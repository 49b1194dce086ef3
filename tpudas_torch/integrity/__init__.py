"""tpudas_torch.integrity: checksummed persistent state, the startup
audit and repair, and disk-full graceful degradation.

The port's counterpart of :mod:`tpudas.integrity`, with the same names:

- :mod:`tpudas_torch.integrity.checksum` — crc32 stamping (embedded for
  JSON, ``.crc`` sidecar for binary) and the verified-read helpers
  every durable artifact goes through, each rejected rung counted
  (``tpudas_integrity_fallback_total``);
- :mod:`tpudas_torch.integrity.audit` — the startup "fsck" run before
  the realtime drivers' first round (``tpudas_torch/tools/fsck.py`` is
  the operator CLI);
- :mod:`tpudas_torch.integrity.resource` — ``ENOSPC``/``EDQUOT``
  degradation: shed the non-essential writers while the stream and its
  carry stay alive.
"""

from tpudas_torch.integrity.audit import audit, audit_backfill, audit_fleet
from tpudas_torch.integrity.checksum import (
    CRC_KEY,
    SIDECAR_SUFFIX,
    crc32_hex,
    fallback_count,
    stamp_json,
    verify_file_checksum,
    verify_json_obj,
    write_json_checksummed,
    write_sidecar_for,
)
from tpudas_torch.integrity.resource import (
    RESOURCE_ERRNOS,
    is_degraded,
    is_resource_error,
    note_pressure,
    probe_recovery,
    should_shed,
)

__all__ = [
    "CRC_KEY",
    "RESOURCE_ERRNOS",
    "SIDECAR_SUFFIX",
    "audit",
    "audit_backfill",
    "audit_fleet",
    "crc32_hex",
    "fallback_count",
    "is_degraded",
    "is_resource_error",
    "note_pressure",
    "probe_recovery",
    "should_shed",
    "stamp_json",
    "verify_file_checksum",
    "verify_json_obj",
    "write_json_checksummed",
    "write_sidecar_for",
]
