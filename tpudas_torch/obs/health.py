"""Edge health snapshot: ``health.json`` + ``metrics.prom`` on disk.

The port's counterpart of :mod:`tpudas.obs.health`.  An operator (or a
node-exporter textfile collector) must be able to tell from OUTSIDE the
process whether the stream keeps up, so the realtime runner writes two
files beside the stream carry every round (``health=True`` or
``TPUDAS_HEALTH=1``):

- ``health.json`` — one small JSON object (schema 3, the JAX package's
  keys) with the liveness numbers: realtime factor, head lag behind
  the fiber head, rounds, redundant ratio, carry resumes, the
  degradation and integrity fields, the last error;
- ``metrics.prom`` — the whole registry in Prometheus text exposition
  format.

Both writes are atomic (tmp + ``os.replace``), and ``health.json`` is
crc32-stamped and double-buffered: the previous good snapshot survives
as ``health.json.prev`` and :func:`read_health` falls back to it (a
counted ladder step) when the primary is torn or corrupt.  A health
write never crashes the processing loop: failures are counted
(``tpudas_health_write_errors_total``) and swallowed, and a disk-full
failure notes pressure (:mod:`tpudas_torch.integrity.resource`).  The
files are byte-compatible with the JAX package's: each package reads
and validates the other's.
"""

from __future__ import annotations

import os
import time

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.atomicio import atomic_write_text as _atomic_write_text

__all__ = [
    "HEALTH_FILENAME",
    "PROM_FILENAME",
    "HEALTH_SCHEMA_VERSION",
    "HEALTH_REQUIRED_KEYS",
    "write_health",
    "read_health",
    "write_prom",
    "validate_health",
]

HEALTH_FILENAME = "health.json"
PROM_FILENAME = "metrics.prom"
# the JAX package's schema 3: v2 added the degradation fields
# (consecutive_failures, quarantined_files, degraded), v3 the integrity
# fields integrity_fallbacks (verified reads that took a ladder step
# this run) and resource_degraded (disk-full writer shedding active)
HEALTH_SCHEMA_VERSION = 3

# keys every snapshot carries
HEALTH_REQUIRED_KEYS = (
    "schema",
    "written_at",
    "rounds",
    "polls",
    "mode",
    "realtime_factor",
    "round_realtime_factor",
    "head_lag_seconds",
    "redundant_ratio",
    "carry_resume_count",
    "last_round_wall_seconds",
    "consecutive_failures",
    "quarantined_files",
    "degraded",
    "last_error",
    "integrity_fallbacks",
    "resource_degraded",
)


def validate_health(payload: dict) -> dict:
    """Raise ``ValueError`` unless ``payload`` carries every required
    key and a known schema version; returns the payload."""
    missing = [k for k in HEALTH_REQUIRED_KEYS if k not in payload]
    if missing:
        raise ValueError(f"health payload missing keys: {missing}")
    if payload["schema"] != HEALTH_SCHEMA_VERSION:
        raise ValueError(
            f"unknown health schema {payload['schema']!r} "
            f"(expected {HEALTH_SCHEMA_VERSION})"
        )
    return payload


def write_health(folder: str, payload: dict) -> str | None:
    """Atomically write ``health.json`` in ``folder`` (previous good
    snapshot preserved as ``health.json.prev``).  Returns the path, or
    None when the write failed (counted, never raised — the health
    writer must not take down the stream it reports on)."""
    payload = dict(payload)
    payload.setdefault("schema", HEALTH_SCHEMA_VERSION)
    payload.setdefault("written_at", time.time())
    reg = get_registry()
    path = os.path.join(folder, HEALTH_FILENAME)
    try:
        validate_health(payload)
        from tpudas_torch.integrity.checksum import (
            rotate_prev,
            write_json_checksummed,
        )

        # rename (not copy) the outgoing primary to .prev: a rename is
        # ~10x cheaper than a copy on overlay filesystems, and the
        # microsecond window with no primary is exactly the case
        # read_health's .prev fallback already covers
        rotate_prev(path)
        write_json_checksummed(path, payload)
    except Exception as exc:
        reg.counter(
            "tpudas_health_write_errors_total",
            "failed health.json/metrics.prom writes (swallowed)",
        ).inc()
        from tpudas_torch.utils.logging import log_event

        log_event("health_write_failed", error=str(exc)[:200])
        from tpudas_torch.integrity.resource import (
            is_resource_error,
            note_pressure,
        )

        if is_resource_error(exc):
            note_pressure("health", exc)
        return None
    reg.counter(
        "tpudas_health_writes_total", "health.json snapshots written"
    ).inc()
    return path


def read_health(folder: str) -> dict | None:
    """The last GOOD health snapshot: checksum-verified
    ``health.json``, falling back to ``health.json.prev`` when the
    primary is torn/corrupt/absent; None when neither verifies."""
    from tpudas_torch.integrity.checksum import (
        count_fallback,
        read_json_verified,
    )

    base = os.path.join(folder, HEALTH_FILENAME)
    for path in (base, base + ".prev"):
        try:
            payload, status = read_json_verified(path, "health")
            if status == "mismatch":
                raise ValueError("health checksum mismatch")
            return validate_health(payload)
        except FileNotFoundError:
            continue  # absence is normal (fresh folder, mid-rename)
        except Exception as exc:
            # torn/corrupt rung (parse failure, crc mismatch, schema
            # skew): count the ladder step, try the next rung
            count_fallback(
                "health", f"{type(exc).__name__}: {str(exc)[:120]}", path
            )
            continue
    return None


def write_prom(folder: str, registry=None) -> str | None:
    """Atomically write the registry's Prometheus exposition as
    ``metrics.prom`` in ``folder`` (node-exporter textfile collector
    format).  Returns the path, or None on (counted, swallowed)
    failure."""
    reg = registry if registry is not None else get_registry()
    path = os.path.join(folder, PROM_FILENAME)
    try:
        _atomic_write_text(path, reg.to_prometheus())
    except Exception as exc:
        get_registry().counter(
            "tpudas_health_write_errors_total",
            "failed health.json/metrics.prom writes (swallowed)",
        ).inc()
        from tpudas_torch.utils.logging import log_event

        log_event("health_write_failed", error=str(exc)[:200])
        from tpudas_torch.integrity.resource import (
            is_resource_error,
            note_pressure,
        )

        if is_resource_error(exc):
            note_pressure("prom", exc)
        return None
    return path
