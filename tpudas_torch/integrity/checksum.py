"""crc32 stamping and verification of every durable artifact.

The port's copy of :mod:`tpudas.integrity.checksum` (the writers, the
verified reads and the audit's re-stamping), with the
same on-disk format byte for byte, so each package verifies what the
other wrote:

- **JSON** (the carry's readable sidecar) embeds the digest as a
  top-level ``"_crc32"`` key computed over the canonical dump of the
  rest of the object (sorted keys, no whitespace);
- **binary** (the carry ``.npz``, the detect score tiles) gets a sidecar ``<path>.crc`` holding
  ``crc32 <8-hex-digest> <size>\\n``, written after the payload's
  rename, so a crash between the two reads as a mismatch.

Writes go through :mod:`tpudas_torch.utils.atomicio` (a per-process tmp
name, ``os.replace`` and the ``fs.write_enospc`` fault site); readers
never see a partial file.  Verified reads pass the ``integrity.verify``
fault site with their artifact's name, so a test can corrupt (action
``"truncate"``) any artifact just before its verified read.

A verification result is ``"ok"``, ``"unstamped"`` (no sidecar: a
legacy artifact, accepted) or ``"mismatch"``.  A reader that rejects a
primary and falls down its ladder reports it with :func:`count_fallback`
(``tpudas_integrity_fallback_total{artifact}``, the process count
:func:`fallback_count` and an ``integrity_fallback`` log event); an
accepted unstamped artifact is counted by :func:`count_unstamped`.
"""

from __future__ import annotations

import io
import json
import os
import zlib

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.atomicio import atomic_write_bytes, atomic_write_text
from tpudas_torch.utils.logging import log_event

__all__ = [
    "CRC_KEY",
    "SIDECAR_SUFFIX",
    "count_fallback",
    "count_unstamped",
    "crc32_hex",
    "fallback_count",
    "read_json_verified",
    "rotate_prev",
    "sidecar_path",
    "stamp_json",
    "strip_stamp",
    "verify_file_checksum",
    "verify_json_obj",
    "write_bytes_checksummed",
    "write_json_checksummed",
    "write_npy_checksummed",
    "write_sidecar_for",
]

CRC_KEY = "_crc32"
SIDECAR_SUFFIX = ".crc"


def crc32_hex(data: bytes) -> str:
    return format(zlib.crc32(data) & 0xFFFFFFFF, "08x")


def _canonical(obj) -> bytes:
    """The bytes the JSON stamp digests: sorted keys, minimal
    separators — identical before the write and after any parse."""
    return json.dumps(
        obj, sort_keys=True, separators=(",", ":"), default=str
    ).encode()


_fallbacks = 0  # process-lifetime ladder steps (all artifacts)


def fallback_count() -> int:
    """Verified reads (process lifetime) that rejected a primary and
    took a degradation-ladder step."""
    return _fallbacks


def count_fallback(artifact: str, reason: str, path: str = "") -> None:
    """One degradation-ladder step: the primary for ``artifact`` was
    rejected and the reader falls through to ``.prev``, rebuild or
    rewind."""
    global _fallbacks
    _fallbacks += 1
    get_registry().counter(
        "tpudas_integrity_fallback_total",
        "verified reads that rejected the primary artifact and took a "
        "degradation-ladder step (.prev / rebuild / rewind)",
        labelnames=("artifact",),
    ).inc(artifact=artifact)
    log_event(
        "integrity_fallback",
        artifact=artifact,
        reason=str(reason)[:200],
        path=str(path),
    )


def count_unstamped(artifact: str) -> None:
    """A legacy artifact without a checksum was accepted."""
    get_registry().counter(
        "tpudas_integrity_unstamped_total",
        "checksum-less legacy artifacts accepted by verified reads",
        labelnames=("artifact",),
    ).inc(artifact=artifact)


def stamp_json(obj: dict) -> dict:
    """``obj`` plus a ``"_crc32"`` key digesting the canonical dump of
    everything else (an existing stamp is replaced)."""
    body = {k: v for k, v in obj.items() if k != CRC_KEY}
    return {**body, CRC_KEY: crc32_hex(_canonical(body))}


def _verify_point(path: str, artifact: str | None) -> None:
    from tpudas_torch.resilience.faults import fault_point

    fault_point("integrity.verify", path=path, artifact=artifact)


def strip_stamp(obj: dict) -> dict:
    return {k: v for k, v in obj.items() if k != CRC_KEY}


def write_json_checksummed(
    path: str, obj: dict, durable: bool | None = None, indent: int = 1
) -> None:
    """Atomically write ``obj`` with an embedded crc32 stamp."""
    atomic_write_text(
        path, json.dumps(stamp_json(obj), indent=indent) + "\n",
        durable=durable,
    )


def verify_json_obj(obj) -> str:
    """``"ok"`` | ``"unstamped"`` | ``"mismatch"`` for a parsed JSON
    object."""
    if not isinstance(obj, dict) or CRC_KEY not in obj:
        return "unstamped"
    body = {k: v for k, v in obj.items() if k != CRC_KEY}
    return "ok" if crc32_hex(_canonical(body)) == obj[CRC_KEY] else "mismatch"


def read_json_verified(path: str, artifact: str) -> tuple[dict, str]:
    """Parse and verify one JSON artifact: ``(payload without the
    stamp, status)``.  Raises whatever ``open``/``json.load`` raise (the
    caller's ladder treats unreadable like mismatched)."""
    _verify_point(path, artifact)
    with open(path) as fh:
        obj = json.load(fh)
    status = verify_json_obj(obj)
    return (strip_stamp(obj) if isinstance(obj, dict) else obj), status


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def write_bytes_checksummed(
    path: str, payload: bytes, durable: bool | None = None
) -> None:
    """Atomic payload write, then the ``<path>.crc`` sidecar."""
    atomic_write_bytes(path, payload, durable=durable)
    atomic_write_text(
        sidecar_path(path),
        f"crc32 {crc32_hex(payload)} {len(payload)}\n",
        durable=durable,
    )


def write_npy_checksummed(path: str, array,
                          durable: bool | None = None) -> None:
    """Checksummed atomic raw ``.npy`` write (serialized in memory, so
    the sidecar digests exactly the bytes on disk)."""
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    write_bytes_checksummed(path, buf.getvalue(), durable=durable)


def write_sidecar_for(path: str, durable: bool | None = None) -> str:
    """(Re-)stamp an existing binary artifact from its current bytes —
    the audit's repair for an unstamped payload or a stale sidecar.
    Returns the digest."""
    with open(path, "rb") as fh:
        payload = fh.read()
    digest = crc32_hex(payload)
    atomic_write_text(
        sidecar_path(path), f"crc32 {digest} {len(payload)}\n",
        durable=durable,
    )
    return digest


def verify_file_checksum(path: str, artifact: str | None = None) -> str:
    """``"ok"`` | ``"unstamped"`` | ``"mismatch"`` for a binary artifact
    against its ``.crc`` sidecar.  A missing payload raises
    ``FileNotFoundError``."""
    _verify_point(path, artifact)
    try:
        with open(sidecar_path(path)) as fh:
            tokens = fh.read().split()
    except FileNotFoundError:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return "unstamped"
    with open(path, "rb") as fh:
        payload = fh.read()
    if len(tokens) != 3 or tokens[0] != "crc32" or not tokens[2].isdigit():
        return "mismatch"
    if int(tokens[2]) != len(payload) or tokens[1] != crc32_hex(payload):
        return "mismatch"
    return "ok"


def rotate_prev(path: str) -> bool:
    """Rotate ``path`` and its sidecar to ``path.prev`` /
    ``path.prev.crc`` (the double buffer before writing a new primary).
    Returns True when a primary existed.

    The sidecar moves first.  Renaming the payload over an old ``.prev``
    frees that file's blocks inside the rename, which takes a while for
    a large artifact (the FFT carry is 800 MB at 10,000 channels), and
    a SIGKILL arriving meanwhile ends the process as soon as the rename
    returns.  With the payload moved first that left a ``.prev`` beside
    the sidecar of the rung before it (a crc mismatch: the audit removed
    the only good carry and the stream fell back to rewind mode); with
    the sidecar first, a kill between the two renames leaves the primary
    unstamped, which every reader accepts and the audit restamps.  An
    unstamped primary takes the old ``.prev`` sidecar away with it, so
    that no ``.prev`` is left paired with another payload's stamp."""
    if not os.path.isfile(path):
        return False
    side = sidecar_path(path)
    prev_side = sidecar_path(path + ".prev")
    if os.path.isfile(side):
        os.replace(side, prev_side)
    elif os.path.isfile(prev_side):
        os.remove(prev_side)
    os.replace(path, path + ".prev")
    return True
