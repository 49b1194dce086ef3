"""crc32 stamping and verification of the stream carry's files.

The port's copy of the part of :mod:`tpudas.integrity.checksum` that
the stream carry needs, with the same on-disk format byte for byte, so
each package verifies the carry the other wrote:

- **JSON** (the carry's readable sidecar) embeds the digest as a
  top-level ``"_crc32"`` key computed over the canonical dump of the
  rest of the object (sorted keys, no whitespace);
- **binary** (the carry ``.npz``) gets a sidecar ``<path>.crc`` holding
  ``crc32 <8-hex-digest> <size>\\n``, written after the payload's
  rename, so a crash between the two reads as a mismatch.

Writes go through a per-process tmp name and ``os.replace``; readers
never see a partial file.  ``durable=True`` (or ``TPUDAS_FSYNC=1``)
fsyncs the payload before the rename and the directory after it.

A verification result is ``"ok"``, ``"unstamped"`` (no sidecar: a
legacy artifact, accepted) or ``"mismatch"``.  A reader that rejects a
primary and falls down its ladder reports it with :func:`count_fallback`,
which emits an ``integrity_fallback`` log event; an accepted unstamped
artifact is counted by :func:`count_unstamped`.
"""

from __future__ import annotations

import json
import os
import zlib

from tpudas_torch.utils.logging import log_event

__all__ = [
    "CRC_KEY",
    "SIDECAR_SUFFIX",
    "count_fallback",
    "count_unstamped",
    "crc32_hex",
    "read_json_verified",
    "rotate_prev",
    "sidecar_path",
    "stamp_json",
    "verify_file_checksum",
    "verify_json_obj",
    "write_bytes_checksummed",
    "write_json_checksummed",
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


def count_fallback(artifact: str, reason: str, path: str = "") -> None:
    """One degradation-ladder step: the primary for ``artifact`` was
    rejected and the reader falls through to ``.prev`` or rewind."""
    log_event(
        "integrity_fallback",
        artifact=artifact,
        reason=str(reason)[:200],
        path=str(path),
    )


def count_unstamped(artifact: str) -> None:
    """A legacy artifact without a checksum was accepted."""
    from tpudas_torch.obs.registry import get_registry

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


def _durable(durable) -> bool:
    if durable is None:
        return os.environ.get("TPUDAS_FSYNC", "0") == "1"
    return bool(durable)


def _atomic_write(path: str, payload: bytes, durable) -> None:
    """``payload`` to ``path`` via a per-process tmp name + rename."""
    durable = _durable(durable)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(payload)
        if durable:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if durable:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def write_json_checksummed(
    path: str, obj: dict, durable: bool | None = None, indent: int = 1
) -> None:
    """Atomically write ``obj`` with an embedded crc32 stamp."""
    text = json.dumps(stamp_json(obj), indent=indent) + "\n"
    _atomic_write(path, text.encode(), durable)


def verify_json_obj(obj) -> str:
    """``"ok"`` | ``"unstamped"`` | ``"mismatch"`` for a parsed JSON
    object."""
    if not isinstance(obj, dict) or CRC_KEY not in obj:
        return "unstamped"
    body = {k: v for k, v in obj.items() if k != CRC_KEY}
    return "ok" if crc32_hex(_canonical(body)) == obj[CRC_KEY] else "mismatch"


def read_json_verified(path: str) -> tuple[dict, str]:
    """Parse and verify one JSON artifact: ``(payload without the
    stamp, status)``.  Raises whatever ``open``/``json.load`` raise (the
    caller's ladder treats unreadable like mismatched)."""
    with open(path) as fh:
        obj = json.load(fh)
    status = verify_json_obj(obj)
    if isinstance(obj, dict):
        obj = {k: v for k, v in obj.items() if k != CRC_KEY}
    return obj, status


def sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


def write_bytes_checksummed(
    path: str, payload: bytes, durable: bool | None = None
) -> None:
    """Atomic payload write, then the ``<path>.crc`` sidecar."""
    _atomic_write(path, payload, durable)
    _atomic_write(
        sidecar_path(path),
        f"crc32 {crc32_hex(payload)} {len(payload)}\n".encode(),
        durable,
    )


def verify_file_checksum(path: str) -> str:
    """``"ok"`` | ``"unstamped"`` | ``"mismatch"`` for a binary artifact
    against its ``.crc`` sidecar.  A missing payload raises
    ``FileNotFoundError``."""
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
    Returns True when a primary existed."""
    if not os.path.isfile(path):
        return False
    os.replace(path, path + ".prev")
    side = sidecar_path(path)
    if os.path.isfile(side):
        os.replace(side, sidecar_path(path + ".prev"))
    return True
