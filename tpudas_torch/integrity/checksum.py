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

:func:`write_npz_checksummed` streams an ``.npz`` (the stream carry,
hundreds of MB on the FFT engine) straight into its tmp file, the bytes
of ``np.savez`` with each member's data written once from a view of its
array and read once for its crc; the whole file's crc is joined from
the members' with :func:`crc32_combine`, not taken over the file again.

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
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.atomicio import (
    atomic_fill_pair,
    atomic_write_pair,
    atomic_write_text,
)
from tpudas_torch.utils.logging import log_event

__all__ = [
    "CRC_KEY",
    "SIDECAR_SUFFIX",
    "count_fallback",
    "count_unstamped",
    "crc32_combine",
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
    "write_npz_checksummed",
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
    """Atomic payload write with its ``<path>.crc`` sidecar, as a pair
    (:func:`~tpudas_torch.utils.atomicio.atomic_write_pair`): a payload
    its sidecar does not vouch for makes the readers fall back or
    rebuild, so the two are renamed back to back after both are
    written, rather than the sidecar written (and possibly blocked on
    the disk) after the payload has landed.  The files and their bytes
    are the JAX package's."""
    atomic_write_pair(
        path, payload, sidecar_path(path),
        f"crc32 {crc32_hex(payload)} {len(payload)}\n", durable=durable,
    )


def write_npy_checksummed(path: str, array,
                          durable: bool | None = None) -> None:
    """Checksummed atomic raw ``.npy`` write (serialized in memory, so
    the sidecar digests exactly the bytes on disk)."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    write_bytes_checksummed(path, buf.getvalue(), durable=durable)


def write_npz_checksummed(path: str, arrays: dict,
                          durable: bool | None = None) -> None:
    """Checksummed atomic ``.npz`` write of ``arrays`` (name -> array),
    byte for byte what ``np.savez`` writes, streamed into the tmp file
    (:func:`~tpudas_torch.utils.atomicio.atomic_fill_pair`): no
    in-memory archive, and one crc pass over each member's data, which
    runs on a few threads while the data is written.  The sidecar is
    :func:`write_bytes_checksummed`'s."""

    def fill(fh):
        crc, size = _write_npz(fh, arrays)
        return f"crc32 {crc:08x} {size}\n"

    atomic_fill_pair(path, fill, sidecar_path(path), durable=durable)


# a member's data is crc'd in chunks of this size on _CRC_THREADS threads
# (zlib releases the GIL) while the writing thread writes it
_CRC_CHUNK = 32 << 20
_CRC_THREADS = 3
_CRC_POLY = 0xEDB88320  # zlib's crc32, reflected


def _multmodp(a: int, b: int) -> int:
    """``a(x) * b(x)`` modulo the crc32 polynomial (reflected bits)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


def _x2n_table() -> tuple:
    t = [1 << 30]  # x^1
    for _ in range(31):
        t.append(_multmodp(t[-1], t[-1]))
    return tuple(t)  # t[k] = x^(2^k)


_X2N = _x2n_table()


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The crc32 of ``A + B`` from ``crc1 = crc32(A)``, ``crc2 =
    crc32(B)`` and ``len2 = len(B)`` (zlib's ``crc32_combine``, which
    Python's ``zlib`` lacks): ``crc1`` times ``x^(8 len2)`` modulo the
    polynomial, plus ``crc2``; microseconds at any length."""
    p, k, n = 1 << 31, 3, int(len2)  # x^0, and x^(8 n) = x^(n 2^3)
    while n:
        if n & 1:
            p = _multmodp(_X2N[k & 31], p)
        n >>= 1
        k += 1
    return _multmodp(p, crc1 & 0xFFFFFFFF) ^ (crc2 & 0xFFFFFFFF)


def _npy_parts(array: np.ndarray) -> tuple:
    """The ``.npy`` 1.0 header ``np.save`` writes for ``array`` and a
    flat byte view of the data it writes after it: C order, or the
    transpose's for an array that is Fortran-contiguous only (the
    header then says ``fortran_order``); a copy only for an array that
    is neither."""
    from numpy.lib import format as npy_format

    head = io.BytesIO()
    npy_format.write_array_header_1_0(
        head, npy_format.header_data_from_array_1_0(array))
    if array.flags.c_contiguous:
        flat = array
    elif array.flags.f_contiguous:
        flat = array.T
    else:
        flat = np.ascontiguousarray(array)
    return head.getvalue(), memoryview(flat.reshape(-1).view(np.uint8))


class _DirectorySink:
    """Where :class:`zipfile.ZipFile` writes the archive's central
    directory and end records: kept in memory, at the file offset that
    follows the members, so its bytes are written and crc'd as one."""

    def __init__(self, offset: int):
        self.offset = offset
        self.data = bytearray()

    def tell(self) -> int:
        return self.offset + len(self.data)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence or pos != self.tell():
            raise io.UnsupportedOperation("the directory is written in order")
        return pos

    def write(self, b) -> int:
        self.data += b
        return len(b)

    def flush(self) -> None:
        pass


def _write_npz(fh, arrays: dict) -> tuple:
    """Write ``arrays`` into the binary file ``fh`` as ``np.savez``
    does: one stored member ``<name>.npy`` each (zipfile's own
    :class:`~zipfile.ZipInfo`, its forced zip64 local header and its
    central directory), each member's data written from a view of its
    array.  Its crc is taken in chunks on a few threads while the data
    is written, then the local header is written again with it, as
    zipfile's own writer does.  Returns the crc32 of the whole file and
    its size, joined from the members' crcs and the headers' bytes."""
    infos, crc, pos = [], 0, 0
    with ThreadPoolExecutor(_CRC_THREADS) as pool:
        for name, value in arrays.items():
            head, data = _npy_parts(np.asanyarray(value))
            chunks = [data[i:i + _CRC_CHUNK]
                      for i in range(0, data.nbytes, _CRC_CHUNK)]
            parts = [pool.submit(zlib.crc32, c) for c in chunks]
            zinfo = zipfile.ZipInfo(name + ".npy")  # as ZipFile.open("w")
            zinfo.external_attr = 0o600 << 16
            zinfo.header_offset = pos
            zinfo.file_size = zinfo.compress_size = len(head) + data.nbytes
            zinfo.CRC = 0
            fh.write(zinfo.FileHeader(True))
            fh.write(head)
            fh.write(data)
            member = zlib.crc32(head)
            for c, part in zip(chunks, parts):
                member = crc32_combine(member, part.result(), c.nbytes)
            zinfo.CRC = member
            local = zinfo.FileHeader(True)
            end = fh.tell()
            fh.seek(pos)
            fh.write(local)
            fh.seek(end)
            crc = crc32_combine(zlib.crc32(local, crc), member,
                                zinfo.file_size)
            infos.append(zinfo)
            pos = end
    sink = _DirectorySink(pos)
    directory = zipfile.ZipFile(sink, "w")
    directory.filelist.extend(infos)
    directory.close()
    fh.write(sink.data)
    return zlib.crc32(sink.data, crc), pos + len(sink.data)


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
