"""The self-describing compressed tile container.

On-disk layout of one ``.tpt`` blob::

    b"TPTC"                      4-byte magic
    u32 little-endian            header length H
    H bytes                      canonical JSON header
    payload                      the codec's compressed bytes

Header keys: ``version`` (1), ``codec`` (registry id), ``dtype``
(numpy dtype string), ``shape`` (list of ints), ``params`` (whatever
the codec's encode returned — everything decode needs), ``crc32``
(8-hex crc of the payload bytes), ``raw_nbytes`` (decoded size, the
bytes-on-disk accounting numerator).

The crc is **embedded**, so compressed tiles carry their own
integrity stamp: no ``.crc`` sidecar, no crash window between payload
and stamp, and :func:`verify_tile_blob` classifies a file as
``ok`` / ``torn`` / ``corrupt`` from its bytes alone — exactly the
ladder vocabulary :mod:`tpudas_torch.integrity.audit` speaks.

Every encode/decode is traced (``codec.encode`` / ``codec.decode``
spans) and accounted (``tpudas_codec_*`` metrics) so compression
ratios and codec wall time are first-class observables.
"""

from __future__ import annotations

import json
import struct
import time

import numpy as np

from tpudas_torch.codec.codecs import CodecError, get_codec
from tpudas_torch.integrity.checksum import crc32_hex
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span

__all__ = [
    "MAGIC",
    "TILE_BLOB_SUFFIX",
    "FRAME_VERSION",
    "decode_tile",
    "encode_tile",
    "read_tile_header",
    "verify_tile_blob",
]

MAGIC = b"TPTC"
FRAME_VERSION = 1
# compressed tiles live beside legacy raw tiles as
# ``L<level>/<idx>.tpt`` — distinct suffix, so a mixed store is
# unambiguous file by file
TILE_BLOB_SUFFIX = ".tpt"

_LEN = struct.Struct("<I")


def encode_tile(arr, codec_id: str, **params) -> bytes:
    """One tile array -> one self-describing compressed blob."""
    codec = get_codec(codec_id)
    arr = np.ascontiguousarray(arr)
    reg = get_registry()
    t0 = time.perf_counter()
    with span("codec.encode", codec=codec.id):
        payload, params_out = codec.encode(arr, **params)
    header = {
        "version": FRAME_VERSION,
        "codec": codec.id,
        "dtype": arr.dtype.str,
        "shape": [int(s) for s in arr.shape],
        "params": params_out,
        "crc32": crc32_hex(payload),
        "raw_nbytes": int(arr.nbytes),
    }
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode()
    blob = MAGIC + _LEN.pack(len(hdr)) + hdr + payload
    reg.counter(
        "tpudas_codec_tiles_encoded_total",
        "tiles encoded into the compressed container",
        labelnames=("codec",),
    ).inc(codec=codec.id)
    reg.counter(
        "tpudas_codec_raw_bytes_total",
        "uncompressed tile bytes fed into codec encodes",
        labelnames=("codec",),
    ).inc(float(arr.nbytes), codec=codec.id)
    reg.counter(
        "tpudas_codec_encoded_bytes_total",
        "compressed tile bytes produced by codec encodes "
        "(header included)",
        labelnames=("codec",),
    ).inc(float(len(blob)), codec=codec.id)
    reg.histogram(
        "tpudas_codec_encode_seconds",
        "wall time of one tile encode",
        labelnames=("codec",),
    ).observe(time.perf_counter() - t0, codec=codec.id)
    return blob


def _split(blob: bytes) -> tuple:
    """``(header_dict, payload_bytes)`` of one blob; CodecError on
    anything that does not parse (bad magic, truncated header)."""
    if blob[:4] != MAGIC:
        raise CodecError(
            f"not a tpudas tile blob (magic {blob[:4]!r})"
        )
    if len(blob) < 8:
        raise CodecError("truncated tile blob (no header length)")
    (hlen,) = _LEN.unpack(blob[4:8])
    hdr_bytes = blob[8 : 8 + hlen]
    if len(hdr_bytes) != hlen:
        raise CodecError("truncated tile blob (torn header)")
    try:
        header = json.loads(hdr_bytes)
    except ValueError as exc:
        raise CodecError(f"unparseable tile header: {exc}") from exc
    if not isinstance(header, dict) or header.get("version") != (
        FRAME_VERSION
    ):
        raise CodecError(
            f"unknown tile frame version "
            f"{header.get('version') if isinstance(header, dict) else header!r}"
        )
    return header, blob[8 + hlen :]


def read_tile_header(blob: bytes) -> dict:
    """The parsed header of one blob (payload untouched)."""
    return _split(blob)[0]


def verify_tile_blob(blob: bytes) -> str:
    """``"ok"`` | ``"torn"`` (payload crc mismatch — a torn write or
    bit rot behind an intact header) | ``"corrupt"`` (the header
    itself does not parse).  The audit's classification primitive for
    compressed tiles — the embedded-crc analogue of
    :func:`tpudas_torch.integrity.checksum.verify_file_checksum`."""
    try:
        header, payload = _split(blob)
        stamp = header["crc32"]
    except (CodecError, KeyError, TypeError):
        return "corrupt"
    return "ok" if crc32_hex(payload) == stamp else "torn"


def decode_tile(blob: bytes, verify: bool = True) -> np.ndarray:
    """One blob -> the tile array.  ``verify=True`` (default) checks
    the embedded payload crc first and raises :class:`CodecError` on
    mismatch — the read path's integrity gate."""
    header, payload = _split(blob)
    if verify and crc32_hex(payload) != header.get("crc32"):
        get_registry().counter(
            "tpudas_codec_verify_failures_total",
            "tile blobs rejected for an embedded-crc mismatch",
        ).inc()
        raise CodecError(
            "tile payload failed its embedded crc32 check "
            "(torn write or bit rot)"
        )
    codec = get_codec(header.get("codec"))
    reg = get_registry()
    t0 = time.perf_counter()
    with span("codec.decode", codec=codec.id):
        arr = codec.decode(
            payload,
            header.get("dtype"),
            tuple(header.get("shape", ())),
            header.get("params") or {},
        )
    if list(arr.shape) != list(header.get("shape", ())):
        raise CodecError(
            f"decode produced shape {arr.shape}, header declares "
            f"{header.get('shape')}"
        )
    reg.counter(
        "tpudas_codec_tiles_decoded_total",
        "tiles decoded from the compressed container",
        labelnames=("codec",),
    ).inc(codec=codec.id)
    reg.histogram(
        "tpudas_codec_decode_seconds",
        "wall time of one tile decode",
        labelnames=("codec",),
    ).observe(time.perf_counter() - t0, codec=codec.id)
    return arr
