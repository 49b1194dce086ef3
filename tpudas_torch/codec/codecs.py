"""The pluggable codec registry and the shipped codecs.

A codec transforms one tile array into a compressed payload and back:

- ``encode(arr, **params) -> (payload_bytes, params_out)`` — the
  returned ``params_out`` is everything ``decode`` needs and is
  persisted verbatim in the tile header (so a blob decodes with no
  out-of-band state);
- ``decode(payload, dtype, shape, params) -> np.ndarray`` — must
  reproduce the array byte-exactly for ``lossless=True`` codecs, and
  within ``params["max_error"]`` absolutely (NaN positions exact)
  otherwise.

Both directions must be **deterministic**: the crash-only tile store
re-encodes a crashed append's rows and relies on the retry producing
the same bytes, and the crash drill asserts pyramid trees
byte-identical between a killed run and an uninterrupted control.
That is why the deflate level is pinned in ``params_out`` instead of
left to a library default that could drift.

Shipped codecs
--------------

``deflate``
    zlib over the raw array bytes.  The baseline: byte-exact, cheap,
    modest ratios on float noise.

``bitshuffle-deflate``
    Bit transposition (all elements' bit 0, then all bit 1, ...)
    before deflate — the Blosc/HDF5 *bitshuffle* transform,
    implemented here in pure numpy (``unpackbits`` / transpose /
    ``packbits``) so nothing new is vendored.  Slowly-varying fields
    (decimated DAS output, quantized integers) share high bits across
    neighbours, so the transposed stream is long runs the deflate
    stage collapses.  Byte-exact.

``quantize-deflate``
    Controlled-lossy: values are rounded to a uniform grid of step
    ``max_error`` (absolute), giving a reconstruction error of at
    most ``max_error / 2`` before output-dtype rounding — comfortably
    inside the advertised ``max_error`` bound for any error bound the
    output dtype can express at the data's magnitude.  The integer
    grid indices are stored through the lossless bitshuffle+deflate
    pipeline in the narrowest integer width that fits; NaN rows (the
    pyramid's data-gap honesty) map to the width's reserved minimum
    sentinel and come back as exactly NaN.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = [
    "Codec",
    "CodecError",
    "codec_ids",
    "get_codec",
    "parse_codec_spec",
    "register_codec",
]

_DEFAULT_DEFLATE_LEVEL = 6


class CodecError(RuntimeError):
    """A tile blob that cannot be trusted: bad magic, torn header,
    payload crc mismatch, unknown codec id, or a decode that does not
    reproduce the declared geometry.  Readers treat this exactly like
    a failed ``.crc`` sidecar check — fall down the degradation
    ladder, never serve the bytes."""


@dataclass(frozen=True)
class Codec:
    """One registered codec: an id, a losslessness contract, and the
    encode/decode pair.  Frozen so registry entries cannot be mutated
    out from under stores that recorded the id in their manifest.

    ``condition`` (lossy codecs only) maps incoming rows onto the
    codec's representable set — e.g. the quantization grid — such
    that ``decode(encode(condition(x))) == condition(x)`` exactly.
    The tile store applies it to rows *before* they reach tails or
    tiles, which is what keeps the incremental pyramid build
    byte-identical to an offline rebuild under a lossy codec: every
    value on disk is already representable, so where an append's
    chunk boundaries fall can never change what a tile encodes."""

    id: str
    lossless: bool
    encode: Callable  # (arr, **params) -> (payload: bytes, params_out)
    decode: Callable  # (payload, dtype, shape, params) -> np.ndarray
    condition: Callable | None = None  # (arr, **params) -> arr


_REGISTRY: dict = {}


def register_codec(codec: Codec) -> Codec:
    """Add (or replace) one codec in the process-wide registry.  The
    id must be lowercase ``[a-z0-9-]`` — it is embedded in tile
    headers and codec spec strings."""
    cid = str(codec.id)
    if not cid or not all(c.isalnum() or c == "-" for c in cid) or (
        cid != cid.lower()
    ):
        raise ValueError(
            f"codec id {cid!r} must be lowercase alphanumeric/dashes"
        )
    _REGISTRY[cid] = codec
    return codec


def get_codec(codec_id: str) -> Codec:
    codec = _REGISTRY.get(str(codec_id))
    if codec is None:
        raise CodecError(
            f"unknown codec id {codec_id!r}; registered: "
            f"{sorted(_REGISTRY)}"
        )
    return codec


def codec_ids() -> tuple:
    """Every registered codec id, sorted — the lint surface
    ``tools/check_codecs.py`` asserts the test matrix covers."""
    return tuple(sorted(_REGISTRY))


def parse_codec_spec(spec) -> tuple:
    """``(codec_id, params)`` from a codec spec string.

    Grammar: ``<id>[:k=v[,k=v...]]`` — e.g. ``"bitshuffle-deflate"``,
    ``"quantize-deflate:max_error=1e-3,level=9"``.  ``None``, ``""``,
    ``"raw"``, ``"none"`` and ``"0"`` all mean *no codec* (the legacy
    raw-``.npy`` store) and return ``(None, {})``.  Values parse as
    int, then float, then stay strings.  The id must be registered.
    """
    if spec is None:
        return None, {}
    s = str(spec).strip()
    if s.lower() in ("", "raw", "none", "0"):
        return None, {}
    cid, _, tail = s.partition(":")
    cid = cid.strip()
    get_codec(cid)  # unknown id fails loudly at config time
    params: dict = {}
    if tail.strip():
        for item in tail.split(","):
            k, sep, v = item.partition("=")
            if not sep or not k.strip():
                raise ValueError(
                    f"bad codec spec item {item!r} in {spec!r} "
                    "(want k=v)"
                )
            v = v.strip()
            try:
                params[k.strip()] = int(v)
            except ValueError:
                try:
                    params[k.strip()] = float(v)
                except ValueError:
                    params[k.strip()] = v
    return cid, params


# ---------------------------------------------------------------------------
# the bitshuffle transform (pure numpy)

def bitshuffle(data: bytes, itemsize: int) -> bytes:
    """Transpose ``data`` (a whole number of ``itemsize``-byte
    elements) to bit-plane order: all elements' bit 0 first, then all
    bit 1, ...  Exactly reversible by :func:`bitunshuffle` given the
    element count (the tile header carries the shape)."""
    if itemsize <= 0 or len(data) % itemsize:
        raise CodecError(
            f"bitshuffle: {len(data)} bytes is not a whole number of "
            f"{itemsize}-byte elements"
        )
    if not data:
        return b""
    a = np.frombuffer(data, np.uint8).reshape(-1, itemsize)
    bits = np.unpackbits(a, axis=1)  # (n, 8*itemsize), bit-endian rows
    # row-major flatten of the (8*itemsize, n) transpose: total bit
    # count is n*itemsize*8, so packbits pads nothing and the decode
    # side's count-bounded unpack reshapes it back exactly
    return np.packbits(np.ascontiguousarray(bits.T)).tobytes()


def bitunshuffle(data: bytes, itemsize: int, n_elems: int) -> bytes:
    """Inverse of :func:`bitshuffle` for ``n_elems`` elements."""
    if n_elems == 0:
        return b""
    total_bits = 8 * itemsize * n_elems
    if len(data) * 8 < total_bits:
        raise CodecError(
            f"bitunshuffle: {len(data)} bytes cannot hold "
            f"{n_elems} x {itemsize}-byte elements"
        )
    bits = np.unpackbits(
        np.frombuffer(data, np.uint8), count=total_bits
    ).reshape(8 * itemsize, n_elems)
    return np.packbits(
        np.ascontiguousarray(bits.T), axis=1
    ).tobytes()


# ---------------------------------------------------------------------------
# lossless codecs

def _deflate_encode(arr: np.ndarray, level=None, **_ignored):
    level = int(_DEFAULT_DEFLATE_LEVEL if level is None else level)
    payload = zlib.compress(
        np.ascontiguousarray(arr).tobytes(), level
    )
    return payload, {"level": level}


def _deflate_decode(payload: bytes, dtype, shape, params):
    raw = zlib.decompress(payload)
    return _from_bytes(raw, dtype, shape)


def _bitshuffle_encode(arr: np.ndarray, level=None, **_ignored):
    level = int(_DEFAULT_DEFLATE_LEVEL if level is None else level)
    arr = np.ascontiguousarray(arr)
    shuffled = bitshuffle(arr.tobytes(), arr.dtype.itemsize)
    return zlib.compress(shuffled, level), {"level": level}


def _bitshuffle_decode(payload: bytes, dtype, shape, params):
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    raw = bitunshuffle(zlib.decompress(payload), dtype.itemsize, n)
    return _from_bytes(raw, dtype, shape)


def _from_bytes(raw: bytes, dtype, shape) -> np.ndarray:
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if len(raw) != n * dtype.itemsize:
        raise CodecError(
            f"decoded payload is {len(raw)} bytes, tile header "
            f"declares {n} x {dtype} = {n * dtype.itemsize}"
        )
    return np.frombuffer(raw, dtype).reshape(shape).copy()


# ---------------------------------------------------------------------------
# controlled-lossy quantization

_QUANT_WIDTHS = (np.int8, np.int16, np.int32, np.int64)
_DEFAULT_MAX_ERROR = 1e-3


def _quantize_encode(arr: np.ndarray, max_error=None, level=None,
                     **_ignored):
    """Round to a uniform grid of step ``max_error`` (reconstruction
    error <= max_error/2, half the advertised bound — the headroom
    absorbs output-dtype rounding), sentinel-encode NaNs, store the
    indices through bitshuffle+deflate in the narrowest width that
    fits."""
    max_error = float(
        _DEFAULT_MAX_ERROR if max_error is None else max_error
    )
    if not (max_error > 0) or not np.isfinite(max_error):
        raise ValueError(
            f"quantize-deflate needs a positive finite max_error, "
            f"got {max_error!r}"
        )
    arr = np.ascontiguousarray(arr)
    if not np.issubdtype(arr.dtype, np.floating):
        raise CodecError(
            "quantize-deflate only encodes floating tiles; use a "
            f"lossless codec for dtype {arr.dtype}"
        )
    level = int(_DEFAULT_DEFLATE_LEVEL if level is None else level)
    step = max_error
    x = arr.astype(np.float64, copy=False)
    finite = np.isfinite(x)
    _check_grid_resolvable(arr, x, finite, step)
    # non-finite rows stay 0 here; the width's sentinel replaces them
    # after the cast below
    q = np.zeros(x.shape, np.float64)
    np.round(np.divide(x, step, where=finite, out=q), out=q)
    for width in _QUANT_WIDTHS:
        info = np.iinfo(width)
        # min is the NaN sentinel, so real indices must fit strictly
        # inside (min, max]
        if q.size == 0 or (
            finite.any()
            and q[finite].min() > info.min
            and q[finite].max() <= info.max
        ) or not finite.any():
            qi = q.astype(width)
            qi[~finite] = info.min
            break
    else:
        raise CodecError(
            "quantize-deflate: grid indices overflow int64 — "
            f"max_error {max_error} is too fine for this data range"
        )
    shuffled = bitshuffle(qi.tobytes(), qi.dtype.itemsize)
    payload = zlib.compress(shuffled, level)
    return payload, {
        "max_error": max_error,
        "step": step,
        "itype": qi.dtype.name,
        "level": level,
    }


def _quantize_decode(payload: bytes, dtype, shape, params):
    try:
        itype = np.dtype(params["itype"])
        step = float(params["step"])
    except (KeyError, TypeError) as exc:
        raise CodecError(
            f"quantize-deflate header is missing {exc} — blob "
            "predates this reader or is corrupt"
        ) from exc
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    raw = bitunshuffle(zlib.decompress(payload), itype.itemsize, n)
    if len(raw) != n * itype.itemsize:
        raise CodecError(
            f"quantize-deflate payload is {len(raw)} bytes, header "
            f"declares {n} x {itype}"
        )
    qi = np.frombuffer(raw, itype).reshape(shape)
    out = qi.astype(np.float64) * step
    out[qi == np.iinfo(itype).min] = np.nan
    return out.astype(np.dtype(dtype), copy=False)


register_codec(Codec(
    id="deflate", lossless=True,
    encode=_deflate_encode, decode=_deflate_decode,
))
register_codec(Codec(
    id="bitshuffle-deflate", lossless=True,
    encode=_bitshuffle_encode, decode=_bitshuffle_decode,
))
def _check_grid_resolvable(arr, x64, finite, step) -> None:
    """Refuse a grid finer than the array dtype can hold: below ``4 *
    eps * |x|`` the dtype's own rounding perturbs a value by more
    than half a grid step, so grid indices stop being stable under a
    store/decode roundtrip — the deterministic-rebuild contract (and
    the error bound itself) would silently break.  The remedy is a
    looser ``max_error`` or a lossless codec."""
    if not finite.any():
        return
    eps = np.finfo(np.asarray(arr).dtype).eps
    amax = float(np.max(np.abs(x64[finite])))
    if amax and step < 4.0 * eps * amax:
        raise CodecError(
            f"quantize-deflate max_error {step:g} is below the "
            f"{np.asarray(arr).dtype} resolution at this data's "
            f"magnitude (|x| up to {amax:g}); loosen max_error or "
            "use a lossless codec"
        )


def _quantize_condition(arr, max_error=None, **_ignored):
    """Snap values onto the quantization grid (NaN passes through).
    Computes exactly what decode-of-encode computes — ``round(x /
    step) * step`` in float64, cast back — so conditioned rows
    roundtrip the codec bit-exactly."""
    max_error = float(
        _DEFAULT_MAX_ERROR if max_error is None else max_error
    )
    if not (max_error > 0) or not np.isfinite(max_error):
        raise ValueError(
            f"quantize-deflate needs a positive finite max_error, "
            f"got {max_error!r}"
        )
    arr = np.asarray(arr)
    step = max_error
    x = arr.astype(np.float64)
    with np.errstate(invalid="ignore"):
        finite = np.isfinite(x)
        _check_grid_resolvable(arr, x, finite, step)
        out = np.round(x / step) * step
        # every non-finite value (inf included) becomes NaN — the
        # SAME mapping encode's sentinel applies, so the roundtrip
        # contract decode(encode(condition(x))) == condition(x) holds
        # for inf inputs too (an inf that conditioned to inf would
        # decode to NaN and break tails-vs-tile byte identity)
        out[~finite] = np.nan
    return out.astype(arr.dtype, copy=False)


register_codec(Codec(
    id="quantize-deflate", lossless=False,
    encode=_quantize_encode, decode=_quantize_decode,
    condition=_quantize_condition,
))
