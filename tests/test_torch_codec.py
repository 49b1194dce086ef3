"""tpudas_torch.codec against tpudas.codec: the same blobs, both ways.

The same seeded numpy tiles go through both packages' encoders; every
blob must be byte-identical, each package must decode the other's blob
to the same array (byte for byte; a lossy codec's NaN mask exactly, its
values within ``max_error``), and the header, verification and spec
parsing must agree.  Host code only (numpy and zlib): no tolerance
applies to the lossless codecs.
"""

import zlib

import numpy as np
import pytest

from tpudas import codec as jcodec
from tpudas.codec import codecs as jcodecs
from tpudas_torch import codec as tcodec
from tpudas_torch.codec import codecs as tcodecs

SPECS = ["deflate", "bitshuffle-deflate", "deflate:level=9",
         "quantize-deflate:max_error=1e-3", "quantize-deflate"]
SHAPES = [(0,), (1,), (7, 3), (16, 64), (3, 16, 64), (5, 0)]
DTYPES = ["float32", "float64", "int16", "uint8"]


def _tile(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 3.0
    if np.dtype(dtype).kind == "f":
        x = x.astype(dtype)
        if x.size > 4:
            x.reshape(-1)[[1, 3]] = np.nan  # a data gap
        return x
    return (x * 20).astype(dtype)


def _cases():
    for spec in SPECS:
        for dtype in DTYPES:
            if spec.startswith("quantize") and np.dtype(dtype).kind != "f":
                continue
            for shape in SHAPES:
                yield spec, dtype, shape


@pytest.mark.parametrize("spec,dtype,shape", list(_cases()),
                         ids=lambda v: str(v).replace(" ", ""))
def test_blobs_byte_identical_and_cross_decode(spec, dtype, shape):
    arr = _tile(shape, dtype)
    cid, params = tcodec.parse_codec_spec(spec)
    assert (cid, params) == jcodec.parse_codec_spec(spec)
    if cid == "quantize-deflate":
        arr = tcodecs.get_codec(cid).condition(arr, **params)
        cond_j = jcodecs.get_codec(cid).condition(arr, **params)
        assert arr.tobytes() == cond_j.tobytes()
    blob_t = tcodec.encode_tile(arr, cid, **params)
    blob_j = jcodec.encode_tile(arr, cid, **params)
    assert blob_t == blob_j
    assert tcodec.read_tile_header(blob_j) == jcodec.read_tile_header(blob_t)
    for dec in (tcodec.decode_tile(blob_j), jcodec.decode_tile(blob_t)):
        assert dec.dtype == arr.dtype and dec.shape == arr.shape
        # conditioned rows roundtrip the lossy codec exactly too
        assert dec.tobytes() == arr.tobytes()


@pytest.mark.parametrize("max_error", [1e-1, 1e-3])
def test_quantize_bound_unconditioned(max_error):
    """Raw (unconditioned) rows: within max_error, NaN mask exact, the
    same bytes in both packages."""
    arr = _tile((16, 64), "float32", seed=4)
    blob_t = tcodec.encode_tile(arr, "quantize-deflate", max_error=max_error)
    assert blob_t == jcodec.encode_tile(arr, "quantize-deflate",
                                        max_error=max_error)
    dec = tcodec.decode_tile(blob_t)
    assert np.array_equal(np.isnan(dec), np.isnan(arr))
    fin = np.isfinite(arr)
    assert np.abs(dec[fin] - arr[fin]).max() <= max_error


def test_registry_and_spec_parsing_agree():
    assert tcodec.codec_ids() == jcodec.codec_ids()
    for spec in (None, "", "raw", "none", "0", " bitshuffle-deflate ",
                 "quantize-deflate:max_error=0.25,level=1",
                 "deflate:level=3,tag=x"):
        assert tcodec.parse_codec_spec(spec) == jcodec.parse_codec_spec(spec)
    for bad, exc in (("nope", tcodec.CodecError), ("deflate:level", ValueError)):
        with pytest.raises(exc):
            tcodec.parse_codec_spec(bad)
    for cid in tcodec.codec_ids():
        t, j = tcodec.get_codec(cid), jcodec.get_codec(cid)
        assert (t.id, t.lossless, t.condition is None) == (
            j.id, j.lossless, j.condition is None)


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_bitshuffle_matches(itemsize):
    data = np.random.default_rng(itemsize).integers(
        0, 256, 24 * itemsize, dtype=np.uint8).tobytes()
    sh = tcodecs.bitshuffle(data, itemsize)
    assert sh == jcodecs.bitshuffle(data, itemsize)
    assert tcodecs.bitunshuffle(sh, itemsize, 24) == data
    with pytest.raises(tcodec.CodecError):
        tcodecs.bitshuffle(data[:-1], itemsize) if itemsize > 1 else (
            tcodecs.bitunshuffle(b"", 1, 3))


def test_verification_ladder_agrees():
    """ok / torn / corrupt classify the same in both, and a torn blob
    fails to decode in both."""
    arr = _tile((16, 64), "float32", seed=2)
    blob = tcodec.encode_tile(arr, "bitshuffle-deflate")
    torn = blob[:-4]
    flipped = blob[:-1] + bytes([blob[-1] ^ 0xFF])
    for b, want in ((blob, "ok"), (torn, "torn"), (flipped, "torn"),
                    (b"XXXX" + blob[4:], "corrupt"), (blob[:9], "corrupt")):
        assert tcodec.verify_tile_blob(b) == want
        assert jcodec.verify_tile_blob(b) == want
    for dec in (tcodec.decode_tile, jcodec.decode_tile):
        with pytest.raises(Exception, match="crc32"):
            dec(torn)
    # decode without the gate still refuses a payload that cannot
    # inflate
    with pytest.raises((zlib.error, tcodec.CodecError)):
        tcodec.decode_tile(torn, verify=False)


def test_quantize_refuses_too_fine_grid_like_jax():
    arr = np.full((4, 4), 1e6, np.float32)
    for mod in (tcodecs, jcodecs):
        with pytest.raises(mod.CodecError, match="resolution"):
            mod.get_codec("quantize-deflate").encode(arr, max_error=1e-6)
    with pytest.raises(tcodec.CodecError, match="floating"):
        tcodec.encode_tile(np.zeros(3, np.int16), "quantize-deflate")
