"""tpudas_torch.serve.tiles against tpudas.serve.tiles: the same tree.

Output folders of seeded float32 rows (64 channels, 1 Hz, files of
uneven length and one 5 s gap) are written once; both packages build
their pyramids over copies of them (``tile_len`` 16, factor 4) and the
``.tiles/`` trees must be sha256-equal file for file — manifest, tails,
tiles and sidecars — under the raw store, ``bitshuffle-deflate`` and
``quantize-deflate``.  A pyramid appended by one package and resumed by
the other gives the same tree; ``rebuild_pyramid`` in either gives the
same tree; the in-memory ``append_patches`` gives the tree of the
file-backed sync.  ``block_reduce(engine="torch")`` on the CPU is
within 1e-6 (relative to the largest |value|) of the JAX
``engine="jax"`` reduction, both float32 windowed reductions.
"""

import hashlib
import os
import shutil

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.serve import tiles as jtiles
from tpudas_torch.core.patch import Patch
from tpudas_torch.proc.naming import get_filename
from tpudas_torch.serve import tiles as ttiles

T0 = np.datetime64("2023-03-22T00:00:00", "ns")
NCH = 64
# rows per output file; None = a 5 s gap (no file)
FILES = [37, 50, 1, 60, None, 80, 23, 30]
CODECS = {"raw": None, "bitshuffle": "bitshuffle-deflate",
          "quantize": "quantize-deflate:max_error=1e-3"}
GEOM = dict(factor=4, tile_len=16)
PKG = {"port": ttiles, "jax": jtiles}


def _patches(seed=0):
    """The output stream as patches (time-major float32 rows)."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    for n in FILES:
        if n is None:
            i += 5
            continue
        times = T0 + (np.arange(i, i + n) * 1_000_000_000).astype(
            "timedelta64[ns]")
        data = rng.standard_normal((n, NCH)).astype(np.float32)
        data[:, 3] += np.linspace(0, 4, n, dtype=np.float32)
        out.append(Patch(
            data=data, coords={"time": times,
                               "distance": np.arange(NCH) * 5.0},
            dims=("time", "distance"), attrs={"d_time": 1.0}))
        i += n
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """One folder holding every output file; ``_copy`` links the first
    k of them into a fresh folder."""
    d = str(tmp_path_factory.mktemp("outputs"))
    names = []
    for p in _patches():
        name = get_filename(p.attrs["time_min"], p.attrs["time_max"])
        p.io.write(os.path.join(d, name), "dasdae")
        names.append(name)
    return d, names


def _copy(outputs, dst, k=None):
    src, names = outputs
    os.makedirs(dst, exist_ok=True)
    for name in names[:k]:
        if not os.path.exists(os.path.join(dst, name)):
            os.link(os.path.join(src, name), os.path.join(dst, name))
    return dst


def tree(folder, with_prev=False):
    tiles = os.path.join(folder, ".tiles")
    out = {}
    for dirpath, _d, files in os.walk(tiles):
        for name in sorted(files):
            if ".tmp" in name or (".prev" in name and not with_prev):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, tiles)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_sync_trees_equal(outputs, tmp_path, codec):
    a = _copy(outputs, str(tmp_path / "port"))
    b = _copy(outputs, str(tmp_path / "jax"))
    n_t = ttiles.sync_pyramid(a, codec=CODECS[codec], **GEOM)
    n_j = jtiles.sync_pyramid(b, codec=CODECS[codec], **GEOM)
    assert n_t == n_j == sum(n for n in FILES if n) + 5
    ta = tree(a)
    assert ta == tree(b)
    blobs = [k for k in ta if k.endswith(".tpt")]
    assert bool(blobs) == (codec != "raw")  # completed tiles encoded
    st = ttiles.TileStore.open(a)
    assert st.levels == jtiles.TileStore.open(b).levels
    assert st.levels[:3] == [n_t, n_t // 4, n_t // 16]
    for level in range(st.n_levels):
        for agg in ttiles.AGGS:
            got = st.read(level, 0, st.n(level), agg=agg)
            want = jtiles.TileStore.open(b).read(level, 0, st.n(level),
                                                 agg=agg)
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("codec", ["raw", "bitshuffle"])
@pytest.mark.parametrize("first,then", [("port", "jax"), ("jax", "port")])
def test_incremental_cross_package_resume(outputs, tmp_path, codec, first,
                                          then):
    """File by file, alternating packages, equals a one-shot sync (the
    manifest's ``.prev`` rung included after the same last append)."""
    one = _copy(outputs, str(tmp_path / "one"))
    jtiles.sync_pyramid(one, codec=CODECS[codec], **GEOM)
    inc = str(tmp_path / "inc")
    for k in range(1, len(outputs[1]) + 1):
        _copy(outputs, inc, k)
        pkg = PKG[first if k % 2 else then]
        pkg.sync_pyramid(inc, codec=CODECS[codec], **GEOM)
    assert tree(inc) == tree(one)


def test_append_patches_equals_sync(outputs, tmp_path):
    """The runners' in-memory path: the first call syncs from the
    files, later calls append the captured patches (overlap dropped)."""
    pats = _patches()
    trees = {}
    for name, pkg in PKG.items():
        d = str(tmp_path / name)
        _copy(outputs, d, 2)
        n, store = pkg.append_patches(d, pats[:2])
        assert store is None and n == 87  # no pyramid yet: synced
        for k in range(2, len(pats)):
            _copy(outputs, d, k + 1)
            # a re-emitted (overlapping) patch rides along
            n, store = pkg.append_patches(d, pats[k - 1:k + 1], store=store)
            assert n > 0
        trees[name] = tree(d)
    ref = _copy(outputs, str(tmp_path / "ref"))
    ttiles.sync_pyramid(ref, **{**GEOM, "tile_len": 256})
    assert trees["port"] == trees["jax"]
    # the runners' default geometry (factor 4, tile_len 256)
    assert trees["port"] == tree(ref)


@pytest.mark.parametrize("to_codec", [None, "quantize-deflate:max_error=0.25",
                                      "raw"])
def test_rebuild_same_in_both(outputs, tmp_path, to_codec):
    """``rebuild_pyramid`` keeps the geometry (and codec unless asked)
    and bumps the generation; both packages rebuild to the same tree,
    and a store rebuilt by one reads in the other."""
    trees = {}
    for name, pkg in PKG.items():
        d = _copy(outputs, str(tmp_path / name))
        jtiles.sync_pyramid(d, codec="bitshuffle-deflate", **GEOM)
        pkg.rebuild_pyramid(d, codec=to_codec)
        trees[name] = tree(d)
        st = ttiles.TileStore.open(d)
        assert (st.factor, st.tile_len, st.generation) == (4, 16, 1)
        want = {None: "bitshuffle-deflate", "raw": None}.get(
            to_codec, "quantize-deflate")
        assert st.codec == want
        other = jtiles.TileStore.open(d)
        assert other.read(1, 0, other.n(1), "max").tobytes() == st.read(
            1, 0, st.n(1), "max").tobytes()
    assert trees["port"] == trees["jax"]


def test_torn_tails_raise_corrupt_in_both(outputs, tmp_path):
    d = _copy(outputs, str(tmp_path / "d"))
    ttiles.sync_pyramid(d, **GEOM)
    with open(os.path.join(d, ".tiles", "tails.npy"), "r+b") as fh:
        fh.truncate(40)
    for pkg in PKG.values():
        st = pkg.TileStore.open(d)
        with pytest.raises(pkg.CorruptStoreError):
            st.read(0, 0, st.n(0))


def test_append_validation_matches(tmp_path):
    """The append guards raise in both packages alike."""
    t = T0 + np.arange(4).astype("timedelta64[s]")
    for pkg in PKG.values():
        st = pkg.TileStore.create(str(tmp_path / pkg.__name__), **GEOM)
        with pytest.raises(ValueError, match="single-row"):
            st.append(t[:1], np.zeros((1, 3), np.float32))
        assert st.append(t, np.ones((4, 3), np.float32)) == 4
        with pytest.raises(ValueError, match="not on the pyramid grid"):
            st.append(t[-1:] + np.timedelta64(500, "ms"),
                      np.zeros((1, 3), np.float32))
        with pytest.raises(ValueError, match="channel count"):
            st.append(t[-1:] + np.timedelta64(1, "s"),
                      np.zeros((1, 4), np.float32))
        assert st.append(t, np.ones((4, 3), np.float32)) == 0  # re-append
        with pytest.raises(ValueError, match="factor"):
            pkg.TileStore.create(str(tmp_path / "x"), factor=1)


@pytest.mark.parametrize("op", ["mean", "min", "max", "sum"])
def test_block_reduce_engines(op):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, NCH)).astype(np.float32)
    x[8:12, 5] = np.nan
    host_t = ttiles.block_reduce(x, 4, op)
    assert host_t.tobytes() == jtiles.block_reduce(x, 4, op).tobytes()
    dev = ttiles.block_reduce(x, 4, op, engine="torch", device="cpu")
    ref = np.asarray(jtiles.block_reduce(x, 4, op, engine="jax"))
    assert dev.shape == ref.shape == (16, NCH) and dev.dtype == np.float32
    assert np.array_equal(np.isnan(dev), np.isnan(ref))
    fin = np.isfinite(ref)
    # 1e-6 of the largest |value|: float32 window sums in another order
    assert np.abs(dev[fin] - ref[fin]).max() <= 1e-6 * np.abs(ref[fin]).max()
    if op in ("min", "max"):
        assert np.array_equal(dev[fin], host_t[fin].astype(np.float32))


def test_block_reduce_engine_guard(monkeypatch):
    import torch

    x = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="engine"):
        ttiles.block_reduce(x, 4, "mean", engine="jax")
    with pytest.raises(ValueError, match="complete groups"):
        ttiles.block_reduce(x[:7], 4, "mean", engine="torch", device="cpu")
    # the card unasked and absent: raises, never drops to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttiles.block_reduce(x, 4, "mean", engine="torch")


def test_env_defaults_like_jax(outputs, tmp_path, monkeypatch):
    """``TPUDAS_PYRAMID_FACTOR`` / ``_TILE_LEN`` / ``TPUDAS_CODEC`` shape a
    fresh pyramid in both packages alike."""
    monkeypatch.setenv("TPUDAS_PYRAMID_FACTOR", "2")
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    monkeypatch.setenv("TPUDAS_CODEC", "deflate")
    a = _copy(outputs, str(tmp_path / "a"))
    b = _copy(outputs, str(tmp_path / "b"))
    ttiles.sync_pyramid(a)
    jtiles.sync_pyramid(b)
    assert tree(a) == tree(b)
    st = ttiles.TileStore.open(a)
    assert (st.factor, st.tile_len, st.codec) == (2, 8, "deflate")
