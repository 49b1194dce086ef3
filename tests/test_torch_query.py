"""tpudas_torch.serve.query against tpudas.serve.query: the same answers.

Over one output folder (the stream of ``tests/test_torch_tiles.py``:
64 channels at 1 Hz, uneven files, a 5 s gap), a pyramid built by the
JAX package (``tile_len`` 16, factor 4) is read by both
``QueryEngine``s.  Every answer — data bytes, times, distance, level,
step and source — must be identical at each budget, for a gap window,
for a window straddling the pyramid head (``"mixed"``), for one older
than a ``since=``-anchored pyramid, past the head and past all data,
over a folder with no pyramid at all (``"files"``), and for a
distance sub-range.  Host code only: byte equality throughout.
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.serve import tiles as jtiles
from tpudas.serve.query import QueryEngine as JEngine
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.serve import tiles as ttiles
from tpudas_torch.serve.query import QueryEngine as TEngine
from test_torch_tiles import GEOM, T0, _copy, outputs  # noqa: F401

S = np.timedelta64(1_000_000_000, "ns")
N_ROWS = 286  # the stream's level-0 rows (281 samples + the 5 s gap)


def _same(a, b):
    assert a.source == b.source
    assert a.level == b.level and a.step_ns == b.step_ns
    assert a.agg == b.agg and a.immutable == b.immutable
    assert np.array_equal(a.times, b.times)
    assert a.distance.tobytes() == b.distance.tobytes()
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    assert a.data.tobytes() == b.data.tobytes()


def _both(folder, *args, **kw):
    t = TEngine(folder).query(*args, **kw)
    j = JEngine(folder).query(*args, **kw)
    _same(t, j)
    return t


@pytest.fixture(scope="module")
def full(outputs, tmp_path_factory):  # noqa: F811
    d = _copy(outputs, str(tmp_path_factory.mktemp("full")))
    jtiles.sync_pyramid(d, **GEOM)
    return d


WINDOWS = {
    "all": (T0, T0 + N_ROWS * S),
    "gap": (T0 + 140 * S, T0 + 160 * S),
    "inner": (T0 + 17 * S, T0 + 203 * S),
    "past_head": (T0 + 280 * S, T0 + 400 * S),
    "past_data": (T0 + 500 * S, T0 + 600 * S),
    "before_data": (T0 - 100 * S, T0 + 3 * S),
}


@pytest.mark.parametrize("budget", [None, 4, 16, 64, 1024])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_query_matches_jax(full, window, budget):
    t0, t1 = WINDOWS[window]
    r = _both(full, t0, t1, max_samples=budget)
    if window == "gap" and budget is None:
        assert np.isnan(r.data).all(axis=1).sum() == 5  # honest gap rows
    if window == "past_data":
        assert r.source == "empty" and r.n_samples == 0


@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("resolution", [2.0, 16.0, 70.0])
def test_aggregates_and_resolution(full, agg, resolution):
    t0, t1 = WINDOWS["inner"]
    r = _both(full, t0, t1, resolution=resolution, agg=agg,
              distance=(50.0, 200.0))
    assert r.distance.min() >= 50.0 and r.distance.max() <= 200.0


def test_window_straddling_the_head(outputs, tmp_path):  # noqa: F811
    """A pyramid over the first files only; the newer files are served
    from the files on the same grid (source "mixed")."""
    d = _copy(outputs, str(tmp_path / "d"), 4)
    jtiles.sync_pyramid(d, **GEOM)
    _copy(outputs, d)
    for budget in (None, 16, 64):
        r = _both(d, T0 + 100 * S, T0 + 250 * S, max_samples=budget)
        assert r.source == "mixed"


def test_window_older_than_the_pyramid(outputs, tmp_path):  # noqa: F811
    d = _copy(outputs, str(tmp_path / "d"))
    jtiles.sync_pyramid(d, since=T0 + 100 * S, **GEOM)
    for budget in (None, 16):
        r = _both(d, T0, T0 + 200 * S, max_samples=budget)
        assert r.source == "mixed"


def test_files_only_folder(outputs, tmp_path):  # noqa: F811
    d = _copy(outputs, str(tmp_path / "d"))
    for kw in ({}, {"max_samples": 20}, {"resolution": 4.0},
               {"agg": "max", "max_samples": 20}):
        r = _both(d, T0 + 10 * S, T0 + 250 * S, **kw)
        assert r.source == "files"
    assert _both(d, T0 + 900 * S, T0 + 990 * S).source == "empty"
    assert not TEngine(d).has_pyramid()


def test_pick_level_matches(full):
    ts, js = ttiles.TileStore.open(full), jtiles.TileStore.open(full)
    t0 = int(T0.astype(np.int64))
    for res in (None, 0.5, 1.0, 3.9, 4.0, 16.0, 1e6):
        for ms in (None, 0, 1, 7, 100):
            args = (t0, t0 + 200 * 10**9, res, ms)
            assert TEngine.pick_level(ts, *args) == JEngine.pick_level(js,
                                                                      *args)


def test_lru_and_generation_keys(full, tmp_path):
    """A warm query is served from the LRU; a rebuild under another
    codec bumps the generation, so the held engine re-reads (no stale
    decoded tile), equal to the JAX engine's fresh answer."""
    import shutil

    d = str(tmp_path / "d")
    shutil.copytree(full, d)
    reg = MetricsRegistry()
    with use_registry(reg):
        eng = TEngine(d)
        a = eng.query(*WINDOWS["all"], max_samples=64)
        misses = reg.value("tpudas_serve_cache_misses_total")
        b = eng.query(*WINDOWS["all"], max_samples=64)
        assert reg.value("tpudas_serve_cache_misses_total") == misses
        assert reg.value("tpudas_serve_cache_hits_total") >= 1
        assert a.data.tobytes() == b.data.tobytes()
        ttiles.rebuild_pyramid(d, codec="quantize-deflate:max_error=0.25")
        c = eng.query(*WINDOWS["all"], max_samples=64)
    assert c.data.tobytes() != a.data.tobytes()
    fin = np.isfinite(a.data)
    assert np.abs(c.data[fin] - a.data[fin]).max() <= 0.25
    _same(c, JEngine(d).query(*WINDOWS["all"], max_samples=64))
    assert eng.cache_info()["tiles"] > 0
    eng.clear_cache()
    assert eng.cache_info()["tiles"] == 0


def test_concurrent_identical_queries_coalesce(full):
    """Threads asking for the same cold tiles share the loads; every
    answer is the JAX engine's."""
    import threading

    eng = TEngine(full)
    want = JEngine(full).query(*WINDOWS["all"])
    got, errs = [], []

    def ask():
        try:
            got.append(eng.query(*WINDOWS["all"]))
        except Exception as exc:  # surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=ask) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(got) == 6
    for r in got:
        _same(r, want)


def test_bad_arguments_like_jax(full):
    for eng in (TEngine(full), JEngine(full)):
        with pytest.raises(ValueError, match="aggregate"):
            eng.query(T0, T0 + S, agg="median")
        with pytest.raises(ValueError, match="inverted"):
            eng.query(T0 + S, T0)
