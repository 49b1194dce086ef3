"""The port's batch ingest against the JAX package's: the on-disk index
cache read across packages, ``chunk(time=<seconds>)``,
``get_patch_time``, and LFProc's prefetch thread and staging.

Small spools (200 Hz x 16 channels, 4 x 30 s; dasdae and int16 tdas)
written by the JAX package's ``make_synthetic_spool``.  Staged LFProc
outputs must be byte-identical to ``TPUDAS_H2D_STAGE=0`` and to the
numpy reader, and within 1e-5 of each channel's scale of the JAX
LFProc (the two sum the same f32 products in different orders).
"""

import filecmp
import json
import os
import time

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

import tpudas.io.registry as jregistry
import tpudas_torch.io.registry as tregistry
from tpudas.core.patch import Patch as JPatch
from tpudas.integrity.checksum import write_json_checksummed as jwrite_json
from tpudas.io.index import DirectoryIndex as JIndex
from tpudas.io.spool import MemorySpool as JMemorySpool
from tpudas.io.spool import spool as jspool
from tpudas.io.tdas import plan_window_from_records as jplan
from tpudas.proc.lfproc import LFProc as JLFProc
from tpudas.proc.memory import get_patch_time as jget_patch_time
from tpudas.testing import make_synthetic_spool, synthetic_patch as jpatch
from tpudas_torch.core.patch import Patch
from tpudas_torch.io.index import INDEX_FILENAME, DirectoryIndex as TIndex
from tpudas_torch.io.spool import MemorySpool as TMemorySpool
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.io.tdas import plan_window_from_records as tplan
from tpudas_torch.proc import get_patch_time
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.testing import synthetic_patch as tpatch

T1 = np.datetime64("2023-03-22T00:00:00", "ns")
T2 = np.datetime64("2023-03-22T00:02:00", "ns")
REL_TOL = 1e-5

FORMATS = {
    "dasdae": ("dasdae", None),
    "tdas-int16": ("tdas", {"dtype": "int16", "scale": 1e-4}),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def pool(request, tmp_path_factory):
    fmt, wk = FORMATS[request.param]
    d = tmp_path_factory.mktemp(f"ingest-{request.param}")
    make_synthetic_spool(d, n_files=4, file_duration=30.0, fs=200.0,
                         n_ch=16, noise=0.02, format=fmt, write_kwargs=wk)
    return str(d)


def _fresh(pool, dest):
    """The pool's data files hard-linked into an index-less directory."""
    os.makedirs(dest)
    for name in sorted(os.listdir(pool)):
        if name.endswith((".h5", ".tdas")):
            os.link(os.path.join(pool, name), os.path.join(dest, name))
    return str(dest)


def _assert_same_records(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        ra, rb = a[name], b[name]
        assert sorted(ra) == sorted(rb), name
        for key in ra:
            assert type(ra[key]) is type(rb[key]), (name, key)
            assert np.array_equal(ra[key], rb[key]), (name, key)


def _no_rescan(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a cached record was scanned again")

    monkeypatch.setattr(jregistry, "scan_file", refuse)
    monkeypatch.setattr(tregistry, "scan_file", refuse)


def _plans(t_records, j_records):
    """The same window planned from both packages' records."""
    lo = T1 + np.timedelta64(20, "s")
    hi = T1 + np.timedelta64(75, "s")

    def ordered(recs):
        return sorted(recs.values(), key=lambda r: r["time_min"])

    return (tplan(ordered(t_records), lo, hi, (5.0, 40.0)),
            jplan(ordered(j_records), lo, hi, (5.0, 40.0)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_cache_read_across_packages(pool, tmp_path, monkeypatch,
                                          writer):
    """A cache either package writes loads in the other with the same
    records (no file scanned again) and the same window plan."""
    d = _fresh(pool, tmp_path / "src")
    (TIndex if writer == "port" else JIndex)(d).update()
    assert os.path.isfile(os.path.join(d, INDEX_FILENAME))
    _no_rescan(monkeypatch)
    t_idx, j_idx = TIndex(d).update(), JIndex(d).update()
    assert len(t_idx._records) == 4  # the cache file itself is no record
    _assert_same_records(t_idx._records, j_idx._records)
    t_plan, j_plan = _plans(t_idx._records, j_idx._records)
    if "tdas" in pool:
        assert t_plan is not None
        assert t_plan == j_plan
    else:
        assert t_plan is None and j_plan is None


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_stale_cache_version_discarded(pool, tmp_path, monkeypatch, reader):
    """A cache of another version is discarded whole: every file is
    scanned again, and the cache is rewritten at the current version."""
    d = _fresh(pool, tmp_path / "src")
    TIndex(d).update()
    path = os.path.join(d, INDEX_FILENAME)
    with open(path) as fh:
        raw = json.load(fh)
    raw.pop("_crc32")
    raw["version"] = 2
    jwrite_json(path, raw)
    idx = (TIndex if reader == "port" else JIndex)(d)
    idx._load_cache()
    assert idx._records == {}
    scanned = []
    reg = tregistry if reader == "port" else jregistry
    real = reg.scan_file
    monkeypatch.setattr(reg, "scan_file",
                        lambda p, **k: scanned.append(p) or real(p, **k))
    idx.update()
    assert len(scanned) == 4
    with open(path) as fh:
        assert json.load(fh)["version"] == 3


def test_index_cache_falls_back_to_prev(pool, tmp_path, monkeypatch):
    """A torn primary falls back to the ``.prev`` double buffer."""
    d = _fresh(pool, tmp_path / "src")
    TIndex(d).update()
    path = os.path.join(d, INDEX_FILENAME)
    os.replace(path, path + ".prev")
    with open(path, "w") as fh:
        fh.write('{"version": 3, "fi')
    _no_rescan(monkeypatch)
    assert len(TIndex(d).update()._records) == 4


@pytest.mark.parametrize("seconds", [7.0, 30.0, 0.001])
def test_chunk_time_matches_jax(seconds):
    """Merge then re-split into fixed-length segments, as the JAX
    package does (the last segment shorter)."""
    kw = dict(duration=20.0, fs=50.0, n_ch=4, noise=0.01)
    t_parts = [tpatch(t0=T1 + np.timedelta64(20 * i, "s"), **kw)
               for i in range(3)]
    j_parts = [jpatch(t0=T1 + np.timedelta64(20 * i, "s"), **kw)
               for i in range(3)]
    got = TMemorySpool(t_parts).chunk(time=seconds)
    ref = JMemorySpool(j_parts).chunk(time=seconds)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert np.array_equal(a.coords["time"], b.coords["time"])
        assert np.array_equal(a.coords["distance"], b.coords["distance"])
        assert np.array_equal(a.host_data(), np.asarray(b.host_data()))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_chunk_time_needs_a_time_step(package):
    """A single-sample patch without a step cannot be segmented: both
    packages raise the same error."""
    cls, spool_cls = ((Patch, TMemorySpool) if package == "port"
                      else (JPatch, JMemorySpool))
    one = cls(data=np.zeros((1, 3), np.float32),
              coords={"time": np.array([T1]), "distance": np.arange(3.0)},
              dims=("time", "distance"))
    with pytest.raises(ValueError, match="known time_step"):
        spool_cls([one]).chunk(time=1.0)


@pytest.mark.parametrize("args", [
    (14000, 1000.0, 10000),
    (70000, 1000.0, 10000, 2, 3.5, 1.0),
    (512, 200.0, 16, 4),
])
def test_get_patch_time_matches_jax(args):
    assert get_patch_time(*args) == jget_patch_time(*args)


def _run_port(src, out, **para):
    lfp = LFProc(tspool(src).sort("time").update(), device="cpu")
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=40, edge_buff_size=10,
        **para)
    lfp.set_output_folder(str(out), delete_existing=True)
    lfp.process_time_range(T1, T2)
    return lfp


def test_staged_lfproc_byte_identical_to_serial_and_close_to_jax(
        pool, tmp_path, monkeypatch):
    tdas_spool = "tdas" in pool
    staged = _run_port(pool, tmp_path / "staged")
    windows = sum(staged.engine_counts.values())
    assert windows == 5
    assert staged.staged_windows == windows
    assert staged.native_windows == (windows if tdas_spool else 0)
    monkeypatch.setenv("TPUDAS_H2D_STAGE", "0")
    serial = _run_port(pool, tmp_path / "serial")
    assert serial.staged_windows == 0
    monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    numpy_read = _run_port(pool, tmp_path / "numpy")
    assert numpy_read.native_windows == 0
    names = sorted(os.listdir(tmp_path / "staged"))
    assert len(names) == windows
    for other in ("serial", "numpy"):
        assert sorted(os.listdir(tmp_path / other)) == names
        for n in names:
            assert filecmp.cmp(tmp_path / "staged" / n, tmp_path / other / n,
                               shallow=False), (other, n)
    monkeypatch.delenv("TPUDAS_H2D_STAGE")
    monkeypatch.delenv("TPUDAS_NO_NATIVE")
    jlfp = JLFProc(jspool(pool).sort("time").update())
    jlfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=40, edge_buff_size=10)
    jlfp.set_output_folder(str(tmp_path / "jax"), delete_existing=True)
    jlfp.process_time_range(T1, T2)
    assert sorted(os.listdir(tmp_path / "jax")) == names
    for n in names:
        a = tspool(str(tmp_path / "staged" / n))[0].host_data()
        b = tspool(str(tmp_path / "jax" / n))[0].host_data()
        scale = np.abs(b).max(axis=0)
        assert (np.abs(a - b).max(axis=0) <= REL_TOL * scale).all()


def _schedule(n):
    grid = T1 + np.arange(n * 10 + 12) * np.timedelta64(1, "s")
    return grid, [(10 * i, 10 * i + 12, 10 * i + 1, 10 * i + 11)
                  for i in range(n)]


def test_prefetch_reads_exactly_one_window_ahead():
    """Window N+1 is asked for before window N is processed, and window
    N+2 only after: the two staging buffers are never overrun."""
    lfp = LFProc(device="cpu")
    grid, windows = _schedule(5)
    asked = []

    def loader(bg, ed, on_gap):
        asked.append(bg)
        return bg

    seen = []
    for i, loaded, emit in lfp._iter_windows(grid, windows, "raise", loader):
        assert loaded == grid[windows[i][0]]
        assert emit[0] == grid[windows[i][2]]
        # the read ahead starts while window i is processed ...
        deadline = time.monotonic() + 10.0
        while len(asked) < min(i + 2, 5) and time.monotonic() < deadline:
            time.sleep(0.001)
        # ... and goes no further, however long the processing takes
        time.sleep(0.02)
        seen.append(len(asked))
    assert seen == [2, 3, 4, 5, 5]


def test_prefetch_failure_reaches_the_consumer():
    lfp = LFProc(device="cpu")
    grid, windows = _schedule(4)

    def loader(bg, ed, on_gap):
        if bg == grid[windows[2][0]]:
            raise OSError("torn read")
        return bg

    done = []
    with pytest.raises(OSError, match="torn read"):
        for i, _loaded, _emit in lfp._iter_windows(grid, windows, "raise",
                                                   loader):
            done.append(i)
    assert done == [0, 1]
