"""tpudas_torch's real-time low-pass path against the JAX package's.

Small spools (100 Hz x 6 channels, 30 s files; dasdae and int16 tdas)
are written once by the JAX package's ``make_synthetic_spool`` and
hard-linked into each run's source folder, a few files at a time, so a
run sees its spool grow between polls.  The port runs on the CPU (plain
PyTorch stages).  Output file names must be identical; data agree
within 1e-5 of each channel's scale (same f32 products, other order),
and stream against batch within 1e-4 of the global maximum on the
common interior (the bound of ``tests/test_stream_state.py``).  The
carry file crosses between the packages in both directions.
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.testing import make_synthetic_spool
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.proc import stream as tstream
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.utils.logging import set_log_handler
from tpudas_torch.utils.profiling import Counters

FS = 100.0
FILE_SEC = 30.0
NCH = 6
T0 = "2023-03-22T00:00:00"
REL_TOL = 1e-5
PARAMS = dict(output_sample_interval=1.0, edge_buffer=8.0,
              process_patch_size=40)

FORMATS = {
    "dasdae": ("dasdae", None),
    "tdas-int16": ("tdas", {"dtype": "int16", "scale": 1e-4}),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def pool(request, tmp_path_factory):
    """Five contiguous files; each run links the first few of them."""
    fmt, wk = FORMATS[request.param]
    d = tmp_path_factory.mktemp(f"pool-{request.param}")
    make_synthetic_spool(d, n_files=5, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01, format=fmt, write_kwargs=wk)
    return str(d)


@pytest.fixture
def fused_env(monkeypatch):
    """The spools are tiny: clear the fused size threshold (in both
    packages) so engine='fused' really runs the fused step."""
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    for name in sorted(os.listdir(pool))[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _drive(driver, pool, src, out, first=3, then=None, **kw):
    """Link ``first`` files, run the driver; each sleep links up to the
    next count in ``then`` (one more round each)."""
    _link(pool, src, first)
    feeds = list(then or [])

    def sleep(_):
        if feeds:
            _link(pool, src, feeds.pop(0))

    kw.setdefault("stateful", True)
    if driver is run_lowpass_realtime:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("flight", False)
    return driver(source=src, output_folder=out, start_time=T0,
                  poll_interval=0.0, file_duration=0.0, sleep_fn=sleep,
                  **PARAMS, **kw)


def _products(out):
    return sorted(n for n in os.listdir(out) if n.startswith("LFDAS_"))


def _merged(out):
    merged = tspool(out).update().chunk(time=None)
    assert len(merged) == 1, "the stream output has a seam"
    return merged[0]


def _assert_same_stream(out_a, out_b):
    """Identical names and time grid, data within REL_TOL per channel."""
    assert _products(out_a) == _products(out_b)
    assert _products(out_a)
    a, b = _merged(out_a), _merged(out_b)
    assert np.array_equal(a.coords["time"], b.coords["time"])
    da, db = a.host_data(), b.host_data()
    scale = np.abs(db).max(axis=0)
    assert (np.abs(da - db).max(axis=0) <= REL_TOL * scale).all()


def _common_interior(a, b):
    lo = max(a.coords["time"][0], b.coords["time"][0])
    hi = min(a.coords["time"][-1], b.coords["time"][-1])
    av = a.select(time=(lo, hi)).host_data()
    bv = b.select(time=(lo, hi)).host_data()
    assert av.shape == bv.shape and av.size > 0
    return av, bv


def _port_lfp(src, out, delete=True):
    lfp = LFProc(tspool(src).sort("time").update(), device="cpu")
    lfp.update_processing_parameter(output_sample_interval=1.0,
                                    process_patch_size=40, edge_buff_size=8)
    lfp.set_output_folder(out, delete_existing=delete)
    return lfp


def test_increments_match_batch(pool, tmp_path):
    src = str(tmp_path / "src")
    _link(pool, src, 3)
    batch = _port_lfp(src, str(tmp_path / "batch"))
    tmax = np.datetime64(T0) + np.timedelta64(90, "s")
    batch.process_time_range(np.datetime64(T0), tmax)
    ref = _merged(str(tmp_path / "batch"))
    lfp = _port_lfp(src, str(tmp_path / "stream"))
    carry = lfp.open_stream(np.datetime64(T0))
    for t2 in (np.datetime64(T0) + np.timedelta64(35, "s"),
               np.datetime64(T0) + np.timedelta64(61, "s"), tmax):
        lfp.process_stream_increment(carry, t2)
    assert carry.kind == "cascade"
    assert lfp.stream_blocks and set(lfp.stream_blocks) == {"cascade-torch"}
    for leaf in carry.bufs:
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    av, bv = _common_interior(_merged(str(tmp_path / "stream")), ref)
    assert np.abs(av - bv).max() / np.abs(bv).max() < 1e-4


@pytest.mark.parametrize("engine", ["auto", "fused", "fft"])
def test_driver_matches_jax(pool, tmp_path, engine, fused_env):
    blocks = {}

    def count(_rnd, lfp):
        for k, v in lfp.stream_blocks.items():
            blocks[k] = blocks.get(k, 0) + v

    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _drive(run_lowpass_realtime, pool, str(tmp_path / "s1"), port_out,
                  then=[5], engine=engine, on_round=count) == 2
    assert _drive(jax_realtime, pool, str(tmp_path / "s2"), jax_out,
                  then=[5], engine=engine) == 2
    _assert_same_stream(port_out, jax_out)
    want = {"fused": "fused-torch", "fft": "fft"}.get(engine, "cascade-torch")
    assert set(blocks) == {want} and blocks[want] > 0


@pytest.mark.parametrize("first", ["jax", "port"])
def test_carry_resumes_across_packages(pool, tmp_path, first):
    """A carry written by one package resumes under the other; the
    resumed run equals an uninterrupted JAX run."""
    one, two = ((jax_realtime, run_lowpass_realtime) if first == "jax"
                else (run_lowpass_realtime, jax_realtime))
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(one, pool, src, out) == 1
    assert os.path.isfile(os.path.join(out, tstream.CARRY_FILENAME))
    saved = tstream.load_carry(out)
    assert saved is not None and saved.kind == "cascade"
    if "tdas" in os.path.basename(pool):
        assert saved.residual.dtype == np.int16
    _link(pool, src, 5)
    assert _drive(two, pool, src, out, first=5) == 1
    ctrl = str(tmp_path / "ctrl")
    assert _drive(jax_realtime, pool, str(tmp_path / "csrc"), ctrl,
                  then=[5]) == 2
    _assert_same_stream(out, ctrl)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_fft_carry_resumes_across_packages(pool, tmp_path, first):
    """An FFT-kind carry written by one package resumes under the other
    (engine="fft"); the resumed run equals an uninterrupted JAX run."""
    one, two = ((jax_realtime, run_lowpass_realtime) if first == "jax"
                else (run_lowpass_realtime, jax_realtime))
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(one, pool, src, out, engine="fft") == 1
    saved = tstream.load_carry(out)
    assert saved is not None and saved.kind == "fft"
    assert saved.edge_in == 800 and len(saved.bufs) == 2
    assert saved.bufs[0].shape == (1600, NCH) and saved.bufs[1].shape == (1, NCH)
    if "tdas" in os.path.basename(pool):
        assert saved.residual.dtype == np.int16
    _link(pool, src, 5)
    assert _drive(two, pool, src, out, first=5, engine="fft") == 1
    ctrl = str(tmp_path / "ctrl")
    assert _drive(jax_realtime, pool, str(tmp_path / "csrc"), ctrl,
                  then=[5], engine="fft") == 2
    _assert_same_stream(out, ctrl)


def test_fft_carry_crossover_rule(pool, tmp_path):
    """An FFT carry resumes under "auto" (and "fft"), never under a
    cascade-only request, in both packages."""
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(run_lowpass_realtime, pool, src, out, engine="fft") == 1
    carry = tstream.load_carry(out)
    assert carry.engine_req == "fft"
    assert tstream._engines_compatible("auto", "auto", "fft")
    assert not tstream._engines_compatible("auto", "cascade", "fft")
    assert not tstream._engines_compatible("fft", "fused", "fft")
    _link(pool, src, 4)
    with pytest.raises(ValueError, match="different start_time"):
        _drive(run_lowpass_realtime, pool, src, out, first=4, engine="cascade")


def test_auto_on_a_non_aligned_grid_streams_fft(pool, tmp_path):
    """A 1.1 s grid over 100 Hz samples (ratio 110 = 2*5*11, a prime
    factor above 8): under "auto" both packages open the FFT stream and
    emit the same files."""
    blocks = {}

    def count(_rnd, lfp):
        for k, v in lfp.stream_blocks.items():
            blocks[k] = blocks.get(k, 0) + v

    kw = dict(PARAMS, output_sample_interval=1.1)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    for driver, src, out in ((run_lowpass_realtime, "s1", port_out),
                             (jax_realtime, "s2", jax_out)):
        _link(pool, str(tmp_path / src), 5)
        extra = {"device": "cpu", "on_round": count} if (
            driver is run_lowpass_realtime) else {"flight": False}
        assert driver(source=str(tmp_path / src), output_folder=out,
                      start_time=T0, poll_interval=0.0, file_duration=0.0,
                      sleep_fn=lambda _: None, stateful=True, **kw,
                      **extra) == 1
    assert tstream.load_carry(port_out).kind == "fft"
    assert set(blocks) == {"fft"}
    _assert_same_stream(port_out, jax_out)


def test_stateful_matches_rewind(pool, tmp_path):
    outs, ctr = {}, {}
    for mode, flag in (("rewind", False), ("stateful", True)):
        ctr[mode] = Counters()
        out = str(tmp_path / mode)
        assert _drive(run_lowpass_realtime, pool, str(tmp_path / f"s{mode}"),
                      out, then=[5], stateful=flag,
                      counters=ctr[mode]) == 2
        outs[mode] = _merged(out)
    assert ctr["rewind"].samples_redundant > 0
    assert ctr["stateful"].samples_redundant == 0
    assert ctr["stateful"].realtime_factor > 0
    av, bv = _common_interior(outs["stateful"], outs["rewind"])
    assert np.abs(av - bv).max() / np.abs(bv).max() < 1e-4


def test_crash_between_write_and_carry_save_reconciles(pool, tmp_path,
                                                        monkeypatch):
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(run_lowpass_realtime, pool, src, out) == 1
    before = tstream.load_carry(out)

    def crash(*_a, **_k):
        raise RuntimeError("killed before the carry save")

    _link(pool, src, 5)
    with monkeypatch.context() as m:
        m.setattr(tstream, "save_carry", crash)
        with pytest.raises(RuntimeError, match="killed"):
            _drive(run_lowpass_realtime, pool, src, out, first=5)
    # the round's outputs reached the disk, its carry did not
    stale = tstream.load_carry(out)
    assert stale.last_emit_ns == before.last_emit_ns
    newest = max(_products(out))
    events = []
    set_log_handler(events.append)
    try:
        assert _drive(run_lowpass_realtime, pool, src, out, first=5) == 1
    finally:
        set_log_handler(None)
    assert [e for e in events if e["event"] == "stream_reconcile_removed"]
    assert newest in _products(out)  # regenerated under its own name
    # the control rounds see the same files: 3, then 5
    ctrl = str(tmp_path / "ctrl")
    assert _drive(run_lowpass_realtime, pool, str(tmp_path / "csrc"), ctrl,
                  then=[5]) == 2
    _assert_same_stream(out, ctrl)


def test_changed_configuration_is_rejected(pool, tmp_path):
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(run_lowpass_realtime, pool, src, out) == 1
    _link(pool, src, 4)
    with pytest.raises(ValueError, match="different start_time"):
        run_lowpass_realtime(
            source=src, output_folder=out,
            start_time="2023-03-22T00:00:30", poll_interval=0.0,
            sleep_fn=lambda _: None, stateful=True, device="cpu", **PARAMS)
    with pytest.raises(ValueError, match="different start_time"):
        run_lowpass_realtime(
            source=src, output_folder=out, start_time=T0,
            poll_interval=0.0, sleep_fn=lambda _: None, stateful=True,
            device="cpu", output_sample_interval=1.0, edge_buffer=5.0,
            process_patch_size=40)


def _pyramid_tree(folder):
    """{relpath: sha256} of ``<folder>/.tiles`` (``.prev`` rungs and tmp
    leftovers excluded: they depend on the append schedule)."""
    import hashlib

    tiles = os.path.join(folder, ".tiles")
    out = {}
    for dirpath, _d, files in os.walk(tiles):
        for name in sorted(files):
            if ".prev" in name or ".tmp" in name:
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, tiles)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _assert_pyramid_of_outputs(out, scratch):
    """The runner's incremental pyramid equals the one-shot sync over
    copies of its own output files, by the port and by the JAX package
    (the tree ``rebuild_pyramid`` writes, generation aside)."""
    from tpudas.serve.tiles import sync_pyramid as jax_sync
    from tpudas_torch.serve.tiles import sync_pyramid

    got = _pyramid_tree(out)
    assert "manifest.json" in got and "tails.npy" in got
    assert any(k.startswith("L1/") for k in got)  # completed tiles
    for name, sync in (("port", sync_pyramid), ("jax", jax_sync)):
        d = os.path.join(scratch, f"pyramid-{name}")
        os.makedirs(d)
        for n in _products(out):
            os.link(os.path.join(out, n), os.path.join(d, n))
        sync(d)
        assert _pyramid_tree(d) == got, name


# the health and flight artifacts hold wall-clock times: compared by name
# and keys, never by bytes
TIMING_ARTIFACTS = (".flight", "health.json", "health.json.prev",
                    "metrics.prom")


def _assert_obs_artifacts(out, jout, keyword):
    """The port's run ``out`` left the artifact of ``keyword`` as the JAX
    run ``jout`` did: the same names in the folder; a ``health.json``
    that each package reads and validates, with the JAX keys, and a
    ``metrics.prom`` naming the JAX one's metrics (the device
    telemetry's among them unless ``TPUDAS_DEVPROF=0``; its compile
    counters follow each package's own compiles); a flight ring
    whose records the JAX reader verifies, with the JAX record kinds,
    the same round-record keys and the same launches a round."""
    from tpudas.obs.flight import read_flight as jax_read_flight
    from tpudas.obs.health import read_health as jax_read_health
    from tpudas_torch.obs.devprof import devprof_enabled
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.obs.health import read_health

    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    if keyword == "health":
        for folder in (out, jout):
            assert os.path.isfile(os.path.join(folder, "metrics.prom"))
        got, want = jax_read_health(out), read_health(jout)
        assert got is not None and want is not None
        assert sorted(got) == sorted(want)
        assert read_health(out) == got
        assert got["rounds"] == want["rounds"] and got["last_error"] is None

        def names(folder):
            text = open(os.path.join(folder, "metrics.prom")).read()
            return {ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE")}

        # every metric of the JAX run, down to the lower layers (spool,
        # window, block counters): the same names.  The device
        # telemetry's may differ: JAX counts the compiles its process
        # has not cached yet, and the port compiles nothing on the CPU;
        # its launch and device-second counters are in both (below)
        devprof = {n for n in names(out) | names(jout)
                   if n.startswith("tpudas_devprof_")}
        assert names(out) - devprof == names(jout) - devprof
        assert {"tpudas_stream_rounds_total", "tpudas_health_writes_total",
                "tpudas_stream_round_phase_seconds",
                "tpudas_stream_head_lag_seconds"} <= names(out)
        # the parallel layer's gauge and the carry save's gather bytes
        parallel_names = {"tpudas_parallel_shards",
                          "tpudas_parallel_transfer_bytes_total"}
        for folder in (out, jout):
            assert parallel_names <= names(folder), folder
        devprof_names = {"tpudas_devprof_launches_total",
                         "tpudas_devprof_device_seconds_total"}
        for folder in (out, jout):
            assert (devprof_names <= names(folder)) == devprof_enabled()
        return
    recs, jrecs = jax_read_flight(out), jax_read_flight(jout)
    assert recs == read_flight(out) and recs
    assert ([r["kind"] for r in recs if r["kind"] != "span"]
            == [r["kind"] for r in jrecs if r["kind"] != "span"])
    rounds = [r for r in recs if r["kind"] == "round"]
    jrounds = [r for r in jrecs if r["kind"] == "round"]
    assert [sorted(r) for r in rounds] == [sorted(r) for r in jrounds]
    assert [r["round"] for r in rounds] == [r["round"] for r in jrounds]
    # the round's device telemetry: the same launches, and device
    # seconds of the port's own, the round's device_execute; under
    # TPUDAS_DEVPROF=0 both packages stamp the same zero fields
    for r, j in zip(rounds, jrounds):
        assert sorted(r["devprof"]) == sorted(j["devprof"])
        assert r["devprof"]["launches"] == j["devprof"]["launches"]
        if devprof_enabled():
            assert r["devprof"]["launches"] > 0
            assert r["devprof"]["device_execute_s"] > 0.0
        else:
            assert r["devprof"] == j["devprof"] == {
                "launches": 0.0, "device_execute_s": 0.0, "bound": None,
                "utilization": None}
        assert r["phases"]["device_execute"] == pytest.approx(
            r["devprof"]["device_execute_s"], abs=1e-6)


@pytest.mark.parametrize("keyword,value", [
    ("mesh", 2), ("window_dp", 2), ("health", True), ("pyramid", True),
    ("live", True), ("flight", True),
])
def test_unported_keywords_raise(tmp_path, keyword, value, request,
                                 monkeypatch):
    """Every keyword of the JAX driver is ported: ``mesh`` shards the
    stateful stream (``tpudas_parallel_shards`` 2 in both packages) and
    ``window_dp`` sends it to the window path, each giving the JAX
    driver's stream; ``pyramid`` builds the tile pyramid; ``health`` and
    ``flight`` leave the JAX driver's artifacts; ``live`` registers a hub
    for the folder that publishes every round, as the JAX driver's
    does."""
    if keyword in ("mesh", "window_dp"):
        from tpudas.obs import registry as jax_registry
        from tpudas_torch.obs import registry as port_registry

        pool = request.getfixturevalue("env_pool")
        outs = {}
        for name, driver, registry in (
                ("port", run_lowpass_realtime, port_registry),
                ("jax", jax_realtime, jax_registry)):
            outs[name] = str(tmp_path / name)
            reg = registry.MetricsRegistry()
            with registry.use_registry(reg):
                assert _drive(driver, pool, str(tmp_path / f"src-{name}"),
                              outs[name], first=2, then=[3],
                              **{keyword: value}) == 2
            shards = reg.get("tpudas_parallel_shards").value()
            assert shards == (2 if keyword == "mesh" else 1), name
            # window_dp runs the window path in both packages: no carry
            assert os.path.exists(os.path.join(
                outs[name], tstream.CARRY_FILENAME)) == (keyword == "mesh"), name
        _assert_same_stream(outs["port"], outs["jax"])
        return
    if keyword == "live":
        from tpudas.live.hub import find_hub as jax_find_hub
        from tpudas_torch.live.hub import find_hub

        pool = request.getfixturevalue("env_pool")
        outs = {}
        for name, driver, finder in (
                ("port", run_lowpass_realtime, find_hub),
                ("jax", jax_realtime, jax_find_hub)):
            outs[name] = str(tmp_path / name)
            assert _drive(driver, pool, str(tmp_path / f"src-{name}"),
                          outs[name], first=2, then=[3], live=value) == 2
            hub = finder(folder=os.path.abspath(outs[name]))
            assert hub is not None and hub.seq == 2, name
            assert [f.n_rows() for f in hub._ring] and all(
                f.n_rows() > 0 for f in hub._ring), name
        _assert_same_stream(outs["port"], outs["jax"])
        return
    if keyword in ("health", "flight"):
        pool = request.getfixturevalue("env_pool")
        # the device telemetry is on in both packages (its default)
        monkeypatch.delenv("TPUDAS_DEVPROF", raising=False)
        from tpudas.obs import registry as jax_registry
        from tpudas_torch.obs import registry as port_registry

        outs = {}
        for name, driver, registry in (
                ("port", run_lowpass_realtime, port_registry),
                ("jax", jax_realtime, jax_registry)):
            outs[name] = str(tmp_path / name)
            kw = {keyword: value}
            if name == "jax" and keyword == "health":
                kw["flight"] = None  # the JAX default, as the port's
            # each run's metrics.prom holds that run's metrics only
            with registry.use_registry(registry.MetricsRegistry()):
                assert _drive(driver, pool, str(tmp_path / f"src-{name}"),
                              outs[name], first=2, then=[3], **kw) == 2
        _assert_obs_artifacts(outs["port"], outs["jax"], keyword)
        _assert_same_stream(outs["port"], outs["jax"])
        return
    if keyword == "pyramid":
        pool = request.getfixturevalue("env_pool")
        # small tiles, so that the stream completes some (16 rows)
        request.getfixturevalue("monkeypatch").setenv(
            "TPUDAS_PYRAMID_TILE_LEN", "16")
        out = str(tmp_path / "o")
        assert _drive(run_lowpass_realtime, pool, str(tmp_path / "src"),
                      out, first=2, then=[3], pyramid=value) == 2
        _assert_pyramid_of_outputs(out, str(tmp_path))
        return
    raise AssertionError(f"no case for {keyword!r}")


@pytest.mark.parametrize("keyword", ["rolling_window", "rolling_step"])
def test_rolling_keywords_without_folder_raise(tmp_path, keyword):
    """As in the JAX package (tests/test_streaming.py): without a
    rolling_output_folder no rolling product would be written."""
    with pytest.raises(ValueError, match="rolling_output_folder"):
        run_lowpass_realtime(
            source=str(tmp_path / "src"), output_folder=str(tmp_path / "o"),
            start_time=T0, sleep_fn=lambda _: None, device="cpu",
            **{keyword: 3.0}, **PARAMS)
    assert not os.path.exists(tmp_path / "o")


def test_inert_keywords_and_device_default(tmp_path, monkeypatch, pool):
    """fault_policy and quarantine are accepted (the fault boundary's
    own tests are in test_torch_faults.py); the unported keywords at
    their off values are accepted; without a card and without
    device='cpu' the driver raises."""
    from tpudas_torch.resilience.faults import RetryPolicy

    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(run_lowpass_realtime, pool, src, out,
                  fault_policy=RetryPolicy(), quarantine=False, mesh=None,
                  flight=False) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_lowpass_realtime(source=src, output_folder=str(tmp_path / "o2"),
                             start_time=T0, sleep_fn=lambda _: None,
                             **PARAMS)


def test_single_sample_tdas_round_trips(tmp_path):
    """A stream emits one-sample blocks; written as tdas (the card's
    host has no h5py) they keep their step and merge with their
    neighbours."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.testing import synthetic_patch

    p = synthetic_patch(t0=np.datetime64(T0), duration=5.0, fs=1.0, n_ch=4)
    step = np.timedelta64(1, "s")
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        part = p.select(time=(p.coords["time"][lo], p.coords["time"][hi - 1]))
        part = part.update_attrs(d_time=1.0)
        write_tdas(part, str(tmp_path / f"LFDAS_{lo}.tdas"))
    one = tspool(str(tmp_path / "LFDAS_2.tdas"))[0]
    assert one.attrs["time_step"] == step
    merged = tspool(str(tmp_path)).update().chunk(time=None)
    assert len(merged) == 1
    np.testing.assert_array_equal(merged[0].coords["time"], p.coords["time"])
    np.testing.assert_allclose(merged[0].host_data(), p.host_data())


# ---------------------------------------------------------------------------
# features the JAX runners turn on from the environment (ROADMAP C3)

# variable -> (config field, what the JAX driver leaves behind); the
# pyramid, the health files and the live hub are ported: under
# TPUDAS_PYRAMID, TPUDAS_HEALTH and TPUDAS_LIVE the port builds them too
ENV_FEATURES = {
    "TPUDAS_HEALTH": ("health", "health.json"),
    "TPUDAS_PYRAMID": ("pyramid", ".tiles"),
    "TPUDAS_LIVE": ("live", "live hub"),
}


@pytest.fixture(scope="module")
def env_pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool-env")
    make_synthetic_spool(d, n_files=3, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    return str(d)


def _lowpass_entry_points(src, out):
    """Every way a caller starts a port low-pass stream, each a thunk."""
    from tpudas_torch.fleet import (
        FleetEngine,
        LowpassStreamRunner,
        StreamConfig,
        StreamSpec,
        build_runner,
    )

    spec = StreamSpec(
        stream_id="env", source=src, output_folder=out,
        config=StreamConfig(kind="lowpass", start_time=T0, **PARAMS))
    return {
        "run_lowpass_realtime": lambda: run_lowpass_realtime(
            source=src, output_folder=out, start_time=T0,
            sleep_fn=lambda _: None, device="cpu", **PARAMS),
        "build_runner": lambda: build_runner(spec, device="cpu"),
        "LowpassStreamRunner": lambda: LowpassStreamRunner(
            spec, out, device="cpu"),
        "FleetEngine": lambda: FleetEngine(out, [spec], device="cpu"),
    }


def _check_env_pyramid(env_pool, tmp_path, jout):
    """``TPUDAS_PYRAMID=1`` (set by the caller): every port entry point
    builds a stream with the pyramid on, and the driver's tree equals
    the one-shot syncs over its own outputs and the JAX driver's tree
    over the same files (the JAX driver's own outputs differ from the
    port's within 1e-5, so its tree is compared after re-syncing the
    port's files, and its level counts directly)."""
    from tpudas.serve.tiles import TileStore as JStore
    from tpudas_torch.serve.tiles import TileStore

    src = str(tmp_path / "src")
    for name in ("build_runner", "LowpassStreamRunner", "FleetEngine"):
        obj = _lowpass_entry_points(src, str(tmp_path / f"ep-{name}"))[
            name]()
        runners = ([st.runner for st in obj.streams.values()]
                   if name == "FleetEngine" else [obj])
        assert all(r.pyramid for r in runners), name
    out = str(tmp_path / "port")
    assert _drive(run_lowpass_realtime, env_pool, src, out) == 1
    _assert_pyramid_of_outputs(out, str(tmp_path))
    assert TileStore.open(out).levels == JStore.open(jout).levels


@pytest.mark.parametrize("var", sorted(ENV_FEATURES))
def test_env_feature_jax_writes_port_raises(env_pool, tmp_path, monkeypatch,
                                            var):
    """Under the variable the JAX driver turns its feature on (and leaves
    its artifact); every one of these features is ported now
    (``TPUDAS_PYRAMID``, ``TPUDAS_HEALTH``, ``TPUDAS_LIVE``): every port
    entry point turns it on and the driver writes what the JAX one
    does."""
    _field, artifact = ENV_FEATURES[var]
    monkeypatch.setenv(var, "1")
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    jout = str(tmp_path / "jax")
    from tpudas.obs import registry as jax_registry

    with jax_registry.use_registry(jax_registry.MetricsRegistry()):
        assert _drive(jax_realtime, env_pool, str(tmp_path / "src"),
                      jout) == 1
    if var == "TPUDAS_LIVE":
        from tpudas.live.hub import find_hub

        assert find_hub(folder=os.path.abspath(jout)) is not None
    else:
        assert os.path.exists(os.path.join(jout, artifact))
    if var == "TPUDAS_PYRAMID":
        _check_env_pyramid(env_pool, tmp_path, jout)
        return
    out = str(tmp_path / "port")
    if var == "TPUDAS_LIVE":
        # ported: every entry point registers a hub for its folder, and
        # the driver publishes its round to it
        from tpudas_torch.live.hub import find_hub

        for name in ("build_runner", "LowpassStreamRunner", "FleetEngine"):
            obj = _lowpass_entry_points(
                str(tmp_path / "src"), str(tmp_path / f"ep-{name}"))[name]()
            runners = ([st.runner for st in obj.streams.values()]
                       if name == "FleetEngine" else [obj])
            assert all(r.live and find_hub(folder=os.path.abspath(
                r.output_folder)) is r.live_hub for r in runners), name
        assert _drive(run_lowpass_realtime, env_pool,
                      str(tmp_path / "src2"), out) == 1
        hub = find_hub(folder=os.path.abspath(out))
        assert hub is not None and hub.seq == 1
        return
    # TPUDAS_HEALTH, ported: every entry point turns health on, and the
    # driver's snapshot agrees with the JAX driver's
    for name in ("build_runner", "LowpassStreamRunner", "FleetEngine"):
        obj = _lowpass_entry_points(
            str(tmp_path / "src"), str(tmp_path / f"ep-{name}"))[name]()
        runners = ([st.runner for st in obj.streams.values()]
                   if name == "FleetEngine" else [obj])
        assert all(r.edge_health.enabled for r in runners), name
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry

    with use_registry(MetricsRegistry()):  # this run's metrics only
        assert _drive(run_lowpass_realtime, env_pool,
                      str(tmp_path / "src2"), out, flight=False) == 1
    _assert_obs_artifacts(out, jout, "health")


@pytest.mark.parametrize("raw,sharded", [("2", True), ("1", False),
                                         ("0", False), ("", False)])
def test_env_mesh(env_pool, tmp_path, monkeypatch, raw, sharded):
    """``TPUDAS_MESH=N`` is a mesh over N devices in both packages (0
    and 1: none; the port's CPU runs take N logical CPU shards): every
    port entry point holds the mesh, both drivers set
    ``tpudas_parallel_shards`` to N, and the port's sharded stream is
    byte for byte its unsharded one and the JAX driver's within 1e-5."""
    from tpudas.obs import registry as jax_registry
    from tpudas_torch.obs import registry as port_registry

    monkeypatch.setenv("TPUDAS_MESH", raw)
    src, out = str(tmp_path / "src"), str(tmp_path / "port")
    _link(env_pool, src, 3)
    for name, start in _lowpass_entry_points(
            src, str(tmp_path / "ep")).items():
        if name == "run_lowpass_realtime":
            continue
        obj = start()
        runners = ([st.runner for st in obj.streams.values()]
                   if name == "FleetEngine" else [obj])
        assert all((r.mesh is not None) == sharded for r in runners), name
    want = 2 if sharded else 1
    outs = {}
    for name, driver, registry in (
            ("port", run_lowpass_realtime, port_registry),
            ("jax", jax_realtime, jax_registry)):
        outs[name] = str(tmp_path / name)
        reg = registry.MetricsRegistry()
        with registry.use_registry(reg):
            assert _drive(driver, env_pool, src, outs[name]) == 1
        assert reg.get("tpudas_parallel_shards").value() == want, name
    _assert_same_stream(outs["port"], outs["jax"])
    monkeypatch.setenv("TPUDAS_MESH", "0")
    ctrl = str(tmp_path / "single")
    assert _drive(run_lowpass_realtime, env_pool, src, ctrl) == 1
    assert _products(ctrl) == _products(outs["port"])
    for name in (*_products(ctrl), tstream.CARRY_FILENAME):
        with open(os.path.join(ctrl, name), "rb") as a, \
                open(os.path.join(outs["port"], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("raw,ring", [("1", True), ("0", False)])
def test_env_flight(env_pool, tmp_path, monkeypatch, raw, ring):
    """The flight recorder is on unless ``TPUDAS_FLIGHT=0`` in both
    packages: at ``1`` both drivers (the JAX one with ``flight=None``)
    leave the same ring, at ``0`` neither leaves one."""
    monkeypatch.setenv("TPUDAS_FLIGHT", raw)
    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    src, out = str(tmp_path / "src"), str(tmp_path / "port")
    jout = str(tmp_path / "jax")
    _link(env_pool, src, 3)
    assert _drive(run_lowpass_realtime, env_pool, src, out) == 1
    assert _drive(jax_realtime, env_pool, src, jout, flight=None) == 1
    for folder in (out, jout):
        assert os.path.isdir(os.path.join(folder, ".flight")) == ring
    if ring:
        _assert_obs_artifacts(out, jout, "flight")


def test_env_features_off_both_run(env_pool, tmp_path, monkeypatch):
    """With every variable at its off value both packages run as they do
    with the variables unset, and emit the same stream."""
    for var in (*ENV_FEATURES, "TPUDAS_FLIGHT"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setenv("TPUDAS_MESH", "1")
    outs = {}
    for name, driver in (("port", run_lowpass_realtime),
                         ("jax", jax_realtime)):
        outs[name] = str(tmp_path / name)
        assert _drive(driver, env_pool, str(tmp_path / "src"),
                      outs[name]) == 1
    for name in ("health.json", ".tiles", ".flight"):
        assert not os.path.exists(os.path.join(outs["jax"], name))
        assert not os.path.exists(os.path.join(outs["port"], name))
    _assert_same_stream(outs["port"], outs["jax"])


def test_flight_default_on_in_both(env_pool, tmp_path, monkeypatch):
    """With ``TPUDAS_FLIGHT`` unset and ``flight=None`` both packages
    leave a ``.flight/`` ring: the two folder listings are equal."""
    monkeypatch.delenv("TPUDAS_FLIGHT", raising=False)
    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    outs = {}
    for name, driver in (("port", run_lowpass_realtime),
                         ("jax", jax_realtime)):
        outs[name] = str(tmp_path / name)
        assert _drive(driver, env_pool, str(tmp_path / "src"),
                      outs[name], flight=None) == 1
    assert ".flight" in os.listdir(outs["port"])
    assert sorted(os.listdir(outs["port"])) == sorted(
        os.listdir(outs["jax"]))
    assert os.listdir(os.path.join(outs["port"], ".flight")) == [
        "seg-00000000.jsonl"]


# ---------------------------------------------------------------------------
# the tile pyramid (ROADMAP A8a)

@pytest.mark.parametrize("codec", [None, "bitshuffle-deflate"])
@pytest.mark.parametrize("engine", ["auto", "fused", "fft"])
def test_pyramid_every_engine(pool, tmp_path, monkeypatch, fused_env, engine,
                              codec):
    """Each engine's stream appends its pyramid round by round (3 files,
    then 5); the tree equals the one-shot syncs over its own outputs,
    by the port and by the JAX package."""
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    if codec:
        monkeypatch.setenv("TPUDAS_CODEC", codec)
    out = str(tmp_path / "out")
    assert _drive(run_lowpass_realtime, pool, str(tmp_path / "src"), out,
                  then=[5], engine=engine, pyramid=True) == 2
    _assert_pyramid_of_outputs(out, str(tmp_path))
    if codec:
        assert any(n.endswith(".tpt") for n in _pyramid_tree(out))


def test_pyramid_resumed_across_packages(env_pool, tmp_path, monkeypatch):
    """A pyramid the JAX driver started (over its own outputs) is resumed
    by the port's driver in the same folder: the port appends only rows
    past the JAX head (the JAX rows stay as written), and the tree
    equals the JAX package's sync over the resulting files."""
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    assert _drive(jax_realtime, env_pool, src, out, first=2,
                  pyramid=True) == 1
    _link(env_pool, src, 3)
    assert _drive(run_lowpass_realtime, env_pool, src, out, first=3,
                  pyramid=True) == 1
    _assert_pyramid_of_outputs(out, str(tmp_path))


def test_pyramid_errors_swallowed_and_counted(env_pool, tmp_path,
                                              monkeypatch):
    """A failing tile read (the ``serve.tile_read`` fault site) on the
    second round's append is counted and swallowed, as in the JAX
    driver: the outputs equal a control's and a later sync converges."""
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.resilience.faults import (
        FaultPlan,
        FaultSpec,
        install_fault_plan,
    )
    from tpudas_torch.serve.tiles import sync_pyramid

    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    out, ctrl = str(tmp_path / "out"), str(tmp_path / "ctrl")
    reg = MetricsRegistry()
    plan = FaultPlan(FaultSpec(site="serve.tile_read", action="raise",
                               times=99))
    with use_registry(reg), install_fault_plan(plan):
        assert _drive(run_lowpass_realtime, env_pool, str(tmp_path / "s1"),
                      out, first=2, then=[3], pyramid=True) == 2
    assert reg.value("tpudas_serve_pyramid_errors_total") >= 1
    assert plan.fired
    assert _drive(run_lowpass_realtime, env_pool, str(tmp_path / "s2"),
                  ctrl, first=2, then=[3]) == 2
    assert _products(out) == _products(ctrl)
    sync_pyramid(out)  # the read side's catch-up converges
    _assert_pyramid_of_outputs(out, str(tmp_path))
