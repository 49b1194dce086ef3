"""The port's rolling stream runner and real-time joint product against
the JAX package's.

``run_rolling_realtime`` (the stateless per-file rolling mean of
``rolling_mean_dascore_edge.ipynb``) and ``run_lowpass_realtime(
rolling_output_folder=...)`` (the joint low-pass + rolling product, on
the rewind path) run in both packages over the same small dasdae spool
(100 Hz x 6 channels, 30 s files, as in ``tests/test_streaming.py``),
the port on the CPU.  Bounds: rolling outputs within 1e-6 of the
largest |value| of the JAX package's (float32 window sums in another
order); the real-time joint product within 1e-6 of the max + 1e-7 of
the batch ``JointProc`` (the JAX test's bound).
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.core.timeutils import to_datetime64
from tpudas.detect.ledger import load_events as jax_load_events
from tpudas.io.registry import write_patch
from tpudas.proc.streaming import (
    run_lowpass_realtime as jax_lowpass,
    run_rolling_realtime as jax_rolling,
)
from tpudas.testing import make_synthetic_spool, synthetic_patch
from tpudas_torch.core.units import s as sec
from tpudas_torch.detect.ledger import ScoreStore, load_events
from tpudas_torch.fleet import (
    FleetEngine,
    RollingStreamRunner,
    StreamConfig,
    StreamSpec,
)
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.proc import run_rolling_realtime
from tpudas_torch.proc.joint import JointProc
from tpudas_torch.proc.streaming import run_lowpass_realtime
from test_torch_realtime import _assert_pyramid_of_outputs

FS = 100.0
FILE_SEC = 30.0
NCH = 6
T0 = "2023-03-22T00:00:00"
REL = 1e-6
RMS = [("rms", {"window": 4.0, "step": 1.0, "thresh": 1.2,
                "baseline": 10.0})]


def _append_files(directory, start_index, count):
    t0 = to_datetime64(T0).astype("datetime64[ns]")
    step = np.timedelta64(int(round(1e9 / FS)), "ns")
    n = int(FILE_SEC * FS)
    for i in range(start_index, start_index + count):
        p = synthetic_patch(
            t0=t0 + i * n * step, duration=FILE_SEC, fs=FS, n_ch=NCH,
            seed=i, phase_origin=t0, noise=0.01,
        )
        write_patch(p, os.path.join(directory, f"raw_{i:04d}.h5"))


def _feeder(src, start, count):
    """A sleep_fn that appends ``count`` files at ``start`` once."""
    state = {"fed": False}

    def sleep(_):
        if not state["fed"]:
            _append_files(src, start, count)
            state["fed"] = True

    return sleep


def _outputs(out):
    return sorted(n for n in os.listdir(out) if n.startswith("LFDAS_"))


def _rolling(pkg, src, out, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
        driver = run_rolling_realtime
    else:
        kw.setdefault("flight", False)
        kw.setdefault("pyramid", False)
        driver = jax_rolling
    kw.setdefault("sleep_fn", _feeder(src, 2, 1))
    return driver(source=src, output_folder=out, window=1.0 * sec,
                  step=1.0 * sec, poll_interval=0.0, **kw)


def _assert_same_rolling_ring(out, jout):
    """The port's rolling ring reads in the JAX reader as the JAX
    runner's: the same record kinds in order, the same round-record
    keys and patch counts, every phase in every round."""
    from tpudas.obs.flight import read_flight as jax_read_flight
    from tpudas.obs.phases import PHASES as JAX_PHASES
    from tpudas_torch.obs.flight import read_flight

    recs, jrecs = jax_read_flight(out), jax_read_flight(jout)
    assert recs and recs == read_flight(out)
    assert [r["kind"] for r in recs] == [r["kind"] for r in jrecs]
    rounds = [r for r in recs if r["kind"] == "round"]
    jrounds = [r for r in jrecs if r["kind"] == "round"]
    assert [sorted(r) for r in rounds] == [sorted(r) for r in jrounds]
    assert [(r["round"], r["patches"], r["mode"]) for r in rounds] == [
        (r["round"], r["patches"], r["mode"]) for r in jrounds]
    for r in rounds:
        assert sorted(r["phases"]) == sorted(JAX_PHASES)
        assert r["devprof"] == {k: jrounds[0]["devprof"][k]
                                for k in ("launches", "bound",
                                          "utilization")} | {
            "device_execute_s": 0.0}


class TestRollingRealtime:
    def test_matches_jax(self, tmp_path):
        """Same file names; each file's data within REL of the max of
        the JAX package's."""
        outs = {}
        for pkg in ("port", "jax"):
            src = str(tmp_path / f"src-{pkg}")
            make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC,
                                 fs=FS, n_ch=NCH)
            outs[pkg] = str(tmp_path / pkg)
            assert _rolling(pkg, src, outs[pkg], scale=2.0) == 2
        names = _outputs(outs["port"])
        assert names == _outputs(outs["jax"]) and len(names) == 3
        for name in names:
            a = tspool(os.path.join(outs["port"], name))[0]
            b = tspool(os.path.join(outs["jax"], name))[0]
            assert np.array_equal(a.coords["time"], b.coords["time"])
            da, db = a.host_data(), b.host_data()
            assert np.array_equal(np.isnan(da), np.isnan(db))
            assert np.nanmax(np.abs(da - db)) <= REL * np.nanmax(np.abs(db))

    def test_processes_only_new_patches(self, tmp_path):
        src, out = str(tmp_path / "raw"), str(tmp_path / "results")
        make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC, fs=FS,
                             n_ch=NCH)
        assert _rolling("port", src, out, scale=2.0) == 2
        assert len(_outputs(out)) == 3  # one output file per input patch
        # stateless per file: each output has its own NaN warm-up row
        for p in tspool(out).update():
            host = p.host_data()
            assert np.isnan(host[0]).all() and np.isfinite(host[1:]).all()

    def test_out_of_order_arrival_still_processed(self, tmp_path):
        src, out = str(tmp_path / "raw"), str(tmp_path / "results")
        os.makedirs(src)
        _append_files(src, 2, 1)  # only the third file exists at first
        rounds = _rolling("port", src, out, sleep_fn=_feeder(src, 0, 2))
        assert rounds == 2
        assert len(_outputs(out)) == 3  # all three processed exactly once

    def test_empty_source_terminates(self, tmp_path):
        src = tmp_path / "raw"
        src.mkdir()
        polls = {"n": 0}

        def guarded_sleep(_):
            polls["n"] += 1
            if polls["n"] > 5:
                raise AssertionError("the rolling loop failed to terminate")

        assert _rolling("port", str(src), str(tmp_path / "out"),
                        sleep_fn=guarded_sleep) == 0

    def test_detect_rms_on_the_rolling_stream(self, tmp_path):
        """The detect hook over the rolling product: the same events
        and score rows as the JAX rolling driver's."""
        outs = {}
        for pkg in ("port", "jax"):
            src = str(tmp_path / f"src-{pkg}")
            make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC,
                                 fs=FS, n_ch=NCH, noise=0.01)
            outs[pkg] = str(tmp_path / pkg)
            assert _rolling(pkg, src, outs[pkg], detect=True,
                            detect_operators=RMS) == 2
        ev_p, ev_j = load_events(outs["port"]), jax_load_events(outs["jax"])
        key = ("op", "kind", "channel", "t_ns", "t_peak_ns", "t_end_ns",
               "seq")
        assert ev_p, "the threshold must produce events"
        assert [[e[k] for k in key] for e in ev_p] == [
            [e[k] for k in key] for e in ev_j]
        for a, b in zip(ev_p, ev_j):
            assert abs(a["score"] - b["score"]) <= REL * abs(b["score"])
        ta, va = ScoreStore.open(outs["port"]).read()
        tb, vb = ScoreStore.open(outs["jax"]).read()
        assert np.array_equal(ta, tb) and ta.size
        # the per-file NaN warm-up rows give NaN RMS rows in both
        assert np.array_equal(np.isnan(va), np.isnan(vb))
        assert np.nanmax(np.abs(va - vb)) <= REL * np.nanmax(np.abs(vb))

    def test_unported_keywords_raise(self, tmp_path, monkeypatch):
        """Every keyword of the JAX rolling runner is ported: ``mesh``
        rolls each round's fresh patches as one batch over the mesh,
        byte-equal to the per-patch run and within 1e-6 of the JAX
        runner's mesh run; ``pyramid`` builds the tile pyramid over the
        rolling outputs; ``flight`` keeps the JAX runner's ring;
        ``live`` registers a hub for the folder that publishes every
        round, as the JAX runner's does."""
        from tpudas.obs.registry import MetricsRegistry as JaxRegistry
        from tpudas.obs.registry import use_registry as jax_use
        from tpudas_torch.obs.registry import MetricsRegistry, use_registry
        from tpudas_torch.utils.logging import set_log_handler

        meshes = {}
        events = []
        set_log_handler(events.append)
        try:
            for pkg, mesh, reg, use in (
                    ("port", 2, MetricsRegistry(), use_registry),
                    ("plain", None, MetricsRegistry(), use_registry),
                    ("jax", 2, JaxRegistry(), jax_use)):
                msrc = str(tmp_path / f"msrc-{pkg}")
                make_synthetic_spool(msrc, n_files=2, file_duration=FILE_SEC,
                                     fs=FS, n_ch=NCH, noise=0.01)
                meshes[pkg] = str(tmp_path / f"mesh-{pkg}")
                with use(reg):
                    assert _rolling("jax" if pkg == "jax" else "port", msrc,
                                    meshes[pkg], mesh=mesh) == 2
                assert reg.get("tpudas_parallel_shards").value() == (
                    1 if mesh is None else 2), pkg
        finally:
            set_log_handler(None)
        assert any(e["event"] == "rolling_batched" for e in events)
        assert _outputs(meshes["port"]) == _outputs(meshes["plain"])
        for name in _outputs(meshes["port"]):
            with open(os.path.join(meshes["port"], name), "rb") as a, \
                    open(os.path.join(meshes["plain"], name), "rb") as b:
                assert a.read() == b.read(), name
        assert _outputs(meshes["port"]) == _outputs(meshes["jax"])
        for a, b in zip(tspool(meshes["port"]).sort("time").update(),
                        tspool(meshes["jax"]).sort("time").update()):
            da, db = a.host_data(), b.host_data()
            assert np.array_equal(np.isnan(da), np.isnan(db))
            assert np.nanmax(np.abs(da - db)) <= REL * np.nanmax(np.abs(db))
        from tpudas.live.hub import find_hub as jax_find_hub
        from tpudas_torch.live.hub import find_hub

        lives = {}
        for pkg, finder in (("port", find_hub), ("jax", jax_find_hub)):
            lsrc = str(tmp_path / f"lsrc-{pkg}")
            make_synthetic_spool(lsrc, n_files=2, file_duration=FILE_SEC,
                                 fs=FS, n_ch=NCH, noise=0.01)
            lout = str(tmp_path / f"live-{pkg}")
            assert _rolling(pkg, lsrc, lout, live=True, flight=True) == 2
            hub = finder(folder=os.path.abspath(lout))
            assert hub is not None and hub.seq == 2, pkg
            lives[pkg] = lout
        _assert_same_rolling_ring(lives["port"], lives["jax"])
        monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
        src = str(tmp_path / "src")
        make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC, fs=FS,
                             n_ch=NCH, noise=0.01)
        out = str(tmp_path / "pyr")
        assert _rolling("port", src, out, pyramid=True) == 2
        _assert_pyramid_of_outputs(out, str(tmp_path))
        monkeypatch.setenv("TPUDAS_DEVPROF", "0")
        outs = {}
        for pkg in ("port", "jax"):
            fsrc = str(tmp_path / f"fsrc-{pkg}")
            make_synthetic_spool(fsrc, n_files=2, file_duration=FILE_SEC,
                                 fs=FS, n_ch=NCH, noise=0.01)
            outs[pkg] = str(tmp_path / f"flight-{pkg}")
            assert _rolling(pkg, fsrc, outs[pkg], flight=True) == 2
        _assert_same_rolling_ring(outs["port"], outs["jax"])

    def test_no_card_and_no_device_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_rolling_realtime(source=str(tmp_path),
                                 output_folder=str(tmp_path / "o"),
                                 window=1.0, step=1.0,
                                 sleep_fn=lambda _: None)


def test_fleet_with_rolling_and_detect_streams(tmp_path):
    """A fleet of a rolling stream and a low-pass stream with detection
    builds and runs; each member equals its own single-stream run."""
    src = str(tmp_path / "src")
    make_synthetic_spool(src, n_files=3, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    lowpass = StreamConfig(
        kind="lowpass", start_time=T0, output_sample_interval=1.0,
        edge_buffer=8.0, process_patch_size=40, poll_interval=0.0,
        detect=True, detect_operators=[
            ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2})],
        poll_jitter=0.0)
    rolling = StreamConfig(kind="rolling", window=1.0, step=1.0,
                           poll_interval=0.0, poll_jitter=0.0)
    specs = [StreamSpec("lp", src, config=lowpass),
             StreamSpec("roll", src, config=rolling)]
    root = str(tmp_path / "root")
    fleet = FleetEngine(root, specs, sleep_fn=lambda _s: None, device="cpu",
                        batched=True)
    summary = fleet.run()
    assert {sid: s["status"] for sid, s in summary["streams"].items()} == {
        "lp": "terminated", "roll": "terminated"}
    assert isinstance(fleet.streams["roll"].runner, RollingStreamRunner)
    assert len(_outputs(os.path.join(root, "roll"))) == 3
    assert os.path.isfile(os.path.join(root, "lp", ".detect", "carry.npz"))
    solo = str(tmp_path / "solo")
    run_lowpass_realtime(source=src, output_folder=solo, start_time=T0,
                         output_sample_interval=1.0, edge_buffer=8.0,
                         process_patch_size=40, poll_interval=0.0,
                         sleep_fn=lambda _s: None, detect=True,
                         detect_operators=lowpass.detect_operators,
                         device="cpu")
    from tpudas_torch.detect.runner import load_detect_carry

    assert load_events(os.path.join(root, "lp")) == load_events(solo)
    got, want = (load_detect_carry(os.path.join(root, "lp")),
                 load_detect_carry(solo))
    assert got["meta"] == want["meta"] and got["meta"]["upto_ns"]
    for st_a, st_b in zip(got["states"], want["states"]):
        for key in st_b:
            assert st_a[key].tobytes() == st_b[key].tobytes(), key


# ---------------------------------------------------------------------------
# the real-time joint product


def _joint(pkg, src, out, roll, **kw):
    if pkg == "port":
        driver = run_lowpass_realtime
        kw.setdefault("device", "cpu")
    else:
        driver = jax_lowpass
        kw.setdefault("flight", False)
    return driver(
        source=src, output_folder=out, start_time=T0,
        output_sample_interval=1.0, edge_buffer=8.0, process_patch_size=40,
        poll_interval=0.0, file_duration=0.0,
        sleep_fn=_feeder(src, 3, 2), rolling_output_folder=roll,
        rolling_window=3.0, rolling_step=1.0, **kw)


@pytest.fixture(scope="module")
def joint_runs(tmp_path_factory):
    """The real-time joint run in both packages: 3 files, then 5."""
    td = tmp_path_factory.mktemp("joint-rt")
    runs = {}
    for pkg in ("port", "jax"):
        src = str(td / f"raw-{pkg}")
        make_synthetic_spool(src, n_files=3, file_duration=FILE_SEC, fs=FS,
                             n_ch=NCH, noise=0.01)
        out, roll = str(td / f"lf-{pkg}"), str(td / f"roll-{pkg}")
        assert _joint(pkg, src, out, roll) == 2
        runs[pkg] = (src, out, roll)
    return td, runs


def _merged_one(folder):
    merged = tspool(folder).update().chunk(time=None)
    assert len(merged) == 1, "the streamed product has a seam"
    return merged[0]


def _interior(a, b):
    ta, tb = a.coords["time"], b.coords["time"]
    lo, hi = max(ta[0], tb[0]), min(ta[-1], tb[-1])
    da = a.select(time=(lo, hi)).host_data()
    db = b.select(time=(lo, hi)).host_data()
    assert da.shape == db.shape and da.size
    return da, db


class TestJointRealtime:
    def test_rolling_product_seam_free_and_equal_to_batch(self, joint_runs):
        """Both rounds' rolling files merge into one gap-free 1 s patch
        that matches the port's batch JointProc over the same stream
        (the JAX test's bound)."""
        td, runs = joint_runs
        src, _out, roll = runs["port"]
        got = _merged_one(roll)
        assert np.isfinite(got.host_data()).all()
        steps = np.diff(got.coords["time"].astype(np.int64))
        assert np.all(steps == 1_000_000_000)
        jp = JointProc(tspool(src).sort("time").update(), device="cpu")
        jp.update_processing_parameter(
            output_sample_interval=1.0, process_patch_size=40,
            edge_buff_size=8, rolling_window=3.0, rolling_step=1.0)
        jp.set_output_folder(str(td / "blf"), delete_existing=True)
        jp.set_rolling_output_folder(str(td / "broll"), delete_existing=True)
        t_end = max(r["time_max"] for r in tspool(src).update().contents())
        jp.process_time_range(np.datetime64(T0), t_end)
        a, b = _interior(got, _merged_one(str(td / "broll")))
        assert np.abs(a - b).max() < 1e-6 * np.abs(b).max() + 1e-7

    def test_matches_jax_realtime_joint(self, joint_runs):
        _td, runs = joint_runs
        for idx in (1, 2):  # the LF product, then the rolling product
            p, j = runs["port"][idx], runs["jax"][idx]
            assert _outputs(p) == _outputs(j)
            a, b = _interior(_merged_one(p), _merged_one(j))
            assert np.abs(a - b).max() < 1e-6 * np.abs(b).max() + 1e-7

    def test_runs_the_rewind_path(self, joint_runs):
        """The joint mode keeps no stream carry: the rolling windows
        need the loaded halo, so every round rewinds."""
        _td, runs = joint_runs
        out = runs["port"][1]
        assert not os.path.exists(os.path.join(out, ".stream_carry.npz"))


# ---------------------------------------------------------------------------
# features the JAX runners turn on from the environment (ROADMAP C3)

def _rolling_entry_points(src, out):
    """Every way a caller starts a port rolling stream, each a thunk."""
    from tpudas_torch.fleet import build_runner

    spec = StreamSpec(stream_id="env", source=src, output_folder=out,
                      config=StreamConfig(kind="rolling", window=1.0,
                                          step=1.0))
    return {
        "run_rolling_realtime": lambda: run_rolling_realtime(
            src, out, window=1.0, step=1.0, sleep_fn=lambda _: None,
            device="cpu"),
        "build_runner": lambda: build_runner(spec, device="cpu"),
        "RollingStreamRunner": lambda: RollingStreamRunner(
            spec, out, device="cpu"),
        "FleetEngine": lambda: FleetEngine(out, [spec], device="cpu"),
    }


@pytest.mark.parametrize("var,raw", [("TPUDAS_PYRAMID", "1"),
                                     ("TPUDAS_LIVE", "1"),
                                     ("TPUDAS_MESH", "2"),
                                     ("TPUDAS_FLIGHT", "1")])
def test_env_feature_raises(tmp_path, monkeypatch, var, raw):
    """Under the variable the JAX rolling runner turns its feature on
    (the pyramid leaves ``.tiles/``, the live plane a hub, the mesh a
    sharded batch), and so does every port entry point: the driver's
    tree is the one the JAX package syncs from the same output files,
    its flight ring has the JAX runner's records, its hub is registered
    for its folder, and under ``TPUDAS_MESH=2`` every runner holds a
    2-shard mesh and the outputs equal the JAX runner's."""
    src = str(tmp_path / "src")
    make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH)
    monkeypatch.setenv(var, raw)
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    if var == "TPUDAS_FLIGHT":
        monkeypatch.setenv("TPUDAS_DEVPROF", "0")
        eps = {n: _rolling_entry_points(src, str(tmp_path / f"ep-{n}"))[n]
               for n in ("build_runner", "RollingStreamRunner",
                         "FleetEngine")}
        for name, start in eps.items():
            obj = start()
            runners = ([st.runner for st in obj.streams.values()]
                       if name == "FleetEngine" else [obj])
            assert all(r.flight is not None for r in runners), name
        outs = {}
        for pkg in ("port", "jax"):
            psrc = str(tmp_path / f"src-{pkg}")
            make_synthetic_spool(psrc, n_files=2, file_duration=FILE_SEC,
                                 fs=FS, n_ch=NCH)
            outs[pkg] = str(tmp_path / pkg)
            assert _rolling(pkg, psrc, outs[pkg], flight=None) == 2
        _assert_same_rolling_ring(outs["port"], outs["jax"])
        return
    if var in ("TPUDAS_PYRAMID", "TPUDAS_LIVE"):
        jout = str(tmp_path / "jax")
        assert _rolling("jax", src, jout, pyramid=None) == 2
        if var == "TPUDAS_PYRAMID":
            assert os.path.isdir(os.path.join(jout, ".tiles"))
        else:
            from tpudas.live.hub import find_hub

            assert find_hub(folder=os.path.abspath(jout)) is not None
    out = str(tmp_path / "port")
    if var == "TPUDAS_LIVE":
        # ported: every entry point registers a hub for its folder, and
        # the driver publishes its round to it, as the JAX runner does
        from tpudas_torch.live.hub import find_hub

        for name, start in _rolling_entry_points(
                src, str(tmp_path / "ep")).items():
            if name == "run_rolling_realtime":
                continue
            obj = start()
            runners = ([st.runner for st in obj.streams.values()]
                       if name == "FleetEngine" else [obj])
            assert all(r.live and find_hub(folder=os.path.abspath(
                r.output_folder)) is r.live_hub for r in runners), name
        assert _rolling("port", src, out, sleep_fn=lambda _: None) == 1
        hub = find_hub(folder=os.path.abspath(out))
        assert hub is not None and hub.seq == 1
        return
    if var == "TPUDAS_PYRAMID":
        eps = {n: _rolling_entry_points(src, str(tmp_path / f"ep-{n}"))[n]
               for n in ("build_runner", "RollingStreamRunner",
                         "FleetEngine")}
        for name, start in eps.items():
            obj = start()
            runners = ([st.runner for st in obj.streams.values()]
                       if name == "FleetEngine" else [obj])
            assert all(r.pyramid for r in runners), name
        # the JAX run's feeder already added the third file: one round
        assert _rolling("port", src, out, pyramid=None,
                        sleep_fn=lambda _: None) == 1
        _assert_pyramid_of_outputs(out, str(tmp_path))
        return
    # TPUDAS_MESH=2: every entry point shards, and the driver's outputs
    # are the JAX runner's under the same variable
    for name, start in _rolling_entry_points(
            src, str(tmp_path / "ep")).items():
        if name == "run_rolling_realtime":
            continue
        obj = start()
        runners = ([st.runner for st in obj.streams.values()]
                   if name == "FleetEngine" else [obj])
        assert all(r.mesh is not None and r.mesh.shape["ch"] == 2
                   for r in runners), name
    jout = str(tmp_path / "jax")
    jsrc = str(tmp_path / "jsrc")
    make_synthetic_spool(jsrc, n_files=2, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH)
    assert _rolling("port", src, out) == 2
    assert _rolling("jax", jsrc, jout) == 2
    assert _outputs(out) == _outputs(jout)
    for a, b in zip(tspool(out).sort("time").update(),
                    tspool(jout).sort("time").update()):
        da, db = a.host_data(), b.host_data()
        assert np.array_equal(np.isnan(da), np.isnan(db))
        assert np.nanmax(np.abs(da - db)) <= REL * np.nanmax(np.abs(db))


@pytest.mark.parametrize("var,raw", [("TPUDAS_HEALTH", "1"),
                                     ("TPUDAS_MESH", "1")])
def test_env_without_effect_runs(tmp_path, monkeypatch, var, raw):
    """The JAX rolling runner reads no ``TPUDAS_HEALTH``, and
    ``TPUDAS_MESH=1`` is no mesh: the port runs as the JAX package does,
    with the same outputs."""
    monkeypatch.setenv(var, raw)
    outs = {}
    for pkg in ("port", "jax"):
        src = str(tmp_path / f"src-{pkg}")
        make_synthetic_spool(src, n_files=2, file_duration=FILE_SEC, fs=FS,
                             n_ch=NCH)
        outs[pkg] = str(tmp_path / pkg)
        assert _rolling(pkg, src, outs[pkg]) == 2
    assert not os.path.exists(os.path.join(outs["jax"], "health.json"))
    assert _outputs(outs["port"]) == _outputs(outs["jax"])
