"""The port's device telemetry plane (tpudas_torch.obs.devprof) against
the JAX package's (tpudas.obs.devprof).

Case for case with ``tests/test_devprof.py`` (all but
``TestBenchHistoryGate``, which tests the JAX ``tools/bench_history.py``):
each case runs the same operations on each package, under its own
registry, and asserts what the JAX test asserts; where both packages
give a value of the same operations (the compile block, the launch
counts), the two are held equal.  Beside them: the port's own launch
sites (the cascade, stacked and FFT stream steps count one launch a
step, with the formula cost of their shape), the compile hook of the
kernel library loader, the ``/profile`` capture started from a request
thread, and a 3-round ``run_lowpass_realtime`` of both packages under
``fused`` and ``fft`` whose round records carry the same ``devprof``
keys and launch counts.  Everything runs on the CPU; the CUDA event
path is held on the card by ``tests/test_torch_gpu.py``.
"""

import ctypes.util
import json
import os
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.integrity import resource as jresource
from tpudas.obs import collect as jcollect
from tpudas.obs import devprof as jdevprof
from tpudas.obs import flight as jflight
from tpudas.obs import registry as jregistry
from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.serve import http as jhttp
from tpudas.testing import make_synthetic_spool
from tpudas_torch.integrity import resource as tresource
from tpudas_torch.obs import collect as tcollect
from tpudas_torch.obs import devprof as tdevprof
from tpudas_torch.obs import flight as tflight
from tpudas_torch.obs import registry as tregistry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.serve import http as thttp

PKGS = {
    "port": SimpleNamespace(devprof=tdevprof, reg=tregistry,
                            resource=tresource, collect=tcollect,
                            flight=tflight, http=thttp),
    "jax": SimpleNamespace(devprof=jdevprof, reg=jregistry,
                           resource=jresource, collect=jcollect,
                           flight=jflight, http=jhttp),
}
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


@pytest.fixture(autouse=True)
def fresh_devprof():
    for p in PKGS.values():
        p.devprof.reset()
    yield
    for p in PKGS.values():
        p.devprof.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _compile_event(dp, secs=0.25):
    """The hook a compile fires (the JAX listener's event name; the
    port's library loader reports under the same suffix)."""
    dp._on_compile_duration(COMPILE_EVENT, secs)


def test_public_surface_is_the_jax_one():
    """Every JAX name, plus the port's ``launch_start`` (a CUDA bracket
    needs its start event recorded before the step)."""
    assert set(jdevprof.__all__) <= set(tdevprof.__all__)
    assert set(tdevprof.__all__) - set(jdevprof.__all__) == {"launch_start"}
    for name in tdevprof.__all__:
        assert callable(getattr(tdevprof, name))
    for name in ("_on_compile_duration", "_State", "_storm_params",
                 "_launch_ratio_threshold", "_util_bound_threshold",
                 "profile_dir"):
        assert hasattr(tdevprof, name)


class TestDeviceTrace:
    """``utils/profiling.py``'s ``Timer`` and ``device_trace``, and the
    spans' device half (``TPUDAS_TRACE_ANNOTATE``)."""

    def test_device_trace_env_logdir(self, tmp_path, monkeypatch):
        from tpudas_torch.utils.profiling import device_trace

        monkeypatch.delenv("TPUDAS_TRACE_DIR", raising=False)
        with pytest.raises(ValueError):
            with device_trace():
                pass
        monkeypatch.setenv("TPUDAS_TRACE_DIR", str(tmp_path / "tr"))
        ran = []
        with device_trace():
            ran.append(True)  # block runs whatever the backend does
            torch.ones(4).add_(1.0)
        assert ran == [True]
        (name,) = os.listdir(tmp_path / "tr")
        with open(tmp_path / "tr" / name) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "aten::add_" in names

    def test_device_trace_failure_still_runs_the_block(self, tmp_path,
                                                       monkeypatch):
        """A profiler that fails to start logs ``trace_failed`` and the
        block still runs, as in the JAX package."""
        import torch.profiler as tprof

        from tpudas_torch.utils import logging as tlog
        from tpudas_torch.utils.profiling import device_trace

        def broken(*_a, **_k):
            raise RuntimeError("no profiler here")

        monkeypatch.setattr(tprof, "profile", broken)
        events = []
        tlog.set_log_handler(events.append)
        try:
            ran = []
            with device_trace(str(tmp_path / "tr")):
                ran.append(True)
        finally:
            tlog.set_log_handler(None)
        assert ran == [True]
        assert [e["event"] for e in events] == ["trace_failed"]
        assert not (tmp_path / "tr").exists()

    def test_timer(self):
        from tpudas.utils.profiling import Timer as JTimer
        from tpudas_torch.utils.profiling import Timer

        for cls in (Timer, JTimer):
            with cls() as t:
                assert t.elapsed is None
                time.sleep(0.01)
            assert t.elapsed >= 0.01

    def test_annotated_span_is_a_record_function_range(self, monkeypatch):
        """With ``TPUDAS_TRACE_ANNOTATE=1`` a span inside a CPU
        ``torch.profiler`` capture on the same thread appears as a
        ``record_function`` event; without it, it does not."""
        from torch.profiler import ProfilerActivity, profile

        from tpudas_torch.obs import trace

        got = {}
        for flag in ("1", "0"):
            monkeypatch.setattr(trace, "_annotation", None)
            monkeypatch.setenv("TPUDAS_TRACE_ANNOTATE", flag)
            with tregistry.use_registry(tregistry.MetricsRegistry()):
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    with trace.span("devprof.test_span"):
                        torch.ones(4).add_(1.0)
            got[flag] = [e.name for e in prof.events()
                         if e.name == "devprof.test_span"]
        monkeypatch.setattr(trace, "_annotation", None)
        assert got == {"1": ["devprof.test_span"], "0": []}


class TestCompileAttribution:
    def test_cold_then_warm_key(self, pkg):
        dp = pkg.devprof
        reg = pkg.reg.MetricsRegistry()
        with pkg.reg.use_registry(reg):
            dp.note_kernel("cascade", (64, 2000), ("xla",))
            _compile_event(dp, 0.5)
            # warm: the exact key again — no trigger, and a stray
            # compile on this thread reads unattributed
            dp.note_kernel("cascade", (64, 2000), ("xla",))
            _compile_event(dp, 0.125)
            snap = dp.devprof_snapshot(calibrate=False)
        by_trigger = snap["compile"]["by_trigger"]
        assert by_trigger.get("first") == 1
        assert by_trigger.get("unattributed") == 1
        assert snap["compile"]["count"] == 2
        assert snap["compile"]["seconds"] == pytest.approx(0.625)
        assert reg.value(
            "tpudas_devprof_compiles_total", trigger="first"
        ) == 1.0
        assert reg.value(
            "tpudas_devprof_compile_seconds_total"
        ) == pytest.approx(0.625)

    def test_shape_vs_knob_fingerprint(self, pkg):
        dp = pkg.devprof
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            dp.note_kernel("fused", (64, 2000), ("knobA",))
            _compile_event(dp)
            # same knobs, new geometry -> shape
            dp.note_kernel("fused", (128, 2000), ("knobA",))
            _compile_event(dp)
            # same geometry, the env fingerprint moved -> knobs
            dp.note_kernel("fused", (128, 2000), ("knobB",))
            _compile_event(dp)
            snap = dp.devprof_snapshot(calibrate=False)
        assert snap["compile"]["by_trigger"] == {
            "first": 1, "shape": 1, "knobs": 1
        }
        kinds = [k["trigger"] for k in snap["compile"]["kernels"]]
        assert kinds == ["first", "shape", "knobs"]

    def test_cold_starts_never_storm(self, pkg, monkeypatch):
        """A cold start compiles every kernel once — 'first' triggers
        must not trip the recompile-storm alarm."""
        dp = pkg.devprof
        monkeypatch.setenv("TPUDAS_DEVPROF_STORM", "3/60")
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            for i in range(6):
                dp.note_kernel("k%d" % i, (8,), ("x",))
                _compile_event(dp, 0.01)
            snap = dp.devprof_snapshot(calibrate=False)
            assert snap["compile"]["storms"] == 0
            assert snap["compile"]["storm_active"] is False
            # but genuine shape churn on one kernel does storm
            for i in range(4):
                dp.note_kernel("churn", (8 + i,), ("x",))
                _compile_event(dp, 0.01)
            snap = dp.devprof_snapshot(calibrate=False)
        assert snap["compile"]["storms"] == 1
        assert snap["compile"]["storm_active"] is True

    def test_compile_excluded_from_device_seconds(self, pkg):
        """A cold key's synchronous compile lands in compile
        accounting, never in the launch bracket's device seconds."""
        dp = pkg.devprof
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with dp.stream_scope("s0"):
                dp.note_kernel("k", (8,), ("x",))
                t0 = time.perf_counter()
                _compile_event(dp, 3600.0)  # absurd compile in bracket
                dp.note_launch("xla", t0, out=None)
            stats = dp.classify_stream("s0", calibrate=False)
        assert stats["launches"] == 1.0
        # the 3600 s never reached device_s: bracket clamped to ~0
        assert stats["device_seconds"] < 1.0

    def test_compile_blocks_equal_between_packages(self, monkeypatch):
        """The same note_kernel / compile sequence gives the same
        compile block (kernel log times aside) and the same metric
        values in both packages."""
        monkeypatch.setenv("TPUDAS_DEVPROF_STORM", "2/60")
        got = {}
        for name, p in PKGS.items():
            reg = p.reg.MetricsRegistry()
            with p.reg.use_registry(reg):
                for kind, shape, knobs, secs in (
                        ("cascade", (60, 8), ("a",), 0.5),
                        ("cascade", (60, 8), ("a",), 0.25),
                        ("cascade", (120, 8), ("a",), 0.125),
                        ("cascade", (120, 8), ("b",), 0.0625),
                        ("fft", (60, 8), (), 1.0)):
                    p.devprof.note_kernel(kind, shape, knobs)
                    _compile_event(p.devprof, secs)
                snap = p.devprof.devprof_snapshot(calibrate=False)
            block = snap["compile"]
            for k in block["kernels"]:
                k.pop("at")
            got[name] = (block, [reg.value(
                "tpudas_devprof_compiles_total", trigger=t)
                for t in ("first", "shape", "knobs", "unattributed")])
        assert got["port"] == got["jax"]
        assert got["port"][0]["storms"] == 1

    def test_library_load_reports_a_compile(self, monkeypatch):
        """A kernel library's first load (and each nvcc build) is one
        compile, attributed to the calling thread's declared key; a
        loaded library is not loaded again."""
        from tpudas_torch.ops import _build

        libc = ctypes.util.find_library("c")
        if libc is None:
            pytest.skip("no C library to load")
        monkeypatch.setattr(_build, "build_libraries", lambda names: None)
        monkeypatch.setattr(_build, "_so_path",
                            lambda name: (None, libc))
        monkeypatch.delitem(_build._LIBS, "devprof_probe", raising=False)
        reg = tregistry.MetricsRegistry()
        try:
            with tregistry.use_registry(reg):
                tdevprof.note_kernel("cascade", (60, 8), ())
                _build.load_library("devprof_probe")
                _build.load_library("devprof_probe")
                snap = tdevprof.devprof_snapshot(calibrate=False)
        finally:
            _build._LIBS.pop("devprof_probe", None)
        assert snap["compile"]["count"] == 1
        assert snap["compile"]["by_trigger"] == {"first": 1}
        assert reg.value("tpudas_devprof_compiles_total",
                         trigger="first") == 1.0


class TestLaunchAttribution:
    def test_solo_vs_stacked_keys(self, pkg):
        dp = pkg.devprof
        reg = pkg.reg.MetricsRegistry()
        with pkg.reg.use_registry(reg):
            with dp.stream_scope("solo"):
                dp.note_launch("xla", time.perf_counter(), None)
            with dp.wave_scope(["a", "b", "c", "d"]):
                dp.note_launch(
                    "xla", time.perf_counter(), None, stacked=True
                )
            snap = dp.devprof_snapshot(calibrate=False)
        assert reg.value(
            "tpudas_devprof_launches_total",
            engine="xla", stacked="0", stream="solo",
        ) == 1.0
        # 1/N per member: the sum over members is ONE launch
        for m in ("a", "b", "c", "d"):
            assert reg.value(
                "tpudas_devprof_launches_total",
                engine="xla", stacked="1", stream=m,
            ) == pytest.approx(0.25)
        keys = {(e["engine"], e["stacked"], e["stream"])
                for e in snap["launches"]}
        assert ("xla", "0", "solo") in keys
        assert ("xla", "1", "a") in keys

    def test_round_collect_deltas(self, pkg):
        dp = pkg.devprof
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with dp.stream_scope("s1"):
                for _ in range(3):
                    dp.note_launch("xla", time.perf_counter(), None)
                d1 = dp.round_collect()
                d2 = dp.round_collect()
        assert d1["launches"] == 3.0
        assert d1["device_execute_s"] >= 0.0
        assert "utilization" in d1 and "bound" in d1
        # second boundary with no new launches: zero delta
        assert d2["launches"] == 0.0
        assert d2["device_execute_s"] == 0.0

    def test_classification_thresholds(self, pkg, monkeypatch):
        """Utilization-first verdict; launch-floor ratio only as the
        no-cost-data fallback."""
        dp = pkg.devprof
        monkeypatch.setenv("TPUDAS_DEVPROF_PEAK_FLOPS", "1e9")
        monkeypatch.setenv("TPUDAS_DEVPROF_PEAK_BYTES", "1e9")
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with dp.stream_scope("hot"):
                # 1 s of device time explained by 0.9e9 flops at a
                # 1e9 flops/s peak -> utilization 0.9 -> compute_bound
                dp.note_launch(
                    "xla", time.perf_counter() - 1.0, None,
                    cost={"flops": 0.9e9, "bytes": 0.0},
                )
            with dp.stream_scope("idle"):
                # same wall, trivial kernel -> utilization ~0
                dp.note_launch(
                    "xla", time.perf_counter() - 1.0, None,
                    cost={"flops": 1e3, "bytes": 1e3},
                )
            hot = dp.classify_stream("hot")
            idle = dp.classify_stream("idle")
        assert hot["bound"] == "compute_bound"
        assert hot["utilization"] == pytest.approx(0.9, abs=0.05)
        assert idle["bound"] == "launch_bound"
        assert idle["utilization"] < 0.01

    def test_disabled_is_total_noop(self, pkg, monkeypatch):
        dp = pkg.devprof
        monkeypatch.setenv("TPUDAS_DEVPROF", "0")
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with dp.stream_scope("off"):
                dp.note_kernel("k", (8,), ("x",))
                dp.note_launch("xla", time.perf_counter(), None)
                assert dp.round_collect() == {}
            stats = dp.classify_stream("off", calibrate=False)
        assert stats["launches"] == 0.0

    def test_launch_floor_and_peaks_calibrate(self, pkg, monkeypatch):
        """The probes give positive figures (here on the CPU), and the
        env pins win over them."""
        dp = pkg.devprof
        floor = dp.launch_floor_seconds()
        assert floor is not None and floor > 0
        assert dp.peak_flops() > 0 and dp.peak_bytes_per_s() > 0
        dp.reset()
        monkeypatch.setenv("TPUDAS_DEVPROF_PEAK_FLOPS", "67e12")
        monkeypatch.setenv("TPUDAS_DEVPROF_PEAK_BYTES", "3.1e12")
        assert dp.peak_flops() == 67e12
        assert dp.peak_bytes_per_s() == 3.1e12


def _stream_block(T, C, seed, int16=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, C)).astype(np.float32)
    return np.round(x / 1e-4).astype(np.int16) if int16 else x


class TestLaunchSites:
    """The port's dispatch sites: one launch a step, attributed to the
    thread's stream (or the wave's members), costed by the formula of
    its shape."""

    @pytest.mark.parametrize("engine", ["auto", "fused"])
    def test_cascade_step_is_one_launch(self, engine, monkeypatch):
        from tpudas_torch.ops import fir

        monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
        plan = fir.design_cascade(1000.0, 1000, 0.45)
        C = 6
        carry = fir.cascade_stream_init(plan, C, device="cpu")
        x = torch.from_numpy(_stream_block(2000, C, 1))
        reg = tregistry.MetricsRegistry()
        with tregistry.use_registry(reg), tdevprof.stream_scope("s"):
            for _ in range(2):
                _y, carry = fir.cascade_decimate_stream(
                    x, carry, plan, engine, qscale=1e-4)
            d = tdevprof.round_collect()
            snap = tdevprof.devprof_snapshot(calibrate=False)
        eng = "fused-torch" if engine == "fused" else "torch"
        assert d["launches"] == 2.0 and d["device_execute_s"] > 0.0
        assert reg.value("tpudas_devprof_launches_total", engine=eng,
                         stacked="0", stream="s") == 2.0
        want = fir.stream_step_cost(plan, 2000, C, 2)
        (key, cost), = snap["costs"].items()
        assert key.startswith("cascade:2000x6x" + eng) and cost == want
        assert snap["streams"]["s"]["flops"] == 2 * want["flops"]
        assert snap["compile"]["kernels"][0]["kind"] == "cascade"

    def test_stacked_step_is_one_launch_split_over_members(self):
        from tpudas_torch.ops import fir

        plan = fir.design_cascade(1000.0, 1000, 0.45)
        widths = (3, 5)
        blocks = [torch.from_numpy(_stream_block(2000, w, i))
                  for i, w in enumerate(widths)]
        carries = [fir.cascade_stream_init(plan, w, device="cpu")
                   for w in widths]
        reg = tregistry.MetricsRegistry()
        with tregistry.use_registry(reg), tdevprof.wave_scope(["a", "b"]):
            fir.cascade_decimate_stream_stacked(
                blocks, carries, plan, "fused-torch", qscale=1e-4)
        snap = tdevprof.devprof_snapshot(calibrate=False)
        total = sum(reg.value("tpudas_devprof_launches_total",
                              engine="fused-torch", stacked="1", stream=s)
                    for s in ("a", "b"))
        assert total == pytest.approx(1.0)
        assert snap["costs"] == {
            k: fir.stream_step_cost(plan, 2000, 8, 2)
            for k in snap["costs"]}
        assert [k["kind"] for k in snap["compile"]["kernels"]] == [
            "cascade_stacked"]

    def test_fft_steps(self):
        from tpudas_torch.ops.filter import (
            fft_pass_filter_stream,
            fft_pass_filter_stream_stacked,
            fft_step_cost,
            fft_stream_init,
        )

        x = torch.from_numpy(_stream_block(1024, 4, 3, int16=False))
        c = fft_stream_init(64, 4)
        reg = tregistry.MetricsRegistry()
        with tregistry.use_registry(reg):
            with tdevprof.stream_scope("f"):
                solo = fft_pass_filter_stream(x, c, 0.001, high=0.45)
            with tdevprof.wave_scope(["f", "g"]):
                stacked = fft_pass_filter_stream_stacked(
                    [x, x[:, :2].contiguous()], [c, c[:, :2]], 0.001,
                    high=0.45)
            snap = tdevprof.devprof_snapshot(calibrate=False)
        assert torch.equal(stacked[0][0], solo[0])
        assert reg.value("tpudas_devprof_launches_total", engine="fft",
                         stacked="0", stream="f") == 1.0
        assert reg.value("tpudas_devprof_launches_total", engine="fft",
                         stacked="1", stream="g") == 0.5
        assert sorted(k["kind"] for k in snap["compile"]["kernels"]) == [
            "fft", "fft_stacked"]
        costs = sorted(snap["costs"].values(), key=lambda c: c["bytes"])
        assert costs == [fft_step_cost(1024, 128, 4, 4),
                         fft_step_cost(1024, 128, 6, 4)]

    def test_cost_formulas(self):
        """The flagship step's cost: the int16 block read once, the 60
        outputs and the new carry written, the old carry read; two
        flops a true tap and output of each stage.  The FFT step: the
        block and carry read once, the output and carry written, two
        real FFTs of nfft a channel."""
        from tpudas_torch.ops import fir
        from tpudas_torch.ops.fftlen import next_tpu_fft_len
        from tpudas_torch.ops.filter import fft_step_cost

        plan = fir.design_cascade(1000.0, 1000, 0.45)
        C = 10000
        cost = fir.stream_step_cost(plan, 60000, C, 2)
        carry = sum(fir.stream_carry_sizes(plan))
        assert cost["bytes"] == 60000 * C * 2 + 60 * C * 4 + 2 * carry * C * 4
        rows, flops = 60000, 0.0
        for R, h in plan.stages:
            rows //= R
            flops += 2.0 * len(h) * rows * C
        assert cost["flops"] == flops
        nfft = next_tpu_fft_len(60000 + 20000)
        f = fft_step_cost(60000, 20000, C, 2)
        assert f["bytes"] == 60000 * C * 6 + 2 * 20000 * C * 4
        assert f["flops"] == pytest.approx(C * 5.0 * nfft * np.log2(nfft))

    def test_kernel_cost_is_memoized_per_key(self):
        calls = []

        def formula(n):
            calls.append(n)
            return {"flops": 2.0 * n, "bytes": 4.0 * n}

        a = tdevprof.kernel_cost("k", (8,), formula, (8,))
        b = tdevprof.kernel_cost("k", (8,), formula, (8,))
        assert a == b == {"flops": 16.0, "bytes": 32.0} and calls == [8]
        assert tdevprof.kernel_cost(
            "k", (9,), lambda: 1 / 0, ()) is None


class TestFlightRoundtrip:
    def test_round_record_carries_devprof(self, pkg, tmp_path):
        folder = str(tmp_path)
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            rec = pkg.flight.FlightRecorder(folder)
            for i in range(4):
                rec.record(
                    "round", stream="s", round=i,
                    phases={"device_execute": 0.004, "host_wait": 0.006,
                            "read_decode": 0.01},
                    realtime_factor=100.0, head_lag=1.0,
                    devprof={"launches": 2.0,
                             "device_execute_s": 0.004,
                             "bound": "launch_bound",
                             "utilization": 0.3},
                )
            rec.flush()
        rounds = pkg.flight.read_flight(folder, kind="round")
        assert len(rounds) == 4
        assert rounds[-1]["devprof"]["bound"] == "launch_bound"
        entry = pkg.collect.devprof_entry(rounds)
        assert entry["rounds"] == 4
        assert entry["launches_per_round"] == pytest.approx(2.0)
        assert entry["device_execute_s"] == pytest.approx(0.016)
        assert entry["bound"] == "launch_bound"
        assert entry["utilization"] == pytest.approx(0.3)
        # device-busy fraction = device seconds / phase wall
        assert 0.0 < entry["device_busy_fraction"] <= 1.0
        # the other package reads the ring to the same entry
        other = PKGS["jax" if pkg is PKGS["port"] else "port"]
        assert other.collect.devprof_entry(
            other.flight.read_flight(folder, kind="round")) == entry

    def test_entry_none_without_devprof_records(self, pkg):
        assert pkg.collect.devprof_entry([]) is None
        assert pkg.collect.devprof_entry(
            [{"kind": "round", "phases": {}}]) is None


def _server(pkg, folder):
    """A server over ``folder`` on an ephemeral port, started once by
    its ``with``."""
    return pkg.http.DASServer(folder)


def _get(url):
    """(status, parsed JSON body) of one GET; an error status is a
    result.  The connection is closed before returning, so the server
    shuts down at once."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, json.loads(exc.read())


class TestEndpoints:
    def test_devprof_endpoint(self, pkg, tmp_path):
        dp = pkg.devprof
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with dp.stream_scope("web"):
                dp.note_launch("xla", time.perf_counter(), None)
            with _server(pkg, str(tmp_path)) as srv:
                status, doc = _get(srv.base_url + "/devprof?calibrate=0")
        assert status == 200
        assert doc["enabled"] is True
        assert "web" in doc["streams"]
        assert doc["streams"]["web"]["launches"] == 1.0
        assert set(doc["calibration"]) >= {
            "launch_floor_s", "util_bound_threshold",
            "launch_ratio_threshold",
        }

    def test_devprof_snapshots_share_keys(self, tmp_path):
        """The same launches give snapshots with the same top-level,
        stream, launch-entry and calibration keys (calibrated, on the
        CPU) and the same launch counts in both packages."""
        docs = {}
        for name, p in PKGS.items():
            with p.reg.use_registry(p.reg.MetricsRegistry()):
                with p.devprof.stream_scope("web"):
                    p.devprof.note_launch("xla", time.perf_counter(), None,
                                          cost={"flops": 1e6, "bytes": 1e6})
                with _server(p, str(tmp_path / name)) as srv:
                    status, docs[name] = _get(srv.base_url + "/devprof")
                assert status == 200
        port, jax_ = docs["port"], docs["jax"]
        assert sorted(port) == sorted(jax_)
        assert sorted(port["calibration"]) == sorted(jax_["calibration"])
        assert sorted(port["compile"]) == sorted(jax_["compile"])
        assert sorted(port["streams"]["web"]) == sorted(
            jax_["streams"]["web"])
        assert [sorted(e) for e in port["launches"]] == [
            sorted(e) for e in jax_["launches"]]
        assert port["streams"]["web"]["launches"] == jax_["streams"][
            "web"]["launches"] == 1.0
        for doc in docs.values():
            assert doc["calibration"]["launch_floor_s"] > 0
            assert doc["streams"]["web"]["utilization"] is not None

    def test_profile_status_bare(self, pkg, tmp_path):
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with _server(pkg, str(tmp_path)) as srv:
                assert _get(srv.base_url + "/profile") == (200, None)

    def test_profile_unavailable_is_501(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setattr(
            pkg.devprof, "profiler_available", lambda: False
        )
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with _server(pkg, str(tmp_path)) as srv:
                status, doc = _get(srv.base_url + "/profile?seconds=1")
        assert status == 501
        assert "profiler" in doc["error"]

    def test_profile_bad_seconds_is_400(self, pkg, tmp_path):
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            with _server(pkg, str(tmp_path)) as srv:
                status, _doc = _get(srv.base_url + "/profile?seconds=nope")
        assert status == 400

    def test_profile_capture_writes_a_trace(self, tmp_path):
        """``/profile?seconds=1`` starts the capture on its own thread
        from the request thread: 200 with the capture's status, 409 for
        a second request while it runs, then a Chrome trace in the
        folder that parses, holding the capture's own profiler step."""
        out = tmp_path / "prof"
        with tregistry.use_registry(tregistry.MetricsRegistry()):
            with _server(PKGS['port'], str(tmp_path)) as srv:
                first, info = _get(
                    srv.base_url + f"/profile?seconds=1&dir={out}")
                second, busy = _get(
                    srv.base_url + f"/profile?seconds=1&dir={out}")
                _s, status = _get(srv.base_url + "/profile")
                deadline = time.time() + 30
                while tdevprof.profile_status() is not None:
                    assert time.time() < deadline
                    time.sleep(0.05)
        assert first == 200 and info["dir"] == str(out)
        assert info["seconds"] == 1.0 and status["dir"] == str(out)
        assert second == 409 and "already" in busy["error"]
        files = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
        assert len(files) == 1
        with open(out / files[0]) as fh:
            doc = json.load(fh)
        assert isinstance(doc["traceEvents"], list)


class TestProfileShedParity:
    def test_enospc_sheds_profile(self, pkg, tmp_path, monkeypatch):
        """A deep capture is a non-essential writer: under disk
        pressure it sheds exactly like the pyramid/prom writers."""
        monkeypatch.setenv("TPUDAS_PROFILE_DIR", str(tmp_path))
        with pkg.reg.use_registry(pkg.reg.MetricsRegistry()):
            pkg.resource.note_pressure("test", None)
            try:
                assert pkg.resource.is_degraded()
                with pytest.raises(RuntimeError, match="shed"):
                    pkg.devprof.start_profile(1.0)
            finally:
                pkg.resource.clear_pressure("test done")
        assert os.listdir(tmp_path) == []

    def test_bad_duration_and_missing_dir(self, pkg, monkeypatch):
        monkeypatch.delenv("TPUDAS_PROFILE_DIR", raising=False)
        monkeypatch.delenv("TPUDAS_TRACE_DIR", raising=False)
        with pytest.raises(ValueError, match="seconds"):
            pkg.devprof.start_profile(-1.0)
        with pytest.raises(ValueError, match="directory"):
            pkg.devprof.start_profile(1.0)


# ---------------------------------------------------------------------------
# the runner's round records, both packages


FS, FILE_SEC, N_CH = 50.0, 30.0, 4
T0 = "2023-03-22T00:00:00"


def _feed(src, first, count):
    make_synthetic_spool(
        src, n_files=count, file_duration=FILE_SEC, fs=FS, n_ch=N_CH,
        noise=0.01,
        start=np.datetime64(T0)
        + np.timedelta64(int(first * FILE_SEC * 1e9), "ns"),
        prefix=f"raw{first:04d}",
    )


@pytest.mark.parametrize("engine", ["fused", "fft"])
def test_runner_records_carry_the_same_devprof(tmp_path, monkeypatch,
                                               engine):
    """The same seeded stream through both packages'
    ``LowpassStreamRunner`` (``run_lowpass_realtime``, 3 rounds, the
    flight ring on): every round record carries the same ``devprof``
    keys and launch count, and the same phase keys; the port's device
    seconds are its own (positive, inside the round's residual).  The
    snapshots share their top-level and calibration keys."""
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    recs, snaps = {}, {}
    for name, driver in (("port", run_lowpass_realtime),
                         ("jax", jax_realtime)):
        p = PKGS[name]
        src, out = str(tmp_path / f"src-{name}"), str(tmp_path / name)
        _feed(src, 0, 2)
        fed = []

        def sleep(_s, src=src, fed=fed):
            if len(fed) < 2:
                fed.append(1)
                _feed(src, 1 + len(fed), 1)

        kw = {"device": "cpu"} if name == "port" else {}
        with p.reg.use_registry(p.reg.MetricsRegistry()):
            n = driver(source=src, output_folder=out, start_time=T0,
                       output_sample_interval=1.0, edge_buffer=5.0,
                       process_patch_size=20, poll_interval=0.0,
                       sleep_fn=sleep, engine=engine, stateful=True,
                       flight=True, health=False, pyramid=False,
                       detect=False, **kw)
            snaps[name] = p.devprof.devprof_snapshot(calibrate=False)
        assert n == 3
        recs[name] = p.flight.read_flight(out, kind="round")
    port, jax_ = recs["port"], recs["jax"]
    assert len(port) == len(jax_) == 3
    for a, b in zip(port, jax_):
        assert sorted(a["devprof"]) == sorted(b["devprof"])
        assert a["devprof"]["launches"] == b["devprof"]["launches"] > 0
        assert sorted(a["phases"]) == sorted(b["phases"])
        assert 0 < a["devprof"]["device_execute_s"] == pytest.approx(
            a["phases"]["device_execute"], abs=1e-6)
    assert sorted(snaps["port"]) == sorted(snaps["jax"])
    assert sorted(snaps["port"]["calibration"]) == sorted(
        snaps["jax"]["calibration"])
    assert sum(e["launches"] for e in snaps["port"]["launches"]) == sum(
        e["launches"] for e in snaps["jax"]["launches"])
