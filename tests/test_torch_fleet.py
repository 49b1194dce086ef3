"""tpudas_torch's FleetEngine against single-stream runs and the JAX
package's FleetEngine.

Three streams of their own widths and content (the seeded spools of
``tests/test_torch_realtime.py``: the JAX package's
``make_synthetic_spool``, hard-linked into each source folder) through
one port ``FleetEngine`` on the CPU: each stream's output files and
carry equal the same stream run alone (``drive(build_runner(...))``)
byte for byte; the file names equal the JAX ``FleetEngine``'s and the
data agree within 1e-5 of each channel's scale.  Then the ports of the
JAX fleet cases: deficit round-robin under a stalled spool, fatal
parking, a ``KeyboardInterrupt`` mid-fleet resumed byte-identical, the
unpark probe, and the port's own rule that a spec asking for an
unported feature raises when the fleet is built.
"""

import hashlib
import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.fleet import FleetEngine as JaxFleetEngine
from tpudas.fleet import StreamConfig as JaxStreamConfig
from tpudas.fleet import StreamSpec as JaxStreamSpec
from tpudas.testing import make_synthetic_spool
from tpudas_torch.fleet import (
    FleetEngine,
    PollJitter,
    StreamConfig,
    StreamSpec,
    build_runner,
    drive,
    run_fleet,
)
from tpudas_torch.fleet.engine import UNPORTED_FIELDS
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.obs.trace import get_spans
from tpudas_torch.proc.stream import CARRY_FILENAME
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan
from test_torch_realtime import _pyramid_tree

FS = 100.0
FILE_SEC = 30.0
T0 = "2023-03-22T00:00:00"
REL_TOL = 1e-5
NOISES = {"s0": 0.005, "s1": 0.01, "s2": 0.02}
WIDTHS = {"s0": 6, "s1": 9, "s2": 5}
PARAMS = dict(start_time=T0, output_sample_interval=1.0, edge_buffer=8.0,
              process_patch_size=40, poll_interval=0.0)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Four contiguous files per stream; each run links a few of them."""
    out = {}
    for sid, w in WIDTHS.items():
        d = tmp_path_factory.mktemp(f"pool-{sid}")
        make_synthetic_spool(d, n_files=4, file_duration=FILE_SEC, fs=FS,
                             n_ch=w, noise=NOISES[sid])
        out[sid] = str(d)
    return out


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    names = sorted(n for n in os.listdir(pool) if n.endswith(".h5"))
    for name in names[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _specs(pools, tmp_path, first=2, sids=None, cls=StreamSpec,
           cfg_cls=StreamConfig, **over):
    specs = []
    for sid in sids or WIDTHS:
        src = str(tmp_path / f"src_{sid}")
        _link(pools[sid], src, first)
        specs.append(cls(stream_id=sid, source=src,
                         config=cfg_cls(kind="lowpass", **{**PARAMS, **over})))
    return specs


def _feeder(pools, tmp_path, counts, sids=None):
    """A ``sleep_fn`` that links each stream's source up to the next
    count of ``counts`` (one per sleep)."""
    counts = list(counts)

    def sleep(_):
        if counts:
            n = counts.pop(0)
            for sid in sids or WIDTHS:
                _link(pools[sid], str(tmp_path / f"src_{sid}"), n)

    return sleep


def _shas(folder) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith("LFDAS_") or name == CARRY_FILENAME:
            with open(os.path.join(folder, name), "rb") as fh:
                out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _control(pools, tmp_path, sid, first=2, then=(), **over):
    """The stream alone: ``drive(build_runner(...))`` over the same feed."""
    src = str(tmp_path / f"ctrl_src_{sid}")
    _link(pools[sid], src, first)
    feeds = list(then)

    def sleep(_):
        if feeds:
            _link(pools[sid], src, feeds.pop(0))

    spec = StreamSpec(stream_id=sid, source=src,
                      config=StreamConfig(kind="lowpass", poll_jitter=0.0,
                                          **{**PARAMS, **over}))
    root = str(tmp_path / "ctrl")
    drive(build_runner(spec, root=root, device="cpu"), sleep_fn=sleep)
    return os.path.join(root, sid)


def _assert_match_controls(pools, tmp_path, root, sids=None, **kw):
    for sid in sids or WIDTHS:
        got = _shas(os.path.join(root, sid))
        assert CARRY_FILENAME in got and len(got) > 1
        want = _shas(_control(pools, tmp_path / f"c_{sid}", sid, **kw))
        assert got == want, f"stream {sid} differs from its solo control"


def _merged(folder):
    merged = tspool(folder).update().chunk(time=None)
    assert len(merged) == 1
    return merged[0]


class TestFleetByteIdentity:
    @pytest.mark.parametrize("engine", ["auto", "fft"])
    def test_three_streams_match_controls_and_jax(self, pools, tmp_path,
                                                  engine):
        """Three interleaved streams over a spool that grows once: each
        equals its control byte for byte; names equal the JAX fleet's,
        data within 1e-5 per channel."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, poll_jitter=0.0, engine=engine)
        reg = MetricsRegistry()
        with use_registry(reg):
            summary = FleetEngine(
                root, specs, sleep_fn=_feeder(pools, tmp_path, [3]),
                device="cpu").run()
        assert summary["parked"] == []
        assert summary["rounds_total"] == 6
        for sid in WIDTHS:
            s = summary["streams"][sid]
            assert s["status"] == "terminated" and s["rounds"] == 2
            assert s["realtime_factor"] > 0
        assert reg.value("tpudas_fleet_steps_total", stream="s0",
                         status="processed") == 2
        assert reg.histogram(
            "tpudas_fleet_step_seconds", labelnames=("stream",)
        ).snapshot(stream="s1")["count"] == 3
        assert get_spans("fleet.run") and get_spans("fleet.step")
        _assert_match_controls(pools, tmp_path, root, then=[3],
                               engine=engine)
        jroot = str(tmp_path / "jax_root")
        jt = tmp_path / "jax"
        jspecs = _specs(pools, jt, cls=JaxStreamSpec, cfg_cls=JaxStreamConfig,
                        poll_jitter=0.0, engine=engine, flight=False)
        JaxFleetEngine(jroot, jspecs,
                       sleep_fn=_feeder(pools, jt, [3])).run()
        for sid in WIDTHS:
            mine, ref = os.path.join(root, sid), os.path.join(jroot, sid)
            names = sorted(n for n in os.listdir(mine)
                           if n.startswith("LFDAS_"))
            assert names and names == sorted(
                n for n in os.listdir(ref) if n.startswith("LFDAS_"))
            a, b = _merged(mine), _merged(ref)
            assert np.array_equal(a.coords["time"], b.coords["time"])
            da, db = a.host_data(), b.host_data()
            scale = np.abs(db).max(axis=0)
            assert (np.abs(da - db).max(axis=0) <= REL_TOL * scale).all()
        # distinct content per stream
        shas = [_shas(os.path.join(root, sid)) for sid in WIDTHS]
        assert shas[0] != shas[1] != shas[2]

    def test_run_fleet_and_spec_folders(self, pools, tmp_path):
        """``run_fleet`` builds and runs; a spec's explicit
        ``output_folder`` wins over ``root/<stream_id>``."""
        specs = _specs(pools, tmp_path, sids=("s0", "s1"), poll_jitter=0.0)
        own = str(tmp_path / "elsewhere")
        specs[1] = StreamSpec(stream_id="s1", source=specs[1].source,
                              config=specs[1].config, output_folder=own)
        summary = run_fleet(str(tmp_path / "root"), specs,
                            sleep_fn=lambda _s: None, device="cpu")
        assert summary["rounds_total"] == 2
        assert _shas(own) and not os.path.exists(
            str(tmp_path / "root" / "s1"))


class TestFleetBuild:
    def test_unported_spec_raises_at_build_never_parked(self, pools,
                                                        tmp_path):
        """A spec asking for a feature the port lacks is the caller's
        error: NotImplementedError at build, before any runner exists."""
        root = str(tmp_path / "root")
        good = _specs(pools, tmp_path, sids=("s0",))[0]
        for field in UNPORTED_FIELDS:
            bad = StreamSpec(stream_id="b0", source=good.source,
                             config=StreamConfig(kind="lowpass",
                                                 **{**PARAMS, field: True}))
            with pytest.raises(NotImplementedError, match=field):
                FleetEngine(root, [good, bad], device="cpu")
            rolling = StreamSpec(
                stream_id="r0", source=good.source,
                config=StreamConfig(kind="rolling", window=1.0, step=1.0,
                                    **{field: True}))
            with pytest.raises(NotImplementedError, match=field):
                FleetEngine(root, [good, rolling], device="cpu")
        assert not os.path.exists(os.path.join(root, "s0"))

    def test_no_device_raises_without_a_card(self, pools, tmp_path,
                                             monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        specs = _specs(pools, tmp_path, sids=("s0",))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetEngine(str(tmp_path / "root"), specs)

    def test_spec_validation(self, pools, tmp_path):
        specs = _specs(pools, tmp_path, sids=("s0",))
        with pytest.raises(ValueError, match="at least one"):
            FleetEngine(str(tmp_path / "root"), [], device="cpu")
        with pytest.raises(ValueError, match="duplicate"):
            FleetEngine(str(tmp_path / "root"), specs + specs, device="cpu")

    def test_jitter_precedence(self, pools, tmp_path, monkeypatch):
        """The spec's explicit poll_jitter > TPUDAS_POLL_JITTER > the
        fleet default; each stream's LCG is seeded by its id."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, sids=("s0", "s1"))
        specs[1] = StreamSpec(stream_id="s1", source=specs[1].source,
                              config=StreamConfig(kind="lowpass",
                                                  poll_jitter=0.5, **PARAMS))
        monkeypatch.delenv("TPUDAS_POLL_JITTER", raising=False)
        eng = FleetEngine(root, specs, default_poll_jitter=0.2, device="cpu")
        assert eng.streams["s0"].runner.jitter.fraction == 0.2
        assert eng.streams["s1"].runner.jitter.fraction == 0.5
        monkeypatch.setenv("TPUDAS_POLL_JITTER", "0.3")
        eng = FleetEngine(root, specs, default_poll_jitter=0.2, device="cpu")
        assert eng.streams["s0"].runner.jitter.fraction == 0.3
        assert eng.streams["s1"].runner.jitter.fraction == 0.5
        # deterministic per stream, distinct across streams
        a, b = PollJitter("s0", 0.1), PollJitter("s0", 0.1)
        assert [a.next_unit() for _ in range(4)] == [
            b.next_unit() for _ in range(4)]
        c = PollJitter("s1", 0.1)
        assert c.next_unit() != PollJitter("s0", 0.1).next_unit()


class TestFleetFairness:
    def test_stalled_spool_cannot_starve_the_rest(self, pools, tmp_path):
        """One stream's index updates stall; the deficit round-robin
        serves the healthy streams first in every later window, and
        every stream completes all its rounds."""
        root = str(tmp_path / "root")
        ids = {"slow": "s0", "fast1": "s1", "fast2": "s2"}
        specs = []
        for sid, pool_id in ids.items():
            src = str(tmp_path / f"src_{sid}")
            _link(pools[pool_id], src, 2)
            specs.append(StreamSpec(
                stream_id=sid, source=src,
                config=StreamConfig(kind="lowpass", poll_jitter=0.0,
                                    **PARAMS)))
        fed = {"n": 0}

        def fleet_sleep(_):
            # two mid-run feeds -> 3 processing rounds per stream
            if fed["n"] < 2:
                fed["n"] += 1
                for sid, pool_id in ids.items():
                    _link(pools[pool_id], str(tmp_path / f"src_{sid}"),
                          2 + fed["n"])

        plan = FaultPlan(FaultSpec("index.update", action="delay",
                                   seconds=0.6, at=1, times=50,
                                   match="src_slow"))
        eng = FleetEngine(root, specs, sleep_fn=fleet_sleep, device="cpu")
        with install_fault_plan(plan):
            summary = eng.run()
        for sid in ids:
            assert summary["streams"][sid]["status"] == "terminated"
            assert summary["streams"][sid]["rounds"] == 3
        log = [sid for sid, _status, _w in eng.service_log]
        windows = [log[i : i + 3] for i in range(0, len(log), 3)]
        assert all(len(w) == 3 for w in windows)
        for w in windows[1:]:
            assert set(w) == set(ids)
            assert w[-1] == "slow", f"slow not served last: {windows}"
        assert (eng.streams["slow"].wall_seconds
                > eng.streams["fast1"].wall_seconds)

    def test_fatal_stream_parks_not_the_fleet(self, pools, tmp_path):
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, first=1, poll_jitter=0.0)
        # hit 2 of round.body = the second stream served in window 0;
        # ValueError classifies fatal -> parked, not retried
        plan = FaultPlan(FaultSpec("round.body", exc=ValueError("bad config"),
                                   at=2))
        reg = MetricsRegistry()
        with use_registry(reg), install_fault_plan(plan):
            summary = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                                  device="cpu").run()
        assert summary["parked"] == ["s1"]
        assert summary["streams"]["s1"]["status"] == "parked"
        assert "bad config" in summary["streams"]["s1"]["error"]
        for sid in ("s0", "s2"):
            assert summary["streams"][sid]["status"] == "terminated"
            assert summary["streams"][sid]["rounds"] == 1
        assert reg.value("tpudas_fleet_parked_total") == 1
        assert reg.value("tpudas_fleet_streams_parked") == 1


class TestFleetCrashResume:
    @pytest.mark.parametrize("site,at", [("carry.save", 2),
                                         ("round.body", 5)])
    def test_ki_mid_fleet_resumes_byte_identical(self, pools, tmp_path,
                                                 site, at):
        """KeyboardInterrupt mid-fleet kills the whole engine with the
        streams at different points; a fresh engine over the same
        folders resumes each to its uninterrupted control's bytes."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, poll_jitter=0.0)
        plan = FaultPlan(FaultSpec(site, exc=KeyboardInterrupt, at=at))
        with install_fault_plan(plan):
            with pytest.raises(KeyboardInterrupt):
                FleetEngine(root, specs, sleep_fn=lambda _s: None,
                            device="cpu").run()
        summary = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                              device="cpu").run()
        assert summary["parked"] == []
        _assert_match_controls(pools, tmp_path, root)


class TestFleetUnpark:
    def test_parked_stream_rejoins_after_probe(self, pools, tmp_path):
        """With unpark_probe set, a stream parked on a fatal is
        re-probed, rebuilt from disk, and finishes."""
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, first=1, poll_jitter=0.0)
        plan = FaultPlan(FaultSpec("round.body",
                                   exc=ValueError("transient-looking"), at=2))
        reg = MetricsRegistry()
        eng = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                          unpark_probe=1.0, device="cpu")
        with use_registry(reg), install_fault_plan(plan):
            summary = eng.run()
        assert summary["parked"] == []
        assert summary["unparked_total"] == 1
        for sid in WIDTHS:
            assert summary["streams"][sid]["status"] == "terminated"
            assert summary["streams"][sid]["rounds"] == 1
        unparked = [sid for sid, s in summary["streams"].items()
                    if s["unparks"]]
        assert unparked == ["s1"]
        s = summary["streams"]["s1"]
        assert s["parked_at"] is not None and s["unparked_at"] is not None
        assert reg.value("tpudas_fleet_unparked_total") == 1
        _assert_match_controls(pools, tmp_path, root, sids=("s1",), first=1)

    def test_probes_exhaust_to_terminal_park(self, pools, tmp_path):
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, first=1, sids=("s0",),
                       poll_jitter=0.0)
        plan = FaultPlan(FaultSpec("round.body", exc=ValueError("still broken"),
                                   at=1, times=1000))
        eng = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                          unpark_probe=0.5, unpark_max_probes=2, device="cpu")
        with install_fault_plan(plan):
            summary = eng.run()
        assert summary["parked"] == ["s0"]
        assert summary["streams"]["s0"]["unparks"] == 2
        assert "still broken" in summary["streams"]["s0"]["error"]

    def test_default_park_stays_terminal(self, pools, tmp_path):
        root = str(tmp_path / "root")
        specs = _specs(pools, tmp_path, first=1, sids=("s0",),
                       poll_jitter=0.0)
        plan = FaultPlan(FaultSpec("round.body", exc=ValueError("fatal"),
                                   at=1))
        eng = FleetEngine(root, specs, sleep_fn=lambda _s: None, device="cpu")
        with install_fault_plan(plan):
            summary = eng.run()
        assert summary["parked"] == ["s0"]
        assert summary["unparked_total"] == 0


@pytest.mark.parametrize("batched", [False, True])
def test_fleet_members_keep_their_pyramids(pools, tmp_path, monkeypatch,
                                           batched):
    """``pyramid=True`` on every spec: each member's ``.tiles/`` is the
    tree its solo control builds over the same feed, solo or batched."""
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    specs = _specs(pools, tmp_path, pyramid=True, poll_jitter=0.0)
    root = str(tmp_path / "root")
    FleetEngine(root, specs, sleep_fn=_feeder(pools, tmp_path, [4]),
                device="cpu", batched=batched).run()

    for sid in WIDTHS:
        ctrl = _control(pools, tmp_path, sid, then=[4], pyramid=True)
        got = _pyramid_tree(os.path.join(root, sid))
        assert any(k.startswith("L1/") for k in got), sid
        assert got == _pyramid_tree(ctrl), sid
