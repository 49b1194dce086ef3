"""The port's cluster rollup (tpudas_torch.obs.collect) and its
``obs_report`` CLI against the JAX package's, over fleet roots the port
wrote.

A 2-stream port ``FleetEngine`` root (health on, the flight ring at its
default) is rolled up by both packages: ``fleet_rollup`` and
``stream_snapshot`` must be equal as dicts, and the two ``obs_report``
CLIs must print the same text and the same JSON (the snapshot's
``generated_at`` aside).  The SLO cases of
``tests/test_obs_flight.py::TestSLO`` run over rings and snapshots the
port wrote; ``pool_rollup`` against a port nobody listens on reads
``unreachable``; the fleet's park and unpark events land in the member's
``health.json`` as in the JAX fleet; in a batched fleet each member's
ring holds only its own spans.  Everything runs on the CPU.
"""

import io
import json
import os
import socket
import sys
from contextlib import redirect_stdout

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import pytest

from tpudas.obs import collect as jcollect
from tpudas.testing import make_synthetic_spool
from tpudas_torch.fleet import FleetEngine, StreamConfig, StreamSpec
from tpudas_torch.obs import collect as tcollect
from tpudas_torch.obs.flight import FlightRecorder, read_flight
from tpudas_torch.obs.health import write_health
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan
from tpudas_torch.tools import obs_report as port_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
WIDTHS = {"s0": 4, "s1": 6}
PARAMS = dict(start_time=T0, output_sample_interval=1.0, edge_buffer=5.0,
              process_patch_size=20, poll_interval=0.0, poll_jitter=0.0)


def _jax_report():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import obs_report as jax_report
    finally:
        sys.path.pop(0)
    return jax_report


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    out = {}
    for sid, w in WIDTHS.items():
        d = tmp_path_factory.mktemp(f"pool-{sid}")
        make_synthetic_spool(d, n_files=3, file_duration=FILE_SEC, fs=FS,
                             n_ch=w, noise=0.01)
        out[sid] = str(d)
    return out


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    names = sorted(n for n in os.listdir(pool) if n.endswith(".h5"))
    for name in names[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _fleet(pools, tmp, first=2, then=(3,), **kw):
    specs = []
    for sid in WIDTHS:
        src = os.path.join(tmp, f"src_{sid}")
        _link(pools[sid], src, first)
        specs.append(StreamSpec(stream_id=sid, source=src, config=StreamConfig(
            kind="lowpass", health=True, **PARAMS)))
    feeds = list(then)

    def sleep(_s):
        if feeds:
            n = feeds.pop(0)
            for sid in WIDTHS:
                _link(pools[sid], os.path.join(tmp, f"src_{sid}"), n)

    root = os.path.join(tmp, "root")
    summary = FleetEngine(root, specs, sleep_fn=sleep, device="cpu",
                          **kw).run()
    return root, summary


@pytest.fixture(scope="module")
def fleet_root(pools, tmp_path_factory):
    root, summary = _fleet(pools, str(tmp_path_factory.mktemp("fleet")))
    assert all(s["rounds"] == 2 for s in summary["streams"].values())
    return root


def test_fleet_rollup_equals_jax(fleet_root):
    got = tcollect.fleet_rollup(fleet_root)
    assert got == jcollect.fleet_rollup(fleet_root)
    assert got["status"] == "ok" and sorted(got["streams"]) == ["s0", "s1"]
    assert got["counts"] == {"ok": 2} and got["slo_counts"] == {"ok": 2}
    for sid, entry in got["streams"].items():
        assert entry["rounds"] == 2 and entry["flight"]["last_round"] == 2
        assert entry["devprof"]["launches_per_round"] == 0.0
        folder = os.path.join(fleet_root, sid)
        assert tcollect.stream_snapshot(folder) == \
            jcollect.stream_snapshot(folder) == entry
    pol = {"head_lag_target_s": 1.0, "objective": 0.5, "window": 1}
    assert tcollect.fleet_rollup(fleet_root, tcollect.SLOPolicy(**pol)) == \
        jcollect.fleet_rollup(fleet_root, jcollect.SLOPolicy(**pol))


def test_empty_root_reads_unknown(tmp_path):
    got = tcollect.fleet_rollup(str(tmp_path))
    assert got == jcollect.fleet_rollup(str(tmp_path))
    assert got["status"] == "unknown"


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("mode", ["text", "json", "stream", "strict"])
def test_obs_report_cli_equals_jax(fleet_root, tmp_path, mode):
    argv = {"text": ["--fleet", fleet_root],
            "json": ["--fleet", fleet_root, "--json"],
            "stream": ["--stream", os.path.join(fleet_root, "s1"),
                       "--json"],
            "strict": ["--fleet", fleet_root, "--strict",
                       "--slo-head-lag", "0.5"]}[mode]
    rc_p, out_p = _cli(port_report.main, argv)
    rc_j, out_j = _cli(_jax_report().main, argv)
    assert rc_p == rc_j
    assert rc_p == (1 if mode == "strict" else 0)
    if mode in ("json", "stream"):
        snap_p, snap_j = json.loads(out_p), json.loads(out_j)
        assert snap_p.pop("generated_at") <= snap_j.pop("generated_at")
        assert snap_p == snap_j
    else:
        assert out_p == out_j
        assert "s0" in out_p and "s1" in out_p


def test_obs_report_module_entry_point(fleet_root):
    """``python -m tpudas_torch.tools.obs_report`` runs without JAX."""
    import subprocess

    res = subprocess.run(
        [sys.executable, "-m", "tpudas_torch.tools.obs_report", "--fleet",
         fleet_root, "--json"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["fleet"]["status"] == "ok"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pool_rollup_unreachable():
    url = f"http://127.0.0.1:{_free_port()}"
    got = tcollect.pool_rollup(url, timeout=2.0)
    assert got["status"] == "unreachable"
    assert got == jcollect.pool_rollup(url, timeout=2.0)
    snap = tcollect.cluster_snapshot(pool_url=url)
    assert snap["status"] == "degraded" and snap["pool"] == got


def test_backfill_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="A8e"):
        tcollect.backfill_rollup(str(tmp_path))
    with pytest.raises(NotImplementedError, match="backfill"):
        tcollect.cluster_snapshot(backfill_root=str(tmp_path))
    with pytest.raises(NotImplementedError):
        port_report.main(["--backfill", str(tmp_path)])


# ---------------------------------------------------------------------------
# the SLO math (tests/test_obs_flight.py::TestSLO) over port-written files


def _ring(folder, lags, target_now=None):
    rec = FlightRecorder(folder)
    for i, lag in enumerate(lags):
        rec.record("round", round=i + 1, head_lag=lag, phases={})
    rec.flush()
    rec.close()
    if target_now is not None:
        write_health(str(folder), {
            "rounds": len(lags), "polls": len(lags),
            "mode": "stateful", "realtime_factor": 10.0,
            "round_realtime_factor": 10.0,
            "head_lag_seconds": target_now, "redundant_ratio": 0.0,
            "carry_resume_count": 0,
            "last_round_wall_seconds": 0.1,
            "consecutive_failures": 0, "quarantined_files": 0,
            "degraded": False, "integrity_fallbacks": 0,
            "resource_degraded": False, "last_error": None,
        })


@pytest.mark.parametrize("case,lags,now,status", [
    ("ok", [10.0] * 20, 10.0, "ok"),
    ("violating", [10.0] * 20, 500.0, "violating"),
    ("burn", [10.0] * 16 + [500.0] * 4, 10.0, "at_risk"),
    ("unknown", [], None, "unknown"),
])
def test_slo_status(tmp_path, case, lags, now, status, monkeypatch):
    monkeypatch.delenv("TPUDAS_SLO_HEAD_LAG", raising=False)
    folder = tmp_path / case
    folder.mkdir()
    _ring(folder, lags, target_now=now)
    pol = tcollect.SLOPolicy(head_lag_target_s=100.0, objective=0.9,
                             window=50)
    got = tcollect.slo_status(folder, pol)
    assert got["status"] == status
    assert got == jcollect.slo_status(folder, jcollect.SLOPolicy(
        head_lag_target_s=100.0, objective=0.9, window=50))
    if case == "burn":
        assert got["error_budget_burn"] == pytest.approx(2.0)


def test_slo_target_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDAS_SLO_HEAD_LAG", "5")
    _ring(tmp_path, [10.0] * 4, target_now=1.0)
    got = tcollect.slo_status(tmp_path)
    assert got["target_s"] == 5.0 and got["status"] == "at_risk"
    assert got == jcollect.slo_status(tmp_path)
    assert tcollect.worst_status(["ok", "at_risk", "bogus"]) == "degraded"
    assert tcollect.worst_status(["ok", "at_risk"]) == "at_risk"


# ---------------------------------------------------------------------------
# the fleet's park / unpark records and per-member rings


@pytest.mark.parametrize("probe", [None, 1.0], ids=["parked", "unparked"])
def test_fleet_event_in_member_health(pools, tmp_path, probe):
    """A member parked on a fatal writes the park event into its
    terminal health.json (``fleet`` sub-object, the JAX fleet's keys);
    with the unpark probe the rebuilt runner's snapshots carry the
    unpark event.  The rollup reads either the same in both
    packages."""
    plan = FaultPlan(FaultSpec("round.body", exc=ValueError("bad config"),
                               at=2))
    with install_fault_plan(plan):
        root, summary = _fleet(pools, str(tmp_path), first=1, then=(),
                               unpark_probe=probe)
    assert plan.fired
    from tpudas_torch.obs.health import read_health

    health = read_health(os.path.join(root, "s1"))
    if probe is None:
        assert summary["parked"] == ["s1"]
        assert sorted(health["fleet"]) == [
            "error", "event", "parked_at", "unparked_at", "unparks"]
        assert health["fleet"]["event"] == "parked"
        assert "bad config" in health["last_error"]
        fatal = read_flight(os.path.join(root, "s1"), kind="fault")
        assert fatal and fatal[-1]["fatal"] is True
    else:
        assert summary["parked"] == [] and summary["unparked_total"] == 1
        assert sorted(health["fleet"]) == [
            "event", "parked_at", "probes", "unparked_at", "unparks"]
        assert health["fleet"]["event"] == "unparked"
    got = tcollect.fleet_rollup(root)
    assert got == jcollect.fleet_rollup(root)
    assert got["streams"]["s1"]["fleet"] == health["fleet"]


def test_batched_members_keep_their_own_spans(pools, tmp_path,
                                              monkeypatch):
    """In a batched fleet each member thread's spans land in its own
    ring: one ``stream.round`` span per round of that member, and no
    span of the packed step (it nests below the capture's depth)."""
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    root, summary = _fleet(pools, str(tmp_path), batched=True)
    for sid in WIDTHS:
        folder = os.path.join(root, sid)
        rounds = read_flight(folder, kind="round")
        spans = read_flight(folder, kind="span", name="stream.round")
        assert [r["round"] for r in rounds] == [1, 2]
        assert sorted(s["round"] for s in spans) == [1, 2]
        assert all(r["stream"] == sid for r in rounds)
        names = {s["name"] for s in read_flight(folder, kind="span")}
        assert "op.stacked" not in names
