"""The port's round-phase timeline (tpudas_torch.obs.phases) against the
JAX package's.

Mirrors ``tests/test_obs_flight.py::TestPhases``: ``RoundPhases``
accumulates and finishes every phase, and a 3-round real-time run of
each package emits every phase exactly once a round into the registry
and into each round's flight record, with ``device_execute +
host_wait > 0`` and each round's ``stream.round`` span flushed ahead of
its record.  The JAX driver runs with ``TPUDAS_DEVPROF=0`` (the port
has no device telemetry yet), so both packages stamp the same devprof
fields; the phase key sets and the round-record key sets must be equal
between the packages.  The ingest pipeline's counters (the prefetcher's
close) are recorded as in the JAX package.  Everything runs on the CPU.
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.obs import phases as jphases
from tpudas.obs import registry as jreg
from tpudas.obs.flight import read_flight as jax_read_flight
from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.proc.streaming import run_rolling_realtime as jax_rolling
from tpudas.testing import make_synthetic_spool
from tpudas_torch.obs import phases as tphases
from tpudas_torch.obs import registry as treg
from tpudas_torch.obs.flight import read_flight
from tpudas_torch.proc.streaming import (
    run_lowpass_realtime,
    run_rolling_realtime,
)

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 30.0
N_CH = 4
PKGS = {"port": (tphases, treg), "jax": (jphases, jreg)}


def _feed_files(src, first, count):
    make_synthetic_spool(
        src, n_files=count, file_duration=FILE_SEC, fs=FS, n_ch=N_CH,
        noise=0.01,
        start=np.datetime64(T0)
        + np.timedelta64(int(first * FILE_SEC * 1e9), "ns"),
        prefix=f"raw{first:04d}",
    )


def _run_stream(pkg, src, out, rounds, **kw):
    """The JAX test's driver call: 2 files, then one more each sleep."""
    state = {"fed": 0}

    def fake_sleep(_):
        if state["fed"] < rounds - 1:
            state["fed"] += 1
            _feed_files(src, 1 + state["fed"], 1)

    kwargs = dict(
        source=src, output_folder=out, start_time=T0,
        output_sample_interval=1.0, edge_buffer=5.0,
        process_patch_size=20, poll_interval=0.0,
        sleep_fn=fake_sleep, max_rounds=rounds + 2,
        health=True, pyramid=False, detect=False, flight=True,
    )
    kwargs.update(kw)
    if pkg == "port":
        kwargs.setdefault("device", "cpu")
        return run_lowpass_realtime(**kwargs)
    return jax_realtime(**kwargs)


def test_phase_names_are_the_jax_ones():
    assert tphases.PHASES == jphases.PHASES
    assert len(tphases.PHASES) == 10


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_round_phases_accumulate_and_finish(pkg):
    phases, registry = PKGS[pkg]
    reg = registry.MetricsRegistry()
    ph = phases.RoundPhases()
    with ph.measure("poll"):
        pass
    ph.add("host_wait", 0.25)
    ph.add("host_wait", 0.25)
    ph.add("commit", -1.0)  # clamped at 0
    assert ph.total() >= 0.5
    out = ph.finish(reg)
    assert sorted(out) == sorted(phases.PHASES)
    assert out["host_wait"] == 0.5 and out["commit"] == 0.0
    snap = phases.phase_seconds_snapshot(reg)
    assert set(snap) == set(phases.PHASES)  # every phase observed once
    for p in phases.PHASES:
        assert snap[p]["count"] == 1
    assert snap["host_wait"] == {"count": 1, "sum": 0.5, "mean": 0.5}


def test_snapshots_equal_between_packages():
    """The same phase and ingest operations give the same snapshots and
    the same exposition."""
    got = {}
    for pkg, (phases, registry) in PKGS.items():
        reg = registry.MetricsRegistry()
        assert phases.phase_seconds_snapshot(reg) == {}
        for secs in (0.125, 0.5):
            ph = phases.RoundPhases()
            ph.add("poll", secs)
            ph.add("commit", 2 * secs)
            ph.finish(reg)
        phases.record_ingest_pipeline(
            2, {"prefetched": 5, "hits": 4, "misses": 1, "stall_s": 0.25,
                "max_ahead": 2}, registry=reg)
        got[pkg] = (phases.phase_seconds_snapshot(reg),
                    phases.ingest_pipeline_snapshot(reg),
                    reg.to_prometheus())
    assert got["port"] == got["jax"]
    assert got["port"][1]["prefetched"] == 5.0


@pytest.fixture(scope="module")
def three_rounds(tmp_path_factory):
    """A 3-round stateful run of each package (health and flight on),
    each under its own fresh registry."""
    td = tmp_path_factory.mktemp("phases")
    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUDAS_DEVPROF", "0")
    try:
        for pkg, (_phases, registry) in PKGS.items():
            src, out = str(td / f"src-{pkg}"), str(td / f"out-{pkg}")
            _feed_files(src, 0, 2)
            reg = registry.MetricsRegistry()
            with registry.use_registry(reg):
                n = _run_stream(pkg, src, out, rounds=3)
            runs[pkg] = (n, out, reg)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_realtime_rounds_emit_all_phases_exactly_once(three_rounds, pkg):
    phases = PKGS[pkg][0]
    n, out, reg = three_rounds[pkg]
    assert n == 3
    snap = phases.phase_seconds_snapshot(reg)
    assert set(snap) == set(phases.PHASES)
    for p in phases.PHASES:
        assert snap[p]["count"] == 3
    recs = read_flight(out, kind="round")
    assert recs == jax_read_flight(out, kind="round")
    assert [r["round"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert sorted(r["phases"]) == sorted(phases.PHASES)
        assert (r["phases"]["device_execute"]
                + r["phases"]["host_wait"]) > 0.0
        assert r["phases"]["place"] == 0.0 and r["phases"]["live"] == 0.0
    spans = read_flight(out, kind="span", name="stream.round")
    assert {s["round"] for s in spans} == {1, 2, 3}
    # a round's spans precede it durably (the drill's replay claim)
    ring = read_flight(out)
    for r in recs:
        i_rec = next(i for i, x in enumerate(ring)
                     if x["kind"] == "round" and x["round"] == r["round"])
        assert any(x["kind"] == "span" and x["name"] == "stream.round"
                   and x.get("round") == r["round"] for x in ring[:i_rec])
    body = reg.histogram("tpudas_stream_round_body_seconds").snapshot()
    assert body["count"] == 3


def test_phase_and_record_keys_equal_between_packages(three_rounds):
    """The same phase keys, the same round-record keys and the same
    devprof fields (the JAX driver's under ``TPUDAS_DEVPROF=0``); the
    port's device_execute is 0.0 and host_wait carries the residual."""
    port = read_flight(three_rounds["port"][1], kind="round")
    jax_ = read_flight(three_rounds["jax"][1], kind="round")
    assert [sorted(r) for r in port] == [sorted(r) for r in jax_]
    assert [sorted(r["phases"]) for r in port] == [
        sorted(r["phases"]) for r in jax_]
    for p, j in zip(port, jax_):
        assert p["devprof"] == j["devprof"] == {
            "launches": 0.0, "device_execute_s": 0.0, "bound": None,
            "utilization": None}
        assert p["phases"]["device_execute"] == 0.0
        assert p["phases"]["host_wait"] > 0.0
        assert (p["round"], p["mode"], p["data_seconds"], p["head_lag"]) \
            == (j["round"], j["mode"], j["data_seconds"], j["head_lag"])
    # the span names the port flushes are among the JAX driver's
    names = {r["name"] for r in read_flight(three_rounds["port"][1],
                                            kind="span")}
    jnames = {r["name"] for r in read_flight(three_rounds["jax"][1],
                                             kind="span")}
    assert {"stream.round", "stream.increment",
            "stream.carry_save"} <= names <= jnames


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_rewind_rounds_emit_all_phases(tmp_path, monkeypatch, pkg):
    """The rewind path (``stateful=False``) times the same phases, with
    its head lag computed because health is on."""
    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    _feed_files(src, 0, 2)
    assert _run_stream(pkg, src, out, rounds=2, stateful=False) == 2
    recs = read_flight(out, kind="round")
    assert [r["mode"] for r in recs] == ["rewind", "rewind"]
    for r in recs:
        assert sorted(r["phases"]) == sorted(PKGS[pkg][0].PHASES)
        assert r["head_lag"] is not None


def test_rewind_head_lag_matches_jax(tmp_path, monkeypatch):
    """In rewind mode the port computes the head lag when health is on,
    as the JAX runner does (the repair of the stateful-only condition):
    the same value in both packages' health snapshots."""
    from tpudas.obs.health import read_health

    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    lags = {}
    for pkg in PKGS:
        src, out = str(tmp_path / f"src-{pkg}"), str(tmp_path / pkg)
        _feed_files(src, 0, 2)
        assert _run_stream(pkg, src, out, rounds=2, stateful=False) == 2
        lags[pkg] = read_health(out)["head_lag_seconds"]
    assert lags["port"] is not None and lags["port"] == lags["jax"]


def test_prefetcher_close_records_the_pipeline(tmp_path, monkeypatch):
    """The repair: the ingest prefetcher's close records its counters
    and gauges into the registry, as the JAX package's does."""
    monkeypatch.setenv("TPUDAS_INGEST_PREFETCH", "2")
    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    snaps = {}
    for pkg, (phases, registry) in PKGS.items():
        src, out = str(tmp_path / f"src-{pkg}"), str(tmp_path / pkg)
        _feed_files(src, 0, 3)
        reg = registry.MetricsRegistry()
        with registry.use_registry(reg):
            assert _run_stream(pkg, src, out, rounds=1,
                               process_patch_size=10) == 1
        snaps[pkg] = phases.ingest_pipeline_snapshot(reg)
    snap = snaps["port"]
    assert set(snap) == set(snaps["jax"])
    assert snap["depth"] == snaps["jax"]["depth"] == 2.0
    assert snap["prefetched"] > 0 and snap["hits"] > 0
    assert snap["misses"] == 0.0 and 0 < snap["queue_peak"] <= 2


def test_rolling_rounds_emit_all_phases(tmp_path, monkeypatch):
    """The rolling runner's rounds: every phase once, writes in
    ``commit``, the record keys of the JAX rolling runner's."""
    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    outs = {}
    for pkg, driver in (("port", run_rolling_realtime),
                        ("jax", jax_rolling)):
        src = str(tmp_path / f"src-{pkg}")
        _feed_files(src, 0, 2)
        fed = []

        def sleep(_s, src=src, fed=fed):
            if not fed:
                fed.append(1)
                _feed_files(src, 2, 1)

        kw = {"device": "cpu"} if pkg == "port" else {}
        outs[pkg] = str(tmp_path / pkg)
        reg = PKGS[pkg][1].MetricsRegistry()
        with PKGS[pkg][1].use_registry(reg):
            assert driver(source=src, output_folder=outs[pkg], window=1.0,
                          step=1.0, poll_interval=0.0, sleep_fn=sleep,
                          flight=True, pyramid=False, **kw) == 2
        snap = PKGS[pkg][0].phase_seconds_snapshot(reg)
        assert {p: s["count"] for p, s in snap.items()} == dict.fromkeys(
            PKGS[pkg][0].PHASES, 2)
    port = read_flight(outs["port"], kind="round")
    jax_ = read_flight(outs["jax"], kind="round")
    assert [sorted(r) for r in port] == [sorted(r) for r in jax_]
    assert [r["patches"] for r in port] == [r["patches"] for r in jax_]
    for r in port:
        assert r["phases"]["commit"] > 0.0 and r["phases"]["host_wait"] > 0
