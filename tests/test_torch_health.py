"""The port's metrics registry exposition and edge health snapshot
against the JAX package's.

The same sequence of metric operations runs through
``tpudas.obs.registry`` and ``tpudas_torch.obs.registry``: the
Prometheus exposition must be byte-equal (labels that need escaping,
infinite and integral floats, histograms with custom buckets) and the
snapshots equal.  ``health.json`` written by one package is read and
validated by the other; a flipped byte or a truncation falls back to
``health.json.prev`` and counts the fallback (as
``tests/test_integrity.py`` holds the JAX reader); a failed write is
counted and never raised.  Everything runs on the CPU.
"""

import json
import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import pytest

from tpudas.obs import health as jhealth
from tpudas.obs import registry as jreg
from tpudas.obs import trace as jtrace
from tpudas_torch.obs import health as thealth
from tpudas_torch.obs import registry as treg
from tpudas_torch.obs import trace as ttrace

REGS = {"jax": jreg, "port": treg}
HEALTHS = {"jax": jhealth, "port": thealth}


def _ops_counters(reg):
    c = reg.counter("tpudas_t_events_total", 'help with \\ and\n"quote"',
                    labelnames=("kind", "path"))
    c.inc(kind="a", path='C:\\dir\n"x"')
    c.inc(2.5, kind="b", path="plain")
    c.inc(kind="a", path='C:\\dir\n"x"')
    reg.counter("tpudas_t_plain_total").inc(3)


def _ops_gauges(reg):
    g = reg.gauge("tpudas_t_level", "a gauge", labelnames=("side",))
    g.set(float("inf"), side="hi")
    g.set(float("-inf"), side="lo")
    g.set(7.0, side="int")
    g.set(0.1 + 0.2, side="frac")
    g.set(1e16, side="big")
    g.inc(2, side="int")
    g.dec(0.5, side="int")
    reg.gauge("tpudas_t_nolabel").set(-3.25)


def _ops_histograms(reg):
    h = reg.histogram("tpudas_t_seconds", "a histogram",
                      labelnames=("phase",))
    for v in (0.0001, 0.003, 0.2, 1.5, 500.0):
        h.observe(v, phase="poll")
    h.observe(0.75, phase="commit")
    b = reg.histogram("tpudas_t_sizes", "custom buckets",
                      buckets=(10, 1, 100.5))
    for v in (0.5, 1, 5, 100.5, 1000):
        b.observe(v)


def _ops_all(reg):
    _ops_counters(reg)
    _ops_gauges(reg)
    _ops_histograms(reg)
    reg.counter("tpudas_t_unused_total", "never incremented")


OPS = {"counters": _ops_counters, "gauges": _ops_gauges,
       "histograms": _ops_histograms, "all": _ops_all}


@pytest.mark.parametrize("case", sorted(OPS))
def test_prometheus_exposition_byte_equal(case):
    out = {}
    for name, mod in REGS.items():
        reg = mod.MetricsRegistry()
        OPS[case](reg)
        out[name] = (reg.to_prometheus(), reg.snapshot())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0].endswith("\n")
    assert out["port"][1] == out["jax"][1]


def test_exposition_of_empty_registry_and_value_reads():
    for mod in REGS.values():
        assert mod.MetricsRegistry().to_prometheus() == ""
    regs = {n: m.MetricsRegistry() for n, m in REGS.items()}
    for reg in regs.values():
        _ops_all(reg)
    for name in ("tpudas_t_plain_total", "tpudas_t_nolabel",
                 "tpudas_t_missing"):
        assert regs["port"].value(name) == regs["jax"].value(name)
    assert regs["port"].value("tpudas_t_level", side="int") == 8.5
    # label keys are fixed at creation in both, and names are checked
    for mod in REGS.values():
        reg = mod.MetricsRegistry()
        reg.counter("tpudas_t_x_total", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.counter("tpudas_t_x_total", labelnames=("b",))
        with pytest.raises(ValueError):
            reg.counter("bad-name")
        with pytest.raises(TypeError):
            reg.gauge("tpudas_t_x_total")


def test_headline_equal():
    heads = {}
    for name, mod in REGS.items():
        reg = mod.MetricsRegistry()
        reg.counter("tpudas_proc_channel_samples_total").inc(1000)
        reg.counter("tpudas_proc_data_seconds_total").inc(60)
        reg.counter("tpudas_proc_wall_seconds_total").inc(2)
        reg.counter("tpudas_proc_samples_redundant_total").inc(100)
        heads[name] = mod.headline(reg)
    assert heads["port"] == heads["jax"]
    assert heads["port"]["realtime_factor"] == 30.0


@pytest.mark.parametrize("scoped", [False, True])
def test_obs_kill_switch(monkeypatch, scoped):
    """``TPUDAS_OBS=0`` hands out the no-op registry and records no span
    in both packages; an explicit ``use_registry`` scope overrides
    it."""
    monkeypatch.setenv("TPUDAS_OBS", "0")
    for name, (mod, tr) in {"jax": (jreg, jtrace),
                            "port": (treg, ttrace)}.items():
        tr.clear_spans()
        if scoped:
            fresh = mod.MetricsRegistry()
            with mod.use_registry(fresh):
                assert mod.get_registry() is fresh
                mod.get_registry().counter("tpudas_t_on_total").inc()
                with tr.span("t.on") as rec:
                    assert rec is not None
            assert fresh.value("tpudas_t_on_total") == 1.0, name
            assert [s["name"] for s in tr.get_spans()] == ["t.on"], name
        else:
            reg = mod.get_registry()
            assert reg is mod._NOOP_REGISTRY, name
            reg.counter("tpudas_t_off_total").inc()
            assert reg.snapshot() == {} and reg.to_prometheus() == ""
            assert reg.value("tpudas_t_off_total", 5.0) == 5.0
            with tr.span("t.off") as rec:
                assert rec is None
            assert tr.get_spans() == [], name
        assert mod.obs_enabled() is False


# ---------------------------------------------------------------------------
# health.json / metrics.prom


def _payload(**over):
    p = {
        "rounds": 3, "polls": 4, "mode": "stateful",
        "realtime_factor": 12.5, "round_realtime_factor": 11.0,
        "head_lag_seconds": 14.0, "redundant_ratio": 0.0,
        "carry_resume_count": 1, "last_round_wall_seconds": 0.25,
        "consecutive_failures": 0, "quarantined_files": 0,
        "degraded": False, "integrity_fallbacks": 0,
        "resource_degraded": False, "last_error": None,
        "detect": {"events": 2}, "fleet": {"event": "parked"},
    }
    p.update(over)
    return p


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_health_written_by_one_read_by_other(tmp_path, writer, reader):
    w, r = HEALTHS[writer], HEALTHS[reader]
    path = w.write_health(str(tmp_path), _payload(written_at=1.5))
    assert path == os.path.join(str(tmp_path), "health.json")
    got = r.read_health(str(tmp_path))
    assert r.validate_health(got) is got
    assert got == {**_payload(written_at=1.5), "schema": 3}
    # the second write rotates the first to .prev, in both packages
    w.write_health(str(tmp_path), _payload(rounds=4, written_at=2.5))
    assert os.path.isfile(str(tmp_path / "health.json.prev"))
    assert r.read_health(str(tmp_path))["rounds"] == 4


def test_health_files_byte_equal(tmp_path):
    """The same payload gives the same health.json bytes."""
    for name, mod in HEALTHS.items():
        os.makedirs(tmp_path / name)
        mod.write_health(str(tmp_path / name), _payload(written_at=9.0))
    assert (tmp_path / "port" / "health.json").read_bytes() == (
        tmp_path / "jax" / "health.json").read_bytes()


def _flip(path):
    data = bytearray(open(path, "rb").read())
    i = data.index(b'"rounds"') + 12  # inside the rounds value
    data[i] ^= 0x01
    open(path, "wb").write(bytes(data))


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])


@pytest.mark.parametrize("damage", [_flip, _truncate],
                         ids=["bitflip", "truncate"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_damaged_primary_falls_back_to_prev(tmp_path, damage, writer):
    """A flipped byte or a truncation of the primary reads the .prev
    rung in both packages and counts the ladder step (the JAX cases of
    tests/test_integrity.py)."""
    HEALTHS[writer].write_health(str(tmp_path), _payload(rounds=1))
    HEALTHS[writer].write_health(str(tmp_path), _payload(rounds=2))
    damage(str(tmp_path / "health.json"))
    for name, mod in HEALTHS.items():
        reg = REGS[name].MetricsRegistry()
        with REGS[name].use_registry(reg):
            got = mod.read_health(str(tmp_path))
        assert got is not None and got["rounds"] == 1, name
        assert reg.value("tpudas_integrity_fallback_total",
                         artifact="health") == 1.0, name
    # both rungs bad: None, two ladder steps
    damage(str(tmp_path / "health.json.prev"))
    reg = treg.MetricsRegistry()
    with treg.use_registry(reg):
        assert thealth.read_health(str(tmp_path)) is None
    assert reg.value("tpudas_integrity_fallback_total",
                     artifact="health") == 2.0


def test_missing_snapshot_reads_none(tmp_path):
    for mod in HEALTHS.values():
        assert mod.read_health(str(tmp_path)) is None


@pytest.mark.parametrize("case", ["not_a_dir", "bad_payload"])
def test_failed_write_counted_never_raised(tmp_path, case):
    """A write into a folder that is a file, or a payload missing its
    required keys, is counted in tpudas_health_write_errors_total and
    returns None in both packages; so does a failed metrics.prom."""
    folder = str(tmp_path)
    payload = _payload()
    if case == "not_a_dir":
        folder = str(tmp_path / "file")
        open(folder, "w").close()
    else:
        del payload["rounds"]
    for name, mod in HEALTHS.items():
        reg = REGS[name].MetricsRegistry()
        with REGS[name].use_registry(reg):
            assert mod.write_health(folder, payload) is None
            if case == "not_a_dir":
                assert mod.write_prom(folder) is None
        want = 2.0 if case == "not_a_dir" else 1.0
        assert reg.value("tpudas_health_write_errors_total") == want, name
        assert reg.value("tpudas_health_writes_total") == 0.0


def test_write_prom_is_the_exposition(tmp_path):
    for name, mod in HEALTHS.items():
        reg = REGS[name].MetricsRegistry()
        _ops_all(reg)
        os.makedirs(tmp_path / name)
        assert mod.write_prom(str(tmp_path / name), reg)
    port = (tmp_path / "port" / "metrics.prom").read_text()
    assert port == (tmp_path / "jax" / "metrics.prom").read_text()
    assert "# TYPE tpudas_t_seconds histogram" in port


def test_enospc_on_health_write_notes_pressure(tmp_path):
    """A disk-full failure of the health write is counted and flips the
    port's shedding flag, as the JAX writer's does."""
    import errno

    from tpudas_torch.integrity import resource
    from tpudas_torch.resilience.faults import (
        FaultPlan,
        FaultSpec,
        install_fault_plan,
    )

    reg = treg.MetricsRegistry()
    exc = OSError(errno.ENOSPC, "No space left on device")
    plan = FaultPlan(FaultSpec("fs.write_enospc", exc=exc, match="health"))
    try:
        with treg.use_registry(reg), install_fault_plan(plan):
            assert thealth.write_health(str(tmp_path), _payload()) is None
            assert resource.is_degraded()
    finally:
        resource.clear_pressure("test done")
    assert plan.fired
    assert reg.value("tpudas_health_write_errors_total") == 1.0


def test_health_json_is_stamped_json(tmp_path):
    thealth.write_health(str(tmp_path), _payload())
    obj = json.loads((tmp_path / "health.json").read_text())
    from tpudas.integrity.checksum import verify_json_obj

    assert verify_json_obj(obj) == "ok"
