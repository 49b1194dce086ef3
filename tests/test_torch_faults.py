"""The port's real-time fault boundary against the JAX package's.

Both ``run_lowpass_realtime`` drivers run over the same small dasdae
spool (100 Hz x 6 channels, 30 s files, written once by the JAX
package's ``make_synthetic_spool`` and hard-linked into each run's
source folder), each under its own package's ``FaultPlan`` built from
the same ``FaultSpec`` arguments.  A run that survives its faults must
emit the same file names as the other package's run and as an
unfaulted port run, with data within 1e-5 of each channel's scale (the
bound of ``test_torch_realtime.py``: same float32 products, another
order).  The port runs on the CPU.
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.resilience import faults as jfaults
from tpudas.resilience.quarantine import QuarantineLedger as JaxLedger
from tpudas.testing import make_synthetic_spool
from tpudas_torch.fleet.engine import POLL_FLOOR_SEC
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.resilience import faults as tfaults
from tpudas_torch.resilience.quarantine import (
    QUARANTINE_FILENAME,
    QuarantineLedger as PortLedger,
)

FS = 100.0
FILE_SEC = 30.0
NCH = 6
T0 = "2023-03-22T00:00:00"
REL_TOL = 1e-5
PARAMS = dict(output_sample_interval=1.0, edge_buffer=8.0,
              process_patch_size=40)
# zero backoff, low thresholds (the JAX package's FAST test policy)
FAST = dict(base_delay=0.0, max_delay=0.0, jitter=0.0, quarantine_after=2,
            quarantine_retry=900.0)
# one transient fault at each site the real-time path passes (carry.save
# at its second hit: the first is the fresh stream's open save)
SITES = {"spool.read": 1, "index.update": 1, "round.body": 1, "carry.save": 2}
PACKAGES = {"port": (run_lowpass_realtime, tfaults),
            "jax": (jax_realtime, jfaults)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool-faults")
    make_synthetic_spool(d, n_files=5, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    return str(d)


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    for name in sorted(os.listdir(pool))[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _run(pkg, pool, src, out, first=3, then=(), specs=(), policy=None,
         sleeps=None, **kw):
    """One driver run of package ``pkg`` under a FaultPlan of ``specs``
    (FaultSpec keyword dicts); ``policy`` is RetryPolicy keywords, or
    None for the default policy.  Each poll's sleep (not a retry's
    backoff, which is shorter than the 125 s poll floor) links up to the
    next count in ``then``.  Returns (rounds, plan)."""
    driver, mod = PACKAGES[pkg]
    _link(pool, src, first)
    feeds = list(then)

    def sleep(seconds):
        if sleeps is not None:
            sleeps.append(seconds)
        if feeds and seconds >= POLL_FLOOR_SEC:
            _link(pool, src, feeds.pop(0))

    plan = mod.FaultPlan(*(mod.FaultSpec(**s) for s in specs))
    if policy is not None:
        kw["fault_policy"] = mod.RetryPolicy(**policy)
    kw["device" if pkg == "port" else "flight"] = (
        "cpu" if pkg == "port" else False)
    with mod.install_fault_plan(plan):
        rounds = driver(source=src, output_folder=out, start_time=T0,
                        poll_interval=0.0, file_duration=0.0, sleep_fn=sleep,
                        stateful=True, **PARAMS, **kw)
    return rounds, plan


def _products(out):
    return sorted(n for n in os.listdir(out) if n.startswith("LFDAS_"))


def _merged(out):
    merged = tspool(out).update().chunk(time=None)
    assert len(merged) == 1, "the stream output has a seam"
    return merged[0]


def _merged_last_time(out):
    return max(p.coords["time"][-1]
               for p in tspool(out).update().chunk(time=None))


def _assert_same_stream(out_a, out_b):
    assert _products(out_a) == _products(out_b)
    assert _products(out_a)
    a, b = _merged(out_a), _merged(out_b)
    assert np.array_equal(a.coords["time"], b.coords["time"])
    da, db = a.host_data(), b.host_data()
    scale = np.abs(db).max(axis=0)
    assert (np.abs(da - db).max(axis=0) <= REL_TOL * scale).all()


@pytest.fixture(scope="module")
def clean(pool, tmp_path_factory):
    """An unfaulted port run over 3 files, then 5."""
    d = tmp_path_factory.mktemp("clean")
    out = str(d / "out")
    rounds, _ = _run("port", pool, str(d / "src"), out, then=[5])
    assert rounds == 2
    return out


@pytest.mark.parametrize("policy", ["fast", "default"])
@pytest.mark.parametrize("site", sorted(SITES))
def test_transient_fault_retried_like_jax(pool, tmp_path, clean, site,
                                          policy):
    """A transient fault at one site: both drivers retry (the default
    policy's backoff goes through sleep_fn) and emit the unfaulted
    stream."""
    spec = dict(site=site, at=SITES[site])
    pol = FAST if policy == "fast" else None
    reg = get_registry()
    retries0 = reg.value("tpudas_stream_retries_total")
    outs, sleeps, rounds = {}, {}, {}
    for pkg in PACKAGES:
        outs[pkg] = str(tmp_path / f"out-{pkg}")
        sleeps[pkg] = []
        rounds[pkg], plan = _run(pkg, pool, str(tmp_path / f"src-{pkg}"),
                                 outs[pkg], then=[5], specs=[spec],
                                 policy=pol, sleeps=sleeps[pkg])
        assert plan.fired == [(site, "raise", SITES[site])]
    assert rounds["port"] == rounds["jax"] == 2
    assert reg.value("tpudas_stream_retries_total") == retries0 + 1
    assert reg.value("tpudas_stream_consecutive_failures") == 0
    # the same backoff in both packages: the retry's, then the polls'
    assert sleeps["port"] == sleeps["jax"]
    want = (0.0 if pol else jfaults.RetryPolicy().delay(0))
    assert want in sleeps["port"]
    _assert_same_stream(outs["port"], outs["jax"])
    _assert_same_stream(outs["port"], clean)


def test_default_call_survives_transient_read(pool, tmp_path, clean):
    """run_lowpass_realtime with its default fault_policy and quarantine
    keeps emitting through a transient read error."""
    out = str(tmp_path / "out")
    rounds, plan = _run("port", pool, str(tmp_path / "src"), out, then=[5],
                        specs=[dict(site="spool.read", at=1)])
    assert rounds == 2 and plan.fired
    _assert_same_stream(out, clean)


def test_unreadable_file_quarantined_like_jax(pool, tmp_path):
    """A file whose payload never decodes: both drivers quarantine it
    after quarantine_after strikes and keep emitting without it, over
    the gap it leaves (on_gap="split")."""
    bad = sorted(os.listdir(pool))[2]
    spec = dict(site="spool.read", at=1, times=9999, exc=ValueError,
                match=bad)
    reg = get_registry()
    added0 = reg.value("tpudas_stream_quarantine_added_total")
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = str(tmp_path / f"out-{pkg}")
        rounds, plan = _run(pkg, pool, str(tmp_path / f"src-{pkg}"),
                            outs[pkg], then=[5], specs=[spec], policy=FAST,
                            on_gap="split")
        assert rounds == 2 and plan.fired
    assert reg.value("tpudas_stream_quarantine_added_total") == added0 + 1
    assert reg.value("tpudas_stream_quarantined_files") == 1
    for pkg in PACKAGES:
        for ledger in (JaxLedger(outs[pkg]), PortLedger(outs[pkg])):
            assert ledger.quarantined_names() == [bad]
            assert ledger.entry(bad)["source"] == "read"
    assert _products(outs["port"]) == _products(outs["jax"])
    # the outputs go on past the quarantined file's 30 s
    last = _merged_last_time(outs["port"])
    assert last > np.datetime64(T0) + np.timedelta64(int(3 * FILE_SEC), "s")
    for name in _products(outs["port"]):
        a = tspool(os.path.join(outs["port"], name))[0].host_data()
        b = tspool(os.path.join(outs["jax"], name))[0].host_data()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=0)
        assert (np.abs(a - b).max(axis=0) <= REL_TOL * scale).all()


@pytest.mark.parametrize("case", ["exhausted", "fatal"])
def test_error_propagates_like_jax(pool, tmp_path, case):
    """quarantine=False under RetryPolicy(max_consecutive=0) lets a
    transient read error through, and a fatal error propagates under
    the default policy: the port raises where the JAX driver raises."""
    if case == "exhausted":
        spec = dict(site="spool.read", at=1)
        policy = dict(FAST, max_consecutive=0)
        want = {"port": tfaults.SpoolReadError,
                "jax": jfaults.SpoolReadError}
    else:
        spec = dict(site="round.body", at=1, exc=TypeError)
        policy = None
        want = {"port": TypeError, "jax": TypeError}
    for pkg in PACKAGES:
        out = str(tmp_path / f"out-{pkg}")
        with pytest.raises(want[pkg]):
            _run(pkg, pool, str(tmp_path / f"src-{pkg}"), out, specs=[spec],
                 policy=policy, quarantine=False)
        assert not os.path.exists(os.path.join(out, QUARANTINE_FILENAME))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_crosses_packages(tmp_path, writer):
    """A quarantine ledger written by one package loads in the other."""
    write, read = ((JaxLedger, PortLedger) if writer == "jax"
                   else (PortLedger, JaxLedger))
    folder = str(tmp_path)
    led = write(folder)
    for _ in range(2):
        led.record_failure("/data/raw_7.h5", "ValueError: bad payload",
                           now=100.0, threshold=2, retry_interval=60.0)
    led.record_failure("/data/raw_8.h5", "OSError: busy", now=101.0,
                       threshold=2, source="scan")
    got = read(folder)
    assert got.quarantined_names() == ["raw_7.h5"]
    assert got.entry("raw_7.h5") == led.entry("raw_7.h5")
    assert got.entry("raw_8.h5") == led.entry("raw_8.h5")
    assert got.excluded(now=150.0) == frozenset({"raw_7.h5"})
    assert got.record_success("raw_7.h5")
    assert write(folder).quarantined_count == 0


# ---------------------------------------------------------------------------
# the atomic-write and verified-read sites (fs.write_enospc,
# integrity.verify), with the startup audit on in both drivers: its
# verified reads and its writes pass the same sites, so both packages
# must count the same hits there.

def _failures_by_kind(reg):
    return {k: reg.value("tpudas_stream_round_failures_total", kind=k)
            for k in ("transient", "resource", "corrupt", "network")}


def _both_registries():
    from tpudas.obs.registry import get_registry as jax_registry

    return {"port": get_registry(), "jax": jax_registry()}


@pytest.mark.parametrize("exc", ["transient", "enospc"])
def test_write_enospc_fires_and_retries_like_jax(pool, tmp_path, clean,
                                                 monkeypatch, exc):
    """A fault at the second atomic write of the run fires in both
    drivers; both retry it under the same kind (``resource`` for an
    ENOSPC OSError) after the same sleeps, pass the write and the
    verified-read sites equally often, and emit the unfaulted
    stream."""
    import errno

    spec = dict(site="fs.write_enospc", at=2)
    if exc == "enospc":
        spec["exc"] = OSError(errno.ENOSPC, "No space left on device")
    regs = _both_registries()
    outs, sleeps, kinds, hits = {}, {}, {}, {}
    for pkg in PACKAGES:
        before = _failures_by_kind(regs[pkg])
        outs[pkg] = str(tmp_path / f"out-{pkg}")
        sleeps[pkg] = []
        rounds, plan = _run(pkg, pool, str(tmp_path / f"src-{pkg}"),
                            outs[pkg], then=[5], specs=[spec], policy=FAST,
                            sleeps=sleeps[pkg])
        assert rounds == 2
        assert plan.fired == [("fs.write_enospc", "raise", 2)]
        hits[pkg] = (plan.hits["fs.write_enospc"],
                     plan.hits["integrity.verify"])
        after = _failures_by_kind(regs[pkg])
        kinds[pkg] = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
    want = "resource" if exc == "enospc" else "transient"
    assert kinds["port"] == kinds["jax"] == {want: 1}
    assert hits["port"] == hits["jax"]
    assert sleeps["port"] == sleeps["jax"]
    _assert_same_stream(outs["port"], outs["jax"])
    _assert_same_stream(outs["port"], clean)
    from tpudas_torch.integrity import resource

    assert not resource.is_degraded()  # the round-end probe cleared it


def _audit_verify_hits(pkg, out, tmp_path):
    """How often ``pkg``'s startup audit of ``out`` passes
    ``integrity.verify`` (counted on a copy)."""
    import shutil

    from tpudas.integrity.audit import audit as jax_audit
    from tpudas_torch.integrity.audit import audit as port_audit

    mod = PACKAGES[pkg][1]
    copy = str(tmp_path / f"count-{pkg}")
    shutil.copytree(out, copy)
    plan = mod.FaultPlan()
    with mod.install_fault_plan(plan):
        rep = (port_audit if pkg == "port" else jax_audit)(copy)
    assert rep["clean"] and not rep["issues"]
    return plan.hits["integrity.verify"]


def _resumed_run(pkg, pool, tmp_path, clean_src_files, spec_kw, regs):
    """Run ``pkg``'s driver over 3 files, then resume it over 5 under a
    FaultPlan of ``spec_kw`` (a dict, or a function of the output folder
    returning one).  Returns (out, sleeps, plan, before, after): the
    failure kinds, the carry fallbacks and the audit errors counted
    before and after the resumed run."""
    src = str(tmp_path / f"src-{pkg}")
    out = str(tmp_path / f"out-{pkg}")
    assert _run(pkg, pool, src, out)[0] == 1
    _link(pool, src, clean_src_files)
    if callable(spec_kw):
        spec_kw = spec_kw(out)
    reg = regs[pkg]

    def counts():
        return (_failures_by_kind(reg),
                reg.value("tpudas_integrity_fallback_total",
                          artifact="carry"),
                reg.value("tpudas_integrity_audit_errors_total"))

    before = counts()
    sleeps = []
    rounds, plan = _run(pkg, pool, src, out, first=clean_src_files,
                        specs=[spec_kw], policy=FAST, sleeps=sleeps)
    assert rounds == 1
    return out, sleeps, plan, before, counts()


def test_integrity_verify_fires_like_jax(pool, tmp_path, clean):
    """A fault raised at the first verified read of a resumed run fires
    in both drivers at the same hit: the startup audit's read of the
    stream carry.  Both swallow the raising audit and count it
    (``tpudas_integrity_audit_errors_total``), fail no round, take no
    fallback (the runtime's own read of the carry is not faulted), pass
    the site equally often, and emit the unfaulted stream."""
    spec = dict(site="integrity.verify", at=1)
    regs = _both_registries()
    outs, sleeps, hits = {}, {}, {}
    for pkg in PACKAGES:
        outs[pkg], sleeps[pkg], plan, before, after = _resumed_run(
            pkg, pool, tmp_path, 5, spec, regs)
        assert plan.fired == [("integrity.verify", "raise", 1)]
        assert after[0] == before[0]  # no failed round
        assert after[1] == before[1]  # no carry fallback
        assert after[2] == before[2] + 1  # the audit raised, swallowed
        hits[pkg] = plan.hits["integrity.verify"]
    assert hits["port"] == hits["jax"]
    assert sleeps["port"] == sleeps["jax"]
    _assert_same_stream(outs["port"], outs["jax"])
    _assert_same_stream(outs["port"], clean)


def test_integrity_verify_after_the_audit_falls_back_like_jax(
        pool, tmp_path, clean):
    """A fault raised at the first verified read after the startup audit
    (the runtime's load of the stream carry) fires in both drivers at
    the same hit; both take it as a rejected primary (one counted
    ``carry`` fallback, no failed round), resume from ``.prev`` (the
    carry saved before the first round's outputs, which the resume
    regenerates) and emit the unfaulted stream, in other file boundaries
    than an unfaulted resume."""
    regs = _both_registries()
    outs, sleeps, hits = {}, {}, {}

    def spec(out):
        # the first verified read after the audit's own
        hits[pkg] = _audit_verify_hits(pkg, out, tmp_path)
        return dict(site="integrity.verify", at=hits[pkg] + 1)

    for pkg in PACKAGES:
        outs[pkg], sleeps[pkg], plan, before, after = _resumed_run(
            pkg, pool, tmp_path, 5, spec, regs)
        assert plan.fired == [("integrity.verify", "raise", hits[pkg] + 1)]
        assert after[0] == before[0]
        assert after[1] == before[1] + 1
        assert after[2] == before[2]
    assert hits["port"] == hits["jax"] >= 1
    assert sleeps["port"] == sleeps["jax"]
    _assert_same_stream(outs["port"], outs["jax"])
    a, b = _merged(outs["port"]), _merged(clean)
    assert np.array_equal(a.coords["time"], b.coords["time"])
    da, db = a.host_data(), b.host_data()
    assert (np.abs(da - db).max(axis=0)
            <= REL_TOL * np.abs(db).max(axis=0)).all()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_verify_truncate_takes_the_prev_rung(clean, tmp_path, pkg):
    """``integrity.verify`` with ``action="truncate"`` tears the carry
    just before its verified read: both packages' ``load_carry`` fall
    to ``.prev`` and count the fallback (tests/test_integrity.py)."""
    import shutil

    from tpudas.obs.registry import MetricsRegistry as JaxRegistry
    from tpudas.obs.registry import use_registry as jax_use_registry
    from tpudas.proc.stream import load_carry as jax_load_carry
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.proc.stream import CARRY_FILENAME, load_carry

    out = str(tmp_path / "out")
    shutil.copytree(clean, out)
    assert os.path.isfile(os.path.join(out, CARRY_FILENAME + ".prev"))
    mod = PACKAGES[pkg][1]
    plan = mod.FaultPlan(mod.FaultSpec(
        "integrity.verify", action="truncate", nbytes=32, at=1, times=1,
        match=CARRY_FILENAME))
    reg, scope, load = ((MetricsRegistry(), use_registry, load_carry)
                        if pkg == "port" else
                        (JaxRegistry(), jax_use_registry, jax_load_carry))
    with scope(reg), mod.install_fault_plan(plan):
        carry = load(out)
    assert plan.fired == [("integrity.verify", "truncate", 1)]
    assert carry is not None
    assert os.path.getsize(os.path.join(out, CARRY_FILENAME)) == 32
    assert reg.value("tpudas_integrity_fallback_total", artifact="carry") == 1


def test_stream_prefetch_site_fires_like_jax(pool, tmp_path, clean,
                                             monkeypatch):
    """``stream.prefetch`` (the async ingest's producer, before each
    slice read) fires in both drivers: the prefetch thread ships the
    fault to the round, which retries and emits the unfaulted stream.
    The port declared the site in ``FAULT_SITES`` and never fired it
    (ROADMAP C13)."""
    monkeypatch.setenv("TPUDAS_INGEST_PREFETCH", "2")
    spec = dict(site="stream.prefetch", at=1)
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = str(tmp_path / f"out-{pkg}")
        rounds, plan = _run(pkg, pool, str(tmp_path / f"src-{pkg}"),
                            outs[pkg], then=[5], specs=[spec], policy=FAST)
        assert plan.fired == [("stream.prefetch", "raise", 1)], pkg
        assert rounds == 2, pkg
    _assert_same_stream(outs["port"], outs["jax"])
    _assert_same_stream(outs["port"], clean)
