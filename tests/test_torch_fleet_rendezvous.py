"""The batched fleet's ``fleet.rendezvous`` span: one a member device
step, from the member's submission until its wave starts to run.

Three co-shaped members (their own spools, same width) through a
batched ``FleetEngine`` on the CPU record one span for each member
device step the executor served (stacked or solo), each on its own
member's thread with the members in the rendezvous as an attribute; an
unbatched fleet records none; and with the span in place every
member's outputs and carry equal the same stream run alone, byte for
byte.  Then the executor alone: the dispatching member's span ends
before the stacked step starts, and a waiting member's ends when its
wave starts, not when it has run.
"""

import hashlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpudas_torch.fleet import (
    FleetEngine,
    StreamConfig,
    StreamSpec,
    build_runner,
    drive,
)
from tpudas_torch.fleet.batch import BatchStepExecutor
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.obs.trace import clear_spans, get_spans
from tpudas_torch.ops import fir as tfir
from tpudas_torch.proc.stream import CARRY_FILENAME
from tpudas_torch.testing import make_synthetic_spool

FS = 100.0
FILE_SEC = 30.0
T0 = "2023-03-22T00:00:00"
WIDTH = 6
NOISES = {"w0": 0.005, "w1": 0.01, "w2": 0.02}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Three contiguous files a member, of one width, each member its
    own noise."""
    out = {}
    for sid, noise in NOISES.items():
        d = tmp_path_factory.mktemp(f"pool-{sid}")
        make_synthetic_spool(d, n_files=3, file_duration=FILE_SEC, fs=FS,
                             n_ch=WIDTH, noise=noise, format="tdas")
        out[sid] = str(d)
    return out


def _link(pool, src):
    os.makedirs(src, exist_ok=True)
    for name in sorted(os.listdir(pool)):
        os.link(os.path.join(pool, name), os.path.join(src, name))


def _config(engine):
    return StreamConfig(kind="lowpass", start_time=T0,
                        output_sample_interval=1.0, edge_buffer=8.0,
                        process_patch_size=20, poll_interval=0.0,
                        poll_jitter=0.0, engine=engine, stateful=True)


def _specs(pools, base, engine):
    specs = []
    for sid in NOISES:
        src = os.path.join(base, f"src_{sid}")
        _link(pools[sid], src)
        specs.append(StreamSpec(stream_id=sid, source=src,
                                config=_config(engine)))
    return specs


def _shas(folder) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith("LFDAS_") or name == CARRY_FILENAME:
            with open(os.path.join(folder, name), "rb") as fh:
                out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _fleet(pools, base, engine, batched):
    reg = MetricsRegistry()
    clear_spans()
    root = os.path.join(base, "root")
    with use_registry(reg):
        summary = FleetEngine(root, _specs(pools, base, engine),
                              sleep_fn=lambda _s: None, batched=batched,
                              device="cpu").run()
    assert summary["parked"] == []
    return reg, root


def _span_count(reg) -> int:
    hist = reg.get("tpudas_span_seconds")
    return hist.snapshot(name="fleet.rendezvous")["count"] if hist else 0


@pytest.mark.parametrize("engine", ["fused", "auto"])
def test_one_span_a_member_step_and_outputs_unchanged(pools, tmp_path,
                                                      engine):
    reg, root = _fleet(pools, str(tmp_path / "batched"), engine, True)
    steps = (reg.value("tpudas_fleet_batch_stacked_members_total")
             + reg.value("tpudas_fleet_batch_solo_launches_total"))
    assert reg.value("tpudas_fleet_batch_stacked_members_total") > 0
    assert steps > 0 and _span_count(reg) == steps
    spans = get_spans("fleet.rendezvous")
    assert len(spans) == steps
    for s in spans:
        assert s["attrs"]["stream"] in NOISES
        assert s["attrs"]["members"] == len(NOISES)
        assert s["thread"][1] == f"fleet-batch-{s['attrs']['stream']}"
    # every member's own steps, each member the same number
    per = {sid: sum(s["attrs"]["stream"] == sid for s in spans)
           for sid in NOISES}
    assert len(set(per.values())) == 1, per

    for sid in NOISES:
        src = str(tmp_path / f"ctrl_src_{sid}")
        _link(pools[sid], src)
        ctrl = str(tmp_path / "ctrl")
        drive(build_runner(StreamSpec(stream_id=sid, source=src,
                                      config=_config(engine)),
                           root=ctrl, device="cpu"),
              sleep_fn=lambda _s: None)
        got = _shas(os.path.join(root, sid))
        assert CARRY_FILENAME in got and len(got) > 1
        assert got == _shas(os.path.join(ctrl, sid)), sid


def test_an_unbatched_fleet_records_no_rendezvous(pools, tmp_path):
    reg, _root = _fleet(pools, str(tmp_path / "solo"), "fused", False)
    assert reg.value("tpudas_stream_rounds_total", mode="stateful") > 0
    assert _span_count(reg) == 0
    assert get_spans("fleet.rendezvous") == []


def test_the_span_ends_when_the_wave_starts(monkeypatch):
    """A stacked step held 0.3 s: every member's rendezvous ends before
    the step's ``op.stacked`` span ends, the dispatcher's before it
    starts."""
    plan = tfir.design_cascade(100.0, 10, 0.45, 4)
    real = tfir.cascade_decimate_stream_stacked

    def slow(*a, **k):
        time.sleep(0.3)
        return real(*a, **k)

    monkeypatch.setattr(tfir, "cascade_decimate_stream_stacked", slow)
    rng = np.random.default_rng(3)
    members = ("a", "b", "c")
    ex = BatchStepExecutor(members)
    out = {}

    def member(m):
        ex.bind(m)
        try:
            block = torch.from_numpy(
                rng.standard_normal((200, 4)).astype(np.float32))
            out[m] = ex.cascade_step(
                block, tfir.cascade_stream_init(plan, 4, "cpu"), plan,
                "torch")
        finally:
            ex.leave(m)

    clear_spans()
    with use_registry(MetricsRegistry()):
        threads = [threading.Thread(target=member, args=(m,))
                   for m in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert sorted(out) == list(members)
    (op,) = get_spans("op.stacked")
    waits = get_spans("fleet.rendezvous")
    assert sorted(s["attrs"]["stream"] for s in waits) == list(members)
    for s in waits:
        assert s["end_ns"] < op["end_ns"] - 100_000_000, (s, op)
    disp = [s for s in waits if s["thread"] == op["thread"]]
    assert len(disp) == 1 and disp[0]["end_ns"] <= op["start_ns"]
