"""The port's spans on the device trace's clock, across threads, at the
layer boundaries of the batch pass and the stream round.

A span record carries ``start_ns`` / ``end_ns`` on the clock of
``torch.profiler``'s Chrome trace, its thread and the id of its
request's root span (``trace``); ``device_trace`` appends every
thread's spans to the trace it writes, and ``trace_gaps`` charges the
device's idle gaps to the innermost span open at each.  A batch pass
and a stream round record their named spans, parents and counters,
and ``LFProc.timings`` holds the host bracket (``compute_s``) beside
the device seconds (``device_s``).

The file imports neither JAX nor the JAX package; its ``gpu`` test runs
on the card with ``python -m pytest --noconftest -q -m gpu
tests/test_torch_trace_clock.py``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpudas_torch.io.spool import spool
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.obs.trace import current_span, span
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.testing import make_synthetic_spool
from tpudas_torch.tools import trace_gaps
from tpudas_torch.utils.profiling import SpanCapture, device_trace

T1 = np.datetime64("2023-03-22T00:00:00", "ns")
T2 = np.datetime64("2023-03-22T00:02:00", "ns")
PARA = {"output_sample_interval": 1.0, "process_patch_size": 40,
        "edge_buff_size": 10}
WINDOW_SPANS = ("lfproc.prefetch", "lfproc.load_window", "lfproc.stage",
                "lfproc.read_wait", "lfproc.window", "lfproc.compute",
                "lfproc.write_output")


def _trace_doc(folder):
    (name,) = [n for n in os.listdir(folder) if n.endswith(".json")]
    with open(os.path.join(folder, name)) as fh:
        return json.load(fh)


def _spans_of(doc):
    return [ev for ev in doc["traceEvents"]
            if ev.get("cat") == "tpudas_span"]


def test_an_op_in_a_span_lies_inside_it_on_the_exported_clock(tmp_path):
    with use_registry(MetricsRegistry()):
        with device_trace(str(tmp_path)):
            with span("clock.op") as rec:
                torch.ones(4096).add_(1.0).sum()
    doc = _trace_doc(tmp_path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    ops = [ev for ev in doc["traceEvents"]
           if ev.get("ph") == "X" and ev.get("name") == "aten::add_"]
    assert ops
    for ev in ops:
        t_ns = base + float(ev["ts"]) * 1e3
        assert rec["start_ns"] - 1e6 <= t_ns <= rec["end_ns"] + 1e6
    (mine,) = [ev for ev in _spans_of(doc) if ev["name"] == "clock.op"]
    assert abs(base + mine["ts"] * 1e3 - rec["start_ns"]) < 1e3
    assert abs(mine["dur"] * 1e3 - (rec["end_ns"] - rec["start_ns"])) < 1e3
    assert rec["duration_s"] == (rec["end_ns"] - rec["start_ns"]) / 1e9
    assert rec["start"] == rec["start_ns"] / 1e9


def test_a_span_on_another_thread_keeps_its_tid_parent_and_trace(tmp_path):
    seen = {}

    def work(parent):
        with span("clock.child", parent=parent) as rec:
            with span("clock.grandchild") as inner:
                time.sleep(0.002)
        seen["child"], seen["inner"] = rec, inner

    with use_registry(MetricsRegistry()):
        with device_trace(str(tmp_path)):
            with span("clock.pass") as root:
                assert current_span() is root
                th = threading.Thread(target=work, args=(root,),
                                      name="clock-worker")
                th.start()
                th.join(timeout=30)
    assert not th.is_alive()
    child, inner = seen["child"], seen["inner"]
    assert root["trace"] == root["id"] and root["parent"] is None
    assert child["parent"] == root["id"] and child["trace"] == root["id"]
    assert inner["parent"] == child["id"] and inner["trace"] == root["id"]
    assert child["depth"] == 1 and inner["depth"] == 2
    assert child["thread"][1] == "clock-worker"
    assert child["thread"][0] != root["thread"][0]
    events = {ev["name"]: ev for ev in _spans_of(_trace_doc(tmp_path))}
    assert events["clock.child"]["tid"] == child["thread"][0]
    assert events["clock.child"]["tid"] != events["clock.pass"]["tid"]
    assert events["clock.child"]["args"]["parent"] == root["id"]
    assert events["clock.child"]["args"]["trace"] == root["id"]
    assert events["clock.grandchild"]["args"]["trace"] == root["id"]


def test_trace_gaps_charges_each_gap_to_the_innermost_open_span(
        tmp_path, capsys):
    def x(name, cat, ts, dur, tid=1, depth=None):
        ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
              "pid": 1, "tid": tid}
        if depth is not None:
            ev["args"] = {"depth": depth}
        return ev

    events = [
        x("pass", "tpudas_span", 0, 1000, depth=0),
        x("read_wait", "tpudas_span", 100, 300, depth=1),
        # the read on another thread, deeper than the wait on it
        x("load_window", "tpudas_span", 50, 400, tid=2, depth=2),
        x("write_output", "tpudas_span", 700, 100, depth=2),
        x("kern", "kernel", 450, 150, tid=7),
        x("Memcpy HtoD", "gpu_memcpy", 500, 50, tid=8),
        x("Memset", "gpu_memset", 900, 50, tid=7),
        x("late", "tpudas_span", 1100, 100, depth=0),
        x("aten::add", "cpu_op", 1220, 10),  # not device work
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace_gaps.idle_by_span(*trace_gaps.load(str(path)))
    assert got["busy_s"] == pytest.approx(200e-6)
    assert got["window_s"] == pytest.approx(1200e-6)
    assert got["idle"] == pytest.approx({
        "load_window": 450e-6,  # 0-450: pass, read_wait and the read
        "write_output": 300e-6,  # 600-900
        trace_gaps.NO_SPAN: 250e-6,  # 950-1200: its middle is in none
    })
    assert trace_gaps.main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["idle"] == got["idle"]


@pytest.fixture(scope="module")
def tdas64(tmp_path_factory):
    d = tmp_path_factory.mktemp("clock-tdas64")
    make_synthetic_spool(d, n_files=4, file_duration=30.0, fs=200.0,
                         n_ch=64, noise=0.02, format="tdas",
                         write_kwargs={"dtype": "int16", "scale": 1e-4})
    return str(d)


class _CountingLFProc(LFProc):
    """The payload bytes each read returned, counted from outside;
    outputs written as tdas (the card's host may lack h5py)."""

    def _load_window(self, t_lo, t_hi, on_gap, alloc=None):
        patch = super()._load_window(t_lo, t_hi, on_gap, alloc=alloc)
        if patch is not None:
            self.read_bytes = getattr(self, "read_bytes", 0) + int(
                patch.data.nbytes)
        return patch

    def _write_output(self, patch, path):
        patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")


def _pass(src, out, device):
    lfp = _CountingLFProc(spool(src).sort("time").update(), device=device)
    lfp.update_processing_parameter(**PARA)
    lfp.set_output_folder(str(out), delete_existing=True)
    reg = MetricsRegistry()
    with use_registry(reg), SpanCapture() as cap:
        lfp.process_time_range(T1, T2)
    return lfp, reg, cap.recs


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_a_pass_records_every_span_once_a_window_with_its_parents(
        tdas64, tmp_path):
    lfp, reg, recs = _pass(tdas64, tmp_path / "o", "cpu")
    windows = sum(lfp.engine_counts.values())
    assert windows == 5
    spans = _by_name(recs)
    (root,) = spans["lfproc.process_time_range"]
    for name in WINDOW_SPANS:
        assert len(spans[name]) == windows, name
    assert "lfproc.ring_wait" not in spans  # the pinned ring is the card's
    ids = {name: {r["id"] for r in rs} for name, rs in spans.items()}
    assert all(r["trace"] == root["id"] for r in recs)
    for r in spans["lfproc.prefetch"]:
        assert r["parent"] == root["id"]
        assert r["thread"][0] != root["thread"][0]
    for name in ("lfproc.load_window", "lfproc.stage"):
        for r in spans[name]:
            assert r["parent"] in ids["lfproc.prefetch"]
            assert r["thread"] != root["thread"]
    for name in ("lfproc.read_wait", "lfproc.window"):
        assert {r["parent"] for r in spans[name]} == {root["id"]}
        assert {r["thread"] for r in spans[name]} == {root["thread"]}
    for name in ("lfproc.compute", "lfproc.write_output"):
        assert {r["parent"] for r in spans[name]} == ids["lfproc.window"]
    assert reg.value("tpudas_window_read_bytes_total") == lfp.read_bytes
    assert lfp.read_bytes > 0 and lfp.read_bytes % (64 * 2) == 0
    assert reg.get("tpudas_window_stage_copies_total") is None
    t = lfp.timings
    assert set(t) == {"assemble_s", "compute_s", "device_s", "write_s"}
    assert t["compute_s"] > 0 and t["device_s"] > 0
    # off the card the device seconds are the host bracket
    assert t["device_s"] == t["compute_s"]
    assert reg.value("tpudas_window_compute_seconds_total") == pytest.approx(
        t["compute_s"])
    assert reg.value("tpudas_window_device_seconds_total") == pytest.approx(
        t["device_s"])


@pytest.mark.parametrize("engine", ["auto", "fft"])
def test_a_stream_round_records_its_host_steps_in_one_trace(
        tdas64, tmp_path, engine):
    reg = MetricsRegistry()
    with use_registry(reg), SpanCapture() as cap:
        rounds = run_lowpass_realtime(
            tdas64, str(tmp_path / "o"), T1, output_sample_interval=1.0,
            edge_buffer=10.0, process_patch_size=40, poll_interval=0.0,
            sleep_fn=lambda _s: None, engine=engine, device="cpu")
    assert rounds == 1
    spans = _by_name(cap.recs)
    (start,) = spans["stream.runner_start"]
    (prep,) = spans["stream.prep"]
    (rnd,) = spans["stream.round"]
    assert start["end_ns"] <= prep["start_ns"] <= prep["end_ns"]
    assert prep["end_ns"] <= rnd["start_ns"]
    blocks = reg.value("tpudas_stream_blocks_total",
                       engine="fft" if engine == "fft" else "cascade-torch")
    assert blocks >= 1
    for name in ("stream.h2d", "stream.fetch", "stream.emit"):
        assert len(spans[name]) == blocks, name
        assert {r["trace"] for r in spans[name]} == {rnd["id"]}
    assert len(spans["stream.pool"]) >= blocks
    assert {r["trace"] for r in spans["stream.prefetch"]} == {rnd["id"]}
    assert all(r["thread"] != rnd["thread"] for r in spans["stream.prefetch"])
    assert reg.value("tpudas_stream_h2d_bytes_total") > 0
    # the emit's writes are its children
    emit_ids = {r["id"] for r in spans["stream.emit"]}
    assert {r["parent"] for r in spans["lfproc.write_output"]} <= emit_ids
    assert reg.value("tpudas_window_compute_seconds_total") > 0


@pytest.mark.gpu
def test_on_the_card_the_device_seconds_are_event_time(tdas64, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lfp, reg, recs = _pass(tdas64, tmp_path / "o", "cuda")
    spans = _by_name(recs)
    windows = sum(lfp.engine_counts.values())
    assert lfp.staged_windows == windows
    assert len(spans["lfproc.ring_wait"]) == windows
    assert {r["parent"] for r in spans["lfproc.ring_wait"]} <= {
        r["id"] for r in spans["lfproc.prefetch"]}
    assert reg.get("tpudas_window_stage_copies_total") is None
    t = lfp.timings
    assert 0 < t["device_s"] <= t["compute_s"]
