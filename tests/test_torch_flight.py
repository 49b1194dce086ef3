"""The port's flight recorder (tpudas_torch.obs.flight) and the audit's
flight half against the JAX package's.

The cases of ``tests/test_obs_flight.py::TestFlightRecorder`` and
``::TestSpanCapture`` run on the port's recorder, and each reads the
ring its recorder wrote with BOTH packages' readers: the on-disk format
is the JAX one, byte for byte (one canonical ``json.dumps`` per record,
the ``_crc32`` stamp spliced on).  A ring written by either package is
continued by the other (the segment numbering resumes), the two audits
repair the same damage to the same bytes, and the records of a driver
run hold the same Python types field by field as the JAX driver's.
Everything runs on the CPU.
"""

import json
import os
import shutil
import threading

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.integrity.audit import audit as jax_audit
from tpudas.obs import flight as jflight
from tpudas.testing import make_synthetic_spool
from tpudas_torch.integrity.audit import audit as port_audit
from tpudas_torch.obs import flight as tflight
from tpudas_torch.obs.flight import (
    FlightRecorder,
    capture,
    read_flight,
    scan_segment,
    segment_paths,
)
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.obs.trace import add_span_sink, remove_span_sink, span
from tpudas_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    install_fault_plan,
)

T0 = "2023-03-22T00:00:00"
RECORDERS = {"port": tflight.FlightRecorder, "jax": jflight.FlightRecorder}


def _both_read(folder, **kw):
    """The ring read by both packages' readers; they must agree."""
    got = tflight.read_flight(folder, **kw)
    assert jflight.read_flight(folder, **kw) == got
    return got


class TestFlightRecorder:
    def test_record_flush_read_roundtrip(self, tmp_path):
        reg = MetricsRegistry()
        with use_registry(reg):
            rec = FlightRecorder(tmp_path)
            rec.record("round", round=1, phases={"poll": 0.1})
            rec.record("span", name="stream.round", dur_s=0.5, round=1)
            rec.record("fault", fault_kind="transient", attempt=1)
            assert rec.flush() == 3
            rec.close()
        recs = _both_read(tmp_path)
        assert [r["kind"] for r in recs] == ["round", "span", "fault"]
        assert recs[0]["phases"] == {"poll": 0.1}
        assert len(_both_read(tmp_path, kind="span")) == 1
        assert _both_read(tmp_path, kind="span", name="stream.round")
        assert _both_read(tmp_path, limit=2) == recs[-2:]
        assert reg.value(
            "tpudas_obs_flight_records_total", kind="span") == 1.0
        assert reg.value("tpudas_obs_flight_bytes_total") > 0

    def test_ring_rotation_is_bounded(self, tmp_path):
        rec = FlightRecorder(tmp_path, max_segment_bytes=4096,
                             max_segments=3)
        for i in range(400):
            rec.record("round", round=i, pad="x" * 64)
            rec.flush()
        rec.close()
        segs = segment_paths(tmp_path)
        assert segs == jflight.segment_paths(tmp_path)
        assert 1 < len(segs) <= 3
        for p in segs:
            # rotation happens at the flush after crossing the bound
            assert os.path.getsize(p) < 4096 + 256
        rounds = [r["round"] for r in _both_read(tmp_path, kind="round")]
        assert rounds[-1] == 399 and rounds[0] > 0
        assert rounds == sorted(rounds)

    def test_torn_tail_readable_prefix_and_audit_repair(self, tmp_path):
        rec = FlightRecorder(tmp_path)
        for i in range(10):
            rec.record("round", round=i)
        rec.flush()
        rec.close()
        seg = segment_paths(tmp_path)[-1]
        data = open(seg, "rb").read()
        open(seg, "wb").write(data[:-15])  # SIGKILL mid-segment-write
        reg = MetricsRegistry()
        with use_registry(reg):
            rounds = [r["round"] for r in read_flight(tmp_path,
                                                      kind="round")]
        assert rounds == list(range(9))  # the verified prefix
        assert rounds == [r["round"] for r in jflight.read_flight(
            tmp_path, kind="round")]
        assert reg.value("tpudas_obs_flight_torn_records_total") == 1.0
        rep = port_audit(str(tmp_path), repair=True)
        assert rep["clean"]
        assert [(i["artifact"], i["status"], i["action"])
                for i in rep["issues"]] == [("flight", "torn", "truncated")]
        rep2 = port_audit(str(tmp_path), repair=True)
        assert rep2["clean"] and not rep2["issues"]
        assert jax_audit(str(tmp_path), repair=False)["issues"] == []
        rec2 = FlightRecorder(tmp_path)  # the repaired ring resumes
        rec2.record("round", round=99)
        rec2.flush()
        rec2.close()
        assert _both_read(tmp_path, kind="round")[-1]["round"] == 99

    def test_torn_tail_then_append_rotates_no_record_lost(self, tmp_path):
        """Resume over an unaudited torn segment: the recorder rotates to
        a fresh segment instead of merging the torn line into its first
        record."""
        rec = FlightRecorder(tmp_path)
        for i in range(5):
            rec.record("round", round=i)
        rec.flush()
        rec.close()
        seg = segment_paths(tmp_path)[-1]
        data = open(seg, "rb").read()
        open(seg, "wb").write(data[:-9])  # crash mid-write, no audit yet
        rec2 = FlightRecorder(tmp_path)
        rec2.record("round", round=100)
        rec2.record("round", round=101)
        rec2.flush()
        rec2.close()
        rounds = [r["round"] for r in _both_read(tmp_path, kind="round")]
        assert rounds == [0, 1, 2, 3, 100, 101]
        assert len(segment_paths(tmp_path)) == 2  # rotated, not appended

    def test_corrupt_middle_line_skipped_not_fatal(self, tmp_path):
        rec = FlightRecorder(tmp_path)
        for i in range(5):
            rec.record("round", round=i)
        rec.flush()
        rec.close()
        seg = segment_paths(tmp_path)[-1]
        lines = open(seg).read().splitlines()
        lines[2] = lines[2].replace('"round":2', '"round":7')  # bit rot
        open(seg, "w").write("\n".join(lines) + "\n")
        records, good_lines, bad = scan_segment(seg)
        assert (records, good_lines, bad) == jflight.scan_segment(seg)
        assert bad == 1
        assert [r["round"] for r in records] == [0, 1, 3, 4]

    def test_ki_kill_at_flush_site_leaves_verified_prefix(self, tmp_path):
        rec = FlightRecorder(tmp_path)
        rec.record("round", round=1)
        rec.flush()
        rec.record("round", round=2)
        plan = FaultPlan(FaultSpec("obs.flight_write",
                                   exc=KeyboardInterrupt))
        with install_fault_plan(plan):
            with pytest.raises(KeyboardInterrupt):
                rec.flush()
        assert plan.fired
        assert [r["round"] for r in _both_read(
            tmp_path, kind="round")] == [1]
        assert port_audit(str(tmp_path), repair=True)["clean"]

    def test_enospc_shed_drops_counted_never_raises(self, tmp_path):
        from tpudas_torch.integrity import resource

        reg = MetricsRegistry()
        with use_registry(reg):
            rec = FlightRecorder(tmp_path)
            rec.record("round", round=1)
            resource.note_pressure("test", None)
            try:
                assert rec.flush() == 0  # shed, not written
            finally:
                resource.clear_pressure("test done")
            assert reg.value(
                "tpudas_obs_flight_drops_total", reason="shed") == 1.0
            assert reg.value(
                "tpudas_obs_events_dropped_total",
                reason="flight_shed") == 1.0
            rec.close()
        assert _both_read(tmp_path) == []

    def test_write_failure_drops_counted_never_raises(self, tmp_path):
        # .flight exists as a FILE: every flush write must fail softly
        open(os.path.join(tmp_path, ".flight"), "w").close()
        reg = MetricsRegistry()
        with use_registry(reg):
            rec = FlightRecorder(tmp_path)
            rec.record("round", round=1)
            assert rec.flush() == 0
            assert reg.value(
                "tpudas_obs_flight_drops_total", reason="error") == 1.0

    def test_envelope_wins_and_unencodable_dropped(self, tmp_path):
        """A field named ``kind``/``ts`` cannot overwrite the envelope,
        in both packages alike; a value that ``default=str`` turns into
        a string is written as that string."""
        for pkg, cls in RECORDERS.items():
            d = tmp_path / pkg
            rec = cls(d)
            rec.record("fault", kind="spoofed", ts=-1, fault_kind="x",
                       value=np.float32(1.5), arr=(1, 2))
            rec.flush()
            rec.close()
        got = _both_read(tmp_path / "port")
        want = _both_read(tmp_path / "jax")
        assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == [
            {k: v for k, v in r.items() if k != "ts"} for r in want]
        assert got[0]["kind"] == "fault" and got[0]["ts"] > 0
        assert got[0]["value"] == "1.5" and got[0]["arr"] == [1, 2]

    def test_same_records_same_bytes(self, tmp_path, monkeypatch):
        """With the clock pinned, both recorders write the same segment
        bytes for the same records."""
        import time as _time

        monkeypatch.setattr(_time, "time", lambda: 1700000000.123456)
        for pkg, cls in RECORDERS.items():
            rec = cls(tmp_path / pkg)
            rec.record("round", round=1, phases={"poll": 0.25,
                                                 "commit": 1e-7},
                       head_lag=None, mode="stateful")
            rec.record("span", name="stream.round", depth=0, dur_s=0.5)
            rec.flush()
            rec.close()
        seg = "seg-00000000.jsonl"
        assert (tmp_path / "port" / ".flight" / seg).read_bytes() == (
            tmp_path / "jax" / ".flight" / seg).read_bytes()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_ring_continued_across_packages(tmp_path, first):
    """A ring that one package's recorder wrote (and rotated) is
    continued by the other's: the newest segment's number is resumed,
    and the next rotation takes the next number."""
    second = "port" if first == "jax" else "jax"
    rec = RECORDERS[first](tmp_path, max_segment_bytes=4096)
    for i in range(80):
        rec.record("round", round=i, pad="y" * 64)
        rec.flush()
    rec.close()
    segs = segment_paths(tmp_path)
    assert len(segs) >= 2
    newest = int(tflight.SEGMENT_RE.match(
        os.path.basename(segs[-1])).group(1))
    rec2 = RECORDERS[second](tmp_path, max_segment_bytes=4096)
    assert rec2._seg_index == newest
    for i in range(80, 160):
        rec2.record("round", round=i, pad="y" * 64)
        rec2.flush()
    rec2.close()
    rounds = [r["round"] for r in _both_read(tmp_path, kind="round")]
    assert rounds == sorted(rounds) and rounds[-1] == 159
    names = [os.path.basename(p) for p in segment_paths(tmp_path)]
    assert names == sorted(names)
    assert int(names[-1][4:12]) > newest


class TestSpanCapture:
    def test_capture_scopes_spans_to_recorder(self, tmp_path):
        reg = MetricsRegistry()
        with use_registry(reg):
            rec = FlightRecorder(tmp_path)
            with span("outside.scope"):
                pass
            with capture(rec):
                with span("stream.round", round=3):
                    with span("stream.increment"):
                        with span("op.cascade_stream"):  # depth 2: capped
                            pass
            with span("outside.after"):
                pass
            rec.flush()
            rec.close()
        names = [r["name"] for r in _both_read(tmp_path, kind="span")]
        assert "stream.round" in names and "stream.increment" in names
        assert "outside.scope" not in names
        assert "outside.after" not in names
        assert "op.cascade_stream" not in names  # depth cap (default 2)
        rec3 = _both_read(tmp_path, kind="span", name="stream.round")[0]
        assert rec3["round"] == 3 and rec3["dur_s"] >= 0.0
        assert rec3["depth"] == 0

    def test_depth_relative_to_capture_scope(self, tmp_path, monkeypatch):
        """Under an outer span (a fleet step's ``fleet.run`` /
        ``fleet.step``) the cap and the recorded depth count from the
        capture scope, as in the JAX recorder; the cap follows
        ``TPUDAS_FLIGHT_SPAN_DEPTH``."""
        monkeypatch.setenv("TPUDAS_FLIGHT_SPAN_DEPTH", "1")
        rec = FlightRecorder(tmp_path)
        with span("fleet.run"), span("fleet.step"):
            with capture(rec):
                with span("stream.round", round=1):
                    with span("stream.increment"):
                        pass
        rec.flush()
        recs = _both_read(tmp_path, kind="span")
        assert [(r["name"], r["depth"]) for r in recs] == [
            ("stream.round", 0)]

    def test_capture_is_thread_local(self, tmp_path):
        """Two threads, each under its own recorder (a batched fleet's
        member threads): each ring holds only its own thread's spans."""
        recs = {k: FlightRecorder(tmp_path / k) for k in ("a", "b")}
        barrier = threading.Barrier(2)

        def member(k):
            with capture(recs[k]):
                barrier.wait()
                for i in range(20):
                    with span("stream.round", stream=k, round=i):
                        pass
            recs[k].flush()

        threads = [threading.Thread(target=member, args=(k,))
                   for k in recs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for k in recs:
            got = _both_read(tmp_path / k, kind="span")
            assert len(got) == 20
            assert {r["stream"] for r in got} == {k}

    def test_capture_none_is_noop(self):
        with capture(None):
            with span("whatever"):
                pass

    def test_raising_sink_counted_not_fatal(self):
        reg = MetricsRegistry()

        def bad_sink(rec):
            raise RuntimeError("boom")

        add_span_sink(bad_sink)
        try:
            with use_registry(reg):
                with span("sink.victim"):
                    pass
        finally:
            remove_span_sink(bad_sink)
        assert reg.value(
            "tpudas_obs_spans_dropped_total", reason="sink_error") >= 1.0

    def test_log_event_drops_counted_obs_wide(self):
        """A raising log handler is counted in the registry (the repair:
        the port counted only in a module global), as in the JAX
        package."""
        from tpudas_torch.utils.logging import (
            event_drops,
            log_event,
            set_log_handler,
        )

        reg = MetricsRegistry()

        def bad_handler(event):
            raise ValueError("nope")

        before = event_drops()
        set_log_handler(bad_handler)
        try:
            with use_registry(reg):
                log_event("doomed")
        finally:
            set_log_handler(None)
        assert event_drops() == before + 1
        assert reg.value(
            "tpudas_obs_events_dropped_total", reason="handler") == 1.0
        assert reg.value("tpudas_log_event_drops_total") == 1.0


# ---------------------------------------------------------------------------
# the audit's flight half: both audits repair the same damage to the
# same bytes


def _ring(folder, n=40):
    rec = FlightRecorder(folder, max_segment_bytes=4096)
    for i in range(n):
        rec.record("round", round=i, pad="z" * 200)
        rec.flush()
    rec.close()
    return segment_paths(folder)


def _torn_tail(folder):
    seg = _ring(folder)[-1]
    data = open(seg, "rb").read()
    open(seg, "wb").write(data[:-17])


def _corrupt_segment(folder):
    segs = _ring(folder)
    assert len(segs) >= 2
    with open(segs[0], "wb") as fh:  # no verifiable line left
        fh.write(b"\x00garbage\n{not json\n")


def _corrupt_middle(folder):
    seg = _ring(folder)[0]
    lines = open(seg).read().splitlines()
    lines[1] = lines[1].replace('"round":1', '"round":5')
    open(seg, "w").write("\n".join(lines) + "\n")


def _stray_tmp(folder):
    _ring(folder, n=3)
    for name in ("seg-00000001.jsonl.tmp", "seg-00000009.jsonl.tmp.4242"):
        with open(os.path.join(folder, ".flight", name), "wb") as fh:
            fh.write(b"half a line")


DAMAGE = {"torn_tail": _torn_tail, "corrupt_segment": _corrupt_segment,
          "corrupt_middle": _corrupt_middle, "stray_tmp": _stray_tmp}


def _tree(folder):
    out = {}
    for dirpath, _dirs, files in os.walk(folder):
        for name in files:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, folder)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_audit_flight_half_matches_jax(tmp_path, damage):
    src = str(tmp_path / "src")
    os.makedirs(src)
    DAMAGE[damage](src)
    copies = {}
    for pkg, fn in (("jax", jax_audit), ("port", port_audit)):
        d = str(tmp_path / pkg)
        shutil.copytree(src, d)
        copies[pkg] = (d, fn(d, repair=True))
    (jd, jrep), (pd, prep) = copies["jax"], copies["port"]
    key = [(i["artifact"], os.path.relpath(i["path"], pd), i["status"],
            i["action"]) for i in prep["issues"]]
    want = [(i["artifact"], os.path.relpath(i["path"], jd), i["status"],
             i["action"]) for i in jrep["issues"]]
    assert key == want and key
    assert prep["clean"] and jrep["clean"]
    assert prep["repaired"] == jrep["repaired"]
    assert _tree(pd) == _tree(jd)
    for d, fn in ((pd, port_audit), (jd, jax_audit)):
        again = fn(d, repair=True)
        assert again["clean"] and not again["issues"]
    assert _both_read(pd) == _both_read(jd)


def test_audit_report_only_changes_nothing(tmp_path):
    _torn_tail(str(tmp_path))
    before = _tree(str(tmp_path))
    rep = port_audit(str(tmp_path), repair=False)
    assert not rep["clean"]
    assert [(i["artifact"], i["action"]) for i in rep["issues"]] == [
        ("flight", "found")]
    assert _tree(str(tmp_path)) == before


# ---------------------------------------------------------------------------
# a driver run's records: the JAX types, field by field


def _type_tree(value):
    if isinstance(value, dict):
        return {k: _type_tree(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_type_tree(v) for v in value]
    return type(value).__name__


def test_driver_records_hold_the_jax_types(tmp_path, monkeypatch):
    """A 2-round stateful run of each package (health on, flight at its
    default): every round, fault-free, and finish record has the same
    keys and the same JSON type in every field as the JAX driver's, so
    no numpy or torch scalar reached the canonical dump as a string."""
    from tpudas.proc.streaming import run_lowpass_realtime as jax_rt
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    monkeypatch.setenv("TPUDAS_DEVPROF", "0")
    monkeypatch.delenv("TPUDAS_FLIGHT", raising=False)
    pool = str(tmp_path / "pool")
    make_synthetic_spool(pool, n_files=3, file_duration=20.0, fs=50.0,
                         n_ch=4, noise=0.01)
    names = sorted(n for n in os.listdir(pool) if n.endswith(".h5"))
    outs = {}
    for pkg, driver in (("port", run_lowpass_realtime), ("jax", jax_rt)):
        src = str(tmp_path / f"src-{pkg}")
        os.makedirs(src)
        for n in names[:2]:
            os.link(os.path.join(pool, n), os.path.join(src, n))
        fed = []

        def sleep(_s, src=src, fed=fed):
            if not fed:
                fed.append(1)
                os.link(os.path.join(pool, names[2]),
                        os.path.join(src, names[2]))

        kw = {"device": "cpu"} if pkg == "port" else {"flight": None}
        outs[pkg] = str(tmp_path / pkg)
        assert driver(source=src, output_folder=outs[pkg], start_time=T0,
                      output_sample_interval=1.0, edge_buffer=5.0,
                      process_patch_size=20, poll_interval=0.0,
                      sleep_fn=sleep, health=True, stateful=True,
                      **kw) == 2
    recs = {pkg: [r for r in _both_read(out) if r["kind"] != "span"]
            for pkg, out in outs.items()}
    assert [r["kind"] for r in recs["port"]] == [
        r["kind"] for r in recs["jax"]] == ["round", "round", "event"]
    for got, want in zip(recs["port"], recs["jax"]):
        got, want = dict(got), dict(want)
        for k in ("stream",):  # the shim's id names its own folder
            assert isinstance(got.pop(k), str) and isinstance(
                want.pop(k), str)
        assert _type_tree(got) == _type_tree(want)
    # the raw lines: every value that is not a string in the JAX ring is
    # not a string in the port's
    seg = os.path.join(outs["port"], ".flight", "seg-00000000.jsonl")
    for line in open(seg):
        obj = json.loads(line)
        assert not any(isinstance(v, str) and v.startswith(("tensor(",
                                                            "np."))
                       for v in obj.values())
