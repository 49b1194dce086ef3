"""The port's live push plane (tpudas_torch.live) against the JAX one.

The same round patches go into a JAX ``LiveHub`` and a port ``LiveHub``
with subscribers at every level and one that never reads: the frames'
payload bytes under every codec, the publish stats, the ladder
outcomes, ``round_record()``, ``resume_frames`` and the SSE wire bytes
of ``format_sse`` / ``delta_event`` are equal.  ``published_unix_ns``,
the one field that reads the wall clock, is pinned to one value on both
frames before the wire bytes are compared.  The tolerance is exact.

Then every class of ``tests/test_live.py`` runs against the port: the
bounded queue and the degrade-then-drop ladder, resume, the emit
listener's hardening, the stream end to end (snapshot == ``/query``,
deltas == the ring, ``Last-Event-ID`` resume, the flight record's
``live`` block, a fault at ``live.emit`` and never-reading subscribers
leaving the outputs byte-identical), fleet routing (each
``FleetEngine`` member's hub under ``/s/<id>/live``), the bridge across
registries, and a SIGKILL at ``live.emit`` then a resume equal to a
live-off control.  One bridge test crosses the packages both ways: a
port ``BridgeSubscriber`` mirrors a JAX ``LiveBridge`` and a JAX
subscriber a port bridge.  Everything runs on the CPU, at 8 channels.
"""

import base64
import glob
import hashlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.core.patch import Patch as JPatch
from tpudas.live import hub as jhub
from tpudas.live import protocol as jprotocol
from tpudas.live import sse as jsse
from tpudas.obs import registry as jreg
from tpudas.testing import make_synthetic_spool
from tpudas_torch.codec import decode_tile
from tpudas_torch.core.patch import Patch
from tpudas_torch.live import find_hub, register_hub, reset_hubs
from tpudas_torch.live import hub as thub
from tpudas_torch.live import protocol as tprotocol
from tpudas_torch.live import sse as tsse
from tpudas_torch.live.hub import DEGRADE_FACTOR, LiveFrame, LiveHub
from tpudas_torch.live.protocol import resume_frames
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan
from tpudas_torch.serve.http import DASServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
NCH = 8
PARAMS = dict(start_time=T0, output_sample_interval=1.0, edge_buffer=5.0,
              process_patch_size=20, poll_interval=0.0, file_duration=0.0)
TIMEOUT = 20.0
# the one frame field that reads the wall clock
WALL_CLOCK = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _fresh_hubs():
    reset_hubs()
    jhub.reset_hubs()
    yield
    reset_hubs()
    jhub.reset_hubs()


# ---------------------------------------------------------------------------
# the hub, both packages on the same patches


def _round_rows(rnd, rows=17, nch=NCH):
    rng = np.random.default_rng(100 + rnd)
    t0 = np.int64(1_679_443_200_000_000_000) + rnd * rows * 10**9
    times = t0 + np.arange(rows, dtype=np.int64) * 10**9
    data = rng.standard_normal((rows, nch)).astype(np.float32)
    data[3, 1] = np.nan  # a gap row survives the reductions
    return times, data


def _patches(cls, times, data, cut=7):
    """The round as two output patches of package ``cls``, the later
    one first (the hub sorts them by time)."""
    out = []
    for lo, hi in ((cut, len(times)), (0, cut)):
        d = data[lo:hi].copy()
        out.append(cls(
            data=torch.from_numpy(d) if cls is Patch else d,
            coords={"time": times[lo:hi].astype("datetime64[ns]"),
                    "distance": np.arange(data.shape[1], dtype=float)},
            dims=("time", "distance")))
    return out


def _events(rnd):
    return [{"seq": rnd, "t_ns": 1_679_443_200_000_000_000 + rnd,
             "channel": rnd % NCH, "op": "stalta", "kind": "on",
             "score": 2.5 + rnd}] if rnd % 2 else []


def _drive_hub(mod, proto, sse, cls, rounds=7):
    """Publish ``rounds`` rounds into a fresh hub of package ``mod``
    with one drained subscriber per level and one that never reads;
    returns everything the two packages must agree on."""
    hub = mod.LiveHub("parity", queue_depth=2, max_level=2, ring=4)
    readers = [hub.subscribe(level=lvl) for lvl in range(3)]
    slow = hub.subscribe(level=0, depth=1)
    got = {"stats": [], "wire": [], "ladder": [], "records": []}
    for rnd in range(1, rounds + 1):
        times, data = _round_rows(rnd)
        if rnd == 5:
            stats = hub.publish(rnd, [], _events(rnd))  # event-only frame
        else:
            stats = hub.publish(rnd, _patches(cls, times, data),
                                _events(rnd))
        got["stats"].append(stats)
        for sub in readers:
            frame = sub.next(timeout=0)
            frame.published_unix_ns = WALL_CLOCK
            try:
                wire = sse.format_sse(
                    "delta", proto.delta_event(frame, sub.level),
                    event_id=frame.seq)
            except ValueError as exc:
                # an event-only frame has no rows to reduce: both
                # packages raise at level >= 1 alike
                wire = ("ValueError", sub.level, str(exc))
            got["wire"].append(wire)
        got["ladder"].append((slow.level, slow.degrades, slow.dropped,
                              slow.shed_frames, slow.qsize()))
        got["records"].append(hub.round_record())
    frame = hub.latest_frame()
    got["payloads"] = [
        frame.payload(lvl, codec, **params)
        for lvl in range(3)
        for codec, params in (("deflate", {}), ("bitshuffle-deflate", {}),
                              ("quantize-deflate", {"max_error": 1e-3}))
    ]
    got["levels"] = [(frame.level_times(lvl).tolist(),
                      frame.level_array(lvl).tobytes()) for lvl in range(3)]
    got["resume"] = [
        None if fr is None else [f.seq for f in fr]
        for fr in (proto.resume_frames(hub, k) for k in (0, 2, 4, 6, 7, 9))
    ]
    got["hello"] = sse.format_sse("hello", {"stream": hub.key,
                                            "seq": hub.head_seq()})
    got["subscribers"] = hub.n_subscribers()
    return got


def test_hub_parity_with_jax():
    with use_registry(MetricsRegistry()) as preg, \
            jreg.use_registry(jreg.MetricsRegistry()) as jr:
        port = _drive_hub(thub, tprotocol, tsse, Patch)
        jax_ = _drive_hub(jhub, jprotocol, jsse, JPatch)
        for key in sorted(port):
            assert port[key] == jax_[key], key
        for name, labels in (
            ("tpudas_live_frames_published_total", {}),
            ("tpudas_live_degrades_total", {}),
            ("tpudas_live_frames_dropped_total", {"reason": "degraded"}),
            ("tpudas_live_frames_dropped_total", {"reason": "slow_drop"}),
            ("tpudas_live_subscribers_dropped_total", {"reason": "slow"}),
            ("tpudas_live_resumes_total", {"result": "replay"}),
            ("tpudas_live_resumes_total", {"result": "snapshot"}),
        ):
            assert preg.value(name, **labels) == jr.value(name, **labels), (
                name, labels)
    # the run exercised the whole ladder and both resume outcomes
    assert port["ladder"][-1][2] == "slow"
    assert None in port["resume"] and [] in port["resume"]
    assert port["stats"][4]["published"] == 1  # the event-only round
    assert [w[1] for w in port["wire"] if isinstance(w, tuple)] == [1, 2]


def test_snapshot_event_parity(tmp_path):
    """``snapshot_event`` through each package's query engine over one
    folder: the same body (the pyramid is the port's)."""
    from tpudas.serve.query import QueryEngine as JEngine
    from tpudas_torch.serve.query import QueryEngine

    out = str(tmp_path / "o")
    pool = str(tmp_path / "pool")
    make_synthetic_spool(pool, n_files=3, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    assert _run(pool, str(tmp_path / "src"), out, first=3, then=(),
                pyramid=True) == 1
    t0 = np.datetime64("2023-03-22T00:00:08", "ns")
    t1 = np.datetime64("2023-03-22T00:00:40", "ns")
    for kw in ({}, {"max_samples": 4}, {"codec_id": "bitshuffle-deflate"}):
        assert tprotocol.snapshot_event(QueryEngine(out), t0, t1, 3, **kw) \
            == jprotocol.snapshot_event(JEngine(out), t0, t1, 3, **kw)


def test_registry_and_defaults_match_jax(monkeypatch):
    for mod in (thub, jhub):
        hub = mod.LiveHub("d")
        assert (hub.queue_depth, hub._ring.maxlen, hub.max_level,
                hub.max_subscribers) == (8, 64, 2, 4096)
    monkeypatch.setenv("TPUDAS_LIVE_DEPTH", "3")
    monkeypatch.setenv("TPUDAS_LIVE_RING", "5")
    monkeypatch.setenv("TPUDAS_LIVE_MAX_LEVEL", "1")
    monkeypatch.setenv("TPUDAS_LIVE_MAX_SUBS", "7")
    for mod in (thub, jhub):
        hub = mod.LiveHub("e")
        assert (hub.queue_depth, hub._ring.maxlen, hub.max_level,
                hub.max_subscribers) == (3, 5, 1, 7)
    a = register_hub("sid", "/abs/folder")
    assert register_hub("/abs/folder") is a
    assert find_hub(stream_id="nope", folder="/abs/folder") is a
    assert sorted(thub.hub_keys(a)) == ["/abs/folder", "sid"]
    with pytest.raises(ValueError, match="at least one key"):
        register_hub()


# ---------------------------------------------------------------------------
# tests/test_live.py, against the port


def _frame(seq, rnd=None, rows=16, nch=4, seed=0):
    rng = np.random.default_rng(seed + seq)
    t0 = np.int64(1_700_000_000_000_000_000) + seq * rows * 10**9
    times = t0 + np.arange(rows, dtype=np.int64) * 10**9
    data = rng.standard_normal((rows, nch)).astype(np.float32)
    return LiveFrame(seq, rnd if rnd is not None else seq, times, data,
                     [], 10**9)


def _publish_n(hub, n, start=1, **kw):
    for i in range(start, start + n):
        fr = _frame(i, **kw)
        with hub._lock:
            hub.seq = fr.seq
            hub._ring.append(fr)
        hub._fanout(fr)


class TestBoundedQueue:
    def test_queue_never_exceeds_depth(self):
        hub = LiveHub("s", queue_depth=3, max_level=1, ring=8)
        sub = hub.subscribe()
        for i in range(1, 20):
            _publish_n(hub, 1, start=i)
            assert sub.qsize() <= 3
        assert sub.dropped == "slow"
        assert hub.n_subscribers() == 0

    def test_degrade_then_drop_ladder_is_deterministic(self):
        with use_registry(MetricsRegistry()):
            hub = LiveHub("s", queue_depth=2, max_level=2, ring=16)
            sub = hub.subscribe()
            outcomes = [sub.offer(_frame(i)) for i in range(1, 7)]
            assert outcomes == ["queued", "queued", "degraded",
                                "degraded", "dropped", "dead"]
            assert sub.level == 2 and sub.dropped == "slow"
            assert sub.degrades == 2 and sub.qsize() == 0

    def test_subscriber_cap_sheds_with_reason(self):
        with use_registry(MetricsRegistry()) as reg:
            hub = LiveHub("s", max_subscribers=1)
            assert hub.subscribe() is not None
            assert hub.subscribe() is None
            assert reg.value("tpudas_live_subscribers_dropped_total",
                             reason="capacity") == 1

    def test_degrade_level_rows_match_block_mean(self):
        fr = _frame(1, rows=10, nch=3)
        lvl1 = fr.level_array(1)
        f = DEGRADE_FACTOR
        expect = np.concatenate([
            fr.data[:8].reshape(2, f, 3).mean(axis=1),
            fr.data[8:].mean(axis=0, keepdims=True),
        ]).astype(np.float32)
        np.testing.assert_array_equal(lvl1, expect)
        assert fr.level_times(1).size == lvl1.shape[0]
        assert fr.payload(1) is fr.payload(1)
        np.testing.assert_array_equal(decode_tile(fr.payload(1)), lvl1)


class TestResume:
    def test_gap_inside_ring_replays(self):
        with use_registry(MetricsRegistry()) as reg:
            hub = LiveHub("s", ring=16)
            _publish_n(hub, 5)
            assert [f.seq for f in resume_frames(hub, 2)] == [3, 4, 5]
            assert reg.value("tpudas_live_resumes_total",
                             result="replay") == 1

    def test_gap_beyond_ring_falls_back_to_snapshot(self):
        with use_registry(MetricsRegistry()) as reg:
            hub = LiveHub("s", ring=2)
            _publish_n(hub, 6)
            assert resume_frames(hub, 1) is None
            assert reg.value("tpudas_live_resumes_total",
                             result="snapshot") == 1

    def test_up_to_date_client_replays_nothing(self):
        hub = LiveHub("s", ring=4)
        _publish_n(hub, 3)
        assert resume_frames(hub, 3) == []
        assert resume_frames(hub, None) is None


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool-live")
    make_synthetic_spool(d, n_files=7, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    return str(d)


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    for name in sorted(n for n in os.listdir(pool) if n.endswith(".h5"))[
            :upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _run(pool, src, out, first=3, then=(5, 7), **kw):
    """The port driver over a growing spool: ``first`` files, then one
    more round per count in ``then``."""
    _link(pool, src, first)
    feeds = list(then)

    def sleep(_):
        if feeds:
            _link(pool, src, feeds.pop(0))

    kw.setdefault("device", "cpu")
    return run_lowpass_realtime(source=src, output_folder=out,
                                sleep_fn=sleep, **PARAMS, **kw)


def _sse_events(raw: str):
    out = []
    complete = raw.rsplit("\n\n", 1)[0]
    for block in complete.split("\n\n"):
        ev = ident = data = None
        for line in block.splitlines():
            if line.startswith("event: "):
                ev = line[7:]
            elif line.startswith("id: "):
                ident = int(line[4:])
            elif line.startswith("data: "):
                data = json.loads(line[6:])
        if ev is not None:
            out.append((ev, ident, data))
    return out


def _read_sse(url, want_events=1, timeout=TIMEOUT, headers=()):
    req = urllib.request.Request(url)
    for k, v in headers:
        req.add_header(k, v)
    resp = urllib.request.urlopen(req, timeout=timeout)
    buf = b""
    deadline = time.time() + timeout
    while time.time() < deadline:
        chunk = resp.read(512)
        if not chunk:
            break
        buf += chunk
        if len(_sse_events(buf.decode())) >= want_events:
            break
    resp.close()
    return _sse_events(buf.decode())


def _h5_digests(folder):
    return {
        os.path.basename(f): hashlib.sha256(open(f, "rb").read()).hexdigest()
        for f in sorted(glob.glob(os.path.join(folder, "*.h5")))
    }


def _tree_digests(folder, sub):
    root = os.path.join(folder, sub)
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = hashlib.sha256(
                open(path, "rb").read()).hexdigest()
    return out


class TestListenerHardening:
    def test_raising_listener_is_counted_and_skipped(self, pool, tmp_path):
        from tpudas_torch.io.spool import spool
        from tpudas_torch.proc.lfproc import LFProc

        out = str(tmp_path / "out")
        with use_registry(MetricsRegistry()) as reg:
            lfp = LFProc(spool(pool).sort("time").update(), device="cpu")
            lfp.update_processing_parameter(
                output_sample_interval=1.0, process_patch_size=20,
                edge_buff_size=5)
            lfp.set_output_folder(out, delete_existing=True)
            good, bad = [], []

            def raising(patch):
                bad.append(patch)
                raise RuntimeError("broken consumer")

            lfp.add_emit_listener(raising)
            lfp.add_emit_listener(good.append)
            t0 = np.datetime64(T0)
            lfp.process_time_range(t0, t0 + np.timedelta64(60, "s"))
            assert glob.glob(os.path.join(out, "*.h5"))
            assert len(good) >= 2 and len(bad) == 1
            assert reg.value("tpudas_lfproc_listener_errors_total") == 1
            lfp.clear_emit_failures()
            assert lfp._failed_listeners == set()


class TestEndToEnd:
    @pytest.fixture(scope="class")
    def live_streamed(self, pool, tmp_path_factory):
        """3 + 2 + 2 files over 3 rounds with live + pyramid on."""
        tmp = tmp_path_factory.mktemp("live-e2e")
        out = str(tmp / "results")
        reset_hubs()
        assert _run(pool, str(tmp / "raw"), out, live=True,
                    pyramid=True) == 3
        hub = find_hub(folder=out)
        assert hub is not None and hub.seq == 3
        return out, hub

    @pytest.fixture(autouse=True)
    def _fresh_hubs(self, live_streamed):
        """Keep the class's stream hub registered across its tests."""
        out, hub = live_streamed
        with thub._HUBS_LOCK:
            thub._HUBS[os.path.abspath(out)] = hub
        yield

    def test_snapshot_then_delta_matches_pull_query(self, live_streamed):
        out, hub = live_streamed
        with DASServer(out, port=0) as srv:
            events = _read_sse(srv.base_url + "/live?window=30&heartbeat=0.2",
                               want_events=2)
            assert events[0][0] == "hello" and events[0][2]["seq"] == hub.seq
            snap = next(d for ev, _i, d in events if ev == "snapshot")
            t0_ns, n, step = snap["t0_ns"], snap["rows"], snap["step_ns"]
            with urllib.request.urlopen(
                    srv.base_url + f"/query?t0={t0_ns}&t1={t0_ns + n * step}"
                    "&format=npy", timeout=TIMEOUT) as r:
                pulled = np.load(io.BytesIO(r.read()))
            pushed = decode_tile(base64.b64decode(snap["blob"]))
            assert pushed.dtype == np.float32
            np.testing.assert_array_equal(pushed,
                                          np.asarray(pulled, np.float32))
            deltas = _read_sse(
                srv.base_url + "/live?window=0&heartbeat=0.2&last_id=0",
                want_events=1 + hub.seq)
            ring = {f.seq: f for f in list(hub._ring)}
            checked = 0
            for ev, ident, data in deltas:
                if ev != "delta":
                    continue
                assert ident == data["seq"]
                got = decode_tile(base64.b64decode(data["blob"]))
                np.testing.assert_array_equal(
                    got, ring[data["seq"]].level_array(data["level"]))
                checked += 1
            assert checked == hub.seq

    def test_sequence_gap_resume_over_http(self, live_streamed):
        out, hub = live_streamed
        with DASServer(out, port=0) as srv:
            events = _read_sse(srv.base_url + "/live?window=0&heartbeat=0.2",
                               want_events=hub.seq,
                               headers=(("Last-Event-ID", "1"),))
            ids = [i for ev, i, _d in events if ev == "delta"]
            assert ids == list(range(2, hub.seq + 1))

    def test_flight_record_and_slo_carry_live_block(self, live_streamed):
        from tpudas_torch.obs.collect import live_entry, slo_status
        from tpudas_torch.obs.flight import read_flight
        from tpudas_torch.obs.phases import PHASES

        out, hub = live_streamed
        rounds = read_flight(out, kind="round")
        assert [sorted(r["live"]) for r in rounds] == [sorted(
            ("subscribers", "published", "dropped_frames", "degrades",
             "dropped_subscribers", "fanout_p99_s"))] * 3
        assert all(sorted(r["phases"]) == sorted(PHASES) for r in rounds)
        assert live_entry(rounds)["published"] == hub.published
        assert "live" in slo_status(out)

    def test_frames_carry_the_rounds_new_events(self, pool, tmp_path):
        """With detection on, each round's frame carries that round's new
        ledger events: the ring's events, in order, are the ledger."""
        from tpudas_torch.detect.ledger import load_events

        out = str(tmp_path / "det")
        with use_registry(MetricsRegistry()):
            assert _run(pool, str(tmp_path / "raw"), out, live=True,
                        detect=True, detect_operators=[
                            ("stalta", {"sta": 2.0, "lta": 10.0, "on": 1.1,
                                        "off": 1.05})]) == 3
        hub = find_hub(folder=out)
        events = [ev for f in hub._ring for ev in f.events]
        assert events and events == load_events(out)
        assert json.loads(json.dumps(events)) == events

    def test_fault_at_live_emit_keeps_outputs_byte_identical(
            self, pool, tmp_path):
        """Every live publish raising (the ``live.emit`` fault site)
        changes nothing durable: outputs, pyramid, carry and ledger are
        byte-identical to a live-off control."""
        def run(leg, live, plan=None):
            out = str(tmp_path / f"out_{leg}")
            with use_registry(MetricsRegistry()) as reg, \
                    install_fault_plan(plan or FaultPlan()):
                assert _run(pool, str(tmp_path / f"raw_{leg}"), out,
                            then=(5,), live=live, pyramid=True,
                            detect=True) == 2
            return out, reg

        plan = FaultPlan(FaultSpec("live.emit", action="raise", at=1,
                                   times=99, exc=RuntimeError))
        out_c, _ = run("control", live=False)
        out_f, reg = run("faulted", live=True, plan=plan)
        assert reg.value("tpudas_live_publish_errors_total") == 2
        assert _h5_digests(out_f) == _h5_digests(out_c)
        for sub in (".tiles", ".detect"):
            assert _tree_digests(out_f, sub) == _tree_digests(out_c, sub)

    def test_subscribers_never_change_outputs(self, pool, tmp_path):
        """Attached never-reading subscribers (ladder-dropped) leave the
        durable products byte-identical to the no-subscriber control."""
        def run(leg, live, attach=False):
            out = str(tmp_path / f"out_{leg}")
            subs = []

            def on_round(rnd, lfp):
                if attach and not subs:
                    subs.append(find_hub(folder=out).subscribe(depth=1))

            with use_registry(MetricsRegistry()):
                _run(pool, str(tmp_path / f"raw_{leg}"), out, live=live,
                     pyramid=True, on_round=on_round)
            return out, subs

        out_c, _ = run("nosub", live=False)
        out_l, subs = run("stalled", live=True, attach=True)
        assert _h5_digests(out_l) == _h5_digests(out_c)
        assert _tree_digests(out_l, ".tiles") == _tree_digests(out_c,
                                                                ".tiles")
        assert subs and (subs[0].dropped == "slow" or subs[0].degrades > 0)


class TestFleetRouting:
    def test_fleet_members_register_hubs(self, pool, tmp_path):
        """Each ``FleetEngine`` member registers its hub under its stream
        id; ``DASServer.for_fleet`` finds it at ``/s/<id>/live``."""
        from tpudas_torch.fleet import FleetEngine, StreamConfig, StreamSpec

        specs = []
        for sid in ("sA", "sB"):
            src = str(tmp_path / f"src_{sid}")
            _link(pool, src, 3)
            specs.append(StreamSpec(stream_id=sid, source=src,
                                    config=StreamConfig(kind="lowpass",
                                                        live=True,
                                                        **PARAMS)))
        root = str(tmp_path / "root")
        FleetEngine(root, specs, sleep_fn=lambda _s: None,
                    device="cpu").run()
        for sid in ("sA", "sB"):
            hub = find_hub(stream_id=sid)
            assert hub is not None and hub.key == sid and hub.seq == 1
            assert find_hub(folder=os.path.join(root, sid)) is hub
        with DASServer.for_fleet(root, port=0) as srv:
            events = _read_sse(srv.base_url + "/s/sB/live?window=0"
                               "&heartbeat=0.2&last_id=0", want_events=2)
            assert events[0][0] == "hello"
            assert events[0][2]["stream"] == "sB"
            assert events[1][0] == "delta" and events[1][1] == 1
            for path in ("/s/nope/live", "/live"):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(srv.base_url + path,
                                           timeout=TIMEOUT)
                assert ei.value.code == 404

    def test_no_producer_is_503(self, tmp_path):
        out = str(tmp_path / "results")
        os.makedirs(out)
        with DASServer(out, port=0) as srv:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.base_url + "/live",
                                       timeout=TIMEOUT)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After") == "5"

    def test_subscriber_cap_is_503(self, tmp_path):
        out = str(tmp_path / "capped")
        os.makedirs(out)
        register_hub(os.path.abspath(out), max_subscribers=0)
        with DASServer(out, port=0) as srv:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.base_url + "/live",
                                       timeout=TIMEOUT)
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After") == "1"


def _wait_for(pred, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


class TestBridge:
    def test_bridge_mirrors_frames_across_registries(self):
        hub = register_hub("bstream")
        bridge = tsse.LiveBridge().start()
        try:
            addr = bridge.address
            reset_hubs()  # the worker process's empty registry
            sub = tsse.BridgeSubscriber(addr, retry_s=0.1).start()
            try:
                assert _wait_for(lambda: bridge._conns), "no worker"
                _publish_n(hub, 3)
                assert _wait_for(lambda: (find_hub(stream_id="bstream")
                                          or hub).seq >= 3
                                 and find_hub(stream_id="bstream")
                                 is not None)
                mirror = find_hub(stream_id="bstream")
                a, b = mirror.latest_frame(), hub.latest_frame()
                assert mirror.seq == 3 and a.seq == b.seq
                np.testing.assert_array_equal(a.level_array(0),
                                              b.level_array(0))
                assert a.payload(0) == b.payload(0)
            finally:
                sub.stop()
        finally:
            bridge.stop()

    @pytest.mark.parametrize("producer", ["jax", "port"])
    def test_bridge_across_packages(self, producer):
        """The bridge's wire bytes are one format: a port subscriber
        mirrors a JAX producer's frames and a JAX subscriber a port
        producer's, payload bytes and rows equal."""
        pmod, psse, cmod, csse = (
            (jhub, jsse, thub, tsse) if producer == "jax"
            else (thub, tsse, jhub, jsse))
        hub = pmod.register_hub("xstream", "/x/folder")
        bridge = psse.LiveBridge().start()
        try:
            sub = csse.BridgeSubscriber(bridge.address, retry_s=0.1).start()
            try:
                assert _wait_for(lambda: bridge._conns), "no worker"
                for i in range(1, 4):
                    fr = pmod.LiveFrame(
                        i, i, *_round_rows(i), _events(i), 10**9)
                    with hub._lock:
                        hub.seq = fr.seq
                        hub._ring.append(fr)
                    hub._fanout(fr)
                assert _wait_for(
                    lambda: cmod.find_hub(stream_id="xstream") is not None
                    and cmod.find_hub(stream_id="xstream").seq >= 3)
                mirror = cmod.find_hub(folder="/x/folder")
                assert mirror is cmod.find_hub(stream_id="xstream")
                for a, b in zip(list(mirror._ring), list(hub._ring)):
                    assert (a.seq, a.round, a.step_ns, a.events,
                            a.published_unix_ns) == (
                        b.seq, b.round, b.step_ns, b.events,
                        b.published_unix_ns)
                    assert a.payload(0) == b.payload(0)
                    for lvl in range(3):
                        assert a.payload(lvl) == b.payload(lvl)
                        np.testing.assert_array_equal(a.level_times(lvl),
                                                      b.level_times(lvl))
            finally:
                sub.stop()
        finally:
            bridge.stop()

    def test_ensure_bridge_is_process_wide(self, monkeypatch):
        monkeypatch.setattr(tsse, "_BRIDGE", None)
        a = tsse.ensure_bridge("127.0.0.1:0")
        try:
            assert tsse.ensure_bridge() is a and a.port > 0
            assert tsse._parse_addr("9") == ("127.0.0.1", 9)
            assert tsse._parse_addr("h:7") == ("h", 7)
        finally:
            a.stop()


_KILL_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {repo!r})
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan

def _kill9(_seconds):
    os.kill(os.getpid(), signal.SIGKILL)

plan = FaultPlan(FaultSpec("live.emit", action="delay", at=1, seconds=0.0,
                           sleep_fn=_kill9))
with install_fault_plan(plan):
    run_lowpass_realtime(source={src!r}, output_folder={out!r},
                         sleep_fn=lambda _s: None, device="cpu", live=True,
                         pyramid=True, detect=True, **{params!r})
raise SystemExit("unreachable: the kill never fired")
"""


class TestKillAtLiveEmit:
    def test_sigkill_at_live_emit_then_resume_matches_control(
            self, pool, tmp_path):
        """SIGKILL the producer exactly at the first ``live.emit`` (after
        the round's commit, before its health write), resume, and the
        durable products equal a live-off control's byte for byte."""
        src, out = str(tmp_path / "raw"), str(tmp_path / "out_killed")
        _link(pool, src, 5)
        script = _KILL_CHILD.format(repo=REPO, src=src, out=out,
                                    params=PARAMS)
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == -9, proc.stderr[-2000:]
        assert _h5_digests(out)  # the round committed before the kill
        _run(pool, src, out, first=5, then=(), live=True, pyramid=True,
             detect=True)
        out_c = str(tmp_path / "out_control")
        _run(pool, str(tmp_path / "raw_control"), out_c, first=5, then=(),
             live=False, pyramid=True, detect=True)
        assert _h5_digests(out) == _h5_digests(out_c)
        for sub in (".tiles", ".detect"):
            assert _tree_digests(out, sub) == _tree_digests(out_c, sub)
