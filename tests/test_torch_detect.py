"""The port's detection (tpudas_torch.detect) against the JAX package's.

The same seeded numpy rows go through the JAX operators (``lax.scan``
on the CPU) and the port's (a loop over rows of plain torch ops,
``device="cpu"``); the same small spool (4 ch, 50 Hz, 20 s files, as in
``tests/test_detect.py``) goes through both ``run_lowpass_realtime``s
with ``detect=True``.  Bounds, each stated where it is asserted:

- STA/LTA ratios and RMS rows within 1e-6 of JAX's, relative to the
  largest |value| (XLA may contract ``sta + a * (x - sta)`` into one
  fused multiply-add, eager torch rounds the product and the sum);
- events equal as ``(op, kind, channel, t_ns, t_peak_ns, t_end_ns)``,
  scores within 1e-6 relative — and no JAX ratio lies within 1e-5 of
  ``on``/``off``, so the equality is not luck;
- within the port, byte identity: across chunkings, across kill/resume
  at every detect-relevant fault site, against an uninterrupted control.
"""

import hashlib
import json
import os
import shutil

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.core.timeutils import to_datetime64
from tpudas.detect import ledger as jledger
from tpudas.detect import operators as jops
from tpudas.io.registry import write_patch
from tpudas.obs import registry as jreg
from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.resilience.faults import RetryPolicy as JaxRetryPolicy
from tpudas.testing import make_synthetic_spool, synthetic_patch
from tpudas_torch.detect import ledger as tledger
from tpudas_torch.detect import operators as tops
from tpudas_torch.detect import runner as trunner
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    RetryPolicy,
    install_fault_plan,
)

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
NCH = 4
STEP_NS = 1_000_000_000
REL = 1e-6  # port vs JAX, relative to the largest |value|
MARGIN = 1e-5  # no JAX ratio this close (relative) to a threshold

# the JAX tests' thresholds: the noisy synthetic stream yields events
OPS = [
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5, "baseline": 20.0}),
]
FAST = dict(base_delay=0.0, max_delay=0.0, jitter=0.0)


def _make(spec):
    return tops.make_operator(spec, device="cpu")


def _rows(T=500, C=3, seed=0):
    rng = np.random.default_rng(seed)
    rows = (0.1 * rng.standard_normal((T, C))).astype(np.float32)
    rows[250:280, 1] += 5.0  # a burst
    rows[120:135, 2] += 2.0
    return rows, np.arange(T, dtype=np.int64) * STEP_NS


def _ev_key(ev):
    return (ev["op"], ev["kind"], ev["channel"], ev["t_ns"],
            ev["t_peak_ns"], ev["t_end_ns"])


def _feed(op, rows, t_ns, cuts):
    """Run ``op`` over ``rows`` split at ``cuts``: (events, scores,
    score times, final state)."""
    st = op.init_state(rows.shape[1], STEP_NS)
    evs, scores, times = [], [], []
    for lo, hi in zip([0] + cuts, cuts + [rows.shape[0]]):
        res, st = op.process(rows[lo:hi], t_ns[lo:hi], STEP_NS, st)
        evs.extend(res.events)
        if res.scores is not None and res.scores.size:
            scores.append(res.scores)
            times.append(res.score_t_ns)
    sc = np.concatenate(scores) if scores else None
    tt = np.concatenate(times) if times else None
    return sorted(evs, key=_ev_key), sc, tt, st


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(b)))


CHUNKINGS = {"whole": [], "halves": [250], "ragged": [1, 7, 64, 65, 251,
                                                      252, 400, 499]}


# ---------------------------------------------------------------------------
# operators


class TestOperators:
    def test_registry(self):
        assert tops.operator_names() == jops.operator_names()
        op = tops.make_operator({"name": "stalta", "on": 5.0}, device="cpu")
        assert op.on == 5.0 and op.device == torch.device("cpu")
        assert tops.make_operator(op) is op
        with pytest.raises(ValueError, match="unknown detect operator"):
            tops.make_operator("nope", device="cpu")
        for spec in OPS:
            assert _make(spec).params() == jops.make_operator(spec).params()

    @pytest.mark.parametrize("spec", [
        ("stalta", {"sta": 5.0, "lta": 1.0}),
        ("stalta", {"on": 2.0, "off": 3.0}),
        ("rms", {"window": 0.0}),
        ("rms", {"baseline": 0.0}),
    ])
    def test_param_validation(self, spec):
        with pytest.raises(ValueError) as port_err:
            _make(spec)
        with pytest.raises(ValueError) as jax_err:
            jops.make_operator(spec)
        assert str(port_err.value) == str(jax_err.value)

    def test_no_card_and_no_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.make_operator(OPS[0])

    def test_two_score_operators_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="score-producing"):
            trunner.DetectPipeline.open(str(tmp_path), operators=[
                ("rms", {"window": 5.0, "step": 2.0}),
                ("rms", {"window": 30.0, "step": 2.0}),
            ], device="cpu")

    def test_stalta_ratios_match_jax(self):
        """The port's recurrence against the JAX scan, row by row."""
        rows, _ = _rows()
        op = _make(OPS[0])
        a_s, a_l, warm_rows = op._alphas(STEP_NS)
        x = torch.from_numpy(rows)
        st = op.init_state(rows.shape[1], STEP_NS)
        got = tops._stalta_scan(
            x * x, torch.from_numpy(st["sta"]), torch.from_numpy(st["lta"]),
            torch.from_numpy(st["in_event"]), 0, op._f32(a_s),
            op._f32(a_l), op._f32(op.on), op._f32(op.off), warm_rows)
        want = jops._get_stalta_scan()(
            rows * rows, st["sta"], st["lta"], st["in_event"], np.int32(0),
            a_s, a_l, np.float32(op.on), np.float32(op.off),
            np.int32(warm_rows))
        assert _rel(got[4].numpy(), np.asarray(want[4])) <= REL
        assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
        assert got[3] == int(want[3])

    @pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
    @pytest.mark.parametrize("spec", OPS, ids=["stalta", "rms"])
    def test_matches_jax_over_chunkings(self, spec, chunking):
        """Events equal JAX's, scores/ratios within REL, the same state
        keys and dtypes, the state within REL."""
        rows, t_ns = _rows()
        cuts = CHUNKINGS[chunking]
        ev_p, sc_p, tt_p, st_p = _feed(_make(spec), rows, t_ns, cuts)
        ev_j, sc_j, tt_j, st_j = _feed(jops.make_operator(spec), rows,
                                       t_ns, cuts)
        assert ev_p, "the burst must produce events"
        assert [_ev_key(e) for e in ev_p] == [_ev_key(e) for e in ev_j]
        for a, b in zip(ev_p, ev_j):
            assert abs(a["score"] - b["score"]) <= REL * abs(b["score"])
        if spec[0] == "stalta":
            # the events' equality is not luck: every JAX ratio keeps
            # MARGIN from both thresholds
            op = jops.make_operator(spec)
            a_s, a_l, warm_rows = op._alphas(STEP_NS)
            st0 = op.init_state(rows.shape[1], STEP_NS)
            ratios = np.asarray(jops._get_stalta_scan()(
                rows * rows, st0["sta"], st0["lta"], st0["in_event"],
                np.int32(0), a_s, a_l, np.float32(op.on),
                np.float32(op.off), warm_rows)[4])
            for thr in (op.on, op.off):
                assert np.abs(ratios - thr).min() > MARGIN * thr
        else:
            assert np.array_equal(tt_p, tt_j)
            assert _rel(sc_p, sc_j) <= REL
            ratios = [e["score"] for e in ev_j]
            assert min(abs(r - spec[1]["thresh"]) for r in ratios) > (
                MARGIN * spec[1]["thresh"])
        assert list(st_p) == list(st_j)
        for key in st_p:
            a, b = np.asarray(st_p[key]), np.asarray(st_j[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if a.dtype.kind == "f" and a.size:
                assert _rel(a, b) <= REL, key
            else:
                assert np.array_equal(a, b), key

    @pytest.mark.parametrize("spec", OPS, ids=["stalta", "rms"])
    def test_byte_identical_across_chunkings(self, spec):
        """Contract rule 1 within the port: every chunking gives the
        same events, scores and state, byte for byte."""
        rows, t_ns = _rows()
        ref = _feed(_make(spec), rows, t_ns, [])
        rng = np.random.default_rng(3)
        for cuts in list(CHUNKINGS.values())[1:] + [sorted(
                rng.choice(np.arange(1, 500), 9, replace=False).tolist())]:
            got = _feed(_make(spec), rows, t_ns, cuts)
            assert got[0] == ref[0]
            if ref[1] is not None:
                assert got[1].tobytes() == ref[1].tobytes()
                assert np.array_equal(got[2], ref[2])
            for key in ref[3]:
                a, b = np.asarray(got[3][key]), np.asarray(ref[3][key])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key

    def test_stalta_carries_open_events(self):
        rng = np.random.default_rng(1)
        rows = (0.05 * rng.standard_normal((400, 2))).astype(np.float32)
        rows[200:230, 0] += 3.0
        t_ns = np.arange(400, dtype=np.int64) * STEP_NS
        op = _make(OPS[0])
        st = op.init_state(2, STEP_NS)
        r1, st = op.process(rows[:210], t_ns[:210], STEP_NS, st)
        assert bool(st["in_event"][0])
        r2, st = op.process(rows[210:], t_ns[210:], STEP_NS, st)
        trig = [e for e in r1.events + r2.events
                if e["channel"] == 0 and e["t_ns"] >= 195 * STEP_NS]
        assert trig and trig[0]["score"] >= op.on
        assert trig[0]["t_end_ns"] > trig[0]["t_peak_ns"] >= trig[0]["t_ns"]
        closed = ~np.asarray(st["in_event"], bool)
        assert not st["peak"][closed].any() and not st["t_on"][closed].any()

    def test_rms_scores_on_global_grid(self):
        op = _make(OPS[1])  # w=5 rows, s=2 rows at 1 Hz
        rows = np.ones((20, 2), np.float32)
        t_ns = np.arange(20, dtype=np.int64) * STEP_NS
        res, _ = op.process(rows, t_ns, STEP_NS, op.init_state(2, STEP_NS))
        assert list(res.score_t_ns) == [p * STEP_NS for p in range(4, 20, 2)]
        assert np.array_equal(res.scores, np.ones((8, 2), np.float32))

    @pytest.mark.parametrize("spec", OPS, ids=["stalta", "rms"])
    def test_nan_rows_are_inert(self, spec):
        """NaN rows freeze the recurrences (finite state, no event
        there) in the port as in the JAX package."""
        rows, t_ns = _rows(T=100)
        rows[40:50] = np.nan
        ev_p, _, _, st_p = _feed(_make(spec), rows, t_ns, [45])
        ev_j, _, _, st_j = _feed(jops.make_operator(spec), rows, t_ns, [45])
        assert [_ev_key(e) for e in ev_p] == [_ev_key(e) for e in ev_j]
        assert all(np.isfinite(e["score"]) for e in ev_p)
        assert not [e for e in ev_p
                    if 40 * STEP_NS <= e["t_ns"] < 50 * STEP_NS]
        for key, val in st_p.items():
            if val.dtype.kind == "f" and key != "ring":
                assert np.isfinite(val).all(), key

    @pytest.mark.parametrize("spec", OPS, ids=["stalta", "rms"])
    def test_state_owns_caller_memory(self, spec):
        """ROADMAP C5: chunk 1 comes from an emitted patch whose data is
        a CPU tensor (``_patch_rows``, as the pipeline reads it); after
        ``process`` returns, the caller overwrites its rows buffer and
        the patch's tensor in place, then chunk 2 follows.  Events,
        scores and the saved state must equal an untouched run's byte
        for byte, and the JAX operator's within REL."""
        from tpudas_torch.core.patch import Patch

        rows, t_ns = _rows()
        cut = 250
        ref = _feed(_make(spec), rows.copy(), t_ns, [cut])
        ev_j, sc_j, _, st_j = _feed(jops.make_operator(spec), rows, t_ns,
                                    [cut])
        op = _make(spec)
        st = op.init_state(rows.shape[1], STEP_NS)
        evs, scores = [], []
        for lo, hi in ((0, cut), (cut, rows.shape[0])):
            data = torch.from_numpy(rows[lo:hi].copy())
            patch = Patch(
                data=data,
                coords={"time": t_ns[lo:hi].astype("datetime64[ns]"),
                        "distance": np.arange(rows.shape[1], dtype=float)},
                dims=("time", "distance"))
            t, r = trunner._patch_rows(patch)
            res, st = op.process(r, t, STEP_NS, st)
            saved = {k: np.array(v, copy=True) for k, v in st.items()}
            r[:] = 1e3  # the caller reuses its rows buffer
            data.fill_(-1e3)  # and the emitted patch's tensor
            for k, v in st.items():
                assert np.asarray(v).tobytes() == saved[k].tobytes(), k
            evs.extend(res.events)
            if res.scores is not None and res.scores.size:
                scores.append(res.scores)
        assert sorted(evs, key=_ev_key) == ref[0]
        if ref[1] is not None:
            assert np.concatenate(scores).tobytes() == ref[1].tobytes()
            assert _rel(np.concatenate(scores), sc_j) <= REL
        assert [_ev_key(e) for e in ref[0]] == [_ev_key(e) for e in ev_j]
        for key in ref[3]:
            a, b = np.asarray(st[key]), np.asarray(ref[3][key])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
            c = np.asarray(st_j[key])
            if a.dtype.kind == "f" and a.size:
                assert _rel(a, c) <= REL, key
            else:
                assert np.array_equal(a, c), key


    def test_rms_sqrt_skips_torch_sqrt_on_cpu(self, monkeypatch):
        """ROADMAP C5: on the CPU ``torch.sqrt`` runs MKL's vector math
        over the OpenMP threads, and its first call in about one fresh
        process in a hundred leaves a chunk ~3e-4 off (a resumed worker's
        RMS scores then differed from the control's).  The CPU operator
        takes numpy's correctly rounded sqrt instead: it never calls
        ``torch.sqrt`` on a CPU tensor, and its scores are the exact
        square roots of its float32 window means."""
        from tpudas_torch.ops.rolling import exact_sqrt, rolling_reduce

        real = torch.sqrt

        def no_cpu_sqrt(t, *a, **k):
            assert t.device.type != "cpu", "torch.sqrt on a CPU tensor"
            return real(t, *a, **k)

        rows, t_ns = _rows()
        want = _feed(_make(OPS[1]), rows, t_ns, [250])
        monkeypatch.setattr(torch, "sqrt", no_cpu_sqrt)
        got = _feed(_make(OPS[1]), rows, t_ns, [250])
        assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
        x = torch.from_numpy(rows)
        mean = rolling_reduce(x * x, 5, 1, "mean").numpy()
        full = np.sqrt(mean)
        pos = (got[2] // STEP_NS).astype(np.int64)
        assert got[1].tobytes() == np.ascontiguousarray(full[pos]).tobytes()
        t = torch.from_numpy(np.array([0.0, 2.0, np.nan, 1e-30], np.float32))
        assert exact_sqrt(t).numpy().tobytes() == np.sqrt(t.numpy()).tobytes()


# ---------------------------------------------------------------------------
# durable artifacts, read across packages

PKG_LEDGER = {"port": tledger, "jax": jledger}
EV = {"op": "stalta", "kind": "trigger", "channel": 1, "t_ns": 10,
      "t_peak_ns": 11, "t_end_ns": 12, "score": 3.5, "seq": 0}


class TestLedger:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_roundtrip_reads_in_both(self, tmp_path, writer):
        evs = [dict(EV), {**EV, "seq": 1, "channel": 2}]
        PKG_LEDGER[writer].write_events(str(tmp_path), evs)
        for mod in PKG_LEDGER.values():
            assert mod.load_events(str(tmp_path)) == evs
        raw = (tmp_path / ".detect" / "events.jsonl").read_text()
        assert raw.count('"_crc32"') == 2

    def test_same_bytes_in_both(self, tmp_path):
        evs = [dict(EV), {**EV, "seq": 1, "channel": 2, "score": 1 / 3}]
        for name, mod in PKG_LEDGER.items():
            mod.write_events(str(tmp_path / name), evs)
        assert ((tmp_path / "port" / ".detect" / "events.jsonl").read_bytes()
                == (tmp_path / "jax" / ".detect" / "events.jsonl")
                .read_bytes())

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_torn_line_falls_back_to_prev(self, tmp_path, writer):
        mod = PKG_LEDGER[writer]
        mod.write_events(str(tmp_path), [dict(EV)])
        mod.write_events(str(tmp_path), [dict(EV), {**EV, "seq": 1}])
        with open(tmp_path / ".detect" / "events.jsonl", "a") as fh:
            fh.write('{"torn": tru')
        reg = MetricsRegistry()
        with use_registry(reg):
            assert tledger.load_events(str(tmp_path)) == [dict(EV)]
        assert reg.value("tpudas_integrity_fallback_total",
                         artifact="events") == 1
        assert jledger.load_events(str(tmp_path)) == [dict(EV)]

    def test_write_event_lines_matches_write_events(self, tmp_path):
        evs = [dict(EV), {**EV, "seq": 1, "channel": 2}]
        tledger.write_events(str(tmp_path / "a"), evs)
        tledger.write_event_lines(str(tmp_path / "b"),
                                  [tledger.event_line(e) for e in evs])
        pa = tmp_path / "a" / ".detect" / "events.jsonl"
        pb = tmp_path / "b" / ".detect" / "events.jsonl"
        assert pa.read_bytes() == pb.read_bytes()

    def test_status_classification(self):
        good = tledger.event_line(EV)
        for text, want in [
            (good + "\n", "ok"), ("", "ok"),
            (json.dumps(EV) + "\n", "unstamped"), ("not json\n", "torn"),
            (good.replace('"channel":1', '"channel":3') + "\n", "torn"),
            (tledger.event_line({**EV, "seq": 5}) + "\n", "torn"),
        ]:
            assert tledger.ledger_status_text(text)[0] == want
            assert jledger.ledger_status_text(text)[0] == want


PKG_STORE = {"port": tledger.ScoreStore, "jax": jledger.ScoreStore}


def _store_rows(n=10):
    t = np.arange(n, dtype=np.int64) * 2_000 + 1000
    return t, np.arange(2 * n, dtype=np.float64).reshape(n, 2)


class TestScoreStore:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_append_read_across_tiles_in_both(self, tmp_path, writer):
        store = PKG_STORE[writer].create(str(tmp_path), epoch_ns=1000,
                                         n_ch=2, tile_len=4)
        t, v = _store_rows()
        store.append(t[:3], v[:3])
        store.append(t[3:], v[3:])
        names = sorted(os.listdir(tledger.ScoreStore.scores_dir(
            str(tmp_path))))
        assert "00000000.npy" in names and "00000001.npy" in names
        for cls in PKG_STORE.values():
            re_t, re_v = cls.open(str(tmp_path)).read()
            assert np.array_equal(re_t, t) and np.array_equal(re_v, v)
            re_t, _ = cls.open(str(tmp_path)).read(t[4], t[8])
            assert np.array_equal(re_t, t[4:8])

    def test_same_files_in_both(self, tmp_path):
        t, v = _store_rows()
        for name, cls in PKG_STORE.items():
            store = cls.create(str(tmp_path / name), epoch_ns=1000, n_ch=2,
                               tile_len=4)
            store.append(t[:3], v[:3])
            store.append(t[3:], v[3:])
        d = {n: tledger.ScoreStore.scores_dir(str(tmp_path / n))
             for n in PKG_STORE}
        assert sorted(os.listdir(d["port"])) == sorted(os.listdir(d["jax"]))
        for name in os.listdir(d["port"]):
            with open(os.path.join(d["port"], name), "rb") as a, open(
                    os.path.join(d["jax"], name), "rb") as b:
                assert a.read() == b.read(), name

    def test_truncate_into_completed_tile(self, tmp_path):
        store = tledger.ScoreStore.create(str(tmp_path), epoch_ns=1000,
                                          n_ch=2, tile_len=4)
        t, v = _store_rows()
        store.append(t, v)
        store.truncate_to(6)  # into tile 1
        for cls in PKG_STORE.values():
            re_t, _ = cls.open(str(tmp_path)).read()
            assert np.array_equal(re_t, t[:6])
        with pytest.raises(tledger.CorruptDetectError):
            store.truncate_to(99)

    def test_crash_before_manifest_recovers_from_head_tile(self, tmp_path):
        store = tledger.ScoreStore.create(str(tmp_path), epoch_ns=1000,
                                          n_ch=2, tile_len=4)
        t, v = _store_rows()
        store.append(t[:3], v[:3])
        manifest_before = open(store.manifest_path).read()
        store.append(t[3:], v[3:])
        with open(store.manifest_path, "w") as fh:
            fh.write(manifest_before)  # the crash: manifest is stale
        for cls in PKG_STORE.values():
            re = cls.open(str(tmp_path))
            assert re.n_rows == 3
            re_t, re_v = re.read()
            assert np.array_equal(re_t, t[:3]) and np.array_equal(re_v, v[:3])


# ---------------------------------------------------------------------------
# the driver


def _spool(src, n_files=2):
    make_synthetic_spool(src, n_files=n_files, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)


def _append_one(src, index):
    t0 = to_datetime64(T0).astype("datetime64[ns]")
    step = np.timedelta64(int(round(1e9 / FS)), "ns")
    n = int(FILE_SEC * FS)
    p = synthetic_patch(t0=t0 + index * n * step, duration=FILE_SEC, fs=FS,
                        n_ch=NCH, seed=index, phase_origin=t0, noise=0.01)
    write_patch(p, os.path.join(src, f"raw_{index:04d}.h5"))


def _drive(src, out, feed_third=False, pkg="port", **kw):
    """One driver call; with ``feed_third`` the first poll's sleep adds
    the third file (a second round)."""
    def sleep(_):
        if feed_third and not os.path.isfile(
                os.path.join(src, "raw_0002.h5")):
            _append_one(src, 2)

    kw.setdefault("detect", True)
    kw.setdefault("detect_operators", OPS)
    if pkg == "port":
        driver, policy = run_lowpass_realtime, RetryPolicy(**FAST)
        kw.setdefault("device", "cpu")
    else:
        driver, policy = jax_realtime, JaxRetryPolicy(**FAST)
        kw.setdefault("flight", False)
        kw.setdefault("pyramid", False)
    return driver(source=src, output_folder=out, start_time=T0,
                  output_sample_interval=1.0, edge_buffer=5.0,
                  process_patch_size=20, poll_interval=0.0, sleep_fn=sleep,
                  fault_policy=policy, **kw)


def _detect_sig(out):
    """(ledger bytes sha, carry content sha, scores content sha): the
    crash-equivalence key of ``tests/test_detect.py`` (the carry by
    parsed content; the npz container embeds zip timestamps)."""
    with open(os.path.join(out, ".detect", "events.jsonl"), "rb") as fh:
        ledger = hashlib.sha256(fh.read()).hexdigest()
    carry = trunner.load_detect_carry(out)
    assert carry is not None
    h = hashlib.sha256()
    h.update(json.dumps(carry["meta"], sort_keys=True).encode())
    for st in carry["states"]:
        for key in sorted(st):
            arr = np.asarray(st[key])
            h.update(key.encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    t, v = tledger.ScoreStore.open(out).read()
    return ledger, h.hexdigest(), hashlib.sha256(
        t.tobytes() + v.tobytes()).hexdigest()


def _assert_same_detection(out_a, out_b):
    """Events equal (scores within REL), score rows within REL, the same
    carry meta — between any two folders, of either package."""
    ev_a, ev_b = tledger.load_events(out_a), tledger.load_events(out_b)
    assert ev_a, "the tuned thresholds must produce events"
    assert [(_ev_key(e), e["seq"]) for e in ev_a] == [
        (_ev_key(e), e["seq"]) for e in ev_b]
    for a, b in zip(ev_a, ev_b):
        assert abs(a["score"] - b["score"]) <= REL * abs(b["score"])
    ta, va = tledger.ScoreStore.open(out_a).read()
    tb, vb = tledger.ScoreStore.open(out_b).read()
    assert np.array_equal(ta, tb) and ta.size
    assert _rel(va, vb) <= REL
    ca = trunner.load_detect_carry(out_a)["meta"]
    cb = trunner.load_detect_carry(out_b)["meta"]
    assert ca == cb


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """An uninterrupted port run: 2 files, then the third (2 rounds)."""
    td = tmp_path_factory.mktemp("detect-control")
    src, out = str(td / "src"), str(td / "out")
    _spool(src)
    assert _drive(src, out, feed_third=True) == 2
    assert tledger.load_events(out)
    return out


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    td = tmp_path_factory.mktemp("detect-jax-control")
    src, out = str(td / "src"), str(td / "out")
    _spool(src)
    assert _drive(src, out, feed_third=True, pkg="jax") == 2
    return out


class TestDriver:
    def test_matches_jax_driver(self, control, jax_control):
        _assert_same_detection(control, jax_control)

    def test_metrics_like_jax(self, tmp_path):
        names = ("tpudas_detect_rounds_total", "tpudas_detect_errors_total",
                 "tpudas_detect_carry_saves_total",
                 "tpudas_detect_ledger_events")
        got = {}
        for pkg, mod in (("port", None), ("jax", jreg)):
            src, out = str(tmp_path / f"src-{pkg}"), str(tmp_path / pkg)
            _spool(src)
            reg = (MetricsRegistry() if mod is None
                   else mod.MetricsRegistry())
            scope = use_registry if mod is None else mod.use_registry
            with scope(reg):
                _drive(src, out, feed_third=True, pkg=pkg)
            got[pkg] = [reg.value(n) for n in names]
        assert got["port"] == got["jax"]
        assert got["port"][0] == 2 and got["port"][1] == 0

    def test_matches_jax_with_health_pyramid_and_flight(self, tmp_path,
                                                        monkeypatch):
        """Both drivers with detection, the pyramid, health on and the
        flight ring at its default: the detection and the stream agree
        as without them, the pyramid is the sync over the outputs, and
        both folders hold the same artifact names, health keys and
        round records (wall-clock fields aside)."""
        from test_torch_realtime import (
            _assert_obs_artifacts,
            _assert_pyramid_of_outputs,
            _assert_same_stream,
        )
        from tpudas_torch.obs.health import read_health

        monkeypatch.setenv("TPUDAS_DEVPROF", "0")
        monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "4")
        monkeypatch.delenv("TPUDAS_FLIGHT", raising=False)
        outs = {}
        for pkg, registry in (("port", None), ("jax", jreg)):
            src, outs[pkg] = str(tmp_path / f"src-{pkg}"), str(
                tmp_path / pkg)
            _spool(src)
            reg = (MetricsRegistry() if registry is None
                   else registry.MetricsRegistry())
            scope = use_registry if registry is None else (
                registry.use_registry)
            with scope(reg):
                assert _drive(src, outs[pkg], feed_third=True, pkg=pkg,
                              health=True, pyramid=True, flight=None) == 2
        _assert_same_detection(outs["port"], outs["jax"])
        _assert_same_stream(outs["port"], outs["jax"])
        _assert_pyramid_of_outputs(outs["port"], str(tmp_path))
        for keyword in ("health", "flight"):
            _assert_obs_artifacts(outs["port"], outs["jax"], keyword)
        assert read_health(outs["port"])["detect"] == read_health(
            outs["jax"])["detect"]

    def test_detect_off_leaves_no_artifacts(self, tmp_path):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        _drive(src, out, detect=False)
        assert not os.path.isdir(os.path.join(out, ".detect"))

    def test_enabling_later_catches_up_from_files(self, tmp_path, control):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        _drive(src, out, detect=False, feed_third=True)
        reg = MetricsRegistry()
        with use_registry(reg):
            _drive(src, out, feed_third=True)
        assert reg.value("tpudas_detect_catchup_rows_total") > 0
        assert _detect_sig(out) == _detect_sig(control)

    def test_operator_config_change_resets_and_recomputes(self, tmp_path,
                                                         control):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        _drive(src, out, feed_third=True)
        reg = MetricsRegistry()
        with use_registry(reg):
            _drive(src, out, detect_operators=[OPS[0]])
        assert reg.value("tpudas_detect_resets_total") == 1
        evs = tledger.load_events(out)
        assert evs and all(e["op"] == "stalta" for e in evs)
        _drive(src, out)  # back to both operators: recomputed exactly
        assert _detect_sig(out) == _detect_sig(control)

    def test_grid_step_change_resets(self, tmp_path, control):
        out = str(tmp_path / "out")
        shutil.copytree(control, out)
        reg0 = MetricsRegistry()
        with use_registry(reg0):
            trunner.DetectPipeline.open(out, operators=OPS, step_sec=1.0,
                                        device="cpu")
        assert reg0.value("tpudas_detect_carry_resumes_total") == 1
        assert reg0.value("tpudas_detect_resets_total") == 0
        reg = MetricsRegistry()
        with use_registry(reg):
            trunner.DetectPipeline.open(out, operators=OPS, step_sec=2.0,
                                        device="cpu")
        assert reg.value("tpudas_detect_resets_total") == 1

    def test_channel_count_change_resets(self, tmp_path, control):
        out = str(tmp_path / "out")
        shutil.copytree(control, out)
        upto = int(trunner.load_detect_carry(out)["meta"]["upto_ns"])
        from tpudas_torch.testing import synthetic_patch as tpatch

        alien = tpatch(t0=np.datetime64(upto + STEP_NS, "ns"),
                       duration=10.0, fs=1.0, n_ch=NCH + 2, seed=7,
                       noise=0.01)
        state = {}
        reg = MetricsRegistry()
        with use_registry(reg):
            trunner.run_detect_round(out, 1, [alien], state, operators=OPS,
                                     step_sec=1.0, device="cpu")
        assert reg.value("tpudas_detect_resets_total") == 1
        assert reg.value("tpudas_detect_errors_total") == 0
        assert state["summary"]["ok"] is True
        assert _detect_sig(out) == _detect_sig(control)

    @pytest.mark.parametrize("first,second", [("port", "jax"),
                                              ("jax", "port")])
    def test_resume_across_packages(self, tmp_path, control, first, second):
        """A detect carry and ledger written by one package, resumed by
        the other: the uninterrupted run's detection."""
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        assert _drive(src, out, pkg=first) == 1
        _append_one(src, 2)
        assert _drive(src, out, pkg=second) == 1
        _assert_same_detection(out, control)


# ---------------------------------------------------------------------------
# crash equivalence within the port


class TestCrashResumeEquivalence:
    """Kill the port's driver at each detect-relevant site, resume: the
    ledger bytes, the carry content and the score rows equal the
    uninterrupted control."""

    SPECS = {
        "detect.op": dict(site="detect.op", at=1),
        "detect.ledger_write": dict(site="detect.ledger_write", at=1),
        "carry.save": dict(site="carry.save", at=2),
        "round.body": dict(site="round.body", at=2),
        "fs.write_enospc": dict(site="fs.write_enospc", at=4),
        # the first atomic write of the detect commit itself
        "fs.write_enospc@detect": dict(site="fs.write_enospc", at=1,
                                       times=10**6, match=".detect"),
    }

    @pytest.mark.parametrize("site", sorted(SPECS))
    def test_kill_resume_identical(self, tmp_path, control, site):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        plan = FaultPlan(FaultSpec(**self.SPECS[site],
                                   exc=KeyboardInterrupt))
        with install_fault_plan(plan):
            with pytest.raises(KeyboardInterrupt):
                _drive(src, out, feed_third=True)
        assert plan.fired, f"fault at {site} never fired"
        assert _drive(src, out, feed_third=True) >= 1
        assert _detect_sig(out) == _detect_sig(control)

    def test_operator_failure_skipped_then_converges(self, tmp_path,
                                                     control):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        plan = FaultPlan(FaultSpec("detect.op", at=1, exc=RuntimeError))
        reg = MetricsRegistry()
        with use_registry(reg), install_fault_plan(plan):
            assert _drive(src, out, feed_third=True) == 2
        assert plan.fired
        assert reg.value("tpudas_detect_errors_total") == 1
        assert reg.value("tpudas_detect_op_errors_total", op="stalta") == 1
        assert _detect_sig(out) == _detect_sig(control)

    def test_full_reset_recomputes_identically(self, tmp_path, control):
        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        _drive(src, out, feed_third=True)
        shutil.rmtree(os.path.join(out, ".detect"))
        _drive(src, out, feed_third=True)
        assert _detect_sig(out) == _detect_sig(control)

    def test_detect_enospc_flips_pressure_then_catches_up(
            self, tmp_path, control):
        """An ENOSPC at every detect write (the stream's own writes
        succeed) is swallowed each round and flips the pressure flag;
        each round-end probe write clears it, and once the disk frees,
        the next call's catch-up reaches the control's state."""
        import errno

        src, out = str(tmp_path / "src"), str(tmp_path / "out")
        _spool(src)
        plan = FaultPlan(FaultSpec(
            "fs.write_enospc", at=1, times=10**6, match=".detect",
            exc=OSError(errno.ENOSPC, "No space left on device")))
        reg = MetricsRegistry()
        with use_registry(reg), install_fault_plan(plan):
            assert _drive(src, out, feed_third=True) == 2
        assert len(plan.fired) == 2
        assert reg.value("tpudas_detect_errors_total") == 2
        assert reg.value("tpudas_integrity_resource_events_total") == 2
        from tpudas_torch.integrity import resource

        assert not resource.is_degraded()
        _drive(src, out)  # no new data: the catch-up finishes the state
        assert _detect_sig(out) == _detect_sig(control)
