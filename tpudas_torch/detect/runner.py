"""The per-round detect hook: feed operators, commit the artifacts.

The port's counterpart of :mod:`tpudas.detect.runner`, with the same
``.detect/`` layout and carry format, so a detect carry and ledger
written by either package resume under the other.  One
:class:`DetectPipeline` owns, for one output folder, the configured
operators (:mod:`tpudas_torch.detect.operators`, computing on the
pipeline's ``device``), their carried states, the events ledger, and
the score tile store (:mod:`tpudas_torch.detect.ledger`).  The
realtime drivers call :func:`run_detect_round` after each round's
output writes; everything in
here is **read-side with respect to the stream**: a failure is
counted, logged, and swallowed — the in-memory pipeline is dropped to
``None`` (the carry's crash-equivalent discipline) and the next round
re-resolves from disk.  An operator failure therefore aborts the
round's detect COMMIT entirely (no partial ledger/carry advance) and
the next round replays the same rows via catch-up — skip == retry ==
restart, byte-identically.

Commit protocol per round (the crash-only core):

1. score tiles / tails / scores manifest (derived track);
2. the events ledger rewrite (``detect.ledger_write`` fault site);
3. the detect carry ``.detect/carry.npz`` LAST — one crc-stamped
   ``.npz`` (meta JSON embedded, ``.prev`` double buffer) holding
   every operator's state plus ``upto_ns`` (newest row fed),
   ``ledger_seq`` (committed ledger lines) and ``score_rows``.

Because the carry commits last it is never AHEAD of the artifacts; on
resume :meth:`DetectPipeline.open` truncates the ledger and score
store back to the carry (``tpudas_detect_reconcile_truncated_total``)
— the truncated surplus is a crashed commit's output, regenerated
identically when the rows replay.  Anything the ladder cannot
reconcile (both ledger rungs bad, score rows lost, operator config
changed) triggers the repair of last resort: remove ``.detect/`` and
recompute the WHOLE history deterministically from the output files
(``tpudas_detect_resets_total``) — detection results are derived data,
the outputs remain the source of truth.

Row sourcing: the steady-state fast path consumes the round's emitted
output patches captured in memory at their write site (the
multi-subscriber ``LFProc`` emit hook) — no re-read of files this
process just wrote.  A fresh pipeline, or any discontinuity between
the carry head and the captured rows, falls back to reading the gap
from the output files through the directory spool (any format the
spool reads, tdas included, so the catch-up works on a host without
h5py); operators are chunk-invariant by contract, so both paths
produce bit-identical events, scores, and carries.  Rows are fed in
the JAX package's bounded power-of-two blocks, so both packages split
a round the same way.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from tpudas_torch.detect.ledger import (
    CorruptDetectError,
    ScoreStore,
    detect_dir,
    event_line,
    load_events,
    write_event_lines,
    write_events,
)
from tpudas_torch.detect.operators import make_operator
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.logging import log_event

__all__ = [
    "DETECT_CARRY_FILENAME",
    "DEFAULT_OPERATORS",
    "DetectPipeline",
    "load_detect_carry",
    "mark_detect_shed",
    "reset_detect",
    "run_detect_round",
    "save_detect_carry",
]

DETECT_CARRY_FILENAME = "carry.npz"
_CARRY_VERSION = 1

# the round's feed block cap (rows): power-of-two decomposed below it
# (the JAX package's split, which bounds its compiled shapes; the port
# keeps it so both packages feed the operators the same blocks)
_FEED_CAP = 256

DEFAULT_OPERATORS = ("stalta", "rms")


def _carry_path(folder: str) -> str:
    return os.path.join(detect_dir(folder), DETECT_CARRY_FILENAME)


def _ops_meta(ops) -> list:
    return [{"name": op.name, "params": op.params()} for op in ops]


def _opt_int(v):
    return None if v is None else int(v)


# ---------------------------------------------------------------------------
# carry persistence

def save_detect_carry(folder: str, ops, states, upto_ns, ledger_seq,
                      score_rows, step_ns) -> str:
    """Atomic crc-stamped ``.npz`` with ``.prev`` rotation — the
    single commit point of the detect subsystem (written LAST)."""
    import io as _io

    from tpudas_torch.integrity.checksum import (
        rotate_prev,
        write_bytes_checksummed,
    )

    path = _carry_path(folder)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {
        "version": _CARRY_VERSION,
        "upto_ns": _opt_int(upto_ns),
        "ledger_seq": int(ledger_seq),
        "score_rows": int(score_rows),
        "step_ns": _opt_int(step_ns),
        "ops": [
            {**om, "keys": list(st.keys())}
            for om, st in zip(_ops_meta(ops), states)
        ],
    }
    arrays = {"meta": np.asarray(json.dumps(meta))}
    for i, st in enumerate(states):
        for key, val in st.items():
            arrays[f"op{i}_{key}"] = np.asarray(val)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    rotate_prev(path)
    write_bytes_checksummed(path, buf.getvalue())
    get_registry().counter(
        "tpudas_detect_carry_saves_total", "detect carry persists"
    ).inc()
    return path


def _parse_detect_carry(path: str) -> dict:
    """Parse one carry rung into ``{meta, states}``, raising on ANY
    defect."""
    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        if meta.get("version") != _CARRY_VERSION:
            raise ValueError(
                f"detect carry version skew: {meta.get('version')!r}"
            )
        states = []
        for i, om in enumerate(meta["ops"]):
            states.append(
                {key: f[f"op{i}_{key}"] for key in om["keys"]}
            )
    return {"meta": meta, "states": states}


def load_detect_carry(folder: str) -> dict | None:
    """Verified-read ladder over the detect carry (primary, ``.prev``,
    None) — mirrors :func:`tpudas_torch.proc.stream.load_carry`."""
    from tpudas_torch.integrity.checksum import (
        count_fallback,
        count_unstamped,
        verify_file_checksum,
    )

    path = _carry_path(folder)
    prev = path + ".prev"
    if not os.path.isfile(path) and not os.path.isfile(prev):
        return None
    for cand in (path, prev):
        if not os.path.isfile(cand):
            if cand == path:
                count_fallback("detect_carry", "primary missing", cand)
            continue
        try:
            status = verify_file_checksum(cand, artifact="detect_carry")
            if status == "mismatch":
                raise ValueError("detect carry checksum mismatch")
            if status == "unstamped":
                count_unstamped("detect_carry")
            parsed = _parse_detect_carry(cand)
        except Exception as exc:
            count_fallback(
                "detect_carry",
                f"{type(exc).__name__}: {str(exc)[:120]}", cand,
            )
            continue
        return parsed
    return None


def reset_detect(folder: str, reason: str) -> None:
    """The repair of last resort: remove ``.detect/`` entirely; the
    next round recomputes the whole detection history from the output
    files (deterministic — absence is safe)."""
    d = detect_dir(folder)
    if os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)
    get_registry().counter(
        "tpudas_detect_resets_total",
        "full detect-state resets (unreconcilable artifacts; the "
        "history recomputes from the output files)",
    ).inc()
    log_event("detect_reset", folder=str(folder), reason=str(reason)[:200])


# ---------------------------------------------------------------------------
# row sourcing

def _patch_rows(patch):
    """(t_ns int64 (T,), rows float32 (T, C)) time-major from one
    output patch, as arrays the pipeline owns: on the CPU the patch's
    host data is its tensor's memory, which its holder may still
    change."""
    d = patch.host_data()
    ax = patch.axis_of("time")
    if ax != 0:
        d = np.moveaxis(d, ax, 0)
    t = (
        np.asarray(patch.coords["time"])
        .astype("datetime64[ns]")
        .astype(np.int64)
    )
    return t, np.array(d, np.float32, copy=True)


def _emitted_blocks(emitted, upto_ns):
    blocks = []
    for p in sorted(
        [q for q in emitted if q is not None],
        key=lambda q: q.attrs["time_min"],
    ):
        t, d = _patch_rows(p)
        if upto_ns is not None:
            m = t > int(upto_ns)
            t, d = t[m], d[m]
        if t.size:
            blocks.append((t, d))
    return blocks


def _file_blocks(folder, upto_ns):
    """Catch-up: re-read the decimated rows newer than ``upto_ns``
    from the output files."""
    from tpudas_torch.io.spool import spool as make_spool

    sp = make_spool(str(folder)).update()
    if upto_ns is not None:
        sp = sp.select(
            time=(np.datetime64(int(upto_ns), "ns"), None)
        )
    if len(sp) == 0:
        return []
    blocks = []
    for patch in sp.chunk(time=None):
        t, d = _patch_rows(patch)
        if upto_ns is not None:
            m = t > int(upto_ns)
            t, d = t[m], d[m]
        if t.size:
            blocks.append((t, d))
    return blocks


# ---------------------------------------------------------------------------
# the pipeline

class DetectPipeline:
    """Operators + states + artifacts for one output folder (see
    module docstring for the commit/reconcile protocol)."""

    def __init__(self, folder, ops, step_sec):
        scoring = [op.name for op in ops if op.has_score_track]
        if len(scoring) > 1:
            # the single-level score store holds ONE time-monotone row
            # track with no operator column; interleaving two
            # operators' rows would silently corrupt windowed reads
            raise ValueError(
                "at most one score-producing operator per folder "
                f"(got {scoring})"
            )
        self.folder = str(folder)
        self.ops = ops
        self.step_ns = int(round(float(step_sec) * 1e9))
        self.states: list = []  # per-op carry dicts (empty until open)
        self.upto_ns = None
        self.ledger_seq = 0
        self.score_rows = 0
        self.events: list = []  # the committed ledger, in memory
        self._lines: list = []  # their serialized (crc-stamped) lines
        # — kept in lockstep with ``events`` so each commit's rewrite
        # stamps only the round's NEW events (O(new), not O(ledger))
        self.score_store: ScoreStore | None = None
        self.n_ch = None
        # a fresh/resumed pipeline must check the OUTPUT FILES once
        # for rows beyond its carry (a killed run's round may be fully
        # written to disk with nothing new for the stream to emit);
        # steady rounds thereafter trust the in-memory emit capture
        self._synced = False

    # -- resolution ----------------------------------------------------
    @classmethod
    def open(cls, folder, operators=None, step_sec=1.0, device=None):
        """Resolve the pipeline from disk: adopt a matching carry and
        reconcile the ledger/scores to it, or reset and start fresh.
        The operators compute on ``device`` (default the CUDA card).
        """
        ops = [
            make_operator(s, device=device)
            for s in (operators if operators is not None
                      else DEFAULT_OPERATORS)
        ]
        pipe = cls(folder, ops, step_sec)
        carry = load_detect_carry(folder)
        if carry is not None and not pipe._carry_matches(carry):
            # operator configuration changed: the persisted history
            # was computed under different rules — recompute it
            reset_detect(folder, "operator configuration changed")
            carry = None
        if carry is not None:
            meta_step = carry["meta"].get("step_ns")
            if meta_step and int(meta_step) != pipe.step_ns:
                # the output grid step is operator geometry too
                # (alphas, window row counts): a changed step means
                # the history was computed under different rules
                reset_detect(folder, "output grid step changed")
                carry = None
        if carry is None:
            # artifacts without a loadable carry cannot be trusted
            # (which rows do they cover?) — reset and recompute
            d = detect_dir(folder)
            if os.path.isdir(d) and any(
                not n.startswith(DETECT_CARRY_FILENAME)
                for n in os.listdir(d)
            ):
                reset_detect(folder, "artifacts without a carry")
            return pipe
        meta = carry["meta"]
        pipe.states = [dict(st) for st in carry["states"]]
        pipe.upto_ns = meta["upto_ns"]
        pipe.ledger_seq = int(meta["ledger_seq"])
        pipe.score_rows = int(meta["score_rows"])
        pipe.n_ch = None
        for st in pipe.states:
            for v in st.values():
                arr = np.asarray(v)
                if arr.ndim >= 1 and arr.shape[-1] > 0:
                    pipe.n_ch = int(arr.shape[-1])
                    break
            if pipe.n_ch is not None:
                break
        try:
            pipe._reconcile()
        except CorruptDetectError as exc:
            reset_detect(folder, str(exc))
            return cls.open(folder, operators=operators,
                            step_sec=step_sec, device=device)
        get_registry().counter(
            "tpudas_detect_carry_resumes_total",
            "detect pipelines resumed from a persisted carry",
        ).inc()
        return pipe

    def _carry_matches(self, carry) -> bool:
        want = _ops_meta(self.ops)
        got = [
            {"name": om.get("name"), "params": om.get("params")}
            for om in carry["meta"].get("ops", ())
        ]
        return json.dumps(want, sort_keys=True) == json.dumps(
            got, sort_keys=True
        )

    def _reconcile(self) -> None:
        """Truncate ledger + scores back to the carry's commit point
        (rows beyond it are a crashed commit's surplus)."""
        events = load_events(self.folder)
        if len(events) < self.ledger_seq:
            raise CorruptDetectError(
                f"ledger holds {len(events)} events but the carry "
                f"committed {self.ledger_seq}"
            )
        if len(events) > self.ledger_seq:
            events = events[: self.ledger_seq]
            write_events(self.folder, events)
            get_registry().counter(
                "tpudas_detect_reconcile_truncated_total",
                "uncommitted ledger events truncated on resume "
                "(regenerated identically by the replayed rows)",
            ).inc()
        self.events = events
        self._lines = [event_line(ev) for ev in events]
        store = ScoreStore.open(self.folder)
        if store is None:
            if self.score_rows > 0:
                raise CorruptDetectError(
                    f"carry committed {self.score_rows} score rows but "
                    "no score store opens"
                )
        else:
            store.truncate_to(self.score_rows)  # may raise -> reset
        self.score_store = store

    # -- one round -----------------------------------------------------
    def process_round(self, emitted) -> dict:
        """Feed this round's new rows through every operator and
        commit.  Raises on any failure (the caller owns the swallow +
        drop-to-None discipline)."""
        reg = get_registry()
        blocks = self._resolve_blocks(emitted)
        if not blocks:
            return self._summary(0, 0)
        if (self.states and self.n_ch is not None
                and int(blocks[0][1].shape[1]) != self.n_ch):
            # a restart changed the channel geometry: the carried
            # per-channel states can never consume these rows — the
            # repair is reset + deterministic recompute from the
            # files, NOT a per-round failure loop on a stale carry
            reset_detect(
                self.folder,
                f"channel count changed {self.n_ch} -> "
                f"{int(blocks[0][1].shape[1])}",
            )
            self.states = []
            self.upto_ns = None
            self.ledger_seq = 0
            self.score_rows = 0
            self.events = []
            self._lines = []
            self.score_store = None
            self.n_ch = None
            blocks = _file_blocks(self.folder, None)
            self._count_catchup(blocks)
            if not blocks:
                return self._summary(0, 0)
        round_events: list = []
        round_scores: list = []
        round_score_t: list = []
        n_rows = 0
        if not self.states:
            n_ch = int(blocks[0][1].shape[1])
            self.n_ch = n_ch
            self.states = [
                op.init_state(n_ch, self.step_ns) for op in self.ops
            ]
        for t, d in blocks:
            for lo, hi in _feed_spans(t.shape[0], _FEED_CAP):
                ct, cd = t[lo:hi], d[lo:hi]
                n_rows += int(ct.shape[0])
                for i, op in enumerate(self.ops):
                    t0 = time.perf_counter()
                    try:
                        from tpudas_torch.resilience.faults import fault_point

                        with span("detect.op", op=op.name):
                            fault_point("detect.op", op=op.name)
                            result, self.states[i] = op.process(
                                cd, ct, self.step_ns, self.states[i]
                            )
                    except Exception:
                        reg.counter(
                            "tpudas_detect_op_errors_total",
                            "operator process() calls that raised "
                            "(the round's detect commit is skipped "
                            "and replayed next round)",
                            labelnames=("op",),
                        ).inc(op=op.name)
                        raise
                    reg.histogram(
                        "tpudas_detect_op_seconds",
                        "per-block operator process() wall time",
                        labelnames=("op",),
                    ).observe(time.perf_counter() - t0, op=op.name)
                    if result.events:
                        op_idx = i
                        for ev in result.events:
                            round_events.append((op_idx, ev))
                    if result.scores is not None and result.scores.size:
                        round_scores.append(result.scores)
                        round_score_t.append(result.score_t_ns)
            self.upto_ns = int(t[-1])
        self._commit(round_events, round_score_t, round_scores)
        reg.counter(
            "tpudas_detect_rows_total",
            "decimated output rows fed through the detect operators",
        ).inc(n_rows)
        reg.counter(
            "tpudas_detect_rounds_total",
            "detect rounds committed",
        ).inc()
        reg.gauge(
            "tpudas_detect_ledger_events",
            "events currently committed in the ledger",
        ).set(self.ledger_seq)
        return self._summary(n_rows, len(round_events))

    def _resolve_blocks(self, emitted):
        """The round's new rows: captured emits when contiguous with
        the carry head, the file-backed catch-up otherwise."""
        if self.upto_ns is None:
            # fresh pipeline: the files are the authoritative history
            blocks = _file_blocks(self.folder, None)
            self._count_catchup(blocks)
            self._synced = True
            return blocks
        blocks = _emitted_blocks(emitted, self.upto_ns)
        if not blocks and not self._synced:
            # first round of a RESUMED pipeline with no fresh emits:
            # a killed run's round may be fully on disk beyond the
            # carry with nothing left for the stream to re-emit
            blocks = _file_blocks(self.folder, self.upto_ns)
            self._count_catchup(blocks)
        elif blocks and (
            int(blocks[0][0][0]) - int(self.upto_ns)
            > int(1.5 * self.step_ns)
        ):
            # rows missing between the carry head and the capture
            # (crashed commit, listener gap): catch up from disk —
            # same rows, so the result is bit-identical either way
            blocks = _file_blocks(self.folder, self.upto_ns)
            self._count_catchup(blocks)
        self._synced = True
        return blocks

    def _count_catchup(self, blocks) -> None:
        rows = sum(int(t.shape[0]) for t, _ in blocks)
        if rows:
            get_registry().counter(
                "tpudas_detect_catchup_rows_total",
                "rows re-read from the output files instead of the "
                "in-memory emit capture",
            ).inc(rows)

    def _commit(self, round_events, score_t, score_vals) -> None:
        """Scores, then ledger, then carry (the commit point)."""
        if score_vals:
            values = np.concatenate(score_vals)
            times = np.concatenate(score_t)
            if self.score_store is None:
                self.score_store = ScoreStore.create(
                    self.folder, epoch_ns=int(times[0]),
                    n_ch=int(values.shape[1]),
                )
            self.score_store.append(times, values)
            self.score_rows += int(values.shape[0])
        if round_events:
            # deterministic ledger order: close time, then operator
            # position, then channel — closure times are monotone
            # across rounds, so a merged catch-up round appends in
            # exactly the order the live rounds would have
            round_events.sort(
                key=lambda item: (
                    item[1]["t_end_ns"], item[0], item[1]["channel"],
                    item[1]["t_ns"],
                )
            )
            reg = get_registry()
            for op_idx, ev in round_events:
                ev["seq"] = self.ledger_seq
                self.ledger_seq += 1
                self.events.append(ev)
                self._lines.append(event_line(ev))
                reg.counter(
                    "tpudas_detect_events_total",
                    "events committed to the ledger, by operator",
                    labelnames=("op",),
                ).inc(op=ev["op"])
            write_event_lines(self.folder, self._lines)
        save_detect_carry(
            self.folder, self.ops, self.states, self.upto_ns,
            self.ledger_seq, self.score_rows, self.step_ns,
        )

    def _summary(self, rows, new_events) -> dict:
        return {
            "operators": [op.name for op in self.ops],
            "rows": int(rows),
            "new_events": int(new_events),
            "ledger_events": int(self.ledger_seq),
            "score_rows": int(self.score_rows),
            "upto_ns": _opt_int(self.upto_ns),
        }


def _feed_spans(n: int, cap: int):
    """Feed-block spans over ``[0, n)``.  A round that fits under
    ``cap`` goes through as ONE block; anything larger is cap-blocked
    with a power-of-two tail (the JAX package's split)."""
    if 0 < n <= cap:
        return [(0, n)]
    spans = []
    off = 0
    while n - off >= cap:
        spans.append((off, off + cap))
        off += cap
    rem = n - off
    b = 1 << max(rem.bit_length() - 1, 0)
    while rem:
        if b <= rem:
            spans.append((off, off + b))
            off += b
            rem -= b
        b >>= 1
    return spans


# ---------------------------------------------------------------------------
# the driver hook

def run_detect_round(folder, rnd, emitted, state, operators=None,
                     step_sec=1.0, device=None) -> None:
    """The realtime drivers' per-round detect hook.  ``state`` is the
    driver's cross-round dict (``{"pipe": ..., "summary": ...}``);
    dropped to ``pipe=None`` on ANY failure so the next round
    re-resolves from disk — counted and swallowed, an operator failure
    must never take down the stream (the resilience posture).  The
    operators of a new pipeline compute on ``device``."""
    reg = get_registry()
    try:
        with span("detect.round", round=rnd):
            pipe = state.get("pipe")
            if pipe is None:
                pipe = DetectPipeline.open(
                    folder, operators=operators, step_sec=step_sec,
                    device=device,
                )
            summary = pipe.process_round(emitted)
            state["pipe"] = pipe
            state["summary"] = dict(
                summary, ok=True, shed=False, last_error=None
            )
            if summary["new_events"]:
                log_event(
                    "detect_round", round=rnd,
                    new_events=summary["new_events"],
                    ledger_events=summary["ledger_events"],
                )
    except Exception as exc:
        state["pipe"] = None
        # the republished summary must not read healthy while detect
        # is failing: keep the last good counters but flip the status
        state["summary"] = dict(
            state.get("summary") or {}, ok=False,
            last_error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        reg.counter(
            "tpudas_detect_errors_total",
            "detect rounds that failed (swallowed; the round replays "
            "via catch-up next time)",
        ).inc()
        log_event(
            "detect_round_failed",
            round=rnd,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        from tpudas_torch.integrity import resource as _resource

        if _resource.is_resource_error(exc):
            _resource.note_pressure("detect", exc)


def mark_detect_shed(state) -> None:
    """Record in the driver's detect summary that this round's hook
    was shed under resource pressure — the summary must show detection
    paused, not the last good round's numbers forever."""
    state["summary"] = dict(state.get("summary") or {}, ok=False,
                            shed=True)
