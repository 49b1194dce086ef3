"""Streaming detection operators: the pluggable-algorithm contract.

The port's counterpart of :mod:`tpudas.detect.operators`.  A
:class:`StreamOperator` consumes the DECIMATED output stream row by row
and threads an explicit state dict ("carry") through every call, so a
retried round and a process restart replay byte-identically.

The contract (``init_state`` / ``process``) has two hard rules:

1. **Chunk invariance.**  ``process`` may be called with the same
   logical row stream split at ANY boundaries (the live path feeds a
   round's emitted patches; the catch-up path re-reads the same rows
   from the output files).  Events, scores and the final state must be
   bit-identical regardless of the split: every cross-row recurrence is
   strictly sequential (a loop over rows) or windowed through a carried
   ring of the trailing rows.
2. **State is the whole memory.**  Everything the operator needs to
   resume lives in the state dict as numpy arrays, with the JAX
   package's keys and dtypes (0-d ``np.int32`` counters, ``np.int64``
   row index, bool ``in_event``): the runner serializes it into the
   detect carry, which either package resumes.

Two operators ship, as in the JAX package:

- ``"stalta"`` — recursive STA/LTA event detection (exponential
  averages of the squared signal; a trigger opens at ``ratio >= on`` and
  closes at ``ratio <= off``; the LTA freezes while triggered).  Each
  CLOSED trigger becomes one ledger event; an open one rides the carry.
- ``"rms"`` — per-channel trailing rolling RMS (window ``window`` s,
  emitted every ``step`` s on the global row grid, pandas alignment via
  :func:`tpudas_torch.ops.rolling.rolling_reduce`) plus anomaly scoring
  against a slow EMA baseline.

Where the JAX package runs ``jax.lax.scan`` under ``jit``, the port
runs a loop over rows of plain torch ops on the operator's ``device``
(default the CUDA card; ``"cpu"`` on request), vectorised over
channels: there is no hand kernel here, and no fallback — an operator
given a CUDA device computes on it or raises.  Eager float32 ops round
each product and sum on their own, where XLA may contract
``sta + a * (x - sta)`` into one fused multiply-add, so ratios can
differ from the JAX package's in the last bits.  Event extraction and
the canonical-carry zeroing stay numpy on the host.

NaN rows (data gaps, rolling warm-up prefixes) are inert: recurrences
freeze through them and they never open a trigger or an anomaly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpudas_torch.device import resolve_device

__all__ = [
    "DetectResult",
    "RollingRmsOperator",
    "StaLtaOperator",
    "StreamOperator",
    "make_operator",
    "operator_names",
    "register_operator",
]


@dataclass
class DetectResult:
    """What one ``process`` call produced.

    ``events`` are ledger-ready dicts with the uniform schema
    ``{op, kind, channel, t_ns, t_peak_ns, t_end_ns, score}`` (times
    int ns, ``score`` a plain float).  ``scores`` / ``score_t_ns`` are
    the per-channel score rows this chunk emitted (``None`` when the
    operator has no score track)."""

    events: list = field(default_factory=list)
    scores: np.ndarray | None = None  # (S, C) float32
    score_t_ns: np.ndarray | None = None  # (S,) int64


class StreamOperator:
    """Base contract for a registered streaming operator.

    Subclasses define ``name`` (the registry key), ``params()`` (the
    JSON-serializable configuration the carry validates on resume),
    ``init_state(n_ch, step_ns)`` and
    ``process(rows, t_ns, step_ns, state) -> (DetectResult, state)``.
    ``rows`` is ``(T, C) float32`` time-major decimated output, ``t_ns``
    the ``(T,) int64`` row times, ``step_ns`` the output grid step.

    ``has_score_track = True`` declares that ``process`` fills
    ``DetectResult.scores``; a pipeline allows at most one such
    operator per folder.  ``device`` is where the operator computes; it
    is not a parameter (the carry does not record it).
    """

    name = "operator"
    has_score_track = False

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def params(self) -> dict:
        raise NotImplementedError

    def init_state(self, n_ch: int, step_ns: int) -> dict:
        raise NotImplementedError

    def process(self, rows, t_ns, step_ns, state):
        raise NotImplementedError

    def _f32(self, value):
        """A 0-d float32 tensor on the operator's device."""
        return torch.tensor(np.float32(value), device=self.device)

    def _tensor(self, array, dtype=None):
        """An owned copy of ``array`` on the operator's device: on the
        CPU ``from_numpy`` alone would share the caller's memory (the
        emitted patch's rows), which the caller may still change."""
        return torch.tensor(np.asarray(array, dtype), device=self.device)


def _owned(t) -> np.ndarray:
    """A host array that shares memory with no tensor: ``.numpy()`` of
    a CPU tensor is a view of it."""
    return np.array(t.cpu().numpy(), copy=True)


# ---------------------------------------------------------------------------
# the registry

_REGISTRY: dict = {}


def register_operator(cls):
    """Class decorator: register ``cls`` under ``cls.name``."""
    _REGISTRY[str(cls.name)] = cls
    return cls


def operator_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def make_operator(spec, device=None) -> StreamOperator:
    """Instantiate one operator from a spec on ``device``: an instance
    (returned as-is), a registered name, ``(name, params_dict)``, or
    ``{"name": ..., **params}``."""
    if isinstance(spec, StreamOperator):
        return spec
    if isinstance(spec, str):
        name, params = spec, {}
    elif isinstance(spec, dict):
        params = dict(spec)
        name = params.pop("name")
    else:
        name, params = spec
        params = dict(params)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown detect operator {name!r}; registered: "
            f"{operator_names()}"
        )
    return _REGISTRY[name](**params, device=device)


# ---------------------------------------------------------------------------
# the two recurrences (loops over rows, vectorised over channels)

def _stalta_scan(x2, sta, lta, in_ev, warm, a_s, a_l, on, off, warm_rows):
    """Sequential STA/LTA recurrence over one chunk of squared rows
    ``x2`` (T, C).  Returns the new (sta, lta, in_event, warm) plus the
    per-row (ratio, trigger) series.  NaN rows freeze both averages and
    force trigger False."""
    floor = torch.tensor(np.float32(1e-20), device=x2.device)
    ratios = torch.empty_like(x2)
    trigs = torch.empty(x2.shape, dtype=torch.bool, device=x2.device)
    for t in range(x2.shape[0]):
        xt = x2[t]
        finite = torch.isfinite(xt)
        sta = torch.where(finite, sta + a_s * (xt - sta), sta)
        # classic freeze: the LTA holds while triggered, so an event
        # cannot decay its own detection floor
        lta = torch.where(finite & ~in_ev, lta + a_l * (xt - lta), lta)
        ratio = sta / torch.maximum(lta, floor)
        if warm >= warm_rows:
            trig = torch.where(in_ev, ratio > off, ratio >= on)
        else:
            trig = in_ev & (ratio > off)
        in_ev = trig & finite
        ratios[t] = ratio
        trigs[t] = in_ev
        warm += 1
    return sta, lta, in_ev, warm, ratios, trigs


def _rms_base_scan(rms_rows, base, bwarm, a_b, warm_min):
    """Sequential EMA-baseline recurrence over the emitted RMS positions
    (S, C).  Returns the final (base, bwarm) plus the per-position
    anomaly ratio (0 while warming up or non-finite)."""
    floor = torch.tensor(np.float32(1e-20), device=rms_rows.device)
    zero = torch.zeros((), dtype=torch.float32, device=rms_rows.device)
    ratios = torch.empty_like(rms_rows)
    for i in range(rms_rows.shape[0]):
        x = rms_rows[i]
        finite = torch.isfinite(x)
        safe = finite & (base > 0)
        if bwarm >= warm_min:
            ratios[i] = torch.where(safe, x / torch.maximum(base, floor), zero)
        else:
            ratios[i] = zero
        base = torch.where(finite, base + a_b * (x - base), base)
        bwarm += 1
    return base, bwarm, ratios


# ---------------------------------------------------------------------------
# STA/LTA

@register_operator
class StaLtaOperator(StreamOperator):
    """Recursive STA/LTA trigger over the squared decimated stream.

    ``sta`` / ``lta`` are the averaging time constants in seconds
    (converted to per-row EMA coefficients from the output grid step);
    ``on`` / ``off`` the trigger open/close ratio thresholds; triggers
    are suppressed for the first ``lta`` seconds of rows (warm-up).
    """

    name = "stalta"

    def __init__(self, sta=2.0, lta=20.0, on=3.0, off=1.5, device=None):
        self.sta = float(sta)
        self.lta = float(lta)
        self.on = float(on)
        self.off = float(off)
        if self.sta <= 0 or self.lta <= self.sta:
            raise ValueError(
                f"need 0 < sta < lta, got sta={self.sta} lta={self.lta}"
            )
        if self.off > self.on:
            raise ValueError(
                f"off threshold {self.off} must not exceed on {self.on}"
            )
        super().__init__(device)

    def params(self) -> dict:
        return {"sta": self.sta, "lta": self.lta, "on": self.on,
                "off": self.off}

    def init_state(self, n_ch: int, step_ns: int) -> dict:
        return {
            "sta": np.zeros(n_ch, np.float32),
            "lta": np.zeros(n_ch, np.float32),
            "in_event": np.zeros(n_ch, bool),
            "warm": np.int32(0),
            "peak": np.zeros(n_ch, np.float32),
            "t_on": np.zeros(n_ch, np.int64),
            "t_peak": np.zeros(n_ch, np.int64),
        }

    def _alphas(self, step_ns: int):
        dt = step_ns / 1e9
        a_s = np.float32(min(1.0, dt / self.sta))
        a_l = np.float32(min(1.0, dt / self.lta))
        warm_rows = max(1, int(round(self.lta / dt)))
        return a_s, a_l, warm_rows

    def process(self, rows, t_ns, step_ns, state):
        rows = np.asarray(rows, np.float32)
        t_ns = np.asarray(t_ns, np.int64)
        if rows.shape[0] == 0:
            return DetectResult(), state
        a_s, a_l, warm_rows = self._alphas(int(step_ns))
        x = self._tensor(rows)
        sta, lta, in_ev, warm, ratios, trigs = _stalta_scan(
            x * x,
            self._tensor(state["sta"], np.float32),
            self._tensor(state["lta"], np.float32),
            self._tensor(state["in_event"], bool),
            int(state["warm"]),
            self._f32(a_s), self._f32(a_l), self._f32(self.on),
            self._f32(self.off), warm_rows,
        )
        ratios = ratios.cpu().numpy()
        trigs = trigs.cpu().numpy()
        new_state = dict(state)
        new_state["sta"] = _owned(sta)
        new_state["lta"] = _owned(lta)
        new_state["in_event"] = _owned(in_ev)
        new_state["warm"] = np.int32(warm)
        events = self._extract_events(t_ns, ratios, trigs, state, new_state)
        return DetectResult(events=events), new_state

    def _extract_events(self, t_ns, ratios, trigs, state, new_state):
        """Close triggers into ledger events; open triggers ride the
        carry (peak / t_on / t_peak per channel).  Walks only the
        channels with any activity."""
        prev_in = np.asarray(state["in_event"], bool)
        peak = np.array(state["peak"], np.float32, copy=True)
        t_on = np.array(state["t_on"], np.int64, copy=True)
        t_peak = np.array(state["t_peak"], np.int64, copy=True)
        events = []
        active = np.flatnonzero(prev_in | trigs.any(axis=0))
        for c in active:
            col = trigs[:, c]
            r = ratios[:, c]
            b = np.concatenate(
                [[1 if prev_in[c] else 0], col.astype(np.int8)]
            )
            d = np.diff(b)
            starts = list(np.flatnonzero(d == 1))
            ends = list(np.flatnonzero(d == -1))
            segs = []
            if prev_in[c]:
                segs.append((0, ends.pop(0) if ends else None, True))
            while starts:
                lo = starts.pop(0)
                segs.append((lo, ends.pop(0) if ends else None, False))
            for lo, hi, carried in segs:
                hi_eff = len(col) if hi is None else hi
                if carried:
                    pk = float(peak[c])
                    tpk = int(t_peak[c])
                    ton = int(t_on[c])
                else:
                    pk, tpk, ton = float("-inf"), 0, int(t_ns[lo])
                if hi_eff > lo:
                    seg = r[lo:hi_eff]
                    m = int(np.argmax(seg))
                    if float(seg[m]) > pk:
                        pk = float(seg[m])
                        tpk = int(t_ns[lo + m])
                if hi is None:
                    # still open at the chunk end: persist in the carry
                    peak[c] = np.float32(pk)
                    t_peak[c] = tpk
                    t_on[c] = ton
                else:
                    events.append(
                        {
                            "op": self.name,
                            "kind": "trigger",
                            "channel": int(c),
                            "t_ns": ton,
                            "t_peak_ns": tpk,
                            "t_end_ns": int(t_ns[hi]),
                            "score": pk,
                        }
                    )
        # canonical carry: a channel with no OPEN event holds zeros, so
        # the carry does not depend on where the chunk boundaries fell
        closed = ~np.asarray(new_state["in_event"], bool)
        peak[closed] = 0
        t_on[closed] = 0
        t_peak[closed] = 0
        new_state["peak"] = peak
        new_state["t_on"] = t_on
        new_state["t_peak"] = t_peak
        return events


# ---------------------------------------------------------------------------
# rolling RMS + anomaly score

@register_operator
class RollingRmsOperator(StreamOperator):
    """Trailing rolling RMS per channel with EMA-baseline anomaly
    scoring.

    The RMS of the trailing ``window`` seconds is emitted every ``step``
    seconds on the GLOBAL row grid (positions ``p % s == 0`` with
    ``p >= w - 1``, pandas alignment), independent of how the stream
    was chunked: the carry holds the trailing ``w - 1`` raw rows plus
    the global row index.  Each emitted RMS row updates a slow EMA
    baseline (time constant ``baseline`` seconds); once the baseline has
    seen a full time constant of positions, ``rms / baseline >= thresh``
    emits one anomaly event per (position, channel)."""

    name = "rms"
    has_score_track = True

    def __init__(self, window=10.0, step=5.0, thresh=4.0, baseline=60.0,
                 device=None):
        self.window = float(window)
        self.step = float(step)
        self.thresh = float(thresh)
        self.baseline = float(baseline)
        if self.window <= 0 or self.step <= 0:
            raise ValueError("window and step must be positive seconds")
        if self.baseline <= 0:
            raise ValueError("baseline time constant must be positive")
        super().__init__(device)

    def params(self) -> dict:
        return {
            "window": self.window,
            "step": self.step,
            "thresh": self.thresh,
            "baseline": self.baseline,
        }

    def init_state(self, n_ch: int, step_ns: int) -> dict:
        return {
            "ring": np.zeros((0, n_ch), np.float32),
            "row_idx": np.int64(0),
            "base": np.zeros(n_ch, np.float32),
            "bwarm": np.int32(0),
        }

    def _geometry(self, step_ns: int):
        dt = step_ns / 1e9
        w = max(1, int(round(self.window / dt)))
        s = max(1, int(round(self.step / dt)))
        return w, s, dt

    def process(self, rows, t_ns, step_ns, state):
        from tpudas_torch.ops.rolling import exact_sqrt, rolling_reduce

        rows = np.asarray(rows, np.float32)
        t_ns = np.asarray(t_ns, np.int64)
        if rows.shape[0] == 0:
            return DetectResult(), state
        w, s, dt = self._geometry(int(step_ns))
        ring = np.asarray(state["ring"], np.float32)
        row0 = int(state["row_idx"])
        pool = np.concatenate([ring, rows]) if ring.size else rows
        g0 = row0 - ring.shape[0]  # global index of pool[0]
        # emitted global positions inside THIS chunk's row range
        p_hi = row0 + rows.shape[0]
        first = max(row0, w - 1)
        first = ((first + s - 1) // s) * s
        positions = np.arange(first, p_hi, s, dtype=np.int64)
        new_state = dict(state)
        keep = min(w - 1, pool.shape[0])
        # an owned copy: ``pool`` is the caller's ``rows`` when the ring
        # is empty, and the saved state must not change with them
        new_state["ring"] = np.array(
            pool[pool.shape[0] - keep:] if keep else pool[:0],
            np.float32, copy=True,
        )
        new_state["row_idx"] = np.int64(p_hi)
        if positions.size == 0:
            return DetectResult(), new_state
        x = self._tensor(pool)
        rms = exact_sqrt(rolling_reduce(x * x, w, 1, "mean"))
        rms_pos = rms[torch.from_numpy(positions - g0).to(self.device)]
        score_times = t_ns[(positions - row0)]
        warm_min = max(1, int(round(self.baseline / (s * dt))))
        a_b = np.float32(min(1.0, (s * dt) / self.baseline))
        base, bwarm, ratios = _rms_base_scan(
            rms_pos, self._tensor(state["base"], np.float32),
            int(state["bwarm"]), self._f32(a_b), warm_min,
        )
        ratios = ratios.cpu().numpy()
        events = []
        for pi, c in np.argwhere(ratios >= np.float32(self.thresh)):
            t_here = int(score_times[pi])
            events.append(
                {
                    "op": self.name,
                    "kind": "anomaly",
                    "channel": int(c),
                    "t_ns": t_here,
                    "t_peak_ns": t_here,
                    "t_end_ns": t_here,
                    "score": float(ratios[pi, c]),
                }
            )
        new_state["base"] = _owned(base)
        new_state["bwarm"] = np.int32(bwarm)
        return DetectResult(
            events=events,
            scores=rms_pos.cpu().numpy(),
            score_t_ns=np.asarray(score_times, np.int64),
        ), new_state
