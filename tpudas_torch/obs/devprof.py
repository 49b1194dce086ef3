"""Device telemetry plane: launch, compile and utilization accounting
for every stream step.

The port's counterpart of :mod:`tpudas.obs.devprof`, name for name,
with the same metrics, snapshot keys, round-record fields and env
knobs.  Where torch differs from JAX:

**Launch accounting.**  Every stream-step dispatch site
(:mod:`tpudas_torch.ops.fir` cascade solo + stacked,
:mod:`tpudas_torch.ops.filter` FFT solo + stacked) brackets its step
with :func:`launch_start` / :func:`note_launch`: launch counts and
device seconds keyed ``{engine, stacked, stream}``.  On a CUDA tensor
the bracket is a pair of timing events recorded on the device's
current stream around the step (taken from a small pool); the pair is
parked, finished pairs are drained on the dispatch path with the
non-blocking ``Event.query()``, and :func:`round_collect` (the round
boundary the runner already owns) waits on each parked end event, never
on the whole device.  The device seconds are the events' elapsed time
less the compile seconds spent inside the bracket, clamped at 0.  On a
CPU tensor the step is synchronous and the bracket's host delta is the
measurement.  A stacked launch serving N streams is attributed 1/N per
member (counts and seconds both), so sums over streams equal true
launches and device-busy seconds.

**Compile accounting.**  A compile is an nvcc build, or the first
``ctypes`` load, of a kernel library (:mod:`tpudas_torch.ops._build`
reports each through :func:`_on_compile_duration`).  Dispatch sites
declare their cache key first via :func:`note_kernel`, so a compile is
attributed to what triggered it (``first`` / ``shape`` / ``knobs``),
and a burst of re-compiles inside a short window raises the
recompile-storm alarm.  The port builds each library once per process
and never on a change of shape, so on the card the storm cannot fire
from the kernels; the logic is the JAX package's.

**Utilization.**  Torch has no ``cost_analysis()``: each kind's FLOPs
and bytes come from a formula over the shape key
(:func:`tpudas_torch.ops.fir.stream_step_cost`,
:func:`tpudas_torch.ops.filter.fft_step_cost`), memoized per key, the
same for the plain and the kernel engines.  With a launch floor (an
``x + 1`` on an 8 x 8 tensor, dispatch to ready) and roofline peaks
(``TPUDAS_DEVPROF_PEAK_FLOPS`` / ``TPUDAS_DEVPROF_PEAK_BYTES``, else a
512 x 512 matmul and copy probe) they give a roofline-relative
utilization per stream and the launch-bound vs compute-bound
classification (``TPUDAS_DEVPROF_UTIL_BOUND``, default 0.5; without
cost data the launch-floor ratio, ``TPUDAS_DEVPROF_LAUNCH_RATIO``,
default 25).  The probes run on the card when this process has
initialized CUDA, else on the CPU.

Surfaces: per-round flight fields and the ``device_execute`` /
``host_wait`` phase split (:func:`round_collect`), the
``tpudas_devprof_*`` metric family, :func:`devprof_snapshot` (the
``GET /devprof`` payload, under an ``obs.devprof`` span), and the
on-demand ``torch.profiler`` capture (:func:`start_profile`, the
``GET /profile?seconds=N`` trigger) into ``TPUDAS_PROFILE_DIR`` (or the
``TPUDAS_TRACE_DIR`` it falls back to) without restarting the stream.
The capture runs on a thread of its own, which starts the profiler,
waits, stops it and writes a Chrome trace: ``torch.profiler`` must be
stopped by the thread that started it.  Its host ranges are that
thread's; the card's kernels and copies are recorded process wide.
``TPUDAS_DEVPROF=0`` is the kill switch: every hook becomes a cheap env
check.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.logging import log_event

__all__ = [
    "devprof_enabled",
    "stream_scope",
    "wave_scope",
    "current_stream",
    "note_kernel",
    "kernel_cost",
    "launch_start",
    "note_launch",
    "round_collect",
    "classify_stream",
    "launch_floor_seconds",
    "peak_flops",
    "peak_bytes_per_s",
    "devprof_snapshot",
    "profiler_available",
    "start_profile",
    "profile_status",
    "reset",
]

_COMPILE_EVENT_SUFFIX = "backend_compile_duration"
_KERNEL_LOG_LIMIT = 64  # newest kernel-key events kept for /devprof
_EVENT_POOL_LIMIT = 64  # idle timing events kept per device

_TLS = threading.local()


def devprof_enabled() -> bool:
    return os.environ.get("TPUDAS_DEVPROF", "1") != "0"


def _launch_ratio_threshold() -> float:
    raw = os.environ.get("TPUDAS_DEVPROF_LAUNCH_RATIO", "")
    try:
        return float(raw) if raw else 25.0
    except ValueError:
        return 25.0


def _util_bound_threshold() -> float:
    raw = os.environ.get("TPUDAS_DEVPROF_UTIL_BOUND", "")
    try:
        return float(raw) if raw else 0.5
    except ValueError:
        return 0.5


def _storm_params() -> tuple:
    """(compiles, window_s) that trip the recompile-storm alarm."""
    raw = os.environ.get("TPUDAS_DEVPROF_STORM", "")
    try:
        n, w = raw.split("/", 1)
        return max(2, int(n)), float(w)
    except (ValueError, AttributeError):
        return 8, 30.0


# ---------------------------------------------------------------------------
# state


class _Acc:
    """One {engine, stacked, stream} accumulator (also summed per
    stream for the round delta / classification reads)."""

    __slots__ = ("launches", "device_s", "flops", "bytes")

    def __init__(self):
        self.launches = 0.0
        self.device_s = 0.0
        self.flops = 0.0
        self.bytes = 0.0

    def snap(self) -> dict:
        return {
            "launches": round(self.launches, 4),
            "device_seconds": round(self.device_s, 6),
            "flops": self.flops,
            "bytes": self.bytes,
        }


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        # {(engine, stacked, stream): _Acc} and {stream: _Acc}
        self.by_key: dict = {}
        self.by_stream: dict = {}
        # per-stream cumulative snapshot at the last round_collect
        self.round_base: dict = {}
        # parked CUDA brackets:
        # [keys, engine, bracket, end_event, compile_s, cost]
        self.pending: list = []
        # compile accounting
        self.compiles = 0
        self.compile_s = 0.0
        self.compile_triggers: dict = {}
        self.compile_times: list = []  # monotonic stamps (storm window)
        self.storm_active = False
        self.storms = 0
        # kernel-key attribution
        self.last_key: dict = {}  # {kind: (shape_key, knobs)}
        self.seen_keys: set = set()
        self.kernel_log: list = []
        # one-time cost capture per kernel key
        self.costs: dict = {}
        # lazy calibration (None = not yet attempted)
        self.launch_floor = None
        self.peak_flops = None
        self.peak_bytes = None
        # deep capture
        self.profile = None  # {"dir", "seconds", "started_at"}


_state = _State()
# idle timing events by device index (outlive reset(): they hold no
# accounting state)
_event_pool: dict = {}
_pool_lock = threading.Lock()


def reset() -> None:
    """Drop all devprof state (tests and bench legs)."""
    global _state
    _state = _State()


def _reset_calibration() -> None:
    """Forget the launch floor and the peaks, so the next calibrating
    read probes again (or takes the env pins)."""
    with _state.lock:
        _state.launch_floor = None
        _state.peak_flops = None
        _state.peak_bytes = None


# ---------------------------------------------------------------------------
# thread-scoped attribution context


@contextmanager
def stream_scope(stream_id):
    """Attribute launches dispatched on this thread to ``stream_id``
    (the runner wraps each round in one)."""
    prev = getattr(_TLS, "stream", None)
    _TLS.stream = str(stream_id)
    try:
        yield
    finally:
        _TLS.stream = prev


@contextmanager
def wave_scope(members):
    """Attribute launches dispatched on this thread to a batch-executor
    wave: the dispatching member's thread runs waves for OTHER members
    (the fleet's rendezvous), so the wave's member list, not the
    thread's own stream scope, is the truth.  >= 2 members marks the
    launch stacked and splits attribution 1/N."""
    prev = getattr(_TLS, "wave", None)
    _TLS.wave = tuple(str(m) for m in members)
    try:
        yield
    finally:
        _TLS.wave = prev


def current_stream() -> str:
    return getattr(_TLS, "stream", None) or ""


def _attribution(stacked: bool) -> list:
    """[(stream, fraction, stacked_label)] for one launch."""
    wave = getattr(_TLS, "wave", None)
    if wave:
        frac = 1.0 / len(wave)
        label = "1" if (len(wave) >= 2 or stacked) else "0"
        return [(m, frac, label) for m in wave]
    return [(current_stream(), 1.0, "1" if stacked else "0")]


# ---------------------------------------------------------------------------
# compile accounting


def _on_compile_duration(event: str, secs: float, **_kw) -> None:
    """One compile of ``secs`` wall seconds (``event`` ends in
    ``backend_compile_duration``; others are ignored): a kernel
    library's nvcc build or first load, reported by
    :mod:`tpudas_torch.ops._build` on the thread that needed it."""
    if not str(event).endswith(_COMPILE_EVENT_SUFFIX):
        return
    trigger = getattr(_TLS, "compile_trigger", None) or "unattributed"
    # the build ran inside the enclosing dispatch bracket (on the
    # calling thread) — note_launch subtracts it so device seconds
    # never include compilation
    _TLS.bracket_compile_s = (
        getattr(_TLS, "bracket_compile_s", 0.0) + float(secs)
    )
    now = time.monotonic()
    storm_n, storm_w = _storm_params()
    newly_storming = False
    with _state.lock:
        _state.compiles += 1
        _state.compile_s += float(secs)
        _state.compile_triggers[trigger] = (
            _state.compile_triggers.get(trigger, 0) + 1
        )
        # only RE-compiles feed the storm window: a cold start
        # legitimately builds every kernel once ("first"), and
        # unattributed builds include the up-front builds
        if trigger in ("shape", "knobs"):
            _state.compile_times.append(now)
        cutoff = now - storm_w
        _state.compile_times = [
            t for t in _state.compile_times if t >= cutoff
        ]
        in_window = len(_state.compile_times)
        if in_window >= storm_n and not _state.storm_active:
            _state.storm_active = True
            _state.storms += 1
            newly_storming = True
    reg = get_registry()
    reg.counter(
        "tpudas_devprof_compiles_total",
        "backend compile events, by the builder-key change that "
        "triggered each (first / shape / knobs / unattributed)",
        labelnames=("trigger",),
    ).inc(trigger=trigger)
    reg.counter(
        "tpudas_devprof_compile_seconds_total",
        "wall seconds spent in backend compilation",
    ).inc(max(float(secs), 0.0))
    if newly_storming:
        reg.gauge(
            "tpudas_devprof_recompile_storm",
            "1 while >= N compiles landed inside the storm window "
            "(TPUDAS_DEVPROF_STORM, default 8/30s)",
        ).set(1.0)
        log_event(
            "devprof_recompile_storm", compiles_in_window=in_window,
            window_s=storm_w, trigger=trigger,
        )


def _storm_state() -> bool:
    """Recompute (and clear, when the window drained) the storm flag."""
    _n, storm_w = _storm_params()
    with _state.lock:
        cutoff = time.monotonic() - storm_w
        _state.compile_times = [
            t for t in _state.compile_times if t >= cutoff
        ]
        if _state.storm_active and not _state.compile_times:
            _state.storm_active = False
            get_registry().gauge(
                "tpudas_devprof_recompile_storm",
                "1 while >= N compiles landed inside the storm window "
                "(TPUDAS_DEVPROF_STORM, default 8/30s)",
            ).set(0.0)
        return _state.storm_active


def note_kernel(kind: str, shape_key, knobs) -> None:
    """Declare the cache key a dispatch site is about to run, BEFORE
    the step, on the calling thread, so a compile fired by that step is
    attributed to what changed: ``first`` (kind never seen),
    ``knobs`` (same shape, the env fingerprint moved), ``shape`` (new
    geometry).  A warm key clears the thread's trigger so unrelated
    concurrent compiles read ``unattributed`` instead of inheriting a
    stale label."""
    if not devprof_enabled():
        return
    # fresh dispatch bracket: drop compile seconds accumulated by
    # out-of-bracket work on this thread
    _TLS.bracket_compile_s = 0.0
    shape_key = tuple(shape_key) if isinstance(shape_key, (list, tuple)) \
        else (shape_key,)
    knobs = tuple(knobs) if isinstance(knobs, (list, tuple)) else (knobs,)
    key = (str(kind), shape_key, knobs)
    with _state.lock:
        if key in _state.seen_keys:
            _TLS.compile_trigger = None
            return
        _state.seen_keys.add(key)
        last = _state.last_key.get(key[0])
        if last is None:
            trigger = "first"
        elif last[1] != knobs:
            trigger = "knobs"
        else:
            trigger = "shape"
        _state.last_key[key[0]] = (shape_key, knobs)
        _state.kernel_log.append({
            "kind": key[0],
            "trigger": trigger,
            "shape": [str(p) for p in shape_key],
            "at": time.time(),
        })
        del _state.kernel_log[:-_KERNEL_LOG_LIMIT]
    _TLS.compile_trigger = trigger


# ---------------------------------------------------------------------------
# one-time cost capture


def kernel_cost(kind: str, shape_key, fn, args) -> dict | None:
    """Memoized per-key cost ``{"flops", "bytes"}``: ``fn(*args)`` is
    the kind's cost formula over the shape (it runs ONCE per key); a
    formula that raises degrades to ``None``, never an error on the
    dispatch path."""
    if not devprof_enabled():
        return None
    shape_key = tuple(shape_key) if isinstance(shape_key, (list, tuple)) \
        else (shape_key,)
    key = (str(kind), shape_key)
    with _state.lock:
        if key in _state.costs:
            return _state.costs[key]
        _state.costs[key] = None
    cost = None
    try:
        got = fn(*args)
        if got:
            cost = {
                "flops": float(got.get("flops", 0.0) or 0.0),
                "bytes": float(got.get("bytes", 0.0) or 0.0),
            }
    except Exception:
        cost = None
    with _state.lock:
        _state.costs[key] = cost
    return cost


# ---------------------------------------------------------------------------
# launch accounting


class _Bracket:
    """A CUDA step's start: the host stamp and the start event recorded
    on the device's current stream."""

    __slots__ = ("t0", "start", "device")

    def __init__(self, t0, start, device):
        self.t0 = t0
        self.start = start
        self.device = device


class _MeshBracket:
    """A sharded step's start over several cards: one :class:`_Bracket`
    per card.  The step's device seconds are the largest of the
    cards' brackets (the cards run their shards concurrently)."""

    __slots__ = ("t0", "parts")

    def __init__(self, t0, parts):
        self.t0 = t0
        self.parts = parts


def _take_event(device):
    import torch

    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _pool_lock:
        free = _event_pool.get(idx)
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _give_events(device, *events) -> None:
    import torch

    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _pool_lock:
        free = _event_pool.setdefault(idx, [])
        for ev in events:
            if len(free) < _EVENT_POOL_LIMIT:
                free.append(ev)


def launch_start(device=None):
    """The start of one step's bracket, taken immediately before the
    step: on a CUDA ``device`` a timing event recorded on its current
    stream, otherwise a ``perf_counter`` stamp (what
    :func:`note_launch` takes as ``t0``).  ``device`` may be a list (a
    sharded step's devices): each distinct card gets its own event,
    and the step counts as one launch timed by its slowest card."""
    t0 = time.perf_counter()
    if isinstance(device, (list, tuple)):
        cards = []
        for d in device:
            if getattr(d, "type", None) == "cuda" and d not in cards:
                cards.append(d)
        if len(cards) > 1 and devprof_enabled():
            return _MeshBracket(t0, [launch_start(d) for d in cards])
        device = cards[0] if cards else None
    if device is None or getattr(device, "type", None) != "cuda" \
            or not devprof_enabled():
        return t0
    import torch

    start = _take_event(device)
    start.record(torch.cuda.current_stream(device))
    return _Bracket(t0, start, device)


def _record(keys, engine: str, seconds: float, cost) -> None:
    seconds = max(float(seconds), 0.0)
    reg = get_registry()
    launches = reg.counter(
        "tpudas_devprof_launches_total",
        "device program launches by engine / stacked / stream "
        "(a stacked launch counts 1/N per member — sums are true "
        "launch counts)",
        labelnames=("engine", "stacked", "stream"),
    )
    dev_s = reg.counter(
        "tpudas_devprof_device_seconds_total",
        "dispatch-to-ready device-execute seconds by engine / "
        "stacked / stream (deferred block_until_ready deltas; a "
        "stacked launch is split 1/N per member)",
        labelnames=("engine", "stacked", "stream"),
    )
    with _state.lock:
        for stream, frac, stacked in keys:
            launches.inc(frac, engine=engine, stacked=stacked,
                         stream=stream)
            dev_s.inc(seconds * frac, engine=engine, stacked=stacked,
                      stream=stream)
            for acc_key, table in (
                ((engine, stacked, stream), _state.by_key),
                (stream, _state.by_stream),
            ):
                acc = table.get(acc_key)
                if acc is None:
                    acc = table[acc_key] = _Acc()
                acc.launches += frac
                acc.device_s += seconds * frac
                if cost:
                    acc.flops += cost["flops"] * frac
                    acc.bytes += cost["bytes"] * frac


def note_launch(engine: str, t0, out, cost=None,
                stacked: bool = False) -> None:
    """Account one step: ``t0`` is :func:`launch_start`'s value taken
    immediately before the step (or a ``perf_counter`` stamp), ``out``
    its result.  A CUDA bracket records its end event on the device's
    current stream and is parked until it has run (finalized here once
    ``Event.query()`` says so, or by :func:`round_collect`); a host
    stamp records the bracket's delta at once.  Never a block on the
    dispatch path."""
    if not devprof_enabled():
        return
    t1 = time.perf_counter()
    # a build that fired inside this bracket (cold key) ran on this
    # thread — charge it to compile accounting, not device seconds, or
    # the first launch of every kernel dwarfs steady state
    comp = getattr(_TLS, "bracket_compile_s", 0.0)
    if comp:
        _TLS.bracket_compile_s = 0.0
    keys = _attribution(stacked)
    if isinstance(t0, (_Bracket, _MeshBracket)):
        import torch

        parts = t0.parts if isinstance(t0, _MeshBracket) else (t0,)
        ends = []
        for br in parts:
            end = _take_event(br.device)
            end.record(torch.cuda.current_stream(br.device))
            ends.append(end)
        with _state.lock:
            _state.pending.append(
                [keys, str(engine), parts, ends, comp, cost]
            )
    else:
        if comp:
            t0 = min(t0 + comp, t1)
        _record(keys, str(engine), t1 - t0, cost)
    _drain_pending(block=False)


def _drain_pending(block: bool) -> None:
    """Finalize parked CUDA brackets: those whose end event has run
    (``Event.query()``) on the dispatch path, every one (waiting on each
    end event) at the round boundary."""
    with _state.lock:
        if not _state.pending:
            return
        pending, _state.pending = _state.pending, []
    kept = []
    for entry in pending:
        keys, engine, parts, ends, comp, cost = entry
        if not block and not all(end.query() for end in ends):
            kept.append(entry)
            continue
        if block:
            for end in ends:
                end.synchronize()
        seconds = max(br.start.elapsed_time(end)
                      for br, end in zip(parts, ends)) / 1e3 - comp
        for br, end in zip(parts, ends):
            _give_events(br.device, br.start, end)
        _record(keys, engine, seconds, cost)
    if kept:
        with _state.lock:
            kept.extend(_state.pending)
            _state.pending = kept


# ---------------------------------------------------------------------------
# calibration + classification


def _probe_device():
    """The card when this process has initialized CUDA (its launches
    run there), else the CPU: a process that never touched the card
    (a serving pool worker) must not open it for a probe."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.current_stream(device).synchronize()


def _calibrate_launch_floor() -> float | None:
    """Dispatch-to-ready seconds of a trivial program (``x + 1`` on an
    8 x 8 tensor) — the pure launch overhead a launch-bound stream's
    per-launch time degenerates to.  Min over a few reps; memoized."""
    try:
        import torch

        dev = _probe_device()
        x = torch.zeros((8, 8), dtype=torch.float32, device=dev)
        _ = x + 1.0  # first use outside the measurement
        _sync(dev)
        best = None
        for _ in range(5):
            t0 = time.perf_counter()
            _ = x + 1.0
            _sync(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best
    except Exception:
        return None


def _calibrate_peaks() -> tuple:
    """(flops/s, bytes/s) achievable peaks: env pins win
    (``TPUDAS_DEVPROF_PEAK_FLOPS`` / ``TPUDAS_DEVPROF_PEAK_BYTES``),
    else a one-shot 512 x 512 matmul / copy probe (host clock, the
    probe's stream synchronized)."""
    flops = bytes_s = None
    raw_f = os.environ.get("TPUDAS_DEVPROF_PEAK_FLOPS", "")
    raw_b = os.environ.get("TPUDAS_DEVPROF_PEAK_BYTES", "")
    try:
        flops = float(raw_f) if raw_f else None
    except ValueError:
        flops = None
    try:
        bytes_s = float(raw_b) if raw_b else None
    except ValueError:
        bytes_s = None
    if flops is not None and bytes_s is not None:
        return flops, bytes_s
    try:
        import torch

        dev = _probe_device()
        n = 512
        a = torch.ones((n, n), dtype=torch.float32, device=dev)
        if flops is None:
            _ = a @ a
            _sync(dev)
            t0 = time.perf_counter()
            _ = a @ a
            _sync(dev)
            dt = max(time.perf_counter() - t0, 1e-9)
            flops = (2.0 * n * n * n) / dt
        if bytes_s is None:
            _ = a * 2.0
            _sync(dev)
            t0 = time.perf_counter()
            _ = a * 2.0
            _sync(dev)
            dt = max(time.perf_counter() - t0, 1e-9)
            bytes_s = (2.0 * 4.0 * n * n) / dt
    except Exception:
        pass
    return flops, bytes_s


def launch_floor_seconds(calibrate: bool = True) -> float | None:
    with _state.lock:
        floor = _state.launch_floor
    if floor is None and calibrate:
        floor = _calibrate_launch_floor()
        with _state.lock:
            _state.launch_floor = floor
    return floor


def peak_flops(calibrate: bool = True) -> float | None:
    with _state.lock:
        pk = _state.peak_flops
    if pk is None and calibrate:
        pk, pb = _calibrate_peaks()
        with _state.lock:
            _state.peak_flops = pk
            if _state.peak_bytes is None:
                _state.peak_bytes = pb
    return pk


def peak_bytes_per_s(calibrate: bool = True) -> float | None:
    with _state.lock:
        pb = _state.peak_bytes
    if pb is None and calibrate:
        pk, pb = _calibrate_peaks()
        with _state.lock:
            _state.peak_bytes = pb
            if _state.peak_flops is None:
                _state.peak_flops = pk
    return pb


def _stream_stats(acc: _Acc, calibrate: bool) -> dict:
    """Classification + utilization for one stream's cumulative
    accumulator.  Mean per-launch seconds come out at FULL launch
    duration even for stacked members (1/N counts over 1/N seconds),
    so the launch-bound test sees what one device step costs.

    Two classification signals, in preference order:

    1. **Roofline utilization** (when a cost formula ran): device
       seconds far above what the step's FLOPs / bytes could take at
       the calibrated peaks read ``launch_bound`` below
       ``TPUDAS_DEVPROF_UTIL_BOUND`` (default 0.5) — the JAX package's
       rule, which also reads a kernel running under half its roofline
       as launch-bound.
    2. **Launch-floor ratio** (no cost data): mean launch seconds
       within ``TPUDAS_DEVPROF_LAUNCH_RATIO`` (default 25) of the
       calibrated empty-program floor is ``launch_bound``."""
    mean_launch = (
        acc.device_s / acc.launches if acc.launches > 0 else None
    )
    floor = launch_floor_seconds(calibrate=calibrate)
    ratio = bound = None
    if mean_launch is not None and floor:
        ratio = mean_launch / floor
    util = None
    pk = peak_flops(calibrate=calibrate)
    pb = peak_bytes_per_s(calibrate=calibrate)
    if acc.device_s > 0 and (pk or pb):
        roofline_s = max(
            acc.flops / pk if pk else 0.0,
            acc.bytes / pb if pb else 0.0,
        )
        util = min(max(roofline_s / acc.device_s, 0.0), 1.0)
    if util is not None and acc.flops + acc.bytes > 0:
        bound = (
            "launch_bound" if util < _util_bound_threshold()
            else "compute_bound"
        )
    elif ratio is not None:
        bound = (
            "launch_bound" if ratio < _launch_ratio_threshold()
            else "compute_bound"
        )
    out = acc.snap()
    out["mean_launch_seconds"] = (
        None if mean_launch is None else round(mean_launch, 6)
    )
    out["launch_ratio"] = None if ratio is None else round(ratio, 2)
    out["bound"] = bound
    out["utilization"] = None if util is None else round(util, 4)
    return out


def classify_stream(stream_id, calibrate: bool = True) -> dict:
    """One stream's live launch-bound vs compute-bound classification
    (empty stats → every field ``None``)."""
    with _state.lock:
        acc = _state.by_stream.get(str(stream_id))
    if acc is None:
        return _stream_stats(_Acc(), calibrate=False)
    return _stream_stats(acc, calibrate)


# ---------------------------------------------------------------------------
# round boundary + snapshot


def round_collect(stream_id=None) -> dict:
    """Finalize the parked launches (waiting on each one's end event,
    at the boundary the runner already pays) and return the stream's
    per-round delta: ``launches``, ``device_execute_s``, plus the live
    ``bound`` classification — the flight-record fields and the
    ``device_execute`` phase input.  ``{}`` when disabled."""
    if not devprof_enabled():
        return {}
    _drain_pending(block=True)
    sid = str(stream_id) if stream_id is not None else current_stream()
    with _state.lock:
        acc = _state.by_stream.get(sid)
        if acc is None:
            _state.round_base[sid] = (0.0, 0.0)
            return {"launches": 0.0, "device_execute_s": 0.0,
                    "bound": None}
        base_l, base_s = _state.round_base.get(sid, (0.0, 0.0))
        d_launches = max(acc.launches - base_l, 0.0)
        d_seconds = max(acc.device_s - base_s, 0.0)
        _state.round_base[sid] = (acc.launches, acc.device_s)
    stats = classify_stream(sid, calibrate=False)
    reg = get_registry()
    if stats["utilization"] is not None:
        reg.gauge(
            "tpudas_devprof_utilization",
            "roofline-relative device utilization estimate per stream",
            labelnames=("stream",),
        ).set(stats["utilization"], stream=sid)
    return {
        "launches": round(d_launches, 4),
        "device_execute_s": round(d_seconds, 6),
        "bound": stats["bound"],
        "utilization": stats["utilization"],
    }


def devprof_snapshot(calibrate: bool = True) -> dict:
    """The full device-telemetry snapshot (the ``GET /devprof``
    payload): launch/device-second accumulators by attribution key,
    per-stream classification + utilization, compile accounting with
    the storm state, the kernel costs, and the calibration figures.
    ``calibrate=False`` skips the one-shot probes (cheap health-path
    reads)."""
    from tpudas_torch.obs.trace import span

    with span("obs.devprof"):
        _drain_pending(block=True)
        floor = launch_floor_seconds(calibrate=calibrate)
        pk = peak_flops(calibrate=calibrate)
        pb = peak_bytes_per_s(calibrate=calibrate)
        with _state.lock:
            by_key = [
                {"engine": k[0], "stacked": k[1], "stream": k[2],
                 **acc.snap()}
                for k, acc in sorted(_state.by_key.items())
            ]
            streams = {
                sid: _stream_stats(acc, calibrate=False)
                for sid, acc in sorted(_state.by_stream.items())
            }
            compile_block = {
                "count": _state.compiles,
                "seconds": round(_state.compile_s, 6),
                "by_trigger": dict(_state.compile_triggers),
                "storms": _state.storms,
                "kernels": list(_state.kernel_log),
            }
            costs = {
                f"{kind}:{'x'.join(str(p) for p in shape)}": cost
                for (kind, shape), cost in sorted(
                    _state.costs.items(), key=lambda kv: str(kv[0])
                )
                if cost is not None
            }
            pending = len(_state.pending)
            profile = dict(_state.profile) if _state.profile else None
        compile_block["storm_active"] = _storm_state()
        # the utilization gauge rides every snapshot so dashboards see
        # it without waiting for a round boundary
        reg = get_registry()
        for sid, stats in streams.items():
            if stats["utilization"] is not None:
                reg.gauge(
                    "tpudas_devprof_utilization",
                    "roofline-relative device utilization estimate "
                    "per stream",
                    labelnames=("stream",),
                ).set(stats["utilization"], stream=sid)
        return {
            "enabled": devprof_enabled(),
            "launches": by_key,
            "streams": streams,
            "compile": compile_block,
            "costs": costs,
            "pending": pending,
            "calibration": {
                "launch_floor_s": floor,
                "peak_flops": pk,
                "peak_bytes_per_s": pb,
                "launch_ratio_threshold": _launch_ratio_threshold(),
                "util_bound_threshold": _util_bound_threshold(),
            },
            "profile": profile,
        }


# ---------------------------------------------------------------------------
# on-demand deep capture (torch.profiler)


def profiler_available() -> bool:
    try:
        from torch import profiler

        return hasattr(profiler, "profile")
    except Exception:
        return False


def profile_dir() -> str | None:
    return (
        os.environ.get("TPUDAS_PROFILE_DIR")
        or os.environ.get("TPUDAS_TRACE_DIR")
        or None
    )


def profile_status() -> dict | None:
    with _state.lock:
        return dict(_state.profile) if _state.profile else None


def _capture(target: str, seconds: float, started, failed: list) -> None:
    """The capture thread: start ``torch.profiler``, wait ``seconds``,
    stop it and write a Chrome trace into ``target`` — start and stop
    on this one thread — with every thread's spans finished meanwhile
    appended to it (the profiler records none of the other threads)."""
    import torch
    from torch.profiler import profile

    from tpudas_torch.utils.profiling import (
        SpanCapture,
        append_spans,
        profiler_activities,
        trace_path,
    )

    spans = SpanCapture()
    try:
        # the card's activity when this process runs on it
        prof = profile(activities=profiler_activities(
            torch.cuda.is_available() and torch.cuda.is_initialized()))
        prof.start()
    except Exception as exc:
        failed.append(f"{type(exc).__name__}: {str(exc)[:200]}")
        with _state.lock:
            _state.profile = None
        started.set()
        return
    started.set()
    try:
        with spans:
            time.sleep(seconds)
        prof.stop()
        path = trace_path(target)
        prof.export_chrome_trace(path)
        append_spans(path, spans.recs)
    except Exception as exc:
        log_event(
            "devprof_profile_stop_failed",
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
    finally:
        with _state.lock:
            _state.profile = None
        log_event("devprof_profile_stopped", dir=target)


def start_profile(seconds: float, out_dir=None) -> dict:
    """Run ``torch.profiler`` for ``seconds`` into ``out_dir`` (default
    ``TPUDAS_PROFILE_DIR``, falling back to ``TPUDAS_TRACE_DIR``)
    WITHOUT restarting the stream: a capture thread starts the
    profiler, waits, stops it and writes the trace — the round loop
    never blocks on the capture.  Raises ``ValueError`` on a bad
    duration / missing dir, ``RuntimeError`` when the profiler is
    unavailable or fails to start, a capture is already running, or
    the resource layer is shedding writes (ENOSPC parity: a deep
    capture is a non-essential writer)."""
    seconds = float(seconds)
    if not 0.0 < seconds <= 600.0:
        raise ValueError(
            f"profile seconds must be in (0, 600], got {seconds}"
        )
    target = str(out_dir) if out_dir else profile_dir()
    if not target:
        raise ValueError(
            "no profile directory: pass out_dir or set "
            "TPUDAS_PROFILE_DIR (TPUDAS_TRACE_DIR is the fallback)"
        )
    if not profiler_available():
        raise RuntimeError("torch.profiler is unavailable on this build")
    from tpudas_torch.integrity import resource as _resource

    if _resource.should_shed("profile"):
        raise RuntimeError(
            "resource-degraded: profile capture shed (disk pressure)"
        )
    with _state.lock:
        if _state.profile is not None:
            raise RuntimeError(
                "a profile capture is already running "
                f"({_state.profile})"
            )
        os.makedirs(target, exist_ok=True)
        info = {
            "dir": target,
            "seconds": seconds,
            "started_at": time.time(),
        }
        _state.profile = info
    started, failed = threading.Event(), []
    threading.Thread(
        target=_capture, args=(target, seconds, started, failed),
        name="tpudas-devprof-profile", daemon=True,
    ).start()
    started.wait()
    if failed:
        raise RuntimeError(f"the profiler failed to start: {failed[0]}")
    log_event("devprof_profile_started", dir=target, seconds=seconds)
    return dict(info)
