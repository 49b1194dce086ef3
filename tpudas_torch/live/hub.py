"""Per-stream live hub: bounded fan-out of round frames.

The port's copy of :mod:`tpudas.live.hub`: the same frames, ladder,
ring, registry and ``TPUDAS_LIVE_*`` defaults, host code only (numpy
and threads; the round's rows come off the card in the emit capture).

One :class:`LiveHub` sits between a stream's round loop and its
subscribers.  The round loop calls :meth:`LiveHub.publish` once per
processed round with the round's emit-captured output patches and the
detect ledger's new events; the hub turns them into ONE immutable
:class:`LiveFrame` (monotonic ``seq``), keeps a small replay ring for
``Last-Event-ID`` resume, and offers the frame to every subscriber's
**bounded** queue.

The contract that makes this safe to run inside the round loop:

- ``publish`` is O(rows + subscribers) with no blocking calls — a
  subscriber can NEVER slow the producer down (the admission gate's
  shed-don't-queue rule applied to push).
- A full subscriber queue triggers the **degrade ladder**: the
  subscriber's resolution level is bumped one coarser step and the
  oldest queued frame is shed (counted,
  ``tpudas_live_frames_dropped_total{reason="degraded"}``); a
  subscriber already at the coarsest level is dropped outright
  (``tpudas_live_subscribers_dropped_total{reason="slow"}``).  The
  ladder is deterministic: depth D and max level M give a
  never-reading client exactly D queued frames, M degrade steps, then
  the drop.
- The hub holds **no durable state**: a crash loses nothing the disk
  did not already have, so retry == restart byte-identity of the
  round loop is untouched by any number of attached clients.

Frames carry the round's decimated rows at level 0 and derive coarser
levels (time-axis block means, factor :data:`DEGRADE_FACTOR` per
level) plus their codec encodings lazily, cached per frame — one
encode serves every subscriber at that (level, codec).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.logging import log_event

__all__ = [
    "DEGRADE_FACTOR",
    "LiveFrame",
    "LiveHub",
    "Subscription",
    "find_hub",
    "get_hub",
    "register_hub",
    "reset_hubs",
]

# time-axis reduction per degrade level (level L = factor**L rows per
# output row) — matches the pyramid's coarsening idea without needing
# the on-disk store
DEGRADE_FACTOR = 4
_DEFAULT_DEPTH = 8        # TPUDAS_LIVE_DEPTH
_DEFAULT_RING = 64        # TPUDAS_LIVE_RING
_DEFAULT_MAX_LEVEL = 2    # TPUDAS_LIVE_MAX_LEVEL
_DEFAULT_MAX_SUBS = 4096  # TPUDAS_LIVE_MAX_SUBS
# rolling per-client fan-out latency window feeding the flight
# record's fanout_p99_s and /slo (bounded: never grows with clients)
_FANOUT_WINDOW = 1024


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw else int(default)


def _reduce_rows(data: np.ndarray, factor: int) -> np.ndarray:
    """Time-axis block mean with a partial tail block (live frames
    have arbitrary row counts, unlike the tile store's conditioned
    full blocks)."""
    if factor <= 1:
        return data
    t = int(data.shape[0])
    full = t // factor
    parts = []
    if full:
        parts.append(
            data[: full * factor]
            .reshape(full, factor, *data.shape[1:])
            .mean(axis=1)
        )
    if t % factor:
        parts.append(data[full * factor:].mean(axis=0, keepdims=True))
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return np.asarray(out, np.float32)


class LiveFrame:
    """One round's immutable push frame.

    ``times``/``data`` are the level-0 decimated rows (int64 ns,
    float32 time-major).  ``payload(level, codec_id, **params)``
    returns the codec blob of the level's reduction, cached so a
    thousand subscribers at the same (level, codec) share one encode.
    A bridge-received frame may start with only the level-0 blob
    (``data=None``); the rows are decoded on first derived use."""

    __slots__ = (
        "seq", "round", "t0_ns", "step_ns", "times", "data", "events",
        "published_unix_ns", "published_perf", "_payloads", "_lock",
    )

    def __init__(self, seq, rnd, times, data, events, step_ns,
                 preset_blob=None, published_unix_ns=None):
        self.seq = int(seq)
        self.round = int(rnd)
        self.times = None if times is None else np.asarray(
            times, np.int64)
        self.data = None if data is None else np.asarray(
            data, np.float32)
        self.t0_ns = (
            int(self.times[0]) if self.times is not None
            and self.times.size else 0
        )
        self.step_ns = int(step_ns)
        self.events = list(events or ())
        self.published_unix_ns = (
            int(published_unix_ns) if published_unix_ns is not None
            else time.time_ns()
        )
        self.published_perf = time.perf_counter()
        self._payloads: dict = {}
        self._lock = threading.Lock()
        if preset_blob is not None:
            # bridge path: the producer's level-0 lossless encoding is
            # reused verbatim (no decode+re-encode per worker)
            self._payloads[(0, "deflate", ())] = bytes(preset_blob)

    # -- level derivation ----------------------------------------------
    def _ensure_data(self) -> None:
        if self.data is not None:
            return
        blob = self._payloads.get((0, "deflate", ()))
        if blob is None:
            # event-only frame (a round that emitted no rows but did
            # append ledger events): zero rows, still deliverable
            self.data = np.zeros((0, 0), np.float32)
            return
        from tpudas_torch.codec import decode_tile

        self.data = np.asarray(decode_tile(blob), np.float32)

    def n_rows(self) -> int:
        if self.data is not None:
            return int(self.data.shape[0])
        return 0 if self.times is None else int(self.times.size)

    def level_array(self, level: int) -> np.ndarray:
        self._ensure_data()
        return _reduce_rows(self.data, DEGRADE_FACTOR ** int(level))

    def level_times(self, level: int) -> np.ndarray:
        """First source timestamp of each reduced block."""
        if self.times is None:
            self._ensure_data()
            n = self.data.shape[0]
            times = self.t0_ns + self.step_ns * np.arange(n, dtype=np.int64)
        else:
            times = self.times
        f = DEGRADE_FACTOR ** int(level)
        if f <= 1:
            return times
        n_out = (times.size + f - 1) // f
        return times[::f][:n_out]

    def payload(self, level: int, codec_id: str = "deflate",
                **params) -> bytes:
        """The level's rows as one self-describing codec blob, cached
        per (level, codec, params)."""
        key = (int(level), str(codec_id),
               tuple(sorted(params.items())))
        with self._lock:
            blob = self._payloads.get(key)
            if blob is not None:
                return blob
        from tpudas_torch.codec import encode_tile

        arr = self.level_array(level)
        blob = encode_tile(arr, codec_id, **params)
        with self._lock:
            return self._payloads.setdefault(key, blob)


class Subscription:
    """One client's bounded frame queue + its degrade-ladder state.

    ``offer`` is the producer side (never blocks, never exceeds
    ``depth``); ``next`` is the consumer side (condition wait with
    timeout).  ``dropped`` is the terminal reason string once the
    ladder ran out or the hub shed the client."""

    __slots__ = (
        "hub", "level", "depth", "max_level", "dropped", "degrades",
        "shed_frames", "_q", "_cond",
    )

    def __init__(self, hub, level: int, depth: int, max_level: int):
        self.hub = hub
        self.level = int(level)
        self.depth = max(int(depth), 1)
        self.max_level = int(max_level)
        self.dropped = None
        self.degrades = 0
        self.shed_frames = 0
        self._q: deque = deque()
        self._cond = threading.Condition()

    def qsize(self) -> int:
        with self._cond:
            return len(self._q)

    def offer(self, frame: LiveFrame) -> str:
        """Producer side: ``queued`` | ``degraded`` | ``dropped`` |
        ``dead`` (already dropped).  O(1), never blocks."""
        with self._cond:
            if self.dropped is not None:
                return "dead"
            if len(self._q) < self.depth:
                self._q.append(frame)
                self._cond.notify()
                return "queued"
            if self.level < self.max_level:
                # degrade ladder rung: coarser from here on; shed the
                # OLDEST queued frame (the client wants the newest
                # picture — the seq gap is resumable by protocol)
                self.level += 1
                self.degrades += 1
                self._q.popleft()
                self.shed_frames += 1
                self._q.append(frame)
                self._cond.notify()
                return "degraded"
            # ladder exhausted: the client cannot keep up at the
            # coarsest level — drop it, never queue unboundedly
            self.dropped = "slow"
            self.shed_frames += len(self._q)
            self._q.clear()
            self._cond.notify()
            return "dropped"

    def next(self, timeout: float = None) -> LiveFrame | None:
        """Consumer side: the next frame, or None on timeout/drop
        (check :attr:`dropped`)."""
        with self._cond:
            if not self._q:
                self._cond.wait(timeout)
            if self._q:
                return self._q.popleft()
            return None

    def kill(self, reason: str) -> None:
        with self._cond:
            if self.dropped is None:
                self.dropped = str(reason)
            self._q.clear()
            self._cond.notify_all()


class LiveHub:
    """One stream's publish/fan-out hub (see the module docstring)."""

    # process-wide publish taps (the ServePool LiveBridge): each is
    # called ``sink(hub, frame)`` after the in-process fan-out; a
    # raising sink is counted and swallowed — same discipline as an
    # emit listener, a read-side consumer never breaks the producer
    _sinks: list = []

    def __init__(self, key: str, queue_depth=None, ring=None,
                 max_level=None, max_subscribers=None):
        self.key = str(key)
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else _env_int("TPUDAS_LIVE_DEPTH", _DEFAULT_DEPTH)
        )
        self.max_level = int(
            max_level if max_level is not None
            else _env_int("TPUDAS_LIVE_MAX_LEVEL", _DEFAULT_MAX_LEVEL)
        )
        self.max_subscribers = int(
            max_subscribers if max_subscribers is not None
            else _env_int("TPUDAS_LIVE_MAX_SUBS", _DEFAULT_MAX_SUBS)
        )
        ring_n = int(
            ring if ring is not None
            else _env_int("TPUDAS_LIVE_RING", _DEFAULT_RING)
        )
        self._ring: deque = deque(maxlen=max(ring_n, 1))
        self._subs: list = []
        self._lock = threading.Lock()
        self.seq = 0
        self.step_ns = None
        # cumulative fan-out accounting (round_record deltas these)
        self.published = 0
        self.frames_dropped = 0
        self.degrades = 0
        self.subs_dropped = 0
        self._fanout_s: deque = deque(maxlen=_FANOUT_WINDOW)
        self._last_totals = (0, 0, 0, 0)

    # -- subscriber lifecycle ------------------------------------------
    def subscribe(self, level: int = 0,
                  depth: int = None) -> Subscription | None:
        """A new bounded subscription, or None when the hub is at its
        subscriber cap (the caller sheds with a 503 — counted here)."""
        level = min(max(int(level), 0), self.max_level)
        sub = Subscription(
            self, level,
            self.queue_depth if depth is None else depth,
            self.max_level,
        )
        reg = get_registry()
        with self._lock:
            if len(self._subs) >= self.max_subscribers:
                reg.counter(
                    "tpudas_live_subscribers_dropped_total",
                    "live subscribers removed, by reason",
                    labelnames=("reason",),
                ).inc(reason="capacity")
                return None
            self._subs.append(sub)
            n = len(self._subs)
        reg.gauge(
            "tpudas_live_subscribers",
            "currently attached live subscribers",
        ).set(n)
        return sub

    def unsubscribe(self, sub: Subscription,
                    reason: str = "client_gone") -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                return
            n = len(self._subs)
        reg = get_registry()
        if sub.dropped is None:
            sub.kill(reason)
        reg.counter(
            "tpudas_live_subscribers_dropped_total",
            "live subscribers removed, by reason",
            labelnames=("reason",),
        ).inc(reason=sub.dropped)
        self.subs_dropped += 1
        reg.gauge(
            "tpudas_live_subscribers",
            "currently attached live subscribers",
        ).set(n)

    def n_subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- publish -------------------------------------------------------
    def publish(self, rnd: int, patches, events=()) -> dict:
        """Turn one round's emit capture + new events into a frame and
        fan it out.  Returns the round's fan-out stats."""
        times, rows = _patches_rows(patches)
        if times is None and not events:
            return {"published": 0, "subscribers": self.n_subscribers()}
        step_ns = self.step_ns
        if times is not None and times.size > 1:
            step_ns = int(times[1] - times[0])
            self.step_ns = step_ns
        with span("live.publish", round=rnd):
            with self._lock:
                self.seq += 1
                frame = LiveFrame(
                    self.seq, rnd, times, rows, events,
                    step_ns or 0,
                )
                self._ring.append(frame)
            return self._fanout(frame)

    def inject(self, frame: LiveFrame) -> dict | None:
        """Bridge path: adopt a producer-built frame (its ``seq`` is
        authoritative).  Stale/duplicate sequences are ignored so two
        bridge feeds cannot double-publish."""
        with self._lock:
            if frame.seq <= self.seq:
                return None
            self.seq = frame.seq
            if frame.step_ns:
                self.step_ns = frame.step_ns
            self._ring.append(frame)
        return self._fanout(frame)

    def _fanout(self, frame: LiveFrame) -> dict:
        reg = get_registry()
        with self._lock:
            subs = list(self._subs)
        outcomes = {"queued": 0, "degraded": 0, "dropped": 0, "dead": 0}
        with span("live.fanout", subscribers=len(subs), seq=frame.seq):
            for sub in subs:
                outcomes[sub.offer(frame)] += 1
        self.published += 1
        reg.counter(
            "tpudas_live_frames_published_total",
            "round frames published into the live plane",
        ).inc()
        if outcomes["degraded"]:
            self.degrades += outcomes["degraded"]
            self.frames_dropped += outcomes["degraded"]
            reg.counter(
                "tpudas_live_degrades_total",
                "subscriber degrade-ladder steps taken (queue full -> "
                "one coarser level)",
            ).inc(outcomes["degraded"])
            reg.counter(
                "tpudas_live_frames_dropped_total",
                "queued frames shed, by reason",
                labelnames=("reason",),
            ).inc(outcomes["degraded"], reason="degraded")
        if outcomes["dropped"]:
            reg.counter(
                "tpudas_live_frames_dropped_total",
                "queued frames shed, by reason",
                labelnames=("reason",),
            ).inc(outcomes["dropped"], reason="slow_drop")
            self.frames_dropped += outcomes["dropped"]
            # the ladder dropped them mid-fanout; reap from the roster
            for sub in subs:
                if sub.dropped is not None:
                    self.unsubscribe(sub, reason=sub.dropped)
        for sink in list(LiveHub._sinks):
            try:
                sink(self, frame)
            except Exception as exc:
                reg.counter(
                    "tpudas_live_publish_errors_total",
                    "live publish/sink callbacks that raised "
                    "(swallowed; the round loop is never poisoned)",
                ).inc()
                log_event(
                    "live_sink_failed", hub=self.key,
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
        stats = {
            "published": 1,
            "seq": frame.seq,
            "subscribers": len(subs),
            **outcomes,
        }
        if outcomes["degraded"] or outcomes["dropped"]:
            log_event(
                "live_fanout_shed", hub=self.key, seq=frame.seq,
                degraded=outcomes["degraded"],
                dropped=outcomes["dropped"],
            )
        return stats

    # -- resume / reads ------------------------------------------------
    def head_seq(self) -> int:
        with self._lock:
            return self.seq

    def latest_frame(self) -> LiveFrame | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def frames_since(self, last_seq: int) -> list | None:
        """Replay frames after ``last_seq`` from the ring, or None
        when the gap predates the ring (the caller falls back to a
        fresh snapshot)."""
        last_seq = int(last_seq)
        with self._lock:
            if last_seq >= self.seq:
                return []
            if not self._ring or self._ring[0].seq > last_seq + 1:
                return None
            return [f for f in self._ring if f.seq > last_seq]

    # -- observability -------------------------------------------------
    def note_fanout(self, seconds: float) -> None:
        """One delivered frame's publish->client-write latency (the
        SSE loop reports it); feeds the histogram, the flight record
        and /slo."""
        s = max(float(seconds), 0.0)
        self._fanout_s.append(s)
        get_registry().histogram(
            "tpudas_live_fanout_seconds",
            "per-client latency from frame publish to the client "
            "socket write completing",
        ).observe(s)

    def fanout_p99(self) -> float | None:
        window = list(self._fanout_s)
        if not window:
            return None
        return float(np.percentile(np.asarray(window), 99))

    def round_record(self) -> dict:
        """The per-round live block for the flight record: deltas of
        the cumulative fan-out accounting since the previous round,
        plus the rolling fan-out P99."""
        totals = (
            self.published, self.frames_dropped, self.degrades,
            self.subs_dropped,
        )
        prev = self._last_totals
        self._last_totals = totals
        p99 = self.fanout_p99()
        return {
            "subscribers": self.n_subscribers(),
            "published": totals[0] - prev[0],
            "dropped_frames": totals[1] - prev[1],
            "degrades": totals[2] - prev[2],
            "dropped_subscribers": totals[3] - prev[3],
            "fanout_p99_s": None if p99 is None else round(p99, 6),
        }

    def close(self, reason: str = "hub_closed") -> None:
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            self.unsubscribe(sub, reason=reason)


def _patches_rows(patches):
    """Concatenate the round's emit-captured patches into one
    time-major (t_ns, rows) pair (the detect runner's conversion,
    shared so live frames and detect see identical rows)."""
    if not patches:
        return None, None
    from tpudas_torch.detect.runner import _emitted_blocks

    blocks = _emitted_blocks(patches, None)
    if not blocks:
        return None, None
    times = np.concatenate([t for t, _ in blocks])
    rows = np.concatenate([d for _, d in blocks])
    return times, rows


# ---------------------------------------------------------------------------
# the in-process hub registry: how the serve plane finds the producer

_HUBS: dict = {}
_HUBS_LOCK = threading.Lock()


def register_hub(*keys, **kwargs) -> LiveHub:
    """One hub registered under every given key (a stream id and/or an
    absolute output-folder path).  Re-registering a key returns the
    existing hub — a restarted runner reattaches, subscribers keep
    their stream."""
    norm = [str(k) for k in keys if k]
    if not norm:
        raise ValueError("register_hub needs at least one key")
    with _HUBS_LOCK:
        for k in norm:
            hub = _HUBS.get(k)
            if hub is not None:
                for k2 in norm:
                    _HUBS[k2] = hub
                return hub
        hub = LiveHub(norm[0], **kwargs)
        for k in norm:
            _HUBS[k] = hub
        return hub


def get_hub(key) -> LiveHub | None:
    with _HUBS_LOCK:
        return _HUBS.get(str(key))


def hub_keys(hub: LiveHub) -> list:
    """Every registry key this hub is reachable under (the bridge
    forwards them so worker processes mirror the registration)."""
    with _HUBS_LOCK:
        return [k for k, v in _HUBS.items() if v is hub]


def find_hub(stream_id=None, folder=None) -> LiveHub | None:
    """Mount-side lookup: by stream id first, then by the mount's
    absolute folder path (the two keys the runner registers)."""
    for key in (
        stream_id,
        None if folder is None else os.path.abspath(str(folder)),
    ):
        if key:
            hub = get_hub(key)
            if hub is not None:
                return hub
    return None


def reset_hubs() -> None:
    """Test hook: drop every registered hub (closing their
    subscribers)."""
    with _HUBS_LOCK:
        items = list(_HUBS.values())
        _HUBS.clear()
    seen = set()
    for hub in items:
        if id(hub) not in seen:
            seen.add(id(hub))
            hub.close()
