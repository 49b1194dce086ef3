"""SSE serving loop + the ServePool socket bridge.

The port's copy of :mod:`tpudas.live.sse`.  The bridge's wire bytes
(header line, raw int64 times, the level-0 ``deflate`` blob) are the
JAX package's, so either package's worker mirrors either package's
producer.

Two transports over one hub:

- :func:`serve_live` — the ``GET /live`` handler body: SSE handshake
  (``hello``), snapshot-or-replay, then the per-round ``delta`` loop
  off one bounded :class:`~tpudas_torch.live.hub.Subscription`.  Long-lived
  connections bypass the data-plane admission gate (they would pin it
  forever); the hub's subscriber cap is their own shed point.
- :class:`LiveBridge` / :class:`BridgeSubscriber` — the producing
  process binds a local socket bridge and every ``ServePool`` worker
  subscribes once, republishing each frame into its own in-process
  hub; one round feeds N worker processes' SSE clients without the
  producer knowing any of them.  Bridge frames reuse the producer's
  level-0 lossless encoding verbatim (no decode+re-encode per worker);
  a stalled worker connection sheds its oldest queued frame — the
  bridge is as backpressure-free as the hub it taps.

The serving loop writes with a socket timeout: a client that stops
reading stalls only its own handler thread until the degrade ladder
drops it (or the write times out), never the round loop.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque

import numpy as np

from tpudas_torch.live.hub import (
    DEGRADE_FACTOR,
    LiveFrame,
    LiveHub,
    hub_keys,
    register_hub,
)
from tpudas_torch.live.protocol import (
    DEFAULT_CODEC,
    delta_event,
    resume_frames,
    snapshot_event,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.logging import log_event

__all__ = [
    "BridgeSubscriber",
    "LiveBridge",
    "ensure_bridge",
    "format_sse",
    "serve_live",
]

_DEFAULT_WINDOW_S = 60.0
_DEFAULT_HEARTBEAT_S = 15.0
_DEFAULT_WRITE_TIMEOUT_S = 30.0


def format_sse(event: str, data: dict, event_id=None) -> bytes:
    """One Server-Sent-Events frame (``id:``/``event:``/``data:``)."""
    lines = []
    if event_id is not None:
        lines.append(f"id: {int(event_id)}")
    lines.append(f"event: {event}")
    lines.append(
        "data: " + json.dumps(data, separators=(",", ":"))
    )
    return ("\n".join(lines) + "\n\n").encode()


def _codec_params(params: dict) -> tuple:
    codec_id = str(params.get("codec", DEFAULT_CODEC))
    cparams = {}
    if "max_error" in params:
        cparams["max_error"] = float(params["max_error"])
    return codec_id, cparams


def _maybe_snapshot(hub, mount, window_s, seq, codec_id, cparams,
                    reason, resolution=None, max_samples=None):
    """The connect/gap backfill, or None when there is nothing to
    backfill (no frame yet / no mount) or the query fails (counted;
    the client still gets deltas — degraded, not broken)."""
    if window_s <= 0 or mount is None:
        return None
    last = hub.latest_frame()
    if last is None:
        return None
    times = last.level_times(0)
    if not times.size:
        return None
    end_ns = int(times[-1])
    t0 = np.datetime64(end_ns - int(window_s * 1e9), "ns")
    t1 = np.datetime64(end_ns, "ns")
    try:
        return snapshot_event(
            mount.engine, t0, t1, seq, resolution=resolution,
            max_samples=max_samples, codec_id=codec_id,
            reason=reason, **cparams,
        )
    except Exception as exc:
        log_event(
            "live_snapshot_failed", hub=hub.key,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        return None


def serve_live(handler, hub: LiveHub, mount, params: dict) -> int:
    """The ``GET /live`` request body: runs for the connection's
    lifetime on the handler's thread.  Query params: ``level`` (start
    resolution level), ``window`` (snapshot seconds, 0 disables),
    ``codec``/``max_error`` (delta encoding), ``resolution``/
    ``max_samples`` (snapshot level pick), ``heartbeat`` (keepalive
    seconds), ``last_id`` (resume; the ``Last-Event-ID`` header
    wins), ``max_frames`` (close after N deltas — test/bench hook),
    ``write_timeout`` (stalled-socket cutoff seconds)."""
    reg = get_registry()
    codec_id, cparams = _codec_params(params)
    window_s = float(params.get("window", _DEFAULT_WINDOW_S))
    heartbeat = float(params.get("heartbeat", _DEFAULT_HEARTBEAT_S))
    max_frames = int(params.get("max_frames", 0))
    write_timeout = float(
        params.get("write_timeout", _DEFAULT_WRITE_TIMEOUT_S)
    )
    resolution = (
        float(params["resolution"]) if "resolution" in params else None
    )
    max_samples = (
        int(params["max_samples"]) if "max_samples" in params else None
    )
    last_id = handler.headers.get("Last-Event-ID")
    if last_id is None:
        last_id = params.get("last_id")
    sub = hub.subscribe(level=int(params.get("level", 0)))
    if sub is None:
        handler._send_json(
            503,
            {"error": "live subscriber cap reached, retry later"},
            headers=(("Retry-After", "1"),),
        )
        return 503
    try:
        handler.connection.settimeout(max(write_timeout, 0.1))
        handler.close_connection = True
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        w = handler.wfile
        start_seq = hub.head_seq()
        w.write(format_sse("hello", {
            "stream": hub.key,
            "seq": start_seq,
            "level": sub.level,
            "max_level": sub.max_level,
            "depth": sub.depth,
            "degrade_factor": DEGRADE_FACTOR,
            "codec": codec_id,
        }))
        delivered_seq = 0
        replay = (
            resume_frames(hub, last_id) if last_id is not None else None
        )
        if replay:
            for fr in replay:
                w.write(format_sse(
                    "delta",
                    delta_event(fr, sub.level, codec_id, **cparams),
                    event_id=fr.seq,
                ))
                delivered_seq = fr.seq
        elif replay is None:
            snap = _maybe_snapshot(
                hub, mount, window_s, start_seq, codec_id, cparams,
                reason="gap" if last_id is not None else "connect",
                resolution=resolution, max_samples=max_samples,
            )
            if snap is not None:
                w.write(format_sse("snapshot", snap))
                # the snapshot window covers every frame through the
                # handshake head: skip queued duplicates
                delivered_seq = start_seq
        w.flush()
        n_sent = 0
        while True:
            if sub.dropped is not None:
                w.write(format_sse("drop", {"reason": sub.dropped}))
                w.flush()
                break
            frame = sub.next(timeout=heartbeat)
            if frame is None:
                if sub.dropped is not None:
                    continue
                w.write(b": keepalive\n\n")
                w.flush()
                continue
            if frame.seq <= delivered_seq:
                continue
            w.write(format_sse(
                "delta",
                delta_event(frame, sub.level, codec_id, **cparams),
                event_id=frame.seq,
            ))
            w.flush()
            hub.note_fanout(
                time.perf_counter() - frame.published_perf
            )
            reg.counter(
                "tpudas_live_frames_sent_total",
                "delta frames written to live clients",
            ).inc()
            delivered_seq = frame.seq
            n_sent += 1
            if max_frames and n_sent >= max_frames:
                break
        return 200
    except (BrokenPipeError, ConnectionResetError, socket.timeout,
            OSError):
        # the client went away (or stalled past the write timeout):
        # normal lifecycle, not a server error
        return 200
    finally:
        hub.unsubscribe(sub)


# ---------------------------------------------------------------------------
# the ServePool bridge: producer-side fan-out socket

def _frame_wire(hub: LiveHub, frame: LiveFrame) -> bytes:
    """One frame as header-line + raw times + level-0 blob."""
    times = frame.level_times(0)
    times_raw = np.ascontiguousarray(times, np.int64).tobytes()
    blob = frame.payload(0, "deflate")
    header = json.dumps({
        "keys": hub_keys(hub) or [hub.key],
        "seq": frame.seq,
        "round": frame.round,
        "step_ns": frame.step_ns,
        "published_unix_ns": frame.published_unix_ns,
        "events": frame.events,
        "times_len": len(times_raw),
        "blob_len": len(blob),
    }, separators=(",", ":")).encode() + b"\n"
    return header + times_raw + blob


class _BridgeConn:
    """One worker connection: a bounded frame queue + writer thread
    (queue full sheds the oldest frame, counted — the bridge never
    buffers unboundedly either)."""

    def __init__(self, bridge, sock):
        self.bridge = bridge
        self.sock = sock
        self._q: deque = deque()
        self._cond = threading.Condition()
        self.alive = True
        self._thread = threading.Thread(
            target=self._run, name="tpudas-live-bridge-conn",
            daemon=True,
        )
        self._thread.start()

    def offer(self, payload: bytes) -> None:
        with self._cond:
            if not self.alive:
                return
            if len(self._q) >= self.bridge.depth:
                self._q.popleft()
                get_registry().counter(
                    "tpudas_live_frames_dropped_total",
                    "queued frames shed, by reason",
                    labelnames=("reason",),
                ).inc(reason="bridge")
            self._q.append(payload)
            self._cond.notify()

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    if not self._q:
                        self._cond.wait(1.0)
                    if not self.alive:
                        return
                    if not self._q:
                        continue
                    payload = self._q.popleft()
                self.sock.sendall(payload)
        except OSError:
            pass
        finally:
            self.close()
            self.bridge._reap(self)

    def close(self) -> None:
        with self._cond:
            self.alive = False
            self._cond.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass


class LiveBridge:
    """Producer-side fan-out socket: bind, accept worker connections,
    and tap every hub publish in this process (installed as a
    :class:`LiveHub` sink by :meth:`start`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 depth: int = 64):
        self.host = str(host)
        self.port = int(port)
        self.depth = int(depth)
        self._listener = None
        self._accept_thread = None
        self._conns: list = []
        self._lock = threading.Lock()

    def start(self) -> "LiveBridge":
        self._listener = socket.create_server(
            (self.host, self.port), backlog=16
        )
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tpudas-live-bridge",
            daemon=True,
        )
        self._accept_thread.start()
        if self._broadcast not in LiveHub._sinks:
            LiveHub._sinks.append(self._broadcast)
        log_event("live_bridge_started", host=self.host, port=self.port)
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            with self._lock:
                self._conns.append(_BridgeConn(self, sock))

    def _broadcast(self, hub: LiveHub, frame: LiveFrame) -> None:
        with self._lock:
            conns = list(self._conns)
        if not conns:
            return
        payload = _frame_wire(hub, frame)
        for conn in conns:
            conn.offer(payload)

    def _reap(self, conn) -> None:
        with self._lock:
            try:
                self._conns.remove(conn)
            except ValueError:
                pass

    def stop(self) -> None:
        try:
            LiveHub._sinks.remove(self._broadcast)
        except ValueError:
            pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            conn.close()


_BRIDGE = None
_BRIDGE_LOCK = threading.Lock()


def _parse_addr(addr) -> tuple:
    s = str(addr)
    if ":" in s:
        host, _, port = s.rpartition(":")
        return host or "127.0.0.1", int(port)
    return "127.0.0.1", int(s)


def ensure_bridge(addr=None) -> LiveBridge:
    """The process-wide producer bridge (one per process; the address
    comes from ``addr`` or ``TPUDAS_LIVE_BRIDGE`` — ``host:port`` or
    a bare port, port 0 picks ephemeral)."""
    global _BRIDGE
    with _BRIDGE_LOCK:
        if _BRIDGE is not None:
            return _BRIDGE
        if addr is None:
            addr = os.environ.get("TPUDAS_LIVE_BRIDGE", "0")
        host, port = _parse_addr(addr)
        _BRIDGE = LiveBridge(host, port).start()
        return _BRIDGE


# ---------------------------------------------------------------------------
# the worker side: subscribe to a producer bridge, republish locally

class BridgeSubscriber:
    """One worker process's feed: connect to the producer's
    :class:`LiveBridge`, read frames, and inject each into the local
    hub registered under the producer's keys.  Reconnects with backoff
    forever (the producer restarting is normal life)."""

    def __init__(self, address, retry_s: float = 1.0):
        self.host, self.port = _parse_addr(address)
        self.retry_s = float(retry_s)
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "BridgeSubscriber":
        self._thread = threading.Thread(
            target=self._run, name="tpudas-live-bridge-sub",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                with socket.create_connection(
                    (self.host, self.port), timeout=10.0
                ) as sock:
                    sock.settimeout(None)
                    self._consume(sock)
            except OSError:
                pass
            self._stop.wait(self.retry_s)

    def _consume(self, sock) -> None:
        rf = sock.makefile("rb")
        while not self._stop.is_set():
            line = rf.readline()
            if not line:
                return
            head = json.loads(line)
            times_raw = rf.read(int(head["times_len"]))
            blob = rf.read(int(head["blob_len"]))
            if times_raw is None or blob is None:
                return
            times = np.frombuffer(times_raw, np.int64)
            frame = LiveFrame(
                head["seq"], head["round"], times, None,
                head.get("events") or (), head.get("step_ns") or 0,
                preset_blob=blob,
                published_unix_ns=head.get("published_unix_ns"),
            )
            hub = register_hub(*head["keys"])
            hub.inject(frame)
