"""Zero-dependency HTTP server over processed-output folders.

The port's copy of :mod:`tpudas.serve.http`: every endpoint, header
rule and error string of the JAX server, over the port's query engine,
ledger, score store and observability plane.  Over one folder the two
servers answer with the same status, body bytes and cache/provenance
headers.  Serving is host code: nothing on a request's path touches
``torch.cuda``; ``/devprof`` and ``/profile`` read the process's
device telemetry (:mod:`tpudas_torch.obs.devprof`), whose probes and
captures touch the card only in a process that already runs on it.
Object-store mounts (``store_url`` and its knobs,
:mod:`tpudas_torch.store`) serve as the JAX server's do.

``ThreadingHTTPServer`` (stdlib, thread per connection) fronted by a
**bounded admission gate**: at most ``max_inflight`` data-plane
requests execute at once, and a request that arrives with the gate
full is shed IMMEDIATELY with ``503 + Retry-After`` instead of
queueing behind a backlog it can only deepen (graceful degradation,
the tpudas_torch.resilience posture).  Control-plane endpoints
(``/healthz``, ``/metrics``, ``/fleet/healthz``) bypass the gate — an
operator must be able to see a saturated server's health *because* it
is saturated.

One server fronts one folder, a whole fleet, or both: every
data/health endpoint below is additionally mounted per stream at
``/s/<stream_id>/...`` (``DASServer(streams={...})`` or
``DASServer.for_fleet(root)``, which mounts every non-hidden
``root/<stream_id>/`` directory), all streams share the ONE admission
gate and process registry (``/metrics`` is the merged exposition by
construction), and ``/fleet/healthz`` aggregates every stream's
``health.json`` into one operator view.

Endpoints (all GET):

- ``/query``     — windowed array read (``t0``/``t1`` ISO-8601 or ns
  ints, optional ``d0``/``d1`` distance bounds, ``resolution`` s/sample
  or ``max_samples``, ``agg`` mean|min|max, ``format`` npy|json).
- ``/waterfall`` — downsampled raster tile: same window params plus
  ``max_px`` (time-axis pixel budget, default 1024); picks the pyramid
  level from the budget and adds symmetric 95th-percentile color
  limits in ``X-Tpudas-Clim-*`` headers.
- ``/tile``      — one pyramid tile by address (``level``, ``idx``):
  the CDN-shaped read path.  Completed tiles are immutable
  and ship with a strong ETag + ``Cache-Control: public,
  max-age=31536000, immutable``; the partial head tile is
  ``no-cache``.  On a compressed store, ``Accept-Encoding: x-tpt``
  gets the stored :mod:`tpudas_torch.codec` blob verbatim.
- ``/live``      — Server-Sent-Events push of the decimated stream
  (:mod:`tpudas_torch.live`): ``hello``, a pyramid-backed
  ``snapshot`` through the same query path as ``/query``, then one
  codec-compressed ``delta`` per round; ``Last-Event-ID`` resumes.
  Requires a live producer (``TPUDAS_LIVE=1`` in-process, or a
  ``--live-bridge`` feed) — otherwise 503 + ``Retry-After``.

Every data-plane response carries a strong content-derived ``ETag``
and honors ``If-None-Match`` (``304`` with no body on a match), and
``/query``/``/waterfall`` bodies are ``deflate``-encoded when the
client asks (``Accept-Encoding: deflate``) — so a CDN/edge cache
absorbs the immutable traffic and revalidates the rest for header
cost.  See SERVING.md "CDN deployment".
- ``/events``    — the detection query plane (tpudas_torch.detect): events
  from the integrity-verified ledger filtered by time window
  (``t0``/``t1``, optional), channel range (``c0``/``c1``),
  ``min_score``, ``op``, ``kind``, capped at ``limit`` (default
  1000); ``scores=1`` additionally returns the per-channel score rows
  in the window from the score tile store.
- ``/healthz``   — the stream's last good ``health.json`` snapshot
  (``tpudas_torch.obs.health.read_health`` — the file stays the crash-safe
  source of truth; this is its live read path).
- ``/metrics``   — the LIVE process registry in Prometheus text
  exposition (the ``metrics.prom`` file snapshot remains for the
  node-exporter textfile collector).  Process-wide: in a fleet this
  is already the merged view over every stream.
- ``/s/<stream_id>/query`` (``/waterfall`` ``/events`` ``/healthz``)
  — the same endpoints scoped to one mounted stream.
- ``/fleet/healthz`` — aggregate health over every mounted stream:
  per-stream status (``ok`` / ``degraded`` / ``unknown``), counts,
  per-stream ``realtime_factor`` / ``head_lag_seconds``, the
  freshness-SLO evaluation, the fleet park/unpark event (timestamps
  included), and an overall status that is ``ok`` only when every
  stream is.
- ``/trace``      — recent spans and flight records:
  ``kind`` (default ``span``), ``name``, ``limit``.  A mounted
  folder with a flight ring serves its crash-surviving on-disk
  records; otherwise the in-memory span ring answers.  Control
  plane (bypasses the admission gate).
- ``/slo``        — per-stream freshness SLO status
  (``tpudas_torch.obs.collect``): current head-lag vs ``target`` plus the
  error-budget burn over recent flight rounds (``objective``,
  ``window``).  Control plane.

``npy`` responses carry provenance headers (``X-Tpudas-Level``,
``X-Tpudas-Step-Ns``, ``X-Tpudas-Source``, ``X-Tpudas-T0-Ns``, ...);
``json`` responses embed the same fields (NaN rows serialize as
``null``).  See SERVING.md for the endpoint reference and runbook.

Operator entry point::

    python -m tpudas_torch.serve.http <output_folder> --port 8000
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpudas_torch.codec import TILE_BLOB_SUFFIX, decode_tile, read_tile_header
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.integrity.checksum import crc32_hex
from tpudas_torch.obs.health import read_health
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import TransientFaultError, fault_point
from tpudas_torch.serve.query import QueryEngine
from tpudas_torch.utils.logging import log_event

__all__ = ["DASServer", "start_server", "serve_forever"]

_DEFAULT_MAX_INFLIGHT = 8
_DATA_ENDPOINTS = ("/query", "/waterfall", "/events", "/tile")
_DEFAULT_EVENTS_LIMIT = 1000
_DEFAULT_SCORES_LIMIT = 10000
# completed full tiles (and windows served entirely from them) can
# never change short of a pyramid rebuild: let a CDN keep them forever
_IMMUTABLE_CC = "public, max-age=31536000, immutable"
# everything touching mutable state (tails, head tile, file fallback)
# must revalidate at origin every time — the ETag makes that a 304
_MUTABLE_CC = "no-cache"
# the custom Accept-Encoding token under which /tile ships the stored
# compressed blob verbatim (self-describing tpudas_torch.codec container)
_TPT_CODING = "x-tpt"
_MIN_DEFLATE_BYTES = 256


class _Mount:
    """One mounted output folder: its query engine plus the per-mount
    ledger/score-store caches.  The root mount serves the bare
    endpoints; stream mounts serve ``/s/<stream_id>/...``.

    ``remote`` (a :class:`tpudas_torch.store.tileplane.RemotePyramid`)
    makes this a stateless serving replica: ``folder`` is the remote's
    local mirror directory, tile objects materialize lazily per query
    through the read-through cache, and the mount's whole durable state
    can be wiped and re-hydrated from the object store."""

    def __init__(self, folder, stream_id=None, cache_tiles=256,
                 engine=None, remote=None):
        self.folder = str(folder)
        self.stream_id = stream_id
        self.remote = remote
        self.engine = QueryEngine(
            self.folder, cache_tiles=cache_tiles, engine=engine,
            tile_prefetch=None if remote is None else remote.prefetch,
        )
        self._events_cache = None
        self._score_store_cache = None
        self._slo_cache = None
        self._devprof_cache = None


def _slo_status_cached(mount, policy, health=None):
    """``slo_status`` cached on the mount, keyed by the policy plus
    the newest flight segment's ``(mtime_ns, size)`` — the expensive
    part is scanning + crc-verifying the ring, and the ring only
    changes when a round flushes.  A monitor polling
    ``/fleet/healthz`` every few seconds must not re-verify megabytes
    of JSONL per stream per request (the tile/ledger caches'
    stat-gated discipline)."""
    from tpudas_torch.obs.collect import slo_status
    from tpudas_torch.obs.flight import segment_paths
    from tpudas_torch.obs.health import HEALTH_FILENAME

    def _stat_key(path):
        try:
            st = os.stat(path)
            return (path, st.st_mtime_ns, st.st_size)
        except OSError:
            return (path, None)

    segs = segment_paths(mount.folder)
    key = None
    if segs:
        # keyed on BOTH the newest flight segment and health.json: a
        # stream running with TPUDAS_FLIGHT=0 over an old ring still
        # updates health every round, and the current-lag half of the
        # SLO must track it
        key = (
            policy,
            _stat_key(segs[-1]),
            _stat_key(os.path.join(mount.folder, HEALTH_FILENAME)),
        )
        cached = mount._slo_cache
        if cached is not None and cached[0] == key:
            return cached[1]
    result = slo_status(mount.folder, policy, health=health)
    if key is not None:
        mount._slo_cache = (key, result)
    return result


def _devprof_entry_cached(mount):
    """The flight ring's devprof fold
    (:func:`tpudas_torch.obs.collect.devprof_entry`), cached on the mount
    keyed by the newest flight segment's ``(mtime_ns, size)`` — the
    same stat-gated discipline as the SLO cache, for the same reason:
    ``/fleet/healthz`` polls must not rescan the ring per request."""
    from tpudas_torch.obs.collect import devprof_entry
    from tpudas_torch.obs.flight import read_flight, segment_paths

    segs = segment_paths(mount.folder)
    if not segs:
        return None
    try:
        st = os.stat(segs[-1])
        key = (segs[-1], st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        cached = mount._devprof_cache
        if cached is not None and cached[0] == key:
            return cached[1]
    result = devprof_entry(read_flight(mount.folder, kind="round",
                                       limit=200))
    if key is not None:
        mount._devprof_cache = (key, result)
    return result


def _load_events_cached(mount):
    """The parsed + crc-verified ledger, cached on the mount keyed by
    the primary file's ``(mtime_ns, size)`` — a dashboard polling
    ``/events`` every second must not re-read and re-verify the whole
    history per request (the tile cache's discipline; here a stat
    suffices because every commit atomically replaces the file).
    Absent-primary (``.prev``-fallback) reads are not cached."""
    from tpudas_torch.detect.ledger import ledger_path, load_events

    try:
        st = os.stat(ledger_path(mount.folder))
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        cached = mount._events_cache
        if cached is not None and cached[0] == key:
            return cached[1]
    events = load_events(mount.folder)
    if key is not None:
        mount._events_cache = (key, events)
    return events


def _open_score_store_cached(mount):
    """``ScoreStore.open`` cached on the mount keyed by the scores
    manifest's ``(mtime_ns, size)`` — every commit (and truncation)
    atomically rewrites the manifest, so a stat decides freshness the
    same way :func:`_load_events_cached` does for the ledger.  Raises
    propagate uncached (the caller owns the degrade path)."""
    from tpudas_torch.detect.ledger import SCORES_MANIFEST, ScoreStore

    manifest = os.path.join(
        ScoreStore.scores_dir(mount.folder), SCORES_MANIFEST
    )
    try:
        st = os.stat(manifest)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        cached = mount._score_store_cache
        if cached is not None and cached[0] == key:
            return cached[1]
    store = ScoreStore.open(mount.folder)
    if key is not None:
        mount._score_store_cache = (key, store)
    return store


class _AdmissionGate:
    """Bounded concurrent-request gate with immediate shedding."""

    def __init__(self, limit: int):
        self.limit = max(int(limit), 1)
        self._sem = threading.BoundedSemaphore(self.limit)
        self._lock = threading.Lock()
        self.in_use = 0

    def try_enter(self) -> bool:
        try:
            # deterministic saturation for tests: an injected fault at
            # this site reads as "gate full"
            fault_point("serve.queue_full")
        except TransientFaultError:
            return False
        if not self._sem.acquire(blocking=False):
            return False
        with self._lock:
            self.in_use += 1
            depth = self.in_use
        get_registry().gauge(
            "tpudas_serve_inflight",
            "data-plane requests currently executing",
        ).set(depth)
        return True

    def leave(self) -> None:
        with self._lock:
            self.in_use -= 1
            depth = self.in_use
        self._sem.release()
        get_registry().gauge(
            "tpudas_serve_inflight",
            "data-plane requests currently executing",
        ).set(depth)


def _parse_time(raw: str):
    """ISO-8601 string or integer nanoseconds."""
    s = str(raw).strip()
    if s.lstrip("-").isdigit():
        return np.datetime64(int(s), "ns")
    return to_datetime64(s)


def _params(query: str) -> dict:
    return {
        k: v[-1] for k, v in urllib.parse.parse_qs(query).items()
    }


def _json_safe(data: np.ndarray):
    """Nested lists with NaN -> None (JSON has no NaN)."""
    out = []
    for row in np.asarray(data, dtype=np.float64):
        out.append(
            [None if not np.isfinite(v) else float(v) for v in row]
        )
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpudas-serve/1"
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------
    def log_message(self, fmt, *args):  # stdlib stderr chatter -> JSONL
        log_event("serve_access", line=(fmt % args)[:200])

    def _send(self, status: int, body: bytes, content_type: str,
              headers=()):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict, headers=()):
        body = (json.dumps(payload, indent=1) + "\n").encode()
        self._send(status, body, "application/json", headers)

    # -- HTTP caching helpers -------------------------------
    def _accepts(self, coding: str) -> bool:
        """Whether the request accepts one content-coding token —
        q-values honored, so ``deflate;q=0`` is an explicit refusal,
        not a match."""
        for item in self.headers.get("Accept-Encoding", "").split(","):
            token, _, params = item.partition(";")
            if token.strip().lower() != coding:
                continue
            q = 1.0
            for p in params.split(";"):
                k, _, v = p.partition("=")
                if k.strip().lower() == "q":
                    try:
                        q = float(v.strip())
                    except ValueError:
                        q = 0.0
            return q > 0.0
        return False

    def _maybe_deflate(self, body: bytes) -> tuple:
        """(body, extra_headers): deflate-encode a data-plane body the
        client asked for (``Accept-Encoding: deflate``) when it is
        big enough to be worth it.  ``Vary`` is always set — the
        representation depends on the request's encoding, cached
        intermediaries must key on it."""
        headers = [("Vary", "Accept-Encoding")]
        if self._accepts("deflate") and len(body) > _MIN_DEFLATE_BYTES:
            body = zlib.compress(body, 6)
            headers.append(("Content-Encoding", "deflate"))
        return body, headers

    def _send_cacheable(self, body: bytes, content_type: str,
                        headers, cache_control: str) -> int:
        """Send one data-plane representation with a strong
        content-derived ETag and the given ``Cache-Control``; answer
        the request's ``If-None-Match`` with an empty ``304`` when
        the representation is unchanged (a CDN revalidation costs
        headers, not payload bytes)."""
        etag = f'"{crc32_hex(body)}-{len(body)}"'
        headers = list(headers) + [
            ("ETag", etag), ("Cache-Control", cache_control),
        ]
        if self.headers.get("If-None-Match") == etag:
            get_registry().counter(
                "tpudas_serve_not_modified_total",
                "conditional GETs answered 304 from a matching ETag",
            ).inc()
            self._send(304, b"", content_type, headers)
            return 304
        self._send(200, body, content_type, headers)
        return 200

    # -- routing -------------------------------------------------------
    def _resolve_mount(self, path):
        """(mount_or_None, endpoint, stream_id_or_None): strips the
        ``/s/<stream_id>`` prefix to the mount it names.  ``mount``
        is None for an unknown stream id (404) — and for bare
        endpoints on a fleet-only server with no root folder."""
        endpoint = path.rstrip("/") or "/"
        if endpoint == "/fleet/healthz":
            return None, endpoint, None
        if endpoint.startswith("/s/"):
            sid, _, rest = endpoint[3:].partition("/")
            return (
                self.server.mounts.get(sid),
                "/" + rest.rstrip("/"),
                sid,
            )
        return self.server.mount, endpoint, None

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        parts = urllib.parse.urlsplit(self.path)
        mount, endpoint, stream_id = self._resolve_mount(parts.path)
        reg = get_registry()
        t_start = time.perf_counter()
        status = 500
        gated = endpoint in _DATA_ENDPOINTS
        if gated and not self.server.gate.try_enter():
            reg.counter(
                "tpudas_serve_shed_total",
                "data-plane requests shed with 503 (admission gate "
                "full)",
            ).inc()
            self._send_json(
                503,
                {"error": "server saturated, retry later"},
                headers=(("Retry-After", "1"),),
            )
            self._account(reg, endpoint, 503, t_start)
            return
        try:
            if mount is not None and mount.remote is not None and gated:
                # rate-limited manifest probe (min_refresh_s); a cold
                # tier outage flips the remote stale and the mirror
                # keeps serving
                mount.remote.refresh()
            with span(
                "serve.request", endpoint=endpoint,
                stream=stream_id or "",
            ):
                status = self._dispatch(
                    mount, endpoint, _params(parts.query), stream_id
                )
        except ValueError as exc:
            status = 400
            self._send_json(400, {"error": str(exc)[:300]})
        except Exception as exc:
            status = 500
            reg.counter(
                "tpudas_serve_errors_total",
                "requests that failed with an internal error",
                labelnames=("endpoint",),
            ).inc(endpoint=endpoint)
            log_event(
                "serve_request_failed",
                endpoint=endpoint,
                error=f"{type(exc).__name__}: {str(exc)[:300]}",
            )
            self._send_json(
                500, {"error": f"{type(exc).__name__}: {str(exc)[:300]}"}
            )
        finally:
            if gated:
                self.server.gate.leave()
            self._account(reg, endpoint, status, t_start)

    def _account(self, reg, endpoint, status, t_start):
        reg.counter(
            "tpudas_serve_requests_total",
            "HTTP requests served, by endpoint and status",
            labelnames=("endpoint", "status"),
        ).inc(endpoint=endpoint, status=status)
        reg.histogram(
            "tpudas_serve_request_seconds",
            "request latency by endpoint",
            labelnames=("endpoint",),
        ).observe(time.perf_counter() - t_start, endpoint=endpoint)

    def _dispatch(
        self, mount, endpoint: str, params: dict, stream_id=None
    ) -> int:
        if endpoint == "/fleet/healthz":
            return self._fleet_healthz()
        if endpoint == "/metrics" and stream_id is None:
            # process-wide (in a fleet: already merged over streams)
            return self._metrics()
        if stream_id is not None and mount is None:
            self._send_json(
                404,
                {"error": f"unknown stream {stream_id!r}",
                 "streams": sorted(self.server.mounts)},
            )
            return 404
        if endpoint == "/trace":
            return self._trace(mount, params, stream_id)
        if endpoint == "/slo":
            return self._slo(mount, params, stream_id)
        if endpoint == "/devprof":
            return self._devprof(params)
        if endpoint == "/profile":
            return self._profile(params)
        if endpoint in (*_DATA_ENDPOINTS, "/healthz", "/live") and (
            mount is None
        ):
            # fleet-only server, bare endpoint: point at the routes
            self._send_json(
                404,
                {"error": "no root folder mounted; use "
                          "/s/<stream_id>" + endpoint,
                 "streams": sorted(self.server.mounts)},
            )
            return 404
        if endpoint == "/healthz":
            return self._healthz(mount)
        if endpoint == "/live":
            return self._live(mount, params, stream_id)
        if endpoint == "/query":
            return self._query(mount, params, waterfall=False)
        if endpoint == "/waterfall":
            return self._query(mount, params, waterfall=True)
        if endpoint == "/events":
            return self._events(mount, params)
        if endpoint == "/tile":
            return self._tile(mount, params)
        self._send_json(404, {"error": f"unknown endpoint {endpoint!r}"})
        return 404

    # -- live push plane ------------------------------------
    def _live(self, mount, params: dict, stream_id=None) -> int:
        """``GET /live`` / ``GET /s/<id>/live`` — the SSE push
        subscription (snapshot-then-delta, see SERVING.md "Live
        subscriptions").  Deliberately NOT behind the admission gate:
        a subscription is open-ended, and thousands of them must not
        starve the bounded data plane — their cost is bounded by the
        hub's per-client queues instead."""
        from tpudas_torch.live.hub import find_hub
        from tpudas_torch.live.sse import serve_live

        hub = find_hub(
            stream_id if stream_id is not None else mount.stream_id,
            mount.folder,
        )
        if hub is None:
            self._send_json(
                503,
                {"error": "no live producer attached (run the stream "
                          "with live=True / TPUDAS_LIVE=1, or point "
                          "this server at it with live_bridge=)"},
                headers=(("Retry-After", "5"),),
            )
            return 503
        return serve_live(self, hub, mount, params)

    # -- control plane -------------------------------------------------
    @staticmethod
    def _store_block(mount):
        """The ``store`` health block for a remote-pyramid mount:
        refresh state, generation, and the read-through cache's
        hit/stale/degraded snapshot — plus whether the mount is
        currently degraded (cold tier unreachable, serving
        stale-but-verified bytes)."""
        if mount is None or mount.remote is None:
            return None, False
        snap = mount.remote.snapshot()
        degraded = bool(
            snap.get("stale")
            or (snap.get("cache") or {}).get("degraded")
        )
        snap["status"] = "degraded" if degraded else "ok"
        return snap, degraded

    def _healthz(self, mount) -> int:
        payload = read_health(mount.folder)
        store_block, store_degraded = self._store_block(mount)
        if payload is None:
            if store_block is not None:
                # a stateless serving replica has no realtime health
                # snapshot; its liveness IS the store plane's
                self._send_json(
                    200,
                    {"status": (
                        "degraded" if store_degraded else "ok"
                    ),
                     "detail": "serving replica (no local realtime "
                               "health snapshot)",
                     "store": store_block},
                )
                return 200
            self._send_json(
                503,
                {"status": "unknown",
                 "detail": "no health snapshot yet (is the stream "
                           "running with TPUDAS_HEALTH=1?)"},
            )
            return 503
        body = dict(payload)
        body["status"] = (
            "degraded" if payload.get("degraded") or store_degraded
            else "ok"
        )
        if store_block is not None:
            body["store"] = store_block
        self._send_json(200, body)
        return 200

    def _fleet_healthz(self) -> int:
        """Aggregate health over every mounted stream: the fleet
        operator's one-stop liveness view.  Per-stream entries use
        the SAME health→entry mapping and worst-first status ranking
        as ``tpudas_torch.obs.collect`` (``ok`` < ``at_risk`` < ``unknown``
        < ``degraded``/``violating``), folding in each stream's
        freshness-SLO status — so this endpoint and
        ``tpudas_torch/tools/obs_report.py`` can never disagree; overall is ``ok``
        only when every stream's health AND SLO are.  Always 200 when
        at least one stream is mounted — a degraded fleet must still
        be inspectable — and 503 with no mounts at all."""
        mounts = self.server.mounts
        if not mounts:
            self._send_json(
                503,
                {"status": "unknown",
                 "detail": "no streams mounted (fleet routes need "
                           "DASServer(streams=...) or .for_fleet)"},
            )
            return 503
        from tpudas_torch.obs.collect import (
            SLOPolicy,
            health_entry,
            worst_status,
        )

        policy = SLOPolicy()
        streams = {}
        counts = {"ok": 0, "degraded": 0, "unknown": 0}
        slo_counts: dict = {}
        for sid in sorted(mounts):
            payload = read_health(mounts[sid].folder)
            entry = health_entry(payload)
            status = entry["status"]
            entry["slo"] = _slo_status_cached(
                mounts[sid], policy, health=payload
            )
            # device telemetry column: bound classification
            # + roofline utilization from the stream's flight ring
            dev = _devprof_entry_cached(mounts[sid])
            if dev is not None:
                entry["devprof"] = dev
            slo_counts[entry["slo"]["status"]] = (
                slo_counts.get(entry["slo"]["status"], 0) + 1
            )
            counts[status] += 1
            streams[sid] = entry
        # the SAME worst-first ranking over health AND SLO statuses as
        # tpudas_torch.obs.collect.fleet_rollup — the HTTP monitor and
        # the obs_report tool must never disagree about the fleet
        overall = worst_status(
            [e["status"] for e in streams.values()]
            + [e["slo"]["status"] for e in streams.values()]
        )
        self._send_json(
            200,
            {"status": overall, "streams": streams, "counts": counts,
             "slo_counts": slo_counts},
        )
        return 200

    def _metrics(self) -> int:
        text = get_registry().to_prometheus()
        self._send(
            200, text.encode(), "text/plain; version=0.0.4; charset=utf-8"
        )
        return 200

    def _trace(self, mount, params: dict, stream_id=None) -> int:
        """Recent spans (and other flight records), filterable — the
        operator's post-hoc "what was the stream doing" view.  A mounted folder with a flight ring serves its
        crash-surviving on-disk records; otherwise the process's
        in-memory span ring answers.  Control plane: bypasses the
        admission gate like ``/healthz`` — tracing a saturated server
        is the point."""
        from tpudas_torch.obs.flight import read_flight, segment_paths
        from tpudas_torch.obs.trace import get_spans

        kind = params.get("kind", "span")
        name = params.get("name") or None
        limit = int(params.get("limit", 256))
        if limit < 1:
            raise ValueError(f"limit must be positive, got {limit}")
        limit = min(limit, 5000)
        with span("serve.trace", stream=stream_id or ""):
            if mount is not None and segment_paths(mount.folder):
                records = read_flight(
                    mount.folder, kind=kind or None, name=name,
                    limit=limit,
                )
                source = "flight"
            else:
                records = get_spans(name)
                if kind and kind != "span":
                    records = []
                records = records[-limit:]
                source = "ring"
        self._send_json(
            200,
            {"source": source, "kind": kind or None, "name": name,
             "count": len(records), "records": records},
        )
        return 200

    def _slo(self, mount, params: dict, stream_id=None) -> int:
        """Per-stream freshness SLO status (tpudas_torch.obs.collect): the
        current head-lag vs target plus the error-budget burn over
        the flight ring's recent rounds.  Bare on a fleet server =
        every mounted stream; scoped = one stream."""
        from tpudas_torch.obs.collect import SLOPolicy, worst_status

        window = int(params.get("window", 200))
        if window < 1:
            raise ValueError(f"window must be positive, got {window}")
        objective = float(params.get("objective", 0.99))
        if not 0.0 < objective <= 1.0:
            raise ValueError(
                f"objective must be in (0, 1], got {objective}"
            )
        policy = SLOPolicy(
            head_lag_target_s=(
                float(params["target"]) if "target" in params else None
            ),
            objective=objective,
            window=window,
        )
        with span("serve.slo", stream=stream_id or ""):
            if stream_id is not None or (
                mount is not None and not self.server.mounts
            ):
                payload = _slo_status_cached(mount, policy)
            else:
                streams = {
                    sid: _slo_status_cached(m, policy)
                    for sid, m in sorted(self.server.mounts.items())
                }
                if mount is not None:
                    streams["."] = _slo_status_cached(mount, policy)
                payload = {
                    "status": worst_status(
                        e["status"] for e in streams.values()
                    ),
                    "streams": streams,
                }
        self._send_json(200, payload)
        return 200

    def _devprof(self, params: dict) -> int:
        """Device telemetry snapshot: per-kernel launch and device
        seconds, compile / recompile-storm state, the kernel costs and
        the live launch-bound vs compute-bound classification per
        stream.  Process-wide (the device is shared) and control plane:
        bypasses the admission gate — profiling a saturated server is
        the point."""
        from tpudas_torch.obs import devprof

        calibrate = str(params.get("calibrate", "1")).lower() not in (
            "0", "false", "no",
        )
        self._send_json(
            200, devprof.devprof_snapshot(calibrate=calibrate)
        )
        return 200

    def _profile(self, params: dict) -> int:
        """Time-boxed ``torch.profiler`` trace into TPUDAS_PROFILE_DIR
        without restarting the stream: ``?seconds=N`` starts one,
        bare ``/profile`` reports status.  501 when the profiler is
        unavailable in this runtime, 409 while a capture is already
        running, 503 when disk pressure sheds the write (or the
        profiler fails to start)."""
        from tpudas_torch.obs import devprof

        if "seconds" not in params:
            self._send_json(200, devprof.profile_status())
            return 200
        if not devprof.profiler_available():
            self._send_json(
                501,
                {"error": "torch.profiler is unavailable in this "
                          "runtime; install a torch build with profiler "
                          "support or inspect /devprof instead"},
            )
            return 501
        seconds = float(params["seconds"])
        out_dir = params.get("dir") or None
        try:
            info = devprof.start_profile(seconds, out_dir=out_dir)
        except RuntimeError as exc:
            status = 409 if "already" in str(exc).lower() else 503
            self._send_json(status, {"error": str(exc)[:300]})
            return status
        self._send_json(200, info)
        return 200

    # -- data plane ----------------------------------------------------
    def _events(self, mount, params: dict) -> int:
        """The detection query plane: integrity-verified ledger events
        (and optionally score rows) filtered by time/channel window,
        score floor, operator and kind."""
        t0_ns = (
            int(np.datetime64(_parse_time(params["t0"]), "ns")
                .astype(np.int64))
            if "t0" in params else None
        )
        t1_ns = (
            int(np.datetime64(_parse_time(params["t1"]), "ns")
                .astype(np.int64))
            if "t1" in params else None
        )
        c0 = int(params["c0"]) if "c0" in params else None
        c1 = int(params["c1"]) if "c1" in params else None
        min_score = (
            float(params["min_score"]) if "min_score" in params else None
        )
        op = params.get("op")
        kind = params.get("kind")
        limit = int(params.get("limit", _DEFAULT_EVENTS_LIMIT))
        if limit < 1:
            raise ValueError(f"limit must be positive, got {limit}")
        scores_limit = int(
            params.get("scores_limit", _DEFAULT_SCORES_LIMIT)
        )
        if scores_limit < 1:
            raise ValueError(
                f"scores_limit must be positive, got {scores_limit}"
            )
        with span("serve.events"):
            events = _load_events_cached(mount)
            total = len(events)
            picked = []
            # scan newest-first so the cap keeps the events happening
            # NOW (the scores cap's discipline); chronological order
            # is restored below
            for ev in reversed(events):
                if t0_ns is not None and int(ev.get("t_ns", 0)) < t0_ns:
                    continue
                if t1_ns is not None and int(ev.get("t_ns", 0)) >= t1_ns:
                    continue
                ch = int(ev.get("channel", -1))
                if c0 is not None and ch < c0:
                    continue
                if c1 is not None and ch > c1:
                    continue
                if min_score is not None and float(
                    ev.get("score", 0.0)
                ) < min_score:
                    continue
                if op is not None and ev.get("op") != op:
                    continue
                if kind is not None and ev.get("kind") != kind:
                    continue
                picked.append(ev)
                if len(picked) >= limit:
                    break
            picked.reverse()
            payload = {
                "events": picked,
                "count": len(picked),
                "ledger_events": total,
            }
            if params.get("scores") == "1":
                try:
                    store = _open_score_store_cached(mount)
                except Exception as exc:
                    # an unreconcilable score store (the fsck's reset
                    # case) must degrade the scores track, not fail a
                    # response whose events were perfectly readable
                    log_event(
                        "serve_events_scores_unavailable",
                        error=f"{type(exc).__name__}: {str(exc)[:200]}",
                    )
                    store = None
                if store is None:
                    payload["scores"] = None
                else:
                    s_t, s_v = store.read(t0_ns, t1_ns)
                    rows_total = int(s_t.shape[0])
                    if rows_total > scores_limit:
                        # bound the response: keep the NEWEST rows in
                        # the window (what a live dashboard wants)
                        s_t = s_t[-scores_limit:]
                        s_v = s_v[-scores_limit:]
                    vals = s_v
                    ch_lo = 0
                    if c0 is not None or c1 is not None:
                        ch_lo = max(0, c0 or 0)
                        ch_hi = (
                            min(vals.shape[1] - 1, c1)
                            if c1 is not None else vals.shape[1] - 1
                        )
                        vals = vals[:, ch_lo:ch_hi + 1]
                    payload["scores"] = {
                        "times_ns": [int(t) for t in s_t],
                        "channel0": int(ch_lo),
                        "values": _json_safe(vals),
                        "rows_total": rows_total,
                        "truncated": rows_total > scores_limit,
                    }
        reg = get_registry()
        reg.counter(
            "tpudas_serve_events_queries_total",
            "/events queries answered from the verified ledger",
        ).inc()
        # events are live mutable state: origin-only, but still ETag-
        # revalidatable (a polling dashboard's unchanged ledger costs
        # headers, not the serialized event list)
        body = (json.dumps(payload, indent=1) + "\n").encode()
        return self._send_cacheable(
            body, "application/json",
            [("X-Tpudas-Events-Total", total)], _MUTABLE_CC,
        )

    def _tile(self, mount, params: dict) -> int:
        """One pyramid tile by address (``level``, ``idx``) — the
        CDN-shaped read path.  A COMPLETED tile is
        immutable by construction, so it ships with a strong ETag and
        ``Cache-Control: immutable``: an edge cache absorbs every
        repeat read forever.  The trailing PARTIAL tile is the
        mutable hot path and stays ``no-cache`` (revalidated at
        origin per request).  Under a compressed store a client that
        advertises ``Accept-Encoding: x-tpt`` gets the stored
        :mod:`tpudas_torch.codec` blob verbatim (zero-copy off disk,
        self-describing — decode client-side); everyone else gets
        decoded raw ``.npy`` bytes."""
        from tpudas_torch.serve.tiles import AGGS

        if "level" not in params or "idx" not in params:
            raise ValueError(
                "level and idx query parameters are required"
            )
        level = int(params["level"])
        idx = int(params["idx"])
        if level < 0 or idx < 0:
            raise ValueError("level and idx must be non-negative")
        store = mount.engine._refresh_store()
        if store is None or store.head_ns is None:
            self._send_json(
                404, {"error": "no tile pyramid in this folder"}
            )
            return 404
        n_level = store.n(level) if level < store.n_levels else 0
        valid = min(store.tile_len, n_level - idx * store.tile_len)
        if valid <= 0:
            self._send_json(
                404,
                {"error": f"tile L{level}/{idx} is beyond the "
                          f"pyramid head",
                 "levels": list(store.levels),
                 "tile_len": int(store.tile_len)},
            )
            return 404
        if mount.remote is not None and valid == store.tile_len:
            # materialize the addressed completed-tile object into the
            # mirror (read-through cached; no-op when already local —
            # the partial head tile serves from mirrored tails)
            mount.remote._fetch_tile(store, level, idx)
        headers = [
            ("X-Tpudas-Level", level),
            ("X-Tpudas-Tile", idx),
            ("X-Tpudas-Valid-Rows", valid),
            ("X-Tpudas-Codec", store.codec or "raw"),
            ("Vary", "Accept-Encoding"),
        ]
        if valid == store.tile_len:
            path = store.resolve_tile_path(level, idx)
            if path is None:
                raise FileNotFoundError(
                    f"manifest references tile L{level}/{idx} but no "
                    "tile file exists (corrupt store)"
                )
            with open(path, "rb") as fh:
                blob = fh.read()
            # verify BEFORE the immutable header: a torn/bit-rotted
            # tile served with max-age=31536000 poisons a CDN for a
            # year — every other read path takes the corrupt-store
            # ladder, this one must too
            if path.endswith(TILE_BLOB_SUFFIX):
                from tpudas_torch.codec import verify_tile_blob
                from tpudas_torch.serve.tiles import CorruptStoreError

                if verify_tile_blob(blob) != "ok":
                    raise CorruptStoreError(
                        f"tile L{level}/{idx} failed its embedded "
                        "crc32 check — run tools/fsck.py to rebuild"
                    )
                if self._accepts(_TPT_CODING):
                    # stored compressed blob, verbatim: the cheapest
                    # possible origin read, and what a CDN should cache
                    return self._send_cacheable(
                        blob, "application/x-tpudas-tile",
                        headers + [("Content-Encoding", _TPT_CODING)],
                        _IMMUTABLE_CC,
                    )
                arr = decode_tile(blob)
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(arr))
                body = buf.getvalue()
            else:
                # raw .npy bytes ARE the representation — after the
                # sidecar-crc gate (raises CorruptStoreError -> 500)
                store._verify_tile(path)
                body = blob
            return self._send_cacheable(
                body, "application/x-npy", headers, _IMMUTABLE_CC
            )
        # the growing head tile: serve its current rows, never cache
        tile = store._load_tile(level, idx)
        arr = (
            tile["mean"] if level == 0
            else np.stack([tile[agg] for agg in AGGS], axis=0)
        )
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr))
        return self._send_cacheable(
            buf.getvalue(), "application/x-npy", headers, _MUTABLE_CC
        )

    def _query(self, mount, params: dict, waterfall: bool) -> int:
        if "t0" not in params or "t1" not in params:
            raise ValueError("t0 and t1 query parameters are required")
        t0 = _parse_time(params["t0"])
        t1 = _parse_time(params["t1"])
        dist = None
        if "d0" in params or "d1" in params:
            dist = (
                float(params["d0"]) if "d0" in params else None,
                float(params["d1"]) if "d1" in params else None,
            )
        agg = params.get("agg", "mean")
        if waterfall:
            max_samples = int(params.get("max_px", 1024))
            resolution = None
        else:
            max_samples = (
                int(params["max_samples"]) if "max_samples" in params
                else None
            )
            resolution = (
                float(params["resolution"]) if "resolution" in params
                else None
            )
        result = mount.engine.query(
            t0, t1, distance=dist, resolution=resolution,
            max_samples=max_samples, agg=agg,
        )
        headers = [
            ("X-Tpudas-Level", result.level),
            ("X-Tpudas-Step-Ns", result.step_ns),
            ("X-Tpudas-Agg", result.agg),
            ("X-Tpudas-Source", result.source),
            ("X-Tpudas-Samples", result.n_samples),
            ("X-Tpudas-Channels", result.distance.size),
        ]
        if result.n_samples:
            headers.append(
                ("X-Tpudas-T0-Ns",
                 int(result.times[0].astype("datetime64[ns]")
                     .astype(np.int64)))
            )
        if waterfall:
            from tpudas_torch.viz.waterfall import _symmetric_clip

            lo, hi = _symmetric_clip(result.data)
            headers += [
                ("X-Tpudas-Clim-Lo", repr(float(lo))),
                ("X-Tpudas-Clim-Hi", repr(float(hi))),
            ]
        cache_control = (
            _IMMUTABLE_CC if result.immutable else _MUTABLE_CC
        )
        if params.get("format", "npy") == "json":
            body = (json.dumps(
                {
                    "times_ns": [
                        int(t) for t in
                        result.times.astype("datetime64[ns]")
                        .astype(np.int64)
                    ],
                    "distance": [float(d) for d in result.distance],
                    "data": _json_safe(result.data),
                    "level": result.level,
                    "step_ns": result.step_ns,
                    "agg": result.agg,
                    "source": result.source,
                },
                indent=1,
            ) + "\n").encode()
            content_type = "application/json"
        else:
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(result.data))
            body = buf.getvalue()
            content_type = "application/x-npy"
        body, enc_headers = self._maybe_deflate(body)
        return self._send_cacheable(
            body, content_type, headers + enc_headers, cache_control
        )


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the stdlib default listen backlog (5) makes a thundering herd
    # pay 1-second SYN retransmits long before the admission gate
    # even sees the request; shedding is the GATE's job, done with an
    # explicit 503, not silent kernel queue drops
    request_queue_size = 128

    def __init__(self, addr, mount, mounts, gate, reuse_port=False):
        self.mount = mount  # root _Mount or None (fleet-only server)
        self.mounts = dict(mounts)  # stream_id -> _Mount
        self.gate = gate
        # SO_REUSEPORT lets N worker PROCESSES bind the same port and
        # have the kernel load-balance accepted connections across
        # them — the tpudas_torch.serve.pool horizontal-scale mechanism
        # (the crash-only tile format already makes concurrent
        # readers safe, so workers share the store read-only)
        self._reuse_port = bool(reuse_port)
        super().__init__(addr, _Handler)

    def server_bind(self):
        if self._reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError(
                    "SO_REUSEPORT is not available on this platform; "
                    "run single-process or front workers with a "
                    "balancer"
                )
            self.socket.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
            )
        super().server_bind()

    @property
    def folder(self):  # legacy accessor (pre-fleet single-folder API)
        return None if self.mount is None else self.mount.folder


class DASServer:
    """Lifecycle wrapper: background thread + context manager.

    ``port=0`` binds an ephemeral port (tests); :attr:`base_url` gives
    the bound address either way.

    ``folder`` mounts one output folder on the bare endpoints
    (``/query``, ``/healthz``, ...); ``streams`` (a
    ``{stream_id: folder}`` mapping) additionally mounts each stream
    at ``/s/<stream_id>/...`` and enables ``/fleet/healthz``.  Either
    may be omitted; :meth:`for_fleet` builds the ``streams`` mapping
    from a fleet root's directory layout.  All mounts share one
    admission gate and the one process registry.

    ``store_url`` (+ ``store_prefix``) mounts an object-store pyramid
    instead of (or on top of) a local folder: the server becomes a
    stateless serving replica that hydrates a local mirror through a
    read-through cache (``cache_dir``/``cache_bytes``), probes the
    remote manifest at most every ``store_refresh_s`` seconds before
    data queries, and keeps serving the mirror (flagged ``degraded`` in
    ``/healthz``'s ``store`` block) when the cold tier is unreachable.
    A ``replica:urlA,urlB,...`` store URL serves through a
    :class:`~tpudas_torch.store.replica.ReplicatedStore` — reads fail
    over primary → mirrors → the cache's stale-but-verified rung, and
    the ``store`` block of ``/healthz`` grows a ``replication`` entry
    (mirror list, handoff backlog, failover/divergence counts, last
    scrub).
    """

    def __init__(self, folder=None, host="127.0.0.1", port=0,
                 max_inflight=_DEFAULT_MAX_INFLIGHT, cache_tiles=256,
                 engine=None, streams=None, reuse_port=False,
                 store_url=None, store_prefix="", cache_dir=None,
                 cache_bytes=None, store_refresh_s=1.0,
                 live_bridge=None):
        if folder is None and not streams and store_url is None:
            raise ValueError(
                "DASServer needs a folder, streams, or a store_url"
            )
        self.remote = None
        if store_url is not None:
            # stateless serving replica: hydrate a local mirror and a
            # read-through cache from the object store; `folder` (when
            # given) IS the mirror directory, otherwise a private temp
            # dir — either can be wiped freely
            import tempfile

            from tpudas_torch.store import (
                ReadThroughCache,
                RemotePyramid,
                store_from_url,
            )

            base = (
                str(cache_dir) if cache_dir is not None
                else tempfile.mkdtemp(prefix="tpudas-serve-store-")
            )
            cache_kwargs = (
                {} if cache_bytes is None
                else {"max_bytes": int(cache_bytes)}
            )
            cache = ReadThroughCache(
                os.path.join(base, "cache"), **cache_kwargs
            )
            mirror = (
                str(folder) if folder is not None
                else os.path.join(base, "mirror")
            )
            self.remote = RemotePyramid(
                store_from_url(store_url), store_prefix, cache,
                mirror, min_refresh_s=float(store_refresh_s),
            )
            self.remote.refresh(force=True)
            folder = mirror
        self.folder = None if folder is None else str(folder)
        mount = (
            None if folder is None
            else _Mount(folder, cache_tiles=cache_tiles, engine=engine,
                        remote=self.remote)
        )
        mounts = {}
        for sid, sfolder in (streams or {}).items():
            sid = str(sid)
            mounts[sid] = _Mount(
                sfolder, stream_id=sid, cache_tiles=cache_tiles,
                engine=engine,
            )
        # legacy attribute: the root mount's engine (None on a
        # fleet-only server); per-stream engines live on the mounts
        self.query_engine = None if mount is None else mount.engine
        self.mounts = mounts
        self._httpd = _Server(
            (host, int(port)), mount, mounts,
            _AdmissionGate(max_inflight), reuse_port=reuse_port,
        )
        self._thread = None
        # live push plane: when the producer runs in a DIFFERENT
        # process (a ServePool worker), the local hub registry is
        # empty — `live_bridge` names the producer's LiveBridge
        # address and a BridgeSubscriber feeds mirrored hubs that
        # `/live` then serves from
        self.live_bridge = live_bridge
        self._bridge_sub = None

    @classmethod
    def for_fleet(cls, root, **kwargs):
        """A server over a fleet root: every non-hidden subdirectory
        is mounted as a stream at ``/s/<name>/...`` (the
        ``FleetEngine`` layout — see FLEET.md).  ``folder=`` may be
        passed through to also mount a root folder on the bare
        endpoints."""
        from tpudas_torch.integrity.audit import fleet_stream_dirs

        streams = dict(fleet_stream_dirs(root))
        if not streams:
            raise ValueError(
                f"no stream folders found under fleet root {root!r}"
            )
        return cls(streams=streams, **kwargs)

    @property
    def address(self):
        return self._httpd.server_address[:2]

    @property
    def base_url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def _start_bridge(self) -> None:
        if self.live_bridge and self._bridge_sub is None:
            from tpudas_torch.live.sse import BridgeSubscriber

            self._bridge_sub = BridgeSubscriber(self.live_bridge).start()

    def start(self) -> "DASServer":
        self._start_bridge()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpudas-serve",
            daemon=True,
        )
        self._thread.start()
        log_event("serve_started", url=self.base_url, folder=self.folder)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._bridge_sub is not None:
            self._bridge_sub.stop()
            self._bridge_sub = None

    def __enter__(self) -> "DASServer":
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False


def start_server(folder, **kwargs) -> DASServer:
    """Start a :class:`DASServer` on a background thread; returns it
    (use as a context manager or call ``.stop()``)."""
    return DASServer(folder, **kwargs).start()


def serve_forever(folder, host="0.0.0.0", port=8000, fleet=False,
                  **kwargs) -> None:
    """Blocking operator entry point (Ctrl-C to stop).  ``fleet=True``
    treats ``folder`` as a fleet root and mounts every stream at
    ``/s/<stream_id>/...`` (plus ``/fleet/healthz``)."""
    if fleet:
        server = DASServer.for_fleet(folder, host=host, port=port,
                                     **kwargs)
        print(
            f"tpudas_torch.serve listening on {server.base_url} over fleet "
            f"root {folder} (streams: {', '.join(sorted(server.mounts))})"
        )
    else:
        server = DASServer(folder, host=host, port=port, **kwargs)
        print(
            f"tpudas_torch.serve listening on {server.base_url} over {folder}"
        )
    try:
        server._start_bridge()
        server._httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server._httpd.server_close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve processed DAS output over HTTP "
                    "(/query /waterfall /healthz /metrics; with "
                    "--fleet also /s/<stream>/... and /fleet/healthz)"
    )
    ap.add_argument("folder",
                    help="processed output folder (or, with --fleet, "
                         "the fleet root whose subdirectories are the "
                         "streams)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-inflight", type=int,
                    default=_DEFAULT_MAX_INFLIGHT)
    ap.add_argument("--cache-tiles", type=int, default=256)
    ap.add_argument("--fleet", action="store_true",
                    help="serve a fleet root: mount every "
                         "<root>/<stream_id>/ at /s/<stream_id>/...")
    ap.add_argument("--store-url", default=None,
                    help="serve a remote pyramid from this object "
                         "store (file:///path, s3://bucket/..., "
                         "fake:tag); FOLDER becomes the local mirror")
    ap.add_argument("--store-prefix", default="",
                    help="stream prefix inside the store")
    ap.add_argument("--cache-dir", default=None,
                    help="NVMe read-through cache directory "
                         "(default: private temp dir)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="read-through cache budget in bytes")
    ap.add_argument("--live-bridge", default=None,
                    help="subscribe to a producer's live bridge at "
                         "host:port (TPUDAS_LIVE_BRIDGE on the "
                         "producer) so /live serves its streams")
    args = ap.parse_args(argv)
    kwargs = {}
    if args.live_bridge:
        kwargs["live_bridge"] = args.live_bridge
    if args.store_url:
        if args.fleet:
            ap.error("--store-url and --fleet are mutually exclusive")
        kwargs.update(
            store_url=args.store_url, store_prefix=args.store_prefix,
            cache_dir=args.cache_dir, cache_bytes=args.cache_bytes,
        )
    serve_forever(
        args.folder, host=args.host, port=args.port,
        max_inflight=args.max_inflight, cache_tiles=args.cache_tiles,
        fleet=args.fleet, **kwargs,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
