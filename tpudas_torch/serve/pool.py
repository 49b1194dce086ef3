"""Horizontally scaled serving: an N-process worker pool over one
shared read-only store.

The port's copy of :mod:`tpudas.serve.pool`.  One
``ThreadingHTTPServer`` process is bound by one interpreter's GIL: more
threads buy concurrency but not CPU.  The crash-only tile format
already makes concurrent READERS safe (immutable full tiles, atomic
tails/manifest replaces, stat-gated refresh), so horizontal scale is
just more processes over the same bytes:

- **Workers**: N child processes (spawned, so no forked locks), each
  running a full :class:`tpudas_torch.serve.http.DASServer` bound to
  the SAME data port via ``SO_REUSEPORT`` — the kernel load-balances
  accepted connections across the listening sockets, no proxy hop,
  no fd passing.  Each worker additionally binds a private ephemeral
  **control port** for its own ``/metrics``.  Serving is host code: a
  worker imports no kernel module and never creates a CUDA context.
- **Pool control plane**: the parent binds ``control_port`` and
  serves ``/metrics`` — every worker's process registry merged into
  one exposition, each sample tagged ``worker="<i>"`` — plus
  ``/healthz`` / ``/pool/healthz``, the aggregate liveness rollup
  (``ok`` only when every worker process is alive and scrapeable).

Per-worker caches are independent by design: a tile decoded in
worker 0 is decoded again on first touch in worker 1.  That is the
stateless-worker property that makes the pool trivially scalable —
the shared cache tier is the CDN/edge cache the immutable-tile HTTP
headers (:mod:`tpudas_torch.serve.http`) are built for, not process
memory.  With ``store_url`` each worker is a stateless replica that
hydrates its own mirror and read-through cache from the object store
(:mod:`tpudas_torch.store`).

Operator entry point (see also ``tpudas_torch/tools/serve_pool.py``)::

    python -m tpudas_torch.serve.pool /data/out --port 8000 --workers 8
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.logging import log_event

__all__ = ["ServePool", "merge_prometheus", "main"]

_DEFAULT_WORKERS = 2
_SCRAPE_TIMEOUT_S = 5.0


def has_reuse_port() -> bool:
    """Whether this platform can run the pool at all (Linux/BSD yes;
    the tests skip where it cannot)."""
    return hasattr(socket, "SO_REUSEPORT")


# ---------------------------------------------------------------------------
# prometheus merge

def _label_sample(line: str, worker: str) -> str:
    """One exposition sample line with a ``worker`` label injected
    (first position, so existing labels survive verbatim)."""
    head, _, value = line.rpartition(" ")
    if not head:
        return line
    if "{" in head:
        name, _, rest = head.partition("{")
        return f'{name}{{worker="{worker}",{rest} {value}'
    return f'{head}{{worker="{worker}"}} {value}'


def merge_prometheus(texts: dict) -> str:
    """Merge ``{worker_id: exposition_text}`` into one exposition:
    ``# HELP``/``# TYPE`` metadata deduplicated, every sample tagged
    with its ``worker`` label.  Nothing is summed — cross-worker
    aggregation is the scraper's job (PromQL ``sum without(worker)``),
    and collapsing here would destroy the per-worker balance view the
    pool exists to expose."""
    out: list = []
    seen_meta: set = set()
    for worker in sorted(texts):
        for line in texts[worker].splitlines():
            if line.startswith("#"):
                if line not in seen_meta:
                    seen_meta.add(line)
                    out.append(line)
                continue
            if line.strip():
                out.append(_label_sample(line, str(worker)))
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# the worker process

def _worker_main(cfg: dict, report_q) -> None:
    """One pool worker: a full DASServer on the SHARED data port
    (``SO_REUSEPORT``) plus a private control DASServer on an
    ephemeral port for per-worker ``/metrics``.  Runs until the
    parent terminates the process (crash-only: workers hold no
    durable state, the store on disk is the only truth)."""
    # serving needs no accelerator: nothing on the server's import or
    # request path touches torch.cuda, so the worker holds no CUDA
    # context
    from tpudas_torch.serve.http import DASServer

    kwargs = dict(
        host=cfg["host"],
        max_inflight=cfg["max_inflight"],
        cache_tiles=cfg["cache_tiles"],
    )
    if cfg.get("store_url"):
        # stateless replica workers: each worker hydrates its OWN
        # mirror + read-through cache from the object store — workers
        # share nothing but the store (and whatever CDN sits in front)
        base = cfg.get("cache_dir")
        kwargs.update(
            store_url=cfg["store_url"],
            store_prefix=cfg.get("store_prefix", ""),
            cache_dir=(
                os.path.join(base, f"worker{cfg['index']}")
                if base else None
            ),
            cache_bytes=cfg.get("cache_bytes"),
        )
    dkw = dict(kwargs)
    if cfg.get("live_bridge"):
        # live push plane: ONLY the data server subscribes
        # to the producer's bridge — a second subscriber on the
        # control server would double the bridge fan-out for nothing
        # (hub.inject dedups by sequence, but why pay the bytes)
        dkw["live_bridge"] = cfg["live_bridge"]
    if cfg["fleet"]:
        data = DASServer.for_fleet(
            cfg["folder"], port=cfg["port"], reuse_port=True, **dkw
        )
        control = DASServer.for_fleet(cfg["folder"], port=0, **kwargs)
    elif cfg.get("store_url"):
        data = DASServer(
            cfg["folder"], port=cfg["port"], reuse_port=True, **dkw
        )
        # the control plane serves /metrics from THIS process's
        # registry; mount the data server's mirror rather than build
        # a second remote (one store plane per worker)
        control = DASServer(
            data.folder, port=0, host=cfg["host"],
            max_inflight=cfg["max_inflight"],
            cache_tiles=cfg["cache_tiles"],
        )
    else:
        data = DASServer(
            cfg["folder"], port=cfg["port"], reuse_port=True, **dkw
        )
        control = DASServer(cfg["folder"], port=0, **kwargs)
    control.start()
    data.start()
    report_q.put({
        "worker": int(cfg["index"]),
        "pid": os.getpid(),
        "data_port": int(data.address[1]),
        "control_port": int(control.address[1]),
        "ready_unix": time.time(),
    })
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


# ---------------------------------------------------------------------------
# the pool control plane

class _PoolHandler(BaseHTTPRequestHandler):
    server_version = "tpudas-serve-pool/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log_event("serve_pool_access", line=(fmt % args)[:200])

    def _send(self, status, body: bytes, ctype: str):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        pool = self.server.pool
        path = self.path.split("?")[0].rstrip("/") or "/"
        if path == "/metrics":
            self._send(
                200, pool.merged_metrics().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path in ("/healthz", "/pool/healthz"):
            payload = pool.health()
            self._send(
                200 if payload["status"] == "ok" else 503,
                (json.dumps(payload, indent=1) + "\n").encode(),
                "application/json",
            )
        else:
            self._send(
                404,
                (json.dumps({
                    "error": f"unknown pool endpoint {path!r}",
                    "endpoints": ["/metrics", "/healthz",
                                  "/pool/healthz"],
                }) + "\n").encode(),
                "application/json",
            )


class _PoolControlServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, pool):
        self.pool = pool
        super().__init__(addr, _PoolHandler)


class ServePool:
    """Lifecycle wrapper for the worker pool: context manager or
    ``.start()``/``.stop()``.  ``port=0`` picks a free shared data
    port; ``control_port=0`` an ephemeral control port (tests)."""

    def __init__(self, folder=None, host="127.0.0.1", port=8000,
                 workers=_DEFAULT_WORKERS, control_port=0, fleet=False,
                 max_inflight=8, cache_tiles=256,
                 start_timeout=120.0, max_restarts=5,
                 restart_backoff=0.5, supervise=True,
                 store_url=None, store_prefix="", cache_dir=None,
                 cache_bytes=None, live_bridge=None):
        if not has_reuse_port():
            raise OSError(
                "SO_REUSEPORT is not available on this platform; "
                "the serve pool needs it to share one data port"
            )
        if folder is None and store_url is None:
            raise ValueError("ServePool needs a folder or a store_url")
        self.folder = None if folder is None else str(folder)
        self.host = str(host)
        self.workers = int(workers)
        if self.workers < 1:
            raise ValueError(f"need >= 1 worker, got {workers}")
        self.fleet = bool(fleet)
        self._cfg = dict(
            folder=self.folder, host=self.host, fleet=self.fleet,
            max_inflight=int(max_inflight),
            cache_tiles=int(cache_tiles),
            live_bridge=None if live_bridge is None else str(live_bridge),
            store_url=store_url, store_prefix=str(store_prefix),
            cache_dir=None if cache_dir is None else str(cache_dir),
            cache_bytes=cache_bytes,
        )
        self.port = int(port) or self._pick_port()
        self._control_addr = (self.host, int(control_port))
        self._start_timeout = float(start_timeout)
        self._procs: list = []
        # index -> {worker, pid, data_port, control_port, ready_unix,
        # start_s}: start_s is the seconds from the spawn to the
        # worker's report (an interpreter, torch, the server)
        self.worker_info: dict = {}
        self._spawned_at: dict = {}
        self._control = None
        self._control_thread = None
        # worker supervision: a dead data-plane worker is
        # respawned (bounded restarts, doubling backoff) instead of
        # permanently shrinking the pool
        self.supervise = bool(supervise)
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self._restarts: dict = {}  # index -> {count, backoff, next}
        self._ctx = None
        self._report_q = None
        self._monitor_thread = None
        self._monitor_stop = threading.Event()

    def _pick_port(self) -> int:
        # all workers must share ONE concrete port for SO_REUSEPORT
        # load balancing, so "port 0" is resolved up front (bind,
        # read, release — the narrow reuse race is a test-only cost)
        s = socket.socket()
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((self.host, 0))
            return int(s.getsockname()[1])
        finally:
            s.close()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServePool":
        import multiprocessing as mp

        # spawn, not fork: the parent may hold CUDA/threading state a
        # forked HTTP server must never inherit
        self._ctx = mp.get_context("spawn")
        self._report_q = self._ctx.Queue()
        for i in range(self.workers):
            self._procs.append(self._spawn_worker(i))
        deadline = time.time() + self._start_timeout
        while len(self.worker_info) < self.workers:
            if any(p.exitcode not in (None, 0) for p in self._procs):
                self.stop()
                raise RuntimeError(
                    "a pool worker died during startup (is the "
                    "folder readable? port bindable?)"
                )
            try:
                self._adopt(self._report_q.get(timeout=0.25))
            except Exception:
                if time.time() > deadline:
                    self.stop()
                    raise RuntimeError(
                        f"pool workers not ready within "
                        f"{self._start_timeout}s"
                    ) from None
        get_registry().gauge(
            "tpudas_serve_pool_workers",
            "serve-pool worker processes currently managed",
        ).set(len(self._procs))
        self._control = _PoolControlServer(self._control_addr, self)
        self._control_thread = threading.Thread(
            target=self._control.serve_forever,
            name="tpudas-serve-pool-control", daemon=True,
        )
        self._control_thread.start()
        if self.supervise:
            self._monitor_stop.clear()
            self._monitor_thread = threading.Thread(
                target=self._monitor,
                name="tpudas-serve-pool-monitor", daemon=True,
            )
            self._monitor_thread.start()
        log_event(
            "serve_pool_started",
            folder=self.folder,
            workers=self.workers,
            port=self.port,
            control_port=self.control_address[1],
        )
        return self

    # -- worker supervision --------------------------------------------
    def _spawn_worker(self, index: int):
        cfg = dict(self._cfg, index=index, port=self.port)
        self._spawned_at[index] = time.time()
        proc = self._ctx.Process(
            target=_worker_main, args=(cfg, self._report_q),
            name=f"tpudas-serve-worker-{index}", daemon=True,
        )
        proc.start()
        return proc

    def _drain_reports(self) -> None:
        """Pick up (re)spawned workers' port/pid reports so the
        control plane scrapes the live process, not the corpse."""
        import queue as _queue

        while True:
            try:
                info = self._report_q.get_nowait()
            except _queue.Empty:
                return
            self._adopt(info)

    def _adopt(self, info: dict) -> None:
        """Record a worker's report, with its start seconds."""
        index = int(info["worker"])
        info["start_s"] = info["ready_unix"] - self._spawned_at[index]
        self.worker_info[index] = info

    def _monitor(self) -> None:
        """Supervision loop: respawn dead data-plane workers with
        bounded restarts and doubling backoff — a crashed worker must
        not permanently shrink the pool.  Restarts are counted
        (``tpudas_serve_pool_worker_restarts_total``); a worker past
        ``max_restarts`` stays down and ``/pool/healthz`` reports the
        pool degraded."""
        reg = get_registry()
        while not self._monitor_stop.wait(0.25):
            self._drain_reports()
            for i, proc in enumerate(self._procs):
                if proc is not None and proc.is_alive():
                    continue
                rec = self._restarts.setdefault(
                    i, {
                        "count": 0,
                        "backoff": self.restart_backoff,
                        "next": 0.0,
                    },
                )
                if rec["count"] >= self.max_restarts:
                    continue
                now = time.time()
                if now < rec["next"]:
                    continue
                rec["count"] += 1
                rec["next"] = now + rec["backoff"]
                rec["backoff"] = min(rec["backoff"] * 2.0, 30.0)
                reg.counter(
                    "tpudas_serve_pool_worker_restarts_total",
                    "dead serve-pool workers respawned by the "
                    "supervision loop",
                ).inc()
                log_event(
                    "serve_pool_worker_respawned",
                    worker=i,
                    restart=rec["count"],
                )
                try:
                    self._procs[i] = self._spawn_worker(i)
                except Exception as exc:
                    log_event(
                        "serve_pool_respawn_failed",
                        worker=i,
                        error=f"{type(exc).__name__}: {str(exc)[:200]}",
                    )

    def restart_counts(self) -> dict:
        return {i: r["count"] for i, r in sorted(self._restarts.items())}

    def stop(self) -> None:
        if self._monitor_thread is not None:
            self._monitor_stop.set()
            self._monitor_thread.join(timeout=10)
            self._monitor_thread = None
        if self._control is not None:
            self._control.shutdown()
            self._control.server_close()
            self._control = None
            if self._control_thread is not None:
                self._control_thread.join(timeout=10)
                self._control_thread = None
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        get_registry().gauge(
            "tpudas_serve_pool_workers",
            "serve-pool worker processes currently managed",
        ).set(0)

    def __enter__(self) -> "ServePool":
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False

    # -- addresses -----------------------------------------------------
    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def control_address(self):
        return self._control.server_address[:2]

    @property
    def control_url(self) -> str:
        host, port = self.control_address
        return f"http://{host}:{port}"

    # -- control-plane payloads ---------------------------------------
    def _scrape(self, info: dict, endpoint: str) -> str:
        url = (
            f"http://{self.host}:{info['control_port']}{endpoint}"
        )
        with urllib.request.urlopen(
            url, timeout=_SCRAPE_TIMEOUT_S
        ) as r:
            return r.read().decode()

    def merged_metrics(self) -> str:
        """Every worker's live registry in one exposition, samples
        tagged ``worker="<i>"`` (the parent's own registry rides
        along as ``worker="pool"``)."""
        reg = get_registry()
        texts = {}
        with span("serve.pool_merge", workers=len(self.worker_info)):
            for i, info in sorted(self.worker_info.items()):
                try:
                    texts[str(i)] = self._scrape(info, "/metrics")
                except Exception as exc:
                    reg.counter(
                        "tpudas_serve_pool_worker_unreachable_total",
                        "pool control-plane scrapes that failed to "
                        "reach a worker",
                    ).inc()
                    log_event(
                        "serve_pool_worker_unreachable",
                        worker=i,
                        error=f"{type(exc).__name__}: "
                              f"{str(exc)[:200]}",
                    )
            texts["pool"] = reg.to_prometheus()
        return merge_prometheus(texts)

    def health(self) -> dict:
        """The aggregate liveness rollup: ``ok`` only when every
        worker process is alive AND its control plane answers."""
        workers = {}
        counts = {"ok": 0, "dead": 0, "unreachable": 0}
        for i, info in sorted(self.worker_info.items()):
            proc = self._procs[i] if i < len(self._procs) else None
            if proc is None or not proc.is_alive():
                status = "dead"
            else:
                try:
                    self._scrape(info, "/metrics")
                    status = "ok"
                except Exception:
                    status = "unreachable"
            counts[status] += 1
            workers[str(i)] = {
                "status": status,
                "pid": info.get("pid"),
                "control_port": info.get("control_port"),
            }
        overall = (
            "ok" if counts["ok"] == len(workers) and workers
            else "degraded"
        )
        return {
            "status": overall,
            "port": self.port,
            "workers": workers,
            "counts": counts,
        }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="N-process tpudas serve pool over one shared "
                    "read-only store (SO_REUSEPORT data plane + "
                    "merged control plane)"
    )
    ap.add_argument("folder",
                    help="processed output folder (or, with --fleet, "
                         "the fleet root)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--workers", type=int, default=_DEFAULT_WORKERS)
    ap.add_argument("--control-port", type=int, default=None,
                    help="pool /metrics + /healthz port "
                         "(default: port + 1)")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="per-worker admission gate size")
    ap.add_argument("--cache-tiles", type=int, default=256,
                    help="per-worker decoded-tile LRU capacity")
    ap.add_argument("--fleet", action="store_true",
                    help="serve a fleet root: every worker mounts "
                         "every <root>/<stream_id>/")
    ap.add_argument("--store-url", default=None,
                    help="serve a remote pyramid from this object "
                         "store; each worker hydrates its own "
                         "mirror + cache (stateless replicas); "
                         "replica:urlA,urlB,... serves through a "
                         "replicated store with mirror failover")
    ap.add_argument("--store-prefix", default="",
                    help="stream prefix inside the store")
    ap.add_argument("--cache-dir", default=None,
                    help="base cache directory (per-worker subdirs)")
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="per-worker read-through cache budget")
    ap.add_argument("--live-bridge", default=None,
                    help="producer LiveBridge address (host:port; "
                         "TPUDAS_LIVE_BRIDGE on the producer) — every "
                         "data worker subscribes so /live fans out "
                         "across the pool")
    args = ap.parse_args(argv)
    if args.store_url and args.fleet:
        ap.error("--store-url and --fleet are mutually exclusive")
    control_port = (
        args.port + 1 if args.control_port is None else
        args.control_port
    )
    pool = ServePool(
        args.folder, host=args.host, port=args.port,
        workers=args.workers, control_port=control_port,
        fleet=args.fleet, max_inflight=args.max_inflight,
        cache_tiles=args.cache_tiles, store_url=args.store_url,
        store_prefix=args.store_prefix, cache_dir=args.cache_dir,
        cache_bytes=args.cache_bytes, live_bridge=args.live_bridge,
    )
    with pool:
        print(
            f"tpudas_torch.serve pool: {pool.workers} workers on "
            f"{pool.base_url} (control {pool.control_url}) over "
            f"{pool.folder}"
        )
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            print("shutting down pool")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
