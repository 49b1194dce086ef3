"""tpudas_torch.serve — the read side of the streaming stack.

The port's counterpart of :mod:`tpudas.serve`:

- :mod:`tpudas_torch.serve.tiles` — the incremental multi-resolution
  pyramid (mean/min/max) over the processed output, appended round by
  round beside the stream carry, crash-only like the carry itself, in
  the JAX package's on-disk format;
- :mod:`tpudas_torch.serve.query` — time x distance window reads that
  pick the coarsest pyramid level satisfying a requested resolution,
  backed by an LRU tile cache with single-flight request coalescing
  and a full-resolution file fallback;
- :mod:`tpudas_torch.serve.http` — the zero-dependency threaded HTTP
  server (``/query``, ``/waterfall``, ``/tile``, ``/events``,
  ``/live``, ``/healthz``, ``/metrics``, ``/trace``, ``/slo``, the
  ``/s/<stream_id>/`` mounts and ``/fleet/healthz``) with the bounded
  admission gate, strong ETags and immutable-tile ``Cache-Control``;
- :mod:`tpudas_torch.serve.pool` — N server processes over one
  read-only store sharing a single ``SO_REUSEPORT`` data port, with a
  merged ``/metrics`` + aggregate ``/healthz`` control plane
  (``tpudas_torch/tools/serve_pool.py``).

``ServePool``, ``start_server`` and ``serve_forever`` are lazy
factories, as in the JAX package: ``import tpudas_torch.serve`` stays
free of multiprocessing and http.server.
"""

from tpudas_torch.serve.query import QueryEngine, QueryResult
from tpudas_torch.serve.tiles import TileStore, rebuild_pyramid, sync_pyramid

__all__ = [
    "QueryEngine",
    "QueryResult",
    "ServePool",
    "TileStore",
    "rebuild_pyramid",
    "sync_pyramid",
    "serve_forever",
    "start_server",
]


def ServePool(*args, **kwargs):  # noqa: N802 - class-shaped factory
    """Lazy re-export of :class:`tpudas_torch.serve.pool.ServePool`."""
    from tpudas_torch.serve.pool import ServePool as _Pool

    return _Pool(*args, **kwargs)


def start_server(*args, **kwargs):
    """Lazy re-export of :func:`tpudas_torch.serve.http.start_server`."""
    from tpudas_torch.serve.http import start_server as _start

    return _start(*args, **kwargs)


def serve_forever(*args, **kwargs):
    """Lazy re-export of :func:`tpudas_torch.serve.http.serve_forever`."""
    from tpudas_torch.serve.http import serve_forever as _serve

    return _serve(*args, **kwargs)
