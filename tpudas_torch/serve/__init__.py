"""tpudas_torch.serve — the read side of the streaming stack.

The port's counterpart of :mod:`tpudas.serve`, in this slice its
pyramid and query halves:

- :mod:`tpudas_torch.serve.tiles` — the incremental multi-resolution
  pyramid (mean/min/max) over the processed output, appended round by
  round beside the stream carry, crash-only like the carry itself, in
  the JAX package's on-disk format;
- :mod:`tpudas_torch.serve.query` — time x distance window reads that
  pick the coarsest pyramid level satisfying a requested resolution,
  backed by an LRU tile cache with single-flight request coalescing
  and a full-resolution file fallback.

The HTTP server and the worker pool (``ServePool``, ``start_server``,
``serve_forever``) are ROADMAP step A8c; until then each raises
``NotImplementedError`` naming it.
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


def _not_ported(name: str):
    raise NotImplementedError(
        f"tpudas_torch.serve.{name}: the HTTP server and worker pool are "
        "not ported to tpudas_torch yet (ROADMAP A8c)"
    )


def ServePool(*args, **kwargs):  # noqa: N802 - class-shaped factory
    """Not ported yet (A8c): raises ``NotImplementedError``."""
    _not_ported("ServePool")


def start_server(*args, **kwargs):
    """Not ported yet (A8c): raises ``NotImplementedError``."""
    _not_ported("start_server")


def serve_forever(*args, **kwargs):
    """Not ported yet (A8c): raises ``NotImplementedError``."""
    _not_ported("serve_forever")
