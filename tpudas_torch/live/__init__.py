"""Live subscription plane: push the decimated stream and detect
events to thousands of concurrent clients.

The port's copy of :mod:`tpudas.live`, with the same exports and wire
formats: a port worker subscribes to a JAX producer's bridge and a JAX
worker to a port producer's.

Everything here is **ephemeral by construction** — the hub holds no
durable state, so the plane is crash-only for free: a SIGKILL at any
point leaves the round loop's on-disk products byte-identical to a run
with no subscribers at all.  The three layers:

- :mod:`tpudas_torch.live.hub` — per-stream :class:`LiveHub` fed from
  the round loop's emit capture and the detect ledger, fanning
  monotonically-sequenced round frames into per-client **bounded**
  queues (a slow client degrades to a coarser level, then is dropped
  with a counted reason — never queued unboundedly, never
  backpressuring the producer).
- :mod:`tpudas_torch.live.protocol` — the snapshot-then-delta wire
  protocol over :mod:`tpudas_torch.codec` frames, with ``Last-Event-ID`` resume.
- :mod:`tpudas_torch.live.sse` — the ``GET /live`` SSE serving loop plus
  the :class:`LiveBridge` socket fan-out that lets ``ServePool`` worker
  processes subscribe to the producing process.

See SERVING.md "Live subscriptions" for the protocol and runbook.
"""

from tpudas_torch.live.hub import (  # noqa: F401
    LiveFrame,
    LiveHub,
    Subscription,
    find_hub,
    get_hub,
    register_hub,
    reset_hubs,
)
from tpudas_torch.live.protocol import (  # noqa: F401
    delta_event,
    resume_frames,
    snapshot_event,
)
from tpudas_torch.live.sse import (  # noqa: F401
    BridgeSubscriber,
    LiveBridge,
    ensure_bridge,
    format_sse,
    serve_live,
)

__all__ = [
    "BridgeSubscriber",
    "LiveBridge",
    "LiveFrame",
    "LiveHub",
    "Subscription",
    "delta_event",
    "ensure_bridge",
    "find_hub",
    "format_sse",
    "get_hub",
    "register_hub",
    "reset_hubs",
    "resume_frames",
    "serve_live",
    "snapshot_event",
]
