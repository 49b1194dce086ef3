"""Snapshot-then-delta wire protocol for the live plane.

The port's copy of :mod:`tpudas.live.protocol`: the same event bodies,
so a client of either package's server decodes the other's.

Every payload on the wire is a :mod:`tpudas_torch.codec` frame (the
``.tpt`` container: self-describing, crc-stamped) carried base64 in a
JSON event body, so a client needs exactly one decoder for ``/tile``,
``/query`` downloads and the live stream:

- **hello** — the handshake: the hub's head sequence, the client's
  granted level/depth, the degrade factor.
- **snapshot** — a pyramid-backed backfill window at the client's
  requested resolution, answered by the SAME
  :class:`tpudas_torch.serve.query.QueryEngine` path as ``GET /query``
  (so a losslessly-encoded snapshot is byte-consistent with a pull of the
  same window — the tier-1 test pins this).
- **delta** — one round's decimated rows at the subscriber's current
  level plus the round's new detect events, ``id:`` = the hub
  sequence.
- **drop** — terminal: the degrade ladder ran out (or the hub shed
  the client); reconnect resumes.

Resume: a reconnecting client sends ``Last-Event-ID`` (or
``?last_id=``).  A gap still inside the hub's replay ring replays the
missed deltas (``tpudas_live_resumes_total{result="replay"}``);
anything older falls back to a fresh snapshot (``result="snapshot"``)
— the client can always converge, the server never buffers
per-client history beyond the shared ring.

The delta encoding defaults to lossless ``deflate`` so
snapshot-then-delta reconstructs exactly what ``/query`` serves;
``?codec=quantize-deflate&max_error=`` opts into the
bounded-error quantize codec as the cheap delta encoding for
bandwidth-constrained dashboards.
"""

from __future__ import annotations

import base64

import numpy as np

from tpudas_torch.live.hub import DEGRADE_FACTOR, LiveFrame, LiveHub
from tpudas_torch.obs.registry import get_registry

__all__ = [
    "DEFAULT_CODEC",
    "delta_event",
    "resume_frames",
    "snapshot_event",
]

DEFAULT_CODEC = "deflate"


def _b64(blob: bytes) -> str:
    return base64.b64encode(blob).decode("ascii")


def delta_event(frame: LiveFrame, level: int,
                codec_id: str = DEFAULT_CODEC, **params) -> dict:
    """One round frame as a JSON-able ``delta`` event body at
    ``level`` (the blob encode is cached on the frame — shared across
    every subscriber at the same level/codec)."""
    level = int(level)
    blob = frame.payload(level, codec_id, **params)
    times = frame.level_times(level)
    f = DEGRADE_FACTOR ** level
    return {
        "seq": frame.seq,
        "round": frame.round,
        "level": level,
        "t0_ns": int(times[0]) if times.size else frame.t0_ns,
        "step_ns": int(frame.step_ns * f),
        "rows": int(times.size),
        "codec": str(codec_id),
        "blob": _b64(blob),
        "events": frame.events,
        "published_unix_ns": frame.published_unix_ns,
    }


def snapshot_event(engine, t0, t1, seq: int, resolution=None,
                   max_samples=None, codec_id: str = DEFAULT_CODEC,
                   reason: str = "connect", **params) -> dict:
    """The connect/gap backfill window as a ``snapshot`` event body:
    one :meth:`QueryEngine.query` answer (the SAME path ``GET /query``
    takes — byte-consistency by construction) encoded as one codec
    blob.  ``seq`` stamps which hub sequence the snapshot covers
    through; deltas with ``seq`` at or below it are already folded
    in."""
    result = engine.query(
        t0, t1, resolution=resolution, max_samples=max_samples
    )
    from tpudas_torch.codec import encode_tile

    data = np.asarray(result.data, np.float32)
    blob = encode_tile(data, codec_id, **params)
    get_registry().counter(
        "tpudas_live_snapshots_total",
        "snapshot backfills served, by reason (fresh connect vs "
        "resume gap beyond the replay ring)",
        labelnames=("reason",),
    ).inc(reason=reason)
    times = np.asarray(result.times, "datetime64[ns]").astype(np.int64)
    return {
        "seq": int(seq),
        "level": int(result.level),
        "t0_ns": int(times[0]) if times.size else None,
        "step_ns": int(result.step_ns),
        "rows": int(data.shape[0]),
        "agg": result.agg,
        "source": result.source,
        "codec": str(codec_id),
        "blob": _b64(blob),
        "distance": [float(v) for v in np.asarray(result.distance)],
        "reason": reason,
    }


def resume_frames(hub: LiveHub, last_id) -> list | None:
    """``Last-Event-ID`` resume: the missed frames when the gap is
    still inside the replay ring, else None (caller sends a fresh
    snapshot).  Counted either way."""
    if last_id is None:
        return None
    frames = hub.frames_since(int(last_id))
    get_registry().counter(
        "tpudas_live_resumes_total",
        "reconnects with Last-Event-ID, by outcome (ring replay vs "
        "snapshot fallback)",
        labelnames=("result",),
    ).inc(result="snapshot" if frames is None else "replay")
    return frames
