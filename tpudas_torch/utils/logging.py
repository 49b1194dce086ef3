"""Structured event logging.

The reference observes progress with bare prints (lf_das.py:263 etc.);
the port keeps those user-visible prints and adds machine-readable
event lines behind an opt-in handler (off by default so notebook output
matches the reference).

A handler exception must not take down the processing loop, but it
must not vanish either: every swallowed handler failure is counted
(:func:`event_drops`, and in the obs registry as
``tpudas_log_event_drops_total`` and
``tpudas_obs_events_dropped_total{reason="handler"}``, as in the JAX
package), and the FIRST drop prints one stderr warning naming the
exception so a misconfigured handler is diagnosable.
"""

from __future__ import annotations

import json
import sys
import time

_handler = None
_drops = 0  # handler exceptions swallowed (mirrored into the registry)
_drop_warned = False


def set_log_handler(handler):
    """Install a callable(event_dict) — or ``"stderr"`` for JSON lines,
    or None to disable (default)."""
    global _handler
    if handler == "stderr":
        def handler(event):  # noqa: F811
            print(json.dumps(event, default=str), file=sys.stderr)
    _handler = handler


def log_event(name: str, **fields):
    if _handler is None:
        return
    event = {"event": name, "ts": time.time(), **fields}
    try:
        _handler(event)
    except Exception as exc:
        _record_drop(name, exc)


def event_drops() -> int:
    """Swallowed handler failures so far (process lifetime)."""
    return _drops


def _record_drop(name: str, exc: Exception) -> None:
    global _drops, _drop_warned
    _drops += 1
    try:
        # lazy import: tpudas_torch.obs.trace imports log_event back
        from tpudas_torch.obs.registry import get_registry

        reg = get_registry()
        reg.counter(
            "tpudas_log_event_drops_total",
            "log_event handler exceptions swallowed",
        ).inc()
        # the obs-wide alias: silent event loss must be visible in
        # metrics.prom next to the flight-recorder drops
        reg.counter(
            "tpudas_obs_events_dropped_total",
            "observability events lost before reaching their sink "
            "(log_event handler failures, flight-recorder drops)",
            labelnames=("reason",),
        ).inc(reason="handler")
    except Exception:
        pass  # the drop counter must not introduce its own crash path
    if not _drop_warned:
        _drop_warned = True
        print(
            f"Warning: log_event handler raised on event {name!r} "
            f"({exc!r}); this and further handler failures are "
            "swallowed (counted in tpudas_log_event_drops_total)",
            file=sys.stderr,
        )
