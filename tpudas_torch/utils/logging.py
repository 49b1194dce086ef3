"""Structured event logging.

The reference observes progress with bare prints (lf_das.py:263 etc.);
the port keeps those user-visible prints and adds machine-readable
event lines behind an opt-in handler (off by default so notebook output
matches the reference).

A handler exception must not take down the processing loop, but it
must not vanish either: every swallowed handler failure is counted
(:func:`event_drops`), and the FIRST drop prints one stderr warning
naming the exception so a misconfigured handler is diagnosable.
"""

from __future__ import annotations

import json
import sys
import time

_handler = None
_drops = 0  # handler exceptions swallowed
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
    if not _drop_warned:
        _drop_warned = True
        print(
            f"Warning: log_event handler raised on event {name!r} "
            f"({exc!r}); this and further handler failures are "
            "swallowed (counted by event_drops())",
            file=sys.stderr,
        )
