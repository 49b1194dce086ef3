"""Disk-full (``ENOSPC``/``EDQUOT``) graceful degradation.

The port's copy of :mod:`tpudas.integrity.resource`.  An edge box
whose disk fills must not die — and must not spend its remaining
breath failing to write derived products.  This module keeps one
process-wide pressure flag:

- any writer that hits a resource error **notes pressure**
  (:func:`note_pressure`): the flag flips, the
  ``tpudas_integrity_resource_degraded`` gauge goes to 1, and the
  realtime driver starts **shedding non-essential writers** (in the
  port: the detect round) via :func:`should_shed` (each
  shed is counted per writer in
  ``tpudas_integrity_writes_shed_total``).  The core stream and the
  carry keep going; a carry save that fails on ENOSPC is
  retried by the fault boundary under the ``"resource"`` kind with
  extra patience (``RetryPolicy.resource_patience``).
- every round-end while degraded, the driver calls
  :func:`probe_recovery`: a tiny probe write into the output folder.
  The moment it succeeds the flag clears, shed writers resume, and the
  detect catch-up re-reads whatever the shed rounds skipped from the
  output files — recovery is automatic, no operator action.

The probe goes through the same ``fs.write_enospc`` fault site as
every real write (:mod:`tpudas_torch.utils.atomicio`), so the whole degrade/recover
cycle is deterministically drillable from a :class:`FaultPlan`.
"""

from __future__ import annotations

import os
import time

from tpudas_torch.obs.registry import get_registry
# the taxonomy (classify_failure) owns the errno set; one definition
# so a new resource errno cannot split retry and shedding behavior
from tpudas_torch.resilience.faults import RESOURCE_ERRNOS
from tpudas_torch.utils.logging import log_event

__all__ = [
    "RESOURCE_ERRNOS",
    "clear_pressure",
    "is_degraded",
    "is_resource_error",
    "note_pressure",
    "probe_recovery",
    "should_shed",
]

_PROBE_FILENAME = ".space_probe.tmp"  # .tmp: an audit sweeps leftovers

_STATE = {"degraded": False, "since": None, "last_error": None}


def is_resource_error(exc: BaseException, _depth: int = 4) -> bool:
    """True when ``exc`` (or a cause within 4 links) is a disk-full /
    quota OSError."""
    while exc is not None and _depth > 0:
        if (
            isinstance(exc, OSError)
            and getattr(exc, "errno", None) in RESOURCE_ERRNOS
        ):
            return True
        exc = exc.__cause__ or exc.__context__
        _depth -= 1
    return False


def is_degraded() -> bool:
    return _STATE["degraded"]


def note_pressure(where: str, exc: BaseException | None = None) -> None:
    """Flip (or refresh) the resource-pressure flag after a writer hit
    ENOSPC/EDQUOT at ``where``."""
    err = None if exc is None else f"{type(exc).__name__}: {str(exc)[:200]}"
    _STATE["last_error"] = err
    if _STATE["degraded"]:
        return
    _STATE["degraded"] = True
    _STATE["since"] = time.time()
    reg = get_registry()
    reg.counter(
        "tpudas_integrity_resource_events_total",
        "disk-full/quota pressure episodes (flag flips to degraded)",
    ).inc()
    reg.gauge(
        "tpudas_integrity_resource_degraded",
        "1 while non-essential writers are shed for disk-full/quota "
        "pressure",
    ).set(1.0)
    log_event("resource_pressure", where=where, error=err)


def clear_pressure(reason: str = "") -> None:
    if not _STATE["degraded"]:
        return
    _STATE["degraded"] = False
    _STATE["since"] = None
    _STATE["last_error"] = None
    get_registry().gauge(
        "tpudas_integrity_resource_degraded",
        "1 while non-essential writers are shed for disk-full/quota "
        "pressure",
    ).set(0.0)
    log_event("resource_recovered", reason=reason)


def should_shed(writer: str) -> bool:
    """True while resource-degraded — and counts the shed per writer,
    so skipped detect rounds are visible, never silent."""
    if not _STATE["degraded"]:
        return False
    get_registry().counter(
        "tpudas_integrity_writes_shed_total",
        "non-essential writes skipped under disk-full/quota pressure",
        labelnames=("writer",),
    ).inc(writer=writer)
    return True


def probe_recovery(folder: str) -> bool:
    """While degraded, try one tiny write into ``folder``; on success
    clear the pressure flag (shed writers resume next round).  Returns
    True when not (or no longer) degraded."""
    if not _STATE["degraded"]:
        return True
    probe = os.path.join(str(folder), _PROBE_FILENAME)
    try:
        from tpudas_torch.resilience.faults import fault_point

        fault_point("fs.write_enospc", path=probe)
        with open(probe, "w") as fh:
            fh.write("x" * 512)
        os.remove(probe)
    except OSError as exc:
        _STATE["last_error"] = f"{type(exc).__name__}: {str(exc)[:200]}"
        log_event("resource_probe_failed", error=_STATE["last_error"])
        return False
    clear_pressure("probe write succeeded")
    return True
