"""Failure taxonomy, retry/backoff, the per-round fault boundary, and
the deterministic fault-injection harness.

The port's own copy of :mod:`tpudas.resilience.faults`: the same
classes, the same decisions and the same :data:`FAULT_SITES`, so a
:class:`FaultSpec` written for one package means the same in the
other.  The real-time path marks eight of the sites: ``round.body``
(top of each runner's ``step``, :mod:`tpudas_torch.fleet.engine`),
``spool.read`` (the per-file payload read,
:mod:`tpudas_torch.io.spool`), ``index.update`` (the directory index
re-scan, :mod:`tpudas_torch.io.index`), ``carry.save`` (the stream
carry persist, :mod:`tpudas_torch.proc.stream`), ``fs.write_enospc``
(every atomic write, :mod:`tpudas_torch.utils.atomicio`),
``integrity.verify`` (every verified read,
:mod:`tpudas_torch.integrity.checksum`), ``detect.op`` and
``detect.ledger_write`` (:mod:`tpudas_torch.detect`).  The other sites
belong to features the port does not have yet.

Taxonomy (:func:`classify_failure`):

- ``"transient"`` — environmental IO that a later attempt can succeed
  at (any ``OSError`` in the round, a :class:`SpoolReadError` wrapping
  one).  Retried with capped exponential backoff + jitter.
- ``"corrupt"`` — a file whose payload fails to decode (a
  :class:`SpoolReadError` wrapping a non-OS error).  Retried, and every
  failure is charged to the file in the quarantine ledger; after
  ``RetryPolicy.quarantine_after`` strikes the file is excluded from
  the spool index and the round proceeds without it.
- ``"network"`` — a :class:`NetworkFaultError`; retried like a
  transient, never quarantined.
- ``"resource"`` — ``OSError`` with ``ENOSPC``/``EDQUOT``; retried with
  ``max_consecutive * resource_patience`` attempts, and the boundary
  flips the process-wide pressure flag
  (:mod:`tpudas_torch.integrity.resource`), so the driver sheds the
  detect round until a probe write succeeds again.
- ``"fatal"`` — everything else; propagates at once.

Backoff is deterministic: ``RetryPolicy.delay(attempt)`` derives its
jitter from an LCG over ``(seed, attempt)``.  With no
:class:`FaultPlan` installed a :func:`fault_point` costs one global
``is None`` check.
"""

from __future__ import annotations

import errno
import os
import time
from dataclasses import dataclass, field

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.logging import log_event

__all__ = [
    "FAULT_SITES",
    "FaultBoundary",
    "FaultPlan",
    "FaultSpec",
    "NetworkFaultError",
    "RetryPolicy",
    "SpoolReadError",
    "TransientFaultError",
    "classify_failure",
    "fault_point",
    "install_fault_plan",
]


class TransientFaultError(OSError):
    """An injected (or explicitly tagged) transient fault — an
    ``OSError`` so the taxonomy needs no special case for it."""


class NetworkFaultError(OSError):
    """A remote storage/network failure — the taxonomy's ``"network"``
    kind."""


class SpoolReadError(Exception):
    """A per-file payload read/decode failure, carrying the offending
    path so the fault boundary can charge the quarantine ledger.
    Raised by :meth:`tpudas_torch.io.spool.DirectorySpool._read_row`
    around any reader error;
    ``__cause__`` holds the original exception."""

    def __init__(self, path: str, original: BaseException):
        super().__init__(
            f"failed to read {path!r}: "
            f"{type(original).__name__}: {original}"
        )
        self.path = str(path)
        self.original = original


RESOURCE_ERRNOS = (errno.ENOSPC, errno.EDQUOT)


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` | ``"corrupt"`` | ``"network"`` | ``"resource"``
    | ``"fatal"`` for one exception.

    A :class:`SpoolReadError` wrapping an ``OSError`` is transient (the
    interrogator may still be flushing the file); wrapping anything
    else it is corrupt (the bytes decoded wrong — rereading the same
    bytes cannot fix that, only quarantine can).  A
    :class:`NetworkFaultError` is network (the remote storage tier
    misbehaved — retried with backoff, never quarantined).  An
    ``OSError`` with ``ENOSPC``/``EDQUOT`` is resource (the OUTPUT
    side is full — retrying with shed writers beats dying); any other
    bare ``OSError`` in the round is transient.  Everything else —
    config, programming, the reference's gap raise — is fatal.
    """
    if isinstance(exc, SpoolReadError):
        return (
            "transient" if isinstance(exc.original, OSError) else "corrupt"
        )
    if isinstance(exc, MemoryError):
        return "fatal"
    if isinstance(exc, NetworkFaultError):
        return "network"
    if isinstance(exc, OSError):
        if getattr(exc, "errno", None) in RESOURCE_ERRNOS:
            return "resource"
        return "transient"
    return "fatal"


@dataclass(frozen=True)
class RetryPolicy:
    """Per-round retry/backoff + quarantine thresholds.

    ``delay(attempt)`` is ``base_delay * multiplier**attempt`` capped at
    ``max_delay``, plus a deterministic jitter in
    ``[0, jitter * delay]`` derived from ``(seed, attempt)`` — no RNG
    state, no wall clock, fully predictable for tests.
    """

    max_consecutive: int = 8  # round failures before even transients propagate
    base_delay: float = 1.0  # seconds, first retry
    max_delay: float = 60.0  # backoff cap
    multiplier: float = 2.0
    jitter: float = 0.1  # fraction of the capped delay
    seed: int = 0
    quarantine_after: int = 3  # per-file strikes before quarantine
    quarantine_retry: float = 900.0  # slow-schedule probe interval (s)
    # resource (disk-full) failures get max_consecutive * this before
    # propagating: exiting cannot free space, waiting for rotation can
    resource_patience: int = 8
    clock: object = time.time  # injectable for deterministic tests

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based)."""
        d = min(
            self.base_delay * self.multiplier ** max(int(attempt), 0),
            self.max_delay,
        )
        # LCG over (seed, attempt): deterministic jitter in [0, jitter*d]
        x = (
            (int(self.seed) * 1103515245 + int(attempt) * 12345 + 12821)
            % (1 << 31)
        ) / float(1 << 31)
        return d * (1.0 + self.jitter * x)


@dataclass
class FaultDecision:
    """What the boundary decided about one round failure."""

    kind: str  # transient | corrupt | fatal
    propagate: bool
    delay: float = 0.0  # backoff before the retry (when not propagating)
    reason: str = ""


class FaultBoundary:
    """Per-run fault bookkeeping for a realtime driver.

    One instance per driver run; the driver funnels every round failure
    through :meth:`on_failure` and every completed round through
    :meth:`on_success`.  The boundary classifies, charges file-
    attributed failures to the quarantine ledger, decides
    retry-vs-propagate, and keeps the degradation metrics/health fields
    current (``tpudas_stream_consecutive_failures``,
    ``tpudas_stream_degraded``, ``tpudas_stream_quarantined_files``).
    """

    def __init__(self, policy: RetryPolicy | None = None, ledger=None):
        self.policy = policy if policy is not None else RetryPolicy()
        self.ledger = ledger
        self.consecutive = 0  # failed round attempts since last success
        self.retries = 0  # total retries this run
        self.last_error: str | None = None

    # -- state the driver surfaces in health.json ----------------------
    @property
    def quarantined_count(self) -> int:
        return 0 if self.ledger is None else self.ledger.quarantined_count

    @property
    def degraded(self) -> bool:
        return self.consecutive > 0 or self.quarantined_count > 0

    def excluded_now(self):
        """Basenames the spool must exclude this round (quarantined
        files whose slow-retry window has not yet opened)."""
        if self.ledger is None:
            return frozenset()
        return self.ledger.excluded(now=self.policy.clock())

    # -- the round preamble (shared by both realtime drivers) ----------
    def begin_round(self, sp, source):
        """Start one polling round over a freshly created spool:
        apply the quarantine exclusion, ``update()`` the index, charge
        scan failures (the file is skipped, the round continues), and
        run the slow-schedule probe bookkeeping.  Returns the updated
        spool.

        Probe release is by failure source: a SCAN-sourced entry whose
        scan now passes is released on the spot (the interrogator
        finished writing it); a READ-sourced entry (scan always
        passed — the payload was the problem) is only *marked pending*
        and released by :meth:`on_success` when the round completes —
        a failed probe read instead re-quarantines WITH escalation,
        the entry's backoff history intact."""
        excl = self.excluded_now()
        if excl and hasattr(sp, "exclude"):
            sp = sp.exclude(excl)
        sp = sp.update()
        scan_errors = getattr(sp, "scan_errors", None) or {}
        for name, msg in scan_errors.items():
            self._charge_file(
                os.path.join(str(source), name), msg, source="scan"
            )
        if self.ledger is not None and self.ledger.quarantined_count:
            for name in self.ledger.probe_open_names(self.policy.clock()):
                # a probe whose scan failed was just re-quarantined by
                # the charge above and is no longer probe-open
                entry = self.ledger.entry(name) or {}
                if entry.get("source") == "read":
                    self.ledger.mark_probe_pending(name)
                else:
                    self._release(name)
        return sp

    # -- the boundary itself -------------------------------------------
    def on_success(self) -> None:
        if self.consecutive:
            log_event("stream_round_recovered", after=self.consecutive)
        self.consecutive = 0
        self.last_error = None
        if self.ledger is not None:
            # read-sourced probes that rode this round to completion:
            # the payload read succeeded (or the file failed and was
            # re-quarantined before we got here)
            for name in self.ledger.probe_pending_names():
                self._release(name)
        self._gauges()

    def on_failure(self, exc: BaseException, where: str = "round") -> (
        FaultDecision
    ):
        kind = classify_failure(exc)
        self.last_error = f"{type(exc).__name__}: {str(exc)[:300]}"
        reg = get_registry()
        reg.counter(
            "tpudas_stream_round_failures_total",
            "realtime round attempts that raised, by failure kind",
            labelnames=("kind",),
        ).inc(kind=kind)
        if isinstance(exc, SpoolReadError):
            self._charge_file(exc.path, self.last_error)
        if kind == "resource":
            # flip the process-wide pressure flag: the driver sheds
            # non-essential writers until a probe write succeeds
            from tpudas_torch.integrity.resource import note_pressure

            note_pressure(where, exc)
        if kind == "fatal":
            decision = FaultDecision(kind, True, reason="fatal failure")
        else:
            self.consecutive += 1
            self._gauges()
            limit = self.policy.max_consecutive
            if kind == "resource":
                limit *= max(int(self.policy.resource_patience), 1)
            if self.consecutive > limit:
                decision = FaultDecision(
                    kind,
                    True,
                    reason=(
                        f"{self.consecutive} consecutive round failures "
                        f"(max {limit})"
                    ),
                )
            else:
                self.retries += 1
                reg.counter(
                    "tpudas_stream_retries_total",
                    "round retries scheduled by the fault boundary",
                ).inc()
                decision = FaultDecision(
                    kind, False, delay=self.policy.delay(self.consecutive - 1)
                )
        log_event(
            "stream_round_failed",
            where=where,
            kind=kind,
            error=self.last_error,
            consecutive=self.consecutive,
            propagate=decision.propagate,
            retry_delay_s=round(decision.delay, 3),
        )
        return decision

    # -- internals ------------------------------------------------------
    def _charge_file(self, path: str, msg: str, source: str = "read") -> (
        None
    ):
        if self.ledger is None:
            return
        outcome = self.ledger.record_failure(
            path, msg, now=self.policy.clock(),
            threshold=self.policy.quarantine_after,
            retry_interval=self.policy.quarantine_retry,
            source=source,
        )
        if outcome == "added":
            get_registry().counter(
                "tpudas_stream_quarantine_added_total",
                "files newly quarantined by the fault boundary",
            ).inc()
        elif outcome == "requarantined":
            get_registry().counter(
                "tpudas_stream_quarantine_requarantined_total",
                "failed slow-schedule probes (re-quarantined with "
                "escalated backoff)",
            ).inc()
        self._gauge_quarantine()

    def _release(self, name: str) -> None:
        self.ledger.record_success(name)
        self._gauge_quarantine()

    def _gauge_quarantine(self) -> None:
        get_registry().gauge(
            "tpudas_stream_quarantined_files",
            "source files currently quarantined (excluded from the index)",
        ).set(self.quarantined_count)

    def _gauges(self) -> None:
        reg = get_registry()
        reg.gauge(
            "tpudas_stream_consecutive_failures",
            "failed round attempts since the last completed round",
        ).set(self.consecutive)
        reg.gauge(
            "tpudas_stream_degraded",
            "1 while the driver is retrying or has quarantined files",
        ).set(1.0 if self.degraded else 0.0)


# ---------------------------------------------------------------------------
# deterministic fault injection

FAULT_SITES = (
    "spool.read",
    "index.update",
    "round.body",
    "carry.save",
    "stream.prefetch",
    "serve.tile_read",
    "serve.queue_full",
    "integrity.verify",
    "fs.write_enospc",
    "detect.op",
    "detect.ledger_write",
    "backfill.claim",
    "backfill.commit",
    "obs.flight_write",
    "store.op",
    "store.op.sent",
    "live.emit",
)

_ACTIONS = ("raise", "truncate", "delay")


@dataclass
class FaultSpec:
    """One injected fault: fire ``action`` at hits
    ``[at, at + times)`` of ``site`` (1-based hit counting).

    - ``action="raise"`` raises ``exc`` (class or instance; default
      :class:`TransientFaultError`, i.e. classified transient);
    - ``action="truncate"`` truncates the file in the site's ``path``
      context to ``nbytes`` (a half-written interrogator file) and lets
      execution continue into the natural decode failure;
    - ``action="delay"`` calls ``sleep_fn(seconds)`` (default
      ``time.sleep``) — a slow NFS mount, not a failure.

    ``match`` (substring) additionally gates the spec on the site's
    path-like context (``path``/``folder``/``directory``), so a fault
    can target ONE file while other reads at the same site succeed.
    Hit counting stays per-site and global regardless of ``match``.
    """

    site: str
    action: str = "raise"
    at: int = 1
    times: int = 1
    exc: object = None
    nbytes: int = 0
    seconds: float = 0.0
    sleep_fn: object = None
    match: str | None = None

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {FAULT_SITES}"
            )
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; known: {_ACTIONS}"
            )


class FaultPlan:
    """An ordered set of :class:`FaultSpec` plus per-site hit counters
    and the ``fired`` log (``(site, action, hit_index)`` tuples) tests
    assert against.  Install with :func:`install_fault_plan`."""

    def __init__(self, *specs: FaultSpec):
        self.specs = list(specs)
        self.hits: dict = {site: 0 for site in FAULT_SITES}
        self.fired: list = []

    def hit(self, site: str, ctx: dict) -> None:
        self.hits[site] = n = self.hits.get(site, 0) + 1
        where = str(
            ctx.get("path") or ctx.get("folder") or ctx.get("directory")
            or ""
        )
        for spec in self.specs:
            if spec.site != site or not (
                spec.at <= n < spec.at + spec.times
            ):
                continue
            if spec.match is not None and spec.match not in where:
                continue
            self.fired.append((site, spec.action, n))
            if spec.action == "delay":
                (spec.sleep_fn or time.sleep)(spec.seconds)
            elif spec.action == "truncate":
                path = ctx.get("path") or ctx.get("folder")
                if path and os.path.isfile(path):
                    with open(path, "r+b") as fh:
                        fh.truncate(int(spec.nbytes))
            else:  # raise
                exc = spec.exc
                if exc is None:
                    exc = TransientFaultError(
                        f"injected transient fault at {site} (hit {n})"
                    )
                elif isinstance(exc, type):
                    exc = exc(f"injected fault at {site} (hit {n})")
                raise exc


_PLAN: FaultPlan | None = None


def fault_point(site: str, **ctx) -> None:
    """Marks a fault-injection site in production code.  No plan
    installed (the always case outside tests) costs one global ``is
    None`` check."""
    if _PLAN is not None:
        _PLAN.hit(site, ctx)


class install_fault_plan:
    """``with install_fault_plan(plan): ...`` scopes a
    :class:`FaultPlan` over a block (process-global — the drivers run
    worker threads; tests do not run concurrently).  Also usable as
    ``install_fault_plan(plan)`` / ``install_fault_plan(None)`` pairs.
    """

    def __init__(self, plan: FaultPlan | None):
        global _PLAN
        self._prev = _PLAN
        _PLAN = plan

    def __enter__(self):
        return _PLAN

    def __exit__(self, *exc_info):
        global _PLAN
        _PLAN = self._prev
        return False
