"""Idempotency-aware retry over any backend.

:class:`RetryingStore` wraps an :class:`~tpudas_torch.store.base.ObjectStore`
and absorbs :class:`~tpudas_torch.store.base.StoreNetworkError` with
capped-exponential backoff + deterministic jitter (the same
``RetryPolicy.delay`` LCG the realtime fault boundary uses — every
sleep predictable for tests).  What makes it correct, not just
persistent, is that the retry strategy follows the operation's
idempotency class:

- **Reads and unconditional puts retry blindly.**  ``get``/``head``/
  ``list`` have no side effects; ``put`` bytes are deterministic
  functions of the stream, so re-putting after an ambiguous failure
  converges on the same object no matter how many times it lands.
- **Conditional puts re-read the token first.**  A network error on
  ``put_if`` is ambiguous — the CAS may have applied before the
  response dropped.  Blind re-issue would then see "current token !=
  my precondition" and miscount its OWN success as a lost race,
  breaking exactly-once.  So before each retry the wrapper re-reads
  the object's token: equal to ``token_of(my_bytes)`` means the first
  attempt landed — return success without re-writing (counted in
  ``tpudas_store_cas_recovered_total``); anything else means it
  really didn't apply (or a rival moved the object) and the CAS is
  re-issued against the ORIGINAL precondition, so a genuine lost race
  still surfaces as :class:`CASConflictError` to the caller's
  protocol.  This hinges on tokens being content-derived
  (:func:`tpudas_torch.store.base.token_of`) and on every mutable artifact
  embedding a writer-distinguishing field (lease token, generation) —
  both invariants of this plane.
- :class:`CASConflictError` is NEVER retried — it is a definitive
  answer, not a failure.

``delete`` is idempotent by contract (False for already-gone) and
retries blindly.  The wrapper is a transparent proxy for everything
else (``list_uploads``, drill helpers), so call sites type against
the plain store contract.
"""

from __future__ import annotations

import time

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.resilience.faults import RetryPolicy
from tpudas_torch.store.base import (
    CASConflictError,
    ObjectStore,
    StoreNetworkError,
)
from tpudas_torch.utils.logging import log_event

__all__ = ["RetryingStore", "STORE_RETRY_POLICY"]

# store ops are cheap and the caller is often a serving thread: tighter
# cap and more attempts than the once-per-round stream policy
STORE_RETRY_POLICY = RetryPolicy(
    max_consecutive=6, base_delay=0.05, max_delay=2.0, multiplier=2.0,
    jitter=0.25,
)


class RetryingStore(ObjectStore):
    """Backend wrapper: absorb network errors per the operation's
    idempotency class.  ``attempts`` = 1 + max retries per call."""

    def __init__(self, inner: ObjectStore,
                 policy: RetryPolicy | None = None,
                 sleep_fn=time.sleep):
        self.inner = inner
        self.policy = policy if policy is not None else STORE_RETRY_POLICY
        self.sleep_fn = sleep_fn
        self.backend = f"retry+{inner.backend}"

    # -- retry machinery ----------------------------------------------
    # both counters carry the wrapped backend's name, so a replicated
    # composite's failover is attributable per member in /metrics
    def _count_retry(self, op: str) -> None:
        get_registry().counter(
            "tpudas_store_retries_total",
            "store calls re-issued after a network error",
            labelnames=("op", "backend"),
        ).inc(op=op, backend=self.inner.backend)

    def _count_exhausted(self, op: str) -> None:
        get_registry().counter(
            "tpudas_store_retry_exhausted_total",
            "store calls that failed every retry attempt "
            "(the member is considered down; replication's handoff "
            "journal / failover ladder takes over)",
            labelnames=("op", "backend"),
        ).inc(op=op, backend=self.inner.backend)

    def _blind(self, op: str, fn):
        """Retry an idempotent call until it answers or patience runs
        out; the last network error propagates for the caller's fault
        boundary."""
        attempts = max(int(self.policy.max_consecutive), 1)
        for attempt in range(attempts):
            try:
                return fn()
            except StoreNetworkError as exc:
                if attempt + 1 >= attempts:
                    self._count_exhausted(op)
                    raise
                self._count_retry(op)
                delay = self.policy.delay(attempt)
                log_event(
                    "store_retry", op=op, attempt=attempt + 1,
                    delay_s=round(delay, 4),
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
                self.sleep_fn(delay)

    # -- the store surface (note: public methods, not hooks — the
    # inner backend already carries spans/metrics/fault sites) --------
    def put(self, key: str, data: bytes) -> str:
        return self._blind("put", lambda: self.inner.put(key, data))

    def get(self, key: str) -> tuple:
        return self._blind("get", lambda: self.inner.get(key))

    def head(self, key: str):
        return self._blind("head", lambda: self.inner.head(key))

    def delete(self, key: str) -> bool:
        return self._blind("delete", lambda: self.inner.delete(key))

    def list(self, prefix: str = "") -> list:
        return self._blind("list", lambda: self.inner.list(prefix))

    def list_uploads(self, prefix: str = "") -> list:
        return self._blind(
            "list", lambda: self.inner.list_uploads(prefix)
        )

    def abort_upload(self, key: str) -> bool:
        return self._blind(
            "delete", lambda: self.inner.abort_upload(key)
        )

    def exists(self, key: str) -> bool:
        return self.head(key) is not None

    def token_for(self, data: bytes) -> str:
        return self.inner.token_for(data)

    def put_if(self, key: str, data: bytes, *,
               if_token: str | None = None,
               if_absent: bool = False) -> str:
        data = bytes(data)
        mine = self.inner.token_for(data)
        ambiguous = False  # a prior attempt MAY have landed unheard
        attempts = max(int(self.policy.max_consecutive), 1)
        for attempt in range(attempts):
            try:
                return self.inner.put_if(
                    key, data, if_token=if_token, if_absent=if_absent
                )
            except CASConflictError as exc:
                # after an ambiguous failure, "conflict, and the
                # object now holds MY token" is the earlier write
                # confirming itself — success, not a lost race
                if ambiguous and exc.current == mine:
                    self._recovered(key, attempt)
                    return mine
                raise
            except StoreNetworkError as exc:
                ambiguous = True
                # ambiguous: did the CAS land before the wire died?
                current = self._current_token_or_none(key)
                if current == mine:
                    self._recovered(key, attempt)
                    return mine
                if attempt + 1 >= attempts:
                    self._count_exhausted("cas")
                    raise
                self._count_retry("cas")
                delay = self.policy.delay(attempt)
                log_event(
                    "store_retry", op="cas", attempt=attempt + 1,
                    delay_s=round(delay, 4),
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
                self.sleep_fn(delay)

    def _recovered(self, key: str, attempt: int) -> None:
        get_registry().counter(
            "tpudas_store_cas_recovered_total",
            "conditional puts whose response was lost but whose write "
            "was confirmed landed by token re-read",
            labelnames=("backend",),
        ).inc(backend=self.inner.backend)
        log_event("store_cas_recovered", key=key, attempt=attempt + 1)

    def _current_token_or_none(self, key: str):
        """Best-effort token re-read for lost-CAS recovery; a network
        error HERE just means we still don't know — treat as
        unrecovered and let the outer loop back off."""
        try:
            return self.inner.head(key)
        except StoreNetworkError:
            return None
