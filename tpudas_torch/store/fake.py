"""An in-process fake object store with scriptable failure.

This is the drill substrate: a dict behind a lock with S3 semantics
(atomic puts, conditional puts on content tokens, prefix list) plus a
:class:`FaultInjector` that scripts the failure modes a real object
store exhibits:

- ``"unavailable"`` — the call raises :class:`StoreNetworkError`
  BEFORE anything applies (a 5xx / connection reset).  Blind retry
  safe.
- ``"lost"`` — a mutation APPLIES, then the response is dropped
  (:class:`StoreNetworkError` after the dict updated).  The lost-CAS
  case: the write landed, the writer never learned its token.
- ``"torn"`` — an upload records a partial-object marker (visible via
  :meth:`FakeObjectStore.list_uploads`, like an abandoned S3
  multipart upload) and raises.  The committed object space is
  untouched — readers never see partial bytes, but fsck must find and
  classify the debris.
- ``"latency"`` — the call sleeps first (a slow cold tier; not a
  failure).
- ``"partition"`` — ``offline`` scoped by the rule's (op, match)
  filter: every accepted call raises :class:`StoreNetworkError`
  before anything applies, with an UNBOUNDED window by default.  This
  is how replication drills sever ONE mirror (or one key prefix)
  while the rest of the fake keeps answering — add with
  :meth:`FaultInjector.partition`, lift with
  :meth:`FaultInjector.heal`.

Rules fire by (op, key-substring) with 1-based hit windows, mirroring
:class:`tpudas_torch.resilience.faults.FaultSpec` so drill scripts read the
same either way.  ``offline=True`` fails EVERY call — the
cold-tier-down drill the cache's stale-serving ladder is tested
against.  All mutations of the injector are thread-safe; drills flip
``offline`` (or partition rules) while reader threads run.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from tpudas_torch.store.base import (
    CASConflictError,
    ObjectNotFoundError,
    ObjectStore,
    StoreNetworkError,
    token_of,
)

__all__ = ["FakeObjectStore", "FaultInjector", "FaultRule"]

_KINDS = ("unavailable", "lost", "torn", "latency", "partition")


@dataclass
class FaultRule:
    """Fire ``kind`` on hits ``[at, at + times)`` of calls whose op is
    ``op`` (or any op when None) and whose key contains ``match`` (or
    any key when None).  Hit counting is per-rule: every call the
    (op, match) filter accepts advances it."""

    kind: str
    op: str | None = None  # put | cas | get | head | delete | list
    match: str | None = None
    at: int = 1
    times: int = 1
    seconds: float = 0.0  # latency kind
    hits: int = 0  # advanced by the injector

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {_KINDS}"
            )


class FaultInjector:
    """Scriptable failure for :class:`FakeObjectStore`.  ``fired``
    logs ``(kind, op, key, hit)`` tuples for drill assertions."""

    def __init__(self, *rules: FaultRule, offline: bool = False,
                 sleep_fn=time.sleep):
        self._lock = threading.Lock()
        self.rules = list(rules)
        self.offline = bool(offline)
        self.sleep_fn = sleep_fn
        self.fired: list = []

    def add(self, rule: FaultRule) -> None:
        with self._lock:
            self.rules.append(rule)

    def set_offline(self, offline: bool) -> None:
        with self._lock:
            self.offline = bool(offline)

    def partition(self, match: str | None = None,
                  op: str | None = None) -> FaultRule:
        """Sever every call accepted by (op, match) until healed — an
        unbounded ``partition`` rule.  ``match=None`` partitions the
        whole store (equivalent to ``offline`` but heal-able per
        rule); a key-prefix ``match`` severs one subtree while the
        rest keeps answering.  Returns the rule for
        :meth:`heal`."""
        rule = FaultRule("partition", op=op, match=match,
                         at=1, times=1 << 30)
        self.add(rule)
        return rule

    def heal(self, rule_or_match) -> int:
        """Remove partition rules: by the exact rule object
        :meth:`partition` returned, or every partition rule whose
        ``match`` equals the given string (None heals the
        match-everything rules).  Returns how many were lifted."""
        with self._lock:
            if isinstance(rule_or_match, FaultRule):
                doomed = [r for r in self.rules if r is rule_or_match]
            else:
                doomed = [
                    r for r in self.rules
                    if r.kind == "partition"
                    and r.match == rule_or_match
                ]
            for r in doomed:
                self.rules.remove(r)
        return len(doomed)

    def _match(self, op: str, key: str):
        """Advance matching rules; return the kinds due to fire, in
        rule order, latency first so a slow-then-dead tier scripts
        naturally."""
        due = []
        with self._lock:
            if self.offline:
                self.fired.append(("offline", op, key, 0))
                return ["offline"]
            for rule in self.rules:
                if rule.op is not None and rule.op != op:
                    continue
                if rule.match is not None and rule.match not in key:
                    continue
                rule.hits += 1
                if rule.at <= rule.hits < rule.at + rule.times:
                    self.fired.append((rule.kind, op, key, rule.hits))
                    due.append(rule)
        due.sort(key=lambda r: r.kind != "latency")
        return due

    def before(self, op: str, key: str):
        """Pre-apply phase: latency sleeps and clean failures.
        Returns the list of kinds deferred to the post-apply phase
        (``lost``)."""
        deferred = []
        for rule in self._match(op, key):
            if rule == "offline":
                raise StoreNetworkError(
                    f"fake store offline: {op} {key!r}"
                )
            if rule.kind == "latency":
                self.sleep_fn(rule.seconds)
            elif rule.kind == "unavailable":
                raise StoreNetworkError(
                    f"injected 5xx before {op} {key!r} "
                    f"(hit {rule.hits})"
                )
            elif rule.kind == "partition":
                raise StoreNetworkError(
                    f"injected partition before {op} {key!r} "
                    f"(match {rule.match!r})"
                )
            else:
                deferred.append(rule)
        return deferred

    def after(self, deferred, op: str, key: str) -> None:
        """Post-apply phase: the mutation landed; drop the response."""
        for rule in deferred:
            if rule.kind == "lost":
                raise StoreNetworkError(
                    f"injected lost response after {op} {key!r} "
                    f"(hit {rule.hits})"
                )


class FakeObjectStore(ObjectStore):
    """The in-memory S3: committed objects in a dict, torn uploads in
    a separate set, every byte copied on the way in and out."""

    backend = "fake"

    def __init__(self, injector: FaultInjector | None = None):
        self.injector = injector if injector is not None else (
            FaultInjector()
        )
        self._lock = threading.RLock()
        self._objects: dict = {}  # key -> bytes
        self._uploads: set = set()  # keys with abandoned partials

    # -- drill helpers -------------------------------------------------
    def snapshot_keys(self) -> list:
        with self._lock:
            return sorted(self._objects)

    def clear_upload(self, key: str) -> None:
        self.abort_upload(key)

    def abort_upload(self, key: str) -> bool:
        with self._lock:
            present = str(key) in self._uploads
            self._uploads.discard(str(key))
        return present

    # -- backend hooks -------------------------------------------------
    def _apply_put(self, key: str, data: bytes, *, torn) -> None:
        if torn:
            with self._lock:
                self._uploads.add(key)
            raise StoreNetworkError(
                f"injected torn upload of {key!r}"
            )
        with self._lock:
            self._objects[key] = bytes(data)
            self._uploads.discard(key)

    def _put(self, key: str, data: bytes) -> str:
        deferred = self.injector.before("put", key)
        torn = [r for r in deferred if r.kind == "torn"]
        self._apply_put(key, data, torn=torn)
        self.injector.after(deferred, "put", key)
        return token_of(data)

    def _put_if(self, key, data, if_token, if_absent) -> str:
        deferred = self.injector.before("cas", key)
        torn = [r for r in deferred if r.kind == "torn"]
        with self._lock:
            current = self._objects.get(key)
            cur_token = None if current is None else token_of(current)
            if if_absent:
                if cur_token is not None:
                    raise CASConflictError(key, None, cur_token)
            elif cur_token != if_token:
                raise CASConflictError(key, if_token, cur_token)
            self._apply_put(key, data, torn=torn)
        self.injector.after(deferred, "cas", key)
        return token_of(data)

    def _get(self, key: str) -> tuple:
        self.injector.before("get", key)
        with self._lock:
            data = self._objects.get(key)
        if data is None:
            raise ObjectNotFoundError(key)
        return bytes(data), token_of(data)

    def _head(self, key: str):
        self.injector.before("head", key)
        with self._lock:
            data = self._objects.get(key)
        return None if data is None else token_of(data)

    def _delete(self, key: str) -> bool:
        deferred = self.injector.before("delete", key)
        with self._lock:
            removed = self._objects.pop(key, None) is not None
        self.injector.after(deferred, "delete", key)
        return removed

    def _list(self, prefix: str) -> list:
        self.injector.before("list", prefix)
        with self._lock:
            if not prefix:
                return list(self._objects)
            return [
                k for k in self._objects
                if k == prefix or k.startswith(prefix + "/")
            ]

    def list_uploads(self, prefix: str = "") -> list:
        with self._lock:
            keys = sorted(self._uploads)
        if not prefix:
            return keys
        return [
            k for k in keys
            if k == prefix or k.startswith(prefix + "/")
        ]
