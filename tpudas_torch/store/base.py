"""The object-store contract every storage backend implements.

Everything durable the platform writes falls into exactly two shapes,
and the contract keeps them apart on purpose:

- **Immutable artifacts** — completed ``.tpt``/``.npy`` tiles, done
  markers' *bytes*, committed shard files, stitched results.  Their
  content is a deterministic function of the stream, so writing them
  is an **unconditional put** (:meth:`ObjectStore.put`): a retry, a
  double execution, or a racing worker re-putting the same key simply
  rewrites the same bytes.  Idempotent by construction.
- **Mutable coordination artifacts** — the pyramid manifest and
  tails, backfill leases, done markers' *existence*, plans.  On a
  POSIX filesystem these were guarded by atomic rename; an object
  store has no rename, so they move to **conditional put**
  (:meth:`ObjectStore.put_if`): compare-and-swap on the object's
  token (ETag / generation), ``if_absent=True`` for create-only.
  Exactly-once commit is "my conditional put of the marker won", not
  "my rename won".

**Tokens** are strong, content-derived ETags: ``crc32(bytes)-len``
(S3's real ETag is accepted verbatim where the service supplies one).
Content-derived tokens make lost-response recovery trivial — after a
network error on a CAS, re-read the token: if it equals
``token_of(my_bytes)`` the write landed and the retry is a no-op
(:mod:`tpudas_torch.store.retry`).  The ABA caveat (two writers storing
byte-identical payloads share a token) is harmless here by
construction: every mutable artifact embeds a distinguishing field
(lease token, manifest ``levels``/``generation``, heartbeat).

**Failure taxonomy.**  Backends raise:

- :class:`StoreNetworkError` (the new ``"network"`` fault kind,
  :func:`tpudas_torch.resilience.faults.classify_failure`) for anything a
  retry can fix — connection resets, 5xx, timeouts, a dropped
  response;
- :class:`CASConflictError` when a conditional put's precondition
  failed — NEVER retried blindly (the caller's protocol decides:
  re-read and merge, or concede the race);
- :class:`ObjectNotFoundError` for a missing key (absence is a
  caller decision, exactly like ``FileNotFoundError`` always was).

Every call funnels through two fault-injection sites:
``store.op`` fires BEFORE the backend touches anything (an injected
raise is a 5xx — nothing applied), ``store.op.sent`` fires AFTER a
mutation applied but before the token returns (an injected raise is a
**lost response** — the write landed, the caller never heard).  The
drill harness drives both (``tpudas_torch/tools/backfill_drill.py
--store``).
"""

from __future__ import annotations

import posixpath
import time
import zlib

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import NetworkFaultError, fault_point

__all__ = [
    "CASConflictError",
    "ObjectNotFoundError",
    "ObjectStore",
    "StoreError",
    "StoreNetworkError",
    "token_of",
]


class StoreError(Exception):
    """Base for object-store failures that are neither network nor a
    missing key (bad key, backend misconfiguration)."""


class StoreNetworkError(NetworkFaultError):
    """The storage tier did not give a definitive answer: connection
    reset, 5xx, timeout, dropped response.  The operation may or may
    not have applied — :mod:`tpudas_torch.store.retry` owns resolving that
    ambiguity (blind retry for idempotent ops, token re-read for
    CAS)."""


class ObjectNotFoundError(StoreError):
    """The key does not exist (the object-store ``FileNotFoundError``)."""

    def __init__(self, key: str):
        super().__init__(f"no such object: {key!r}")
        self.key = str(key)


class CASConflictError(StoreError):
    """A conditional put lost: the object's current token does not
    match the precondition.  ``current`` carries the observed token
    when the backend knows it cheaply (None otherwise)."""

    def __init__(self, key: str, expected, current=None):
        super().__init__(
            f"conditional put of {key!r} lost: expected token "
            f"{expected!r}, current {current!r}"
        )
        self.key = str(key)
        self.expected = expected
        self.current = current


def token_of(data: bytes) -> str:
    """The canonical content-derived token (strong ETag) for a
    payload: ``crc32-len``.  Every backend that controls its own
    tokens (posix, fake) uses exactly this, so a caller can always
    answer "did MY bytes land?" from the token alone."""
    return f"{zlib.crc32(bytes(data)) & 0xFFFFFFFF:08x}-{len(data)}"


def _norm_key(key: str) -> str:
    """Keys are ``/``-separated relative paths — no backstepping, no
    absolute keys, no empty segments (the posix backend maps them
    onto a directory tree; the others just benefit from one spelling).
    """
    key = str(key)
    norm = posixpath.normpath(key)
    if (
        not key
        or key.startswith("/")
        or norm.startswith("..")
        or "\\" in key
        or norm in (".", "")
    ):
        raise StoreError(f"invalid object key {key!r}")
    return norm


class ObjectStore:
    """Template-method base: public methods carry the spans, metrics,
    byte accounting, and the two fault-injection sites; backends
    implement the underscore hooks only.

    The mutation hooks (``_put`` / ``_put_if`` / ``_delete``) must be
    atomic per key: a reader never observes partial bytes, and a
    conditional put either wholly applies or raises
    :class:`CASConflictError`."""

    backend = "abstract"

    # -- backend hooks -------------------------------------------------
    def _put(self, key: str, data: bytes) -> str:
        raise NotImplementedError

    def _put_if(self, key, data, if_token, if_absent) -> str:
        raise NotImplementedError

    def _get(self, key: str) -> tuple:
        raise NotImplementedError

    def _head(self, key: str):
        raise NotImplementedError

    def _delete(self, key: str) -> bool:
        raise NotImplementedError

    def _list(self, prefix: str) -> list:
        raise NotImplementedError

    def list_uploads(self, prefix: str = "") -> list:
        """Keys of torn (started, never completed) uploads under
        ``prefix`` — the object-store analogue of a crashed writer's
        tmp file, classified by fsck.  Backends without partial-upload
        visibility return []."""
        return []

    def abort_upload(self, key: str) -> bool:
        """Discard one torn upload named by :meth:`list_uploads`
        (fsck's repair).  Backends without partial-upload state
        return False."""
        return False

    def token_for(self, data: bytes) -> str:
        """The token THIS backend would assign ``data`` — what
        lost-response recovery compares a re-read token against.
        Backends whose service mints its own content-derived ETag
        (S3: MD5) override this to use the same formula."""
        return token_of(data)

    # -- instrumentation ----------------------------------------------
    def _account(self, op: str, t0: float, nbytes: int = 0) -> None:
        reg = get_registry()
        reg.counter(
            "tpudas_store_ops_total",
            "object-store backend calls, by operation",
            labelnames=("op",),
        ).inc(op=op)
        reg.histogram(
            "tpudas_store_op_seconds",
            "object-store backend call latency",
            labelnames=("op",),
        ).observe(time.perf_counter() - t0, op=op)
        if nbytes:
            direction = "put" if op in ("put", "cas") else "get"
            reg.counter(
                "tpudas_store_bytes_total",
                "object payload bytes moved through the store API",
                labelnames=("dir",),
            ).inc(nbytes, dir=direction)

    def _network_error(self, op: str) -> None:
        get_registry().counter(
            "tpudas_store_network_errors_total",
            "backend calls that raised StoreNetworkError "
            "(5xx, timeout, dropped response)",
            labelnames=("op",),
        ).inc(op=op)

    # -- public API ----------------------------------------------------
    def put(self, key: str, data: bytes) -> str:
        """Unconditional atomic write; returns the new token.  The
        immutable-artifact path: callers only use this for payloads
        whose bytes are deterministic, so blind retries and double
        executions are safe."""
        key = _norm_key(key)
        data = bytes(data)
        t0 = time.perf_counter()
        with span("store.put", key=key, backend=self.backend):
            fault_point("store.op", path=key, op="put")
            try:
                token = self._put(key, data)
            except StoreNetworkError:
                self._network_error("put")
                raise
            fault_point("store.op.sent", path=key, op="put")
        self._account("put", t0, len(data))
        return token

    def put_if(
        self, key: str, data: bytes, *,
        if_token: str | None = None, if_absent: bool = False,
    ) -> str:
        """Conditional atomic write (compare-and-swap); returns the
        new token.  ``if_absent=True`` = create-only (S3
        ``If-None-Match: *``); ``if_token`` = replace only while the
        current token matches (``If-Match``).  Exactly one of the two
        must be given.  Raises :class:`CASConflictError` on a lost
        race — the caller's coordination protocol decides what that
        means."""
        key = _norm_key(key)
        data = bytes(data)
        if if_absent == (if_token is not None):
            raise StoreError(
                "put_if needs exactly one precondition: if_token=... "
                "or if_absent=True"
            )
        t0 = time.perf_counter()
        with span("store.cas", key=key, backend=self.backend):
            fault_point("store.op", path=key, op="cas")
            try:
                token = self._put_if(key, data, if_token, if_absent)
            except StoreNetworkError:
                self._network_error("cas")
                raise
            except CASConflictError:
                get_registry().counter(
                    "tpudas_store_cas_conflicts_total",
                    "conditional puts that lost their "
                    "compare-and-swap precondition",
                ).inc()
                raise
            fault_point("store.op.sent", path=key, op="cas")
        self._account("cas", t0, len(data))
        return token

    def get(self, key: str) -> tuple:
        """``(bytes, token)``; raises :class:`ObjectNotFoundError`."""
        key = _norm_key(key)
        t0 = time.perf_counter()
        with span("store.get", key=key, backend=self.backend):
            fault_point("store.op", path=key, op="get")
            try:
                data, token = self._get(key)
            except StoreNetworkError:
                self._network_error("get")
                raise
        self._account("get", t0, len(data))
        return data, token

    def head(self, key: str):
        """The current token, or None when the key is absent (the
        cheap freshness probe manifest polling rides on)."""
        key = _norm_key(key)
        t0 = time.perf_counter()
        with span("store.head", key=key, backend=self.backend):
            fault_point("store.op", path=key, op="head")
            try:
                token = self._head(key)
            except StoreNetworkError:
                self._network_error("head")
                raise
        self._account("head", t0)
        return token

    def delete(self, key: str) -> bool:
        """Idempotent delete; True when an object was removed."""
        key = _norm_key(key)
        t0 = time.perf_counter()
        with span("store.delete", key=key, backend=self.backend):
            fault_point("store.op", path=key, op="delete")
            try:
                removed = self._delete(key)
            except StoreNetworkError:
                self._network_error("delete")
                raise
            fault_point("store.op.sent", path=key, op="delete")
        self._account("delete", t0)
        return bool(removed)

    def list(self, prefix: str = "") -> list:
        """Sorted keys under ``prefix`` (committed objects only —
        torn uploads surface via :meth:`list_uploads`)."""
        prefix = _norm_key(prefix) if prefix else ""
        t0 = time.perf_counter()
        with span("store.list", prefix=prefix, backend=self.backend):
            fault_point("store.op", path=prefix, op="list")
            try:
                keys = sorted(self._list(prefix))
            except StoreNetworkError:
                self._network_error("list")
                raise
        self._account("list", t0)
        return keys

    def exists(self, key: str) -> bool:
        return self.head(key) is not None
