"""Object-store tile plane: pluggable storage backends.

Public surface:

- :mod:`tpudas_torch.store.base` — the contract (put / put_if CAS / get /
  head / delete / list), errors, content-derived tokens;
- :mod:`tpudas_torch.store.posix` / :mod:`tpudas_torch.store.s3` /
  :mod:`tpudas_torch.store.fake` — the three backends;
- :mod:`tpudas_torch.store.retry` — idempotency-aware network-error retry;
- :mod:`tpudas_torch.store.replica` — primary + N-mirror replication with
  hinted handoff, anti-entropy scrub, and promotion;
- :mod:`tpudas_torch.store.cache` — the NVMe read-through tier;
- :mod:`tpudas_torch.store.tileplane` — the pyramid publisher and the
  remote (multi-host) pyramid reader;
- :func:`store_from_url` — one string configures the whole plane.
"""

from __future__ import annotations

from tpudas_torch.store.base import (
    CASConflictError,
    ObjectNotFoundError,
    ObjectStore,
    StoreError,
    StoreNetworkError,
    token_of,
)
from tpudas_torch.store.cache import ReadThroughCache
from tpudas_torch.store.fake import FakeObjectStore, FaultInjector, FaultRule
from tpudas_torch.store.posix import PosixStore
from tpudas_torch.store.replica import ReplicatedStore, find_replicated
from tpudas_torch.store.retry import STORE_RETRY_POLICY, RetryingStore
from tpudas_torch.store.tileplane import PyramidPublisher, RemotePyramid

__all__ = [
    "CASConflictError",
    "FakeObjectStore",
    "FaultInjector",
    "FaultRule",
    "ObjectNotFoundError",
    "ObjectStore",
    "PosixStore",
    "PyramidPublisher",
    "ReadThroughCache",
    "RemotePyramid",
    "ReplicatedStore",
    "RetryingStore",
    "STORE_RETRY_POLICY",
    "StoreError",
    "StoreNetworkError",
    "find_replicated",
    "store_from_url",
    "token_of",
]

# one process-wide fake per URL tag, so every component a test wires
# with "fake:xyz" talks to the SAME in-memory store (mirrors how every
# component pointed at one bucket shares state)
_FAKES: dict = {}


def store_from_url(url: str, retry: bool = True,
                   policy=None, sleep_fn=None) -> ObjectStore:
    """Build a (by default retry-wrapped) backend from a URL:

    - ``file:///abs/path`` or a bare path → :class:`PosixStore`;
    - ``s3://bucket/prefix`` → :class:`S3Store` (needs boto3 or an
      injected client — construct directly for the latter);
    - ``fake:`` / ``fake:tag`` → a process-shared
      :class:`FakeObjectStore` per tag (tests, drills);
    - ``replica:urlA,urlB,...`` → a
      :class:`~tpudas_torch.store.replica.ReplicatedStore` over the listed
      members — FIRST is the primary, the rest are mirrors (any mix
      of the schemes above).  Each member is built through this
      function (so each is individually retry-wrapped when
      ``retry=True``); the composite itself is never retry-wrapped —
      the members already absorb transient faults, and a member that
      stays down is what the handoff journal and failover ladder are
      for.  The handoff journal lives under ``TPUDAS_REPLICA_JOURNAL``
      (a fresh tempdir otherwise).

    ``retry=False`` returns the raw backend (drills that must see
    every injected fault exactly once)."""
    url = str(url)
    if url.startswith("replica:"):
        specs = [s.strip() for s in url[len("replica:"):].split(",")]
        specs = [s for s in specs if s]
        if len(specs) < 2:
            raise StoreError(
                f"replica url needs a primary and >=1 mirror: {url!r}"
            )
        members = [
            store_from_url(s, retry=retry, policy=policy,
                           sleep_fn=sleep_fn)
            for s in specs
        ]
        return ReplicatedStore(members[0], members[1:])
    if url.startswith("fake:"):
        tag = url[len("fake:"):]
        store = _FAKES.get(tag)
        if store is None:
            store = _FAKES[tag] = FakeObjectStore()
    elif url.startswith("s3://"):
        from tpudas_torch.store.s3 import S3Store

        rest = url[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise StoreError(f"s3 url missing bucket: {url!r}")
        store = S3Store(bucket, prefix)
    else:
        if url.startswith("file://"):
            url = url[len("file://"):]
        store = PosixStore(url)
    if not retry:
        return store
    kwargs = {}
    if policy is not None:
        kwargs["policy"] = policy
    if sleep_fn is not None:
        kwargs["sleep_fn"] = sleep_fn
    return RetryingStore(store, **kwargs)
