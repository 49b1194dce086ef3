"""Read-through object cache: local NVMe under the remote cold tier.

Sits between a remote :class:`~tpudas_torch.store.base.ObjectStore` and the
serving path (below the in-memory query LRU — that one caches decoded
windows, this one caches object BYTES so a worker restart or a cold
query only pays the wide-area fetch once per object per host).

Entry files are self-describing: a tiny JSON header (key, token,
crc32, length) followed by the payload, under a content-hashed
filename.  Every read re-verifies the payload crc against the header
— a torn or bit-flipped cache file is deleted and treated as a miss,
never served.  That verification is what makes DEGRADED mode honest:

- **Healthy path**: ``head`` the store for the current token; token
  matches a cached entry → hit (no remote read); otherwise ``get``,
  serve, and fill.
- **Cold tier down** (``head``/``get`` raise the ``network`` kind
  after retries): serve the newest cached entry for the key if its
  crc still verifies — *stale-but-verified* — counted in
  ``tpudas_store_cache_stale_served_total`` and surfaced in
  ``/healthz`` via :meth:`snapshot`.  No cached entry → the network
  error propagates (the caller's degradation ladder takes over).

Immutable artifacts (tiles) are also safe to serve WITHOUT the
``head`` freshness probe — :meth:`get_through` with
``immutable=True`` skips it, hiding cold-tier latency entirely on the
hot path.  Mutable artifacts must keep the probe; the
generation-bump invalidation (:meth:`invalidate_prefix`, driven by
the pyramid's ``generation`` counter) is what prevents a stale object
from being served after a CAS bump — the cache-poisoning case in the
race-matrix tests.

Eviction is LRU by payload bytes against ``max_bytes``.  The index is
in-memory, rebuilt from entry headers at construction, so a restarted
worker inherits a warm cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from collections import OrderedDict

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.store.base import ObjectNotFoundError, StoreNetworkError
from tpudas_torch.utils.logging import log_event

__all__ = ["ReadThroughCache"]

_MAGIC = b"tpoc1\n"


def _entry_name(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:32] + ".obj"


class ReadThroughCache:
    """Byte cache for one remote store; safe for concurrent readers.

    ``max_bytes`` bounds payload bytes (headers are noise); 0 disables
    caching entirely (every read is a remote read — the control
    configuration benches compare against)."""

    def __init__(self, cache_dir: str, max_bytes: int = 1 << 30):
        self.dir = os.path.abspath(str(cache_dir))
        self.max_bytes = int(max_bytes)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # key -> {token, name, nbytes}; order = LRU (oldest first)
        self._index: OrderedDict = OrderedDict()
        self._bytes = 0
        self._degraded = False
        self._stale_served = 0
        self._rebuild_index()
        self._gauges()

    # -- metrics -------------------------------------------------------
    def _count(self, which: str) -> None:
        get_registry().counter(
            "tpudas_store_cache_events_total",
            "read-through cache outcomes (hit/miss/stale_served/"
            "evicted/invalidated/corrupt)",
            labelnames=("event",),
        ).inc(event=which)

    def _gauges(self) -> None:
        reg = get_registry()
        reg.gauge(
            "tpudas_store_cache_bytes",
            "payload bytes currently held by the read-through cache",
        ).set(self._bytes)
        reg.gauge(
            "tpudas_store_degraded",
            "1 while the cold tier is unreachable and the cache is "
            "serving stale-but-verified objects",
        ).set(1.0 if self._degraded else 0.0)

    # -- index / files -------------------------------------------------
    def _rebuild_index(self) -> None:
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(".obj"):
                continue
            meta = self._read_header(os.path.join(self.dir, name))
            if meta is None:
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
                continue
            self._index[meta["key"]] = {
                "token": meta["token"], "name": name,
                "nbytes": int(meta["len"]),
            }
            self._bytes += int(meta["len"])

    def _read_header(self, path: str):
        try:
            with open(path, "rb") as fh:
                if fh.read(len(_MAGIC)) != _MAGIC:
                    return None
                line = fh.readline(4096)
            meta = json.loads(line)
            if not all(k in meta for k in ("key", "token", "crc", "len")):
                return None
            return meta
        except (OSError, ValueError):
            return None

    def _read_entry(self, key: str, entry):
        """Verified payload bytes, or None (corrupt entries are
        deleted on the spot)."""
        path = os.path.join(self.dir, entry["name"])
        try:
            with open(path, "rb") as fh:
                if fh.read(len(_MAGIC)) != _MAGIC:
                    raise ValueError("bad magic")
                meta = json.loads(fh.readline(4096))
                data = fh.read()
            if meta.get("key") != key or len(data) != int(meta["len"]):
                raise ValueError("header mismatch")
            if (zlib.crc32(data) & 0xFFFFFFFF) != int(meta["crc"]):
                raise ValueError("crc mismatch")
            return data
        except (OSError, ValueError):
            self._count("corrupt")
            self._drop(key)
            return None

    def _write_entry(self, key: str, token: str, data: bytes) -> None:
        if self.max_bytes <= 0 or len(data) > self.max_bytes:
            return
        name = _entry_name(key)
        header = json.dumps({
            "key": key, "token": token,
            "crc": zlib.crc32(data) & 0xFFFFFFFF, "len": len(data),
        }).encode() + b"\n"
        path = os.path.join(self.dir, name)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(header)
                fh.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._drop(key, unlink=False)
        self._index[key] = {
            "token": token, "name": name, "nbytes": len(data),
        }
        self._bytes += len(data)
        self._evict()
        self._gauges()

    def _drop(self, key: str, unlink: bool = True) -> None:
        entry = self._index.pop(key, None)
        if entry is None:
            return
        self._bytes -= int(entry["nbytes"])
        if unlink:
            try:
                os.unlink(os.path.join(self.dir, entry["name"]))
            except OSError:
                pass

    def _evict(self) -> None:
        while self._bytes > self.max_bytes and self._index:
            key = next(iter(self._index))
            self._drop(key)
            self._count("evicted")

    # -- the public surface --------------------------------------------
    def get_through(self, store, key: str, immutable: bool = False):
        """``(data, token)`` via the cache.  ``immutable=True`` trusts
        any cached entry without a freshness probe (correct only for
        content-addressed / write-once keys like committed tiles)."""
        with self._lock:
            entry = self._index.get(key)
            if entry is not None and immutable:
                data = self._read_entry(key, entry)
                if data is not None:
                    self._index.move_to_end(key)
                    self._count("hit")
                    return data, entry["token"]
                entry = None
            try:
                current = store.head(key) if entry is not None else None
            except StoreNetworkError:
                return self._serve_stale(key, entry, "head")
            if entry is not None and current == entry["token"]:
                data = self._read_entry(key, entry)
                if data is not None:
                    self._index.move_to_end(key)
                    self._count("hit")
                    self._note_healthy()
                    return data, entry["token"]
            try:
                data, token = store.get(key)
            except StoreNetworkError:
                return self._serve_stale(key, entry, "get")
            except ObjectNotFoundError:
                self._drop(key)
                self._note_healthy()
                raise
            self._count("miss")
            self._write_entry(key, token, data)
            self._note_healthy()
            return data, token

    def _serve_stale(self, key: str, entry, where: str):
        if entry is None:
            entry = self._index.get(key)
        data = None if entry is None else self._read_entry(key, entry)
        if data is None:
            raise StoreNetworkError(
                f"cold tier unreachable at {where} and no verified "
                f"cache entry for {key!r}"
            )
        if not self._degraded:
            log_event("store_cache_degraded", key=key, where=where)
        self._degraded = True
        self._stale_served += 1
        self._count("stale_served")
        get_registry().counter(
            "tpudas_store_cache_stale_served_total",
            "objects served from the cache while the cold tier was "
            "unreachable (stale-but-verified degradation)",
        ).inc()
        self._index.move_to_end(key)
        self._gauges()
        return data, entry["token"]

    def _note_healthy(self) -> None:
        if self._degraded:
            log_event("store_cache_recovered")
        self._degraded = False
        self._gauges()

    def invalidate_prefix(self, prefix: str) -> int:
        """Drop every cached key under ``prefix`` — the generation-
        bump hook that makes a CAS bump of the manifest also kill any
        object the bump superseded (cache-poisoning defense)."""
        with self._lock:
            doomed = [
                k for k in self._index
                if not prefix or k == prefix
                or k.startswith(prefix.rstrip("/") + "/")
            ]
            for k in doomed:
                self._drop(k)
                self._count("invalidated")
            self._gauges()
            return len(doomed)

    def degraded(self) -> bool:
        return self._degraded

    def snapshot(self) -> dict:
        """The ``/healthz`` store block."""
        with self._lock:
            return {
                "degraded": self._degraded,
                "entries": len(self._index),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "stale_served": self._stale_served,
            }
