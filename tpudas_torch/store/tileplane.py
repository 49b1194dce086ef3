"""The pyramid over an object store: publisher and remote reader.

The on-disk pyramid layout (``<stream>/.tiles/``: immutable
``L<k>/<idx>.npy|.tpt`` tiles + ``.crc`` sidecars, mutable
``tails.npy`` and ``manifest.json``) maps 1:1 onto object keys under
a stream prefix.  The division of labour:

:class:`PyramidPublisher` — runs beside the WRITER (realtime appender
or backfill stitcher).  After each local append it pushes, in the
same order the local append commits:

1. **tiles** — unconditional puts (immutable; a key that already
   exists holds the identical bytes by determinism, so existing keys
   are skipped outright — the steady-state publish uploads only the
   tiles this append completed);
2. **tails** (+ sidecar) — conditional put on the last-seen token;
3. **manifest** — conditional put LAST, so a remote reader that can
   see a manifest can fetch every tile it references (the same
   crash-ordering argument the local append makes with rename).

The manifest/tails CAS protects the single-writer protocol: a
conflict here is not congestion, it is a SECOND writer publishing the
same stream (split-brain after a botched failover) — surfaced as
:class:`~tpudas_torch.store.base.CASConflictError` after a bounded re-read
loop, never papered over.  Lost responses are absorbed one layer
down by :class:`~tpudas_torch.store.retry.RetryingStore` token re-reads.

:class:`RemotePyramid` — runs beside each READER (a stateless
ServePool worker on any host).  Maintains a local mirror directory in
the exact ``.tiles/`` layout and lets the battle-tested
:class:`~tpudas_torch.serve.tiles.TileStore` read machinery (manifest
fallback, tails pairing, codec decode, checksum gates) work
unchanged on top.  ``refresh()`` is one ``head`` on the manifest key
when nothing changed; on a token change it re-materializes manifest
+ tails and — when the manifest's ``generation`` counter moved —
drops every mirrored tile and cache entry under the stream
(:meth:`~tpudas_torch.store.cache.ReadThroughCache.invalidate_prefix`):
a rebuild re-encodes tiles under unchanged names, and serving the
pre-bump bytes after the CAS bump is exactly the cache-poisoning
race the matrix tests pin.  Tile objects materialize lazily per read
through the cache with ``immutable=True`` (no freshness probe — the
cold tier is not on the steady-state read path at all).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

from tpudas_torch.integrity.checksum import SIDECAR_SUFFIX
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.serve.tiles import (
    MANIFEST_FILENAME,
    TAILS_FILENAME,
    TILE_DIRNAME,
    TileStore,
)
from tpudas_torch.store.base import (
    CASConflictError,
    ObjectNotFoundError,
    ObjectStore,
    StoreError,
)
from tpudas_torch.utils.logging import log_event

__all__ = ["PyramidPublisher", "RemotePyramid", "pyramid_keys"]

_CAS_ATTEMPTS = 4
_BLOB_SUFFIX = ".tpt"


def pyramid_keys(prefix: str) -> dict:
    """The well-known mutable keys for one stream's pyramid."""
    prefix = str(prefix).strip("/")
    join = (lambda n: f"{prefix}/{n}") if prefix else (lambda n: n)
    return {
        "manifest": join(MANIFEST_FILENAME),
        "tails": join(TAILS_FILENAME),
        "tails_crc": join(TAILS_FILENAME + SIDECAR_SUFFIX),
        "tiles": join("L"),  # level dirs all start L<k>/
    }


def _cas_put(store: ObjectStore, key: str, data: bytes, token):
    """One mutable artifact's conditional put: create-only when we
    have never seen a token, If-Match otherwise, with a bounded
    re-read loop for the token we may simply be behind on (our own
    process restarted; the artifact is still single-writer).  Returns
    the new token."""
    for attempt in range(_CAS_ATTEMPTS):
        try:
            if token is None:
                return store.put_if(key, data, if_absent=True)
            return store.put_if(key, data, if_token=token)
        except CASConflictError as exc:
            observed = exc.current
            if observed is None:
                observed = store.head(key)
            if attempt + 1 >= _CAS_ATTEMPTS or observed == token:
                raise
            log_event(
                "store_cas_behind", key=key, attempt=attempt + 1,
                expected=token, observed=observed,
            )
            token = observed
    raise StoreError(f"unreachable CAS loop for {key!r}")


class PyramidPublisher:
    """Mirror one stream's local pyramid into an object store after
    each append.  One instance per writer process; ``publish()`` is
    idempotent and cheap when nothing changed."""

    def __init__(self, store: ObjectStore, prefix: str, folder):
        self.store = store
        self.prefix = str(prefix).strip("/")
        self.folder = str(folder)
        self.keys = pyramid_keys(self.prefix)
        # remote tokens of the mutable artifacts, as last written/seen
        self._tokens: dict = {}
        # immutable keys known present remotely (skip re-upload)
        self._published: set = set()
        self._seeded = False

    def _key(self, rel: str) -> str:
        return f"{self.prefix}/{rel}" if self.prefix else rel

    @property
    def tiles_dir(self) -> str:
        return os.path.join(self.folder, TILE_DIRNAME)

    def _seed(self) -> None:
        """First publish: learn what the store already holds, so a
        restarted publisher re-uploads nothing and CASes against the
        real tokens instead of clobbering blind."""
        listing = (
            self.store.list(self.prefix) if self.prefix
            else self.store.list()
        )
        strip = len(self.prefix) + 1 if self.prefix else 0
        for full in listing:
            rel = full[strip:]
            if rel.startswith("L"):
                self._published.add(rel)
        for name in ("manifest", "tails", "tails_crc"):
            self._tokens[name] = self.store.head(self.keys[name])
        self._seeded = True

    def _local_tiles(self):
        """Relative paths of every immutable artifact currently on
        disk (tile payloads + their sidecars), level dirs only."""
        out = []
        root = self.tiles_dir
        try:
            levels = sorted(os.listdir(root))
        except OSError:
            return out
        for lvl in levels:
            if not lvl.startswith("L"):
                continue
            lvl_dir = os.path.join(root, lvl)
            try:
                names = sorted(os.listdir(lvl_dir))
            except OSError:
                continue
            for name in names:
                if ".tmp." in name:
                    continue
                out.append(f"{lvl}/{name}")
        return out

    def publish(self) -> dict:
        """Push everything the store does not have yet; returns
        ``{"tiles": n_uploaded, "manifest": bool}`` for telemetry."""
        with span("store.publish", prefix=self.prefix):
            if not self._seeded:
                self._seed()
            uploaded = 0
            for rel in self._local_tiles():
                if rel in self._published:
                    continue
                path = os.path.join(self.tiles_dir, rel)
                try:
                    with open(path, "rb") as fh:
                        data = fh.read()
                except OSError:
                    continue  # racing the writer's own rename
                self.store.put(self._key(rel), data)
                self._published.add(rel)
                uploaded += 1
            manifest_moved = self._publish_mutable()
        if uploaded or manifest_moved:
            get_registry().counter(
                "tpudas_store_published_tiles_total",
                "immutable pyramid tile objects uploaded by the "
                "publisher",
            ).inc(uploaded)
            log_event(
                "store_pyramid_published", prefix=self.prefix,
                tiles=uploaded, manifest=manifest_moved,
            )
        return {"tiles": uploaded, "manifest": manifest_moved}

    def _publish_mutable(self) -> bool:
        """Tails then manifest, each CAS'd, each only when the local
        bytes differ from what we last pushed."""
        moved = False
        for name, filename in (
            ("tails", TAILS_FILENAME),
            ("tails_crc", TAILS_FILENAME + SIDECAR_SUFFIX),
            ("manifest", MANIFEST_FILENAME),
        ):
            path = os.path.join(self.tiles_dir, filename)
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError:
                continue  # no pyramid yet / tails not written yet
            if self._tokens.get(name) == self.store.token_for(data):
                continue
            self._tokens[name] = _cas_put(
                self.store, self.keys[name], data,
                self._tokens.get(name),
            )
            if name == "manifest":
                moved = True
        return moved


class RemotePyramid:
    """A read-only pyramid materialized on demand from an object
    store, served through the standard :class:`TileStore` machinery
    over a local mirror directory.  Thread-safe: one instance serves
    every worker thread of a host."""

    def __init__(self, store: ObjectStore, prefix: str, cache,
                 mirror_dir, min_refresh_s: float = 1.0,
                 clock=time.monotonic):
        self.store = store
        self.prefix = str(prefix).strip("/")
        self.cache = cache
        self.mirror = os.path.abspath(str(mirror_dir))
        self.keys = pyramid_keys(self.prefix)
        self.min_refresh_s = float(min_refresh_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._manifest_token = None
        self._generation = None
        self._last_probe = None
        self._stale = False  # last probe failed; serving mirror as-is
        os.makedirs(
            os.path.join(self.mirror, TILE_DIRNAME), exist_ok=True
        )

    # -- mirror plumbing ----------------------------------------------
    def _mirror_path(self, rel: str) -> str:
        return os.path.join(
            self.mirror, TILE_DIRNAME, *rel.split("/")
        )

    def _write_mirror(self, rel: str, data: bytes) -> None:
        path = self._mirror_path(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def _key(self, rel: str) -> str:
        return f"{self.prefix}/{rel}" if self.prefix else rel

    # -- refresh -------------------------------------------------------
    def refresh(self, force: bool = False) -> "RemotePyramid":
        """Probe the manifest token (rate-limited to
        ``min_refresh_s``); re-materialize manifest + tails when it
        moved, and drop mirrored tiles + cache entries when the
        manifest ``generation`` moved with it."""
        with self._lock:
            now = self.clock()
            if (not force and self._last_probe is not None
                    and now - self._last_probe < self.min_refresh_s):
                return self
            self._last_probe = now
            try:
                token = self.store.head(self.keys["manifest"])
            except OSError:
                # cold tier down: keep serving the current mirror
                # (its tiles verify locally); flag for /healthz
                if not self._stale:
                    log_event(
                        "store_remote_pyramid_stale", prefix=self.prefix
                    )
                self._stale = True
                return self
            self._stale = False
            if token is None or token == self._manifest_token:
                return self
            self._materialize_mutable(token)
        return self

    def _materialize_mutable(self, token: str) -> None:
        try:
            data, token = self.store.get(self.keys["manifest"])
        except ObjectNotFoundError:
            return
        generation = _manifest_generation(data)
        if (self._generation is not None
                and generation != self._generation):
            self._invalidate_tiles(generation)
        self._generation = generation
        for name, filename in (
            ("tails", TAILS_FILENAME),
            ("tails_crc", TAILS_FILENAME + SIDECAR_SUFFIX),
        ):
            try:
                blob, _tok = self.store.get(self.keys[name])
            except ObjectNotFoundError:
                continue
            self._write_mirror(filename, blob)
        # manifest LAST: a reader that sees it finds tails in place
        self._write_mirror(MANIFEST_FILENAME, data)
        self._manifest_token = token
        log_event(
            "store_remote_pyramid_refreshed", prefix=self.prefix,
            generation=generation,
        )

    def _invalidate_tiles(self, new_generation) -> None:
        """A generation bump re-encoded tiles under unchanged names:
        every mirrored/cached pre-bump object is now poison."""
        root = os.path.join(self.mirror, TILE_DIRNAME)
        try:
            entries = os.listdir(root)
        except OSError:
            entries = []
        for name in entries:
            if name.startswith("L"):
                shutil.rmtree(os.path.join(root, name),
                              ignore_errors=True)
        dropped = 0
        if self.cache is not None:
            dropped = self.cache.invalidate_prefix(self.prefix)
        get_registry().counter(
            "tpudas_store_generation_invalidations_total",
            "remote-pyramid generation bumps that flushed mirrored "
            "tiles and cache entries",
        ).inc()
        log_event(
            "store_remote_pyramid_invalidated", prefix=self.prefix,
            generation=new_generation, cache_dropped=dropped,
        )

    # -- reads ---------------------------------------------------------
    def open(self):
        """The mirror's :class:`TileStore` (None before the first
        successful refresh materializes a manifest)."""
        self.refresh()
        return TileStore.open(self.mirror)

    def _fetch_tile(self, ts: TileStore, level: int, tile_idx: int) -> (
        None
    ):
        """Materialize one tile object into the mirror if it is not
        already there — blob format first when the manifest says the
        store is codec'd, raw ``.npy`` (+ sidecar) otherwise, each
        falling back to the other (mixed-format stores read file by
        file, same as local)."""
        rel_blob = f"L{int(level)}/{int(tile_idx):08d}{_BLOB_SUFFIX}"
        rel_raw = f"L{int(level)}/{int(tile_idx):08d}.npy"
        order = (rel_blob, rel_raw) if ts.codec else (rel_raw, rel_blob)
        for rel in order:
            if os.path.isfile(self._mirror_path(rel)):
                return
            try:
                if self.cache is not None:
                    data, _tok = self.cache.get_through(
                        self.store, self._key(rel), immutable=True
                    )
                else:
                    data, _tok = self.store.get(self._key(rel))
            except ObjectNotFoundError:
                continue
            self._write_mirror(rel, data)
            if rel == rel_raw:
                # raw tiles read through the sidecar checksum gate;
                # the sidecar is write-once alongside its tile, so it
                # rides the cache too — a restarted replica pays no
                # cold-tier round trip for it, and an outage serves
                # the cached copy instead of failing the tile
                side_key = self._key(rel + SIDECAR_SUFFIX)
                try:
                    if self.cache is not None:
                        side, _t = self.cache.get_through(
                            self.store, side_key, immutable=True
                        )
                    else:
                        side, _t = self.store.get(side_key)
                    self._write_mirror(rel + SIDECAR_SUFFIX, side)
                except ObjectNotFoundError:
                    pass
            return

    def prefetch(self, ts: TileStore, level, lo, hi) -> None:
        """Materialize every COMPLETED tile object the ``[lo, hi)``
        row window of ``level`` needs — the
        :class:`~tpudas_torch.serve.query.QueryEngine` ``tile_prefetch``
        hook.  The partial head tile has no object behind it (its
        rows live in ``tails``, already mirrored by ``refresh``), so
        it is never fetched — which also keeps a cold-tier outage off
        the head-of-stream read path entirely."""
        tl = ts.tile_len
        n_full_tiles = int(ts.n(level)) // tl
        lo_i = max(int(lo), 0)
        hi_i = min(int(hi), n_full_tiles * tl)
        if hi_i > lo_i:
            for t_idx in range(lo_i // tl, (hi_i - 1) // tl + 1):
                self._fetch_tile(ts, level, t_idx)

    def read(self, level, lo, hi, agg="mean", loader=None):
        """:meth:`TileStore.read` over the mirror, materializing the
        tiles the window needs first.  ``loader`` passes through (the
        query engine's decoded-tile LRU stacks on top unchanged)."""
        ts = self.open()
        if ts is None:
            raise ObjectNotFoundError(self.keys["manifest"])
        self.prefetch(ts, level, lo, hi)
        return ts.read(level, int(lo), int(hi), agg, loader=loader)

    # -- health --------------------------------------------------------
    def snapshot(self) -> dict:
        out = {
            "prefix": self.prefix,
            "generation": self._generation,
            "manifest_token": self._manifest_token,
            "stale": self._stale,
        }
        if self.cache is not None:
            out["cache"] = self.cache.snapshot()
        from tpudas_torch.store.replica import find_replicated

        repl = find_replicated(self.store)
        if repl is not None:
            out["replication"] = repl.snapshot()
        return out


def _manifest_generation(data: bytes) -> int:
    """The ``generation`` counter from raw manifest bytes (0 when
    unparseable — the verified parse happens in TileStore; this is
    only the invalidation trigger)."""
    try:
        return int(json.loads(data.decode()).get("generation", 0))
    except (ValueError, AttributeError, TypeError):
        return 0
