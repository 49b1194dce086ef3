"""Window queries over the tile pyramid (with full-resolution fallback).

The port's counterpart of :mod:`tpudas.serve.query`: the same level
choice, fallbacks, cache keys and results, over a ``.tiles/`` folder
either package wrote.  Host code (numpy); the reductions it does on the
fly go through :func:`tpudas_torch.serve.tiles.block_reduce`.

``QueryEngine.query(t0, t1, ...)`` answers a time x distance window
read in three steps:

1. **Level choice** — the coarsest pyramid level whose sample step
   still satisfies the requested ``resolution`` (seconds per sample) or
   ``max_samples`` budget; no constraint means full resolution.
2. **Tile assembly** — the window's tiles, through an LRU tile cache
   with **single-flight request coalescing**: concurrent identical tile
   loads share ONE disk read (the leader loads, followers wait on its
   event), so a thundering herd of dashboard clients costs one IO.
   Cache keys include the tile's valid-row count, so a growing tail
   tile is re-fetched after each pyramid append while full tiles stay
   cached forever (they are immutable).
3. **Full-resolution fallback** — windows (or window prefixes) older
   than the pyramid are served from the original output files via the
   :class:`tpudas_torch.io.index.DirectoryIndex` time-range lookup, reduced
   on the fly to the chosen level's grid so a straddling window comes
   back on ONE uniform grid.

Results are honest about gaps: rows with no underlying data are NaN.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.io.index import DirectoryIndex
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.serve.tiles import AGGS, TileStore, block_reduce
from tpudas_torch.utils.logging import log_event

__all__ = ["QueryEngine", "QueryResult"]

_DEFAULT_CACHE_TILES = 256


@dataclass
class QueryResult:
    """One answered window query.

    ``times`` (datetime64[ns], leading-edge sample times), ``distance``
    (channel coordinates), ``data`` (times x distance, NaN where the
    stream has no data), plus the provenance the HTTP layer surfaces in
    response headers: pyramid ``level``, grid ``step_ns``, aggregate,
    and ``source`` ("tiles" | "files" | "mixed" | "empty").
    """

    times: np.ndarray
    distance: np.ndarray
    data: np.ndarray
    level: int
    step_ns: int
    agg: str
    source: str
    # True when the window was served ENTIRELY from completed
    # (immutable) full tiles: the response bytes can never change
    # short of a pyramid rebuild, so the HTTP layer may mark it
    # CDN-cacheable forever (SERVING.md "CDN deployment")
    immutable: bool = False

    @property
    def n_samples(self) -> int:
        return int(self.data.shape[0])


class _Flight:
    """One in-flight tile load (single-flight slot)."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


class QueryEngine:
    """Cached, coalesced window reads over one output folder."""

    def __init__(self, folder, cache_tiles: int = _DEFAULT_CACHE_TILES,
                 engine=None, tile_prefetch=None):
        self.folder = str(folder)
        self.engine = engine
        # optional hook ``(store, level, lo, hi)`` called before a
        # pyramid read: a RemotePyramid materializes the window's tile
        # objects into the local mirror so TileStore finds them
        # (tpudas_torch.store.tileplane; None on a plain local folder)
        self.tile_prefetch = tile_prefetch
        self._store = TileStore.open(self.folder, engine=engine)
        self._index = DirectoryIndex(self.folder)
        self._cache: OrderedDict = OrderedDict()
        self._cache_cap = max(int(cache_tiles), 1)
        self._lock = threading.Lock()  # cache + in-flight table
        self._inflight: dict = {}
        # DirectoryIndex mutates its record dict in update(); two
        # concurrent fallback queries must not interleave an update
        # with a time_range_records iteration
        self._index_lock = threading.Lock()

    # -- store visibility ---------------------------------------------
    @property
    def store(self) -> TileStore | None:
        return self._store

    def has_pyramid(self) -> bool:
        """True when the folder has a (readable, non-empty) tile
        pyramid right now — cheap gate for callers that only want the
        engine when it can actually beat a full-resolution read
        (e.g. ``patch_waterfall``)."""
        store = self._refresh_store()
        return store is not None and store.head_ns is not None

    def _refresh_store(self) -> TileStore | None:
        """Pick up pyramid growth since the last query (the writer
        appends between polls; the manifest is the consistency
        point)."""
        if self._store is None:
            self._store = TileStore.open(self.folder, engine=self.engine)
        else:
            self._store.refresh()
        return self._store

    # -- the tile cache ------------------------------------------------
    def _tile_key(self, store, level, tile_idx):
        # keyed on (tile, valid rows, store generation, codec): valid
        # refreshes the growing head tile per append; generation+codec
        # key out a rebuild_pyramid re-encode — same tile index,
        # different bytes — so a re-encoded store can never serve a
        # stale pre-rebuild decoded array
        valid = min(
            store.tile_len, store.n(level) - tile_idx * store.tile_len
        )
        return (
            int(level), int(tile_idx), int(valid),
            int(store.generation), store.codec or "raw",
        )

    def cache_info(self) -> dict:
        with self._lock:
            return {
                "tiles": len(self._cache),
                "capacity": self._cache_cap,
            }

    def _cached_loader(self, store):
        """A ``loader(level, tile_idx)`` for :meth:`TileStore.read`
        that goes through the LRU cache with single-flight
        coalescing."""
        reg = get_registry()

        def load(level, tile_idx):
            key = self._tile_key(store, level, tile_idx)
            while True:
                with self._lock:
                    hit = self._cache.get(key)
                    if hit is not None:
                        self._cache.move_to_end(key)
                        reg.counter(
                            "tpudas_serve_cache_hits_total",
                            "tile reads answered from the LRU cache",
                        ).inc()
                        return hit
                    flight = self._inflight.get(key)
                    leader = flight is None
                    if leader:
                        flight = self._inflight[key] = _Flight()
                if not leader:
                    reg.counter(
                        "tpudas_serve_singleflight_coalesced_total",
                        "tile loads that waited on an identical "
                        "in-flight load instead of hitting disk",
                    ).inc()
                    flight.event.wait()
                    if flight.error is None:
                        return flight.value
                    # leader failed: surface the same failure here (a
                    # retry loop would hide real IO errors)
                    raise flight.error
                # from here on the leader MUST reach the finally that
                # sets flight.event / clears _inflight — even the
                # counter update stays inside, or a raise would wedge
                # every future request for this tile on event.wait()
                try:
                    reg.counter(
                        "tpudas_serve_cache_misses_total",
                        "tile reads that had to load from disk",
                    ).inc()
                    value = store._load_tile(level, tile_idx)
                except BaseException as exc:
                    flight.error = exc
                    raise
                else:
                    flight.value = value
                    with self._lock:
                        self._cache[key] = value
                        self._cache.move_to_end(key)
                        while len(self._cache) > self._cache_cap:
                            self._cache.popitem(last=False)
                            reg.counter(
                                "tpudas_serve_cache_evictions_total",
                                "tiles evicted from the LRU cache",
                            ).inc()
                        reg.gauge(
                            "tpudas_serve_cache_tiles",
                            "tiles currently held by the LRU cache",
                        ).set(len(self._cache))
                    return value
                finally:
                    flight.event.set()
                    with self._lock:
                        self._inflight.pop(key, None)

        return load

    # -- level selection ----------------------------------------------
    @staticmethod
    def pick_level(store: TileStore, t0_ns: int, t1_ns: int,
                   resolution=None, max_samples=None) -> int:
        """The coarsest level whose step still satisfies the requested
        resolution (seconds/sample) or sample budget; 0 when
        unconstrained."""
        res_sec = None
        if resolution is not None:
            res_sec = float(resolution)
        elif max_samples is not None and int(max_samples) > 0:
            res_sec = max((t1_ns - t0_ns) / 1e9 / int(max_samples), 0.0)
        if res_sec is None or res_sec <= 0:
            return 0
        level = 0
        for k in range(store.n_levels):
            if store.n(k) == 0 and k > 0:
                break
            if store.level_step_ns(k) / 1e9 <= res_sec:
                level = k
        return level

    # -- full-resolution fallback -------------------------------------
    def _file_rows(self, lo_ns: int, hi_ns: int, refresh: bool = True):
        """Full-resolution rows overlapping [lo_ns, hi_ns] read from
        the output files via the index's time-range lookup (no
        directory rescan beyond the incremental update; pass
        ``refresh=False`` when the caller already updated the index
        this request — one stat-scan per query, not per slab).
        Returns a list of contiguous (times_ns int64, data float
        (rows, C)) groups plus the distance coords (None when no
        data)."""
        from tpudas_torch.io.registry import read_file
        from tpudas_torch.io.spool import merge_patches

        lo = np.datetime64(int(lo_ns), "ns")
        hi = np.datetime64(int(hi_ns), "ns")
        with self._index_lock:
            if refresh:
                self._index.update()
            recs = self._index.time_range_records(lo, hi)
        patches = []
        for rec in recs:
            patches.extend(
                read_file(
                    rec["path"],
                    format=rec.get("format", "dasdae"),
                    time=(lo, hi),
                )
            )
        get_registry().counter(
            "tpudas_serve_fallback_reads_total",
            "full-resolution output files read for windows older "
            "than (or without) the pyramid",
        ).inc(float(len(recs)))
        groups = []
        distance = None
        for p in merge_patches(patches):
            data = p.host_data()
            ax = p.axis_of("time")
            if ax != 0:
                data = np.moveaxis(data, ax, 0)
            times = (
                np.asarray(p.coords["time"])
                .astype("datetime64[ns]")
                .astype(np.int64)
            )
            if times.size:
                groups.append((times, np.asarray(data, dtype=np.float64)))
                if distance is None:
                    distance = np.asarray(
                        p.coords.get("distance", ()), dtype=np.float64
                    )
        return groups, distance

    def _file_coverage_ns(self):
        """(earliest time_min, latest time_max) over the folder's
        indexed files as epoch ns, or (None, None) when empty — the
        bound that keeps file-fallback grids sized by DATA, not by
        whatever window a client asked for."""
        with self._index_lock:
            self._index.update()
            recs = self._index.time_range_records(None, None)
        if not recs:
            return None, None
        lo = min(
            np.datetime64(r["time_min"], "ns").astype(np.int64)
            for r in recs
        )
        hi = max(
            np.datetime64(r["time_max"], "ns").astype(np.int64)
            for r in recs
        )
        return int(lo), int(hi)

    # level-0 rows materialized per slab of the file-fallback grid
    # (~8 MB/channel-hundred of float64): bounds peak memory however
    # large the (data-clamped) span is
    _FILE_GRID_SLAB = 1_048_576

    def _files_on_level_grid(self, store, level, i_lo, i_hi, agg):
        """The [i_lo, i_hi) span of the level grid assembled from
        full-resolution files (pre-pyramid ``i < 0``, or beyond-head
        ``i >= n``).  Missing rows are NaN; coarse rows are reduced on
        the fly with the same kernel the pyramid cascade uses.
        Assembled in bounded slabs — the caller clamps the span to
        actual file coverage, this bounds the per-slab allocation."""
        f = int(store.factor) ** int(level)
        step0 = int(store.step_ns)
        group_slab = max(self._FILE_GRID_SLAB // f, 1)
        parts = []
        for g_lo in range(int(i_lo), int(i_hi), group_slab):
            g_hi = min(g_lo + group_slab, int(i_hi))
            lo0, hi0 = g_lo * f, g_hi * f
            lo_ns = store.t0_ns + lo0 * step0
            hi_ns = store.t0_ns + (hi0 - 1) * step0
            # the caller's _file_coverage_ns already refreshed the
            # index this request
            groups, _ = self._file_rows(lo_ns, hi_ns, refresh=False)
            grid = np.full(
                (hi0 - lo0, int(store.n_ch)), np.nan, np.float64
            )
            for t_ns, data in groups:
                idx = np.round(
                    (t_ns - int(store.t0_ns)) / step0
                ).astype(np.int64)
                ok = (
                    (np.abs(t_ns - (store.t0_ns + idx * step0))
                     <= 0.01 * step0)
                    & (idx >= lo0)
                    & (idx < hi0)
                )
                if data.shape[1] == grid.shape[1]:
                    grid[idx[ok] - lo0] = data[ok]
                else:
                    # mismatched channel geometry: the rows stay NaN,
                    # but never silently — the append side raises
                    # loudly for the same condition
                    log_event(
                        "serve_fallback_channel_mismatch",
                        file_channels=int(data.shape[1]),
                        pyramid_channels=int(grid.shape[1]),
                    )
            if level == 0:
                parts.append(grid.astype(np.float32))
            else:
                parts.append(
                    block_reduce(grid, f, agg, self.engine).astype(
                        np.float32
                    )
                )
        if not parts:
            return np.empty((0, int(store.n_ch)), np.float32)
        return np.concatenate(parts, axis=0)

    # -- the query -----------------------------------------------------
    def query(
        self,
        t0,
        t1,
        distance=None,
        resolution=None,
        max_samples=None,
        agg: str = "mean",
    ) -> QueryResult:
        """Answer one [t0, t1] x distance window read.

        ``resolution`` (seconds/sample) or ``max_samples`` picks the
        coarsest satisfying pyramid level; ``distance`` is an optional
        ``(lo, hi)`` channel-coordinate range; ``agg`` is ``"mean"``
        (default), ``"min"`` or ``"max"`` (levels above 0 carry all
        three).  Windows (or prefixes) older than the pyramid fall back
        to the full-resolution output files.
        """
        if agg not in AGGS:
            raise ValueError(f"unknown aggregate {agg!r}; known: {AGGS}")
        t0_ns = int(to_datetime64(t0).astype("datetime64[ns]").astype(np.int64))
        t1_ns = int(to_datetime64(t1).astype("datetime64[ns]").astype(np.int64))
        if t1_ns < t0_ns:
            raise ValueError(f"empty/inverted window: t1 {t1} < t0 {t0}")
        store = self._refresh_store()
        reg = get_registry()
        with span("serve.query", agg=agg):
            if store is None or store.head_ns is None:
                result = self._query_files_only(
                    t0_ns, t1_ns, agg, resolution, max_samples
                )
            else:
                result = self._query_pyramid(
                    store, t0_ns, t1_ns, resolution, max_samples, agg
                )
        result = self._select_distance(result, distance)
        reg.counter(
            "tpudas_serve_queries_total",
            "window queries answered, by data source",
            labelnames=("source",),
        ).inc(source=result.source)
        return result

    def _query_pyramid(self, store, t0_ns, t1_ns, resolution, max_samples,
                       agg) -> QueryResult:
        level = self.pick_level(store, t0_ns, t1_ns, resolution, max_samples)
        stepk = store.level_step_ns(level)
        rel0 = t0_ns - store.t0_ns
        rel1 = t1_ns - store.t0_ns
        i_lo = -(-rel0 // stepk)  # ceil: first sample time >= t0
        i_hi = rel1 // stepk + 1  # past the last sample time <= t1
        n_k = store.n(level)
        if i_lo < 0 or i_hi > n_k:
            # the span beyond the pyramid comes from files: clamp it
            # to actual file coverage FIRST, so the grid is sized by
            # data on disk, never by the window a client asked for
            # (t0=1970 must not allocate fifty years of NaN)
            cov_lo, cov_hi = self._file_coverage_ns()
            if i_lo < 0:
                i_lo = (
                    max(i_lo, (cov_lo - store.t0_ns) // stepk)
                    if cov_lo is not None
                    else 0
                )
            if i_hi > n_k:
                i_hi = (
                    max(
                        min(i_hi, (cov_hi - store.t0_ns) // stepk + 1),
                        n_k,
                    )
                    if cov_hi is not None
                    else n_k
                )
        if i_hi <= i_lo:
            return self._empty(store, level, stepk, agg)
        parts = []
        source = []
        # pre-pyramid prefix (i < 0) from full-resolution files
        i_mid = min(max(i_lo, 0), i_hi)
        if i_lo < i_mid:
            parts.append(
                self._files_on_level_grid(store, level, i_lo, i_mid, agg)
            )
            source.append("files")
        # the pyramid-covered span
        i_tiles_hi = min(i_hi, max(n_k, i_mid))
        if i_mid < i_tiles_hi:
            if self.tile_prefetch is not None:
                self.tile_prefetch(store, level, i_mid, i_tiles_hi)
            parts.append(
                store.read(
                    level, i_mid, i_tiles_hi, agg=agg,
                    loader=self._cached_loader(store),
                )
            )
            source.append("tiles")
        i_hi_eff = i_tiles_hi
        # beyond-the-head suffix: output files the pyramid has not
        # absorbed yet (a lagging or failing append must DEGRADE the
        # read path to the files, not hide new data); trailing rows
        # with no file backing are trimmed, so a window past all data
        # still comes back empty rather than NaN-padded
        i_post = max(i_lo, n_k)
        if i_hi > i_post:
            suffix = self._files_on_level_grid(
                store, level, i_post, i_hi, agg
            )
            backed = np.isfinite(suffix).any(axis=1)
            n_keep = (
                int(np.max(np.nonzero(backed)[0])) + 1
                if backed.any()
                else 0
            )
            if n_keep:
                parts.append(suffix[:n_keep])
                source.append("files")
                i_hi_eff = i_post + n_keep
        if not parts:
            return self._empty(store, level, stepk, agg)
        data = np.concatenate(parts, axis=0)
        times = (
            np.asarray(store.t0_ns + np.arange(i_lo, i_hi_eff) * stepk)
            .astype("datetime64[ns]")
        )
        # immutable = every row came from a COMPLETED full tile (no
        # file fallback, no growing head tile): those bytes are
        # append-proof, so the HTTP layer can mark the response
        # CDN-cacheable forever
        n_full_rows = (n_k // store.tile_len) * store.tile_len
        return QueryResult(
            times=times,
            distance=np.asarray(store.distance, dtype=np.float64),
            data=data,
            level=int(level),
            step_ns=int(stepk),
            agg=agg,
            source=(
                "mixed" if len(set(source)) > 1 else source[0]
            ),
            immutable=bool(
                set(source) == {"tiles"} and i_hi_eff <= n_full_rows
            ),
        )

    def _query_files_only(self, t0_ns, t1_ns, agg, resolution=None,
                          max_samples=None) -> QueryResult:
        """No pyramid at all (legacy folder): serve the files' rows,
        still honoring the caller's resolution/sample budget by
        reducing on the fly — a ``/waterfall?max_px=1024`` over a
        month of legacy output must not ship the month at full
        resolution.  The window is clamped to file coverage before
        anything is read."""
        cov_lo, cov_hi = self._file_coverage_ns()
        if cov_lo is not None:
            t0_ns = max(int(t0_ns), cov_lo)
            t1_ns = min(int(t1_ns), cov_hi)
        if cov_lo is None or t1_ns < t0_ns:
            return QueryResult(
                times=np.empty(0, dtype="datetime64[ns]"),
                distance=np.empty(0),
                data=np.empty((0, 0), np.float32),
                level=0, step_ns=0, agg=agg, source="empty",
            )
        groups, distance = self._file_rows(t0_ns, t1_ns, refresh=False)
        groups = [
            (t[(t >= t0_ns) & (t <= t1_ns)],
             d[(t >= t0_ns) & (t <= t1_ns)])
            for t, d in groups
        ]
        groups = [(t, d) for t, d in groups if t.size]
        if not groups:
            return QueryResult(
                times=np.empty(0, dtype="datetime64[ns]"),
                distance=(
                    np.empty(0)
                    if distance is None
                    else np.asarray(distance, np.float64)
                ),
                data=np.empty((0, 0 if distance is None else len(distance)),
                              np.float32),
                level=0, step_ns=0, agg=agg, source="empty",
            )
        times = np.concatenate([t for t, _ in groups]).astype(
            "datetime64[ns]"
        )
        data = np.concatenate([d for _, d in groups], axis=0).astype(
            np.float32
        )
        step_ns = (
            int(np.median(np.diff(times.astype(np.int64))))
            if times.size > 1
            else 0
        )
        # on-the-fly budget reduction (the no-pyramid analogue of the
        # pyramid's level choice): group-mean/min/max on the native
        # grid, gaps NaN-filled so reduction stays honest
        res_sec = None
        if resolution is not None:
            res_sec = float(resolution)
        elif max_samples is not None and int(max_samples) > 0:
            res_sec = (t1_ns - t0_ns) / 1e9 / int(max_samples)
        if res_sec is not None and step_ns > 0:
            m = int(res_sec * 1e9 // step_ns)
            if m >= 2 and times.size:
                t_ns = times.astype(np.int64)
                first = int(t_ns[0])
                idx = np.round((t_ns - first) / step_ns).astype(np.int64)
                n_grid = int(idx[-1]) + 1
                g = n_grid // m
                if g >= 1:
                    grid = np.full(
                        (g * m, data.shape[1]), np.nan, np.float64
                    )
                    ok = idx < g * m
                    grid[idx[ok]] = data[ok]
                    data = block_reduce(grid, m, agg, self.engine).astype(
                        np.float32
                    )
                    times = (
                        first
                        + np.arange(g, dtype=np.int64) * (m * step_ns)
                    ).astype("datetime64[ns]")
                    step_ns = m * step_ns
        return QueryResult(
            times=times,
            distance=np.asarray(distance, np.float64),
            data=data,
            level=0, step_ns=step_ns, agg=agg, source="files",
        )

    def _empty(self, store, level, stepk, agg) -> QueryResult:
        return QueryResult(
            times=np.empty(0, dtype="datetime64[ns]"),
            distance=np.asarray(store.distance, dtype=np.float64),
            data=np.empty((0, int(store.n_ch)), np.float32),
            level=int(level), step_ns=int(stepk), agg=agg, source="empty",
        )

    @staticmethod
    def _select_distance(result: QueryResult, distance) -> QueryResult:
        if distance is None or result.distance.size == 0:
            return result
        lo, hi = distance
        d = result.distance
        mask = np.ones(d.shape[0], dtype=bool)
        if lo is not None:
            mask &= d >= float(lo)
        if hi is not None:
            mask &= d <= float(hi)
        result.distance = d[mask]
        result.data = result.data[:, mask]
        return result

    # -- maintenance ----------------------------------------------------
    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
        get_registry().gauge(
            "tpudas_serve_cache_tiles",
            "tiles currently held by the LRU cache",
        ).set(0)
        log_event("serve_cache_cleared", folder=os.path.basename(self.folder))
