"""Incremental multi-resolution tile pyramid over processed output.

The port's counterpart of :mod:`tpudas.serve.tiles`, with the same
on-disk formats byte for byte: a ``.tiles/`` folder written by either
package is read, appended to, audited and rebuilt by the other, and the
same output files give the same tree.  All of it is host code (numpy,
zlib, atomic file writes) except :func:`block_reduce` with
``engine="torch"``, which runs the port's windowed reduction on the
card.

The streaming drivers append decimated low-frequency output to a
directory round by round; this module maintains, beside that output
(and the stream carry), a pyramid of progressively coarser reductions
of the same stream so the read side can answer a window query at ANY
zoom by touching O(pixels) bytes instead of O(window) full-resolution
samples:

- level 0 is the processed output grid itself (one row per output
  sample, all channels);
- level ``k+1`` reduces each complete group of ``factor`` level-``k``
  samples to one sample, carrying three aggregates per group — mean
  (the display value), min and max (the envelope, so extremes survive
  decimation) — via the shared rolling kernels
  (:func:`tpudas_torch.ops.rolling.rolling_reduce`).

Layout (all under ``<folder>/.tiles/``):

- ``manifest.json`` — the authoritative state: grid anchor/step,
  factor, tile length, channel coordinates, and per-level appended
  sample counts.  Written atomically (tmp + rename) AFTER the tiles it
  describes, double-buffered as ``manifest.json.prev`` — the same
  crash-only discipline as the stream carry (tpudas_torch.proc.stream) and
  ``health.json`` (tpudas_torch.obs.health).
- ``L<level>/<tile_index>.npy`` — COMPLETE fixed-length tiles
  (``tile_len`` rows x all channels) as raw ``.npy`` arrays (no zip
  container: a tile read/write is one header + one contiguous block,
  ~10x cheaper than ``.npz`` at this size, and the per-round append
  rides the stream's hot path).  Level 0 tiles are ``(rows, n_ch)``
  data; coarser tiles stack the three aggregates as ``(3, rows,
  n_ch)`` in :data:`AGGS` order.  A tile file is written exactly once,
  when it completes — full tiles are immutable.
- ``L<level>/<tile_index>.tpt`` — the same complete tiles under a
  compressed store (``codec=`` / ``TPUDAS_CODEC=``): one
  self-describing :mod:`tpudas_torch.codec` blob per tile, crc embedded (no
  ``.crc`` sidecar).  Only COMPLETE tiles are encoded — ``tails.npy``
  and the manifest stay raw, they are the mutable per-round hot path.
  Reads accept both suffixes (codec-preferred), so a legacy raw store
  keeps serving untouched and a half-converted (mixed) store is
  consistent file by file.  Under a LOSSY codec incoming rows are
  first *conditioned* onto the codec's representable grid
  (:attr:`tpudas_torch.codec.Codec.condition`), so every value on disk —
  tails included — obeys the codec's error bound and the incremental
  build stays byte-identical to an offline rebuild.
- ``tails.npy`` — every level's trailing PARTIAL tile in one
  self-describing file (header: ``[n_entries, (level, planes, rows,
  base_hi, base_lo) ...]``, then the row data), rewritten atomically
  once per append.
  This is the steady-state trick: appending to N pyramid levels costs
  ONE tail write plus the occasional completed tile, not N partial-
  tile rewrites — filesystem ops, not bytes, dominate a small append.

Write ordering per append: completed tiles, then ``tails.npy``, then
the manifest — so the manifest never references rows that are not
durably on disk.  Rows beyond the manifest's count (a crashed
append's surplus) are sliced off at read time; a partial-tile read
prefers the tile's FILE when one exists (a crashed append that
completed the tile before the manifest advanced — its prefix is
byte-identical because the reduction is deterministic) and falls back
to ``tails.npy`` otherwise.  During one append the cascade reads its
just-written source rows from a write-through cache, so a steady
append touches the disk only to write.

Data gaps in the output stream become NaN rows on the level-0 grid and
propagate to NaN coarse samples, so a served window is honest about
missing spans at every zoom.

Restart resumes the pyramid from the manifest; :func:`sync_pyramid`
(the realtime driver's per-round hook) appends exactly the output rows
newer than the pyramid head, making the incremental build byte-
identical to a one-shot rebuild from the same output files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from tpudas_torch.codec import (
    CodecError,
    TILE_BLOB_SUFFIX,
    decode_tile,
    encode_tile,
    get_codec,
    parse_codec_spec,
)
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.integrity.checksum import (
    count_fallback,
    count_unstamped,
    read_json_verified,
    rotate_prev,
    verify_file_checksum,
    write_json_checksummed,
    write_npy_checksummed,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.resilience.faults import fault_point
from tpudas_torch.utils.atomicio import atomic_write_bytes
from tpudas_torch.utils.logging import log_event

__all__ = [
    "TILE_DIRNAME",
    "MANIFEST_FILENAME",
    "MANIFEST_VERSION",
    "AGGS",
    "CorruptStoreError",
    "TileStore",
    "append_patches",
    "block_reduce",
    "rebuild_pyramid",
    "sync_pyramid",
]


class CorruptStoreError(RuntimeError):
    """The pyramid's on-disk state is internally inconsistent (e.g.
    the manifest implies partial rows neither the tails file nor a
    tile file can supply).  A SERVER-side condition — the HTTP layer
    maps it to 500, never to a client 400.  The pyramid is derived
    data: delete ``.tiles/`` (or re-run :func:`sync_pyramid`) to
    rebuild it byte-identically from the outputs."""

TILE_DIRNAME = ".tiles"
MANIFEST_FILENAME = "manifest.json"
TAILS_FILENAME = "tails.npy"
MANIFEST_VERSION = 1
AGGS = ("mean", "min", "max")

_DEFAULT_FACTOR = 4
_DEFAULT_TILE_LEN = 256
_STORE_DTYPE = np.float32


def _resolve_codec(codec) -> tuple:
    """``(codec_id, params)`` from a spec string, an already-split
    ``(id, params)`` pair, or None — every codec entry point funnels
    through here so an unknown id fails loudly at config time."""
    if isinstance(codec, tuple):
        cid, params = codec
        if cid is not None:
            get_codec(cid)  # unknown id -> CodecError now, not at read
        return cid, dict(params or {})
    return parse_codec_spec(codec)


def rebuild_pyramid(
    folder, engine=None, factor=None, tile_len=None, codec=None
) -> int:
    """The degradation ladder's last pyramid rung: delete ``.tiles/``
    and rebuild it from the output files via :func:`sync_pyramid` —
    byte-identical to the incremental build, because the reduction is
    deterministic.  The original ``factor``/``tile_len``/codec are
    recovered from whatever manifest rung still parses (the geometry
    must survive the rebuild, or the "byte-identical" claim breaks);
    env defaults apply only when nothing is recoverable.

    ``codec`` is also the offline **re-encode** entry point: pass a codec spec (``"bitshuffle-deflate"``,
    ``"quantize-deflate:max_error=1e-3"``, or ``"raw"`` to strip
    compression) to rebuild the whole pyramid in that format; the
    default (None) preserves the store's recorded codec.  The
    manifest ``generation`` is bumped either way, so query-layer
    decoded-tile caches can never serve a pre-rebuild array.

    Returns the number of level-0 rows in the rebuilt pyramid."""
    import json as _json
    import shutil

    tiles_dir = os.path.join(str(folder), TILE_DIRNAME)
    # recovery always runs (not just for missing args): the
    # generation counter must survive the rebuild, or a held query
    # engine could key rebuilt tiles back into pre-rebuild cache slots
    generation = 0
    recovered_codec: tuple | None = None
    store = TileStore.open(folder)
    if store is not None:
        factor = factor or store.factor
        tile_len = tile_len or store.tile_len
        generation = store.generation
        recovered_codec = (store.codec, store.codec_params)
    else:
        # last resort: a raw (checksum-ignored) parse of either
        # manifest rung just for the geometry + codec fields
        base = os.path.join(tiles_dir, MANIFEST_FILENAME)
        for path in (base, base + ".prev"):
            try:
                with open(path) as fh:
                    raw = _json.load(fh)
                factor = factor or int(raw["factor"])
                tile_len = tile_len or int(raw["tile_len"])
                generation = int(raw.get("generation", 0))
                recovered_codec = (
                    raw.get("codec") or None,
                    dict(raw.get("codec_params") or {}),
                )
                break
            except (OSError, ValueError, KeyError, TypeError):
                continue
    if codec is None:
        codec = recovered_codec  # preserve the recorded format
    if os.path.isdir(tiles_dir):
        shutil.rmtree(tiles_dir, ignore_errors=True)
    get_registry().counter(
        "tpudas_serve_pyramid_rebuilds_total",
        "tile pyramids deleted and rebuilt from the output files "
        "(corrupt-store recovery)",
    ).inc()
    log_event("pyramid_rebuilt", folder=str(folder))
    # the rebuilt store is a NEW tile generation: even a content-
    # identical lossless rebuild bumps it (cheap — one cold refill of
    # the decoded-tile LRU), because a lossy or cross-codec rebuild
    # MUST invalidate every cached decoded array.  The bumped counter
    # goes into the FRESH manifest from its very first save — a
    # post-sync fixup would leave a window (or, after a crash mid-
    # rebuild, a permanent state) where re-encoded tiles still read
    # as the old generation and key into stale cache slots
    return sync_pyramid(
        folder, factor=factor, tile_len=tile_len, engine=engine,
        codec=codec, generation=int(generation) + 1,
    )


def block_reduce(x, factor: int, op: str, engine=None,
                 device=None) -> np.ndarray:
    """Reduce complete groups of ``factor`` rows of ``x`` (rows x
    channels) to one row each — ``x`` must have ``g * factor`` rows.

    Equivalent to :func:`tpudas_torch.ops.rolling.rolling_reduce` with a
    trailing window of ``factor`` sampled at the complete-window
    positions.  The host default (``engine`` None, ``"numpy"`` or
    ``"host"``) reduces the ``(g, factor, C)`` reshape directly in
    float64 — same groups, deterministic, the JAX package's host
    default, so the stored float32 tiles are byte-identical to its
    tiles; it sits on the realtime driver's per-round hot path so it
    must not pay for the stride-1 windows it would throw away.
    ``engine="torch"`` runs ``rolling_reduce`` on ``device`` (default
    the CUDA card, which raises when there is none) and returns its
    float32 rows; the JAX package's spelling ``"jax"`` is not accepted
    (no entry point of the port passes it), and any other engine raises
    ``ValueError``.  NaN rows propagate to their group's output under
    every op (gap honesty).
    """
    if engine not in (None, "numpy", "host", "torch"):
        raise ValueError(
            f"block_reduce engine must be None, 'numpy', 'host' or "
            f"'torch', got {engine!r}"
        )
    if engine != "torch":
        x = np.asarray(x)  # a torch tensor goes to the device as it is
    if x.shape[0] % factor:
        raise ValueError(
            f"block_reduce needs complete groups: {x.shape[0]} rows "
            f"is not a multiple of factor {factor}"
        )
    if engine == "torch":
        from tpudas_torch.ops.rolling import rolling_reduce

        full = rolling_reduce(x, factor, 1, op, axis=0, device=device)
        return full[factor - 1 :: factor].cpu().numpy()
    if x.shape[0] == 0:
        return x.astype(np.float64)
    g = x.shape[0] // factor
    grouped = x.astype(np.float64).reshape((g, factor) + x.shape[1:])
    if op == "mean":
        return grouped.mean(axis=1)
    if op == "sum":
        return grouped.sum(axis=1)
    if op == "max":
        return grouped.max(axis=1)
    if op == "min":
        return grouped.min(axis=1)
    raise ValueError(f"unknown block_reduce op {op!r}")


@dataclass
class TileStore:
    """The pyramid writer/reader for one output folder.

    Create with :meth:`create` (fresh) or :meth:`open` (resume from the
    manifest); the realtime driver goes through :func:`sync_pyramid`
    which does both.  All mutation happens in :meth:`append`; the
    manifest on disk is only advanced after every tile it references
    is durably in place.
    """

    folder: str
    factor: int = _DEFAULT_FACTOR
    tile_len: int = _DEFAULT_TILE_LEN
    engine: str | None = None  # block_reduce engine (None = host, default)
    # tile codec id (tpudas_torch.codec registry; None = legacy raw .npy)
    # + its persisted parameters — both recorded in the manifest, so
    # the store that wrote a tile always knows how to read it back
    codec: str | None = None
    codec_params: dict = field(default_factory=dict)
    # bumped by rebuild_pyramid: lets the query engine's decoded-tile
    # LRU key out stale entries after a re-encode (same tile index,
    # different bytes)
    generation: int = 0
    t0_ns: int | None = None  # grid anchor (first level-0 sample time)
    step_ns: int | None = None  # level-0 grid step
    n_ch: int | None = None
    distance: np.ndarray | None = None
    levels: list = field(default_factory=list)  # appended samples per level
    # (mtime_ns, size) of the manifest last parsed — refresh() is a
    # stat when nothing changed, not a re-parse (the warm-query path)
    _manifest_stat: tuple | None = None
    # append-scoped write-through cache {(level, tile_idx): stored
    # array}: the cascade reads its just-written source rows from
    # memory; cleared at the start of every append
    _wcache: dict = field(default_factory=dict)
    # per-level trailing partial-tile rows, mirrored to the shared
    # tails.npy once per append.  ONE attribute holding ONE immutable
    # snapshot ({level: array}, {level: base_tile}) — None = not
    # loaded — so concurrent server threads racing a refresh always
    # read a fully-populated pair (attribute assignment is atomic;
    # a loaded-flag + two dicts is not).  base_tile records WHICH
    # tile each tail belongs to, so a crash-skewed (older-manifest,
    # newer-tails) pairing can never be misread as another tile's
    # rows.
    _tails_state: tuple | None = None

    # -- paths ---------------------------------------------------------
    @property
    def tiles_dir(self) -> str:
        return os.path.join(self.folder, TILE_DIRNAME)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.tiles_dir, MANIFEST_FILENAME)

    @property
    def tails_path(self) -> str:
        return os.path.join(self.tiles_dir, TAILS_FILENAME)

    def tile_path(self, level: int, tile_idx: int) -> str:
        return os.path.join(
            self.tiles_dir, f"L{int(level)}", f"{int(tile_idx):08d}.npy"
        )

    def tile_blob_path(self, level: int, tile_idx: int) -> str:
        return os.path.join(
            self.tiles_dir,
            f"L{int(level)}",
            f"{int(tile_idx):08d}{TILE_BLOB_SUFFIX}",
        )

    def resolve_tile_path(self, level: int, tile_idx: int) -> str | None:
        """The on-disk file for one tile, whichever format it is in —
        the store's codec format preferred, the other accepted (a
        mixed raw+compressed store reads consistently file by file).
        None when neither exists."""
        blob = self.tile_blob_path(level, tile_idx)
        raw = self.tile_path(level, tile_idx)
        for path in (blob, raw) if self.codec else (raw, blob):
            if os.path.isfile(path):
                return path
        return None

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(
        cls,
        folder,
        factor: int = _DEFAULT_FACTOR,
        tile_len: int = _DEFAULT_TILE_LEN,
        engine=None,
        codec=None,
    ) -> "TileStore":
        """A fresh, empty pyramid for ``folder`` (no manifest written
        until the first :meth:`append`).  ``codec`` is a
        :func:`tpudas_torch.codec.parse_codec_spec` spec string (or
        ``(id, params)`` pair) selecting the compressed tile format;
        None/"raw" keeps legacy raw ``.npy`` tiles."""
        if int(factor) < 2:
            raise ValueError(f"pyramid factor must be >= 2, got {factor}")
        if int(tile_len) < int(factor):
            raise ValueError(
                f"tile_len {tile_len} must be >= factor {factor}"
            )
        codec_id, codec_params = _resolve_codec(codec)
        return cls(
            folder=str(folder),
            factor=int(factor),
            tile_len=int(tile_len),
            engine=engine,
            codec=codec_id,
            codec_params=codec_params,
        )

    @classmethod
    def open(cls, folder, engine=None) -> "TileStore | None":
        """Resume a pyramid from its manifest; None when ``folder`` has
        no (readable) manifest — the no-pyramid signal the query
        engine's full-resolution fallback keys off."""
        store = cls(folder=str(folder), engine=engine)
        if store._load_manifest():
            return store
        return None

    @classmethod
    def open_or_create(cls, folder, **kwargs) -> "TileStore":
        store = cls.open(folder, engine=kwargs.get("engine"))
        if store is not None:
            return store
        return cls.create(folder, **kwargs)

    def _load_manifest(self) -> bool:
        """Load the manifest (``.prev`` double-buffer fallback for a
        torn primary).  Returns True when a valid manifest was read;
        on failure the in-memory state is CLEARED — a store whose
        ``.tiles/`` was deleted out from under it (the documented
        corruption remedy) must read as empty, not keep serving a
        phantom pyramid or re-write a manifest over missing tiles."""
        base = self.manifest_path
        for path in (base, base + ".prev"):
            try:
                try:
                    st = os.stat(path)
                    stat_key = (st.st_mtime_ns, st.st_size)
                except OSError:
                    stat_key = None
                raw, status = read_json_verified(path, "manifest")
                if status == "mismatch":
                    raise ValueError("manifest checksum mismatch")
                if status == "unstamped":
                    count_unstamped("manifest")
                if raw.get("version") != MANIFEST_VERSION:
                    raise ValueError(
                        f"unknown pyramid manifest version "
                        f"{raw.get('version')!r}"
                    )
                self.factor = int(raw["factor"])
                self.tile_len = int(raw["tile_len"])
                self.t0_ns = int(raw["t0_ns"])
                self.step_ns = int(raw["step_ns"])
                self.n_ch = int(raw["n_ch"])
                self.distance = np.asarray(raw["distance"], dtype=np.float64)
                self.levels = [int(n) for n in raw["levels"]]
                # codec keys are absent on pre-codec manifests:
                # their absence IS the raw-store signal
                codec = raw.get("codec") or None
                if codec is not None:
                    get_codec(codec)  # unknown id = unreadable store
                self.codec = codec
                self.codec_params = dict(raw.get("codec_params") or {})
                self.generation = int(raw.get("generation", 0))
                # stat-gate future refreshes only off the PRIMARY (a
                # .prev fallback must re-check the primary next time)
                self._manifest_stat = stat_key if path == base else None
                # tails follow the manifest: reload lazily on demand
                self._tails_state = None
                return True
            except FileNotFoundError:
                continue
            except (OSError, ValueError, KeyError, TypeError,
                    CodecError) as exc:
                get_registry().counter(
                    "tpudas_serve_manifest_unreadable_total",
                    "pyramid manifests that failed to parse (fell back "
                    "to .prev or empty)",
                ).inc()
                count_fallback(
                    "manifest",
                    f"{type(exc).__name__}: {str(exc)[:120]}",
                    path,
                )
                log_event(
                    "pyramid_manifest_unreadable",
                    path=path,
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
                continue
        self.t0_ns = None
        self.step_ns = None
        self.n_ch = None
        self.distance = None
        self.levels = []
        self.codec = None
        self.codec_params = {}
        self.generation = 0
        self._manifest_stat = None
        self._tails_state = None
        return False

    def refresh(self) -> "TileStore":
        """Re-read the manifest (the server's view of a pyramid a
        writer is concurrently appending to).  Costs one ``stat`` when
        nothing changed — the warm-query hot path must not re-parse
        JSON per request."""
        if self._manifest_stat is not None:
            try:
                st = os.stat(self.manifest_path)
                if (st.st_mtime_ns, st.st_size) == self._manifest_stat:
                    return self
            except OSError:
                pass  # vanished mid-write: fall through to the loader
        self._load_manifest()
        return self

    def _save_manifest(self) -> None:
        payload = {
            "version": MANIFEST_VERSION,
            "factor": self.factor,
            "tile_len": self.tile_len,
            "t0_ns": int(self.t0_ns),
            "step_ns": int(self.step_ns),
            "n_ch": int(self.n_ch),
            "distance": [float(d) for d in self.distance],
            "levels": [int(n) for n in self.levels],
        }
        if self.codec is not None:
            # keys only present on compressed stores, so a raw store's
            # manifest is byte-identical to what pre-codec code wrote
            payload["codec"] = self.codec
            payload["codec_params"] = dict(self.codec_params)
        if self.generation:
            payload["generation"] = int(self.generation)
        path = self.manifest_path
        # rename-not-copy double buffer, same as health.json: the
        # outgoing good manifest survives as .prev for torn-read
        # readers; the write carries an embedded crc32 stamp
        rotate_prev(path)
        write_json_checksummed(path, payload)
        # our in-memory state IS this manifest: stat-gate so a writer
        # held across rounds never re-parses its own save
        try:
            st = os.stat(path)
            self._manifest_stat = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._manifest_stat = None

    # -- geometry ------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_step_ns(self, level: int) -> int:
        return int(self.step_ns) * int(self.factor) ** int(level)

    def n(self, level: int) -> int:
        return self.levels[level] if level < len(self.levels) else 0

    def time_of(self, level: int, i: int) -> int:
        """ns timestamp of level-``level`` sample ``i`` — the time of
        the FIRST level-0 sample in its group (leading-edge
        alignment)."""
        return int(self.t0_ns) + int(i) * self.level_step_ns(level)

    @property
    def head_ns(self) -> int | None:
        """Exclusive end of level-0 coverage (``None`` while empty)."""
        if self.t0_ns is None or not self.levels:
            return None
        return self.t0_ns + self.levels[0] * int(self.step_ns)

    # -- reading -------------------------------------------------------
    @staticmethod
    def _tile_dict(level: int, arr: np.ndarray, valid: int) -> dict:
        """{agg: (rows, n_ch)} view of one stored tile array.  Level 0
        serves its single data plane as every aggregate."""
        if level == 0:
            data = arr[:valid]
            return {agg: data for agg in AGGS}
        return {agg: arr[i, :valid] for i, agg in enumerate(AGGS)}

    # -- tails (the shared partial-tile file) --------------------------
    def _ensure_tails(self) -> tuple:
        """The current ``({level: rows}, {level: base_tile})``
        snapshot, loading it from disk at most once per manifest
        generation.  Callers hold the returned PAIR — never re-read
        the attribute mid-operation — so a concurrent refresh can
        only swap in a complete newer snapshot, never a half-built
        one."""
        state = self._tails_state
        if state is None:
            state = self._load_tails()
        return state

    def _load_tails(self) -> tuple:
        """Parse ``tails.npy`` (self-describing: ``[n_entries, (level,
        planes, rows, base_hi, base_lo)...]`` header, float32 row
        data) into one atomic (tails, bases) snapshot."""
        tails: dict = {}
        bases: dict = {}
        path = self.tails_path
        if os.path.isfile(path):
            fault_point("serve.tile_read", path=path)
            if verify_file_checksum(path, artifact="tails") == "mismatch":
                count_fallback("tails", "checksum mismatch", path)
                raise CorruptStoreError(
                    f"pyramid tails file {path!r} failed its crc32 "
                    f"check — delete {TILE_DIRNAME}/ (or run "
                    "tools/fsck.py) to rebuild"
                )
            try:
                flat = np.load(path)
                k = int(round(float(flat[0])))
                off = 1 + 5 * k
                n_ch = int(self.n_ch)
                for j in range(k):
                    level = int(round(float(flat[1 + 5 * j])))
                    planes = int(round(float(flat[2 + 5 * j])))
                    rows = int(round(float(flat[3 + 5 * j])))
                    # base tile index split into two sub-2^20 fields:
                    # each is exact in float32, together good to 2^40
                    # tiles — a single float32 silently rounds past
                    # 2^24 and would mis-tag the tail after ~decades
                    base = (
                        int(round(float(flat[4 + 5 * j]))) * (1 << 20)
                        + int(round(float(flat[5 + 5 * j])))
                    )
                    cnt = planes * rows * n_ch
                    arr = flat[off : off + cnt].reshape(
                        planes, rows, n_ch
                    )
                    off += cnt
                    tails[level] = arr[0] if level == 0 else arr
                    bases[level] = base
            except (ValueError, IndexError) as exc:
                # a torn/garbled tails file is SERVER-side corruption,
                # not a caller mistake
                count_fallback(
                    "tails", f"{type(exc).__name__}: {str(exc)[:120]}",
                    path,
                )
                raise CorruptStoreError(
                    f"unreadable pyramid tails file {path!r}: "
                    f"{type(exc).__name__}: {exc} — delete "
                    f"{TILE_DIRNAME}/ to rebuild"
                ) from exc
            get_registry().counter(
                "tpudas_serve_tile_loads_total",
                "pyramid tile files loaded from disk",
            ).inc()
        state = (tails, bases)
        self._tails_state = state  # single atomic publication
        return state

    def _save_tails(self) -> None:
        """One atomic write carrying EVERY level's partial tile — the
        append's fixed cost, independent of how many levels moved."""
        tails, bases = self._ensure_tails()
        entries, chunks = [], []
        for level in sorted(tails):
            arr = tails[level]
            if level == 0:
                planes, rows = 1, int(arr.shape[0])
            else:
                planes, rows = int(arr.shape[0]), int(arr.shape[1])
            if rows == 0:
                continue
            base = int(bases.get(level, 0))
            entries.append(
                (level, planes, rows, base >> 20, base & ((1 << 20) - 1))
            )
            chunks.append(np.asarray(arr, _STORE_DTYPE).reshape(-1))
        header = np.asarray(
            [len(entries)] + [v for e in entries for v in e],
            dtype=_STORE_DTYPE,
        )
        payload = (
            np.concatenate([header] + chunks) if chunks else header
        )
        os.makedirs(self.tiles_dir, exist_ok=True)
        write_npy_checksummed(self.tails_path, payload)

    def _tail_for(self, level: int, tile_idx: int, rows: int):
        """The tails entry for ``tile_idx`` of ``level`` when it
        exists, belongs to THAT tile, and carries at least ``rows``
        rows — else None.  The base-tile tag is what makes an
        older-manifest/newer-tails crash pairing safe: rows of a
        different tile can never be served as this one's."""
        tails, bases = self._ensure_tails()
        arr = tails.get(level)
        if arr is None or bases.get(level) != int(tile_idx):
            return None
        row_ax = 0 if level == 0 else 1
        if arr.shape[row_ax] < rows:
            return None
        return arr

    def _partial_rows(self, level: int, tile_idx: int, off: int):
        """The first ``off`` rows of the partial tile, in stored
        layout: from the in-memory/loaded tails when they cover it
        (the steady path — no stat, no read), else from the tile's
        FILE (a crashed append completed the tile before the manifest
        advanced — determinism makes its prefix our rows)."""
        row_ax = 0 if level == 0 else 1
        keep = (slice(None),) * row_ax + (slice(0, off),)
        arr = self._tail_for(level, tile_idx, off)
        if arr is not None:
            return arr[keep]
        path = self.resolve_tile_path(level, tile_idx)
        if path is not None:
            arr = self._read_tile_file(path)
            if arr.shape[row_ax] >= off:
                return arr[keep]
        raise CorruptStoreError(
            f"pyramid level {level} tile {tile_idx} holds fewer "
            f"partial rows than the manifest implies ({off}) — store "
            f"corrupt; delete {TILE_DIRNAME}/ to rebuild"
        )

    def _load_tile(self, level: int, tile_idx: int) -> dict:
        """One tile's aggregate arrays ``{agg: (rows, n_ch)}``, sliced
        to the manifest's sample count (a crashed append's surplus
        rows are invisible).  The head's partial tile comes from the
        tails file unless a crashed-future complete tile file covers
        it."""
        path = self.tile_path(level, tile_idx)
        n_level = self.n(level)
        valid = min(self.tile_len, n_level - tile_idx * self.tile_len)
        if valid <= 0:
            raise IndexError(
                f"tile L{level}/{tile_idx} is beyond the manifest head "
                f"({n_level} samples)"
            )
        if valid < self.tile_len:
            tail = self._tail_for(level, tile_idx, valid)
            if tail is not None:
                return self._tile_dict(level, tail, valid)
            # fall through: a crashed-future complete tile file covers
            # the partial index (its prefix is byte-identical)
        arr = self._read_tile_file(
            self.resolve_tile_path(level, tile_idx) or path
        )
        return self._tile_dict(level, arr, valid)

    def _read_tile_file(self, path: str) -> np.ndarray:
        """One tile file's array, whichever format it is in: a
        ``.tpt`` blob decodes through :mod:`tpudas_torch.codec` (embedded
        crc verified), a raw ``.npy`` goes through the sidecar gate.
        A missing file surfaces as ``FileNotFoundError`` (absence is
        the caller's decision, same as the raw path always was)."""
        fault_point("serve.tile_read", path=path)
        if path.endswith(TILE_BLOB_SUFFIX):
            with open(path, "rb") as fh:
                blob = fh.read()
            try:
                arr = decode_tile(blob)
            except CodecError as exc:
                count_fallback(
                    "tile", f"{type(exc).__name__}: {str(exc)[:120]}",
                    path,
                )
                raise CorruptStoreError(
                    f"compressed pyramid tile {path!r} failed to "
                    f"decode ({exc}) — delete {TILE_DIRNAME}/ (or run "
                    "tools/fsck.py) to rebuild"
                ) from exc
        else:
            self._verify_tile(path)
            arr = np.load(path)
        get_registry().counter(
            "tpudas_serve_tile_loads_total",
            "pyramid tile files loaded from disk",
        ).inc()
        return arr

    @staticmethod
    def _verify_tile(path: str) -> None:
        """Checksum gate before trusting one tile file's bytes (an
        unstamped legacy tile is accepted — the audit re-stamps it)."""
        try:
            status = verify_file_checksum(path, artifact="tile")
        except FileNotFoundError:
            return  # absence surfaces as np.load's own error
        if status == "mismatch":
            count_fallback("tile", "checksum mismatch", path)
            raise CorruptStoreError(
                f"pyramid tile {path!r} failed its crc32 check — "
                f"delete {TILE_DIRNAME}/ (or run tools/fsck.py) to "
                "rebuild"
            )
        if status == "unstamped":
            count_unstamped("tile")

    def read(self, level, lo, hi, agg="mean", loader=None) -> np.ndarray:
        """Level-``level`` samples ``[lo, hi)`` of one aggregate as a
        ``(hi - lo, n_ch)`` array.  ``loader(level, tile_idx) -> {agg:
        array}`` overrides the disk tile read — the query engine
        injects its caching, request-coalescing loader here."""
        if agg not in AGGS:
            raise ValueError(f"unknown aggregate {agg!r}; known: {AGGS}")
        lo, hi = int(lo), int(hi)
        n_level = self.n(level)
        if lo < 0 or hi > n_level or lo > hi:
            raise IndexError(
                f"level {level} read [{lo}, {hi}) out of range "
                f"(have {n_level} samples)"
            )
        if hi == lo:
            return np.empty((0, int(self.n_ch)), dtype=_STORE_DTYPE)
        load = loader if loader is not None else self._load_tile
        tl = self.tile_len
        parts = []
        for t_idx in range(lo // tl, (hi - 1) // tl + 1):
            tile = load(level, t_idx)[agg]
            a = max(lo - t_idx * tl, 0)
            b = min(hi - t_idx * tl, tl)
            parts.append(tile[a:b])
        return np.concatenate(parts, axis=0)

    # -- appending -----------------------------------------------------
    def _write_tile(self, level: int, tile_idx: int, arr) -> None:
        """Write one COMPLETED tile in the store's format: a
        :mod:`tpudas_torch.codec` blob (crc embedded) under a codec, the
        legacy checksummed raw ``.npy`` otherwise.  Either way the
        write is atomic and funnels through the ``fs.write_enospc``
        fault site, so ENOSPC shedding and the crash drill cover the
        compressed store identically."""
        if self.codec is not None:
            blob = encode_tile(arr, self.codec, **self.codec_params)
            atomic_write_bytes(self.tile_blob_path(level, tile_idx), blob)
            return
        write_npy_checksummed(self.tile_path(level, tile_idx), arr)

    def _condition_rows(self, arr: np.ndarray) -> np.ndarray:
        """Map rows onto the codec's representable set before they
        touch tails or tiles (lossy codecs only; identity otherwise).
        This is what keeps a lossy store deterministic: every stored
        value roundtrips the codec bit-exactly, so append chunking,
        crash replay, and offline rebuild all converge on the same
        bytes — and the error bound holds uniformly, tails included."""
        if self.codec is None:
            return arr
        codec = get_codec(self.codec)
        if codec.condition is None:
            return arr
        return np.ascontiguousarray(
            codec.condition(arr, **self.codec_params)
        )

    def _append_level(self, level: int, stacked: np.ndarray) -> None:
        """Append rows to one level — ``stacked`` is ``(rows, n_ch)``
        at level 0, ``(3, rows, n_ch)`` (AGGS order) above.  COMPLETED
        tiles are written to their own files (immutable, once); the
        trailing partial rows stay in the tails snapshot and hit disk via
        the shared single-file :meth:`_save_tails` at the end of the
        append.  Everything written lands in the append-scoped
        write-through cache so the cascade reduces from memory."""
        row_ax = 0 if level == 0 else 1
        total = stacked.shape[row_ax]
        if total == 0:
            return
        tails, bases = self._ensure_tails()
        n = self.n(level)
        tl = self.tile_len
        off = n % tl
        base = n // tl
        if off:
            combined = np.concatenate(
                [self._partial_rows(level, base, off), stacked],
                axis=row_ax,
            )
        else:
            combined = stacked
        rows_comb = combined.shape[row_ax]
        n_full = rows_comb // tl
        if n_full:
            os.makedirs(
                os.path.join(self.tiles_dir, f"L{int(level)}"),
                exist_ok=True,
            )
        for j in range(n_full):
            sl = (slice(None),) * row_ax + (slice(j * tl, (j + 1) * tl),)
            tile = np.ascontiguousarray(combined[sl])
            self._write_tile(level, base + j, tile)
            self._wcache[(level, base + j)] = tile
        sl = (slice(None),) * row_ax + (slice(n_full * tl, rows_comb),)
        rem = np.ascontiguousarray(combined[sl])
        # single-writer mutation of the published snapshot dicts (the
        # driver is the only appender; server readers are other
        # processes, or read-only threads that took their own snapshot)
        tails[level] = rem
        bases[level] = base + n_full
        if rem.shape[row_ax]:
            self._wcache[(level, base + n_full)] = rem

    def append(self, times, data) -> int:
        """Append output rows to the pyramid and cascade the coarser
        levels.  ``times`` are datetime64 (ascending, on the output
        grid); ``data`` is (rows, n_ch).  Rows at or before the current
        head are dropped (idempotent re-append); an on-grid hole ahead
        of the head is filled with NaN rows.  Returns the number of
        grid rows the pyramid advanced by (fills included).
        """
        times = np.asarray(times).astype("datetime64[ns]")
        data = np.asarray(data, dtype=_STORE_DTYPE)
        if data.ndim != 2 or data.shape[0] != times.shape[0]:
            raise ValueError(
                f"append needs (rows, n_ch) data matching times; got "
                f"data {data.shape} for {times.shape[0]} times"
            )
        if times.size == 0:
            return 0
        t_ns = times.astype(np.int64)
        if self.t0_ns is None:
            if times.size < 2:
                raise ValueError(
                    "cannot infer the grid step from a single-row first "
                    "append; append at least two rows"
                )
            self.t0_ns = int(t_ns[0])
            self.step_ns = int(np.median(np.diff(t_ns)))
            if self.step_ns <= 0:
                raise ValueError("times must be strictly increasing")
            self.n_ch = int(data.shape[1])
            self.distance = np.arange(self.n_ch, dtype=np.float64)
            self.levels = [0]
        if data.shape[1] != self.n_ch:
            raise ValueError(
                f"channel count changed: pyramid has {self.n_ch}, "
                f"append got {data.shape[1]}"
            )
        step = int(self.step_ns)
        rel = t_ns - int(self.t0_ns)
        idx = np.round(rel / step).astype(np.int64)
        if np.any(np.abs(rel - idx * step) > 0.01 * step):
            raise ValueError(
                "append times are not on the pyramid grid "
                f"(anchor {self.t0_ns} ns, step {step} ns)"
            )
        if np.any(np.diff(idx) <= 0):
            raise ValueError("append times must be strictly increasing")
        n0 = self.levels[0]
        keep = idx >= n0
        if not np.any(keep):
            return 0
        idx = idx[keep]
        data = data[keep]
        # place rows on the contiguous grid [n0, last+1); holes -> NaN
        last = int(idx[-1])
        block = np.full((last + 1 - n0, self.n_ch), np.nan,
                        dtype=_STORE_DTYPE)
        block[idx - n0] = data
        block = self._condition_rows(block)
        self._wcache.clear()
        self._append_level(0, block)
        self.levels[0] = last + 1
        self._cascade()
        # durability order: completed tiles are already down; now the
        # tails, then the manifest that references them
        self._save_tails()
        self._wcache.clear()
        self._save_manifest()
        appended = int(block.shape[0])
        get_registry().counter(
            "tpudas_serve_pyramid_appended_samples_total",
            "level-0 grid rows appended to the tile pyramid "
            "(NaN gap fills included)",
        ).inc(appended)
        return appended

    def set_distance(self, distance) -> None:
        """Record the channel (distance) coordinates — called by
        :func:`sync_pyramid` from the first output patch so served
        windows carry real distances, not channel indices."""
        d = np.asarray(distance, dtype=np.float64)
        if self.n_ch is not None and d.shape[0] != self.n_ch:
            raise ValueError(
                f"distance coords ({d.shape[0]}) != channels "
                f"({self.n_ch})"
            )
        self.distance = d

    def _cascade_loader(self, level: int, tile_idx: int) -> dict:
        """Tile loader for the cascade: the append's write-through
        cache first (the just-written source rows), disk only for the
        occasional pre-existing backlog tile."""
        cached = self._wcache.get((level, tile_idx))
        if cached is not None:
            valid = min(
                self.tile_len, self.n(level) - tile_idx * self.tile_len
            )
            return self._tile_dict(level, cached, valid)
        return self._load_tile(level, tile_idx)

    def _cascade(self) -> None:
        """Propagate complete groups of ``factor`` finer samples into
        each coarser level until no level has a complete new group."""
        f = int(self.factor)
        lvl = 0
        while True:
            n_src = self.n(lvl)
            n_dst = self.n(lvl + 1)
            g = n_src // f - n_dst
            if g <= 0:
                break
            lo, hi = n_dst * f, (n_dst + g) * f
            if lvl == 0:
                base = self.read(0, lo, hi, loader=self._cascade_loader)
                srcs = {agg: base for agg in AGGS}
            else:
                srcs = {
                    agg: self.read(
                        lvl, lo, hi, agg=agg, loader=self._cascade_loader
                    )
                    for agg in AGGS
                }
            reduced = np.stack(
                [
                    block_reduce(srcs[agg], f, agg, self.engine).astype(
                        _STORE_DTYPE
                    )
                    for agg in AGGS
                ],
                axis=0,
            )
            # coarse rows obey the codec's representable set too, so
            # their later tile encode is exact and chunk-independent
            reduced = self._condition_rows(reduced)
            self._append_level(lvl + 1, reduced)
            if lvl + 1 < len(self.levels):
                self.levels[lvl + 1] = n_dst + g
            else:
                self.levels.append(n_dst + g)
            lvl += 1


def sync_pyramid(
    folder,
    factor: int | None = None,
    tile_len: int | None = None,
    engine=None,
    since=None,
    codec=None,
    generation: int = 0,
) -> int:
    """Bring ``folder``'s tile pyramid up to date with its output
    files; returns the number of level-0 rows appended.

    The realtime driver's per-round hook (and the offline rebuild
    oracle): opens/creates the store from the manifest, reads ONLY the
    output rows newer than the pyramid head through the directory
    spool's pushed-down time selection, and appends them group by
    contiguous group.  ``since`` anchors a FRESH pyramid at a later
    start (outputs older than it stay full-resolution-only — the
    query engine's file fallback covers them).

    ``factor`` / ``tile_len`` / ``codec`` only shape a FRESH pyramid
    (an existing manifest wins); their defaults come from
    ``TPUDAS_PYRAMID_FACTOR`` / ``TPUDAS_PYRAMID_TILE_LEN`` /
    ``TPUDAS_CODEC`` (a codec spec string, e.g.
    ``bitshuffle-deflate`` or ``quantize-deflate:max_error=1e-3``) so
    an operator can tune tile granularity and compression without
    touching driver code.  Re-encoding an EXISTING store is
    :func:`rebuild_pyramid`'s job — which passes ``generation`` (the
    bumped cache-invalidation counter) through to the fresh store so
    its first manifest already carries it.
    """
    from tpudas_torch.io.spool import spool as make_spool

    if factor is None:
        factor = int(
            os.environ.get("TPUDAS_PYRAMID_FACTOR", _DEFAULT_FACTOR)
        )
    if tile_len is None:
        tile_len = int(
            os.environ.get("TPUDAS_PYRAMID_TILE_LEN", _DEFAULT_TILE_LEN)
        )
    if codec is None:
        codec = os.environ.get("TPUDAS_CODEC")
    store = TileStore.open(folder, engine=engine)
    if store is None:
        store = TileStore.create(
            folder, factor=factor, tile_len=tile_len, engine=engine,
            codec=codec,
        )
        # non-zero only on the rebuild path: the fresh store's very
        # first manifest save must already carry the new generation
        store.generation = int(generation)
    head = store.head_ns
    lo = head
    if lo is None and since is not None:
        lo = int(to_datetime64(since).astype("datetime64[ns]").astype(np.int64))
    sp = make_spool(str(folder)).update()
    if lo is not None:
        sp = sp.select(time=(np.datetime64(int(lo), "ns"), None))
    if len(sp) == 0:
        return 0
    merged = sp.chunk(time=None)
    appended = 0
    for patch in merged:
        d = patch.host_data()
        ax = patch.axis_of("time")
        if ax != 0:
            d = np.moveaxis(d, ax, 0)
        times = np.asarray(patch.coords["time"]).astype("datetime64[ns]")
        t_ns = times.astype(np.int64)
        if lo is not None:
            m = t_ns >= int(lo)
            times, d = times[m], d[m]
        if times.size == 0:
            continue
        appended += _append_patch(store, times, d, patch)
    return appended


def _append_patch(store: TileStore, times, data, patch) -> int:
    """Append time-major rows plus (on the pyramid's first rows) the
    real distance coordinates from the source patch."""
    first_append = store.t0_ns is None
    appended = store.append(times, data)
    if first_append and store.t0_ns is not None:
        dist = patch.coords.get("distance")
        if dist is not None and len(dist) == store.n_ch:
            store.set_distance(dist)
            store._save_manifest()
    return appended


def append_patches(folder, patches, engine=None, store=None) -> tuple:
    """The realtime driver's FAST per-round path: append this round's
    freshly emitted output patches straight from memory — no index
    rescan, no re-read of files the process just wrote.  Returns
    ``(rows_appended, store_or_None)``; the caller passes the store
    back next round so a steady round costs one manifest ``stat``
    instead of a re-open (``None`` after any fallback — re-resolve
    from disk, the carry discipline).

    Correctness guard: the in-memory rows are used only when they are
    CONTIGUOUS with the pyramid head (overlap is fine — re-emitted
    rewind rows are dropped idempotently).  A fresh folder (no
    manifest yet) or a pyramid that fell behind the outputs (a crash
    between the output writes and the append) falls back to
    :func:`sync_pyramid`, which backfills from the files — so every
    path converges to the same byte-identical pyramid.
    """
    patches = [p for p in patches if p is not None]
    if store is not None:
        store.refresh()
    else:
        store = TileStore.open(folder, engine=engine)
    if store is None or store.head_ns is None or not patches:
        # no pyramid yet (anchor at the EARLIEST output, which may
        # predate this round) or nothing captured: authoritative sync
        return sync_pyramid(folder, engine=engine), None
    head = store.head_ns
    blocks = []
    for p in sorted(patches, key=lambda q: q.attrs["time_min"]):
        d = p.host_data()
        ax = p.axis_of("time")
        if ax != 0:
            d = np.moveaxis(d, ax, 0)
        t = np.asarray(p.coords["time"]).astype("datetime64[ns]")
        if t.size:
            blocks.append((t, d, p))
    if not blocks:
        return 0, store
    new_blocks = [
        b for b in blocks if int(b[0][-1].astype(np.int64)) >= head
    ]
    if not new_blocks:
        return 0, store  # pure re-emission (rewind overlap): nothing new
    lo_ns = int(new_blocks[0][0][0].astype(np.int64))
    if lo_ns > head:
        # rows missing between the pyramid head and this round's
        # capture (crashed append, listener gap): catch up from disk
        return sync_pyramid(folder, engine=engine), None
    # ONE append for the whole round: the cascade and the manifest
    # rename dance are paid once, not once per emitted patch (filesystem
    # ops dominate the steady-state append cost).  append() places the
    # concatenated rows on the grid itself, NaN-filling any interior
    # gap between blocks.
    times = np.concatenate([t for t, _, _ in new_blocks])
    data = np.concatenate([d for _, d, _ in new_blocks], axis=0)
    return _append_patch(store, times, data, new_blocks[0][2]), store
