"""Durable detection artifacts: the events ledger and score tiles.

The port's copy of :mod:`tpudas.detect.ledger`, byte for byte in its
file formats, so a ledger or score store either package wrote reads in
the other.  Everything lives under ``<output_folder>/.detect/`` beside
the stream carry and follows the integrity discipline (crc32 stamps,
``.prev`` double buffers, atomic writes through
:mod:`tpudas_torch.utils.atomicio`):

- ``events.jsonl`` (+ ``.prev``) — the append-only events ledger: one
  crc32-stamped JSON object per line (``stamp_json`` — the same
  embedded-digest format every JSON artifact uses), with a
  monotonically increasing ``seq``.  The file is REWRITTEN atomically
  (tmp + rename, outgoing primary rotated to ``.prev``) whenever a
  round commits new events, through the ``detect.ledger_write``
  fault-injection site; readers verify every line and fall down the
  ``.prev`` ladder on any defect.  Line bytes are canonical
  (sorted keys, minimal separators), so a crash-resume test can
  byte-compare ledgers.
- ``scores/`` — a single-level score tile store: fixed-length tiles
  ``NNNNNNNN.npy`` of ``(tile_len, 1 + n_ch) float64`` rows (column 0
  = time as ns relative to the manifest epoch — exact below ~104
  days; the rest = per-channel scores), a ``tails.npy`` partial tile,
  and a stamped ``manifest.json`` (+ ``.prev``) holding geometry and
  the committed row count.  Write order per append: full tiles, then
  tails, then manifest — rows beyond the manifest are a crashed
  append's surplus and are reproduced byte-identically on resume (the
  detect carry is the single commit point, see
  :mod:`tpudas_torch.detect.runner`).  A partial-tile read prefers a
  completed tile FILE when one exists (a crash after the tile
  completed but before the manifest advanced).

The score store is DERIVED data: any unrepairable defect is fixed by removing it; the runner
then recomputes deterministically from the output files.  (The JAX
package's startup audit also classifies and repairs these files; the
port's audit is a later slice.)
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from tpudas_torch.integrity.checksum import (
    count_fallback,
    count_unstamped,
    read_json_verified,
    rotate_prev,
    sidecar_path,
    stamp_json,
    verify_file_checksum,
    verify_json_obj,
    write_json_checksummed,
    write_npy_checksummed,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.atomicio import atomic_write_text
from tpudas_torch.utils.logging import log_event

__all__ = [
    "DETECT_DIRNAME",
    "LEDGER_FILENAME",
    "SCORES_DIRNAME",
    "SCORES_MANIFEST",
    "CorruptDetectError",
    "ScoreStore",
    "detect_dir",
    "event_line",
    "ledger_path",
    "ledger_status_text",
    "load_events",
    "parse_ledger_text",
    "validate_scores_manifest",
    "write_event_lines",
    "write_events",
]

DETECT_DIRNAME = ".detect"
LEDGER_FILENAME = "events.jsonl"
SCORES_DIRNAME = "scores"
SCORES_MANIFEST = "manifest.json"
SCORES_TAILS = "tails.npy"
SCORES_VERSION = 1

_DEFAULT_TILE_LEN = 512


class CorruptDetectError(RuntimeError):
    """The detect state on disk is internally inconsistent beyond the
    ``.prev`` ladder.  The runner's repair of last resort is a full
    reset: remove ``.detect/`` and recompute deterministically from
    the output files."""


def detect_dir(folder: str) -> str:
    return os.path.join(str(folder), DETECT_DIRNAME)


def ledger_path(folder: str) -> str:
    return os.path.join(detect_dir(folder), LEDGER_FILENAME)


# ---------------------------------------------------------------------------
# the events ledger

def event_line(ev: dict) -> str:
    """The canonical (deterministic) ledger line for one event."""
    return json.dumps(
        stamp_json(ev), sort_keys=True, separators=(",", ":")
    )


def ledger_status_text(text: str):
    """``(status, events_or_None)`` for one ledger file's text:
    ``"ok"`` (every line parses, verifies, seq contiguous),
    ``"unstamped"`` (parses but carries checksum-less legacy lines),
    or ``"torn"`` (a line that does not parse, a crc32 mismatch, or a
    non-contiguous ``seq`` — a torn tail line reads exactly like bit
    rot)."""
    events = []
    unstamped = False
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            return "torn", None
        if not isinstance(obj, dict):
            return "torn", None
        status = verify_json_obj(obj)
        if status == "mismatch":
            return "torn", None
        if status == "unstamped":
            unstamped = True
        obj = {k: v for k, v in obj.items() if k != "_crc32"}
        try:
            seq_ok = int(obj.get("seq", -1)) == len(events)
        except (TypeError, ValueError):
            seq_ok = False
        if not seq_ok:
            return "torn", None
        events.append(obj)
    return ("unstamped" if unstamped else "ok"), events


def parse_ledger_text(text: str) -> list:
    """Parse + verify one ledger file's text into the event list,
    raising ``ValueError`` on ANY defect (the verified-read ladder's
    rung test).  Unstamped (legacy) lines are accepted and counted."""
    status, events = ledger_status_text(text)
    if status == "torn":
        raise ValueError("ledger torn (bad line, crc mismatch, or seq)")
    if status == "unstamped":
        count_unstamped("events")
    return events


def load_events(folder: str) -> list:
    """The committed events, through the verified-read ladder:
    primary ``events.jsonl``, then ``.prev`` (one commit back — the
    runner's reconcile regenerates the difference byte-identically),
    then empty.  Every rejected rung is counted
    (``tpudas_integrity_fallback_total{artifact="events"}``)."""
    path = ledger_path(folder)
    for cand in (path, path + ".prev"):
        if not os.path.isfile(cand):
            continue
        try:
            from tpudas_torch.resilience.faults import fault_point

            fault_point("integrity.verify", path=cand, artifact="events")
            with open(cand) as fh:
                return parse_ledger_text(fh.read())
        except Exception as exc:
            count_fallback(
                "events", f"{type(exc).__name__}: {str(exc)[:120]}", cand
            )
            continue
    return []


def write_events(folder: str, events: list) -> str:
    """Atomically rewrite the whole ledger (outgoing primary rotated
    to ``.prev``) through the ``detect.ledger_write`` fault site.
    Returns the path."""
    return write_event_lines(folder, [event_line(ev) for ev in events])


def write_event_lines(folder: str, lines: list) -> str:
    """:func:`write_events` over pre-serialized canonical lines
    (each an :func:`event_line` result).  The steady-state commit path
    caches its lines so a round's rewrite serializes and crc-stamps
    only the NEW events — O(new) stamping work per commit, not
    O(ledger)."""
    from tpudas_torch.resilience.faults import fault_point

    path = ledger_path(folder)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fault_point("detect.ledger_write", path=path)
    text = "".join(line + "\n" for line in lines)
    rotate_prev(path)
    atomic_write_text(path, text)
    get_registry().counter(
        "tpudas_detect_ledger_appends_total",
        "events-ledger commits (atomic whole-file rewrites)",
    ).inc()
    return path


# ---------------------------------------------------------------------------
# the score tile store

def validate_scores_manifest(payload: dict) -> dict:
    for key in ("version", "epoch_ns", "n_ch", "tile_len", "n_rows",
                "tile_t0_rel"):
        if key not in payload:
            raise ValueError(f"scores manifest missing {key!r}")
    if payload["version"] != SCORES_VERSION:
        raise ValueError(
            f"scores manifest version skew: {payload['version']!r}"
        )
    if len(payload["tile_t0_rel"]) != (
        int(payload["n_rows"]) // int(payload["tile_len"])
    ):
        raise ValueError("scores manifest tile index inconsistent")
    return payload


class ScoreStore:
    """Single-level per-channel score tiles (see module docstring)."""

    def __init__(self, scores_dir, epoch_ns, n_ch, tile_len, n_rows,
                 tile_t0_rel, tails):
        self.dir = str(scores_dir)
        self.epoch_ns = int(epoch_ns)
        self.n_ch = int(n_ch)
        self.tile_len = int(tile_len)
        self.n_rows = int(n_rows)
        self.tile_t0_rel = [float(v) for v in tile_t0_rel]
        self._tails = np.asarray(tails, np.float64).reshape(
            -1, 1 + self.n_ch
        )
        # full tiles are immutable once written, so verified reads are
        # memoized per instance (bounded LRU); truncate_to invalidates
        # the removed indices.  The lock covers the plain-dict LRU for
        # readers that share one instance across threads.
        self._tile_cache: "dict[int, np.ndarray]" = {}
        self._tile_cache_lock = threading.Lock()

    # -- paths ---------------------------------------------------------
    @staticmethod
    def scores_dir(folder: str) -> str:
        return os.path.join(detect_dir(folder), SCORES_DIRNAME)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, SCORES_MANIFEST)

    @property
    def tails_path(self) -> str:
        return os.path.join(self.dir, SCORES_TAILS)

    def tile_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"{int(idx):08d}.npy")

    # -- open / create -------------------------------------------------
    @classmethod
    def create(cls, folder, epoch_ns, n_ch,
               tile_len=_DEFAULT_TILE_LEN) -> "ScoreStore":
        d = cls.scores_dir(folder)
        os.makedirs(d, exist_ok=True)
        store = cls(d, epoch_ns, n_ch, tile_len, 0, [], np.zeros(
            (0, 1 + int(n_ch))
        ))
        store._save_manifest()
        return store

    @classmethod
    def open(cls, folder) -> "ScoreStore | None":
        """Open from the verified manifest (``.prev`` ladder); None
        when no rung verifies (absent or unrepairable — the runner
        resets)."""
        d = cls.scores_dir(folder)
        manifest = os.path.join(d, SCORES_MANIFEST)
        payload = None
        for cand in (manifest, manifest + ".prev"):
            if not os.path.isfile(cand):
                continue
            try:
                obj, status = read_json_verified(cand, "scores_manifest")
                if status == "mismatch":
                    raise ValueError("scores manifest crc32 mismatch")
                if status == "unstamped":
                    count_unstamped("scores_manifest")
                payload = validate_scores_manifest(obj)
                break
            except Exception as exc:
                count_fallback(
                    "scores_manifest",
                    f"{type(exc).__name__}: {str(exc)[:120]}", cand,
                )
                continue
        if payload is None:
            return None
        store = cls(
            d, payload["epoch_ns"], payload["n_ch"], payload["tile_len"],
            payload["n_rows"], payload["tile_t0_rel"],
            np.zeros((0, 1 + int(payload["n_ch"]))),
        )
        store._tails = store._load_tails_consistent()
        return store

    def _load_tails_consistent(self) -> np.ndarray:
        """The committed partial-tile rows.

        The append order is tiles -> tails -> manifest, so the
        manifest is never NEWER than the other two; after a crash it
        can be stale.  A completed-but-uncommitted tile FILE at the
        (stale) manifest head is therefore preferred when it exists
        and verifies — it authoritatively holds the committed partial
        region's rows, whereas ``tails.npy`` may already belong to a
        LATER partial tile (an interrupted append that completed a
        tile and re-based the tails).  In the steady state no head
        tile file exists and the tails file is the source.  Raises
        :class:`CorruptDetectError` when neither source can supply the
        committed rows."""
        want = self.n_rows % self.tile_len
        if not want:
            return np.zeros((0, 1 + self.n_ch))
        head_tile = self.tile_path(self.n_rows // self.tile_len)
        if os.path.isfile(head_tile):
            try:
                if verify_file_checksum(
                    head_tile, artifact="scores_tile"
                ) != "mismatch":
                    arr = np.load(head_tile).reshape(-1, 1 + self.n_ch)
                    if arr.shape[0] >= want:
                        return np.asarray(arr[:want], np.float64)
            except Exception:
                pass
        tails = None
        if os.path.isfile(self.tails_path):
            try:
                if verify_file_checksum(
                    self.tails_path, artifact="scores_tails"
                ) == "mismatch":
                    raise ValueError("tails crc32 mismatch")
                tails = np.load(self.tails_path).reshape(-1, 1 + self.n_ch)
            except Exception as exc:
                count_fallback(
                    "scores_tails",
                    f"{type(exc).__name__}: {str(exc)[:120]}",
                    self.tails_path,
                )
                tails = None
        if tails is not None and tails.shape[0] >= want:
            return np.asarray(tails[:want], np.float64)
        raise CorruptDetectError(
            f"scores store cannot supply {want} committed tail "
            f"rows ({self.tails_path})"
        )

    # -- persistence ---------------------------------------------------
    def _save_manifest(self) -> None:
        rotate_prev(self.manifest_path)
        write_json_checksummed(
            self.manifest_path,
            {
                "version": SCORES_VERSION,
                "epoch_ns": self.epoch_ns,
                "n_ch": self.n_ch,
                "tile_len": self.tile_len,
                "n_rows": self.n_rows,
                "tile_t0_rel": self.tile_t0_rel,
            },
        )

    def append(self, t_ns, values) -> int:
        """Append score rows; write order: full tiles, tails, manifest
        (the commit).  Returns rows appended."""
        t_ns = np.asarray(t_ns, np.int64)
        values = np.asarray(values, np.float64)
        if t_ns.size == 0:
            return 0
        rel = (t_ns - self.epoch_ns).astype(np.float64)
        rows = np.concatenate([rel[:, None], values], axis=1)
        buf = (
            np.concatenate([self._tails, rows])
            if self._tails.size else rows
        )
        n_full = self.n_rows // self.tile_len
        while buf.shape[0] >= self.tile_len:
            tile = np.ascontiguousarray(buf[: self.tile_len])
            write_npy_checksummed(self.tile_path(n_full), tile)
            self.tile_t0_rel.append(float(tile[0, 0]))
            buf = buf[self.tile_len:]
            n_full += 1
        self._tails = np.ascontiguousarray(buf)
        write_npy_checksummed(self.tails_path, self._tails)
        self.n_rows += int(rows.shape[0])
        self._save_manifest()
        return int(rows.shape[0])

    def truncate_to(self, n_rows: int) -> None:
        """Reconcile to the detect carry's committed row count (rows
        beyond it are a crashed commit's surplus, regenerated
        identically).  Raises :class:`CorruptDetectError` when the
        target is AHEAD of the store (rows lost — the runner resets).
        """
        n_rows = int(n_rows)
        if n_rows == self.n_rows:
            return
        if n_rows > self.n_rows:
            raise CorruptDetectError(
                f"scores store holds {self.n_rows} rows but the carry "
                f"committed {n_rows}"
            )
        full = n_rows // self.tile_len
        rem = n_rows % self.tile_len
        if full < len(self.tile_t0_rel):
            # the new tail comes out of a previously completed tile
            src = self._read_tile(full)
            if src is None or src.shape[0] < rem:
                raise CorruptDetectError(
                    f"scores tile {full} cannot supply {rem} rows for "
                    "truncation"
                )
            self._tails = np.ascontiguousarray(src[:rem])
            for idx in range(full, len(self.tile_t0_rel)):
                with self._tile_cache_lock:
                    self._tile_cache.pop(idx, None)
                for p in (self.tile_path(idx),
                          sidecar_path(self.tile_path(idx))):
                    if os.path.isfile(p):
                        os.remove(p)
            self.tile_t0_rel = self.tile_t0_rel[:full]
        else:
            self._tails = np.ascontiguousarray(self._tails[:rem])
        self.n_rows = n_rows
        write_npy_checksummed(self.tails_path, self._tails)
        self._save_manifest()
        log_event("detect_scores_truncated", rows=n_rows)

    # -- reading -------------------------------------------------------
    _TILE_CACHE_MAX = 64

    def _read_tile(self, idx: int) -> np.ndarray | None:
        idx = int(idx)
        with self._tile_cache_lock:
            cached = self._tile_cache.pop(idx, None)
            if cached is not None:
                self._tile_cache[idx] = cached  # re-insert: LRU order
                return cached
        path = self.tile_path(idx)
        if not os.path.isfile(path):
            return None
        try:
            if verify_file_checksum(
                path, artifact="scores_tile"
            ) == "mismatch":
                raise ValueError("tile crc32 mismatch")
            tile = np.load(path).reshape(-1, 1 + self.n_ch)
        except Exception as exc:
            count_fallback(
                "scores_tile", f"{type(exc).__name__}: {str(exc)[:120]}",
                path,
            )
            return None
        with self._tile_cache_lock:
            self._tile_cache[idx] = tile
            while len(self._tile_cache) > self._TILE_CACHE_MAX:
                self._tile_cache.pop(next(iter(self._tile_cache)))
        return tile

    def read(self, t0_ns=None, t1_ns=None):
        """``(t_ns (S,), values (S, n_ch))`` of committed score rows
        within ``[t0_ns, t1_ns)`` (None = unbounded).  Tiles that fail
        verification are skipped (counted) — an honest gap, not a
        crash."""
        lo = -np.inf if t0_ns is None else float(int(t0_ns) - self.epoch_ns)
        hi = np.inf if t1_ns is None else float(int(t1_ns) - self.epoch_ns)
        chunks = []
        bounds = self.tile_t0_rel + [
            float(self._tails[0, 0]) if self._tails.size else np.inf
        ]
        for idx in range(len(self.tile_t0_rel)):
            nxt = bounds[idx + 1]
            if nxt <= lo or self.tile_t0_rel[idx] >= hi:
                continue
            tile = self._read_tile(idx)
            if tile is not None:
                chunks.append(tile)
        if self._tails.size:
            chunks.append(self._tails)
        if not chunks:
            return (np.zeros(0, np.int64),
                    np.zeros((0, self.n_ch), np.float64))
        rows = np.concatenate(chunks)
        m = (rows[:, 0] >= lo) & (rows[:, 0] < hi)
        rows = rows[m]
        t = rows[:, 0].astype(np.int64) + self.epoch_ns
        return t, rows[:, 1:]
