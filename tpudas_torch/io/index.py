"""Incremental directory index for spools.

The port's counterpart of :mod:`tpudas.io.index`.  ``spool(path).update()``
must cheaply pick up new interrogator files every polling round
(low_pass_dascore_edge.ipynb:201), so files are re-scanned only when
their (mtime, size) changes.  Records are plain dicts — no pandas on
the processing path.  The index persists to ``.tpudas_index.json``
inside the directory ("on first run, it will index the patches and
subsequently update the index file for future uses" — the reference
notebooks' contract), in the JAX package's format and version: a cache
either package writes loads in the other, with the same records.
"""

from __future__ import annotations

import os

import numpy as np

INDEX_FILENAME = ".tpudas_index.json"
_SUFFIXES = (".h5", ".hdf5", ".tdas")
_FORMAT_BY_SUFFIX = {".h5": "dasdae", ".hdf5": "dasdae", ".tdas": "tdas"}

# the frame's columns (:meth:`DirectoryIndex.to_dataframe`)
_COLUMNS = [
    "path",
    "mtime",
    "size",
    "time_min",
    "time_max",
    "time_step",
    "distance_min",
    "distance_max",
    "ntime",
    "ndistance",
    "format",
    "dims",
]


def _record_to_json(rec: dict) -> dict:
    out = {}
    for k, v in rec.items():
        if isinstance(v, np.datetime64):
            out[k] = {"__dt64__": int(v.astype("datetime64[ns]").astype(np.int64))}
        elif isinstance(v, np.timedelta64):
            out[k] = {"__td64__": int(v.astype("timedelta64[ns]").astype(np.int64))}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _record_from_json(rec: dict) -> dict:
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict) and "__dt64__" in v:
            out[k] = np.datetime64(int(v["__dt64__"]), "ns")
        elif isinstance(v, dict) and "__td64__" in v:
            out[k] = np.timedelta64(int(v["__td64__"]), "ns")
        else:
            out[k] = v
    return out


class DirectoryIndex:
    """Metadata index of all readable DAS files in one directory."""

    def __init__(self, directory):
        self.directory = os.path.abspath(str(directory))
        self._records: dict[str, dict] = {}
        self._scanned = False
        self._loaded_cache = False
        # {basename: "Type: message"} for files whose scan failed in the
        # last update(): the realtime driver charges them to the
        # quarantine ledger (tpudas_torch.resilience)
        self.scan_errors: dict[str, str] = {}

    # cache persistence ------------------------------------------------
    @property
    def cache_path(self) -> str:
        return os.path.join(self.directory, INDEX_FILENAME)

    # the JAX package's version (v2: exact tdas "dx"; v3: "dtype_code" /
    # "scale" for the int16 raw path); a cache of any other version is
    # discarded whole so every file is rescanned — header-only reads —
    # instead of old and new records coexisting (a mixed set would fail
    # the planner's geometry check and disable the planned path)
    CACHE_VERSION = 3

    def _load_cache(self):
        """Load the persisted index, falling back to the ``.prev``
        double buffer when the primary is torn or corrupt.  A primary
        that parses but carries a foreign version is authoritative: the
        whole cache is discarded (no ``.prev`` fallback)."""
        from tpudas_torch.integrity.checksum import (
            count_fallback,
            count_unstamped,
            read_json_verified,
        )

        self._loaded_cache = True
        for path in (self.cache_path, self.cache_path + ".prev"):
            try:
                raw, status = read_json_verified(path, "index")
            except FileNotFoundError:
                continue
            except (OSError, ValueError):
                count_fallback("index", "unparseable cache", path)
                continue
            if status == "mismatch":
                count_fallback("index", "checksum mismatch", path)
                continue
            if status == "unstamped":
                count_unstamped("index")
            if raw.get("version") != self.CACHE_VERSION:
                self._records = {}
                return
            try:
                self._records = {
                    k: _record_from_json(v)
                    for k, v in raw.get("files", {}).items()
                }
                return
            except (ValueError, KeyError, TypeError, AttributeError):
                count_fallback("index", "bad cache records", path)
                continue
        self._records = {}

    def _save_cache(self):
        from tpudas_torch.integrity.checksum import (
            rotate_prev,
            write_json_checksummed,
        )

        payload = {
            "version": self.CACHE_VERSION,
            "files": {k: _record_to_json(v) for k, v in self._records.items()},
        }
        try:
            # rename-not-copy double buffer: the outgoing good snapshot
            # survives as .prev for readers racing this save
            rotate_prev(self.cache_path)
            write_json_checksummed(self.cache_path, payload, indent=None)
        except OSError:
            pass  # read-only data dir: keep the index in memory only

    # scanning ---------------------------------------------------------
    def update(self, exclude=()) -> "DirectoryIndex":
        """Incrementally rescan the directory; returns self.

        ``exclude`` (basenames) skips those files entirely — no stat,
        no scan, records dropped while excluded (the realtime driver
        passes its quarantine set)."""
        from tpudas_torch.io.registry import scan_file
        from tpudas_torch.resilience.faults import fault_point

        fault_point("index.update", directory=self.directory)
        if not self._loaded_cache:
            self._load_cache()
        if not os.path.isdir(self.directory):
            raise FileNotFoundError(f"no such directory: {self.directory}")
        self._scanned = True
        exclude = frozenset(exclude)
        self.scan_errors = {}
        seen = set()
        changed = False
        for name in sorted(os.listdir(self.directory)):
            if not name.lower().endswith(_SUFFIXES) or name in exclude:
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            seen.add(name)
            rec = self._records.get(name)
            if rec is not None and rec.get("mtime") == st.st_mtime and rec.get(
                "size"
            ) == st.st_size:
                continue
            fmt = _FORMAT_BY_SUFFIX[os.path.splitext(name.lower())[1]]
            try:
                info = scan_file(path, format=fmt)[0]
            except (OSError, ValueError, KeyError) as exc:
                # unreadable / foreign / partially-written file: skipped,
                # and reported in scan_errors; a stale record for it
                # must go too (its bytes no longer match the record)
                self.scan_errors[name] = f"{type(exc).__name__}: {str(exc)[:200]}"
                if self._records.pop(name, None) is not None:
                    changed = True
                continue
            info["mtime"] = st.st_mtime
            info["size"] = st.st_size
            info.pop("shape", None)
            self._records[name] = info
            changed = True
        for name in set(self._records) - seen:
            del self._records[name]
            changed = True
        if changed:
            self._save_cache()
        return self

    def ensure(self) -> "DirectoryIndex":
        """Index lazily if never scanned (spool used without .update())."""
        if not self._scanned:
            self.update()
        return self

    def records(self) -> list:
        """Copies of every record, in file-name order."""
        return [dict(self._records[k]) for k in sorted(self._records)]

    def to_dataframe(self):
        """The records as a pandas DataFrame (every :data:`_COLUMNS`
        column present), as the JAX index gives it.  Imports pandas here
        only."""
        import pandas as pd

        if not self._records:
            return pd.DataFrame(columns=_COLUMNS)
        df = pd.DataFrame(list(self._records.values()))
        for col in _COLUMNS:
            if col not in df.columns:
                df[col] = None
        return df

    def time_range_records(self, t_lo=None, t_hi=None) -> list:
        """Copies of the records whose time span overlaps ``[t_lo,
        t_hi]`` (datetime64 bounds; ``None`` = unbounded), sorted by
        ``time_min`` — straight off the in-memory/persisted records, no
        directory rescan (call :meth:`update` first when freshness
        matters).  The serve query engine's full-resolution fallback
        reads through this."""
        if not self._loaded_cache:
            self._load_cache()
        lo = None if t_lo is None else np.datetime64(t_lo, "ns")
        hi = None if t_hi is None else np.datetime64(t_hi, "ns")
        out = []
        for rec in self._records.values():
            r_lo, r_hi = rec.get("time_min"), rec.get("time_max")
            if r_lo is None or r_hi is None:
                continue
            if lo is not None and np.datetime64(r_hi, "ns") < lo:
                continue
            if hi is not None and np.datetime64(r_lo, "ns") > hi:
                continue
            out.append(dict(rec))
        out.sort(key=lambda r: np.datetime64(r["time_min"], "ns"))
        return out
