"""Incremental directory index for spools.

The port's counterpart of :mod:`tpudas.io.index`.  ``spool(path).update()``
must cheaply pick up new interrogator files every polling round
(low_pass_dascore_edge.ipynb:201), so files are re-scanned only when
their (mtime, size) changes.  Records are plain dicts — no pandas on
the processing path.  The index lives in memory, shared per directory
per process; persisting it beside the data (the JAX package's
``.tpudas_index.json``) is a later slice.
"""

from __future__ import annotations

import os

_SUFFIXES = (".h5", ".hdf5", ".tdas")
_FORMAT_BY_SUFFIX = {".h5": "dasdae", ".hdf5": "dasdae", ".tdas": "tdas"}

class DirectoryIndex:
    """Metadata index of all readable DAS files in one directory."""

    def __init__(self, directory):
        self.directory = os.path.abspath(str(directory))
        self._records: dict[str, dict] = {}
        self._scanned = False
        # {basename: "Type: message"} for files whose scan failed in the
        # last update(): the realtime driver charges them to the
        # quarantine ledger (tpudas_torch.resilience)
        self.scan_errors: dict[str, str] = {}

    def update(self, exclude=()) -> "DirectoryIndex":
        """Incrementally rescan the directory; returns self.

        ``exclude`` (basenames) skips those files entirely — no stat,
        no scan, records dropped while excluded (the realtime driver
        passes its quarantine set)."""
        from tpudas_torch.io.registry import scan_file
        from tpudas_torch.resilience.faults import fault_point

        fault_point("index.update", directory=self.directory)
        if not os.path.isdir(self.directory):
            raise FileNotFoundError(f"no such directory: {self.directory}")
        self._scanned = True
        exclude = frozenset(exclude)
        self.scan_errors = {}
        seen = set()
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
                self._records.pop(name, None)
                continue
            info["mtime"] = st.st_mtime
            info["size"] = st.st_size
            info.pop("shape", None)
            self._records[name] = info
        for name in set(self._records) - seen:
            del self._records[name]
        return self

    def ensure(self) -> "DirectoryIndex":
        """Index lazily if never scanned (spool used without .update())."""
        if not self._scanned:
            self.update()
        return self

    def records(self) -> list:
        """Copies of every record, in file-name order."""
        return [dict(self._records[k]) for k in sorted(self._records)]
