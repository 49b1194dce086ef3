"""Spools: lazy, indexable views over collections of patches.

The port's counterpart of :mod:`tpudas.io.spool` — the DASCore Spool
surface the reference consumes (SURVEY.md §2.3): ``spool(...)``
dispatch, ``update``, ``sort``, ``select``, ``chunk(time=None)`` merge
with gap detection and gap fill, ``chunk(time=<seconds>)`` re-split,
indexing/iteration.  Selection is
recorded lazily and applied at materialization, so a
``DirectorySpool`` window read (``spool.select(time=...)`` inside the
overlap-save loop, lf_das.py:236) touches only the overlapping files
and only the needed rows.

Records are kept as lists of dicts (:meth:`BaseSpool.contents`); only
:meth:`BaseSpool.get_contents` builds a pandas DataFrame, importing
pandas inside itself, so the processing path runs without pandas.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.io.index import DirectoryIndex
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.logging import log_event

__all__ = ["spool", "BaseSpool", "MemorySpool", "DirectorySpool", "merge_patches"]


def spool(obj):
    """Create a spool from a path, a Patch, a list of patches, or pass
    an existing spool through (``dc.spool(...)`` — lf_das.py:215,239)."""
    if isinstance(obj, BaseSpool):
        return obj
    if isinstance(obj, Patch):
        return MemorySpool([obj])
    if isinstance(obj, (list, tuple)):
        return MemorySpool(list(obj))
    if isinstance(obj, (str, os.PathLike)):
        path = str(obj)
        if os.path.isdir(path):
            return DirectorySpool(path)
        if os.path.isfile(path):
            from tpudas_torch.io.registry import read_file

            return MemorySpool(read_file(path))
        raise FileNotFoundError(f"no such file or directory: {path}")
    raise TypeError(f"cannot build a spool from {type(obj)!r}")


def _normalize_time_bounds(bounds):
    if bounds is None:
        return None
    lo, hi = bounds
    return (
        None if lo is None else to_datetime64(lo),
        None if hi is None else to_datetime64(hi),
    )


def _step_ns(patch) -> int:
    step = patch.attrs.get("time_step")
    if step is None:
        return 0
    return int(step.astype("timedelta64[ns]").astype(np.int64))


def _fillable_steps(gap_ns, step_ns, max_fill):
    """Number of whole grid steps a fillable hole spans, or 0.

    A hole qualifies when (a) filling is enabled, (b) it lands on the
    sampling grid (within 0.1 step — files from one interrogator share
    a clock, so real holes are exact multiples), and (c) the missing
    span ``(k-1) * step`` is at most ``max_fill`` seconds.
    """
    if max_fill is None or step_ns <= 0:
        return 0
    k = int(round(gap_ns / step_ns))
    if k < 2:
        return 0
    if abs(gap_ns - k * step_ns) > 0.1 * step_ns:
        return 0
    return k if (k - 1) * step_ns <= max_fill * 1e9 else 0


def merge_patches(patches, tolerance=1.5, max_fill=None):
    """Merge time-sorted patches into maximal contiguous groups.

    Adjacent patches are contiguous when the start of the next is within
    ``tolerance * time_step`` of one step past the end of the previous.
    Exact overlaps (an integer number of steps, e.g. re-written resume
    windows) are trimmed from the incoming patch; true gaps split the
    result into multiple patches — the caller (``check_merge``
    semantics, lf_das.py:16-20) decides whether that is an error.

    ``max_fill`` (seconds, default off): holes whose missing span is at
    most this long — and that land on the sampling grid — are bridged
    by linear interpolation between the bounding samples instead of
    splitting the result (event ``gap_filled``).  This is the single
    meaning of LFProc's ``data_gap_tolorance``.
    """
    if not patches:
        return []
    patches = sorted(patches, key=lambda p: p.attrs["time_min"])
    groups = [[patches[0]]]
    for p in patches[1:]:
        prev = groups[-1][-1]
        step_ns = _step_ns(prev)
        gap_ns = int(
            (
                p.attrs["time_min"].astype("datetime64[ns]")
                - prev.attrs["time_max"].astype("datetime64[ns]")
            ).astype(np.int64)
        )
        if step_ns > 0 and (
            gap_ns <= tolerance * step_ns
            or _fillable_steps(gap_ns, step_ns, max_fill)
        ):
            groups[-1].append(p)
        else:
            groups.append([p])
    out = []
    for group in groups:
        if len(group) == 1:
            out.append(group[0])
            continue
        first = group[0]
        ax = first.axis_of("time")
        step_ns = _step_ns(first)
        datas = []
        times = []
        prev_end = None
        filled_rows = 0
        for p in group:
            data = p.host_data()
            if ax != 0:
                data = np.moveaxis(data, ax, 0)
            taxis = p.coords["time"]
            if prev_end is not None and taxis.size and taxis[0] <= prev_end:
                # overlap: drop duplicated leading samples
                keep = taxis > prev_end
                start = int(np.argmax(keep)) if keep.any() else taxis.size
                data = data[start:]
                taxis = taxis[start:]
            if taxis.size == 0:
                continue
            if prev_end is not None and step_ns > 0:
                gap_ns = int(
                    (
                        taxis[0].astype("datetime64[ns]")
                        - prev_end.astype("datetime64[ns]")
                    ).astype(np.int64)
                )
                k = _fillable_steps(gap_ns, step_ns, max_fill)
                if k:
                    # bridge the admitted hole: linear interpolation
                    # between the bounding rows keeps the grid regular
                    nf = k - 1
                    a, b = datas[-1][-1], data[0]
                    w = (np.arange(1, nf + 1, dtype=np.float64) / k
                         ).reshape((-1,) + (1,) * (data.ndim - 1))
                    fill = a * (1.0 - w) + b * w
                    datas.append(fill.astype(data.dtype, copy=False))
                    times.append(
                        prev_end.astype("datetime64[ns]")
                        + np.arange(1, nf + 1)
                        * np.timedelta64(step_ns, "ns")
                    )
                    filled_rows += nf
            datas.append(data)
            times.append(taxis)
            prev_end = taxis[-1]
        if filled_rows:
            log_event(
                "gap_filled",
                rows=filled_rows,
                seconds=filled_rows * step_ns / 1e9,
            )
        merged = np.concatenate(datas, axis=0)
        if ax != 0:
            merged = np.moveaxis(merged, 0, ax)
        coords = dict(first.coords)
        coords["time"] = np.concatenate(times)
        out.append(
            Patch(
                data=merged,
                coords=coords,
                dims=first.dims,
                attrs=first.attrs.to_dict(),
            )
        )
    return out


class BaseSpool:
    """Common spool behavior; subclasses implement materialization."""

    # the DASCore-style identity columns every contents row carries;
    # absent metadata is an empty string, as in DASCore's frame
    _ID_COLUMNS = (
        "network",
        "station",
        "tag",
        "instrument_id",
        "cable_id",
        "experiment_id",
        "data_type",
        "data_category",
        "data_units",
        "dims",
    )

    # -- abstract surface ---------------------------------------------
    def _materialize(self) -> list:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def contents(self) -> list:
        """One dict per patch: coordinate ranges/steps/counts (the
        index record columns) — the pandas-free form of
        :meth:`get_contents`."""
        raise NotImplementedError

    def update(self):
        return self

    def sort(self, key="time"):
        return self

    # -- shared behavior ----------------------------------------------
    def __getitem__(self, item):
        patches = self._materialize()
        return patches[item]

    def __iter__(self):
        return iter(self._materialize())

    def select(self, time=None, distance=None):
        raise NotImplementedError

    def chunk(self, time="__required__", overlap=None, tolerance=1.5,
              max_fill=None):
        """``chunk(time=None)`` merges contiguous patches along time;
        ``chunk(time=seconds)`` merges then re-splits into fixed-length
        segments (an extension the reference leaves to DASCore).
        ``max_fill`` (seconds) bridges on-grid holes up to that long by
        linear interpolation — see :func:`merge_patches`.  ``overlap``
        (DASCore's keyword) is accepted and ignored, as in the JAX
        package."""
        if time == "__required__":
            raise TypeError("chunk() requires the time keyword, e.g. time=None")
        merged = merge_patches(
            self._materialize(), tolerance=tolerance, max_fill=max_fill
        )
        if time is None:
            return MemorySpool(merged)
        seg_sec = float(time)
        out = []
        for p in merged:
            taxis = p.coords["time"]
            if taxis.size == 0:
                continue
            step = p.attrs.get("time_step")
            if step is None:
                raise ValueError(
                    "chunk(time=<seconds>) requires a patch with a known "
                    "time_step (single-sample or step-less patches cannot "
                    "be segmented)"
                )
            step_s = step.astype("timedelta64[ns]").astype(np.int64) / 1e9
            seg_n = max(int(round(seg_sec / step_s)), 1)
            ax = p.axis_of("time")
            host = p.host_data()
            for start in range(0, taxis.size, seg_n):
                sl = (slice(None),) * ax + (slice(start, start + seg_n),)
                out.append(
                    Patch(
                        data=host[sl],
                        coords={**p.coords, "time": taxis[start : start + seg_n]},
                        dims=p.dims,
                        attrs=p.attrs.to_dict(),
                    )
                )
        return MemorySpool(out)

    def get_contents(self):
        """Summary DataFrame of the spool, one row per patch
        (``Spool.get_contents()`` — low_pass_dascore.ipynb:81), with
        the DASCore identity columns.  Imports pandas here only."""
        import pandas as pd

        rows = self.contents()
        for row in rows:
            for col in self._ID_COLUMNS:
                row.setdefault(col, "")
        return pd.DataFrame(rows)


class MemorySpool(BaseSpool):
    """A spool over in-memory patches."""

    def __init__(self, patches):
        self._patches = list(patches)

    def _materialize(self):
        return self._patches

    def __len__(self):
        return len(self._patches)

    def contents(self):
        rows = []
        for p in self._patches:
            a = p.attrs
            row = {
                "time_min": a.get("time_min"),
                "time_max": a.get("time_max"),
                "time_step": a.get("time_step"),
                "distance_min": a.get("distance_min"),
                "distance_max": a.get("distance_max"),
                "ntime": len(p.coords.get("time", ())),
                "ndistance": len(p.coords.get("distance", ())),
                "dims": ",".join(p.dims),
            }
            for col in self._ID_COLUMNS:
                if col not in row:
                    row[col] = a.get(col) or ""
            rows.append(row)
        return rows

    def sort(self, key="time"):
        return MemorySpool(
            sorted(self._patches, key=lambda p: p.attrs[f"{key}_min"])
        )

    def select(self, time=None, distance=None):
        time = _normalize_time_bounds(time)
        out = []
        for p in self._patches:
            q = p.select(time=time, distance=distance)
            if q.coords["time"].size and (
                "distance" not in q.dims or q.coords["distance"].size
            ):
                out.append(q)
        return MemorySpool(out)


class DirectorySpool(BaseSpool):
    """A lazy spool over an indexed directory of DAS files.

    Selection criteria are recorded and pushed down into the file reads
    (range-sliced reads), so materializing a processing window reads
    only the bytes it needs.
    """

    _index_cache: dict[str, DirectoryIndex] = {}

    def __init__(self, directory, _index=None, _time=None, _distance=None,
                 _sort_key="time", _exclude=frozenset()):
        self.directory = os.path.abspath(str(directory))
        if _index is not None:
            self._index = _index
        else:
            # share one index per directory per process: the edge loop
            # re-creates spool(path).update() every round
            self._index = DirectorySpool._index_cache.setdefault(
                self.directory, DirectoryIndex(self.directory)
            )
        self._time = _time
        self._distance = _distance
        self._sort_key = _sort_key
        self._exclude = frozenset(_exclude)

    def _clone(self, **kw):
        args = {
            "_index": self._index,
            "_time": self._time,
            "_distance": self._distance,
            "_sort_key": self._sort_key,
            "_exclude": self._exclude,
        }
        args.update(kw)
        return DirectorySpool(self.directory, **args)

    def update(self):
        """Re-scan the directory for new/changed files (incremental)."""
        reg = get_registry()
        t0 = _time.perf_counter()
        self._index.update(exclude=self._exclude)
        reg.histogram(
            "tpudas_spool_update_seconds",
            "directory index re-scan latency",
        ).observe(_time.perf_counter() - t0)
        reg.counter(
            "tpudas_spool_updates_total", "directory index re-scans"
        ).inc()
        return self._clone()

    def sort(self, key="time"):
        return self._clone(_sort_key=key)

    def exclude(self, names):
        """A view of this spool without the given basenames (the
        realtime driver's quarantine): the index re-scan skips them and
        records already indexed are hidden."""
        return self._clone(_exclude=self._exclude | frozenset(map(str, names)))

    @property
    def scan_errors(self) -> dict:
        """{basename: message} for files whose scan failed in the last
        ``update()``."""
        return dict(self._index.scan_errors)

    def select(self, time=None, distance=None):
        return self._clone(
            _time=_normalize_time_bounds(time) if time is not None else self._time,
            _distance=distance if distance is not None else self._distance,
        )

    # index-level filtering -------------------------------------------
    def contents(self) -> list:
        """The index records this view selects (no payload IO)."""
        recs = self._index.ensure().records()
        if self._exclude:
            recs = [r for r in recs
                    if os.path.basename(str(r["path"])) not in self._exclude]
        if self._sort_key == "time":
            recs.sort(key=lambda r: np.datetime64(r["time_min"], "ns"))
        if self._time is not None:
            lo, hi = self._time
            if lo is not None:
                recs = [r for r in recs if r["time_max"] >= lo]
            if hi is not None:
                recs = [r for r in recs if r["time_min"] <= hi]
        if self._distance is not None:
            lo, hi = self._distance
            if lo is not None:
                recs = [r for r in recs if float(r["distance_max"]) >= lo]
            if hi is not None:
                recs = [r for r in recs if float(r["distance_min"]) <= hi]
        return recs

    def __len__(self):
        return len(self.contents())

    def _read_row(self, row) -> Patch:
        from tpudas_torch.io.registry import read_file
        from tpudas_torch.resilience.faults import SpoolReadError, fault_point

        reg = get_registry()
        t0 = _time.perf_counter()
        try:
            fault_point("spool.read", path=row["path"])
            patches = read_file(
                row["path"],
                format=row.get("format") or "dasdae",
                time=self._time,
                distance=self._distance,
            )
        except Exception as exc:
            # attribute the failure to the file, so the fault boundary
            # can charge the quarantine ledger
            reg.counter(
                "tpudas_spool_read_errors_total",
                "file payload reads that raised",
            ).inc()
            raise SpoolReadError(row["path"], exc) from exc
        reg.histogram(
            "tpudas_spool_read_seconds",
            "per-file payload read latency (selection applied)",
        ).observe(_time.perf_counter() - t0)
        reg.counter(
            "tpudas_spool_reads_total", "file payload reads"
        ).inc()
        return patches[0]

    def _materialize(self):
        return [self._read_row(row) for row in self.contents()]

    def __getitem__(self, item):
        rows = self.contents()
        n = len(rows)
        if isinstance(item, (int, np.integer)):
            idx = int(item)
            if idx < 0:
                idx += n
            if not 0 <= idx < n:
                raise IndexError(f"spool index {item} out of range ({n} patches)")
            return self._read_row(rows[idx])
        return [self._read_row(row) for row in rows[item]]

    def native_window_plan(self, t_lo, t_hi):
        """The JAX package's name for :meth:`window_plan`: the same plan,
        or None where it does not apply."""
        return self.window_plan(t_lo, t_hi)

    def window_plan(self, t_lo, t_hi):
        """A :func:`tpudas_torch.io.tdas.plan_window_from_records` plan
        for the window [t_lo, t_hi] honoring this spool's distance
        selection, or None when the planned path does not apply
        (non-tdas files, mixed geometry, coverage gap)."""
        from tpudas_torch.io.tdas import plan_window_from_records

        return plan_window_from_records(
            self.select(time=(t_lo, t_hi)).contents(), t_lo, t_hi,
            self._distance,
        )
