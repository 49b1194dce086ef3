"""Patch attributes with generation-spanning alias resolution.

The three reference notebooks read channel spacing / sampling interval
under three different attr spellings (SURVEY.md §2.3):

- ``distance_step`` / ``time_step``    (low_pass_dascore.ipynb:102,104)
- ``d_distance`` / ``d_time``          (rolling_mean_dascore.ipynb; lf_das.py:58)
- ``step_distance`` / ``step_time``    (low_pass_dascore_edge.ipynb:102,104)

:class:`PatchAttrs` stores canonical keys and resolves every alias on
read and on write, so all three generations work. ``time_step`` is
normalized to ``timedelta64[ns]`` (the notebooks divide it by
``np.timedelta64(1, "s")``), while numeric construction input — e.g.
``attrs={"d_time": 0.001}`` as in the reference impulse probe
(lf_das.py:58) — is accepted and converted.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from tpudas_torch.core.timeutils import to_datetime64, to_timedelta64

# alias -> canonical
ALIASES = {
    "d_time": "time_step",
    "step_time": "time_step",
    "time_step": "time_step",
    "d_distance": "distance_step",
    "step_distance": "distance_step",
    "distance_step": "distance_step",
}

# canonical keys normalized to datetime64 / timedelta64 on write
_DATETIME_KEYS = frozenset({"time_min", "time_max"})
_TIMEDELTA_KEYS = frozenset({"time_step"})


def canonical_name(key: str) -> str:
    return ALIASES.get(key, key)


def _normalize(key: str, value):
    if value is None:
        return None
    if key in _DATETIME_KEYS:
        return to_datetime64(value)
    if key in _TIMEDELTA_KEYS:
        return to_timedelta64(value)
    return value


class PatchAttrs(Mapping):
    """Immutable mapping of patch metadata with alias resolution."""

    __slots__ = ("_data",)

    def __init__(self, *args, **kwargs):
        data = {}
        for src in args:
            if src:
                for k, v in dict(src).items():
                    k = canonical_name(k)
                    data[k] = _normalize(k, v)
        for k, v in kwargs.items():
            k = canonical_name(k)
            data[k] = _normalize(k, v)
        object.__setattr__(self, "_data", data)

    # Mapping interface ------------------------------------------------
    def __getitem__(self, key):
        return self._data[canonical_name(key)]

    def __contains__(self, key):
        return canonical_name(key) in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def get(self, key, default=None):
        return self._data.get(canonical_name(key), default)

    def __setattr__(self, name, value):  # pragma: no cover - guard
        raise TypeError("PatchAttrs is immutable; use .updated(...)")

    def __repr__(self):
        return f"PatchAttrs({self._data!r})"

    def __eq__(self, other):
        if isinstance(other, PatchAttrs):
            other = other._data
        if not isinstance(other, Mapping):
            return NotImplemented
        if set(self._data) != {canonical_name(k) for k in other}:
            return False
        for k, v in other.items():
            mine = self._data[canonical_name(k)]
            try:
                if not np.all(mine == _normalize(canonical_name(k), v)):
                    return False
            except (TypeError, ValueError):
                return False
        return True

    # updates ----------------------------------------------------------
    def updated(self, **kwargs) -> "PatchAttrs":
        new = dict(self._data)
        for k, v in kwargs.items():
            k = canonical_name(k)
            new[k] = _normalize(k, v)
        return PatchAttrs(new)

    def to_dict(self) -> dict:
        return dict(self._data)


def derive_coord_attrs(coords, dims) -> dict:
    """Attrs derived from coordinates: min/max/step per dimension."""
    out = {}
    for dim in dims:
        axis = np.asarray(coords[dim])
        if axis.size == 0:
            continue
        if np.issubdtype(axis.dtype, np.datetime64):
            axis = axis.astype("datetime64[ns]")
            out[f"{dim}_min"] = axis.min()
            out[f"{dim}_max"] = axis.max()
            if axis.size > 1:
                step_ns = np.median(np.diff(axis.astype(np.int64)))
                out[f"{dim}_step"] = np.timedelta64(int(step_ns), "ns")
        else:
            out[f"{dim}_min"] = axis.min()
            out[f"{dim}_max"] = axis.max()
            if axis.size > 1:
                out[f"{dim}_step"] = float(np.median(np.diff(axis)))
    return out
