"""Immutable mapping utilities.

Provides ``FrozenDict``, the read-only configuration view exposed by
``LFProc.parameters`` (reference: lf_das.py:12, lf_das.py:293-295, via
dascore.utils.mapping.FrozenDict).
"""

from collections.abc import Mapping


class FrozenDict(Mapping):
    """A dict-like, hashable-when-possible, immutable mapping."""

    __slots__ = ("_data",)

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_data", dict(*args, **kwargs))

    def __getitem__(self, key):
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def __repr__(self):
        return f"FrozenDict({self._data!r})"

    def __setattr__(self, name, value):  # pragma: no cover - guard
        raise TypeError("FrozenDict is immutable")

    def updated(self, **kwargs):
        """Return a new FrozenDict with ``kwargs`` merged in."""
        new = dict(self._data)
        new.update(kwargs)
        return FrozenDict(new)
