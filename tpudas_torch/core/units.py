"""Minimal pint-style time units.

The reference notebooks import ``from dascore.units import s`` and build
window/step sizes as ``d_t * s`` (rolling_mean_dascore.ipynb cell 7).
This module provides just enough of a quantity algebra for those call
sites: multiplication with numbers yields a :class:`Quantity` whose
``to_seconds()`` the kernels consume.
"""

from __future__ import annotations

import numpy as np

_SECONDS_PER = {
    "ns": 1e-9,
    "us": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "min": 60.0,
    "h": 3600.0,
}


class Quantity:
    """A magnitude with a time unit; supports * / + - with scalars."""

    __slots__ = ("magnitude", "unit")

    def __init__(self, magnitude, unit: str = "s"):
        if unit not in _SECONDS_PER:
            raise ValueError(f"unknown unit {unit!r}")
        self.magnitude = magnitude
        self.unit = unit

    def to_seconds(self) -> float:
        return float(self.magnitude) * _SECONDS_PER[self.unit]

    def to_timedelta64(self) -> np.timedelta64:
        return np.timedelta64(int(round(self.to_seconds() * 1e9)), "ns")

    # arithmetic -------------------------------------------------------
    def __mul__(self, other):
        return Quantity(self.magnitude * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return self.to_seconds() / other.to_seconds()
        return Quantity(self.magnitude / other, self.unit)

    def __add__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.to_seconds() + other.to_seconds(), "s")
        raise TypeError("can only add Quantity to Quantity")

    def __sub__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.to_seconds() - other.to_seconds(), "s")
        raise TypeError("can only subtract Quantity from Quantity")

    def __neg__(self):
        return Quantity(-self.magnitude, self.unit)

    def __float__(self):
        return self.to_seconds()

    def __eq__(self, other):
        if isinstance(other, Quantity):
            return self.to_seconds() == other.to_seconds()
        return NotImplemented

    def __repr__(self):
        return f"{self.magnitude} {self.unit}"


class Unit(Quantity):
    """A named unit; ``d_t * s`` produces a Quantity in that unit."""

    def __init__(self, unit: str):
        super().__init__(1.0, unit)


# the public unit registry used by the notebooks
ns = Unit("ns")
us = Unit("us")
ms = Unit("ms")
s = Unit("s")
minute = Unit("min")
h = Unit("h")


def get_seconds(value, default=None):
    """Coerce float / Quantity / timedelta64 → float seconds (or default)."""
    if value is None:
        return default
    if isinstance(value, Quantity):
        return value.to_seconds()
    if isinstance(value, np.timedelta64):
        return value.astype("timedelta64[ns]").astype(np.int64) / 1e9
    return float(value)
