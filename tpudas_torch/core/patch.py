"""Patch: an immutable, labeled 2-D array of DAS data.

The port's counterpart of :mod:`tpudas.core.patch` (the DASCore Patch
the reference builds on, SURVEY.md §2.3, L2).  Data is a
``(time, distance)`` array held on the host as numpy (the engine moves
each window to the device itself); coordinates are host-side
numpy axes (``time`` is datetime64[ns], ``distance`` float meters);
attrs are a :class:`~tpudas_torch.core.attrs.PatchAttrs` with the
three-generation alias map.

IO and viz hang off the ``.io`` and ``.viz`` accessors as in the
reference call sites (``patch.io.write(path, "dasdae")`` —
lf_das.py:232; ``patch.viz.waterfall(scale=0.01)`` —
low_pass_dascore.ipynb cell 22).  ``pass_filter``, ``interpolate``,
``rolling`` and ``median_filter`` run the port's FFT engine,
gather-lerp, windowed reductions and median despike on the card
(``device="cpu"`` on request).
"""

from __future__ import annotations

import numpy as np

from tpudas_torch.core.attrs import PatchAttrs, derive_coord_attrs
from tpudas_torch.core.timeutils import to_datetime64, to_float_seconds
from tpudas_torch.core import units as _units

__all__ = ["Patch"]


def _as_host(data) -> np.ndarray:
    """Materialize data on host as a numpy array."""
    return np.asarray(data)


class _PatchIO:
    """Accessor for ``patch.io.write(path, format)``."""

    def __init__(self, patch: "Patch"):
        self._patch = patch

    def write(self, path, format="dasdae", **kwargs):
        from tpudas_torch.io.registry import write_patch

        return write_patch(self._patch, path, format=format, **kwargs)


class _PatchViz:
    """Accessor for ``patch.viz.waterfall(...)``; ``pyramid`` and
    ``max_px`` are :func:`tpudas_torch.viz.waterfall.patch_waterfall`'s
    (a window wider than ``max_px`` samples rasters from the output
    folder's tile pyramid)."""

    def __init__(self, patch: "Patch"):
        self._patch = patch

    def waterfall(self, scale=None, ax=None, cmap="seismic", show=False,
                  pyramid=None, max_px=1024):
        from tpudas_torch.viz.waterfall import patch_waterfall

        return patch_waterfall(
            self._patch, scale=scale, ax=ax, cmap=cmap, show=show,
            pyramid=pyramid, max_px=max_px,
        )


class Patch:
    """Immutable labeled 2-D array: ``dims`` name each axis, ``coords``
    label them, ``attrs`` carry metadata."""

    __slots__ = ("_data", "_coords", "_dims", "_attrs")

    def __init__(self, data=None, coords=None, dims=None, attrs=None):
        if data is None:
            raise ValueError("Patch requires data")
        if coords is None:
            raise ValueError("Patch requires coords")
        if dims is None:
            dims = tuple(coords.keys())
        dims = tuple(dims)
        if len(dims) != len(data.shape):
            raise ValueError(
                f"dims {dims} rank != data rank {len(data.shape)}"
            )
        norm_coords = {}
        for name in dims:
            if name not in coords:
                raise ValueError(f"missing coord for dim {name!r}")
            axis = coords[name]
            if name == "time":
                axis = to_datetime64(np.asarray(axis))
            else:
                axis = np.asarray(axis)
                if axis.dtype.kind in "iu":
                    axis = axis.astype(np.float64)
            if axis.ndim != 1 or axis.shape[0] != data.shape[dims.index(name)]:
                raise ValueError(
                    f"coord {name!r} length {axis.shape} does not match "
                    f"data axis length {data.shape[dims.index(name)]}"
                )
            norm_coords[name] = axis
        # extra (non-dim) coords pass through untouched
        for name, axis in (coords or {}).items():
            if name not in norm_coords:
                norm_coords[name] = np.asarray(axis)

        derived = derive_coord_attrs(norm_coords, dims)
        merged = PatchAttrs(derived, attrs or {})
        # coordinate extrema always win over stale user values — the
        # filename/resume contracts read attrs["time_min"/"time_max"]
        # (lf_das.py:230) and must reflect the actual coordinates.
        lock = {
            k: v
            for k, v in derived.items()
            if k.endswith("_min") or k.endswith("_max")
        }
        if lock:
            merged = merged.updated(**lock)

        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_coords", norm_coords)
        object.__setattr__(self, "_dims", dims)
        object.__setattr__(self, "_attrs", merged)

    # immutability -----------------------------------------------------
    def __setattr__(self, name, value):  # pragma: no cover - guard
        raise TypeError("Patch is immutable; use .new(...)")

    # basic accessors --------------------------------------------------
    @property
    def data(self):
        return self._data

    @property
    def coords(self):
        return self._coords

    @property
    def dims(self):
        return self._dims

    @property
    def attrs(self) -> PatchAttrs:
        return self._attrs

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def io(self) -> _PatchIO:
        return _PatchIO(self)

    @property
    def viz(self) -> _PatchViz:
        return _PatchViz(self)

    def axis_of(self, dim: str) -> int:
        return self._dims.index(dim)

    def host_data(self) -> np.ndarray:
        return _as_host(self._data)

    def __repr__(self):
        dims = ", ".join(
            f"{d}: {len(self._coords[d])}" for d in self._dims
        )
        return f"<tpudas_torch.Patch ({dims})>"

    def equals(self, other: "Patch", atol=0.0) -> bool:
        if self._dims != other._dims:
            return False
        for d in self._dims:
            if not np.array_equal(self._coords[d], other._coords[d]):
                return False
        a, b = self.host_data(), other.host_data()
        if a.shape != b.shape:
            return False
        return bool(np.allclose(a, b, atol=atol, equal_nan=True))

    # construction helpers --------------------------------------------
    def new(self, data=None, coords=None, dims=None, attrs=None) -> "Patch":
        """Return a copy with any of data/coords/dims/attrs replaced
        (reference call sites: ``patch.new(data=...)``)."""
        return Patch(
            data=self._data if data is None else data,
            coords=dict(self._coords) if coords is None else coords,
            dims=self._dims if dims is None else dims,
            attrs=self._attrs.to_dict() if attrs is None else attrs,
        )

    def update_attrs(self, **kwargs) -> "Patch":
        """Return a copy with attrs updated (``update_attrs(d_time=dt)``
        — lf_das.py:227)."""
        return Patch(
            data=self._data,
            coords=dict(self._coords),
            dims=self._dims,
            attrs=self._attrs.updated(**kwargs).to_dict(),
        )

    def pipe(self, func, *args, **kwargs) -> "Patch":
        """Apply ``func(patch, *args, **kwargs)`` — the hook the edge
        calibration probe uses (lf_das.py:61)."""
        return func(self, *args, **kwargs)

    # selection --------------------------------------------------------
    def select(self, **kwargs) -> "Patch":
        """Trim along named dimensions: ``select(time=(a, b),
        distance=(d1, d2))``; ``None`` bounds are open; endpoints are
        inclusive."""
        data = self._data
        coords = dict(self._coords)
        for dim, bounds in kwargs.items():
            if bounds is None:
                continue
            if dim not in self._dims:
                raise ValueError(f"unknown dimension {dim!r}")
            lo, hi = bounds
            axis_vals = coords[dim]
            if dim == "time":
                lo = None if lo is None else to_datetime64(lo)
                hi = None if hi is None else to_datetime64(hi)
            mask = np.ones(len(axis_vals), dtype=bool)
            if lo is not None:
                mask &= axis_vals >= lo
            if hi is not None:
                mask &= axis_vals <= hi
            idx = np.nonzero(mask)[0]
            ax = self.axis_of(dim)
            if idx.size and idx[-1] - idx[0] + 1 == idx.size:
                sl = slice(int(idx[0]), int(idx[-1]) + 1)
                data = data[(slice(None),) * ax + (sl,)]
                coords[dim] = axis_vals[sl]
            else:
                data = np.take(_as_host(data), idx, axis=ax)
                coords[dim] = axis_vals[idx]
        return Patch(
            data=data, coords=coords, dims=self._dims,
            attrs=self._attrs.to_dict(),
        )

    def dropna(self, dim: str = "time", how: str = "any") -> "Patch":
        """Drop labels along ``dim`` whose slice contains NaN
        (rolling_mean_dascore.ipynb:189)."""
        ax = self.axis_of(dim)
        host = self.host_data()
        other_axes = tuple(i for i in range(host.ndim) if i != ax)
        bad = np.isnan(host)
        mask = bad.any(axis=other_axes) if how == "any" else bad.all(axis=other_axes)
        keep = ~mask
        data = np.compress(keep, host, axis=ax)
        coords = dict(self._coords)
        coords[dim] = self._coords[dim][keep]
        return Patch(
            data=data, coords=coords, dims=self._dims,
            attrs=self._attrs.to_dict(),
        )

    # compute (dispatch to tpudas_torch.ops) ---------------------------
    def pass_filter(self, order: int = 4, engine=None, device=None,
                    **kwargs) -> "Patch":
        """Zero-phase band filtering along a named dimension:
        ``pass_filter(time=(None, corner_hz))`` (lf_das.py:40, :223), on
        ``device`` (default the CUDA card)."""
        from tpudas_torch.ops.filter import patch_pass_filter

        return patch_pass_filter(self, order=order, engine=engine,
                                 device=device, **kwargs)

    def interpolate(self, engine=None, device=None, **kwargs) -> "Patch":
        """Linear resample onto a new axis:
        ``interpolate(time=new_axis)`` (lf_das.py:42, :223-225), on
        ``device`` (default the CUDA card)."""
        from tpudas_torch.ops.resample import patch_interpolate

        return patch_interpolate(self, engine=engine, device=device, **kwargs)

    def rolling(self, step=None, engine=None, device=None, **kwargs):
        """Windowed reduction factory:
        ``rolling(time=w, step=s, engine="numpy").mean()``
        (rolling_mean_dascore.ipynb:148); the device engine runs on
        ``device`` (default the CUDA card)."""
        from tpudas_torch.ops.rolling import PatchRoller

        return PatchRoller(self, step=step, engine=engine, device=device,
                           **kwargs)

    def median_filter(self, engine=None, device=None, **kwargs) -> "Patch":
        """Sliding-window median despike (the notebook's
        ``scipy.ndimage.median_filter`` equivalent,
        low_pass_dascore.ipynb:265): ``median_filter(size=5)`` over both
        dims, ``median_filter(size=9, dim="time")`` per channel, on
        ``device`` (default the CUDA card); ``engine="scipy"`` runs
        scipy on the host."""
        from tpudas_torch.ops.median import patch_median_filter

        return patch_median_filter(self, engine=engine, device=device,
                                   **kwargs)

    # convenience ------------------------------------------------------
    def time_seconds(self) -> np.ndarray:
        """Time coord as float64 seconds from the first sample."""
        t = self._coords["time"]
        return to_float_seconds(t, epoch=t[0])

    def get_sample_step(self, dim: str = "time") -> float:
        """Sample step along ``dim`` in SI units (seconds / meters)."""
        val = self._attrs.get(f"{dim}_step")
        return _units.get_seconds(val)
