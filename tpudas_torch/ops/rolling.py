"""Rolling-window reductions with pandas-compatible semantics.

The port's counterpart of :mod:`tpudas.ops.rolling`.  The reference
computes mean-decimation via
``patch.rolling(time=w, step=s, engine="numpy").mean()``
(rolling_mean_dascore.ipynb:148).  Semantics (DASCore mimics pandas
``rolling(window, step=step)``):

- output positions are input indices ``p = 0, s, 2s, ...`` (so the
  output time coord is ``time[::s]``),
- the window at position ``p`` is the trailing ``[p-w+1, p]``,
- positions with ``p < w-1`` (incomplete window) are NaN — the warm-up
  prefix downstream strips with ``dropna("time")``.

Device engine: a direct windowed reduction on the alignment-shifted
float32 tensor, NaN prefix concatenated — the JAX package's
``lax.reduce_window`` in plain torch, on ``device`` (default the CUDA
card).  ``amax``/``amin`` run over ``unfold`` windows; sums run a fixed
pairwise tree over each window (:func:`_window_sum`), so a window's sum
does not depend on where the array starts, how many windows it holds or
the device (the detect RMS operator's chunk invariance rests on it).  Host engine (``"numpy"``/``"host"``): the float64 reference of
the same semantics, computed with torch on CPU tensors.  The mesh
batched rolling mean of the JAX package belongs to the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.core import units as _units
from tpudas_torch.device import resolve_device

__all__ = ["PatchRoller", "exact_sqrt", "rolling_reduce"]

_HOST_ENGINES = ("numpy", "host")


def exact_sqrt(t: torch.Tensor) -> torch.Tensor:
    """Elementwise square root, the same bytes on every call.  On the
    CPU ``torch.sqrt`` runs MKL's vector math in chunks over the OpenMP
    threads, and in about one fresh process in a hundred its first call
    leaves one chunk at a lower accuracy (up to ~3e-4 relative; later
    calls are right): so the CPU path takes numpy's correctly rounded
    ``sqrt``.  On the card this is ``torch.sqrt``."""
    if t.device.type != "cpu":
        return torch.sqrt(t)
    return torch.from_numpy(np.sqrt(t.detach().numpy()))


def _window_step_samples(window_sec, step_sec, d_sec):
    w = int(round(window_sec / d_sec))
    s = int(round(step_sec / d_sec)) if step_sec is not None else 1
    if w < 1:
        raise ValueError(f"window shorter than one sample ({window_sec} s)")
    if s < 1:
        raise ValueError(f"step shorter than one sample ({step_sec} s)")
    return w, s


# elements of the first level of a window sum's pairwise tree per pass
_MAX_TREE_ELEMS = 1 << 28


def _window_sum(x, w, s, n):
    """Sums of the ``w`` rows of (T, ...) ``x`` starting at rows
    ``0, s, ..., (n-1)s``.  Each window is summed in one fixed pairwise
    order that depends on ``w`` alone: its rows are halved into two
    halves added row for row (an odd row rides to the next level) until
    one row is left.  So a window's sum is the same bytes whatever
    ``n``, wherever ``x`` starts (a detect operator's pool starts at
    another row in each chunking) and on any device (only elementwise
    adds), and it keeps pairwise summation's accuracy."""
    rest = tuple(x.shape[1:])
    per_window = max(w // 2, 1) * max(int(np.prod(rest)), 1)
    chunk = max(1, _MAX_TREE_ELEMS // per_window)
    outs = []
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        # (w, m, ...): element [k, i] is row i0*s + i*s + k, no copy
        v = torch.as_strided(
            x, (w, m) + rest, (x.stride(0), s * x.stride(0)) + x.stride()[1:],
            x.storage_offset() + i0 * s * x.stride(0),
        )
        while v.shape[0] > 1:
            h = v.shape[0] // 2
            y = v[:h] + v[h:2 * h]
            v = torch.cat([y, v[2 * h:]]) if v.shape[0] % 2 else y
        outs.append(v[0])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _windowed(x, w, s, op):
    """Valid trailing windows of ``w`` rows at stride ``s`` of (T, ...)
    ``x``, reduced by ``op`` (the positions ``w-1, w-1+s, ...``)."""
    if op in ("mean", "sum"):
        red = _window_sum(x, w, s, (x.shape[0] - w) // s + 1)
        return red / w if op == "mean" else red
    win = x.unfold(0, w, s)  # (n, ..., w): a view, no copy
    if op == "max":
        return win.amax(dim=-1)
    if op == "min":
        return win.amin(dim=-1)
    raise ValueError(op)


def _reduce_window(data, w, s, op):
    """data: (T, ...). Valid trailing windows at stride s, pandas-aligned;
    returns the full output including the NaN warm-up rows."""
    n = data.shape[0]
    n_out = (n - 1) // s + 1  # positions 0, s, 2s, ... < n
    i0 = -(-(w - 1) // s)  # ceil((w-1)/s): first complete-window output
    if i0 >= n_out:  # no window ever completes
        return torch.full((n_out,) + tuple(data.shape[1:]), float("nan"),
                          dtype=data.dtype, device=data.device)
    j0 = i0 * s - w + 1  # input start so valid windows land on positions
    red = _windowed(data[j0:], w, s, op)
    nan_rows = torch.full((i0,) + tuple(data.shape[1:]), float("nan"),
                          dtype=data.dtype, device=data.device)
    return torch.cat([nan_rows, red], dim=0)


def _host_rolling(data, w, s, op):
    """float64 reference (pandas semantics) on CPU tensors: the float64
    cumulative sum for mean/sum, the windowed extremum for min/max."""
    x = torch.as_tensor(np.asarray(data, np.float64))
    n = x.shape[0]
    positions = torch.arange(0, n, s)
    out = torch.full((len(positions),) + tuple(x.shape[1:]), float("nan"),
                     dtype=torch.float64)
    valid = positions >= w - 1
    pv = positions[valid]
    if pv.numel():
        if op in ("mean", "sum"):
            c = torch.cat([torch.zeros((1,) + tuple(x.shape[1:]),
                                       dtype=torch.float64),
                           torch.cumsum(x, dim=0)])  # c[k] = sum of first k
            ssum = c[pv + 1] - c[pv + 1 - w]
            out[valid] = ssum / w if op == "mean" else ssum
        elif op in ("max", "min"):
            start = int(pv[0]) - (w - 1)
            out[valid] = _windowed(x[start:], w, s, op)
        else:
            raise ValueError(op)
    return out.numpy()


def rolling_reduce(data, w, s, op, axis=0, engine=None, device=None):
    """Rolling reduction along ``axis`` with pandas alignment.  The
    host engine returns float64 numpy; the device engine a float32 (or
    the input's floating dtype) tensor on ``data``'s device (a tensor)
    or on ``device`` (numpy; default the CUDA card)."""
    if engine in _HOST_ENGINES:
        host = np.asarray(data)
        moved = axis != 0
        if moved:
            host = np.moveaxis(host, axis, 0)
        out = _host_rolling(host, int(w), int(s), op)
        if moved:
            out = np.moveaxis(out, 0, axis)
        return out
    if isinstance(data, torch.Tensor):
        arr = data
    else:
        arr = torch.from_numpy(np.ascontiguousarray(data)).to(
            resolve_device(device))
    if not torch.is_floating_point(arr) or arr.dtype == torch.float64:
        # the JAX package computes in float32 (x64 off)
        arr = arr.to(torch.float32)
    moved = axis != 0
    if moved:
        arr = torch.movedim(arr, axis, 0)
    out = _reduce_window(arr, int(w), int(s), op)
    if moved:
        out = torch.movedim(out, 0, axis)
    return out


def _host(out):
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


class PatchRoller:
    """Factory returned by ``patch.rolling(time=w, step=s, engine=...)``."""

    def __init__(self, patch, step=None, engine=None, device=None, **kwargs):
        if len(kwargs) != 1:
            raise ValueError("rolling requires exactly one dim, e.g. time=1*s")
        (dim, window), = kwargs.items()
        self.patch = patch
        self.dim = dim
        self.engine = engine
        self.device = device
        d = patch.get_sample_step(dim)
        if d is None or d <= 0:
            raise ValueError(f"cannot infer sample step for dim {dim!r}")
        self.window, self.step = _window_step_samples(
            _units.get_seconds(window), _units.get_seconds(step), d
        )

    def _stepped_coords_attrs(self, p):
        """Subsampled coords + attrs with the *_step refreshed to the
        post-decimation step (stale steps would corrupt any downstream
        Nyquist / window / contiguity computation)."""
        from tpudas_torch.core.attrs import derive_coord_attrs

        coords = dict(p.coords)
        coords[self.dim] = p.coords[self.dim][:: self.step]
        attrs = p.attrs.to_dict()
        attrs.update(derive_coord_attrs(coords, p.dims))
        return coords, attrs

    def _reduce(self, data, op):
        return rolling_reduce(
            data, self.window, self.step, op, axis=self.patch.axis_of(self.dim),
            engine=self.engine, device=self.device,
        )

    def _apply(self, op):
        p = self.patch
        out = _host(self._reduce(p.host_data(), op))
        coords, attrs = self._stepped_coords_attrs(p)
        return p.new(data=out, coords=coords, attrs=attrs)

    def mean(self):
        return self._apply("mean")

    def sum(self):
        return self._apply("sum")

    def min(self):
        return self._apply("min")

    def max(self):
        return self._apply("max")

    def std(self):
        """Population std on the same windows.

        Computed on offset-shifted data ``y = x - mean(x)`` before the
        ``E[y^2] - E[y]^2`` identity: with a large DC offset (common in
        raw strain-rate counts) the unshifted identity cancels
        catastrophically in f32.  Shifting by the NaN-ignoring mean
        keeps a NaN gap sample to the windows that overlap it.
        """
        p = self.patch
        ax = p.axis_of(self.dim)
        if self.engine in _HOST_ENGINES:
            data = torch.as_tensor(np.asarray(p.host_data(), np.float64))
        else:
            data = torch.from_numpy(np.ascontiguousarray(p.host_data())).to(
                resolve_device(self.device))
            if not torch.is_floating_point(data) or data.dtype == torch.float64:
                data = data.to(torch.float32)
        shift = torch.nan_to_num(
            torch.nanmean(data, dim=ax, keepdim=True), nan=0.0)
        y = data - shift
        m = torch.as_tensor(self._reduce(y, "mean"))
        m2 = torch.as_tensor(self._reduce(y * y, "mean"))
        out = exact_sqrt(torch.clamp_min(m2 - m**2, 0))
        coords, attrs = self._stepped_coords_attrs(p)
        return p.new(data=_host(out), coords=coords, attrs=attrs)
