"""Resampling: linear interpolation onto a target grid.

The port's counterpart of :mod:`tpudas.ops.resample`.  The reference
decimates by linear interpolation onto a uniform target grid
(``Patch.interpolate(time=new_axis)``, lf_das.py:42, :223-225).
Datetimes and index arithmetic stay on the host in float64/int64
(exact, a copy of the JAX package's host code); the device work is a
gather and a lerp (``index_select`` twice), as the JAX package left it
to XLA — there is no TPU kernel to replace.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.core.attrs import derive_coord_attrs
from tpudas_torch.core.timeutils import to_datetime64, to_float_seconds

__all__ = ["patch_interpolate", "interp_indices_weights", "gather_lerp"]


def interp_indices_weights(src, dst):
    """Host-side: indices/weights for linear interp of ``dst`` into ``src``.

    Both axes may be datetime64 or numeric; computation is float64
    (datetime64 -> int64 ns), exact for ms-quantized grids. Out-of-range
    targets clamp to the edge values (np.interp semantics, which the
    reference's engine inherits).

    Returns (idx int32 array, w float32 array) with
    ``out = src_data[idx] * (1-w) + src_data[idx+1] * w``.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if np.issubdtype(src.dtype, np.datetime64) or np.issubdtype(
        dst.dtype, np.datetime64
    ):
        epoch = to_datetime64(src[0])
        s = to_float_seconds(to_datetime64(src), epoch=epoch)
        d = to_float_seconds(to_datetime64(dst), epoch=epoch)
    else:
        s = src.astype(np.float64)
        d = dst.astype(np.float64)
    if s.size < 2:
        raise ValueError("need at least 2 source samples to interpolate")
    if np.any(np.diff(s) <= 0):
        raise ValueError("source axis must be strictly increasing")
    idx = np.searchsorted(s, d, side="right") - 1
    idx = np.clip(idx, 0, s.size - 2)
    denom = s[idx + 1] - s[idx]
    w = (d - s[idx]) / denom
    w = np.clip(w, 0.0, 1.0)  # edge clamp, matches np.interp
    return idx.astype(np.int32), w.astype(np.float32)


def gather_lerp(data, idx, w):
    """Linear interpolation along dim 0 of a (T, ...) tensor:
    ``data[idx] + (data[idx+1] - data[idx]) * w`` (``idx``/``w`` from
    :func:`interp_indices_weights`, as arrays or tensors)."""
    dev = data.device
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64))
    idx = idx.to(device=dev, dtype=torch.int64)
    w = torch.as_tensor(w, device=dev)
    lo = data.index_select(0, idx)
    hi = data.index_select(0, idx + 1)
    wcol = w.reshape((-1,) + (1,) * (data.dim() - 1)).to(data.dtype)
    return lo + (hi - lo) * wcol


def patch_interpolate(patch, engine=None, device=None, **kwargs):
    """Patch-level ``interpolate(dim=new_axis)`` (linear, edge-clamped).
    ``engine`` ``"numpy"``/``"host"`` interpolates on the host in
    float64; anything else gathers on ``device`` (default the CUDA
    card).  The result holds host data."""
    if len(kwargs) != 1:
        raise ValueError("interpolate requires exactly one dim, e.g. time=new_axis")
    (dim, new_axis), = kwargs.items()
    ax = patch.axis_of(dim)
    src = patch.coords[dim]
    if dim == "time":
        new_axis = to_datetime64(np.asarray(new_axis))
    else:
        new_axis = np.asarray(new_axis, dtype=np.float64)
    idx, w = interp_indices_weights(src, new_axis)

    host = patch.host_data()
    if ax != 0:
        host = np.moveaxis(host, ax, 0)
    if engine in ("numpy", "host"):
        lo = host[idx]
        hi = host[idx + 1]
        out = lo + (hi - lo) * w.astype(np.float64).reshape(
            (-1,) + (1,) * (host.ndim - 1)
        )
        out = out.astype(host.dtype, copy=False)
    else:
        from tpudas_torch.device import resolve_device

        x = torch.from_numpy(np.ascontiguousarray(host)).to(resolve_device(device))
        out = gather_lerp(x, idx, w).cpu().numpy()
    if ax != 0:
        out = np.moveaxis(out, 0, ax)

    coords = dict(patch.coords)
    coords[dim] = new_axis
    # refresh the step attr for the new axis; other attrs carry over
    attrs = patch.attrs.to_dict()
    attrs.update(derive_coord_attrs(coords, patch.dims))
    return patch.new(data=out, coords=coords, attrs=attrs)
