"""Sliding-window median despike.

The port's counterpart of :mod:`tpudas.ops.median`: the notebook's
``scipy.ndimage.median_filter`` calls (low_pass_dascore.ipynb:265,:334)
as a 1-D (per-trace) or square 2-D footprint with scipy's default
``reflect`` boundary (``c b a | a b c | c b a``).  On the device the
filter gathers the ``prod(sizes)`` shifted views of the padded array
and takes their middle with ``torch.median`` — plain torch ops, as the
JAX package leaves its sort-based ``jnp.median`` to XLA.  Sizes are
odd, so the middle is an element of the window: the result is
bit-equal to scipy's and to the JAX package's, and a NaN in a window
gives NaN as ``jnp.median`` does (a sort would order NaN last and pick
a finite middle).

The stack of views holds ``prod(sizes)`` copies of the array (25 for a
5 x 5 footprint), so it is built over slices of the last axis (the
channels of a ``(time, distance)`` array) of at most
``_MAX_STACK_BYTES`` each; every output element depends only on its own
window, so the slicing changes no value.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.device import resolve_device

__all__ = ["median_filter", "patch_median_filter"]

_HOST_ENGINES = ("numpy", "host", "scipy")
_MAX_STACK_BYTES = 1 << 30


def _reflect_pad(x, pad, axis):
    """scipy's ``reflect`` padding of ``pad`` samples on both sides of
    ``axis`` (``pad`` at most the axis length)."""
    n = x.shape[axis]
    front = torch.arange(pad - 1, -1, -1, device=x.device)
    back = torch.arange(n - 1, n - pad - 1, -1, device=x.device)
    return torch.cat(
        [x.index_select(axis, front), x, x.index_select(axis, back)],
        dim=axis,
    )


def _median_views(padded, shape, sizes, axes):
    """The median over the ``prod(sizes)`` shifted views of ``padded``
    that start at each output element of ``shape``."""
    shifts = [()]
    for sz in sizes:
        shifts = [sh + (k,) for sh in shifts for k in range(sz)]
    views = []
    for sh in shifts:
        view = padded
        for ax, k in zip(axes, sh):
            view = view.narrow(ax, k, shape[ax])
        views.append(view)
    return torch.median(torch.stack(views, dim=0), dim=0).values


def median_filter(data, size, axes=None, device=None):
    """Median filter along ``axes`` (default all), matching
    ``scipy.ndimage.median_filter(x, size)``: ``size`` is one odd
    footprint or a per-axis tuple (1 = no filtering on that axis, e.g.
    ``(3, 1)`` despikes along time only on a ``(T, C)`` array).  A
    tensor is filtered on its own device and returned as a tensor; a
    numpy array on ``device`` (default the CUDA card), returned as
    numpy."""
    host = not isinstance(data, torch.Tensor)
    x = (torch.from_numpy(np.ascontiguousarray(data)).to(
        resolve_device(device)) if host else data)
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if np.isscalar(size):
        sizes = (int(size),) * len(axes)
    else:
        sizes = tuple(int(s) for s in size)
        if len(sizes) != len(axes):
            raise ValueError(
                f"size tuple {sizes} must have one entry per filtered "
                f"axis ({len(axes)})"
            )
    for sz in sizes:
        if sz % 2 != 1:
            raise ValueError("median filter sizes must be odd")
    padded = x
    pads = [0] * x.ndim
    for ax, sz in zip(axes, sizes):
        if sz > 1:
            pads[ax] = sz // 2
            padded = _reflect_pad(padded, sz // 2, ax)
    # slices of the last axis, each with its own halo of padded columns
    last = x.ndim - 1
    n_views = int(np.prod(sizes))
    per_col = n_views * x.element_size() * max(x.numel() // max(
        x.shape[last], 1), 1)
    width = max(1, min(x.shape[last], int(_MAX_STACK_BYTES // per_col)))
    pieces = []
    for c0 in range(0, x.shape[last], width):
        c1 = min(c0 + width, x.shape[last])
        part = padded.narrow(last, c0, c1 - c0 + 2 * pads[last])
        shape = list(x.shape)
        shape[last] = c1 - c0
        pieces.append(_median_views(part, shape, sizes, axes))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=last)
    return out.cpu().numpy() if host else out


def patch_median_filter(patch, size=5, dim=None, engine=None, device=None):
    """Patch-level despike.  ``dim=None`` filters over all dims (the
    notebook's 2-D usage); ``dim="time"`` filters per channel.
    ``engine="scipy"`` (or ``"numpy"``/``"host"``) runs
    ``scipy.ndimage.median_filter`` on the host; otherwise the filter
    runs on ``device`` (default the CUDA card)."""
    if engine in _HOST_ENGINES:
        from scipy.ndimage import median_filter as _scipy_mf

        host = np.asarray(patch.data)
        if dim is None:
            out = _scipy_mf(host, size=size)
        else:
            ax = patch.axis_of(dim)
            sz = [1] * host.ndim
            sz[ax] = size
            out = _scipy_mf(host, size=tuple(sz))
        return patch.new(data=out)
    axes = None if dim is None else (patch.axis_of(dim),)
    out = median_filter(patch.host_data(), size, axes=axes, device=device)
    return patch.new(data=out)
