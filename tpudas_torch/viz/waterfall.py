"""Waterfall (raster) QC plots.

The port's counterpart of :mod:`tpudas.viz.waterfall`.  matplotlib is
imported inside the functions that draw, so importing this module needs
no matplotlib (the card's host may lack it).

``waterfall_plot`` keeps the reference's signature and observable
behavior (lf_das.py:110-178: bounds validation that prints and returns,
95th-percentile symmetric clip, seismic colormap, measured-depth extent
``(ch + ch_start) * spacing - surface_fiber``, 600-dpi JPEG) but is
built from this module's own raster helpers, shared with
``patch_waterfall`` — the Patch-native QC plot behind
``Patch.viz.waterfall(scale=...)`` (low_pass_dascore.ipynb cell 22),
which draws a real datetime x-axis.
"""

from __future__ import annotations

import numpy as np

__all__ = ["waterfall_plot", "patch_waterfall"]


def _symmetric_clip(data, percentile=95.0):
    """Symmetric color limits at the given percentile of |data|."""
    finite = np.abs(data[np.isfinite(data)])
    if finite.size == 0:
        return (-1.0, 1.0)
    v = float(np.percentile(finite, percentile))
    return (-v, v)


def _raster(ax, block, extent, clim, cmap="seismic"):
    """The one imshow call both QC plots share: row-major block, no
    resampling, symmetric limits."""
    return ax.imshow(
        block,
        aspect="auto",
        interpolation="none",
        cmap=cmap,
        extent=extent,
        vmin=clim[0],
        vmax=clim[1],
    )


def _validate_window(data, min_sec, max_sec, min_ch, max_ch, sample_rate):
    """The reference's print-and-return input guard; returns an error
    string (exact reference wording — notebooks see these messages) or
    None when the window is plottable."""
    n_ch, n_t = data.shape
    if min_sec >= max_sec or min_sec < 0 or max_sec * sample_rate > n_t:
        return (
            f"ERROR in plotSpaceTime inputs minSec: {min_sec} "
            f"or maxSec: {max_sec}"
        )
    if min_ch >= max_ch or min_ch < 0 or max_ch > n_ch:
        return (
            f"Error in plotSpaceTime inputs minCh: {min_ch} "
            f"or maxCh: {max_ch} referring to array with {n_ch} channels."
        )
    return None


def waterfall_plot(
    some_data,
    min_sec,
    max_sec,
    min_ch,
    max_ch,
    ch_start,
    channel_spacing,
    surface_fiber,
    sample_rate,
    fig_title,
    fig_dir,
    fig_name,
):
    """QC raster of a (channel x time) array; saves ``fig_name``.jpeg."""
    import matplotlib.pyplot as plt

    some_data = np.asarray(some_data)
    error = _validate_window(
        some_data, min_sec, max_sec, min_ch, max_ch, sample_rate
    )
    if error is not None:
        print(error)
        return

    # measured depth along the fiber for the y axis
    def depth(ch):
        return (ch + ch_start) * channel_spacing - surface_fiber

    sec = slice(int(min_sec * sample_rate), int(max_sec * sample_rate))
    fig, ax = plt.subplots(figsize=(12, 8))
    im = _raster(
        ax,
        some_data[min_ch:max_ch, sec],
        extent=(min_sec, max_sec, depth(max_ch), depth(min_ch)),
        clim=_symmetric_clip(some_data),
    )
    ax.set_ylabel("MD (ft)", fontsize=10)
    ax.set_xlabel("Time (sec)", fontsize=10)
    ax.set_title(fig_title, fontsize=14)
    fig.colorbar(im, ax=ax).set_label("Strain rate (1/s)", fontsize=10)
    fig.savefig(f"{fig_dir}/{fig_name}.jpeg", dpi=600, format="jpeg")
    plt.show()


def _pyramid_block(patch, pyramid, max_px):
    """(data, times, dists) for the patch's window read from the tile
    pyramid at the coarsest level satisfying the ``max_px`` time-axis
    budget, or ``None`` when the pyramid does not exist / does not
    cover the window (caller falls back to the full-resolution patch
    data)."""
    from tpudas_torch.serve.query import QueryEngine

    engine = (
        pyramid
        if isinstance(pyramid, QueryEngine)
        else QueryEngine(str(pyramid))
    )
    if not engine.has_pyramid():
        # no pyramid: bail BEFORE query() would fall back to re-reading
        # the window's full-resolution files we already hold as `patch`
        return None
    times = patch.coords["time"]
    dists = np.asarray(patch.coords["distance"], dtype=np.float64)
    result = engine.query(
        times[0],
        times[-1],
        distance=(float(dists.min()), float(dists.max())),
        max_samples=int(max_px),
    )
    if result.n_samples == 0 or result.source not in ("tiles", "mixed"):
        return None
    return result.data, result.times, result.distance


def patch_waterfall(patch, scale=None, ax=None, cmap="seismic", show=False,
                    pyramid=None, max_px=1024):
    """Waterfall of a Patch: time on x (real datetimes), distance on y,
    symmetric color limits. ``scale`` (scalar) clips at
    ``scale * max|data|``; a (lo, hi) pair sets limits directly.

    ``pyramid`` (an output folder path or a
    :class:`tpudas_torch.serve.query.QueryEngine`) rasters windows wider than
    ``max_px`` time samples from the multi-resolution tile pyramid
    instead of materializing the full-resolution block — the plot is
    O(pixels), not O(window).  With no pyramid (or a window the pyramid
    does not cover) the full-resolution path runs unchanged, and below
    the budget the output is identical with or without ``pyramid``."""
    import matplotlib.dates as mdates
    import matplotlib.pyplot as plt

    data = patch.host_data()
    tax = patch.axis_of("time")
    if tax != 0:
        data = data.T
    times = patch.coords["time"]
    dists = patch.coords["distance"]
    if (
        pyramid is not None
        and max_px is not None
        and data.shape[0] > int(max_px)
    ):
        block = _pyramid_block(patch, pyramid, max_px)
        if block is not None:
            data, times, dists = block
    finite = np.abs(data[np.isfinite(data)])
    vmax = float(finite.max()) if finite.size else 1.0
    if scale is None:
        lim = (-vmax, vmax)
    elif np.ndim(scale) == 0:
        lim = (-float(scale) * vmax, float(scale) * vmax)
    else:
        lim = (float(scale[0]), float(scale[1]))

    if ax is None:
        _, ax = plt.subplots(figsize=(12, 8))
    # a real time extent (matplotlib date floats), not sample counts
    t_lo, t_hi = (
        mdates.date2num(np.datetime64(times[0], "us").item()),
        mdates.date2num(np.datetime64(times[-1], "us").item()),
    )
    im = _raster(
        ax,
        data.T,
        extent=(t_lo, t_hi, float(dists[-1]), float(dists[0])),
        clim=lim,
        cmap=cmap,
    )
    ax.xaxis_date()
    ax.figure.autofmt_xdate()
    ax.set_xlabel("Time")
    ax.set_ylabel("Distance (m)")
    plt.colorbar(im, ax=ax).set_label("Amplitude")
    if show:
        plt.show()
    return ax
