"""Zero-phase band filtering: the FFT engine.

The port's counterpart of :mod:`tpudas.ops.filter`.  The reference's
``pass_filter`` is scipy's forward-backward IIR (``sosfiltfilt``); its
magnitude response is exactly ``|H(f)|^2`` with zero phase, so the
engine applies the squared Butterworth magnitude in the frequency
domain — ``rfft -> multiply -> irfft`` along the time axis (dim 0),
batched over channels — as the JAX package does.  The JAX package left
this to XLA (no Pallas kernel), so here it is plain ``torch.fft``
(cuFFT on the card) and tensor ops: there is no TPU kernel to replace.
Every length is padded to the JAX package's 5-smooth ``nfft``
(:func:`tpudas_torch.ops.fftlen.next_tpu_fft_len`) and the response is
computed in float32 as there, so both packages filter on the same grid.

Entry points take a torch tensor (its device is used) or a numpy array
(moved to ``device``, default the CUDA card).  The stacked fleet step
(:func:`fft_pass_filter_stream_stacked`) validates several streams'
blocks as one wave and runs each member's step at the member's own
width; the mesh path of the stream step is a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudas_torch.core import units as _units
from tpudas_torch.device import resolve_device
from tpudas_torch.ops.fftlen import next_tpu_fft_len

__all__ = [
    "patch_pass_filter",
    "fft_lowpass_response",
    "fft_pass_filter",
    "fft_stream_init",
    "fft_pass_filter_stream",
    "fft_pass_filter_stream_stacked",
]


def _as_tensor(data, device, dtype=None):
    """``data`` on its own device (a tensor) or moved to ``device``
    (numpy; default the CUDA card)."""
    if isinstance(data, torch.Tensor):
        if device is not None and torch.device(device).type != data.device.type:
            raise ValueError(f"data is on {data.device}, device={device!r}")
        t = data
    else:
        t = torch.from_numpy(np.ascontiguousarray(data)).to(resolve_device(device))
    return t if dtype is None else t.to(dtype)


def _f32(value, device):
    """A float32 scalar tensor: the JAX package rounds every traced
    parameter to float32 before it enters the arithmetic."""
    return torch.tensor(np.float32(value), device=device)


def _butter_mag2(freqs, low, high, order):
    """Squared Butterworth magnitude response (filtfilt-equivalent).

    ``low``/``high`` are the band edges in the units of ``freqs`` (low =
    high-pass corner, high = low-pass corner, as in
    ``pass_filter(time=(low, high))``), float32 tensors or None.
    """
    resp = torch.ones_like(freqs)
    if high is not None:
        resp = resp / (1.0 + (freqs / high) ** (2 * order))
    if low is not None:
        safe = torch.clamp_min(freqs, torch.finfo(freqs.dtype).tiny)
        resp = resp / (1.0 + (low / safe) ** (2 * order))
        resp = torch.where(freqs <= 0.0, torch.zeros_like(resp), resp)
    return resp


def _rfft_freqs(nfft, d_sec, device):
    """The rfft bin frequencies of ``nfft`` points at step ``d_sec``,
    in float32 as the JAX package computes them."""
    return torch.arange(nfft // 2 + 1, dtype=torch.float32, device=device) / (
        _f32(nfft, device) * _f32(d_sec, device)
    )


def _filter_rows(x, d_sec, low, high, order):
    """(T, C) float32 tensor filtered along dim 0 -> (T, C)."""
    n = x.shape[0]
    nfft = next_tpu_fft_len(n)
    dev = x.device
    spec = torch.fft.rfft(x, n=nfft, dim=0)
    resp = _butter_mag2(
        _rfft_freqs(nfft, d_sec, dev),
        None if low is None else _f32(low, dev),
        None if high is None else _f32(high, dev),
        int(order),
    )
    return torch.fft.irfft(spec * resp[:, None], n=nfft, dim=0)[:n]


def fft_pass_filter(data, d_sec, low=None, high=None, order=4, device=None):
    """The zero-phase band filter along dim 0 of a (T, C) or (T,) array;
    returns a float32 tensor of the same shape on the data's device."""
    x = _as_tensor(data, device, torch.float32)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    out = _filter_rows(x, d_sec, low, high, order)
    return out[:, 0] if squeeze else out


def fft_lowpass_response(nfft, d_sec, corner, order=4, device=None):
    """The rfft-domain low-pass response the window engine multiplies
    by (float32, ``nfft // 2 + 1`` bins), on ``device``."""
    dev = resolve_device(device)
    return _butter_mag2(
        _rfft_freqs(int(nfft), d_sec, dev), None, _f32(corner, dev), int(order)
    )


# ---------------------------------------------------------------------------
# streaming overlap-save: carry the filter's edge support across blocks
#
# The carry is the overlap-save state — the last ``2 * edge`` RAW input
# samples — so each input sample enters the FFT engine exactly once and
# the emitted region of every block is clean (full ``edge`` support on
# both sides, circular-wrap artifacts confined to the discarded halo) as
# long as ``edge`` covers the filter's impulse-response support.


def fft_stream_init(edge: int, n_ch: int) -> np.ndarray:
    """Zero carry for :func:`fft_pass_filter_stream`: the stream's last
    ``2 * edge`` input samples (zeros = silence before the stream)."""
    return np.zeros((2 * int(edge), int(n_ch)), np.float32)


def fft_pass_filter_stream(block, carry, d_sec, low=None, high=None,
                           order=4, qscale=None, device=None):
    """One streaming step of the zero-phase FFT band filter.

    block: (T, C) new input samples (a tensor, or numpy moved to
    ``device``); carry: (2*edge, C) from :func:`fft_stream_init` or a
    previous step (numpy or tensor; moved to the block's device).
    Returns ``(filtered, new_carry)``, fresh float32 tensors on the
    block's device: ``filtered[i]`` is the zero-phase filtered value of
    the stream ``edge`` samples BEHIND ``block[i]`` (an output needs its
    right-side support before it can be clean).  With a zero carry the
    first ``edge`` emitted samples read pre-stream silence; callers
    discard them as the batch path discards its stream-start edge.

    ``qscale`` takes a raw int16 block: it crosses to the device as
    int16 and is dequantized there (``block.float() * qscale``, float32
    scale), as the JAX step does; the carry stays float32."""
    from tpudas_torch.ops.fir import _check_quantized

    x = _as_tensor(block, device)
    dev = x.device
    _check_quantized(x, qscale)
    c = carry if isinstance(carry, torch.Tensor) else torch.from_numpy(
        np.asarray(carry))
    c = c.to(device=dev, dtype=torch.float32)
    if c.dim() != 2 or c.shape[0] % 2:
        raise ValueError(f"carry must be (2*edge, C), got {tuple(c.shape)}")
    if x.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(
            f"block {tuple(x.shape)} does not match carry {tuple(c.shape)}"
        )
    x = x.to(torch.float32)
    if qscale is not None:
        x = x * _f32(qscale, dev)
    T = int(x.shape[0])
    edge = int(c.shape[0]) // 2
    xc = torch.cat([c, x], dim=0)
    filt = _filter_rows(xc, d_sec, low, high, order)
    return filt[edge : edge + T].clone(), xc[xc.shape[0] - 2 * edge :].clone()


def fft_pass_filter_stream_stacked(blocks, carries, d_sec, low=None,
                                   high=None, order=4, qscale=None,
                                   device=None):
    """N streams' overlap-save FFT filter steps in one call, validated
    as one wave as the JAX package's stacked step is.  ``blocks`` share
    T and the filter parameters; each keeps its own channel width.
    Returns ``[(filtered_i, new_carry_i), ...]`` in member order: each
    is :func:`fft_pass_filter_stream` of that member alone.  An FFT
    over the packed width is not promised the member's bits (on the
    CPU a one-channel member at 2,048 points differs in the last bit),
    and packing would share only the elementwise dequantize, so no
    member is packed.  ``qscale`` is one scale shared by every
    member."""
    from tpudas_torch.ops.fir import _check_quantized

    blocks = [_as_tensor(b, device) for b in blocks]
    carries = list(carries)
    if not blocks or len(blocks) != len(carries):
        raise ValueError(
            f"blocks/carries length mismatch: {len(blocks)} vs "
            f"{len(carries)}"
        )
    T = int(blocks[0].shape[0])
    rows_carry = int(np.shape(carries[0])[0])
    if rows_carry % 2:
        raise ValueError(
            f"carry must be (2*edge, C), got {tuple(np.shape(carries[0]))}"
        )
    for i, (b, c) in enumerate(zip(blocks, carries)):
        if int(b.shape[0]) != T or int(np.shape(c)[0]) != rows_carry:
            raise ValueError(
                f"member {i} shapes {tuple(b.shape)}/"
                f"{tuple(np.shape(c))} do not match the wave's "
                f"T={T}, 2*edge={rows_carry}"
            )
        if b.dim() != 2 or int(b.shape[1]) != int(np.shape(c)[1]):
            raise ValueError(
                f"member {i} block {tuple(b.shape)} does not match "
                f"carry {tuple(np.shape(c))}"
            )
        _check_quantized(b, qscale)
    return [
        fft_pass_filter_stream(b, c, d_sec, low=low, high=high,
                               order=order, qscale=qscale)
        for b, c in zip(blocks, carries)
    ]


def _host_sosfiltfilt(data, d_sec, low, high, order):
    """Host reference engine: scipy Butterworth + sosfiltfilt (the
    reference's exact numerics)."""
    from scipy.signal import butter, sosfiltfilt

    nyq = 0.5 / d_sec
    if low is not None and high is not None:
        sos = butter(order, [low / nyq, high / nyq], btype="bandpass", output="sos")
    elif high is not None:
        sos = butter(order, high / nyq, btype="lowpass", output="sos")
    elif low is not None:
        sos = butter(order, low / nyq, btype="highpass", output="sos")
    else:
        return np.asarray(data, np.float64)
    return sosfiltfilt(sos, np.asarray(data, np.float64), axis=0)


def patch_pass_filter(patch, order=4, engine=None, device=None, **kwargs):
    """Patch-level ``pass_filter(time=(low, high))``.

    Exactly one named dimension must be given; band edges are in Hz for
    time (cycles per meter for distance).  ``None`` bounds are open.
    ``engine`` ``"numpy"``/``"scipy"``/``"host"`` runs scipy's
    ``sosfiltfilt`` on the host; anything else the FFT engine on
    ``device`` (default the CUDA card).  The result holds host data, as
    every port Patch does.
    """
    if len(kwargs) != 1:
        raise ValueError("pass_filter requires exactly one dim, e.g. time=(None, 5)")
    (dim, band), = kwargs.items()
    low, high = band
    low = _units.get_seconds(low) if low is not None else None
    high = _units.get_seconds(high) if high is not None else None
    ax = patch.axis_of(dim)
    d = patch.get_sample_step(dim)
    if d is None or d <= 0:
        raise ValueError(f"cannot infer sample step for dim {dim!r}")
    nyq = 0.5 / d
    for edge in (low, high):
        if edge is not None and not (0 < edge <= nyq):
            raise ValueError(
                f"filter corner {edge} Hz outside (0, Nyquist={nyq}]"
            )
    host = patch.host_data()
    if ax != 0:
        host = np.moveaxis(host, ax, 0)
    if engine in ("numpy", "scipy", "host"):
        out = _host_sosfiltfilt(host, d, low, high, order)
        out = out.astype(patch.host_data().dtype, copy=False)
    else:
        out = fft_pass_filter(host, d, low=low, high=high, order=order,
                              device=device).cpu().numpy()
    if ax != 0:
        out = np.moveaxis(out, 0, ax)
    return patch.new(data=out)
