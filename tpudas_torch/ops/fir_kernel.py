"""The strided (decimating) FIR stage: CUDA kernel, wrapper, plain version.

For a (T, C) window ``x`` and frame-blocked taps ``hb`` (B, R)::

    y[k, c] = sum_{b, r} hb[b, r] * x[row0 + (k + b) * R + r, c],   k < n_out

with rows below 0 or at or past T reading as zero.  A negative first
row ``row0`` is the left pad that aligns a batch window with its phase
(:func:`tpudas_torch.ops.fir.shift_to_phase`), without a padded copy.
This is the port's counterpart of the TPU kernel
``fir_decimate_pallas`` (tpudas/ops/pallas_fir.py:324; its v1 form at
:269 computes the same function): one stage of the polyphase cascade
in :mod:`tpudas_torch.ops.fir`.

- :func:`fir_decimate` is the wrapper.  On a CUDA tensor it launches
  the hand-written kernel in ``csrc/fir_decimate.cu`` (built with nvcc
  at first use, bound with ctypes) or raises — there is no fallback.
  On a CPU tensor, and only there, it runs :func:`fir_decimate_plain`.
  ``fir_decimate.launches`` counts kernel launches.
- :func:`fir_decimate_tiled_plain` walks the kernel's tiling in plain
  PyTorch (stripes, tiles, tap chunks, order of sums), for the CPU
  tests.
- :func:`fir_decimate_plain` is the plain PyTorch version, a
  transcription of ``_polyphase_stage_xla`` (tpudas/ops/fir.py:340):
  one contraction over the tap phase for all frames, then a B-term
  shifted sum.  The CPU tests use it; on the card it is the reference
  the kernel is held against.

int16 input follows the TPU kernel's contract: the raw integers are
filtered (cast to float32 exactly) and the caller applies the
quantization scale to the (R-times smaller) output.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "chunk_frames", "copy_width", "fir_decimate", "fir_decimate_plain",
    "fir_decimate_tiled_plain",
]

_LIB_NAME = "fir_decimate"
_lib = None


def _kernel_lib():
    """The ctypes-bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        from tpudas_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        ptrs = [ctypes.c_void_p] * 3
        head = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # T, C, R
        tail = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        for fn in (lib.fir_decimate_f32, lib.fir_decimate_i16):
            # B, chunk frames, copy width
            fn.argtypes = ptrs + head + [ctypes.c_int] * 3 + tail
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# the kernel's tiling (csrc/fir_decimate.cu, namespace v2), which
# fir_decimate_tiled_plain walks on the CPU
TILE_OUTPUTS = 32  # outputs a time tile (v2::K)
ROW_BYTES = 128  # a staged row of a channel stripe: 64 int16 or 32 f32
SLOT_ROWS = 320  # rows a ring slot is sized for when taps are chunked
COPY_WIDTHS = (16, 8, 4, 2)


def chunk_frames(R: int, B: int) -> int:
    """Tap frames the kernel stages at once: all ``B`` when a slot of
    ``(TILE_OUTPUTS + B - 1) * R`` rows stays within ``SLOT_ROWS``,
    else as many as fit (at least one)."""
    return max(1, min(int(B), SLOT_ROWS // int(R) - TILE_OUTPUTS + 1))


def copy_width(x) -> int:
    """Bytes a staging copy moves: the widest of 16, 8, 4 that divides
    both the window's address and its row pitch, else one element
    (odd-width int16)."""
    pitch = x.shape[1] * x.element_size()
    ptr = x.data_ptr()
    for w in COPY_WIDTHS[:-1]:
        if pitch % w == 0 and ptr % w == 0:
            return w
    return x.element_size()


def _check(x, hb, R, n_out):
    if not isinstance(x, torch.Tensor) or not isinstance(hb, torch.Tensor):
        raise TypeError("fir_decimate takes torch tensors")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"x must be float32 or int16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, C), got shape {tuple(x.shape)}")
    if hb.dtype != torch.float32 or hb.dim() != 2 or hb.shape[1] != R:
        raise ValueError(
            f"taps must be float32 (B, R={R}), got {hb.dtype} "
            f"{tuple(hb.shape)}"
        )
    if R < 1 or n_out < 0:
        raise ValueError(f"need R >= 1 and n_out >= 0, got {R}, {n_out}")
    if hb.device != x.device:
        raise ValueError(
            f"x on {x.device} but taps on {hb.device}"
        )
    if not (x.is_contiguous() and hb.is_contiguous()):
        raise ValueError("x and taps must be contiguous")


def fir_decimate_plain(x, hb, R: int, n_out: int, row0: int = 0):
    """Plain PyTorch stage on any device: (T, C) -> (n_out, C) float32.

    ``row0`` drops leading rows or left-pads with zeros as
    :func:`~tpudas_torch.ops.fir.shift_to_phase` does, so the numbers
    are those of the stage on the shifted window.  The einsum contracts
    the tap phase ``r`` for every frame at once
    (``u[b, m] = <x frame m, hb[b]>``); the b-loop then sums the B
    shifted frame products in order — the formulation of
    ``_polyphase_stage_xla``.
    """
    B = hb.shape[0]
    need = (n_out + B) * R
    row0 = int(row0)
    if row0 < 0:
        x = torch.nn.functional.pad(x, (0, 0, -row0, 0))
    else:
        x = x[row0:]
    x = x.to(torch.float32)
    T = x.shape[0]
    if need > T:
        x = torch.nn.functional.pad(x, (0, 0, 0, need - T))
    xr = x[:need].reshape(n_out + B, R, x.shape[1])
    u = torch.einsum("mrc,br->bmc", xr, hb)
    y = torch.zeros((n_out, x.shape[1]), dtype=torch.float32, device=x.device)
    for b in range(B):
        y = y + u[b, b : b + n_out]
    return y


def _launch(what, fn, x, hb, R, n_out, row0, *geometry):
    """Run one kernel entry point of the library on CUDA tensors ->
    (n_out, C) float32; raises when the launcher refuses."""
    T, C = x.shape
    y = torch.empty((n_out, C), dtype=torch.float32, device=x.device)
    if n_out == 0 or C == 0:
        return y, False
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), hb.data_ptr(), y.data_ptr(), T, C, R,
                *geometry, n_out, row0, stream)
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {rc} "
            f"(x {tuple(x.shape)} {x.dtype}, taps {tuple(hb.shape)}, "
            f"R={R}, n_out={n_out}, row0={row0})"
        )
    return y, True


def fir_decimate(x, hb, R: int, n_out: int, row0: int = 0):
    """One decimating FIR stage: x (T, C) float32 or int16, hb (B, R)
    float32 -> (n_out, C) float32, the first output reading from row
    ``row0`` (negative rows read as zero).  CUDA tensors run the kernel
    (or raise); CPU tensors run :func:`fir_decimate_plain`.
    ``fir_decimate.launches`` counts launches, ``launches_by_width``
    the same launches by :func:`copy_width`."""
    R, n_out, row0 = int(R), int(n_out), int(row0)
    _check(x, hb, R, n_out)
    if x.device.type == "cpu":
        return fir_decimate_plain(x, hb, R, n_out, row0)
    if x.device.type != "cuda":
        raise ValueError(f"fir_decimate runs on cuda or cpu, not {x.device}")
    lib = _kernel_lib()
    fn = (lib.fir_decimate_i16 if x.dtype == torch.int16
          else lib.fir_decimate_f32)
    B = hb.shape[0]
    width = copy_width(x)
    y, ran = _launch("fir_decimate", fn, x, hb, R, n_out, row0, B,
                     chunk_frames(R, B), width)
    if ran:
        fir_decimate.launches += 1
        fir_decimate.launches_by_width[width] += 1
    return y


fir_decimate.launches = 0
fir_decimate.launches_by_width = dict.fromkeys(COPY_WIDTHS, 0)


def fir_decimate_tiled_plain(x, hb, R: int, n_out: int, row0: int = 0):
    """The kernel's tiling in plain PyTorch, for the CPU tests: the same
    function as :func:`fir_decimate_plain`, computed as the kernel
    computes it.  Each channel stripe of ``ROW_BYTES`` is staged one
    time tile of ``TILE_OUTPUTS`` outputs and one chunk of
    :func:`chunk_frames` tap frames at a time, rows outside ``[0, T)``
    as zero; each output sums, per chunk, tap phase by phase and frame
    by frame in fused multiply-adds (float64 product and sum, rounded
    to float32 once), and the chunk sums in order."""
    R, n_out, row0 = int(R), int(n_out), int(row0)
    T, C = x.shape
    B = hb.shape[0]
    K, bch = TILE_OUTPUTS, chunk_frames(R, B)
    tc = ROW_BYTES // x.element_size()
    tiles = -(-n_out // K)
    h = hb.reshape(-1).to(torch.float64)
    xf = x.to(torch.float32)
    y = torch.empty((n_out, C), dtype=torch.float32)
    for c0 in range(0, C, tc):
        xs = xf[:, c0 : c0 + tc]
        acc = None
        for b0 in range(0, B, bch):
            nb = min(bch, B - b0)
            g = (row0 + (torch.arange(tiles)[:, None] * K + b0) * R
                 + torch.arange((K + nb - 1) * R)[None, :])
            ok = ((g >= 0) & (g < T))[..., None]
            staged = torch.where(ok, xs[g.clamp(0, max(T - 1, 0))], 0.0)
            staged = staged.reshape(tiles, K + nb - 1, R, -1).double()
            part = torch.zeros((tiles, K, xs.shape[1]), dtype=torch.float32)
            for p in range(R):
                for b in range(nb):
                    fma = staged[:, b : b + K, p] * h[(b0 + b) * R + p]
                    part = (fma + part.double()).float()
            acc = part if acc is None else acc + part
        y[:, c0 : c0 + tc] = acc.reshape(tiles * K, -1)[:n_out]
    return y
