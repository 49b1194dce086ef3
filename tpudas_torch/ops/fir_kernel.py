"""The strided (decimating) FIR stage: CUDA kernel, wrapper, plain version.

For a (T, C) window ``x`` and frame-blocked taps ``hb`` (B, R)::

    y[k, c] = sum_{b, r} hb[b, r] * x[(k + b) * R + r, c],   k < n_out

with rows at or past T reading as zero.  This is the port's counterpart
of the TPU kernel ``fir_decimate_pallas`` (tpudas/ops/pallas_fir.py:324;
its v1 form at :269 computes the same function): one stage of the
polyphase cascade in :mod:`tpudas_torch.ops.fir`.

- :func:`fir_decimate` is the wrapper.  On a CUDA tensor it launches
  the hand-written kernel in ``csrc/fir_decimate.cu`` (built with nvcc
  at first use, bound with ctypes) or raises — there is no fallback.
  On a CPU tensor, and only there, it runs :func:`fir_decimate_plain`.
  ``fir_decimate.launches`` counts kernel launches.
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

__all__ = ["fir_decimate", "fir_decimate_plain"]

_LIB_NAME = "fir_decimate"
_lib = None


def _kernel_lib():
    """The ctypes-bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        from tpudas_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        args = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        for fn in (lib.fir_decimate_f32, lib.fir_decimate_i16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def fir_decimate_plain(x, hb, R: int, n_out: int):
    """Plain PyTorch stage on any device: (T, C) -> (n_out, C) float32.

    The einsum contracts the tap phase ``r`` for every frame at once
    (``u[b, m] = <x frame m, hb[b]>``); the b-loop then sums the B
    shifted frame products in order — the formulation of
    ``_polyphase_stage_xla``.
    """
    B = hb.shape[0]
    need = (n_out + B) * R
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


def fir_decimate(x, hb, R: int, n_out: int):
    """One decimating FIR stage: x (T, C) float32 or int16, hb (B, R)
    float32 -> (n_out, C) float32.  CUDA tensors run the kernel (or
    raise); CPU tensors run :func:`fir_decimate_plain`."""
    R, n_out = int(R), int(n_out)
    _check(x, hb, R, n_out)
    if x.device.type == "cpu":
        return fir_decimate_plain(x, hb, R, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"fir_decimate runs on cuda or cpu, not {x.device}")
    T, C = x.shape
    y = torch.empty((n_out, C), dtype=torch.float32, device=x.device)
    if n_out == 0 or C == 0:
        return y
    lib = _kernel_lib()
    fn = lib.fir_decimate_i16 if x.dtype == torch.int16 else lib.fir_decimate_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), hb.data_ptr(), y.data_ptr(), T, C, R,
            hb.shape[0] * R, n_out, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fir_decimate kernel launch failed: cudaError {rc} "
            f"(x {tuple(x.shape)} {x.dtype}, taps {tuple(hb.shape)}, "
            f"R={R}, n_out={n_out})"
        )
    fir_decimate.launches += 1
    return y


fir_decimate.launches = 0
