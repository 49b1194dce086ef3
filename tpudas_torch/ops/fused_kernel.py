"""The fused stateful cascade step: CUDA kernel, wrapper, plain version.

One stateful streaming step of the whole decimating cascade, from a
(T, C) block and the per-stage carry to the decimated output and the
new carry, with the same carry layout as the per-stage chain
(:func:`tpudas_torch.ops.fir.stream_carry_sizes`), so a stream may
cross between the two engines at any block.  This is the port's
counterpart of the TPU kernel ``fused_cascade_pallas``
(tpudas/ops/pallas_fir.py:576).

- :func:`fused_cascade` is the wrapper.  On a CUDA tensor it launches
  the hand-written kernel in ``csrc/fused_cascade.cu`` (built with nvcc
  at first use, bound with ctypes) or raises — there is no fallback,
  and a plan that does not fit the kernel's shared memory raises too.
  On a CPU tensor, and only there, it runs :func:`fused_cascade_plain`.
  ``fused_cascade.launches`` counts kernel launches.
- :func:`fused_cascade_plain` is the plain PyTorch version: the chunked
  loop of the JAX package's ``fused-xla`` step (tpudas/ops/fir.py:989-1005)
  over :func:`tpudas_torch.ops.fir_kernel.fir_decimate_plain`, which
  replays the per-stage chain's arithmetic chunk by chunk.

int16 blocks dequantize on read (``float(v) * qscale``, bit-equal to the
plain ``x.float() * qscale``): carry_0 holds dequantized float32 rows in
every engine, unlike the single stage's contract (B1 filters raw
integers and the caller scales the output).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["fused_cascade", "fused_cascade_plain"]

_LIB_NAME = "fused_cascade"
_lib = None


def _kernel_lib():
    """The ctypes-bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        from tpudas_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        args = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        for fn in (lib.fused_cascade_f32, lib.fused_cascade_i16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.fused_cascade_smem_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fused_cascade_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _ratio(stages) -> int:
    r = 1
    for R, _h in stages:
        r *= int(R)
    return r


def _check(x, carry, stages, sizes, qscale):
    if not isinstance(x, torch.Tensor):
        raise TypeError("fused_cascade takes a torch tensor block")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"x must be float32 or int16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (T, C), got shape {tuple(x.shape)}")
    if qscale is not None and x.dtype != torch.int16:
        raise ValueError(f"qscale given but data dtype is {x.dtype}")
    if not (len(carry) == len(stages) == len(sizes)):
        raise ValueError(
            f"{len(carry)} carry leaves, {len(stages)} stages, "
            f"{len(sizes)} carry sizes"
        )
    T, C = x.shape
    ratio = _ratio(stages)
    if T % ratio:
        raise ValueError(
            f"block length {T} is not a multiple of the ratio {ratio}"
        )
    for i, (b, p) in enumerate(zip(carry, sizes)):
        if not isinstance(b, torch.Tensor) or b.dtype != torch.float32:
            raise TypeError(f"carry leaf {i} must be a float32 tensor")
        if tuple(b.shape) != (int(p), C):
            raise ValueError(
                f"carry leaf {i} has shape {tuple(b.shape)}, want ({p}, {C})"
            )
        if b.device != x.device:
            raise ValueError(f"x on {x.device} but carry leaf {i} on {b.device}")


def fused_cascade_plain(x, carry, stages, sizes, qscale=None,
                        chunk_out=None):
    """Plain PyTorch fused step on any device: (T, C) float32 or int16
    block -> ``(y (T/ratio, C) float32, new_carry)``.

    The block is dequantized first, then walked in chunks of
    ``chunk_out`` final outputs (default: the largest divisor of the
    output count not above ``8192 // ratio``, or ``TPUDAS_FUSED_CHUNK``
    — :func:`tpudas_torch.ops.fir.fused_chunk_outputs`); every chunk
    threads every stage's carry through the per-stage arithmetic, so
    outputs and carry equal the per-stage chain's."""
    from tpudas_torch.ops.fir import _block_taps, _fused_chunk_for_ratio
    from tpudas_torch.ops.fir_kernel import fir_decimate_plain

    _check(x, carry, stages, sizes, qscale)
    dev = x.device
    if qscale is not None:
        x = x.to(torch.float32) * torch.tensor(np.float32(qscale), device=dev)
    else:
        x = x.to(torch.float32)
    ratio = _ratio(stages)
    T, C = x.shape
    n_out = T // ratio
    blocked = [
        (int(R),
         torch.from_numpy(_block_taps(np.asarray(h, np.float32), int(R))).to(dev))
        for R, h in stages
    ]
    bufs = tuple(carry)
    if n_out == 0:
        return x.new_zeros((0, C)), tuple(b.clone() for b in bufs)
    if chunk_out is None:
        chunk_out = _fused_chunk_for_ratio(ratio, n_out)
    chunk_in = int(chunk_out) * ratio
    outs = []
    for c0 in range(0, T, chunk_in):
        y = x[c0 : c0 + chunk_in]
        new = []
        for (R, hb), p, buf in zip(blocked, sizes, bufs):
            xi = torch.cat([buf, y], dim=0) if p else y
            k = y.shape[0] // R
            new.append(xi[xi.shape[0] - p :].clone())
            y = fir_decimate_plain(xi.contiguous(), hb, R, k)
        bufs = tuple(new)
        outs.append(y)
    return torch.cat(outs, dim=0), bufs


@functools.lru_cache(maxsize=32)
def _taps_host(key):
    return np.concatenate([np.frombuffer(h, np.float32) for _R, h in key])


def _device_taps(stages, device):
    key = tuple((int(R), np.asarray(h, np.float32).tobytes()) for R, h in stages)
    return torch.from_numpy(_taps_host(key).copy()).to(device)


def fused_cascade(x, carry, stages, sizes, qscale=None):
    """One fused stateful cascade step: x (T, C) float32 or int16 with
    ``qscale``, ``carry`` the per-stage (p_i, C) float32 leaves,
    ``stages`` the plan's ``(R, taps)`` pairs, ``sizes`` its
    :func:`~tpudas_torch.ops.fir.stream_carry_sizes` -> ``(y, new_carry)``
    with fresh tensors.  CUDA tensors run the kernel (or raise); CPU
    tensors run :func:`fused_cascade_plain`."""
    _check(x, carry, stages, sizes, qscale)
    if x.device.type == "cpu":
        return fused_cascade_plain(x, carry, stages, sizes, qscale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cascade runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and all(b.is_contiguous() for b in carry)):
        raise ValueError("x and the carry leaves must be contiguous")
    T, C = x.shape
    S = len(stages)
    dev = x.device
    y = torch.empty((T // _ratio(stages), C), dtype=torch.float32, device=dev)
    new = tuple(
        torch.empty((int(p), C), dtype=torch.float32, device=dev) for p in sizes
    )
    if C == 0:
        return y, new
    lib = _kernel_lib()
    ints = ctypes.c_int * S
    R = ints(*(int(r) for r, _h in stages))
    L = ints(*(int(np.asarray(h).size) for _r, h in stages))
    p = ints(*(int(v) for v in sizes))
    smem = lib.fused_cascade_smem_bytes(R, L, p, S)
    if smem < 0 or smem > 232448:
        raise ValueError(
            f"plan (R={list(R)}, taps={list(L)}, carry={list(p)}) does not "
            f"fit the fused kernel ({smem} bytes of shared memory; the "
            "limit is 232448, and stages after the first must carry "
            "exactly taps - R rows)"
        )
    taps = _device_taps(stages, dev)
    ptrs = ctypes.c_void_p * S
    cin = ptrs(*(b.data_ptr() if b.numel() else None for b in carry))
    cout = ptrs(*(b.data_ptr() if b.numel() else None for b in new))
    qs = float(np.float32(1.0 if qscale is None else qscale))
    fn = lib.fused_cascade_i16 if x.dtype == torch.int16 else lib.fused_cascade_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            x.data_ptr(), y.data_ptr(), cin, cout, taps.data_ptr(), R, L, p,
            S, T, C, qs, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_cascade kernel launch failed: cudaError {rc} "
            f"(x {tuple(x.shape)} {x.dtype}, R={list(R)}, taps={list(L)}, "
            f"carry={list(p)})"
        )
    fused_cascade.launches += 1
    return y, new


fused_cascade.launches = 0
