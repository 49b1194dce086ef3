"""HBM read probes: CUDA kernels, wrappers and plain versions.

The port's counterparts of the TPU read probes, which measure the
device-memory read rate every kernel bound is held against:

- :func:`copy_heads` — P1, ``copy_kernel(rows, cb, k_fastest)``
  (tools/probe_pipeline.py:32): read every (rows, cb) tile of a (T, C)
  float32 array, write each tile's first ``rows/8`` rows,
  ``out[k*rows/8 + r] = x[k*rows + r]`` for ``r < rows/8``.
- :func:`copy_heads_pstream` — P2, ``copy_kernel_pstream(P, rows, cb)``
  (tools/probe_pipeline.py:70): the same heads over
  ``t_eff = (T // (rows*P)) * rows*P`` rows, with P tiles in flight.
- :func:`ring_reader` — P3, ``manual_reader(rows, nbuf)``
  (tools/probe_dma.py:45): read every (rows, C) chunk through an
  nbuf-slot ring; return ``sum_i sum_c x[i*rows, c]`` as (1, 1) float32.

Each wrapper checks the geometry the TPU kernel took implicitly (``rows``
a multiple of 8, ``cb`` dividing ``C``) and raises on anything else.  On
a CUDA tensor it launches the hand-written kernel in
``csrc/hbm_probe.cu`` (built with nvcc at first use, bound with ctypes)
or raises — there is no fallback.  On a CPU tensor, and only there, it
runs the plain version beside it (``*_plain``).  ``<wrapper>.launches``
counts the wrapper's launches on the card: one per call, which for
:func:`ring_reader` is a read kernel followed by a one-thread kernel
that reduces the per-block partial sums in a fixed order.  The kernels read every byte they credit into
shared memory through asynchronous bulk copies; the plain versions
compute the same function but read only what they return, so their
time is no read-rate yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from tpudas_torch.ops._build import KernelError

__all__ = [
    "copy_heads",
    "copy_heads_plain",
    "copy_heads_pstream",
    "copy_heads_pstream_plain",
    "heads_rows",
    "ring_reader",
    "ring_reader_plain",
]

_LIB_NAME = "hbm_probe"
_lib = None


def _kernel_lib():
    """The ctypes-bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        from tpudas_torch.ops._build import load_library

        lib = load_library(_LIB_NAME)
        lib.copy_heads_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ring_reader_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        for fn in (lib.copy_heads_f32, lib.ring_reader_f32):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_x(x, what):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} takes a torch tensor")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(
            f"{what}: x must be a (T, C) float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def heads_rows(T: int, rows: int, P: int = 1) -> int:
    """``t_eff``: the rows a head copy reads, whole groups of P tiles."""
    return (int(T) // (int(rows) * int(P))) * int(rows) * int(P)


def _check_heads(x, rows, cb, P, what):
    _check_x(x, what)
    C = x.shape[1]
    if rows < 8 or rows % 8:
        raise ValueError(f"{what}: rows must be a positive multiple of 8, got {rows}")
    if cb < 1 or C % cb:
        raise ValueError(f"{what}: cb={cb} does not divide C={C}")
    if P < 1:
        raise ValueError(f"{what}: P must be >= 1, got {P}")
    if x.device.type == "cuda" and (cb % 4 or C % 4 or x.data_ptr() % 16):
        # the kernel's bulk copies move 16-byte-aligned multiples of
        # 16 bytes
        raise ValueError(
            f"{what}: the CUDA kernel needs cb and C multiples of 4 and a "
            f"16-byte-aligned array (cb={cb}, C={C})"
        )


def copy_heads_pstream_plain(x, P: int, rows: int, cb: int):
    """Plain P2: the first rows/8 rows of every rows-tall tile of the
    first ``t_eff`` rows.  ``cb`` and ``P`` only shape the kernel's walk;
    the function does not depend on them."""
    t_eff = heads_rows(x.shape[0], rows, P)
    return x[:t_eff].view(-1, rows, x.shape[1])[:, : rows // 8].reshape(
        -1, x.shape[1]
    )


def copy_heads_plain(x, rows: int, cb: int, k_fastest: bool = False):
    """Plain P1 (the grid order does not change the function)."""
    return copy_heads_pstream_plain(x, 1, rows, cb)


def _launch_heads(x, P, rows, cb, k_fastest):
    T, C = x.shape
    out = torch.empty(
        (heads_rows(T, rows, P) // 8, C), dtype=torch.float32, device=x.device
    )
    if out.numel() == 0:
        return out, False
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.copy_heads_f32(
            x.data_ptr(), out.data_ptr(), T, C, rows, cb, P, int(k_fastest),
            stream,
        )
    if rc != 0:
        raise KernelError(
            f"copy_heads kernel launch failed: cudaError {rc} (x {tuple(x.shape)}, "
            f"rows={rows}, cb={cb}, P={P}, k_fastest={bool(k_fastest)})"
        )
    return out, True


def copy_heads(x, rows: int, cb: int, k_fastest: bool = False):
    """P1: (T, C) float32 -> (t_eff/8, C) heads, every tile read in
    full.  ``k_fastest`` makes consecutive blocks walk down the time
    axis instead of across the channels.  CUDA tensors run the kernel
    (or raise); CPU tensors run :func:`copy_heads_plain`."""
    rows, cb = int(rows), int(cb)
    _check_heads(x, rows, cb, 1, "copy_heads")
    if x.device.type == "cpu":
        return copy_heads_plain(x, rows, cb, k_fastest)
    out, launched = _launch_heads(x, 1, rows, cb, k_fastest)
    if launched:
        copy_heads.launches += 1
    return out


def copy_heads_pstream(x, P: int, rows: int, cb: int):
    """P2: the heads of every tile of the first ``t_eff`` rows, each
    block streaming P tiles at once (P copies in flight).  CUDA tensors
    run the kernel (or raise); CPU tensors run
    :func:`copy_heads_pstream_plain`."""
    P, rows, cb = int(P), int(rows), int(cb)
    _check_heads(x, rows, cb, P, "copy_heads_pstream")
    if x.device.type == "cpu":
        return copy_heads_pstream_plain(x, P, rows, cb)
    out, launched = _launch_heads(x, P, rows, cb, False)
    if launched:
        copy_heads_pstream.launches += 1
    return out


def ring_reader_plain(x, rows: int, nbuf: int = 2):
    """Plain P3: the float64 sum of row 0 of every whole rows-tall
    chunk, as a (1, 1) float32 tensor (``nbuf`` shapes only the
    kernel's ring)."""
    n = int(x.shape[0]) // int(rows)
    s = x[0 : n * rows : rows].sum(dtype=torch.float64)
    return s.to(torch.float32).reshape(1, 1)


def ring_reader(x, rows: int, nbuf: int):
    """P3: every (rows, C) chunk read through an nbuf-slot ring with
    nbuf - 1 copies in flight, on a persistent grid of one block per SM;
    returns the sum of each chunk's row 0 as a (1, 1) float32 tensor.
    CUDA tensors run the kernel (or raise), then a one-thread kernel
    that sums the per-block partials in a fixed order; the pair adds one
    to ``ring_reader.launches``.  CPU tensors run
    :func:`ring_reader_plain`."""
    rows, nbuf = int(rows), int(nbuf)
    _check_x(x, "ring_reader")
    if rows < 1:
        raise ValueError(f"ring_reader: rows must be >= 1, got {rows}")
    if nbuf < 1:
        raise ValueError(f"ring_reader: nbuf must be >= 1, got {nbuf}")
    if x.device.type == "cpu":
        return ring_reader_plain(x, rows, nbuf)
    T, C = x.shape
    if C % 4 or x.data_ptr() % 16:
        raise ValueError(
            f"ring_reader: the CUDA kernel needs C a multiple of 4 and a "
            f"16-byte-aligned array (C={C})"
        )
    lib = _kernel_lib()
    # one block per SM at most: the partial sums' length
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty(sms, dtype=torch.float64, device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ring_reader_f32(
            x.data_ptr(), partials.data_ptr(), out.data_ptr(), T, C, rows,
            nbuf, sms, stream,
        )
    if rc != 0:
        raise KernelError(
            f"ring_reader kernel launch failed: cudaError {rc} "
            f"(x {tuple(x.shape)}, rows={rows}, nbuf={nbuf})"
        )
    ring_reader.launches += 1
    return out


copy_heads.launches = 0
copy_heads_pstream.launches = 0
ring_reader.launches = 0
