"""The fused stateful cascade step: CUDA kernel, wrapper, plain version.

One stateful streaming step of the whole decimating cascade, from a
(T, C) block and the per-stage carry to the decimated output and the
new carry, with the same carry layout as the per-stage chain
(:func:`tpudas_torch.ops.fir.stream_carry_sizes`), so a stream may
cross between the two engines at any block.  This is the port's
counterpart of the TPU kernel ``fused_cascade_pallas``
(tpudas/ops/pallas_fir.py:576).

- :func:`fused_cascade` is the wrapper.  On a CUDA tensor it launches
  two hand-written kernels of ``csrc/fused_cascade.cu`` (built with nvcc
  at first use, bound with ctypes) on the caller's stream, or raises —
  there is no fallback, and a plan that does not fit a kernel's shared
  memory raises too: kernel A (:func:`fused_stage01`) runs stages 0 and
  1 in parallel over time tiles of ``K_1`` stage-1 outputs
  (:func:`stage1_tile`) and writes the intermediate ``u_2`` at
  1/(R_0 R_1) of the input rate; kernel B, the ring walk, runs the
  remaining stages on ``u_2``.  A plan of one or two stages is kernel A
  alone, writing ``y``.  On a CPU tensor, and only there, it runs
  :func:`fused_cascade_plain`.  ``fused_cascade.launches`` counts steps
  (one per call that launched), ``fused_cascade.kernel_launches`` the
  kernels launched.
- :func:`fused_cascade_one_kernel` is kernel B over the whole cascade
  (the single-kernel step the two kernels replace), kept so a
  measurement can time the two designs on one block.  The main path
  never calls it.
- :func:`fused_cascade_plain` is the plain PyTorch version: the chunked
  loop of the JAX package's ``fused-xla`` step (tpudas/ops/fir.py:989-1005)
  over :func:`tpudas_torch.ops.fir_kernel.fir_decimate_plain`, which
  replays the per-stage chain's arithmetic chunk by chunk.
- :func:`fused_cascade_split_plain` is the plain mirror of the two-kernel
  split: :func:`stage01_plain` walks kernel A's time tiles, halo and
  carry writes, then :func:`fused_cascade_plain` runs the remaining
  stages.  Tests hold it against :func:`fused_cascade_plain`, so the
  tiling's index arithmetic is checked on the CPU.

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

from tpudas_torch.ops._build import KernelError

__all__ = [
    "fused_cascade",
    "fused_cascade_one_kernel",
    "fused_cascade_plain",
    "fused_cascade_split_plain",
    "fused_stage01",
    "stage01_plain",
    "stage1_tile",
]

# kernel A's tile: about this many stage-0 outputs of its own, plus the
# stage-1 halo (K_1 = 50 stage-1 outputs, 274 stage-0 outputs at the
# flagship's R_1 = 5, L_1 = 29)
TILE_STAGE0_OUTPUTS = 250
SMEM_LIMIT = 232448  # bytes of opt-in shared memory per block (sm_90)
# stage 1 of a one-stage plan: the identity, so kernel A writes y
_IDENTITY = (1, np.ones(1, np.float32))

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
        args = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        for fn in (lib.stage01_f32, lib.stage01_i16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.stage01_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.stage01_smem_bytes.restype = ctypes.c_longlong
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


def stage1_tile(R1: int) -> int:
    """Kernel A's stage-1 outputs per time tile for stage-1 ratio
    ``R1``: its halo (L_1 - R_1 stage-0 outputs) is then at most about
    10% of a tile at the flagship."""
    return max(1, TILE_STAGE0_OUTPUTS // int(R1))


def _pair(stages, sizes):
    """Stages 0 and 1 of a plan as ((R0, h0, p0), (R1, h1, p1)); a
    one-stage plan gets the identity as stage 1."""
    R0, h0 = stages[0]
    if len(stages) == 1:
        R1, h1 = _IDENTITY
        p1 = 0
    else:
        (R1, h1), p1 = stages[1], sizes[1]
    return ((int(R0), np.asarray(h0, np.float32), int(sizes[0])),
            (int(R1), np.asarray(h1, np.float32), int(p1)))


def stage01_plain(x, carry, stages, sizes, qscale=None, k1=None):
    """Plain PyTorch version of kernel A: stages 0 and 1 of the plan
    (``stages``/``sizes``/``carry`` of one or two stages; one stage gets
    the identity as stage 1) -> ``(u, new_carry)``, ``u`` the
    T/(R_0 R_1) stage-1 outputs.  Walks kernel A's time tiles of ``k1``
    stage-1 outputs (default :func:`stage1_tile`): each tile computes
    the stage-0 outputs its z_1 rows hold, halo included (rows below p_1
    from carry_1), then its stage-1 outputs; the last tile's z_1 rows
    end with carry_1'."""
    from tpudas_torch.ops.fir import _block_taps
    from tpudas_torch.ops.fir_kernel import fir_decimate_plain

    if not 1 <= len(stages) <= 2:
        raise ValueError(f"stage01_plain takes 1 or 2 stages, got {len(stages)}")
    _check(x, carry, stages, sizes, qscale)
    dev = x.device
    if qscale is not None:
        x = x.to(torch.float32) * torch.tensor(np.float32(qscale), device=dev)
    else:
        x = x.to(torch.float32)
    (R0, h0, p0), (R1, h1, p1) = _pair(stages, sizes)
    L0, L1 = h0.size, h1.size
    if p1 != max(L1 - R1, 0) or p0 < max(L0 - R0, 0):
        raise ValueError("stage 1 must carry exactly its halo, stage 0 at "
                         "least its halo")
    hb0 = torch.from_numpy(_block_taps(h0, R0)).to(dev)
    hb1 = torch.from_numpy(_block_taps(h1, R1)).to(dev)
    T, C = x.shape
    n0 = T // R0
    n1 = n0 // R1
    z0 = torch.cat([carry[0], x], dim=0)
    c1 = carry[1] if len(stages) == 2 else x.new_zeros((0, C))
    if n1 == 0:
        return x.new_zeros((0, C)), (z0[T:].clone(), c1.clone())
    k1 = stage1_tile(R1) if k1 is None else int(k1)
    u = x.new_empty((n1, C))
    for m0 in range(0, n1, k1):
        m1 = min(m0 + k1, n1)
        r_lo, r_hi = m0 * R1, (m1 - 1) * R1 + L1  # the tile's z_1 rows
        k_lo, k_hi = max(r_lo - p1, 0), r_hi - p1  # its stage-0 outputs
        y0 = fir_decimate_plain(z0[k_lo * R0 : (k_hi - 1) * R0 + L0], hb0,
                                R0, k_hi - k_lo)
        z1 = torch.cat([c1[r_lo : min(r_hi, p1)], y0], dim=0)
        u[m0:m1] = fir_decimate_plain(z1, hb1, R1, m1 - m0)
    new1 = z1[n0 - r_lo : n0 - r_lo + p1].clone()
    new = (z0[T:].clone(), new1)
    return u, new[: len(stages)]


def fused_cascade_split_plain(x, carry, stages, sizes, qscale=None, k1=None):
    """The two-kernel split in plain PyTorch: :func:`stage01_plain` on
    stages 0-1, then :func:`fused_cascade_plain` on the rest ->
    ``(y, new_carry)``, equal to :func:`fused_cascade_plain`."""
    _check(x, carry, stages, sizes, qscale)
    u, new01 = stage01_plain(x, carry[:2], stages[:2], sizes[:2], qscale, k1)
    if len(stages) <= 2:
        return u, new01
    y, rest = fused_cascade_plain(u, carry[2:], stages[2:], sizes[2:])
    return y, new01 + rest


_DEVICE_TAPS: dict = {}


def _device_taps(taps, device):
    """Tap arrays concatenated, as one float32 tensor on ``device``,
    kept for the next step: a copy from pageable host memory waits for
    the stream, so a copy per launch would serialise host and card.
    The kernels only read it."""
    key = (tuple(np.asarray(h, np.float32).tobytes() for h in taps),
           str(device))
    t = _DEVICE_TAPS.get(key)
    if t is None:
        if len(_DEVICE_TAPS) >= 64:
            _DEVICE_TAPS.clear()
        host = np.concatenate([np.frombuffer(h, np.float32) for h in key[0]])
        t = _DEVICE_TAPS[key] = torch.from_numpy(host.copy()).to(device)
    return t


def _cuda_args(x, carry):
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels run on cuda, not {x.device}")
    if not (x.is_contiguous() and all(b.is_contiguous() for b in carry)):
        raise ValueError("x and the carry leaves must be contiguous")


def _raise_launch(what, rc, x, detail):
    raise KernelError(
        f"{what} launch failed: cudaError {rc} "
        f"(x {tuple(x.shape)} {x.dtype}, {detail})"
    )


def _refuse(stages, sizes, smem, which):
    R = [int(r) for r, _h in stages]
    L = [int(np.asarray(h).size) for _r, h in stages]
    raise ValueError(
        f"plan (R={R}, taps={L}, carry={list(map(int, sizes))}) does not "
        f"fit the fused {which} ({smem} bytes of shared memory; the limit "
        f"is {SMEM_LIMIT}, stage 0 takes at most 256 taps, and stages "
        "after the first must carry exactly taps - R rows)"
    )


def _walk_geometry(stages, sizes):
    """Kernel B's ctypes (R, L, p) arrays for ``stages``; raises when it
    does not take the plan."""
    S = len(stages)
    ints = ctypes.c_int * S
    R = ints(*(int(r) for r, _h in stages))
    L = ints(*(int(np.asarray(h).size) for _r, h in stages))
    p = ints(*(int(v) for v in sizes))
    smem = _kernel_lib().fused_cascade_smem_bytes(R, L, p, S)
    if not 0 <= smem <= SMEM_LIMIT:
        _refuse(stages, sizes, smem, "ring-walk kernel")
    return R, L, p


def _stage01_geometry(stages, sizes, k1=None):
    """Kernel A's (stage pair, K_1) for stages 0-1 (:func:`_pair`);
    raises when it does not take the pair."""
    pair = _pair(stages, sizes)
    (R0, h0, p0), (R1, h1, p1) = pair
    k1 = stage1_tile(R1) if k1 is None else int(k1)
    smem = _kernel_lib().stage01_smem_bytes(R0, h0.size, p0, R1, h1.size,
                                            p1, k1)
    if not 0 <= smem <= SMEM_LIMIT:
        _refuse(stages[:2], sizes[:2], smem, "stage-0/1 kernel")
    return pair, k1


def _launch_walk(x, y, carry, new, stages, geometry, qscale):
    """Kernel B (the ring walk) over ``stages``: x (T, C) -> y, new."""
    R, L, p = geometry
    lib = _kernel_lib()
    S = len(stages)
    T, C = x.shape
    taps = _device_taps([h for _r, h in stages], x.device)
    ptrs = ctypes.c_void_p * S
    cin = ptrs(*(b.data_ptr() if b.numel() else None for b in carry))
    cout = ptrs(*(b.data_ptr() if b.numel() else None for b in new))
    qs = float(np.float32(1.0 if qscale is None else qscale))
    fn = lib.fused_cascade_i16 if x.dtype == torch.int16 else lib.fused_cascade_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), cin, cout, taps.data_ptr(), R, L,
                p, S, T, C, qs, stream)
    if rc != 0:
        _raise_launch("fused ring-walk kernel", rc, x,
                      f"R={list(R)}, taps={list(L)}, carry={list(p)}")
    fused_cascade.kernel_launches += 1


def _launch_stage01(x, u, carry, new, geometry, qscale):
    """Kernel A over stages 0-1 (one stage: the identity as stage 1):
    x (T, C) -> u (T/(R0 R1), C), new carry leaves 0 (and 1)."""
    ((R0, h0, p0), (R1, h1, p1)), k1 = geometry
    lib = _kernel_lib()
    T, C = x.shape
    taps = _device_taps([h0, h1], x.device)

    def ptr(leaves, i):
        ok = len(leaves) > i and leaves[i].numel()
        return leaves[i].data_ptr() if ok else None

    qs = float(np.float32(1.0 if qscale is None else qscale))
    fn = lib.stage01_i16 if x.dtype == torch.int16 else lib.stage01_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), u.data_ptr(), ptr(carry, 0), ptr(carry, 1),
                ptr(new, 0), ptr(new, 1), taps.data_ptr(), R0, h0.size, p0,
                R1, h1.size, p1, k1, T, C, qs, stream)
    if rc != 0:
        _raise_launch("fused stage-0/1 kernel", rc, x,
                      f"R=({R0}, {R1}), taps=({h0.size}, {h1.size}), "
                      f"carry=({p0}, {p1}), K1={k1}")
    fused_cascade.kernel_launches += 1


def _outputs(x, stages, sizes):
    T, C = x.shape
    y = torch.empty((T // _ratio(stages), C), dtype=torch.float32,
                    device=x.device)
    new = tuple(
        torch.empty((int(p), C), dtype=torch.float32, device=x.device)
        for p in sizes
    )
    return y, new


def fused_stage01(x, carry, stages, sizes, qscale=None, k1=None):
    """Kernel A alone on a plan of one or two stages -> ``(u, new_carry)``
    (for a measurement of kernel A, ``k1`` stage-1 outputs a tile,
    default :func:`stage1_tile`; :func:`fused_cascade` calls its
    launcher).  CUDA tensors run the kernel (or raise); CPU tensors run
    :func:`stage01_plain`."""
    _check(x, carry, stages, sizes, qscale)
    if not 1 <= len(stages) <= 2:
        raise ValueError(f"fused_stage01 takes 1 or 2 stages, got {len(stages)}")
    if x.device.type == "cpu":
        return stage01_plain(x, carry, stages, sizes, qscale, k1)
    _cuda_args(x, carry)
    u, new = _outputs(x, stages, sizes)
    if x.shape[0] == 0 or x.shape[1] == 0:
        return u, tuple(b.clone() for b in carry)
    _launch_stage01(x, u, carry, new, _stage01_geometry(stages, sizes, k1),
                    qscale)
    return u, new


def fused_cascade_one_kernel(x, carry, stages, sizes, qscale=None):
    """The single-kernel step: kernel B over the whole cascade ->
    ``(y, new_carry)``.  Not on the main path; kept to time the design
    it replaced (and to run kernel B alone on ``u_2``).  CUDA tensors
    run the kernel (or raise); CPU tensors run
    :func:`fused_cascade_plain`."""
    _check(x, carry, stages, sizes, qscale)
    if x.device.type == "cpu":
        return fused_cascade_plain(x, carry, stages, sizes, qscale)
    _cuda_args(x, carry)
    y, new = _outputs(x, stages, sizes)
    if x.shape[1] == 0:
        return y, new
    _launch_walk(x, y, carry, new, stages, _walk_geometry(stages, sizes),
                 qscale)
    return y, new


def fused_cascade(x, carry, stages, sizes, qscale=None):
    """One fused stateful cascade step: x (T, C) float32 or int16 with
    ``qscale``, ``carry`` the per-stage (p_i, C) float32 leaves,
    ``stages`` the plan's ``(R, taps)`` pairs, ``sizes`` its
    :func:`~tpudas_torch.ops.fir.stream_carry_sizes` -> ``(y, new_carry)``
    with fresh tensors.  CUDA tensors run kernel A and, for three or
    more stages, kernel B on its output (or raise; both fit checks come
    before either launch); CPU tensors run :func:`fused_cascade_plain`."""
    _check(x, carry, stages, sizes, qscale)
    if x.device.type == "cpu":
        return fused_cascade_plain(x, carry, stages, sizes, qscale)
    _cuda_args(x, carry)
    # both fit checks before either launch: a plan is refused whole
    a_geom = _stage01_geometry(stages[:2], sizes[:2])
    b_geom = _walk_geometry(stages[2:], sizes[2:]) if len(stages) > 2 else None
    y, new = _outputs(x, stages, sizes)
    T, C = x.shape
    if C == 0:
        return y, new
    if T == 0:
        return y, tuple(b.clone() for b in carry)
    if b_geom is None:
        _launch_stage01(x, y, carry, new, a_geom, qscale)
    else:
        (R0, _h0, _p0), (R1, _h1, _p1) = a_geom[0]
        u = torch.empty((T // (R0 * R1), C), dtype=torch.float32,
                        device=x.device)
        _launch_stage01(x, u, carry[:2], new[:2], a_geom, qscale)
        _launch_walk(u, y, carry[2:], new[2:], stages[2:], b_geom, None)
    fused_cascade.launches += 1
    return y, new


fused_cascade.launches = 0
fused_cascade.kernel_launches = 0
