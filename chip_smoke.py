#!/usr/bin/env python3
"""On-card smoke run of tpudas_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # on a machine with one CUDA card

Drives the port's paths on the card at the north-star width of 10,000
channels over a synthetic int16 tdas spool (1 kHz -> 1 Hz): the batch
low-pass (``LFProc.process_time_range``), the real-time loop
(``run_lowpass_realtime``, stateful, carry saved and resumed), both on
the cascade and on the FFT engine, and the HBM read probes
(``python -m tpudas_torch.tools.probe_pipeline`` / ``probe_dma``); and
holds each hand-written CUDA kernel against its plain PyTorch version
at the shapes those paths give it.  Phases, each printing JSON lines:

1. environment (versions, card, power limit, optional packages);
2. build of ``tpudas_torch/csrc/*.cu`` with nvcc (sm_90a), one nvcc per
   source, all started together;
3c. (run first) the HBM read probes P1-P3 (``csrc/hbm_probe.cu``) vs
   their plain versions at 4,096 x 256 and at the tools' 129,024 x 2,048
   f32 (P1/P2 bit-equal, P3 within 1e-6 of the sum of |terms|); then
   the tools' sweeps through their entry points (every geometry of
   their lists, ``torch.sum`` and ``copy_`` beside them, CUDA events,
   resident windows) and the best P1 geometry on a 60,000 x 10,000 f32
   stream block; prints the achieved read rate, and every bound of
   phases 3 and 3b gets a second value at that rate
   (``bound_ms_measured``);
3. the strided-FIR kernel vs plain at the flagship stage shapes of a
   60 s window at 10,000 and 2,048 channels, float32 and int16, plus a
   ragged case, a long-tap case and all-zero input;
3b. the fused-cascade kernel vs plain on stream blocks of 60, 8 and 1
   outputs at 10,000 channels (int16, f32), 60 at 2,048, a ragged
   width, an uneven block sequence (outputs and every carry leaf), a
   NaN gap (the kernel's NaN set within the plain one's) and all-zero
   input; with the per-stage kernel chain and a ``conv1d`` chain timed
   beside it;
4. ``LFProc`` over 180 s x 10,000 channels: every window on the CUDA
   kernel, ``fir_decimate.launches == 4 x windows``, the output tiles
   the 1 Hz grid, the synthetic LF component is recovered within 0.01;
5. ``run_lowpass_realtime`` over the same spool: engine="fused" over
   files 1-2, then a second call that resumes from the saved carry over
   file 3; every block launches the fused kernel; an engine="auto"
   control (per-stage kernel on every stage, 4 launches a block) gives
   the same names and data within 1e-5; the stream equals phase 4's
   batch output within 1e-4 on the common interior;
6. the FFT engine over the same spool: ``LFProc(engine="fft")`` (4
   windows, all "fft", no FIR launch, the 1 Hz grid, LF recovery);
   ``engine="auto"`` on a 1.1 s grid (ratio 1100 = 2^2 5^2 11: every
   window routes to the FFT engine); ``run_lowpass_realtime(engine=
   "fft")`` over files 1-2, then resumed over file 3 from its "fft"
   carry, equal to the FFT batch output within 1e-4 on the interior.

Per-channel relative errors are held to 1e-5 (same f32 products, other
order) and zeros must be exact; times come from CUDA events, each with
its bound.  Then the kernel summary line, the card's name and power
limit, and the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero.  Without a CUDA card it exits 2
before any phase.  ``--rehearse`` runs the same phases on the CPU at a
64-channel width with the plain versions (no kernel, no timings worth
reading) and exits 3: a dry run of the control flow, never a result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32, non-tensor (NVIDIA data sheet)
REL_TOL = 1e-5
LF_FREQ = 0.05
NOISE = 0.02
QSCALE = 1e-4
T0 = "2023-03-22T00:00:00"
# main-path duration: 3 files x 60 s, 4 overlap-save windows at
# process_patch_size=60 / edge_buff_size=10 (cut from an archive's
# hours in duration only; the width stays 10,000 channels)
MAIN_PATH_SECONDS = 180.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Timer:
    """Milliseconds per call: CUDA events on the card, the host clock
    in a CPU rehearsal."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, fn, reps):
        fn()  # warm-up
        self.sync()
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def reps_for(self, fn, budget_ms=150.0):
        once = self(fn, 1)
        return int(min(50, max(3, math.ceil(budget_ms / max(once, 1e-3)))))


def per_channel_rel(got, ref):
    """max over channels of max_t|got-ref| / max_t|ref| (channels on
    axis 1), with near-silent channels floored at 1e-7 of the loudest."""
    err = (got - ref).abs().amax(dim=0)
    scale = ref.abs().amax(dim=0)
    floor = max(float(scale.max()) * 1e-7, 1e-30)
    return float((err / scale.clamp_min(floor)).max()), float(err.max())


# the best HBM read rate phase 3c achieved on this card (bytes/s); the
# bounds of phases 3 and 3b get a second value at this rate
MEASURED = {"read_bytes_per_s": None}


def bound_at_measured(by, ops):
    """The bound at the measured read rate (None before phase 3c)."""
    rate = MEASURED["read_bytes_per_s"]
    if not rate:
        return None
    return max(by / rate, ops / F32_FLOPS_PER_S) * 1e3


def stage_bound_ms(T, C, in_bytes, n_out, taps):
    by = T * C * in_bytes + n_out * C * 4
    ops = 2.0 * taps * n_out * C
    t_b, t_o = by / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return (max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"),
            bound_at_measured(by, ops))


def synthetic_window(T, C, device, seed, quantized):
    """(T, C) window of the synthetic stream, made on ``device``:
    channel-ramped 0.05 Hz sine + 25 Hz sine + noise (int16 at
    QSCALE when ``quantized``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(T, device=device, dtype=torch.float64) / 1000.0
    d = torch.arange(C, device=device, dtype=torch.float64)
    amp = 1.0 + d / (d.max() + 1.0)
    x = (torch.sin(2 * math.pi * LF_FREQ * t)[:, None] * amp[None, :]
         + 0.5 * torch.sin(2 * math.pi * 25.0 * t)[:, None]).float()
    x += NOISE * torch.randn(T, C, device=device, generator=g)
    if quantized:
        return torch.round(x / QSCALE).clamp_(-32768, 32767).to(torch.int16)
    return x


def compare_stage(timer, x, hb, R, k, taps, label, with_time=True):
    """Kernel vs plain on one stage input; returns the case record."""
    from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain

    got = fir_decimate(x, hb, R, k)
    ref = fir_decimate_plain(x, hb, R, k)
    timer.sync()
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: kernel output not finite")
    rel, abs_err = per_channel_rel(got, ref)
    T, C = x.shape
    bound, bound_by, bound_m = stage_bound_ms(T, C, x.element_size(), k, taps)
    rec = {"case": label, "T": T, "C": C, "dtype": str(x.dtype).split(".")[-1],
           "R": R, "taps": taps, "n_out": k, "max_rel_err": rel,
           "max_abs_err": abs_err, "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_measured": bound_m}
    if with_time:
        h = hb.reshape(-1)[None, None, :]

        def lib():
            xt = x.t().to(torch.float32)[:, None, :]
            return torch.nn.functional.conv1d(xt, h, stride=R)

        lib_out = lib()[:, 0, :].t()
        n = min(lib_out.shape[0], k)
        rec["library_max_abs_err"] = float(
            (lib_out[:n] - ref[:n]).abs().max()
        )
        kern = lambda: fir_decimate(x, hb, R, k)  # noqa: E731
        plain = lambda: fir_decimate_plain(x, hb, R, k)  # noqa: E731
        rk, rp, rl = (timer.reps_for(f) for f in (kern, plain, lib))
        # turns: plain, kernel, library, library, kernel, plain
        p1, k1, l1 = timer(plain, rp), timer(kern, rk), timer(lib, rl)
        l2, k2, p2 = timer(lib, rl), timer(kern, rk), timer(plain, rp)
        rec.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   library_ms=(l1 + l2) / 2, ms_turns=[k1, k2],
                   plain_ms_turns=[p1, p2], library_ms_turns=[l1, l2])
    if rel > REL_TOL:
        emit(rec)
        fail(f"{label}: kernel vs plain per-channel rel err {rel:.3e} > "
             f"{REL_TOL:g}")
    return rec


def phase_kernels(device, widths, timer):
    from tpudas_torch.ops.fir import (
        blocked_taps, chain_layout, design_cascade, shift_to_phase,
    )
    from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain
    from tpudas_torch.proc.lfproc import output_corner

    plan = design_cascade(1000.0, 1000, output_corner(1.0))
    taps = [len(h) for _, h in plan.stages]
    stages = blocked_taps(plan, device)
    # one 60 s LFProc window of the flagship schedule
    # (process_patch_size=60, edge_buff_size=10): 60,001 rows, emit
    # phase 10 s, 40 outputs
    T, phase, n_out = 60001, 10000, 40
    layout, _rows = chain_layout(plan, n_out, "torch", "cpu")
    main = {}
    for C in widths:
        for quantized in (True, False):
            x = synthetic_window(T, C, device, seed=C, quantized=quantized)
            cur = shift_to_phase(x, phase, plan.delay).contiguous()
            del x
            recs = []
            for i, ((R, hb), (_e, k)) in enumerate(zip(stages, layout)):
                label = (f"flagship stage {i} "
                         f"{'int16' if cur.dtype == torch.int16 else 'f32'}"
                         f" {C}ch")
                recs.append(compare_stage(timer, cur, hb, R, k, taps[i], label))
                emit(recs[-1])
                nxt = fir_decimate_plain(cur, hb, R, k)
                if cur.dtype == torch.int16:
                    nxt = nxt * QSCALE
                cur = nxt.contiguous()
            main[(C, quantized)] = recs
            del cur
            if device.type == "cuda":
                torch.cuda.empty_cache()
    # ragged: C not a multiple of 32, T short of (n_out + B) * R
    R, hb = stages[0]
    k = 1001
    T_short = (k + hb.shape[0]) * R - 37
    for quantized in (False, True):
        x = synthetic_window(T_short, 1000, device, seed=7, quantized=quantized)
        emit(compare_stage(timer, x, hb, R, k, taps[0],
                           f"ragged C=1000 T=need-37 "
                           f"{'int16' if quantized else 'f32'}",
                           with_time=False))
    # the longest stage the design can produce: 4095 taps (several
    # shared-memory tap chunks)
    g = torch.Generator(device=device).manual_seed(11)
    h_long = torch.randn(819, 5, device=device, generator=g) / 819.0
    x = synthetic_window((300 + 819) * 5, 333, device, seed=12, quantized=False)
    emit(compare_stage(timer, x, h_long.contiguous(), 5, 300, 4095,
                       "long taps L=4095 R=5 C=333", with_time=False))
    # all-zero input must give exact zeros
    for dt in (torch.float32, torch.int16):
        z = torch.zeros((20000, 777), dtype=dt, device=device)
        out = fir_decimate(z, hb, R, 2400)
        timer.sync()
        nz = int(torch.count_nonzero(out))
        emit({"case": f"zeros {str(dt).split('.')[-1]}", "nonzero": nz})
        if nz:
            fail(f"all-zero {dt} input gave {nz} nonzero outputs")
    return plan, main


def cascade_bound_ms(plan, T, C, in_bytes):
    """Least time for one fused step: the block read once, the output
    and the new carry written once, the old carry read once; flops over
    the true taps of every stage."""
    from tpudas_torch.ops.fir import stream_carry_sizes

    n_out = T // plan.ratio
    carry = sum(stream_carry_sizes(plan))
    by = T * C * in_bytes + n_out * C * 4 + 2 * carry * C * 4
    flops, rows = 0.0, T
    for R, h in plan.stages:
        rows //= int(R)
        flops += 2.0 * len(h) * rows * C
    t_b, t_o = by / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"),
            bound_at_measured(by, flops))


def warm_blocks(plan, n_list, C, device, seed, quantized, warm=30):
    """Consecutive blocks of ``n_list`` outputs of one synthetic stream,
    and the carry a plain step leaves after ``warm`` outputs of it: the
    state a running stream holds (every carry leaf nonzero)."""
    from tpudas_torch.ops.fir import cascade_stream_init, stream_carry_sizes
    from tpudas_torch.ops.fused_kernel import fused_cascade_plain

    rows = [n * plan.ratio for n in (warm, *n_list)]
    x = synthetic_window(sum(rows), C, device, seed, quantized)
    parts = list(torch.split(x, rows))
    qs = QSCALE if quantized else None
    _y, carry = fused_cascade_plain(
        parts[0].contiguous(), cascade_stream_init(plan, C, device),
        plan.stages, stream_carry_sizes(plan), qscale=qs)
    return [b.contiguous() for b in parts[1:]], carry


def conv1d_chain(plan, x, carry, qscale):
    """The yardstick the port never calls: the cascade as one
    ``conv1d`` per stage over the carry-extended input."""
    u = x.to(torch.float32)
    if qscale is not None:
        u = u * qscale
    for (R, h), buf in zip(plan.stages, carry):
        k = u.shape[0] // int(R)
        z = torch.cat([buf, u], dim=0).t()[:, None, :]
        w = torch.from_numpy(np.asarray(h, np.float32)).to(x.device)
        u = torch.nn.functional.conv1d(z, w[None, None, :],
                                       stride=int(R))[:, 0, :k].t()
    return u


def compare_fused(timer, plan, blocks, carry, qscale, label,
                  with_time=True):
    """B3 vs its plain version over consecutive blocks from one carry:
    the outputs (stacked per channel) and every final carry leaf
    per-channel within REL_TOL.  Timed on the first block: the kernel,
    the plain version, the per-stage B1 chain and the conv1d chain."""
    from tpudas_torch.ops.fir import cascade_decimate_stream, stream_carry_sizes
    from tpudas_torch.ops.fused_kernel import fused_cascade, fused_cascade_plain

    sizes = stream_carry_sizes(plan)
    ck = cp = carry
    ys, rys = [], []
    for x in blocks:
        y, ck = fused_cascade(x, ck, plan.stages, sizes, qscale=qscale)
        ry, cp = fused_cascade_plain(x, cp, plan.stages, sizes, qscale=qscale)
        ys.append(y)
        rys.append(ry)
    y, ry = torch.cat(ys), torch.cat(rys)
    timer.sync()
    if not bool(torch.isfinite(y).all()):
        fail(f"{label}: fused kernel output not finite")
    rel, abs_err = per_channel_rel(y, ry)
    leaf_rel = [per_channel_rel(a, b)[0] for a, b in zip(ck, cp) if a.numel()]
    x = blocks[0]
    T, C = x.shape
    bound, bound_by, bound_m = cascade_bound_ms(plan, T, C, x.element_size())
    rec = {"case": label, "T": T, "C": C, "blocks": len(blocks),
           "n_out": T // plan.ratio, "dtype": str(x.dtype).split(".")[-1],
           "max_rel_err": rel, "max_abs_err": abs_err,
           "carry_max_rel_err": max(leaf_rel), "bound_ms": bound,
           "bound_by": bound_by, "bound_ms_measured": bound_m}
    if with_time:
        kern = lambda: fused_cascade(x, carry, plan.stages, sizes,  # noqa: E731
                                     qscale=qscale)
        plain = lambda: fused_cascade_plain(x, carry, plan.stages,  # noqa: E731
                                            sizes, qscale=qscale)
        chain = lambda: cascade_decimate_stream(x, carry, plan,  # noqa: E731
                                                "auto", qscale=qscale)
        conv = lambda: conv1d_chain(plan, x, carry, qscale)  # noqa: E731
        rec["conv1d_chain_max_abs_err"] = float((conv() - rys[0]).abs().max())
        fns = (kern, plain, chain, conv)
        reps = [timer.reps_for(f) for f in fns]
        # turns: kernel, plain, chain, conv, conv, chain, plain, kernel
        first = [timer(f, r) for f, r in zip(fns, reps)]
        second = [timer(f, r) for f, r in zip(fns[::-1], reps[::-1])][::-1]
        keys = ("ms", "plain_ms", "b1_chain_ms", "conv1d_chain_ms")
        for key, a, b in zip(keys, first, second):
            rec[key] = (a + b) / 2
            rec[key + "_turns"] = [a, b]
    if rel > REL_TOL or max(leaf_rel) > REL_TOL:
        emit(rec)
        fail(f"{label}: fused kernel vs plain per-channel rel err "
             f"{max(rel, *leaf_rel):.3e} > {REL_TOL:g}")
    return rec


def phase_fused_kernel(device, widths, timer):
    """Phase 3b: B3 (csrc/fused_cascade.cu) against fused_cascade_plain
    at the flagship stream blocks, a narrower width, a ragged width, an
    uneven block sequence, a NaN gap and all-zero input."""
    from tpudas_torch.ops.fir import (
        cascade_stream_init, design_cascade, stream_carry_sizes,
    )
    from tpudas_torch.ops.fused_kernel import fused_cascade, fused_cascade_plain
    from tpudas_torch.proc.lfproc import output_corner

    plan = design_cascade(1000.0, 1000, output_corner(1.0))
    ratio, sizes = plan.ratio, stream_carry_sizes(plan)
    main = {}
    for C in widths:
        for quantized in (True, False):
            # a 1-output block is compared over 20 consecutive blocks,
            # so every channel has a series to scale its error by
            cases = ((60, [60]), (8, [8]), (1, [1] * 20))
            for n, n_list in (cases if C == widths[0] else cases[:1]):
                blocks, carry = warm_blocks(plan, n_list, C, device,
                                            seed=n + C, quantized=quantized)
                label = (f"fused {n} out {'int16' if quantized else 'f32'} "
                         f"{C}ch")
                rec = compare_fused(timer, plan, blocks, carry,
                                    QSCALE if quantized else None, label)
                emit(rec)
                main[(C, quantized, n)] = rec
                del blocks, carry
    # ragged: C not a multiple of 32
    blocks, carry = warm_blocks(plan, [8, 8], 1000, device, seed=3,
                                quantized=False)
    emit(compare_fused(timer, plan, blocks, carry, None,
                       "fused ragged C=1000 f32", with_time=False))
    # an uneven block sequence through both, carried from zeros:
    # outputs and every carry leaf
    C = 1000
    carry_k = carry_p = cascade_stream_init(plan, C, device)
    ys_k, ys_p = [], []
    for i, n in enumerate((50, 13, 1, 27, 40)):
        x = synthetic_window(n * ratio, C, device, seed=20 + i,
                             quantized=True)
        y, carry_k = fused_cascade(x, carry_k, plan.stages, sizes, QSCALE)
        yp, carry_p = fused_cascade_plain(x, carry_p, plan.stages, sizes,
                                          QSCALE)
        ys_k.append(y)
        ys_p.append(yp)
    timer.sync()
    rel = per_channel_rel(torch.cat(ys_k), torch.cat(ys_p))[0]
    leaf = [per_channel_rel(a, b)[0] for a, b in zip(carry_k, carry_p)]
    emit({"case": "fused block sequence (50,13,1,27,40) int16 1000ch",
          "max_rel_err": rel, "carry_max_rel_err": leaf})
    if max(rel, *leaf) > REL_TOL:
        fail(f"block sequence: rel err {max(rel, *leaf):.3e} > {REL_TOL:g}")
    # NaN gap: the kernel's NaN set is a subset of the plain version's
    (x,), carry = warm_blocks(plan, [40], C, device, seed=31,
                              quantized=False)
    x[ratio : 2 * ratio, 2] = float("nan")
    x[-ratio // 2 :, 0] = float("nan")
    y, nc = fused_cascade(x, carry, plan.stages, sizes)
    yp, ncp = fused_cascade_plain(x, carry, plan.stages, sizes)
    timer.sync()
    nan_k, nan_p = torch.isnan(y), torch.isnan(yp)
    both = ~nan_k & ~nan_p
    scale = float(yp[both].abs().max())
    err = float((y[both] - yp[both]).abs().max()) / scale
    rec = {"case": "fused NaN gap f32 1000ch", "nan_kernel": int(nan_k.sum()),
           "nan_plain": int(nan_p.sum()), "finite_max_rel_err": err}
    emit(rec)
    if not bool(nan_p.any()) or bool((nan_k & ~nan_p).any()):
        fail("NaN gap: the kernel's NaN set is not a subset of the plain "
             "version's")
    if err > REL_TOL:
        fail(f"NaN gap: finite samples differ by {err:.3e}")
    # all-zero input and carry give exact zeros
    for dt in (torch.float32, torch.int16):
        z = torch.zeros((20 * ratio, 777), dtype=dt, device=device)
        y, nc = fused_cascade(z, cascade_stream_init(plan, 777, device),
                              plan.stages, sizes,
                              QSCALE if dt == torch.int16 else None)
        timer.sync()
        nz = int(torch.count_nonzero(y)) + sum(
            int(torch.count_nonzero(b)) for b in nc)
        emit({"case": f"fused zeros {str(dt).split('.')[-1]}", "nonzero": nz})
        if nz:
            fail(f"all-zero {dt} block gave {nz} nonzero values")
    return main


PROBE_T, PROBE_C = 129024, 2048  # the tools' size: 1.057 GB f32
STREAM_SHAPE = (60000, 10000)  # one 60 s stream block at 10,000 ch (2.4 GB)
# the small check: T = 4,096 x C = 256 and geometries that fit it
SMALL_P1 = ((256, 64, False), (256, 64, True), (512, 128, False),
            (128, 256, True))
SMALL_P2 = ((1, 512, 64), (2, 512, 64), (3, 512, 64), (4, 256, 128))
SMALL_P3 = ((256, 4), (128, 8), (512, 2))


def check_probes(device, T, C, p1, p2, p3, seed):
    """Each probe kernel against its plain version on one seeded (T, C)
    window: P1/P2 bit-equal, P3 within 1e-6 of the sum of |terms|.
    Returns the largest absolute error of each probe."""
    from tpudas_torch.ops.hbm_probe import (
        copy_heads, copy_heads_plain, copy_heads_pstream,
        copy_heads_pstream_plain, ring_reader, ring_reader_plain,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((T, C), generator=g, device=device)
    err = {"copy_heads": 0.0, "copy_heads_pstream": 0.0, "ring_reader": 0.0}
    for rows, cb, kf in p1:
        got, ref = copy_heads(x, rows, cb, kf), copy_heads_plain(x, rows, cb, kf)
        err["copy_heads"] = max(err["copy_heads"],
                                float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            fail(f"P1 rows={rows} cb={cb} k_fastest={kf} at {T}x{C}: kernel "
                 "is not bit-equal to plain")
    for P, rows, cb in p2:
        got = copy_heads_pstream(x, P, rows, cb)
        ref = copy_heads_pstream_plain(x, P, rows, cb)
        err["copy_heads_pstream"] = max(err["copy_heads_pstream"],
                                        float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            fail(f"P2 P={P} rows={rows} cb={cb} at {T}x{C}: kernel is not "
                 "bit-equal to plain")
    for rows, nbuf in p3:
        got = float(ring_reader(x, rows, nbuf))
        ref = float(ring_reader_plain(x, rows, nbuf))
        n = T // rows
        terms = float(x[0 : n * rows : rows].abs().sum(dtype=torch.float64))
        err["ring_reader"] = max(err["ring_reader"], abs(got - ref))
        if abs(got - ref) > 1e-6 * terms:
            fail(f"P3 rows={rows} nbuf={nbuf} at {T}x{C}: |{got} - {ref}| > "
                 f"1e-6 x {terms}")
    return err


def nearest_divisor(C, want):
    """The divisor of C that is a multiple of 4 and closest to ``want``
    (a stream block's 10,000 channels are not a multiple of 2,048)."""
    divs = [d for d in range(4, C + 1, 4) if C % d == 0]
    return min(divs, key=lambda d: (abs(d - want), -d))


def phase_hbm_probe(device, rehearse):
    """Phase 3c: the HBM read probes.  Returns the kernel entries of
    P1-P3 for the kernels line; sets ``MEASURED``."""
    from tpudas_torch.ops.hbm_probe import (
        copy_heads, copy_heads_plain, copy_heads_pstream,
        copy_heads_pstream_plain, ring_reader, ring_reader_plain,
    )
    from tpudas_torch.tools import probe_dma, probe_pipeline
    from tpudas_torch.tools.harness import measure
    from tpudas_torch.tools.probe_pipeline import card_line

    T, C = (8192, PROBE_C) if rehearse else (PROBE_T, PROBE_C)
    iters = 6 if rehearse else 96
    dev_arg = "cpu" if rehearse else None
    t0 = time.perf_counter()
    check_probes(device, 4096, 256, SMALL_P1, SMALL_P2, SMALL_P3, seed=1)
    err = check_probes(device, T, C, probe_pipeline.P1_GEOMETRIES,
                       probe_pipeline.P2_GEOMETRIES, probe_dma.P3_GEOMETRIES,
                       seed=2)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    # the probe path: the tools' entry points, counts from 0
    copy_heads.launches = copy_heads_pstream.launches = 0
    ring_reader.launches = 0
    argv = ["--T", str(T), "--C", str(C), "--iters", str(iters)]
    if rehearse:
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    recs = probe_pipeline.main(argv) + probe_dma.main(argv)
    sweep_s = time.perf_counter() - t0
    launches = {"copy_heads": copy_heads.launches,
                "copy_heads_pstream": copy_heads_pstream.launches,
                "ring_reader": ring_reader.launches}
    by = {k: [r for r in recs if r["probe"] == k]
          for k in ("P1", "P2", "P3", "torch.sum", "copy_")}
    best = {k: max(v, key=lambda r: r["read_bytes_per_s"])
            for k, v in by.items() if k in ("P1", "P2", "P3")}
    lib_sum, lib_copy = by["torch.sum"][0], by["copy_"][0]
    rate_from = max([*best.values(), lib_sum],
                    key=lambda r: r["read_bytes_per_s"])
    rate = rate_from["read_bytes_per_s"]
    # plain versions at each probe's best geometry (not counted)
    b1, b2, b3 = best["P1"], best["P2"], best["P3"]
    plain = {
        "P1": measure(lambda x: copy_heads_plain(x, b1["rows"], b1["cb"],
                                                 b1["k_fastest"]),
                      T, C, iters, device=dev_arg) * 1e3,
        "P2": measure(lambda x: copy_heads_pstream_plain(x, b2["P"], b2["rows"],
                                                         b2["cb"]),
                      T, C, iters, device=dev_arg) * 1e3,
        "P3": measure(lambda x: ring_reader_plain(x, b3["rows"], b3["nbuf"]),
                      T, C, iters, device=dev_arg) * 1e3,
    }
    # the best P1 geometry on a stream block's shape (cb adjusted to
    # divide its channels), beside torch.sum on the same array
    sT, sC = (4000, 1000) if rehearse else STREAM_SHAPE
    s_cb = nearest_divisor(sC, b1["cb"])
    s_ms = measure(lambda x: copy_heads(x, b1["rows"], s_cb, b1["k_fastest"]),
                   sT, sC, iters, device=dev_arg) * 1e3
    s_sum = measure(torch.sum, sT, sC, iters, device=dev_arg) * 1e3
    s_read = (sT // b1["rows"]) * b1["rows"] * sC * 4
    stream = {"T": sT, "C": sC, "rows": b1["rows"], "cb": s_cb,
              "k_fastest": b1["k_fastest"], "ms": s_ms,
              "read_bytes_per_s": s_read / (s_ms / 1e3),
              "torch_sum_ms": s_sum,
              "torch_sum_read_bytes_per_s": sT * sC * 4 / (s_sum / 1e3)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    MEASURED["read_bytes_per_s"] = rate
    res = {
        "phase": "hbm_probe", "read_bytes_per_s": rate,
        "read_rate_from": {k: rate_from[k] for k in
                           ("probe", "rows", "cb", "P", "nbuf", "k_fastest")
                           if k in rate_from},
        "share_of_3.35TBps": rate / HBM_BYTES_PER_S,
        "shape": f"{T}x{C} f32", "launches": launches,
        "best": best, "plain_ms": plain, "torch_sum": lib_sum,
        "copy_": lib_copy, "stream_block": stream,
        "max_abs_err": err, "check_s": check_s, "sweep_s": sweep_s,
        "card": card_line() if device.type == "cuda" else "cpu rehearsal",
    }
    emit(res)
    for name, n in launches.items():
        if n == 0:
            if device.type == "cuda":
                fail(f"the probe path launched {name} no time")
        elif device.type != "cuda":
            fail(f"{name} launched on the CPU")

    def entry(name, replaces, probe, err_key):
        r = best[probe]
        bound_m = (r["read_bytes"] + r["written_bytes"]) / rate * 1e3
        return {
            "name": name, "route": "cuda",
            "source": "tpudas_torch/csrc/hbm_probe.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[err_key],
            "ms": r["ms"], "plain_ms": plain[probe], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": lib_sum["ms"],
            "bound_ms_measured": bound_m, "copy_ms": lib_copy["ms"],
            "read_bytes_per_s": r["read_bytes_per_s"],
            "geometry": {k: r[k] for k in ("rows", "cb", "P", "nbuf",
                                           "k_fastest") if k in r},
            "shape": f"{T}x{C} f32 ({probe}'s best geometry of its sweep)",
        }

    return [entry("copy_heads", "tools/probe_pipeline.py:32", "P1",
                  "copy_heads"),
            entry("copy_heads_pstream", "tools/probe_pipeline.py:70", "P2",
                  "copy_heads_pstream"),
            entry("ring_reader", "tools/probe_dma.py:45", "P3",
                  "ring_reader")]


def lfproc_class(force_tdas=False):
    """``LFProc``, or — where h5py is missing (the card's host) or a
    rehearsal asks for the card's path — a subclass that writes each
    output patch as tdas under the ``LFDAS_`` stem."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.proc.lfproc import LFProc

    if importlib.util.find_spec("h5py") is not None and not force_tdas:
        return LFProc

    class TdasOutputLFProc(LFProc):
        """Writes each output patch as tdas under the LFDAS_ stem."""

        def _write_output(self, patch, path):
            write_tdas(patch, os.path.splitext(path)[0] + ".tdas")

    return TdasOutputLFProc


def lf_fit(patch, bg):
    """(max per-channel LF fit residual, max amplitude error): each
    channel regressed on the synthetic 0.05 Hz sine, whose amplitude is
    the known ramp over distance."""
    times = patch.coords["time"]
    data = patch.host_data()
    dists = patch.coords["distance"]
    s = np.sin(2 * np.pi * LF_FREQ * (
        (times - bg).astype("timedelta64[ns]").astype(np.int64) / 1e9))
    a = (data * s[:, None]).sum(0) / (s @ s)  # per-channel regression
    resid = np.abs(data - s[:, None] * a[None, :]).max(0) / np.abs(a)
    truth_amp = 1.0 + dists / (dists.max() + 1.0)  # the synthetic ramp
    amp_err = np.abs(a - truth_amp) / truth_amp
    return float(resid.max()), float(amp_err.max())


def grid_checks(out, what, step_ns=1_000_000_000):
    """The merged output of ``out``: one patch on a gap-free grid of
    ``step_ns`` (1 Hz by default) under LFDAS_ names.  Returns (patch,
    sorted names)."""
    from tpudas_torch.io.spool import spool

    names = sorted(os.listdir(out))
    names = [n for n in names if not n.startswith(".")]
    merged = spool(out).update().chunk(time=None)
    if len(merged) != 1:
        fail(f"{what}: output does not merge into one patch ({len(merged)})")
    p = merged[0]
    steps = np.diff(p.coords["time"].astype("datetime64[ns]").astype(np.int64))
    if not all(n.startswith("LFDAS_") for n in names):
        fail(f"{what}: output names are not all LFDAS_")
    if not bool(np.all(steps == step_ns)):
        fail(f"{what}: output grid is not a gap-free {step_ns / 1e9:g} s grid")
    if not bool(np.isfinite(p.host_data()).all()):
        fail(f"{what}: output not finite")
    return p, names


def phase_main_path(device, n_ch, seconds, workdir, cls):
    """Phase 4: the batch path.  Leaves its spool (``workdir/src``) and
    output (``workdir/out``) for phase 5."""
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.testing import make_synthetic_spool

    src = os.path.join(workdir, "src")
    out = os.path.join(workdir, "out")
    shutil.rmtree(workdir, ignore_errors=True)
    file_sec = 60.0
    n_files = int(round(seconds / file_sec))
    t0 = time.perf_counter()
    make_synthetic_spool(
        src, n_files=n_files, file_duration=file_sec, fs=1000.0, n_ch=n_ch,
        noise=NOISE, format="tdas", start=T0,
        write_kwargs={"dtype": "int16", "scale": QSCALE},
    )
    setup_s = time.perf_counter() - t0
    bg = np.datetime64(T0, "ns")
    fir_decimate.launches = 0
    lfp, wall, wins, expect_stems = run_lfproc(device, cls, src, out)
    expect_windows = len(wins)
    launches = fir_decimate.launches
    windows = sum(lfp.engine_counts.values())
    p, names = grid_checks(out, "main path")
    resid, amp_err = lf_fit(p, bg)
    res = {
        "phase": "main_path", "channels": n_ch, "seconds": n_files * file_sec,
        "fs": 1000.0, "payload": "int16 tdas", "setup_s": setup_s,
        "output_format": ("tdas (no h5py)" if cls.__name__ != "LFProc"
                          else "dasdae"),
        "windows": windows, "expected_windows": expect_windows,
        "engine_counts": lfp.engine_counts,
        "quantized_windows": lfp.quantized_windows,
        "fir_decimate_launches": launches, "wall_s": wall,
        "s_per_window": wall / max(windows, 1), "timings": lfp.timings,
        "realtime_factor": n_files * file_sec / wall,
        "outputs": len(names), "output_rows": int(p.host_data().shape[0]),
        "lf_fit_max_resid": resid, "lf_amp_max_rel_err": amp_err,
    }
    emit(res)
    if cls.__name__ != "LFProc":
        print("main path: outputs were written as tdas under the LFDAS_ "
              "stem (no h5py on this host, or a rehearsal)", flush=True)
    ran = "cascade-cuda" if device.type == "cuda" else "cascade-torch"
    want_launches = 4 * windows if device.type == "cuda" else 0
    checks = [
        (windows == expect_windows, "window count"),
        (lfp.engine_counts[ran] == windows, f"every window ran {ran}"),
        (lfp.quantized_windows == windows, "every window shipped int16"),
        (launches == want_launches, f"launches {launches} != {want_launches}"),
        ([os.path.splitext(n)[0] for n in names] == expect_stems,
         "output names follow the window schedule"),
        (int(p.host_data().shape[0]) == wins[-1][3] - wins[0][2],
         "output rows cover the schedule"),
        (resid < 0.01, "LF fit residual < 0.01"),
        (amp_err < 0.01, "LF amplitude error < 0.01"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"main path check failed: {what}")
    return res


def interior_rel(p_a, p_b):
    """max |a - b| / max |b| on the two patches' common time span."""
    lo = max(p_a.coords["time"][0], p_b.coords["time"][0])
    hi = min(p_a.coords["time"][-1], p_b.coords["time"][-1])
    av = p_a.select(time=(lo, hi)).host_data()
    bv = p_b.select(time=(lo, hi)).host_data()
    if av.shape != bv.shape or not av.size:
        return float("inf")
    return float(np.abs(av - bv).max() / np.abs(bv).max())


def new_run():
    """Accumulators of one real-time run over one or more driver calls."""
    return {"calls": 0, "rounds": 0, "blocks": {}, "wall_s": 0.0,
            "timings": {}, "counters": None, "events": []}


def link_files(src_all, src, upto):
    """Hard-link the first ``upto`` files of ``src_all`` into ``src``."""
    os.makedirs(src, exist_ok=True)
    for name in sorted(os.listdir(src_all))[:upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(src_all, name), os.path.join(src, name))


def drive_realtime(run, src_all, src, out, engine, device, feed=(), **para):
    """One ``run_lowpass_realtime`` call at the flagship parameters
    (``para`` overrides them); each poll's sleep links up to the next
    file count of ``feed``."""
    from tpudas_torch.proc.streaming import run_lowpass_realtime
    from tpudas_torch.utils.logging import set_log_handler
    from tpudas_torch.utils.profiling import Counters

    feed = list(feed)
    if run["counters"] is None:
        run["counters"] = Counters()

    def sleep(_):
        if feed:
            link_files(src_all, src, feed.pop(0))

    def on_round(_rnd, lfp):
        run["rounds"] += 1
        for k, v in lfp.stream_blocks.items():
            run["blocks"][k] = run["blocks"].get(k, 0) + v
        for k, v in lfp.timings.items():
            run["timings"][k] = run["timings"].get(k, 0.0) + v

    kw = dict(output_sample_interval=1.0, edge_buffer=10.0,
              process_patch_size=60)
    kw.update(para)
    set_log_handler(run["events"].append)
    t0 = time.perf_counter()
    try:
        n = run_lowpass_realtime(
            src, out, T0, poll_interval=0.0, sleep_fn=sleep,
            on_round=on_round, engine=engine, stateful=True,
            counters=run["counters"], device=device, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        set_log_handler(None)
    run["wall_s"] += time.perf_counter() - t0
    run["calls"] += 1
    return n


def phase_realtime(device, workdir, cls):
    """Phase 5: the real-time path over phase 4's spool.  A fused run
    (engine="fused") sees files 1-2, saves its carry and ends; a second
    call sees file 3 and resumes from that carry.  The control
    (engine="auto", one uninterrupted call, the same feed: files 1-2,
    then 3) runs the per-stage chain.  Both are held to each other and
    to phase 4's batch output."""
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.stream import CARRY_FILENAME

    src_all = os.path.join(workdir, "src")
    rt = os.path.join(workdir, "rt")
    shutil.rmtree(rt, ignore_errors=True)
    cuda = device.type == "cuda"

    def link(src, upto):
        link_files(src_all, src, upto)

    def drive(run, src, out, engine, feed=()):
        return drive_realtime(run, src_all, src, out, engine, device, feed)

    # the runner builds an LFProc every round: on a host without h5py
    # it must be the one that writes tdas
    saved_cls = fleet_engine.LFProc
    fleet_engine.LFProc = cls
    try:
        fused, ctrl = new_run(), new_run()
        src_f, out_f = os.path.join(rt, "src_fused"), os.path.join(rt, "fused")
        link(src_f, 2)
        fused_cascade.launches = 0
        fir_decimate.launches = 0
        r1 = drive(fused, src_f, out_f, "fused")
        carry_saved = os.path.isfile(os.path.join(out_f, CARRY_FILENAME))
        resumes_1 = sum(e["event"] == "stream_resume" for e in fused["events"])
        link(src_f, 3)
        r2 = drive(fused, src_f, out_f, "fused")
        fused_launches = fused_cascade.launches
        fused_fir_launches = fir_decimate.launches
        resumes = sum(e["event"] == "stream_resume" for e in fused["events"])

        src_c, out_c = os.path.join(rt, "src_ctrl"), os.path.join(rt, "ctrl")
        link(src_c, 2)
        fused_cascade.launches = 0
        fir_decimate.launches = 0
        rc = drive(ctrl, src_c, out_c, "auto", feed=[3])
        ctrl_launches = fir_decimate.launches
        ctrl_fused_launches = fused_cascade.launches
    finally:
        fleet_engine.LFProc = saved_cls

    bg = np.datetime64(T0, "ns")
    p_f, names_f = grid_checks(out_f, "realtime fused")
    p_c, names_c = grid_checks(out_c, "realtime control")
    p_b, _ = grid_checks(os.path.join(workdir, "out"), "batch")
    ctrl_rel = per_channel_rel(torch.from_numpy(p_f.host_data()),
                               torch.from_numpy(p_c.host_data()))[0]
    batch_rel = interior_rel(p_f, p_b)
    resid, amp_err = lf_fit(p_f, bg)
    rounds = [e for e in fused["events"] if e["event"] == "realtime_round"]
    fused_eng = "fused-cuda" if cuda else "fused-torch"
    chain_eng = "cascade-cuda" if cuda else "cascade-torch"
    n_fused = sum(fused["blocks"].values())
    n_ctrl = sum(ctrl["blocks"].values())
    ctr = fused["counters"]
    res = {
        "phase": "realtime", "channels": int(p_f.host_data().shape[1]),
        "seconds": ctr.data_seconds, "payload": "int16 tdas",
        "fused": {"calls": fused["calls"], "rounds": fused["rounds"],
                  "resumes": resumes, "blocks": fused["blocks"],
                  "fused_cascade_launches": fused_launches,
                  "fir_decimate_launches": fused_fir_launches,
                  "wall_s": fused["wall_s"], "timings": fused["timings"],
                  "realtime_factor": ctr.realtime_factor,
                  "head_lag_s": rounds[-1]["head_lag_seconds"] if rounds
                  else None,
                  "outputs": len(names_f)},
        "control": {"rounds": ctrl["rounds"], "blocks": ctrl["blocks"],
                    "fir_decimate_launches": ctrl_launches,
                    "fused_cascade_launches": ctrl_fused_launches,
                    "wall_s": ctrl["wall_s"], "timings": ctrl["timings"],
                    "realtime_factor": ctrl["counters"].realtime_factor},
        "fused_vs_control_max_rel_err": ctrl_rel,
        "fused_vs_batch_interior_rel_err": batch_rel,
        "output_rows": int(p_f.host_data().shape[0]),
        "lf_fit_max_resid": resid, "lf_amp_max_rel_err": amp_err,
    }
    emit(res)
    checks = [
        ((r1, r2, rc) == (1, 1, 2), f"rounds {(r1, r2, rc)} != (1, 1, 2)"),
        (carry_saved, "the first fused call saved its carry"),
        (resumes_1 == 0 and resumes == 1,
         "the second fused call resumed from the saved carry"),
        (set(fused["blocks"]) == {fused_eng} and n_fused > 0,
         f"every fused block ran {fused_eng}"),
        (fused_launches == (n_fused if cuda else 0),
         f"fused_cascade launches {fused_launches} != blocks {n_fused}"),
        (fused_fir_launches == 0, "the fused run launched no per-stage kernel"),
        (set(ctrl["blocks"]) == {chain_eng} and n_ctrl > 0,
         f"every control block ran {chain_eng}"),
        (ctrl_launches == (4 * n_ctrl if cuda else 0),
         f"control fir_decimate launches {ctrl_launches} != 4 x {n_ctrl}"),
        (ctrl_fused_launches == 0, "the control launched no fused kernel"),
        (names_f == names_c, "fused and control output names differ"),
        (ctrl_rel <= REL_TOL, f"fused vs control rel err {ctrl_rel:.3e}"),
        (batch_rel <= 1e-4, f"fused vs batch interior {batch_rel:.3e}"),
        (resid < 0.01, "LF fit residual < 0.01"),
        (amp_err < 0.01, "LF amplitude error < 0.01"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"realtime check failed: {what}")
    return res


def run_lfproc(device, cls, src, out, **para):
    """One ``LFProc.process_time_range`` over the whole spool at the
    flagship parameters (``para`` overrides them); returns (lfp, wall
    seconds, schedule: windows and expected LFDAS_ stems)."""
    from tpudas_torch.core.timeutils import build_time_grid
    from tpudas_torch.io.spool import spool
    from tpudas_torch.proc.lfproc import schedule_windows
    from tpudas_torch.proc.naming import get_filename

    kw = dict(output_sample_interval=1.0, process_patch_size=60,
              edge_buff_size=10)
    kw.update(para)
    lfp = cls(spool(src).sort("time").update(), device=device)
    lfp.update_processing_parameter(**kw)
    lfp.set_output_folder(out, delete_existing=True)
    bg = np.datetime64(T0, "ns")
    ed = bg + np.timedelta64(int(MAIN_PATH_SECONDS), "s")
    grid = build_time_grid(bg, ed, kw["output_sample_interval"])
    wins = schedule_windows(len(grid), kw["process_patch_size"],
                            kw["edge_buff_size"])
    stems = sorted(os.path.splitext(get_filename(grid[el], grid[eh - 1]))[0]
                   for _, _, el, eh in wins)
    t0 = time.perf_counter()
    lfp.process_time_range(bg, ed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return lfp, time.perf_counter() - t0, wins, stems


def phase_fft(device, workdir, cls):
    """Phase 6: the FFT engine over phase 4's spool.  (a) the batch path
    under engine="fft"; (b) engine="auto" on a 1.1 s grid, which the
    cascade cannot serve (ratio 1100 = 2^2 5^2 11), so every window
    routes to the FFT engine; (c) the real-time path under engine="fft"
    over files 1-2, resumed over file 3 from its "fft" carry, held to
    (a) on the common interior."""
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.stream import load_carry

    src_all = os.path.join(workdir, "src")
    fdir = os.path.join(workdir, "fft")
    shutil.rmtree(fdir, ignore_errors=True)
    bg = np.datetime64(T0, "ns")
    checks = []

    def kernels_quiet():
        fir_decimate.launches = fused_cascade.launches = 0

    # (a) engine="fft", 1 s grid
    kernels_quiet()
    out_a = os.path.join(fdir, "batch")
    lfp_a, wall_a, wins_a, stems_a = run_lfproc(device, cls, src_all, out_a,
                                                engine="fft")
    fir_a = fir_decimate.launches + fused_cascade.launches
    p_a, names_a = grid_checks(out_a, "fft batch")
    resid_a, amp_a = lf_fit(p_a, bg)
    a = {"windows": len(wins_a), "engine_counts": lfp_a.engine_counts,
         "fir_launches": fir_a, "wall_s": wall_a, "timings": lfp_a.timings,
         "realtime_factor": MAIN_PATH_SECONDS / wall_a,
         "quantized_windows": lfp_a.quantized_windows,
         "lf_fit_max_resid": resid_a, "lf_amp_max_rel_err": amp_a}
    checks += [
        (len(wins_a) == 4 and lfp_a.engine_counts.get("fft") == 4,
         f"(a) 4 windows, all fft: {lfp_a.engine_counts}"),
        (sum(lfp_a.engine_counts.values()) == 4, "(a) only fft windows"),
        (fir_a == 0, f"(a) {fir_a} FIR launches"),
        ([os.path.splitext(n)[0] for n in names_a] == stems_a,
         "(a) output names follow the window schedule"),
        (resid_a < 0.01 and amp_a < 0.01, "(a) LF recovery < 0.01"),
    ]
    # (b) engine="auto" on a 1.1 s grid
    kernels_quiet()
    out_b = os.path.join(fdir, "auto_1p1")
    lfp_b, wall_b, wins_b, stems_b = run_lfproc(
        device, cls, src_all, out_b, engine="auto",
        output_sample_interval=1.1)
    fir_b = fir_decimate.launches + fused_cascade.launches
    p_b, names_b = grid_checks(out_b, "auto 1.1 s", step_ns=1_100_000_000)
    resid_b, amp_b = lf_fit(p_b, bg)
    b = {"windows": len(wins_b), "engine_counts": lfp_b.engine_counts,
         "fir_launches": fir_b, "wall_s": wall_b, "timings": lfp_b.timings,
         "lf_fit_max_resid": resid_b, "lf_amp_max_rel_err": amp_b}
    checks += [
        (len(wins_b) > 0 and lfp_b.engine_counts.get("fft") == len(wins_b)
         and sum(lfp_b.engine_counts.values()) == len(wins_b),
         f"(b) every window routed to fft: {lfp_b.engine_counts}"),
        (fir_b == 0, f"(b) {fir_b} FIR launches"),
        ([os.path.splitext(n)[0] for n in names_b] == stems_b,
         "(b) output names follow the window schedule"),
        (resid_b < 0.01 and amp_b < 0.01, "(b) LF recovery < 0.01"),
    ]
    # (c) the real-time path under engine="fft", resumed once
    run = new_run()
    src_c, out_c = os.path.join(fdir, "src_rt"), os.path.join(fdir, "rt")
    saved_cls = fleet_engine.LFProc
    fleet_engine.LFProc = cls
    try:
        kernels_quiet()
        link_files(src_all, src_c, 2)
        r1 = drive_realtime(run, src_all, src_c, out_c, "fft", device)
        carry = load_carry(out_c)
        link_files(src_all, src_c, 3)
        r2 = drive_realtime(run, src_all, src_c, out_c, "fft", device)
        fir_c = fir_decimate.launches + fused_cascade.launches
    finally:
        fleet_engine.LFProc = saved_cls
    resumes = sum(e["event"] == "stream_resume" for e in run["events"])
    p_c, names_c = grid_checks(out_c, "fft realtime")
    resid_c, amp_c = lf_fit(p_c, bg)
    rel_c = interior_rel(p_c, p_a)
    ctr = run["counters"]
    c = {"calls": run["calls"], "rounds": run["rounds"], "resumes": resumes,
         "carry_kind": None if carry is None else carry.kind,
         "edge_in": None if carry is None else carry.edge_in,
         "blocks": run["blocks"], "fir_launches": fir_c,
         "wall_s": run["wall_s"], "timings": run["timings"],
         "seconds": ctr.data_seconds, "realtime_factor": ctr.realtime_factor,
         "outputs": len(names_c), "vs_batch_interior_rel_err": rel_c,
         "lf_fit_max_resid": resid_c, "lf_amp_max_rel_err": amp_c}
    checks += [
        ((r1, r2) == (1, 1), f"(c) rounds {(r1, r2)} != (1, 1)"),
        (carry is not None and carry.kind == "fft",
         "(c) the first call saved an fft carry"),
        (resumes == 1, f"(c) {resumes} stream_resume events, not 1"),
        (set(run["blocks"]) == {"fft"}, f"(c) blocks {run['blocks']}"),
        (fir_c == 0, f"(c) {fir_c} FIR launches"),
        (rel_c <= 1e-4, f"(c) stream vs batch interior {rel_c:.3e} > 1e-4"),
        (resid_c < 0.01 and amp_c < 0.01, "(c) LF recovery < 0.01"),
    ]
    emit({"phase": "fft", "channels": int(p_a.host_data().shape[1]),
          "payload": "int16 tdas", "batch_fft": a, "auto_1.1s": b,
          "realtime_fft": c})
    for ok, what in checks:
        if not ok:
            fail(f"fft check failed: {what}")
    return {"batch_fft": a, "auto_1.1s": b, "realtime_fft": c}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="dry run on the CPU at a small width; exits 3")
    args = ap.parse_args(argv)
    if args.rehearse:
        device = torch.device("cpu")
        widths, n_ch = (64, 48), 64
        # 64 channels make every stream block smaller than the fused
        # size threshold; clear it so phase 5 runs the fused step
        os.environ["TPUDAS_FUSED_MIN_ELEMS"] = "0"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                  "False); nothing was run", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        widths, n_ch = (10000, 2048), 10000
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpudas_torch.tools.probe_pipeline import card_line

    smi = card_line() if device.type == "cuda" else "cpu rehearsal"
    emit({
        "phase": "environment", "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "nvidia_smi": smi,
        "h5py": importlib.util.find_spec("h5py") is not None,
        "pandas": importlib.util.find_spec("pandas") is not None,
    })

    from tpudas_torch.ops._build import build_info, build_libraries

    if device.type == "cuda":
        # every kernel at once: one nvcc per source, started together
        t0 = time.perf_counter()
        libs = ("fir_decimate", "fused_cascade", "hbm_probe")
        build_libraries(libs)
        emit({"phase": "build", "wall_s": time.perf_counter() - t0,
              "libraries": {n: build_info(n) for n in libs}})

    timer = Timer(device)
    probes = phase_hbm_probe(device, args.rehearse)
    plan, main_cases = phase_kernels(device, widths, timer)
    fused_cases = phase_fused_kernel(device, widths, timer)
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    cls = lfproc_class(force_tdas=args.rehearse)
    res = phase_main_path(device, n_ch, MAIN_PATH_SECONDS, workdir, cls)
    rt = phase_realtime(device, workdir, cls)
    phase_fft(device, workdir, cls)
    shutil.rmtree(workdir, ignore_errors=True)

    recs = main_cases[(widths[0], True)]  # the main path's shapes
    kernel = {
        "name": "fir_decimate",
        "route": "cuda",
        "source": "tpudas_torch/csrc/fir_decimate.cu",
        "replaces": "tpudas/ops/pallas_fir.py:324",
        "launches": res["fir_decimate_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": sum(r["ms"] for r in recs),
        "plain_ms": sum(r["plain_ms"] for r in recs),
        "bound_ms": sum(r["bound_ms"] for r in recs),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in recs)
                     else "operations"),
        "bound_ms_measured": sum(r["bound_ms_measured"] for r in recs),
        "library_ms": sum(r["library_ms"] for r in recs),
        "shape": (f"the 4 flagship stages of one 60 s window, "
                  f"{widths[0]} ch int16"),
        "realtime_control_launches": rt["control"]["fir_decimate_launches"],
    }
    # B3 at the main path's full block: 60 outputs, int16, full width
    full = fused_cases[(widths[0], True, 60)]
    mains = [r for (c, q, _n), r in fused_cases.items()
             if c == widths[0] and q]
    fused = {
        "name": "fused_cascade",
        "route": "cuda",
        "source": "tpudas_torch/csrc/fused_cascade.cu",
        "replaces": "tpudas/ops/pallas_fir.py:576",
        "launches": rt["fused"]["fused_cascade_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in mains),
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "bound_ms_measured": full["bound_ms_measured"],
        # no single PyTorch call computes the stateful cascade step
        "library_ms": None,
        "b1_chain_ms": full["b1_chain_ms"],
        "conv1d_chain_ms": full["conv1d_chain_ms"],
        "ms_by_block": {f"{n} out": fused_cases[(widths[0], True, n)]["ms"]
                        for n in (60, 8, 1)},
        "shape": f"one 60-output stream block, {widths[0]} ch int16",
    }
    emit({"kernels": [kernel, fused, *probes]})
    if args.rehearse:
        print("chip_smoke: CPU rehearsal finished; no result", flush=True)
        return 3
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
