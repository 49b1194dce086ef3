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
3b. the fused cascade step (kernel A, stages 0-1 over time tiles, then
   kernel B, the ring walk, on its output) vs plain on stream blocks of
   60, 8 and 1 outputs at 10,000 channels (int16, f32), 60 at 2,048, a
   ragged width, an uneven block sequence (outputs and every carry
   leaf), a NaN gap (the kernels' NaN set within the plain one's) and
   all-zero input; each case times the step (``ms``) beside the
   single-kernel step it replaced (``one_kernel_ms``: kernel B over the
   whole cascade, also held to the plain version), and the timed cases
   kernel A and kernel B alone, the per-stage kernel chain and a
   ``conv1d`` chain;
4. ``LFProc`` over 180 s x 10,000 channels: every window on the CUDA
   kernel, ``fir_decimate.launches == 4 x windows``, the output tiles
   the 1 Hz grid, the synthetic LF component is recovered within 0.01;
5. ``run_lowpass_realtime`` over the same spool: engine="fused" over
   files 1-2, then a second call that resumes from the saved carry over
   file 3; every block launches the fused step (kernels A and B); an
   engine="auto"
   control (per-stage kernel on every stage, 4 launches a block) gives
   the same names and data within 1e-5; the stream equals phase 4's
   batch output within 1e-4 on the common interior;
6. the FFT engine over the same spool: ``LFProc(engine="fft")`` (4
   windows, all "fft", no FIR launch, the 1 Hz grid, LF recovery);
   ``engine="auto"`` on a 1.1 s grid (ratio 1100 = 2^2 5^2 11: every
   window routes to the FFT engine); ``run_lowpass_realtime(engine=
   "fft")`` over files 1-2, then resumed over file 3 from its "fft"
   carry, equal to the FFT batch output within 1e-4 on the interior;
7. ``JointProc`` over the same spool: LF files byte-equal to phase 4's,
   the 1 s rolling mean within 1e-6 of a float64 mean;
8. the fleet (``FleetEngine``) over the same spool: four streams of
   10,000, 6,001, 2,500 and 1,499 channels (``distance`` selections,
   20,000 ch packed), batched under ``engine="fused"`` (files 1-2, then
   a second fleet resumed over file 3), ``"auto"`` (files 1-2) and
   ``"fft"`` (file 1): every member's output files and carry byte-equal to its solo
   control and to the unbatched fleet, B3 and the B1 chain launched on
   the packed block (fewer steps than member blocks), every FFT step at
   its member's width; the fused fleet again with every wave's steps
   run one by one (threads kept, packing taken away); one packed
   60-output B3 step timed against its members' solo steps; the FFT's
   packed transform held against the per-member one;
9. the real-time derived products over the same spool: (a)
   ``run_lowpass_realtime(engine="fused", detect=True)`` with STA/LTA
   and RMS (thresholds that yield events here) over files 1-2, then a
   resumed call over file 3, its ledger, detect carry and scores equal
   to an uninterrupted control's, B3 launched, the same rows through
   the operators on the CPU giving the same events (STA/LTA
   byte-equal, RMS within 1e-6); (b) ``run_rolling_realtime`` (1 s
   window and step) with detect ``rms``, each output within 1e-6 of a
   float64 rolling mean of its file; (c) the real-time joint product
   (``rolling_output_folder``) over two rounds, seam-free, within 1e-6
   of phase 7's batch product, the LF product within 1e-4 of phase
   4's, B1 launched; (d) ``Patch.median_filter`` (5 x 5, and 9 along
   time) on phase 4's output bit-equal to ``scipy.ndimage``;
10. the SIGKILL crash drill (``tpudas_torch/tools/crash_drill.py``) at
   10,000 channels under ``engine="fused"`` (4 killed cycles),
   ``"auto"`` and ``"fft"`` (2 each): fresh worker interpreters on the
   card with the stateful carry, phase 9's detection and the tile
   pyramid on, killed at seeded points after they are ready; the
   drained folder audits clean, no worker's startup audit raised, no
   pyramid append failed, and the outputs, the stream carry, the
   pyramid tree and the detect state equal an uninterrupted control's;
   the fused workers launched B3 and the auto workers B1;
11. the tile pyramid (``tpudas_torch.serve``) over 6 files of 60 s x
   10,000 ch: (a) ``run_lowpass_realtime(engine="fused",
   pyramid=True)`` in two calls, the tree equal to ``rebuild_pyramid``
   over a copy, the level counts the output rows and their floor
   divisions by 4, B3 launched once a block; (b) ``engine="auto"``
   under ``TPUDAS_CODEC=bitshuffle-deflate`` and 64-row tiles, decoded
   tiles equal to a raw store's, a ``quantize-deflate`` rebuild within
   1e-3 with the generation bumped, B1 launched 4 times a block; (c)
   ``QueryEngine`` at 16, 64 and 1,024 samples over the whole stream
   (full width and 1,000 ch), each answer equal to the host reduction of
   the output rows, cold and warm, and windows past the head served
   from the files; (d) ``block_reduce(engine="torch")`` on the card
   against the host float64 reduction (min/max exact, mean within 1e-6
   of the largest value); (e) the waterfall's ``_pyramid_block`` at
   ``max_px`` 256.  No pyramid append may fail;
12. the observability plane (``tpudas_torch.obs``: health files, flight
   ring, round phases) on the real-time path over 4 files of 60 s x
   10,000 ch, one a round: (a) ``engine="fused"`` with ``health=True``,
   the flight ring at its default, detection and the pyramid, in two
   calls (the second resumes from the carry): each round's ten phases,
   its body seconds and the part of the body no phase covers, and
   ``timings["device_s"]`` beside ``host_wait``; ``health.json``
   validated every round, ``metrics.prom`` holding every phase's
   count, the ring's round records each after its ``stream.round``
   span, no health write error, no flight drop, B3 2 kernels a block;
   (b) the same under ``"auto"`` (B1 4 times a block) and ``"fft"``;
   (c) the fused stream (no detection, no pyramid) with health and
   flight off and on in A B B A turns, the round walls and their
   difference; (d) a batched ``fused`` fleet of 10,000 and 6,001 ch with
   health on, ``fleet_rollup`` and ``python -m
   tpudas_torch.tools.obs_report --json`` over its root, each member's
   ring holding only its own spans and rounds.  Phase 10's workers run
   with health and the flight ring on, and each leg must replay the
   last committed round from the ring right after its kills.

Per-channel relative errors are held to 1e-5 (same f32 products, other
order) and zeros must be exact; times come from CUDA events, each with
its bound.  Then the kernel summary line, the card's name and power
limit, and the last line ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero.  Without a CUDA card it exits 2
before any phase.  ``--rehearse`` runs the same phases on the CPU at a
64-channel width with the plain versions (no kernel, no timings worth
reading) and exits 3: a dry run of the control flow, never a result.
``--only fir`` runs phases 1, 2 and 3 alone (the stage kernel's
iteration loop), ``--only fused`` phases 1, 2 and 3b (the fused
step's), ``--only fleet`` phases 1, 2 and 8 over a fresh spool and
``--only detect`` phases 1, 2 and 9 over a fresh spool (its batch
references from one ``JointProc`` pass), ``--only crash`` phases 1,
2 and 10 over a fresh spool (``--cycles N``: N killed cycles for every
engine), ``--only pyramid`` phases 1, 2 and 11 and ``--only obs``
phases 1, 2 and 12, each over a fresh spool; all exit 4 without the
kernels line or the ``ok`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import shutil
import sys
import time
from unittest import mock

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

    def cold(self, fn, reps=20):
        """Milliseconds per call with the 50 MB L2 flushed (a 128 MB
        write) before each launch; each launch timed alone."""
        if not self.cuda:
            return self(fn, reps)
        flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
        fn()
        pairs = []
        for _ in range(reps):
            flush.fill_(1.0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def graphed(self, fn, calls=10, reps=5):
        """Milliseconds per call of the device work alone: ``calls``
        calls captured in one CUDA graph, replayed ``reps`` times, so no
        host time of the wrapper stands between launches."""
        if not self.cuda:
            return self(fn, reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        b.synchronize()
        del g
        return a.elapsed_time(b) / (reps * calls)

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


def rows_read(T, R, B, n_out, row0):
    """Rows of a (T, C) stage input that the stage reads: those of
    [row0, row0 + (n_out + B) * R) inside [0, T)."""
    return max(0, min(T, row0 + (n_out + B) * R) - max(0, row0))


def compare_stage(timer, x, hb, R, k, taps, label, with_time=True, row0=0,
                  cold=False):
    """Kernel vs plain on one stage input (first row ``row0``); returns
    the case record.  With ``with_time``: the kernel, plain and the
    library call in turns, the kernel's device time in a CUDA graph,
    and with ``cold`` the kernel again with L2 flushed before each
    launch."""
    from tpudas_torch.ops.fir_kernel import (
        copy_width, fir_decimate, fir_decimate_plain,
    )

    got = fir_decimate(x, hb, R, k, row0)
    ref = fir_decimate_plain(x, hb, R, k, row0)
    timer.sync()
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: kernel output not finite")
    rel, abs_err = per_channel_rel(got, ref)
    T, C = x.shape
    bound, bound_by, bound_m = stage_bound_ms(
        rows_read(T, R, hb.shape[0], k, row0), C, x.element_size(), k, taps)
    rec = {"case": label, "T": T, "C": C, "dtype": str(x.dtype).split(".")[-1],
           "R": R, "taps": taps, "n_out": k, "row0": row0,
           "copy_width": copy_width(x), "max_rel_err": rel,
           "max_abs_err": abs_err, "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_measured": bound_m}
    if with_time:
        h = hb.reshape(-1)[None, None, :]

        def lib():
            xt = x[max(row0, 0):].t().to(torch.float32)[:, None, :]
            return torch.nn.functional.conv1d(xt, h, stride=R,
                                              padding=max(-row0, 0))

        lib_out = lib()[:, 0, :].t()
        n = min(lib_out.shape[0], k)
        rec["library_max_abs_err"] = float(
            (lib_out[:n] - ref[:n]).abs().max()
        )
        kern = lambda: fir_decimate(x, hb, R, k, row0)  # noqa: E731
        plain = lambda: fir_decimate_plain(x, hb, R, k, row0)  # noqa: E731
        rec.update(timed_turns(timer, (kern, plain, lib),
                               ("ms", "plain_ms", "library_ms")))
        d1, d2 = timer.graphed(kern), timer.graphed(kern)
        rec.update(device_ms=(d1 + d2) / 2, device_ms_turns=[d1, d2])
        if cold:
            k1, k2 = timer.cold(kern), timer.cold(kern)
            rec.update(cold_ms=(k1 + k2) / 2, cold_ms_turns=[k1, k2])
    if rel > REL_TOL:
        emit(rec)
        fail(f"{label}: kernel vs plain per-channel rel err {rel:.3e} > "
             f"{REL_TOL:g}")
    return rec


def window_paths(timer, plan, x, phase, n_out, label):
    """One batch window's device path on the kernel (``cascade_decimate``:
    the four stages, stage 0 from its first row) against the plain path
    (``engine="torch"``: ``shift_to_phase``'s padded copy, then the four
    plain stages), on the same window: outputs held to each other,
    times in turns."""
    from tpudas_torch.ops.fir import cascade_decimate

    qs = QSCALE if x.dtype == torch.int16 else None

    def kern():
        return cascade_decimate(x, plan, phase, n_out, qscale=qs)

    def plain():
        return cascade_decimate(x, plan, phase, n_out, "torch", qscale=qs)

    rel = per_channel_rel(kern(), plain())[0]
    d1, d2 = timer.graphed(kern), timer.graphed(kern)
    rec = {"case": label, "T": x.shape[0], "C": x.shape[1], "max_rel_err": rel,
           **timed_turns(timer, (kern, plain),
                         ("window_path_ms", "window_path_plain_ms")),
           "window_path_device_ms": (d1 + d2) / 2,
           "window_path_device_ms_turns": [d1, d2]}
    if rel > REL_TOL:
        emit(rec)
        fail(f"{label}: window paths differ by {rel:.3e}")
    return rec


def phase_kernels(device, widths, timer):
    from tpudas_torch.ops.fir import blocked_taps, chain_layout, design_cascade
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
    main, paths = {}, {}
    for C in widths:
        for quantized in (True, False):
            # stage 0 reads the window from its first row phase - delay
            # (< 0: the left pad), as cascade_decimate's kernel path does
            x = synthetic_window(T, C, device, seed=C, quantized=quantized)
            cur, recs = x, []
            for i, ((R, hb), (_e, k)) in enumerate(zip(stages, layout)):
                row0 = phase - plan.delay if i == 0 else 0
                label = (f"flagship stage {i} "
                         f"{'int16' if cur.dtype == torch.int16 else 'f32'}"
                         f" {C}ch")
                recs.append(compare_stage(timer, cur, hb, R, k, taps[i], label,
                                          row0=row0, cold=True))
                emit(recs[-1])
                nxt = fir_decimate_plain(cur, hb, R, k, row0)
                if cur.dtype == torch.int16:
                    nxt = nxt * QSCALE
                cur = nxt.contiguous()
            main[(C, quantized)] = recs
            if quantized:  # the main path's payload
                paths[C] = window_paths(timer, plan, x, phase, n_out,
                                        f"window path int16 {C}ch")
                emit(paths[C])
            del cur, x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    # the narrower copy widths: row pitches (and one address) that 16
    # bytes do not divide
    R, hb = stages[0]
    for C, quantized, offset in ((1002, False, 0), (1004, True, 0),
                                 (333, False, 0), (778, True, 0),
                                 (777, True, 0), (2048, True, 1)):
        x = synthetic_window(6000, C, device, seed=C, quantized=quantized)
        if offset:  # storage starting one element past an aligned address
            flat = torch.empty(x.numel() + offset, dtype=x.dtype,
                               device=device)
            x = flat[offset:].view(x.shape).copy_(x)
        emit(compare_stage(timer, x, hb, R, 700, taps[0],
                           f"width C={C} {'int16' if quantized else 'f32'}"
                           f"{' +1 element' if offset else ''}",
                           with_time=False, row0=-3173))
    # ragged: C not a multiple of 32, T short of (n_out + B) * R
    k = 1001
    T_short = (k + hb.shape[0]) * R - 37
    for quantized in (False, True):
        x = synthetic_window(T_short, 1000, device, seed=7, quantized=quantized)
        emit(compare_stage(timer, x, hb, R, k, taps[0],
                           f"ragged C=1000 T=need-37 "
                           f"{'int16' if quantized else 'f32'}",
                           with_time=False))
    # first rows before, at and after the window's start (the first
    # more than one time tile of outputs before it)
    for row0 in (-3173, -5, 0, 777):
        x = synthetic_window(20000, 1000, device, seed=13, quantized=True)
        emit(compare_stage(timer, x, hb, R, 2400, taps[0],
                           f"row0={row0} int16 C=1000", with_time=False,
                           row0=row0))
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
        out = fir_decimate(z, hb, R, 2400, -3173)
        timer.sync()
        nz = int(torch.count_nonzero(out))
        emit({"case": f"zeros {str(dt).split('.')[-1]}", "nonzero": nz})
        if nz:
            fail(f"all-zero {dt} input gave {nz} nonzero outputs")
    return plan, main, paths


def stages_bound_ms(stages, sizes, T, C, in_bytes):
    """Least time for a stateful step of ``stages`` over T input rows:
    the input read once, the output and the new carry written once, the
    old carry read once; flops over the true taps of every stage.  The
    whole cascade is B3's bound; stages 0-1 and 2-3 are kernel A's and
    kernel B's."""
    flops, rows = 0.0, T
    for R, h in stages:
        rows //= int(R)
        flops += 2.0 * len(h) * rows * C
    by = T * C * in_bytes + rows * C * 4 + 2 * sum(sizes) * C * 4
    t_b, t_o = by / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"),
            bound_at_measured(by, flops))


def cascade_bound_ms(plan, T, C, in_bytes):
    """Least time for one fused step (:func:`stages_bound_ms`)."""
    from tpudas_torch.ops.fir import stream_carry_sizes

    return stages_bound_ms(plan.stages, stream_carry_sizes(plan), T, C,
                           in_bytes)


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
                  with_time=True, k1_sweep=()):
    """B3 (kernels A + B) and the single-kernel step vs the plain
    version over consecutive blocks from one carry: the outputs (stacked
    per channel) and every final carry leaf per-channel within REL_TOL.
    Timed on the first block: the step and the single-kernel step; with
    ``with_time`` also kernels A and B alone (with their bounds), the
    plain version, the per-stage B1 chain, the conv1d chain and kernel
    A at each tile size of ``k1_sweep``."""
    from tpudas_torch.ops.fir import cascade_decimate_stream, stream_carry_sizes
    from tpudas_torch.ops.fused_kernel import (
        fused_cascade,
        fused_cascade_one_kernel,
        fused_cascade_plain,
        fused_stage01,
    )

    sizes = stream_carry_sizes(plan)
    ck = c1 = cp = carry
    ys, y1s, rys = [], [], []
    for x in blocks:
        y, ck = fused_cascade(x, ck, plan.stages, sizes, qscale=qscale)
        y1, c1 = fused_cascade_one_kernel(x, c1, plan.stages, sizes,
                                          qscale=qscale)
        ry, cp = fused_cascade_plain(x, cp, plan.stages, sizes, qscale=qscale)
        ys.append(y)
        y1s.append(y1)
        rys.append(ry)
    y, y1, ry = torch.cat(ys), torch.cat(y1s), torch.cat(rys)
    timer.sync()
    if not bool(torch.isfinite(y).all()):
        fail(f"{label}: fused kernel output not finite")
    rel, abs_err = per_channel_rel(y, ry)
    leaf_rel = [per_channel_rel(a, b)[0] for a, b in zip(ck, cp) if a.numel()]
    one_rel = max([per_channel_rel(y1, ry)[0]] + [
        per_channel_rel(a, b)[0] for a, b in zip(c1, cp) if a.numel()])
    x = blocks[0]
    T, C = x.shape
    bound, bound_by, bound_m = cascade_bound_ms(plan, T, C, x.element_size())
    rec = {"case": label, "T": T, "C": C, "blocks": len(blocks),
           "n_out": T // plan.ratio, "dtype": str(x.dtype).split(".")[-1],
           "max_rel_err": rel, "max_abs_err": abs_err,
           "carry_max_rel_err": max(leaf_rel),
           "one_kernel_max_rel_err": one_rel, "bound_ms": bound,
           "bound_by": bound_by, "bound_ms_measured": bound_m}
    kern = lambda: fused_cascade(x, carry, plan.stages, sizes,  # noqa: E731
                                 qscale=qscale)
    one = lambda: fused_cascade_one_kernel(x, carry, plan.stages,  # noqa: E731
                                           sizes, qscale=qscale)
    if with_time:
        plain = lambda: fused_cascade_plain(x, carry, plan.stages,  # noqa: E731
                                            sizes, qscale=qscale)
        chain = lambda: cascade_decimate_stream(x, carry, plan,  # noqa: E731
                                                "auto", qscale=qscale)
        conv = lambda: conv1d_chain(plan, x, carry, qscale)  # noqa: E731
        rec["conv1d_chain_max_abs_err"] = float((conv() - rys[0]).abs().max())
        # kernel A alone, and kernel B alone on kernel A's output
        a_args = (x, carry[:2], plan.stages[:2], sizes[:2], qscale)
        u, _ = fused_stage01(*a_args)
        b_args = (u, carry[2:], plan.stages[2:], sizes[2:])
        ka = lambda: fused_stage01(*a_args)  # noqa: E731
        kb = lambda: fused_cascade_one_kernel(*b_args)  # noqa: E731
        fns = (kern, one, ka, kb, plain, chain, conv)
        keys = ("ms", "one_kernel_ms", "kernel_a_ms", "kernel_b_ms",
                "plain_ms", "b1_chain_ms", "conv1d_chain_ms")
        for name, st, sz, rows, nb in (
                ("kernel_a", plan.stages[:2], sizes[:2], T, x.element_size()),
                ("kernel_b", plan.stages[2:], sizes[2:], u.shape[0], 4)):
            b_ms, b_by, b_m = stages_bound_ms(st, sz, rows, C, nb)
            rec[name + "_bound_ms"] = b_ms
            rec[name + "_bound_by"] = b_by
            rec[name + "_bound_ms_measured"] = b_m
        if k1_sweep:
            # kernel A at other tile sizes (K_1 stage-1 outputs a tile)
            def at(k1):
                return lambda: fused_stage01(*a_args, k1=k1)
            sweep = timed_turns(timer, [at(k) for k in k1_sweep],
                                [str(k) for k in k1_sweep])
            rec["kernel_a_ms_by_k1"] = {k: sweep[str(k)] for k in k1_sweep}
    else:
        fns, keys = (kern, one), ("ms", "one_kernel_ms")
    rec.update(timed_turns(timer, fns, keys))
    if rel > REL_TOL or max(leaf_rel) > REL_TOL or one_rel > REL_TOL:
        emit(rec)
        fail(f"{label}: fused kernels vs plain per-channel rel err "
             f"{max(rel, one_rel, *leaf_rel):.3e} > {REL_TOL:g}")
    return rec


def timed_turns(timer, fns, keys):
    """Each function timed twice, in turns (forward, then backward):
    ``{key: mean ms, key_turns: [first, second]}``."""
    reps = [timer.reps_for(f) for f in fns]
    first = [timer(f, r) for f, r in zip(fns, reps)]
    second = [timer(f, r) for f, r in zip(fns[::-1], reps[::-1])][::-1]
    rec = {}
    for key, a, b in zip(keys, first, second):
        rec[key] = (a + b) / 2
        rec[key + "_turns"] = [a, b]
    return rec


# kernel A's tile sizes timed beside the default on the main block
K1_SWEEP = (25, 50, 100, 200)


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
                main_case = C == widths[0] and quantized and n == 60
                rec = compare_fused(timer, plan, blocks, carry,
                                    QSCALE if quantized else None, label,
                                    k1_sweep=K1_SWEEP if main_case else ())
                emit(rec)
                main[(C, quantized, n)] = rec
                del blocks, carry
    # ragged: C not a multiple of 32
    blocks, carry = warm_blocks(plan, [8, 8], 1000, device, seed=3,
                                quantized=False)
    emit(compare_fused(timer, plan, blocks, carry, None,
                       "fused ragged C=1000 f32", with_time=False))
    from tpudas_torch.ops.fused_kernel import fused_cascade_one_kernel

    def step_times(fn_args):
        """(ms, one_kernel_ms) of the step and the single-kernel step
        over the same (x, carry, qscale) calls."""
        def run(step):
            return lambda: [step(x, c, plan.stages, sizes, q)
                            for x, c, q in fn_args]
        return timed_turns(timer, (run(fused_cascade),
                                   run(fused_cascade_one_kernel)),
                           ("ms", "one_kernel_ms"))
    # an uneven block sequence through both, carried from zeros:
    # outputs and every carry leaf
    C = 1000
    carry_k = carry_p = cascade_stream_init(plan, C, device)
    ys_k, ys_p, calls = [], [], []
    for i, n in enumerate((50, 13, 1, 27, 40)):
        x = synthetic_window(n * ratio, C, device, seed=20 + i,
                             quantized=True)
        calls.append((x, carry_k, QSCALE))
        y, carry_k = fused_cascade(x, carry_k, plan.stages, sizes, QSCALE)
        yp, carry_p = fused_cascade_plain(x, carry_p, plan.stages, sizes,
                                          QSCALE)
        ys_k.append(y)
        ys_p.append(yp)
    timer.sync()
    rel = per_channel_rel(torch.cat(ys_k), torch.cat(ys_p))[0]
    leaf = [per_channel_rel(a, b)[0] for a, b in zip(carry_k, carry_p)]
    emit({"case": "fused block sequence (50,13,1,27,40) int16 1000ch",
          "max_rel_err": rel, "carry_max_rel_err": leaf,
          **step_times(calls)})
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
           "nan_plain": int(nan_p.sum()), "finite_max_rel_err": err,
           **step_times([(x, carry, None)])}
    emit(rec)
    if not bool(nan_p.any()) or bool((nan_k & ~nan_p).any()):
        fail("NaN gap: the kernel's NaN set is not a subset of the plain "
             "version's")
    if err > REL_TOL:
        fail(f"NaN gap: finite samples differ by {err:.3e}")
    # all-zero input and carry give exact zeros
    for dt in (torch.float32, torch.int16):
        z = torch.zeros((20 * ratio, 777), dtype=dt, device=device)
        z_args = (z, cascade_stream_init(plan, 777, device),
                  QSCALE if dt == torch.int16 else None)
        y, nc = fused_cascade(z_args[0], z_args[1], plan.stages, sizes,
                              z_args[2])
        timer.sync()
        nz = int(torch.count_nonzero(y)) + sum(
            int(torch.count_nonzero(b)) for b in nc)
        emit({"case": f"fused zeros {str(dt).split('.')[-1]}", "nonzero": nz,
              **step_times([z_args])})
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


def lfproc_class(force_tdas=False, base=None):
    """``base`` (default ``LFProc``), or — where h5py is missing (the
    card's host) or a rehearsal asks for the card's path — a subclass
    that writes each output patch as tdas under the same stem."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.proc.lfproc import LFProc

    base = base or LFProc
    if importlib.util.find_spec("h5py") is not None and not force_tdas:
        return base

    class TdasOutput(base):
        """Writes each output patch as tdas under the same stem."""

        def _write_output(self, patch, path):
            write_tdas(patch, os.path.splitext(path)[0] + ".tdas")

    TdasOutput.__name__ = f"TdasOutput{base.__name__}"
    return TdasOutput


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


# phase 4's runs in turns: the native assembler with pinned staging, and
# the numpy reader without staging (the host read's speed differs
# between calls, so the two are compared inside one call)
INGEST_MODES = {
    "staged": {},
    "serial": {"TPUDAS_NO_NATIVE": "1", "TPUDAS_H2D_STAGE": "0"},
}
INGEST_ORDER = ("staged", "serial", "serial", "staged")
WINDOW_SECONDS = 60  # process_patch_size x output_sample_interval


def same_files(a, b):
    """Names of the output files of ``a`` and ``b`` whose bytes differ
    (or that only one has)."""
    import filecmp

    na = sorted(n for n in os.listdir(a) if not n.startswith("."))
    nb = sorted(n for n in os.listdir(b) if not n.startswith("."))
    if na != nb:
        return sorted(set(na) ^ set(nb))
    return [n for n in na if not filecmp.cmp(os.path.join(a, n),
                                             os.path.join(b, n),
                                             shallow=False)]


def phase_main_path(device, n_ch, seconds, workdir, cls):
    """Phase 4: the batch path, run four times in turns (``INGEST_ORDER``):
    the native assembler with pinned staging, and the numpy reader
    without staging.  The first run is the main path.  Leaves its spool
    (``workdir/src``) and the first run's output (``workdir/out``) for
    the later phases."""
    from tpudas_torch.ops import fir as fir_mod
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.proc import lfproc as lfproc_mod
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
    cuda = device.type == "cuda"
    # the kernel path reads each window from its first row: it makes no
    # shifted or padded copy (shift_to_phase is the plain path's step);
    # the loader's own read time is summed beside the consumer's wait
    shifts, load_s = [], [0.0]
    plain_shift = fir_mod.shift_to_phase
    plain_load = lfproc_mod.LFProc._load_window

    def timed_load(self, *a, **k):
        t_l = time.perf_counter()
        try:
            return plain_load(self, *a, **k)
        finally:
            load_s[0] += time.perf_counter() - t_l

    fir_mod.shift_to_phase = lambda *a: shifts.append(a[1]) or plain_shift(*a)
    lfproc_mod.LFProc._load_window = timed_load
    runs = []
    try:
        for i, mode in enumerate(INGEST_ORDER):
            out_i = out if i == 0 else os.path.join(workdir, f"out{i}_{mode}")
            shifts.clear()
            load_s[0] = 0.0
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            fir_decimate.launches = 0
            fir_decimate.launches_by_width = dict.fromkeys(
                fir_decimate.launches_by_width, 0)
            with mock.patch.dict(os.environ, INGEST_MODES[mode]):
                lfp, wall, wins, expect_stems = run_lfproc(device, cls, src,
                                                           out_i)
            peak = torch.cuda.max_memory_allocated() if cuda else None
            windows = sum(lfp.engine_counts.values())
            runs.append({
                "mode": mode, "out": out_i, "wall_s": wall,
                "assemble_wait_s": lfp.timings["assemble_s"],
                "load_s": load_s[0], "device_s": lfp.timings["device_s"],
                "write_s": lfp.timings["write_s"],
                "realtime_factor": n_files * file_sec / wall,
                "windows": windows, "native_windows": lfp.native_windows,
                "staged_windows": lfp.staged_windows,
                "quantized_windows": lfp.quantized_windows,
                "engine_counts": dict(lfp.engine_counts),
                "fir_decimate_launches": fir_decimate.launches,
                "fir_decimate_launches_by_width":
                    dict(fir_decimate.launches_by_width),
                "shift_to_phase_calls": len(shifts),
                "peak_device_bytes": peak,
                # in get_patch_time's terms: peak bytes over one window's
                # samples x 8 bytes_per_element
                "processing_factor": (
                    None if peak is None else
                    peak / (WINDOW_SECONDS * 1000.0 * n_ch * 8)),
            })
    finally:
        fir_mod.shift_to_phase = plain_shift
        lfproc_mod.LFProc._load_window = plain_load
    first = runs[0]
    expect_windows = len(wins)
    windows = first["windows"]
    p, names = grid_checks(out, "main path")
    resid, amp_err = lf_fit(p, bg)
    differ = {r["mode"] + str(i): same_files(out, r["out"])
              for i, r in enumerate(runs) if i}

    def mean(mode, key):
        vals = [r[key] for r in runs if r["mode"] == mode]
        return sum(vals) / len(vals)

    res = {
        "phase": "main_path", "channels": n_ch, "seconds": n_files * file_sec,
        "fs": 1000.0, "payload": "int16 tdas", "setup_s": setup_s,
        "output_format": ("tdas (no h5py)" if cls.__name__ != "LFProc"
                          else "dasdae"),
        "windows": windows, "expected_windows": expect_windows,
        "engine_counts": first["engine_counts"],
        "quantized_windows": first["quantized_windows"],
        "native_windows": first["native_windows"],
        "staged_windows": first["staged_windows"],
        "fir_decimate_launches": first["fir_decimate_launches"],
        "fir_decimate_launches_by_width":
            first["fir_decimate_launches_by_width"],
        "shift_to_phase_calls": first["shift_to_phase_calls"],
        "wall_s": first["wall_s"],
        "s_per_window": first["wall_s"] / max(windows, 1),
        "timings": {"assemble_s": first["assemble_wait_s"],
                    "device_s": first["device_s"],
                    "write_s": first["write_s"]},
        "realtime_factor": first["realtime_factor"],
        "runs": [{k: v for k, v in r.items() if k != "out"} for r in runs],
        "mean": {m: {k: mean(m, k) for k in
                     ("wall_s", "assemble_wait_s", "load_s", "device_s",
                      "write_s", "realtime_factor")} for m in INGEST_MODES},
        "outputs_differing_from_first_run": differ,
        "outputs": len(names), "output_rows": int(p.host_data().shape[0]),
        "lf_fit_max_resid": resid, "lf_amp_max_rel_err": amp_err,
    }
    emit(res)
    if cls.__name__ != "LFProc":
        print("main path: outputs were written as tdas under the LFDAS_ "
              "stem (no h5py on this host, or a rehearsal)", flush=True)
    ran = "cascade-cuda" if cuda else "cascade-torch"
    checks = [
        (windows == expect_windows, "window count"),
        ([os.path.splitext(n)[0] for n in names] == expect_stems,
         "output names follow the window schedule"),
        (int(p.host_data().shape[0]) == wins[-1][3] - wins[0][2],
         "output rows cover the schedule"),
        (resid < 0.01, "LF fit residual < 0.01"),
        (amp_err < 0.01, "LF amplitude error < 0.01"),
        (all(not d for d in differ.values()),
         f"every run's outputs byte-identical to the first run's: {differ}"),
    ]
    for r in runs:
        m, n = r["mode"], r["windows"]
        staged = m == "staged"
        want = 4 * n if cuda else 0
        checks += [
            (n == expect_windows, f"{m}: window count {n}"),
            (r["engine_counts"][ran] == n, f"{m}: every window ran {ran}"),
            (r["quantized_windows"] == n, f"{m}: every window shipped int16"),
            (r["fir_decimate_launches"] == want,
             f"{m}: launches {r['fir_decimate_launches']} != {want}"),
            (r["shift_to_phase_calls"] == (0 if cuda else n),
             f"{m}: shift_to_phase ran {r['shift_to_phase_calls']} times"),
            (r["native_windows"] == (n if staged else 0),
             f"{m}: native_windows {r['native_windows']}"),
            (r["staged_windows"] == (n if staged else 0),
             f"{m}: staged_windows {r['staged_windows']}"),
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
            "timings": {}, "counters": None, "events": [],
            "native_windows": 0}


def link_files(src_all, src, upto):
    """Hard-link the first ``upto`` data files of ``src_all`` into
    ``src`` (not the spool's index cache)."""
    os.makedirs(src, exist_ok=True)
    names = sorted(n for n in os.listdir(src_all) if n.endswith(".tdas"))
    for name in names[:upto]:
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
        run["native_windows"] += lfp.native_windows
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
        fused_cascade.launches = fused_cascade.kernel_launches = 0
        fir_decimate.launches = 0
        r1 = drive(fused, src_f, out_f, "fused")
        carry_saved = os.path.isfile(os.path.join(out_f, CARRY_FILENAME))
        resumes_1 = sum(e["event"] == "stream_resume" for e in fused["events"])
        link(src_f, 3)
        r2 = drive(fused, src_f, out_f, "fused")
        fused_launches = fused_cascade.launches
        fused_kernel_launches = fused_cascade.kernel_launches
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
                  "fused_cascade_kernel_launches": fused_kernel_launches,
                  "fir_decimate_launches": fused_fir_launches,
                  "wall_s": fused["wall_s"], "timings": fused["timings"],
                  "realtime_factor": ctr.realtime_factor,
                  "head_lag_s": rounds[-1]["head_lag_seconds"] if rounds
                  else None,
                  "native_windows": fused["native_windows"],
                  "outputs": len(names_f)},
        "control": {"rounds": ctrl["rounds"], "blocks": ctrl["blocks"],
                    "fir_decimate_launches": ctrl_launches,
                    "fused_cascade_launches": ctrl_fused_launches,
                    "wall_s": ctrl["wall_s"], "timings": ctrl["timings"],
                    "native_windows": ctrl["native_windows"],
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
        (fused_kernel_launches == (2 * n_fused if cuda else 0),
         f"fused kernels A+B launches {fused_kernel_launches} != "
         f"2 x {n_fused}"),
        (fused_fir_launches == 0, "the fused run launched no per-stage kernel"),
        (set(ctrl["blocks"]) == {chain_eng} and n_ctrl > 0,
         f"every control block ran {chain_eng}"),
        (ctrl_launches == (4 * n_ctrl if cuda else 0),
         f"control fir_decimate launches {ctrl_launches} != 4 x {n_ctrl}"),
        (ctrl_fused_launches == 0, "the control launched no fused kernel"),
        (fused["native_windows"] > 0 and ctrl["native_windows"] > 0,
         "the stream read its slices through the native assembler"),
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


ROLLING_SECONDS = 1.0  # window and step: rolling_mean_dascore's geometry


def phase_joint(device, workdir, cls):
    """Phase 7: ``JointProc`` over phase 4's spool — the LF product and
    a 1 s trailing mean at a 1 s step from one ingest pass.  The LF
    files must be byte-identical to phase 4's first run; the rolling
    files must merge into one patch on the ``bg + k * 1 s`` grid and
    equal a float64 numpy trailing mean of the same int16 input within
    1e-6 of each channel's scale."""
    from tpudas_torch.io.spool import spool
    from tpudas_torch.io.tdas import assemble_window_patch
    from tpudas_torch.ops.fir_kernel import fir_decimate

    src = os.path.join(workdir, "src")
    jdir = os.path.join(workdir, "joint")
    lf_out, roll_out = os.path.join(jdir, "lf"), os.path.join(jdir, "roll")
    bg = np.datetime64(T0, "ns")
    ed = bg + np.timedelta64(int(MAIN_PATH_SECONDS), "s")
    cuda = device.type == "cuda"
    fir_decimate.launches = 0
    lfp = cls(spool(src).sort("time").update(), device=device)
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=60, edge_buff_size=10,
        rolling_window=ROLLING_SECONDS, rolling_step=ROLLING_SECONDS)
    lfp.set_output_folder(lf_out, delete_existing=True)
    lfp.set_rolling_output_folder(roll_out, delete_existing=True)
    t0 = time.perf_counter()
    lfp.process_time_range(bg, ed)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fir_decimate.launches
    windows = sum(lfp.engine_counts.values())
    differ = same_files(os.path.join(workdir, "out"), lf_out)
    p_lf, _ = grid_checks(lf_out, "joint LF product")
    p, names = grid_checks(roll_out, "rolling product")
    times = p.coords["time"].astype("datetime64[ns]")
    off_ns = (times - bg).astype(np.int64)
    on_grid = bool(np.all(off_ns % int(ROLLING_SECONDS * 1e9) == 0))
    # the float64 reference from the raw int16 payload of the whole spool
    plan = spool(src).update().window_plan(bg, ed)
    raw = assemble_window_patch(plan)
    x = raw.host_data()
    step_ns = int(plan["dt_ns"])
    w = int(round(ROLLING_SECONDS * 1e9 / step_ns))
    idx = ((times - raw.coords["time"][0].astype("datetime64[ns]"))
           .astype(np.int64) // step_ns)
    qscale = float(raw.attrs["data_scale"])
    ref = np.stack([x[i - w + 1 : i + 1].sum(axis=0, dtype=np.float64)
                    for i in idx]) / w * qscale
    got = p.host_data().astype(np.float64)
    scale = np.abs(ref).max(axis=0)
    rel = float((np.abs(got - ref).max(axis=0) / scale).max())
    del raw, x
    res = {
        "phase": "joint", "channels": int(got.shape[1]),
        "rolling_window_s": ROLLING_SECONDS, "rolling_step_s": ROLLING_SECONDS,
        "windows": windows, "rolling_windows": lfp.rolling_windows,
        "native_windows": lfp.native_windows,
        "staged_windows": lfp.staged_windows,
        "fir_decimate_launches": launches, "wall_s": wall,
        "timings": lfp.timings,
        "realtime_factor": MAIN_PATH_SECONDS / wall,
        "rolling_samples": int(got.shape[0]), "rolling_files": len(names),
        "lf_outputs_differing_from_phase4": differ,
        "rolling_vs_float64_max_rel_err": rel,
    }
    emit(res)
    checks = [
        (not differ, f"LF output differs from phase 4's: {differ}"),
        (lfp.rolling_windows == windows == 4,
         f"{lfp.rolling_windows} rolling files for {windows} windows"),
        (lfp.staged_windows == windows and lfp.native_windows == windows,
         "every window read natively and staged"),
        (launches == (4 * windows if cuda else 0), f"launches {launches}"),
        (on_grid, "rolling samples off the bg + k * step grid"),
        (np.array_equal(times, p_lf.coords["time"].astype("datetime64[ns]")),
         f"{got.shape[0]} rolling samples not at the LF product's times"),
        (rel <= 1e-6, f"rolling vs float64 reference {rel:.3e} > 1e-6"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"joint check failed: {what}")
    return res


# phase 8: four streams read phase 4's spool, each its own channel range
# (a ``distance`` selection), for ragged widths whose odd sizes put the
# members at packed offsets where B1's copy width differs from solo
FLEET_MEMBERS = (("a", 0, 10000), ("b", 1, 6001), ("c", 3, 2500),
                 ("d", 7, 1499))  # 20,000 channels packed
REHEARSE_MEMBERS = (("a", 0, 32), ("b", 1, 17), ("c", 3, 9), ("d", 7, 6))
D_CH = 5.0  # the synthetic spool's channel spacing (m)


def fleet_specs(fdir, src_all, members, tag, engine, upto):
    """The members' specs, each over its own source folder of hard links
    to the first ``upto`` files of ``src_all``."""
    from tpudas_torch.fleet import StreamConfig, StreamSpec

    specs = []
    for sid, c0, w in members:
        src = os.path.join(fdir, f"src_{tag}_{sid}")
        link_files(src_all, src, upto)
        specs.append(StreamSpec(stream_id=sid, source=src, config=StreamConfig(
            kind="lowpass", start_time=T0, output_sample_interval=1.0,
            edge_buffer=10.0, process_patch_size=60, poll_interval=0.0,
            poll_jitter=0.0, engine=engine, stateful=True,
            distance=(c0 * D_CH, (c0 + w - 1) * D_CH))))
    return specs


def kernel_counts():
    """The kernel wrappers' launch counts and the stacked step's."""
    from tpudas_torch.ops.fir import cascade_decimate_stream_stacked
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    return {"b3_steps": fused_cascade.launches,
            "b3_kernels": fused_cascade.kernel_launches,
            "b1": fir_decimate.launches,
            "stacked": {f"{e}@{c}": n for (e, c), n in
                        cascade_decimate_stream_stacked.launches.items()}}


def zero_kernel_counts():
    from tpudas_torch.ops.fir import cascade_decimate_stream_stacked
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    fused_cascade.launches = fused_cascade.kernel_launches = 0
    fir_decimate.launches = 0
    cascade_decimate_stream_stacked.launches.clear()


def _run_wave_unstacked(ex, key, pend):
    """A stacked wave's members run one by one, for the leg that keeps
    the batched fleet's threads and rendezvous and takes the packing
    away."""
    return [ex._run_solo(key, p) for p in pend]


def fleet_leg(device, fdir, src_all, members, tag, engine, calls, batched,
              unstacked=False):
    """One fleet over ``calls`` (file counts; a new ``FleetEngine`` each,
    resuming every member from its carry), or with ``batched=None`` each
    member alone (``drive(build_runner(...))``, the same calls).  With
    ``unstacked`` the batched fleet runs every wave's members solo.
    Kernel counts are set to 0 just before and read just after."""
    from tpudas_torch.fleet import FleetEngine, build_runner, drive
    from tpudas_torch.fleet.batch import BatchStepExecutor
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry

    root = os.path.join(fdir, tag)
    blocks, data_s, walls, timings = {}, [0.0], [], {}

    def on_round(sid, _rnd, lfp):
        for k, v in lfp.stream_blocks.items():
            blocks.setdefault(sid, {})
            blocks[sid][k] = blocks[sid].get(k, 0) + v
        for k, v in lfp.timings.items():
            timings[k] = timings.get(k, 0.0) + v

    cuda = device.type == "cuda"
    reg = MetricsRegistry()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    summaries = []
    waves = (mock.patch.object(BatchStepExecutor, "_run_stacked",
                               _run_wave_unstacked) if unstacked
             else contextlib.nullcontext())
    with use_registry(reg), waves:
        for upto in calls:
            specs = fleet_specs(fdir, src_all, members, tag, engine, upto)
            t0 = time.perf_counter()
            if batched is None:
                runners = []
                for spec in specs:
                    sid = str(spec.stream_id)
                    r = build_runner(spec, root=root, device=device,
                                     on_round=lambda rnd, lfp, sid=sid:
                                     on_round(sid, rnd, lfp))
                    drive(r, sleep_fn=lambda _s: None)
                    runners.append(r)
            else:
                eng = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                                  batched=batched, device=device,
                                  on_round=on_round)
                summaries.append(eng.run())
                runners = [s.runner for s in eng.streams.values()]
            if cuda:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            data_s[0] += sum(r.counters.data_seconds for r in runners)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    wall = sum(walls)
    return root, {
        "calls": len(calls), "unstacked": unstacked, "wall_s": wall,
        "walls_s": walls,
        "member_data_s": data_s[0],
        "realtime_factor": data_s[0] / wall if wall else None,
        "blocks": blocks,
        # summed over the members, whose rounds overlap when batched
        "member_timings": timings,
        "member_blocks": sum(sum(b.values()) for b in blocks.values()),
        "kernel_counts": counts,
        "stacked_launches": reg.value(
            "tpudas_fleet_batch_stacked_launches_total"),
        "stacked_members": reg.value(
            "tpudas_fleet_batch_stacked_members_total"),
        "solo_launches": reg.value("tpudas_fleet_batch_solo_launches_total"),
        "groups": reg.value("tpudas_fleet_batch_groups_total"),
        "parked": sorted({p for s in summaries for p in s["parked"]}),
        "peak_device_bytes": peak,
    }


def member_diff(a, b):
    """Output files and the carry of two member folders whose bytes
    differ (or that only one has)."""
    import filecmp

    from tpudas_torch.proc.stream import CARRY_FILENAME

    def names(d):
        return sorted(n for n in os.listdir(d)
                      if n.startswith("LFDAS_") or n == CARRY_FILENAME)

    na, nb = names(a), names(b)
    if na != nb or CARRY_FILENAME not in na or len(na) < 2:
        return sorted(set(na) ^ set(nb)) or ["no outputs"]
    return [n for n in na if not filecmp.cmp(os.path.join(a, n),
                                             os.path.join(b, n),
                                             shallow=False)]


def fleet_step_timing(timer, members, device):
    """One 60-output int16 stream block per member at its own width, from
    the same carry: the stacked steps on the packed block (B3 and the B1
    chain) byte-equal to each member's solo step; the packed B3 step
    (kernels A + B) timed with events against the sum of the members'
    solo steps, and the stacked step with its packing and slicing."""
    from tpudas_torch.ops.fir import (
        _stream_step,
        cascade_decimate_stream,
        cascade_decimate_stream_stacked,
        design_cascade,
        stream_carry_sizes,
    )
    from tpudas_torch.ops.fused_kernel import fused_cascade

    plan = design_cascade(1000.0, 1000, 0.45)
    sizes = stream_carry_sizes(plan)
    widths = [w for _sid, _c0, w in members]
    C = sum(widths)
    warm = [warm_blocks(plan, (60,), w, device, 80 + i, True)
            for i, w in enumerate(widths)]
    blocks = [b[0][0] for b in warm]
    carries = [b[1] for b in warm]
    rec = {"channels": C, "widths": widths, "rows": int(blocks[0].shape[0])}
    engines = ("fused-cuda", "cuda") if device.type == "cuda" else (
        "fused-torch", "torch")
    for eng in engines:
        res = cascade_decimate_stream_stacked(blocks, carries, plan, eng,
                                              qscale=QSCALE)
        differ = []
        for i, (b, c) in enumerate(zip(blocks, carries)):
            y, new = cascade_decimate_stream(b, c, plan, eng, qscale=QSCALE)
            if not (torch.equal(y, res[i][0]) and all(
                    torch.equal(u, v) for u, v in zip(new, res[i][1]))):
                differ.append(widths[i])
        rec[f"{eng}_stacked_differs_at_widths"] = differ
        del res
    packed = torch.cat(blocks, dim=1).contiguous()
    pc = tuple(torch.cat([c[i] for c in carries], dim=1).contiguous()
               for i in range(len(sizes)))
    step = fused_cascade if device.type == "cuda" else None
    if step is not None:
        def packed_b3():
            return step(packed, pc, plan.stages, sizes, qscale=QSCALE)

        reps = timer.reps_for(packed_b3)
        rec["b3_packed_ms"] = timer(packed_b3, reps)
        rec["b3_solo_ms"] = [
            timer(lambda b=b, c=c: step(b, c, plan.stages, sizes,
                                        qscale=QSCALE), reps)
            for b, c in zip(blocks, carries)]
        rec["b3_solo_sum_ms"] = sum(rec["b3_solo_ms"])
        rec["b3_stacked_op_ms"] = timer(
            lambda: cascade_decimate_stream_stacked(
                blocks, carries, plan, "fused-cuda", qscale=QSCALE), reps)
        rec["b1_chain_packed_ms"] = timer(
            lambda: _stream_step(packed, pc, plan, "cuda", QSCALE), reps)
        rec["b1_chain_solo_sum_ms"] = sum(
            timer(lambda b=b, c=c: _stream_step(b, c, plan, "cuda", QSCALE),
                  reps) for b, c in zip(blocks, carries))
        rec["b3_packed_bound_ms"], rec["b3_packed_bound_by"], \
            rec["b3_packed_bound_ms_measured"] = cascade_bound_ms(
                plan, int(packed.shape[0]), C, 2)
    del packed, pc, blocks, carries, warm
    return rec


def fft_packed_transform(timer, members, device):
    """The FFT stream step's transform over one packed [carry; block]
    (20,000 ch at the flagship's edge) against each member's transform
    at its own width: whether the bits agree, the largest difference,
    and both times.  The port's stacked step runs the per-member form."""
    from tpudas_torch.ops.filter import _filter_rows
    from tpudas_torch.proc.lfproc import output_corner

    widths = [w for _sid, _c0, w in members]
    rows = 80000 if device.type == "cuda" else 8000  # 2 x edge + 60 s
    x = synthetic_window(rows, sum(widths), device, 90, False)
    corner = output_corner(1.0)
    packed = _filter_rows(x, 1e-3, None, corner, 4)
    differ, max_abs = [], 0.0
    o = 0
    for w in widths:
        m = _filter_rows(x[:, o:o + w].contiguous(), 1e-3, None, corner, 4)
        if not torch.equal(m, packed[:, o:o + w]):
            differ.append(w)
        max_abs = max(max_abs, float((m - packed[:, o:o + w]).abs().max()))
        o += w
    del packed
    parts = [x[:, o:o + w].contiguous() for o, w in
             zip(np.cumsum([0] + widths[:-1]), widths)]
    rec = {"rows": rows, "channels": sum(widths),
           "packed_differs_at_widths": differ,
           "packed_max_abs_diff": max_abs}
    rec["packed_ms"] = timer(lambda: _filter_rows(x, 1e-3, None, corner, 4),
                             3)
    rec["per_member_ms"] = timer(
        lambda: [_filter_rows(p, 1e-3, None, corner, 4) for p in parts], 3)
    del x, parts
    return rec


def phase_fleet(device, workdir, cls, members, timer):
    """Phase 8: the multi-array fleet over phase 4's spool.  Four streams
    of ragged widths (20,000 ch packed), ``poll_jitter=0`` and a no-op
    sleep, so the backlog forms batch groups (the drain regime).  (a)
    ``engine="fused"`` batched over files 1-2, then a second fleet that
    resumes every member over file 3; (b) ``engine="auto"`` batched over
    files 1-2; (c) ``engine="fft"`` batched over file 1.  Each member's
    output files and carry must equal its solo control (the same calls
    of ``drive(build_runner(...))``) byte for byte, and the unbatched
    fleet's; each leg runs batched, solo, unbatched, batched again, so
    the walls come in turns; (a) must launch B3 and (b) the B1 chain on the
    packed block, fewer steps than member blocks, and (c) transforms
    every member at its own width (no stacked launch).  (a) also runs
    the batched fleet with every wave unstacked (its members' steps one
    by one), between the unbatched fleet and the second batched run, to
    separate what packing saves from what the member threads overlap.
    Then one packed 60-output B3 step timed against its members' solo
    steps, and the FFT's packed transform against the per-member one."""
    from tpudas_torch.fleet import engine as fleet_engine

    src_all = os.path.join(workdir, "src")
    fdir = os.path.join(workdir, "fleet")
    shutil.rmtree(fdir, ignore_errors=True)
    cuda = device.type == "cuda"
    # the fft leg over file 1 alone (60 s; 120 s before phase 10 came):
    # the full run keeps within its time
    legs = {"fused": (2, 3), "auto": (2,), "fft": (1,)}
    res, checks = {}, []
    saved_cls = fleet_engine.LFProc
    fleet_engine.LFProc = cls
    try:
        for engine, calls in legs.items():
            root_b, rb = fleet_leg(device, fdir, src_all, members,
                                   f"{engine}_batched", engine, calls, True)
            root_c, rc = fleet_leg(device, fdir, src_all, members,
                                   f"{engine}_control", engine, calls, None)
            leg = {"batched": rb, "control": rc}
            vs_ctrl = {sid: member_diff(os.path.join(root_b, sid),
                                        os.path.join(root_c, sid))
                       for sid, _c0, _w in members}
            leg["differs_from_control"] = vs_ctrl
            checks += [
                (not any(vs_ctrl.values()),
                 f"({engine}) members differ from solo controls: {vs_ctrl}"),
                (rb["parked"] == [], f"({engine}) parked {rb['parked']}"),
            ]
            if engine == "fft":
                fft_blocks = sum(v.get("fft", 0)
                                 for v in rb["blocks"].values())
                checks.append((
                    rb["groups"] >= 1 and rb["stacked_launches"] == 0
                    and 0 < rb["solo_launches"] <= fft_blocks,
                    f"(fft) groups {rb['groups']}, stacked "
                    f"{rb['stacked_launches']}, solo {rb['solo_launches']} "
                    f"of {fft_blocks} member blocks"))
            else:
                checks.append((rb["stacked_launches"] >= 1
                               and rb["groups"] >= 1,
                               f"({engine}) no stacked launch"))
            root_u, ru = fleet_leg(device, fdir, src_all, members,
                                   f"{engine}_unbatched", engine, calls,
                                   False)
            leg["unbatched"] = ru
            vs_u = {sid: member_diff(os.path.join(root_b, sid),
                                     os.path.join(root_u, sid))
                    for sid, _c0, _w in members}
            leg["differs_from_unbatched"] = vs_u
            checks.append((not any(vs_u.values()),
                           f"({engine}) batched differs from unbatched: "
                           f"{vs_u}"))
            if engine == "fused":
                root_s, rs = fleet_leg(device, fdir, src_all, members,
                                       f"{engine}_unstacked", engine, calls,
                                       True, unstacked=True)
                leg["unstacked"] = rs
                vs_s = {sid: member_diff(os.path.join(root_s, sid),
                                         os.path.join(root_c, sid))
                        for sid, _c0, _w in members}
                leg["unstacked_differs_from_control"] = vs_s
                checks.append((not any(vs_s.values()),
                               f"({engine}) unstacked batched run differs "
                               f"from solo controls: {vs_s}"))
            # batched again, so the walls come in turns: B, solo, U,
            # (fused: unstacked,) B
            root_a, ra = fleet_leg(device, fdir, src_all, members,
                                   f"{engine}_batched_again", engine, calls,
                                   True)
            leg["batched_again"] = ra
            vs_a = {sid: member_diff(os.path.join(root_a, sid),
                                     os.path.join(root_c, sid))
                    for sid, _c0, _w in members}
            checks.append((not any(vs_a.values()),
                           f"({engine}) second batched run differs from "
                           f"solo controls: {vs_a}"))
            res[engine] = leg
    finally:
        fleet_engine.LFProc = saved_cls
    C = sum(w for _sid, _c0, w in members)
    a, b = res["fused"]["batched"], res["auto"]["batched"]
    s = res["fused"]["unstacked"]
    fused_blocks = sum(v.get("fused-cuda" if cuda else "fused-torch", 0)
                       for v in a["blocks"].values())
    chain_blocks = sum(v.get("cascade-cuda" if cuda else "cascade-torch", 0)
                       for v in b["blocks"].values())
    if cuda:
        ka, kb = a["kernel_counts"], b["kernel_counts"]
        checks += [
            (ka["stacked"].get(f"fused-cuda@{C}", 0) >= 1,
             f"(fused) no stacked B3 step over {C} ch: {ka['stacked']}"),
            (0 < ka["b3_steps"] < fused_blocks,
             f"(fused) B3 steps {ka['b3_steps']} not fewer than member "
             f"blocks {fused_blocks}"),
            (kb["stacked"].get(f"cuda@{C}", 0) >= 1,
             f"(auto) no stacked B1 chain over {C} ch: {kb['stacked']}"),
            (0 < kb["b1"] < 4 * chain_blocks and kb["b1"] % 4 == 0,
             f"(auto) B1 launches {kb['b1']} vs 4 x {chain_blocks} member "
             "blocks"),
            (kb["b3_steps"] == 0, "(auto) launched B3"),
            (not s["kernel_counts"]["stacked"],
             f"(fused, unstacked) stacked steps {s['kernel_counts']}"),
        ]
    steps = fleet_step_timing(timer, members, device)
    checks += [(not steps[k], f"stacked step differs: {k} {steps[k]}")
               for k in steps if k.endswith("differs_at_widths")]
    fft_t = fft_packed_transform(timer, members, device)
    rec = {"phase": "fleet", "members": [list(m) for m in members],
           "channels": C, "payload": "int16 tdas", "legs": res,
           "fused_member_blocks": fused_blocks,
           "auto_member_blocks": chain_blocks,
           "packed_step": steps, "fft_transform": fft_t}
    emit(rec)
    for ok, what in checks:
        if not ok:
            fail(f"fleet check failed: {what}")
    return rec


# phase 9: the real-time derived products.  Thresholds for which the
# flagship spool's 1 Hz LF stream yields events: at the stream's start
# the LTA and the RMS baseline (EMAs from zero) are still low, which
# lifts the ratios above the values the stationary 0.05 Hz sine reaches
# later (STA/LTA 2.2 in the first cycle after the warm-up, at most 1.93
# after it; RMS about 1.33), so each channel triggers there and nowhere
# else
DETECT_OPS = [
    ("stalta", {"sta": 2.0, "lta": 20.0, "on": 2.05, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 1.0, "thresh": 1.65,
             "baseline": 20.0}),
]


def detect_sig(out):
    """(ledger bytes sha, carry content sha, scores content sha) — the
    crash-equivalence key of tests/test_detect.py (the carry compared
    by parsed content: the npz container embeds zip timestamps)."""
    import hashlib

    from tpudas_torch.detect.ledger import ScoreStore
    from tpudas_torch.detect.runner import load_detect_carry

    with open(os.path.join(out, ".detect", "events.jsonl"), "rb") as fh:
        ledger = hashlib.sha256(fh.read()).hexdigest()
    carry = load_detect_carry(out)
    if carry is None:
        fail(f"no detect carry in {out}")
    h = hashlib.sha256()
    h.update(json.dumps(carry["meta"], sort_keys=True).encode())
    for st in carry["states"]:
        for key in sorted(st):
            arr = np.asarray(st[key])
            h.update(key.encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    t, v = ScoreStore.open(out).read()
    return (ledger, h.hexdigest(),
            hashlib.sha256(t.tobytes() + v.tobytes()).hexdigest())


def round_walls(run):
    """(sum of the rounds' processing walls, sum of their detect walls)
    from a run's ``realtime_round`` events."""
    rounds = [e for e in run["events"] if e["event"] == "realtime_round"]
    return (sum(e["wall_seconds"] for e in rounds),
            sum(e.get("detect_seconds") or 0.0 for e in rounds))


def ev_key(ev):
    return (ev["t_end_ns"], ev["op"], ev["channel"], ev["t_ns"],
            ev["t_peak_ns"])


def detect_on_cpu(out, ledger_events):
    """Phase 9a's cross-check: the control's emitted rows (its merged
    output files) through fresh operators on the CPU, held to what the
    card's pipeline committed: the same events (STA/LTA scores and
    state byte-equal; RMS within 1e-6 of the max)."""
    from tpudas_torch.detect.ledger import ScoreStore
    from tpudas_torch.detect.operators import make_operator
    from tpudas_torch.detect.runner import load_detect_carry
    from tpudas_torch.io.spool import spool

    p = spool(out).update().chunk(time=None)[0]
    rows = np.ascontiguousarray(p.host_data(), np.float32)
    t_ns = p.coords["time"].astype("datetime64[ns]").astype(np.int64)
    states = load_detect_carry(out)["states"]
    res = {}
    for (name, params), st_card in zip(DETECT_OPS, states):
        op = make_operator((name, params), device="cpu")
        got, st = op.process(rows, t_ns, 1_000_000_000,
                             op.init_state(rows.shape[1], 1_000_000_000))
        card = sorted((e for e in ledger_events if e["op"] == name),
                      key=ev_key)
        cpu = sorted(got.events, key=ev_key)
        same_keys = [ev_key(e) for e in card] == [ev_key(e) for e in cpu]
        if name == "stalta":
            score_err = 0.0 if [e["score"] for e in card] == [
                e["score"] for e in cpu] else float("inf")
            state_err = 0.0 if all(
                np.asarray(st[k]).tobytes() == np.asarray(st_card[k]).tobytes()
                for k in st) else float("inf")
        else:
            score_err = max((abs(a["score"] - b["score"]) / abs(b["score"])
                             for a, b in zip(card, cpu)), default=0.0)
            _t, v = ScoreStore.open(out).read()
            state_err = max(
                float(np.nanmax(np.abs(v - got.scores))
                      / np.nanmax(np.abs(got.scores))),
                float(np.abs(st["base"] - st_card["base"]).max()
                      / np.abs(st["base"]).max()),
                0.0 if (int(st["row_idx"]) == int(st_card["row_idx"])
                        and int(st["bwarm"]) == int(st_card["bwarm"]))
                else float("inf"))
        res[name] = {"events": len(cpu), "same_events": same_keys,
                     "score_max_rel_err": score_err,
                     "state_or_scores_max_rel_err": state_err}
    return res


def write_rolling_tdas(patch, path):
    from tpudas_torch.io.tdas import write_tdas

    write_tdas(patch, os.path.splitext(path)[0] + ".tdas")


def phase_detect_fused(device, workdir, ddir):
    """Phase 9a: ``run_lowpass_realtime(engine="fused", detect=True)``
    fed as phase 5 feeds (files 1-2, then a resumed call over file 3)
    beside an uninterrupted control; the ledger, carry and scores of
    the two equal; the rows re-run on the CPU give the same events."""
    from tpudas_torch.detect.ledger import ScoreStore, load_events
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    src_all = os.path.join(workdir, "src")
    cuda = device.type == "cuda"
    kw = dict(detect=True, detect_operators=DETECT_OPS)
    run, ctrl = new_run(), new_run()
    src_r, out_r = os.path.join(ddir, "src_resumed"), os.path.join(
        ddir, "resumed")
    link_files(src_all, src_r, 2)
    zero_kernel_counts()
    r1 = drive_realtime(run, src_all, src_r, out_r, "fused", device, **kw)
    link_files(src_all, src_r, 3)
    r2 = drive_realtime(run, src_all, src_r, out_r, "fused", device, **kw)
    b3, b3_kernels = fused_cascade.launches, fused_cascade.kernel_launches
    b1 = fir_decimate.launches
    src_c, out_c = os.path.join(ddir, "src_ctrl"), os.path.join(ddir, "ctrl")
    link_files(src_all, src_c, 2)
    rc = drive_realtime(ctrl, src_all, src_c, out_c, "fused", device,
                        feed=[3], **kw)
    events = load_events(out_c)
    by_op = {name: sum(e["op"] == name for e in events)
             for name, _p in DETECT_OPS}
    store = ScoreStore.open(out_c)
    score_rows = 0 if store is None else store.n_rows
    same = detect_sig(out_r) == detect_sig(out_c)
    cpu = detect_on_cpu(out_c, events)
    wall_r, det_r = round_walls(run)
    wall_c, det_c = round_walls(ctrl)
    res = {"rounds": [r1, r2, rc], "b3_steps": b3, "b3_kernels": b3_kernels,
           "b1_launches": b1, "blocks": run["blocks"],
           "thresholds": dict(DETECT_OPS), "events_by_op": by_op,
           "score_rows": score_rows, "resumed_equals_control": same,
           "cpu_rerun": cpu,
           "resumed_round_wall_s": wall_r, "resumed_detect_wall_s": det_r,
           "control_round_wall_s": wall_c, "control_detect_wall_s": det_c,
           "detect_share_of_round": det_c / (wall_c + det_c),
           "resumed_call_wall_s": run["wall_s"],
           "control_call_wall_s": ctrl["wall_s"]}
    n_blocks = sum(run["blocks"].values())
    checks = [
        ((r1, r2, rc) == (1, 1, 2), f"rounds {(r1, r2, rc)} != (1, 1, 2)"),
        (all(n >= 1 for n in by_op.values()),
         f"an operator yielded no event: {by_op}"),
        (score_rows >= 1, "no score row"),
        (same, "the resumed run's ledger, carry or scores differ from the "
         "control's"),
        (b3 > 0 if cuda else b3 == 0, f"B3 launches {b3}"),
        (b3 == (n_blocks if cuda else 0), f"B3 steps {b3} != blocks "
         f"{n_blocks}"),
        (all(c["same_events"] for c in cpu.values()),
         f"the CPU re-run's events differ: {cpu}"),
        (cpu["stalta"]["score_max_rel_err"] == 0.0
         and cpu["stalta"]["state_or_scores_max_rel_err"] == 0.0,
         "STA/LTA on the card is not byte-equal to the CPU"),
        (cpu["rms"]["score_max_rel_err"] <= 1e-6
         and cpu["rms"]["state_or_scores_max_rel_err"] <= 1e-6,
         f"RMS card vs CPU {cpu['rms']}"),
    ]
    return res, checks


def phase_detect_rolling(device, workdir, ddir):
    """Phase 9b: ``run_rolling_realtime(window=1 s, step=1 s)`` (the
    rolling_mean_dascore notebook's) with detect ``rms``, fed files 1-2
    then 3: each output within 1e-6 of the max of the host float64
    ``rolling_reduce`` of its file."""
    from tpudas_torch.detect.ledger import ScoreStore, load_events
    from tpudas_torch.io.spool import spool
    from tpudas_torch.ops.rolling import rolling_reduce
    from tpudas_torch.proc.streaming import run_rolling_realtime

    src_all = os.path.join(workdir, "src")
    src, out = os.path.join(ddir, "src_rolling"), os.path.join(ddir,
                                                                "rolling")
    link_files(src_all, src, 2)
    feed = [3]

    def sleep(_):
        if feed:
            link_files(src_all, src, feed.pop(0))

    t0 = time.perf_counter()
    rounds = run_rolling_realtime(
        src, out, window=ROLLING_SECONDS, step=ROLLING_SECONDS,
        poll_interval=0.0, sleep_fn=sleep, detect=True,
        detect_operators=[DETECT_OPS[1]], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ins = spool(src).sort("time").update()
    outs = spool(out).sort("time").update()
    errs = []
    for j in range(len(ins)):
        p = ins[j]
        w = int(round(ROLLING_SECONDS / p.get_sample_step("time")))
        ref = rolling_reduce(p.host_data(), w, w, "mean", engine="host")
        got = outs[j].host_data().astype(np.float64)
        if got.shape != ref.shape or not np.array_equal(np.isnan(got),
                                                        np.isnan(ref)):
            fail(f"rolling output {j} shape or NaN rows differ")
        errs.append(float(np.nanmax(np.abs(got - ref))
                          / np.nanmax(np.abs(ref))))
    events = load_events(out)
    store = ScoreStore.open(out)
    res = {"rounds": rounds, "outputs": len(outs), "wall_s": wall,
           "realtime_factor": MAIN_PATH_SECONDS / wall,
           "max_rel_err_by_file": errs, "rms_events": len(events),
           "score_rows": 0 if store is None else store.n_rows}
    checks = [
        (rounds == 2 and len(outs) == 3, f"{rounds} rounds, {len(outs)} "
         "outputs"),
        (max(errs) <= 1e-6, f"rolling vs float64 {max(errs):.3e}"),
        (res["score_rows"] >= 1 and len(events) >= 1,
         "detect rms on the rolling stream yielded no score or event"),
    ]
    return res, checks


def phase_detect_joint(device, workdir, ddir):
    """Phase 9c: ``run_lowpass_realtime(rolling_output_folder=...)`` over
    files 1-2, then 3 (one call, two rounds: the joint mode runs the
    rewind path, whose new call starts again at start_time): the rolling
    product one seam-free patch within 1e-6 of phase 7's batch product,
    the LF product within 1e-4 of phase 4's, B1 on every stage."""
    from tpudas_torch.ops.fir_kernel import fir_decimate

    src_all = os.path.join(workdir, "src")
    src = os.path.join(ddir, "src_joint")
    lf, roll = os.path.join(ddir, "joint_lf"), os.path.join(ddir, "joint_roll")
    link_files(src_all, src, 2)
    run = new_run()
    zero_kernel_counts()
    rounds = drive_realtime(
        run, src_all, src, lf, "auto", device, feed=[3],
        rolling_output_folder=roll, rolling_window=ROLLING_SECONDS,
        rolling_step=ROLLING_SECONDS)
    b1 = fir_decimate.launches
    p_lf, _ = grid_checks(lf, "real-time joint LF product")
    p_roll, names = grid_checks(roll, "real-time rolling product")
    p_batch_lf, _ = grid_checks(os.path.join(workdir, "out"), "batch")
    p_batch_roll, _ = grid_checks(os.path.join(workdir, "joint", "roll"),
                                  "batch rolling product")
    roll_rel = interior_rel(p_roll, p_batch_roll)
    lf_rel = interior_rel(p_lf, p_batch_lf)
    res = {"rounds": rounds, "b1_launches": b1, "rolling_files": len(names),
           "rolling_samples": int(p_roll.host_data().shape[0]),
           "rolling_vs_batch_interior_rel_err": roll_rel,
           "lf_vs_phase4_interior_rel_err": lf_rel,
           "wall_s": run["wall_s"],
           "carry_files": sorted(n for n in os.listdir(lf)
                                 if n.startswith(".stream_carry"))}
    checks = [
        (rounds == 2, f"{rounds} rounds != 2"),
        (b1 > 0 if device.type == "cuda" else b1 == 0, f"B1 launches {b1}"),
        (roll_rel <= 1e-6, f"rolling vs batch {roll_rel:.3e}"),
        (lf_rel <= 1e-4, f"LF vs phase 4 {lf_rel:.3e}"),
        (not res["carry_files"], "the joint mode saved a stream carry"),
    ]
    return res, checks


def phase_detect_median(device, workdir, timer):
    """Phase 9d: ``Patch.median_filter(size=5)`` and ``size=9,
    dim="time"`` on phase 4's LF output, bit-equal to
    ``scipy.ndimage.median_filter``; the call's ms, the device work's ms
    and the peak device memory it added."""
    from scipy.ndimage import median_filter as scipy_median

    from tpudas_torch.io.spool import spool
    from tpudas_torch.ops.median import median_filter

    p = spool(os.path.join(workdir, "out")).update().chunk(time=None)[0]
    host = np.ascontiguousarray(p.host_data())
    cuda = device.type == "cuda"
    res, checks = {}, []
    for name, kw, size in (("2d_size5", {"size": 5}, 5),
                           ("time_size9", {"size": 9, "dim": "time"},
                            (9, 1))):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = p.median_filter(device=device, **kw).host_data()
        call_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
        x = torch.from_numpy(host).to(device)
        axes = None if "dim" not in kw else (p.axis_of("time"),)
        dev_ms = timer(lambda: median_filter(x, kw["size"], axes=axes), 5)
        t0 = time.perf_counter()
        want = scipy_median(host, size=size)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        same = got.dtype == want.dtype and got.tobytes() == want.tobytes()
        res[name] = {"shape": list(host.shape), "call_ms": call_ms,
                     "device_ms": dev_ms, "scipy_host_ms": scipy_ms,
                     "peak_device_bytes": peak, "bit_equal_to_scipy": same}
        checks.append((same, f"median {name} differs from scipy"))
    return res, checks


def phase_detect(device, workdir, timer, cls, jcls):
    """Phase 9 over phase 4's spool: 9a-9d (see their docstrings).  The
    runners build an LFProc / JointProc every round and the rolling
    runner writes through ``write_rolling_output``: on a host without
    h5py all three write tdas."""
    from tpudas_torch.fleet import engine as fleet_engine

    ddir = os.path.join(workdir, "detect")
    shutil.rmtree(ddir, ignore_errors=True)
    saved = (fleet_engine.LFProc, fleet_engine.JointProc,
             fleet_engine.write_rolling_output)
    fleet_engine.LFProc, fleet_engine.JointProc = cls, jcls
    if cls.__name__ != "LFProc":
        fleet_engine.write_rolling_output = write_rolling_tdas
    try:
        res = {"phase": "detect"}
        checks = []
        for key, fn in (("fused", phase_detect_fused),
                        ("rolling", phase_detect_rolling),
                        ("joint", phase_detect_joint)):
            res[key], c = fn(device, workdir, ddir)
            checks += [(ok, f"9{key[0]}: {what}") for ok, what in c]
    finally:
        (fleet_engine.LFProc, fleet_engine.JointProc,
         fleet_engine.write_rolling_output) = saved
    res["median"], c = phase_detect_median(device, workdir, timer)
    checks += [(ok, f"9d: {what}") for ok, what in c]
    emit(res)
    for ok, what in checks:
        if not ok:
            fail(f"detect check failed: {what}")
    shutil.rmtree(ddir, ignore_errors=True)
    return res


def batch_references(device, workdir, jcls):
    """``--only detect``: the batch products phase 9 compares with —
    phase 4's LF output (``workdir/out``) and phase 7's rolling product
    (``workdir/joint/roll``) — from one ``JointProc`` pass (its LF files
    are byte-equal to ``LFProc``'s, phase 7 holds it)."""
    from tpudas_torch.io.spool import spool

    bg = np.datetime64(T0, "ns")
    lfp = jcls(spool(os.path.join(workdir, "src")).sort("time").update(),
               device=device)
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=60, edge_buff_size=10,
        rolling_window=ROLLING_SECONDS, rolling_step=ROLLING_SECONDS)
    lfp.set_output_folder(os.path.join(workdir, "out"), delete_existing=True)
    lfp.set_rolling_output_folder(os.path.join(workdir, "joint", "roll"),
                                  delete_existing=True)
    lfp.process_time_range(
        bg, bg + np.timedelta64(int(MAIN_PATH_SECONDS), "s"))


# phase 10: the SIGKILL crash drill (tpudas_torch/tools/crash_drill.py)
# at the flagship's width and parameters, with phase 9's detection; the
# drilled cycles of each engine (each cycle one SIGKILLed worker)
CRASH_CYCLES = {"fused": 4, "auto": 2, "fft": 2}


def crash_feeder(pool):
    """The drill's feed: file k of the drilled stream is a copy of the
    spool's file k mod 3 (``pool``, written by ``make_synthetic_spool``)
    under its own start time, k x 60 s after T0 — a copy and a header
    rewrite, where synthesizing a 60 s x 10,000 ch file takes ~23 s."""
    from tpudas_torch.io.tdas import _pack_header, read_tdas_header

    names = sorted(n for n in os.listdir(pool) if n.endswith(".tdas"))
    t0_ns = int(np.datetime64(T0, "ns").astype(np.int64))

    def feed(src, first, n_files):
        os.makedirs(src, exist_ok=True)
        made = []
        for k in range(first, first + n_files):
            tpl = os.path.join(pool, names[k % len(names)])
            h = read_tdas_header(tpl)
            name = f"raw{k:04d}.tdas"
            dst = os.path.join(src, name)
            shutil.copyfile(tpl, dst)
            with open(dst, "r+b") as fh:
                fh.write(_pack_header(
                    t0_ns + k * h["n_time"] * h["dt_ns"], h["dt_ns"],
                    h["n_time"], h["n_ch"], h["dtype_code"], h["scale"],
                    h["d0"], h["dx"]))
            made.append(name)
        return made

    return feed


def phase_crash(device, workdir, n_ch, tdas_output, cycles=None):
    """Phase 10: the crash drill under ``fused``, ``auto`` and ``fft``
    (``CRASH_CYCLES`` killed cycles each, or ``cycles``): fresh worker
    interpreters on the card, SIGKILLed at seeded points, with detection,
    the tile pyramid, the health files and the flight ring on; right
    after the kills the ring replays the last committed round (its
    phases, its ``stream.round`` span); the drained folder audits clean,
    no startup audit raised, no pyramid append failed, and the outputs,
    the stream carry, the pyramid tree and the detect state equal an
    uninterrupted control's.  Each line reports ``flight`` and the
    flight repairs the workers' audits made.
    One line per engine; the fused workers must have launched B3 and
    the auto workers B1."""
    from tpudas_torch.tools.crash_drill import run_drill

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()  # the workers need the card's memory
    shape = {"fs": 1000.0, "file_sec": 60.0, "n_ch": n_ch, "noise": NOISE,
             "format": "tdas",
             "write_kwargs": {"dtype": "int16", "scale": QSCALE},
             "dt_out": 1.0, "edge": 10.0, "patch_out": 60,
             "detect_ops": DETECT_OPS}
    feed = crash_feeder(os.path.join(workdir, "src"))
    res = {}
    for engine, n in CRASH_CYCLES.items():
        wd = os.path.join(workdir, "crash", engine)
        shutil.rmtree(wd, ignore_errors=True)
        rep = run_drill(engine=engine, cycles=cycles or n, seed=0,
                        workdir=wd, device=device.type, shape=shape,
                        tdas_output=tdas_output, feed=feed)
        rec, aud = rep["recover_s"], rep["audit_seconds"]
        line = {
            "phase": "crash", "engine": engine, "n_ch": n_ch,
            "cycles": rep["cycles"], "kills": rep["kills"],
            "epochs": rep["epochs"], "audit_repairs": rep["audit_repairs"],
            "audit_errors": rep["audit_errors"],
            "audit_clean": rep["audit_clean"],
            "outputs_match": rep["outputs_match"],
            "carry_match": rep["carry_match"],
            "pyramid_match": rep["pyramid_match"],
            "pyramid_files": rep["pyramid_files"],
            "pyramid_errors": rep["pyramid_errors"],
            "control_pyramid_errors": rep["control_pyramid_errors"],
            "detect_match": rep["detect_match"],
            "detect_events": rep["detect_events"],
            "flight": rep["flight"],
            "flight_repairs": rep["flight_repairs"],
            "recover_s_median": float(np.median(rec)) if rec else None,
            "recover_s_max": max(rec) if rec else None, "recover_s": rec,
            "audit_seconds_median": float(np.median(aud)) if aud else None,
            "audit_seconds_max": max(aud) if aud else None,
            "final_audit_s": rep["final_audit_s"],
            "cold_wall_s": rep["cold_wall_s"],
            "warm_wall_s": rep["warm_wall_s"],
            "warm_work_s": rep["warm_work_s"],
            "drill_wall_s": rep["drill_wall_s"],
            "worker_start_s_median": float(np.median(rep["worker_start_s"])),
            "worker_launches": rep["launches"],
            "difference": rep["difference"],
            "cycle_log": rep["cycle_log"], "drain": rep["drain"],
            "ok": rep["ok"],
        }
        emit(line)
        launches = rep["launches"]
        checks = [
            (rep["ok"], "the drill is not ok"),
            (rep["kills"] >= 1, "no kill landed"),
            (rep["detect_events"] >= 1, "no detect event (a vacuous match)"),
            (rep["pyramid_match"] and rep["pyramid_files"] > 0,
             "the pyramid differs from the control's (or is empty)"),
            (rep["pyramid_errors"] == rep["control_pyramid_errors"] == 0,
             "a worker swallowed a pyramid-append error"),
            (rep["flight"]["ok"],
             f"the flight ring did not replay the last committed round: "
             f"{rep['flight']}"),
        ]
        if engine == "fused":
            checks.append(((launches["fused_cascade"] > 0) == cuda,
                           f"B3 steps of the workers {launches}"))
        if engine == "auto":
            checks.append(((launches["fir_decimate"] > 0) == cuda,
                           f"B1 launches of the workers {launches}"))
        for ok, what in checks:
            if not ok:
                # the workdir stays for a post-mortem: the workers' logs
                # are under <workdir>/logs
                fail(f"crash drill ({engine}): {what}; workdir {wd}: {line}")
        shutil.rmtree(wd, ignore_errors=True)
        res[engine] = line
    return res


# phase 11: the tile pyramid (tpudas_torch.serve) on the real-time path.
# 6 files of 60 s x 10,000 ch (files k mod 3 of the spool under their
# own start times, as phase 10 feeds), 1 Hz output
PYRAMID_FILES = 6
PYRAMID_BUDGETS = (16, 64, 1024)


def manifest_core(folder):
    """The manifest without its stamp and generation: what a rebuild
    must reproduce."""
    with open(os.path.join(folder, ".tiles", "manifest.json")) as fh:
        m = json.load(fh)
    return {k: v for k, v in m.items() if k not in ("_crc32", "generation")}


def tiles_bytes(folder):
    """Bytes of ``.tiles/`` per level directory, plus the tails and
    manifest files."""
    out = {}
    base = os.path.join(folder, ".tiles")
    for d, _sub, files in os.walk(base):
        rel = os.path.relpath(d, base)
        for n in files:
            key = rel if rel != "." else n.split(".")[0]
            out[key] = out.get(key, 0) + os.path.getsize(os.path.join(d, n))
    return out


def copy_outputs(out, dst):
    """Hard-link the output files of ``out`` into a fresh ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for n in os.listdir(out):
        if n.startswith("LFDAS_"):
            os.link(os.path.join(out, n), os.path.join(dst, n))
    return dst


def hierarchy(x0, levels):
    """The pyramid the host reduction gives the output rows ``x0``:
    level k+1 is ``block_reduce`` of level k's float32 rows, per agg
    (the cascade's own order)."""
    from tpudas_torch.serve.tiles import block_reduce

    ref = [{a: x0 for a in ("mean", "min", "max")}]
    for k in range(1, levels):
        prev = ref[-1]
        n = prev["mean"].shape[0] // 4 * 4
        ref.append({a: block_reduce(prev[a][:n], 4, a).astype(np.float32)
                    for a in ("mean", "min", "max")})
    return ref


def pyramid_round_lines(run):
    return [{"round": e["round"], "wall_s": e["wall_seconds"],
             "pyramid_append_s": e["pyramid_seconds"]}
            for e in run["events"] if e["event"] == "realtime_round"]


def phase_pyramid(device, workdir, cls, timer):
    """Phase 11: the tile pyramid on the real-time path at 10,000 ch.
    (a) ``engine="fused"`` with ``pyramid=True`` over two calls (the
    second resumes from the manifest): the tree equals
    ``rebuild_pyramid`` over a copy, the level counts are the output rows
    and their floor divisions by 4, B3 launched once a block; (b)
    ``engine="auto"`` under ``bitshuffle-deflate`` and 64-row tiles:
    decoded tiles equal a raw store's, then a ``quantize-deflate``
    rebuild within 1e-3 with the generation bumped, B1 launched 4 times
    a block; (c) ``QueryEngine`` at 16 / 64 / 1024 samples, full width
    and a 1,000-ch range, each answer equal to the host reduction of the
    output rows, cold and warm, and the fallback past the head; (d)
    ``block_reduce(engine="torch")`` on the card against the host; (e)
    ``_pyramid_block`` at ``max_px`` 256."""
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.io.spool import spool
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.serve.query import QueryEngine
    from tpudas_torch.serve.tiles import (
        TileStore,
        block_reduce,
        rebuild_pyramid,
        sync_pyramid,
    )
    from tpudas_torch.tools.crash_drill import _pyramid_tree as pyramid_tree
    from tpudas_torch.viz.waterfall import _pyramid_block

    cuda = device.type == "cuda"
    pdir = os.path.join(workdir, "pyramid")
    shutil.rmtree(pdir, ignore_errors=True)
    src_all = os.path.join(pdir, "src_all")
    crash_feeder(os.path.join(workdir, "src"))(src_all, 0, PYRAMID_FILES)
    reg = MetricsRegistry()
    env_keys = ("TPUDAS_CODEC", "TPUDAS_PYRAMID_TILE_LEN",
                "TPUDAS_PYRAMID_FACTOR", "TPUDAS_PYRAMID")
    saved_env = {k: os.environ.pop(k, None) for k in env_keys}
    saved_cls = fleet_engine.LFProc
    fleet_engine.LFProc = cls
    res = {"phase": "pyramid", "n_ch": None}
    try:
        with use_registry(reg):
            # (a) the fused stream, two calls: 4 files, then all 6
            fused = new_run()
            src_f, out_f = (os.path.join(pdir, n) for n in ("src_f", "fused"))
            link_files(src_all, src_f, 4)
            fused_cascade.launches = fused_cascade.kernel_launches = 0
            fir_decimate.launches = 0
            r1 = drive_realtime(fused, src_all, src_f, out_f, "fused", device,
                                pyramid=True)
            link_files(src_all, src_f, PYRAMID_FILES)
            r2 = drive_realtime(fused, src_all, src_f, out_f, "fused", device,
                                pyramid=True)
            b3, b3k, b1_f = (fused_cascade.launches,
                             fused_cascade.kernel_launches,
                             fir_decimate.launches)
            hist_a = reg.histogram(
                "tpudas_serve_pyramid_append_seconds").snapshot()
            errors_a = reg.value("tpudas_serve_pyramid_errors_total")
            # (b) the auto stream under a codec and 64-row tiles
            os.environ["TPUDAS_CODEC"] = "bitshuffle-deflate"
            os.environ["TPUDAS_PYRAMID_TILE_LEN"] = "64"
            auto = new_run()
            src_a, out_a = (os.path.join(pdir, n) for n in ("src_a", "auto"))
            link_files(src_all, src_a, 4)
            fused_cascade.launches = 0
            fir_decimate.launches = 0
            ra = drive_realtime(auto, src_all, src_a, out_a, "auto", device,
                                feed=[PYRAMID_FILES], pyramid=True)
            b1, b3_a = fir_decimate.launches, fused_cascade.launches
            for k in ("TPUDAS_CODEC", "TPUDAS_PYRAMID_TILE_LEN"):
                os.environ.pop(k, None)
            errors = reg.value("tpudas_serve_pyramid_errors_total")
    finally:
        fleet_engine.LFProc = saved_cls
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (a) checks
    p_f, _names = grid_checks(out_f, "pyramid fused")
    x0 = np.ascontiguousarray(p_f.host_data(), dtype=np.float32)
    n_rows, n_ch = x0.shape
    res["n_ch"] = int(n_ch)
    store = TileStore.open(out_f)
    want_levels = [n_rows]
    while want_levels[-1] // 4:
        want_levels.append(want_levels[-1] // 4)
    copy = os.path.join(pdir, "fused_copy")
    shutil.copytree(out_f, copy)
    t0 = time.perf_counter()
    rebuild_pyramid(copy)
    rebuild_s = time.perf_counter() - t0
    got_tree = {k: v for k, v in pyramid_tree(out_f).items()
                if k != "manifest.json"}
    reb_tree = {k: v for k, v in pyramid_tree(copy).items()
                if k != "manifest.json"}
    n_blocks = sum(fused["blocks"].values())
    rounds_a = pyramid_round_lines(fused)
    res["a"] = {
        "engine": "fused", "calls": [r1, r2], "rounds": rounds_a,
        "output_rows": int(n_rows), "levels": store.levels,
        "want_levels": want_levels, "tiles_files": len(got_tree),
        "tree_equals_rebuild": got_tree == reb_tree
        and manifest_core(out_f) == manifest_core(copy),
        "rebuild_s": rebuild_s, "tiles_bytes": tiles_bytes(out_f),
        "append_seconds": hist_a, "blocks": fused["blocks"],
        "fused_cascade_launches": b3, "fused_cascade_kernel_launches": b3k,
        "fir_decimate_launches": b1_f, "wall_s": fused["wall_s"],
        "pyramid_errors": errors_a,
    }
    fused_eng = "fused-cuda" if cuda else "fused-torch"
    checks = [
        ((r1, r2) == (1, 1), f"fused calls {(r1, r2)} != (1, 1)"),
        (store.levels == want_levels,
         f"levels {store.levels} != {want_levels}"),
        (res["a"]["tree_equals_rebuild"],
         "the incremental tree differs from rebuild_pyramid's"),
        (any(k.startswith("L0/") for k in got_tree),
         "level 0 completed no tile"),
        (set(fused["blocks"]) == {fused_eng} and n_blocks > 0,
         f"every fused block ran {fused_eng}"),
        (b3 == (n_blocks if cuda else 0),
         f"B3 launches {b3} != blocks {n_blocks} (phase 5's relation)"),
        (b3k == (2 * n_blocks if cuda else 0),
         f"kernels A+B launches {b3k} != 2 x {n_blocks}"),
        (len(rounds_a) == 2 and all(r["pyramid_append_s"] is not None
                                    for r in rounds_a),
         "each round appended the pyramid"),
    ]

    # (b) the compressed store against a raw one, then a lossy rebuild
    st_a = TileStore.open(out_a)
    raw = copy_outputs(out_a, os.path.join(pdir, "auto_raw"))
    sync_pyramid(raw, tile_len=64, codec="raw")
    st_raw = TileStore.open(raw)
    tpt = [k for k in pyramid_tree(out_a) if k.endswith(".tpt")]
    same = st_a.levels == st_raw.levels and all(
        st_a.read(k, 0, st_a.n(k), a).tobytes()
        == st_raw.read(k, 0, st_raw.n(k), a).tobytes()
        for k in range(st_a.n_levels) for a in ("mean", "min", "max"))
    lossy = os.path.join(pdir, "auto_lossy")
    shutil.copytree(out_a, lossy)
    rebuild_pyramid(lossy, codec="quantize-deflate:max_error=1e-3")
    st_q = TileStore.open(lossy)
    # the bound holds per level: level 0 against the raw rows, each
    # coarser level against the host reduction of the level below as
    # the lossy store holds it (its own source); against the raw store
    # the levels' errors add up, so those are reported, not bounded
    q_err, nan_same, q_vs_raw = 0.0, True, []
    for k in range(st_q.n_levels):
        lvl_raw = 0.0
        for a in ("mean", "min", "max"):
            q = st_q.read(k, 0, st_q.n(k), a)
            r = st_raw.read(k, 0, st_raw.n(k), a)
            if k:
                below = st_q.read(k - 1, 0, st_q.n(k) * 4, a)
                src = block_reduce(below, 4, a).astype(np.float32)
            else:
                src = r
            nan_same = nan_same and np.array_equal(np.isnan(q), np.isnan(r))
            fin = np.isfinite(r)
            if fin.any():
                q_err = max(q_err, float(np.abs(q[fin] - src[fin]).max()))
                lvl_raw = max(lvl_raw, float(np.abs(q[fin] - r[fin]).max()))
        q_vs_raw.append(lvl_raw)
    n_blocks_a = sum(auto["blocks"].values())
    res["b"] = {
        "engine": "auto", "codec": st_a.codec, "tile_len": st_a.tile_len,
        "calls": ra, "rounds": pyramid_round_lines(auto),
        "levels": st_a.levels, "tpt_tiles": len(tpt),
        "tpt_levels": sorted({k.split("/")[0] for k in tpt}),
        "decoded_equal_raw": bool(same), "tiles_bytes": tiles_bytes(out_a),
        "raw_tiles_bytes": tiles_bytes(raw),
        "quantize_max_abs_err": q_err, "quantize_nan_exact": bool(nan_same),
        "quantize_err_vs_raw_by_level": q_vs_raw,
        "quantize_generation": st_q.generation,
        "quantize_tiles_bytes": tiles_bytes(lossy),
        "blocks": auto["blocks"], "fir_decimate_launches": b1,
        "fused_cascade_launches": b3_a, "wall_s": auto["wall_s"],
    }
    chain_eng = "cascade-cuda" if cuda else "cascade-torch"
    checks += [
        (ra == 2, f"auto rounds {ra} != 2"),
        (st_a.codec == "bitshuffle-deflate" and st_a.tile_len == 64,
         "the auto store's codec and tile length"),
        ({"L0", "L1"} <= set(res["b"]["tpt_levels"]),
         f"completed .tpt tiles at levels 0-1: {res['b']['tpt_levels']}"),
        (same, "decoded tiles differ from the raw store's"),
        (q_err <= 1e-3 and nan_same,
         f"quantize-deflate rebuild err {q_err:.3e} (bound 1e-3)"),
        (st_q.generation == 1, "the rebuild bumped the generation"),
        (set(auto["blocks"]) == {chain_eng} and n_blocks_a > 0,
         f"every auto block ran {chain_eng}"),
        (b1 == (4 * n_blocks_a if cuda else 0),
         f"B1 launches {b1} != 4 x {n_blocks_a}"),
        (b3_a == 0, "the auto stream launched no B3 step"),
    ]

    # (c) queries over the whole stream, against the host reduction
    ref = hierarchy(x0, store.n_levels)
    times = p_f.coords["time"]
    dists = np.asarray(p_f.coords["distance"], np.float64)
    # a 1,000-channel range (a quarter of the width in a rehearsal)
    c0, c1 = min(1000, n_ch // 4), min(1000, n_ch // 4) + min(1000, n_ch // 4)
    sub = (float(dists[c0]), float(dists[c1 - 1]))
    queries = []
    for budget in PYRAMID_BUDGETS:
        for rng_name, drange in (("full", None), (f"{c1 - c0}ch", sub)):
            eng = QueryEngine(out_f)
            t_c = time.perf_counter()
            r = eng.query(times[0], times[-1], max_samples=budget,
                          distance=drange)
            cold = (time.perf_counter() - t_c) * 1e3
            t_w = time.perf_counter()
            r2 = eng.query(times[0], times[-1], max_samples=budget,
                           distance=drange)
            warm = (time.perf_counter() - t_w) * 1e3
            want = ref[r.level]["mean"][:r.n_samples]
            if drange is not None:
                want = want[:, c0:c1]
            equal = (r.data.tobytes() == np.ascontiguousarray(
                want).tobytes() and r2.data.tobytes() == r.data.tobytes())
            queries.append({"max_samples": budget, "range": rng_name,
                            "level": r.level, "rows": r.n_samples,
                            "channels": int(r.data.shape[1]),
                            "source": r.source, "cold_ms": cold,
                            "warm_ms": warm, "equal_host": bool(equal)})
            checks.append((equal and r.source == "tiles",
                           f"query {budget}/{rng_name}: level {r.level} "
                           f"source {r.source} equal {equal}"))
    # past the head: a pyramid over the first 3 output files only
    part = copy_outputs(out_f, os.path.join(pdir, "part"))
    names = sorted(n for n in os.listdir(part) if n.startswith("LFDAS_"))
    later = names[len(names) // 2:]
    held = os.path.join(pdir, "part_rest")
    os.makedirs(held)
    for n in later:
        os.replace(os.path.join(part, n), os.path.join(held, n))
    sync_pyramid(part)
    for n in later:
        os.replace(os.path.join(held, n), os.path.join(part, n))
    head = TileStore.open(part).head_ns
    eng = QueryEngine(part)
    mixed = eng.query(times[0], times[-1])
    beyond = eng.query(np.datetime64(int(head), "ns") + np.timedelta64(1, "s"),
                       times[-1])
    fb_equal = mixed.data.tobytes() == x0.tobytes()
    res["c"] = {"queries": queries,
                "fallback": {"mixed_source": mixed.source,
                             "beyond_source": beyond.source,
                             "mixed_equal_rows": bool(fb_equal),
                             "beyond_rows": beyond.n_samples}}
    checks += [
        (mixed.source == "mixed" and fb_equal,
         f"straddling window: {mixed.source}, equal {fb_equal}"),
        (beyond.source == "files" and beyond.n_samples > 0,
         f"window past the head: {beyond.source}"),
    ]

    # (d) the device reduction against the host one
    n4 = n_rows // 4 * 4
    xr = x0[:n4]
    red = {}
    for op in ("mean", "min", "max"):
        host = block_reduce(xr, 4, op).astype(np.float32)
        dev = block_reduce(xr, 4, op, engine="torch", device=device)
        xt = torch.from_numpy(xr).to(device)
        dev_t = block_reduce(xt, 4, op, engine="torch")
        t_h = time.perf_counter()
        for _ in range(5):
            block_reduce(xr, 4, op)
        host_ms = (time.perf_counter() - t_h) / 5 * 1e3
        # a card tensor in, the host rows out (the D2H included)
        dev_ms = timer(lambda: block_reduce(xt, 4, op, engine="torch"), 5)
        fin = np.isfinite(host)
        err = float(np.abs(dev[fin] - host[fin]).max())
        scale = float(np.abs(host[fin]).max())
        exact = (np.array_equal(dev, host) if op != "mean" else None)
        red[op] = {"host_ms": host_ms, "device_ms": dev_ms,
                   "max_abs_err": err, "rel_err": err / scale,
                   "exact": exact,
                   "tensor_equal": bool(np.array_equal(dev_t, dev))}
        # min and max are exact; the mean is within 1e-6 of the largest
        # |value| (float32 window sums against float64)
        ok = exact if op != "mean" else err <= 1e-6 * scale
        checks.append((ok and red[op]["tensor_equal"],
                       f"block_reduce {op} on {device.type}: err {err:.3e}"))
    res["d"] = {"rows": int(n4), "channels": int(n_ch), "ops": red}

    # (e) the waterfall's pyramid block
    t_e = time.perf_counter()
    blk = _pyramid_block(p_f, out_f, 256)
    blk_ms = (time.perf_counter() - t_e) * 1e3
    ok_e = blk is not None
    if ok_e:
        qr = QueryEngine(out_f).query(times[0], times[-1],
                                      distance=(dists.min(), dists.max()),
                                      max_samples=256)
        ok_e = (blk[0].tobytes() == qr.data.tobytes()
                and blk[0].shape[1] == n_ch)
    res["e"] = {"max_px": 256, "ms": blk_ms, "ok": bool(ok_e),
                "shape": list(blk[0].shape) if blk is not None else None}
    checks.append((ok_e, "_pyramid_block at max_px 256"))
    res["pyramid_errors"] = errors
    checks.append((errors == 0,
                   f"tpudas_serve_pyramid_errors_total {errors} != 0"))
    emit(res)
    for ok, what in checks:
        if not ok:
            fail(f"pyramid check failed: {what}")
    shutil.rmtree(pdir, ignore_errors=True)
    return res


# phase 12: the observability plane (health, flight, round phases) on the
# real-time path.  4 files of 60 s x 10,000 ch, one a round: files 0-2
# are phase 4's spool, file 3 a copy of file 0 under its own start time
OBS_FILES = 4
OBS_MEMBERS = (("a", 0, 10000), ("b", 1, 6001))
REHEARSE_OBS_MEMBERS = (("a", 0, 32), ("b", 1, 17))
# the artifacts that hold wall-clock times (never compared by bytes)
OBS_ARTIFACTS = ("health.json", "health.json.prev", "metrics.prom")


def obs_linker(workdir, odir):
    """``link(src, upto)``: hard-link the stream's first ``upto`` files
    into ``src`` — the spool's own files, then copies of them under
    later start times (written once into ``odir/pool``)."""
    spool_dir = os.path.join(workdir, "src")
    names = sorted(n for n in os.listdir(spool_dir) if n.endswith(".tdas"))
    pool = os.path.join(odir, "pool")
    copy = crash_feeder(spool_dir)

    def link(src, upto):
        os.makedirs(src, exist_ok=True)
        for k in range(upto):
            if k < len(names):
                name, frm = names[k], os.path.join(spool_dir, names[k])
            else:
                name = f"raw{k:04d}.tdas"
                frm = os.path.join(pool, name)
                if not os.path.exists(frm):
                    copy(pool, k, 1)
            dst = os.path.join(src, name)
            if not os.path.exists(dst):
                os.link(frm, dst)

    return link


def parse_prom(path):
    """``{(name, labels): value}`` of a Prometheus text exposition."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            key, value = line.rsplit(" ", 1)
            name, _, labels = key.partition("{")
            out[(name, labels.rstrip("}"))] = float(value)
    return out


def ring_checks(out):
    """The flight ring of ``out``: its round records (each with every
    phase) and whether each is preceded, since the record before it, by
    a ``stream.round`` span of its round."""
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.obs.phases import PHASES

    ring = read_flight(out)
    rounds, ordered, span_round = [], True, None
    for rec in ring:
        if rec["kind"] == "span" and rec.get("name") == "stream.round":
            span_round = rec.get("round")
        elif rec["kind"] == "round":
            ordered = ordered and span_round == rec["round"]
            ordered = ordered and sorted(rec["phases"]) == sorted(PHASES)
            rounds.append(rec)
            span_round = None
    return rounds, ordered, ring


def obs_leg(device, link, ldir, engine, calls, obs=True, detect=True,
            pyramid=True):
    """One real-time stream: each entry of ``calls`` is one
    ``run_lowpass_realtime`` call, starting over its first file count and
    linking the next count at each poll's sleep (the second call resumes
    from the carry).  ``obs`` turns the health files and the flight ring
    on (health=True, flight at its default), or both off.  Returns the
    per-round phases, walls and device seconds, and the checks."""
    from tpudas_torch.obs.health import read_health, validate_health
    from tpudas_torch.obs.phases import PHASES
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    cuda = device.type == "cuda"
    src, out = os.path.join(ldir, "src"), os.path.join(ldir, "out")
    reg = MetricsRegistry()
    per_round, mark, health_ok = [], [0.0], []

    def on_round(rnd, lfp):
        wall = time.perf_counter() - mark[0]
        body = reg.histogram(
            "tpudas_stream_round_body_seconds").snapshot()["sum"]
        if obs:
            snap = read_health(out)
            health_ok.append(snap is not None and validate_health(snap)
                             is snap and snap["rounds"] == rnd)
        per_round.append({
            "round": rnd, "wall_s": wall, "body_sum_s": body,
            "device_s": float(lfp.timings.get("device_s", 0.0)),
            "blocks": dict(lfp.stream_blocks)})
        mark[0] = time.perf_counter()

    zero_kernel_counts()
    with use_registry(reg):
        for counts in calls:
            link(src, counts[0])
            feed = list(counts[1:])

            def sleep(_s, feed=feed):
                if feed:
                    link(src, feed.pop(0))
                mark[0] = time.perf_counter()

            mark[0] = time.perf_counter()
            run_lowpass_realtime(
                src, out, T0, output_sample_interval=1.0, edge_buffer=10.0,
                process_patch_size=60, poll_interval=0.0, sleep_fn=sleep,
                on_round=on_round, engine=engine, stateful=True,
                device=device, health=obs, flight=None if obs else False,
                detect=detect, detect_operators=DETECT_OPS,
                pyramid=pyramid)
            if cuda:
                torch.cuda.synchronize()
    counts = kernel_counts()
    prev = 0.0
    for r in per_round:  # the body histogram's sum, per round
        total = r.pop("body_sum_s")
        r["body_s"], prev = total - prev, total
    blocks = {}
    for r in per_round:
        for k, v in r["blocks"].items():
            blocks[k] = blocks.get(k, 0) + v
    res = {"engine": engine, "obs": obs, "rounds": len(per_round),
           "blocks": blocks, "kernel_counts": counts,
           "carry_resumes": reg.value("tpudas_stream_carry_resumes_total"),
           "per_round": per_round}
    checks = [(len(per_round) == sum(len(c) for c in calls),
               f"{engine}: rounds {len(per_round)} != one a file")]
    n_blocks = sum(blocks.values())
    if engine == "fused":
        checks += [
            (set(blocks) == {"fused-cuda" if cuda else "fused-torch"},
             f"fused blocks {blocks}"),
            (counts["b3_steps"] == (n_blocks if cuda else 0),
             f"B3 steps {counts['b3_steps']} != blocks {n_blocks}"),
            (counts["b3_kernels"] == 2 * counts["b3_steps"],
             f"B3 kernels {counts['b3_kernels']} != 2 x steps")]
    elif engine == "auto":
        checks += [(counts["b1"] == (4 * n_blocks if cuda else 0),
                    f"B1 launches {counts['b1']} != 4 x {n_blocks}")]
    else:
        checks += [(counts["b1"] == counts["b3_steps"] == 0,
                    f"fft launched a FIR kernel {counts}")]
    if len(calls) > 1:
        checks.append((res["carry_resumes"] == len(calls) - 1,
                       f"carry resumes {res['carry_resumes']}"))
    if not obs:
        checks.append((not any(os.path.exists(os.path.join(out, n))
                                for n in (".flight", *OBS_ARTIFACTS)),
                       "obs off left a health file or a flight ring"))
        return res, checks
    rounds, ordered, ring = ring_checks(out)
    for r, rec in zip(per_round, rounds):
        ph = rec["phases"]
        r["phases"] = ph
        # the body covers every phase but the poll, which precedes it
        r["unphased_s"] = r["body_s"] - (sum(ph.values()) - ph["poll"])
    prom = parse_prom(os.path.join(out, "metrics.prom"))
    phase_counts = {p: prom.get(("tpudas_stream_round_phase_seconds_count",
                                 f'phase="{p}"')) for p in PHASES}
    drops = reg.get("tpudas_obs_flight_drops_total")
    flight_drops = sum(v for _l, v in drops._series()) if drops else 0.0
    res.update({
        "ring_records": len(ring), "ring_rounds": len(rounds),
        "health_write_errors": reg.value(
            "tpudas_health_write_errors_total"),
        "health_writes": reg.value("tpudas_health_writes_total"),
        "flight_drops": flight_drops,
        "flight_bytes": reg.value("tpudas_obs_flight_bytes_total"),
        "prom_phase_counts": phase_counts,
        "artifacts": sorted(n for n in os.listdir(out)
                            if n in (".flight", *OBS_ARTIFACTS))})
    checks += [
        (all(health_ok) and len(health_ok) == len(per_round),
         f"{engine}: validate_health/read_health failed in a round "
         f"{health_ok}"),
        (all(v == len(per_round) for v in phase_counts.values()),
         f"{engine}: metrics.prom phase counts {phase_counts}"),
        (len(rounds) == len(per_round) and ordered,
         f"{engine}: the ring's round records (one a round, all phases, "
         f"each after its stream.round span): {len(rounds)}, {ordered}"),
        (res["health_write_errors"] == 0 and flight_drops == 0,
         f"{engine}: health write errors {res['health_write_errors']}, "
         f"flight drops {flight_drops}"),
    ]
    return res, checks


def obs_fleet(device, link, fdir, members):
    """Phase 12d: a batched ``fused`` fleet of two members (10,000 and
    6,001 ch) with health and flight on, one call over two files; then
    ``fleet_rollup`` and ``python -m tpudas_torch.tools.obs_report
    --json`` over its root.  Each member's ring holds one
    ``stream.round`` span a round of its own and only its own round
    records."""
    import subprocess

    from tpudas_torch.fleet import FleetEngine, StreamConfig, StreamSpec
    from tpudas_torch.obs.collect import fleet_rollup
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry

    cuda = device.type == "cuda"
    specs = []
    for sid, c0, w in members:
        src = os.path.join(fdir, f"src_{sid}")
        link(src, 2)
        specs.append(StreamSpec(stream_id=sid, source=src, config=StreamConfig(
            kind="lowpass", start_time=T0, output_sample_interval=1.0,
            edge_buffer=10.0, process_patch_size=60, poll_interval=0.0,
            poll_jitter=0.0, engine="fused", stateful=True, health=True,
            distance=(c0 * D_CH, (c0 + w - 1) * D_CH))))
    root = os.path.join(fdir, "root")
    reg = MetricsRegistry()
    zero_kernel_counts()
    t0 = time.perf_counter()
    with use_registry(reg):
        summary = FleetEngine(root, specs, sleep_fn=lambda _s: None,
                              batched=True, device=device).run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    rollup = fleet_rollup(root)
    t_r = time.perf_counter()
    rep = subprocess.run(
        [sys.executable, "-m", "tpudas_torch.tools.obs_report", "--fleet",
         root, "--json"], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    report_s = time.perf_counter() - t_r
    cli = json.loads(rep.stdout) if rep.returncode == 0 else None
    rings = {}
    for sid, _c0, _w in members:
        folder = os.path.join(root, sid)
        spans = read_flight(folder, kind="span", name="stream.round")
        recs = read_flight(folder, kind="round")
        rings[sid] = {
            "rounds": [r["round"] for r in recs],
            "round_spans": sorted(s["round"] for s in spans),
            "own": all(r["stream"] == sid for r in recs),
            "span_names": sorted({s["name"] for s in read_flight(
                folder, kind="span")})}
    res = {"wall_s": wall, "kernel_counts": counts,
           "stacked_launches": reg.value(
               "tpudas_fleet_batch_stacked_launches_total"),
           "rounds": {sid: s["rounds"] for sid, s in
                      summary["streams"].items()},
           "parked": summary["parked"], "rings": rings,
           "rollup": rollup, "obs_report_rc": rep.returncode,
           "obs_report_s": report_s,
           "obs_report_status": None if cli is None else cli["status"]}
    want_rounds = {sid: list(range(1, s["rounds"] + 1))
                   for sid, s in summary["streams"].items()}
    checks = [
        (summary["parked"] == [], f"fleet parked {summary['parked']}"),
        (all(r["rounds"] == want_rounds[sid] == r["round_spans"] and r["own"]
             for sid, r in rings.items()),
         f"a member's ring holds another's spans or rounds: {rings}"),
        (cli is not None and cli["fleet"]["streams"] == rollup["streams"],
         f"obs_report --json (rc {rep.returncode}) differs from "
         f"fleet_rollup: {rep.stderr[-400:]}"),
        (rollup["status"] == "ok" and sorted(rollup["streams"]) == sorted(
            sid for sid, _c, _w in members), f"rollup {rollup['status']}"),
        ((counts["b3_steps"] > 0 and res["stacked_launches"] > 0) if cuda
         else counts["b3_steps"] == 0,
         f"the fleet's B3 steps {counts}, stacked "
         f"{res['stacked_launches']}"),
    ]
    return res, checks


def phase_obs(device, workdir, cls, members):
    """Phase 12: the observability plane on the real-time path at the
    flagship width.  (a) ``fused`` with health, the flight ring (its
    default), detection and the pyramid: 4 files, one a round, in 2
    calls (the second resumes from the carry); each round's ten phases,
    body seconds and the body no phase covers, ``timings["device_s"]``
    beside ``host_wait``; ``health.json`` validated every round,
    ``metrics.prom`` holding every phase, the ring's round records each
    after its ``stream.round`` span, no health write error and no
    flight drop; B3 2 kernels a block.  (b) the same checks under
    ``auto`` (B1 4 times a block) and ``fft``, one call of 2 rounds
    each.  (c) the overhead: the fused stream (no detection, no
    pyramid) with health and flight off (A) and on (B), A B B A, one
    call of 4 rounds each.  (d) a batched 2-member fleet, rolled up."""
    from tpudas_torch.fleet import engine as fleet_engine

    cuda = device.type == "cuda"
    odir = os.path.join(workdir, "obs")
    shutil.rmtree(odir, ignore_errors=True)
    link = obs_linker(workdir, odir)
    saved_cls = fleet_engine.LFProc
    fleet_engine.LFProc = cls
    legs, checks = {}, []
    t_phase = time.perf_counter()
    try:
        link(os.path.join(odir, "warm"), OBS_FILES)  # the copy, once
        for name, engine, calls in (("fused", "fused", [[1, 2], [3, 4]]),
                                    ("auto", "auto", [[1, 2]]),
                                    ("fft", "fft", [[1, 2]])):
            leg, c = obs_leg(device, link, os.path.join(odir, name), engine,
                             calls)
            legs[name] = leg
            checks += c
            emit({"phase": "obs", "leg": name, **leg})
            if cuda:
                torch.cuda.empty_cache()
        turns = []
        for i, obs in enumerate((False, True, True, False)):
            leg, c = obs_leg(device, link, os.path.join(odir, f"ab{i}"),
                             "fused", [list(range(1, OBS_FILES + 1))],
                             obs=obs, detect=False, pyramid=False)
            checks += c
            turns.append({"obs": obs, "round_walls_s": [
                r["wall_s"] for r in leg["per_round"]],
                "health_s": [r.get("phases", {}).get("health")
                             for r in leg["per_round"]]})
        fleet, c = obs_fleet(device, link, os.path.join(odir, "fleet"),
                             members)
        checks += c
    finally:
        fleet_engine.LFProc = saved_cls

    def walls(on, first=0):
        return [x for t in turns if t["obs"] == on
                for x in t["round_walls_s"][first:]]

    off, on = walls(False), walls(True)
    # steady: each turn's rounds after its first (the call's filter
    # design and first launches ride the first round)
    s_off, s_on = walls(False, 1), walls(True, 1)
    overhead = {
        "turns": turns,
        "round_wall_off_s": float(np.mean(off)),
        "round_wall_on_s": float(np.mean(on)),
        "difference_s": float(np.mean(on) - np.mean(off)),
        "median_difference_s": float(np.median(on) - np.median(off)),
        "steady_round_wall_off_s": float(np.mean(s_off)),
        "steady_round_wall_on_s": float(np.mean(s_on)),
        "steady_difference_s": float(np.mean(s_on) - np.mean(s_off)),
        "steady_spread_off_s": float(np.max(s_off) - np.min(s_off)),
        "health_phase_mean_s": float(np.mean(
            [h for t in turns for h in t["health_s"] if h is not None])),
    }
    overhead["difference_frac"] = (
        overhead["difference_s"] / overhead["round_wall_off_s"])
    emit({"phase": "obs", "leg": "overhead", **overhead})
    emit({"phase": "obs", "leg": "fleet", **fleet})
    fused = legs["fused"]
    summary = {
        "phase": "obs", "leg": "summary",
        "wall_s": time.perf_counter() - t_phase,
        "fused_rounds": [
            {"round": r["round"], "phases": r["phases"],
             "body_s": r["body_s"], "unphased_s": r["unphased_s"],
             "device_s": r["device_s"],
             "host_wait_s": r["phases"]["host_wait"]}
            for r in fused["per_round"]],
        "b3": fused["kernel_counts"], "b3_blocks": fused["blocks"],
        "b1": legs["auto"]["kernel_counts"]["b1"],
        "b1_blocks": legs["auto"]["blocks"],
        "overhead_difference_s": overhead["difference_s"],
    }
    emit(summary)
    for ok, what in checks:
        if not ok:
            fail(f"obs check failed: {what}")
    shutil.rmtree(odir, ignore_errors=True)
    return {"legs": legs, "overhead": overhead, "fleet": fleet,
            "summary": summary}


def short_kernel_name(mangled):
    """``stage01_kernel<int16>`` or ``fir_v2_kernel<int16,16,8,6>`` from
    a mangled entry name (the kernels of csrc/ are templates over the
    element type, and the stage kernel over its copy width and its
    compiled (R, B))."""
    import re

    for name in ("stage01_kernel", "fused_cascade_kernel", "fir_v2_kernel",
                 "fir_decimate_kernel"):
        if name in mangled:
            tail = mangled.split(name, 1)[1]
            args = ["int16" if tail.startswith("Is") else "float"]
            args += re.findall(r"Li(\d+)E", tail.split("EEv", 1)[0])
            return f"{name}<{','.join(args)}>"
    return mangled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="dry run on the CPU at a small width; exits 3")
    ap.add_argument("--only",
                    choices=["fir", "fused", "fleet", "detect", "crash",
                             "pyramid", "obs"],
                    help="run phases 1, 2 and 3 (fir), 3b (fused), 8 "
                    "(fleet), 9 (detect), 10 (crash), 11 (pyramid) or 12 "
                    "(obs) alone; exits 4")
    ap.add_argument("--cycles", type=int, default=None,
                    help="killed cycles of each engine's crash drill "
                    "(default: fused 4, auto and fft 2)")
    args = ap.parse_args(argv)
    if args.rehearse:
        device = torch.device("cpu")
        widths, n_ch = (64, 48), 64
        members = REHEARSE_MEMBERS
        obs_members = REHEARSE_OBS_MEMBERS
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
        members = FLEET_MEMBERS
        obs_members = OBS_MEMBERS
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

    from tpudas_torch.ops._build import (
        build_info,
        build_libraries,
        kernel_resources,
    )

    resources = {}
    if device.type == "cuda":
        # every kernel at once: one nvcc per source, started together
        t0 = time.perf_counter()
        libs = ("fir_decimate", "fused_cascade", "hbm_probe")
        build_libraries(libs)
        resources = {n: kernel_resources(n) for n in libs}
        emit({"phase": "build", "wall_s": time.perf_counter() - t0,
              "libraries": {n: build_info(n) for n in libs},
              "kernels": resources})
        spills = {short_kernel_name(k): v for k, v in
                  resources["fir_decimate"].items()
                  if v.get("spill_stores") or v.get("spill_loads")}
        if spills:
            fail(f"stage kernels spill registers: {spills}")

    timer = Timer(device)
    if args.only == "fir":
        phase_kernels(device, widths, timer)
        print("chip_smoke: --only fir finished; no result", flush=True)
        return 4
    if args.only == "fused":
        phase_fused_kernel(device, widths, timer)
        print("chip_smoke: --only fused finished; no result", flush=True)
        return 4
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    cls = lfproc_class(force_tdas=args.rehearse)
    from tpudas_torch.proc.joint import JointProc

    jcls = lfproc_class(force_tdas=args.rehearse, base=JointProc)
    tdas_output = args.rehearse or importlib.util.find_spec("h5py") is None
    if args.only in ("fleet", "detect", "crash", "pyramid", "obs"):
        from tpudas_torch.testing import make_synthetic_spool

        shutil.rmtree(workdir, ignore_errors=True)
        make_synthetic_spool(
            os.path.join(workdir, "src"), n_files=3, file_duration=60.0,
            fs=1000.0, n_ch=n_ch, noise=NOISE, format="tdas", start=T0,
            write_kwargs={"dtype": "int16", "scale": QSCALE})
        if args.only == "fleet":
            phase_fleet(device, workdir, cls, members, timer)
        elif args.only == "crash":
            phase_crash(device, workdir, n_ch, tdas_output, args.cycles)
        elif args.only == "pyramid":
            phase_pyramid(device, workdir, cls, timer)
        elif args.only == "obs":
            phase_obs(device, workdir, cls, obs_members)
        else:
            batch_references(device, workdir, jcls)
            phase_detect(device, workdir, timer, cls, jcls)
        shutil.rmtree(workdir, ignore_errors=True)
        print(f"chip_smoke: --only {args.only} finished; no result",
              flush=True)
        return 4
    probes = phase_hbm_probe(device, args.rehearse)
    plan, main_cases, paths = phase_kernels(device, widths, timer)
    fused_cases = phase_fused_kernel(device, widths, timer)
    res = phase_main_path(device, n_ch, MAIN_PATH_SECONDS, workdir, cls)
    rt = phase_realtime(device, workdir, cls)
    phase_fft(device, workdir, cls)
    phase_joint(device, workdir, jcls)
    fleet = phase_fleet(device, workdir, cls, members, timer)
    detect = phase_detect(device, workdir, timer, cls, jcls)
    phase_crash(device, workdir, n_ch, tdas_output, args.cycles)
    pyramid = phase_pyramid(device, workdir, cls, timer)
    obs = phase_obs(device, workdir, cls, obs_members)
    shutil.rmtree(workdir, ignore_errors=True)
    fleet_counts = {leg: fleet["legs"][leg]["batched"]["kernel_counts"]
                    for leg in ("fused", "auto")}

    recs = main_cases[(widths[0], True)]  # the main path's shapes
    narrow = main_cases[(widths[1], True)]
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
        # phase 8's batched auto fleet: B1 chains, stacked and solo
        "fleet_launches": fleet_counts["auto"]["b1"],
        # phase 9c: the real-time joint product's rewind windows
        "detect_joint_launches": detect["joint"]["b1_launches"],
        # phase 11b: the auto stream with the pyramid on
        "pyramid_launches": pyramid["b"]["fir_decimate_launches"],
        # phase 12b: the auto stream with health and flight on
        "obs_launches": obs["legs"]["auto"]["kernel_counts"]["b1"],
        "launches_by_width": res["fir_decimate_launches_by_width"],
        "ms_by_stage": [r["ms"] for r in recs],
        "cold_ms_by_stage": [r["cold_ms"] for r in recs],
        "bound_ms_by_stage": [r["bound_ms"] for r in recs],
        "window_path_ms": paths[widths[0]]["window_path_ms"],
        "window_path_plain_ms": paths[widths[0]]["window_path_plain_ms"],
        "window_path_device_ms": paths[widths[0]]["window_path_device_ms"],
        "device_ms_by_stage": [r["device_ms"] for r in recs],
        f"ms_by_stage_{widths[1]}ch": [r["ms"] for r in narrow],
        "kernels": {short_kernel_name(k): v for k, v in
                    resources.get("fir_decimate", {}).items()},
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
        "one_kernel_ms": full["one_kernel_ms"],
        "kernel_a_ms": full["kernel_a_ms"],
        "kernel_b_ms": full["kernel_b_ms"],
        "kernel_launches": rt["fused"]["fused_cascade_kernel_launches"],
        # phase 8's batched fused fleet: B3 steps, stacked and solo
        "fleet_launches": fleet_counts["fused"]["b3_steps"],
        # phase 9a: detection on the fused stream (resumed run)
        "detect_launches": detect["fused"]["b3_steps"],
        # phase 11a: the fused stream with the pyramid on
        "pyramid_launches": pyramid["a"]["fused_cascade_launches"],
        # phase 12a: the fused stream with health, flight, detection and
        # the pyramid on (2 calls, 4 rounds)
        "obs_launches": obs["legs"]["fused"]["kernel_counts"]["b3_steps"],
        "fleet_packed_ms": fleet["packed_step"].get("b3_packed_ms"),
        "fleet_solo_sum_ms": fleet["packed_step"].get("b3_solo_sum_ms"),
        "b1_chain_ms": full["b1_chain_ms"],
        "conv1d_chain_ms": full["conv1d_chain_ms"],
        "ms_by_block": {f"{n} out": fused_cases[(widths[0], True, n)]["ms"]
                        for n in (60, 8, 1)},
        "one_kernel_ms_by_block": {
            f"{n} out": fused_cases[(widths[0], True, n)]["one_kernel_ms"]
            for n in (60, 8, 1)},
        "kernels": {short_kernel_name(k): v for k, v in
                    resources.get("fused_cascade", {}).items()},
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
