#!/usr/bin/env python3
"""On-card smoke run of tpudas_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # on a machine with one CUDA card

Drives the port's main path on the card — the flagship 1 kHz -> 1 Hz
zero-phase low-pass + decimation through ``LFProc.process_time_range``
over a synthetic int16 tdas spool at the north-star width of 10,000
channels — and holds the hand-written CUDA kernel against its plain
PyTorch version at every stage shape that path gives it.  Phases, each
printing one JSON line:

1. environment (versions, card, power limit, optional packages);
2. build of ``tpudas_torch/csrc/fir_decimate.cu`` with nvcc (sm_90a);
3. kernel vs plain at the flagship stage shapes of a 60 s window at
   10,000 and 2,048 channels, float32 and int16, plus a ragged case, a
   long-tap case and all-zero input; per-channel relative error must be
   <= 1e-5 and zeros exact; kernel, plain and ``conv1d`` times from
   CUDA events, with the bound of each case;
4. ``LFProc`` over 180 s x 10,000 channels of int16 tdas: every window
   on the CUDA kernel, ``fir_decimate.launches == 4 x windows``, the
   output tiles the 1 Hz grid, and the synthetic LF component is
   recovered within 0.01.

Then the kernel summary line, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA card it exits 2 before any phase.
``--rehearse`` runs the same phases on the CPU at a small width with
the plain stages (no kernel, no timings worth reading) and exits 3: a
dry run of the control flow, never a result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
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


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


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


def stage_bound_ms(T, C, in_bytes, n_out, taps):
    by = T * C * in_bytes + n_out * C * 4
    ops = 2.0 * taps * n_out * C
    t_b, t_o = by / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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
    bound, bound_by = stage_bound_ms(T, C, x.element_size(), k, taps)
    rec = {"case": label, "T": T, "C": C, "dtype": str(x.dtype).split(".")[-1],
           "R": R, "taps": taps, "n_out": k, "max_rel_err": rel,
           "max_abs_err": abs_err, "bound_ms": bound, "bound_by": bound_by}
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


def phase_main_path(device, n_ch, seconds, workdir):
    from tpudas_torch.core.timeutils import build_time_grid
    from tpudas_torch.io.spool import spool
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.proc.lfproc import LFProc, schedule_windows
    from tpudas_torch.proc.naming import get_filename
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
    have_h5py = importlib.util.find_spec("h5py") is not None

    class TdasOutputLFProc(LFProc):
        """Writes each output patch as tdas under the LFDAS_ stem."""

        def _write_output(self, patch, path):
            write_tdas(patch, os.path.splitext(path)[0] + ".tdas")

    cls = LFProc if have_h5py else TdasOutputLFProc
    lfp = cls(spool(src).sort("time").update(), device=device)
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=60, edge_buff_size=10,
    )
    lfp.set_output_folder(out, delete_existing=True)
    bg = np.datetime64(T0, "ns")
    ed = bg + np.timedelta64(int(n_files * file_sec), "s")
    grid = build_time_grid(bg, ed, 1.0)
    wins = schedule_windows(len(grid), 60, 10)
    expect_windows = len(wins)
    expect_stems = sorted(
        os.path.splitext(get_filename(grid[el], grid[eh - 1]))[0]
        for _, _, el, eh in wins
    )
    fir_decimate.launches = 0
    t0 = time.perf_counter()
    lfp.process_time_range(bg, ed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fir_decimate.launches
    windows = sum(lfp.engine_counts.values())
    names = sorted(os.listdir(out))
    merged = spool(out).update().chunk(time=None)
    if len(merged) != 1:
        fail(f"output does not merge into one patch ({len(merged)})")
    p = merged[0]
    times = p.coords["time"]
    steps = np.diff(times.astype("datetime64[ns]").astype(np.int64))
    data = p.host_data()
    dists = p.coords["distance"]
    s = np.sin(2 * np.pi * LF_FREQ * (
        (times - bg).astype("timedelta64[ns]").astype(np.int64) / 1e9))
    a = (data * s[:, None]).sum(0) / (s @ s)  # per-channel regression
    resid = np.abs(data - s[:, None] * a[None, :]).max(0) / np.abs(a)
    truth_amp = 1.0 + dists / (dists.max() + 1.0)  # the synthetic ramp
    amp_err = np.abs(a - truth_amp) / truth_amp
    res = {
        "phase": "main_path", "channels": n_ch, "seconds": n_files * file_sec,
        "fs": 1000.0, "payload": "int16 tdas", "setup_s": setup_s,
        "output_format": "dasdae" if have_h5py else "tdas (no h5py)",
        "windows": windows, "expected_windows": expect_windows,
        "engine_counts": lfp.engine_counts,
        "quantized_windows": lfp.quantized_windows,
        "fir_decimate_launches": launches, "wall_s": wall,
        "s_per_window": wall / max(windows, 1), "timings": lfp.timings,
        "realtime_factor": n_files * file_sec / wall,
        "outputs": len(names), "output_rows": int(data.shape[0]),
        "lf_fit_max_resid": float(resid.max()),
        "lf_amp_max_rel_err": float(amp_err.max()),
        "finite": bool(np.isfinite(data).all()),
    }
    emit(res)
    if not have_h5py:
        print("main path: h5py is missing, so outputs were written as tdas "
              "under the LFDAS_ stem", flush=True)
    ran = "cascade-cuda" if device.type == "cuda" else "cascade-torch"
    want_launches = 4 * windows if device.type == "cuda" else 0
    checks = [
        (windows == expect_windows, "window count"),
        (lfp.engine_counts[ran] == windows, f"every window ran {ran}"),
        (lfp.quantized_windows == windows, "every window shipped int16"),
        (launches == want_launches, f"launches {launches} != {want_launches}"),
        (all(n.startswith("LFDAS_") for n in names), "LFDAS_ names"),
        (bool(np.all(steps == 1_000_000_000)), "1 Hz grid without gaps"),
        ([os.path.splitext(n)[0] for n in names] == expect_stems,
         "output names follow the window schedule"),
        (int(data.shape[0]) == wins[-1][3] - wins[0][2],
         "output rows cover the schedule"),
        (res["finite"], "finite output"),
        (res["lf_fit_max_resid"] < 0.01, "LF fit residual < 0.01"),
        (res["lf_amp_max_rel_err"] < 0.01, "LF amplitude error < 0.01"),
    ]
    for ok, what in checks:
        if not ok:
            fail(f"main path check failed: {what}")
    shutil.rmtree(workdir, ignore_errors=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="dry run on the CPU at a small width; exits 3")
    args = ap.parse_args(argv)
    if args.rehearse:
        device = torch.device("cpu")
        widths, n_ch = (64, 48), 64
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                  "False); nothing was run", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        widths, n_ch = (10000, 2048), 10000
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line() if device.type == "cuda" else "cpu rehearsal"
    emit({
        "phase": "environment", "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "nvidia_smi": smi,
        "h5py": importlib.util.find_spec("h5py") is not None,
        "pandas": importlib.util.find_spec("pandas") is not None,
    })

    from tpudas_torch.ops import fir_kernel
    from tpudas_torch.ops._build import build_info

    if device.type == "cuda":
        t0 = time.perf_counter()
        fir_kernel._kernel_lib()
        info = build_info("fir_decimate")
        emit({"phase": "build", "wall_s": time.perf_counter() - t0, **info})

    timer = Timer(device)
    plan, main_cases = phase_kernels(device, widths, timer)
    res = phase_main_path(device, n_ch, MAIN_PATH_SECONDS,
                          os.path.join(os.path.dirname(os.path.abspath(
                              __file__)), "build", "chip_smoke"))

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
        "library_ms": sum(r["library_ms"] for r in recs),
        "shape": (f"the 4 flagship stages of one 60 s window, "
                  f"{widths[0]} ch int16"),
    }
    emit({"kernels": [kernel]})
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
