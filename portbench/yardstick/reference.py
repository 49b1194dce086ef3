"""The check that decides ``correct``: the outputs the timed path wrote,
read back from their files, against a plain float64 reference worked
out from the configuration and the pool.

Every output of the low-pass product is a linear combination of the
input samples, so the reference builds the matrix ``M`` (outputs x
pool rows) of those combinations from the configuration's reference
module (``portbench/reference/<engine>.py``) and the cell's schedule of
outputs, and computes ``M @ X`` in float64 over the pool's samples, a
block of channels at a time.  The control is the same product in the
nearest precision below the configuration's float32 with TF32 off:
TF32 (``M`` and the samples rounded to 10 mantissa bits, products
summed in float32), the step a later change that moved the filter onto
the tensor cores would take.

The compared numbers:

- ``missing_outputs``: due output times absent from a folder, plus
  times present that are not due, over every folder checked (limit 0);
- ``max_rel_err``: over every folder, channel and due time, the largest
  ``|y - ref|`` over the channel's largest ``|ref|``.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from portbench.yardstick import tdasfmt

PB_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_engine_reference(name: str, pb_dir: str = PB_DIR):
    """``portbench/reference/<name>.py``, loaded by its file."""
    path = os.path.join(pb_dir, "reference", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pb_reference_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operator(cfg, pool, segments, pb_dir: str = PB_DIR):
    """(times_ns, M): the due output times in order and their float64
    rows over the pool.  ``segments`` is a list of (r0, r1, grid
    indices): a stretch of rows [r0, r1) the program filtered as one
    piece, and the output grid points it emits; rows before the pool
    (r0 < 0) are the zeros a stream starts from."""
    ref = load_engine_reference(cfg["reference"], pb_dir)
    dt_ns, t0_ns = pool["dt_ns"], pool["t0_ns"]
    n_rows = pool["rows_file"] * pool["n_files"]
    step = int(float(cfg["output_sample_interval"]) * 1000) * 1_000_000
    times, rows = [], []
    for r0, r1, grid_idx in segments:
        tns = t0_ns + np.asarray(grid_idx, np.int64) * step
        centre = (tns - t0_ns) // dt_ns
        block = ref.window_rows(cfg, r0, r1, centre, tns, t0_ns, dt_ns)
        full = np.zeros((len(tns), n_rows))
        full[:, max(r0, 0):r1] = block[:, max(-r0, 0):]
        times.append(tns)
        rows.append(full)
    times = np.concatenate(times)
    if len(np.unique(times)) != len(times):
        raise ValueError("an output time is due twice")
    return times, np.concatenate(rows)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest,
    ties to even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def apply(M: np.ndarray, pool_x: np.ndarray, scale: float, device,
          precision: str = "float64", block: int = 1024) -> np.ndarray:
    """``M @ (pool_x * scale)``: float64, or the TF32 control."""
    dev = torch.device(device)
    n_ch = pool_x.shape[1]
    out = np.empty((M.shape[0], n_ch))
    xq = torch.from_numpy(np.ascontiguousarray(pool_x)).to(dev)
    if precision == "float64":
        Mt = torch.from_numpy(M).to(dev)
    else:
        Mt = tf32_round(torch.from_numpy(M).to(dev, torch.float32))
    s32 = torch.tensor(np.float32(scale), device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c0 in range(0, n_ch, block):
            xb = xq[:, c0:c0 + block]
            if precision == "float64":
                y = Mt @ (xb.to(torch.float64) * float(np.float32(scale)))
            else:
                y = Mt @ tf32_round(xb.to(torch.float32) * s32)
            out[:, c0:c0 + block] = y.double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def read_folder(folder) -> tuple:
    """(times_ns, rows) of every ``LFDAS_*`` tdas output in ``folder``,
    sorted by time."""
    times, rows = [], []
    for name in sorted(os.listdir(folder)):
        if not (name.startswith("LFDAS_") and name.endswith(".tdas")):
            continue
        hdr, data = tdasfmt.read(os.path.join(folder, name))
        times.append(tdasfmt.times_ns(hdr))
        rows.append(data)
    if not times:
        return np.zeros(0, np.int64), np.zeros((0, 0))
    times = np.concatenate(times)
    order = np.argsort(times, kind="stable")
    return times[order], np.concatenate(rows)[order]


def compare(times, got_times, got, ref, denom) -> tuple:
    """(missing, max_rel_err) of one folder's outputs against the
    reference rows ``ref`` at ``times``."""
    want = set(times.tolist())
    have = got_times.tolist()
    missing = len(want - set(have)) + sum(t not in want for t in have)
    missing += len(have) - len(set(have))  # a time written twice
    pos = {t: i for i, t in enumerate(times.tolist())}
    keep = [i for i, t in enumerate(have) if t in pos]
    if not keep:
        return missing, float("inf") if want else 0.0
    if got.shape[1] != ref.shape[1]:
        return missing + len(want), float("inf")
    idx = np.array([pos[have[i]] for i in keep])
    err = np.abs(got[keep] - ref[idx]).max(axis=0) / denom
    err = np.where(np.isfinite(got[keep]).all(axis=0), err, np.inf)
    return missing, float(err.max())


def denominators(ref: np.ndarray) -> np.ndarray:
    """Each channel's largest ``|ref|`` (1 where a channel is all 0)."""
    d = np.abs(ref).max(axis=0)
    return np.where(d > 0, d, 1.0)
