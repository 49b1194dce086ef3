"""The benchmark's interrogator: a pool of contiguous int16 tdas files
made from a seed, on the device.

The signal is that of ``tpudas_torch.testing.make_synthetic_spool``: a
low-frequency sine whose amplitude ramps over distance (what the
low-pass must keep), a high-frequency sine (what it must reject) and
white noise, quantized to int16 at a fixed scale.  The seed draws the
two phases and the noise; every seed gives the same sizes.  The samples
are made on the device in blocks of rows with a ``torch.Generator`` on
that device, so a 10,000-channel file costs a few large kernel calls
and one copy to the host per block.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.yardstick import tdasfmt

T0_NS = int(np.datetime64("2023-03-22T00:00:00", "ns").astype(np.int64))

_BLOCK_ELEMS = 1 << 26  # samples generated per device block


def seed_parts(seed: int) -> tuple:
    """(host seed, device seed): the phases and the noise of one seed."""
    seed = int(seed) % (1 << 63)
    return seed, (seed * 0x9E3779B97F4A7C15 + 1) % (1 << 63)


def signal_params(cfg: dict, seed: int) -> dict:
    """The seed's draw of the signal's phases, with the configured
    amplitudes and frequencies."""
    host_seed, _ = seed_parts(seed)
    rng = np.random.default_rng(host_seed)
    lf_phase, hf_phase = rng.uniform(0.0, 2.0 * math.pi, size=2)
    sig = cfg["signal"]
    return {"lf_freq": float(sig["lf_freq_hz"]),
            "hf_freq": float(sig["hf_freq_hz"]),
            "hf_amp": float(sig["hf_amp"]),
            "noise": float(sig["noise"]),
            "scale": float(np.float32(cfg["int16_scale"])),
            "lf_phase": float(lf_phase), "hf_phase": float(hf_phase)}


def make_block(cfg, params, row0, rows, gen, device) -> torch.Tensor:
    """(rows, n_ch) int16 samples of the stream from full-rate row
    ``row0`` (time from the pool's start, so phases run on across
    files)."""
    n_ch = int(cfg["n_ch"])
    fs = float(cfg["fs_hz"])
    t = (row0 + torch.arange(rows, device=device, dtype=torch.float64)) / fs
    d = torch.arange(n_ch, device=device, dtype=torch.float64) * float(
        cfg["d_ch_m"])
    amp = 1.0 + d / (d.max() + 1.0)
    lf = torch.sin(2 * math.pi * params["lf_freq"] * t + params["lf_phase"])
    hf = params["hf_amp"] * torch.sin(
        2 * math.pi * params["hf_freq"] * t + params["hf_phase"])
    x = (lf[:, None] * amp[None, :] + hf[:, None]).to(torch.float32)
    if params["noise"]:
        x += params["noise"] * torch.randn(rows, n_ch, device=device,
                                           generator=gen)
    q = torch.round(x / params["scale"]).clamp_(-32768, 32767)
    return q.to(torch.int16)


def file_samples(cfg, params, i, gen, device) -> np.ndarray:
    """File ``i`` of the pool: (rows a file, n_ch) int16 on the host."""
    n_ch = int(cfg["n_ch"])
    rows_file = int(round(float(cfg["file_seconds"]) * float(cfg["fs_hz"])))
    block = max(1, _BLOCK_ELEMS // n_ch)
    host = np.empty((rows_file, n_ch), np.int16)
    for r in range(0, rows_file, block):
        n = min(block, rows_file - r)
        q = make_block(cfg, params, i * rows_file + r, n, gen, device)
        host[r:r + n] = q.cpu().numpy()
    return host


def _generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_parts(seed)[1])
    return gen


def pool_samples(cfg: dict, seed: int, device) -> np.ndarray:
    """The whole pool's int16 samples, made as :func:`make_pool` makes
    them, without files."""
    params = signal_params(cfg, seed)
    gen = _generator(seed, device)
    return np.concatenate([file_samples(cfg, params, i, gen, device)
                           for i in range(int(cfg["pool_files"]))])


def make_pool(cfg: dict, seed: int, directory, device) -> dict:
    """Write the configuration's pool of ``pool_files`` contiguous
    files into ``directory`` (fsynced, so no write-back runs later).
    Returns the pool's description: paths, t0, step, rows a file,
    channels, scale."""
    os.makedirs(directory, exist_ok=True)
    params = signal_params(cfg, seed)
    gen = _generator(seed, device)
    rows_file = int(round(float(cfg["file_seconds"]) * float(cfg["fs_hz"])))
    dt_ns = int(round(1e9 / float(cfg["fs_hz"])))
    paths = []
    for i in range(int(cfg["pool_files"])):
        path = os.path.join(directory, f"raw_{i:04d}.tdas")
        tdasfmt.write(path, file_samples(cfg, params, i, gen, device),
                      T0_NS + i * rows_file * dt_ns, dt_ns,
                      scale=params["scale"], d0=0.0,
                      dx=float(cfg["d_ch_m"]), fsync=True)
        paths.append(path)
    return describe(cfg, seed, paths)


def describe(cfg, seed, paths=()) -> dict:
    """The pool's description: paths, t0, step, rows a file, channels,
    scale and the seed's signal parameters."""
    params = signal_params(cfg, seed)
    return {"paths": list(paths), "t0_ns": T0_NS,
            "dt_ns": int(round(1e9 / float(cfg["fs_hz"]))),
            "rows_file": int(round(float(cfg["file_seconds"])
                                   * float(cfg["fs_hz"]))),
            "n_files": int(cfg["pool_files"]),
            "n_ch": int(cfg["n_ch"]), "scale": params["scale"],
            "params": params}


def read_pool(pool: dict) -> np.ndarray:
    """The whole pool's raw int16 samples, (rows, n_ch), from its
    files."""
    parts = [tdasfmt.read(p, decode=False)[1] for p in pool["paths"]]
    return np.concatenate(parts, axis=0)
