"""Probe: HBM read rate of the head-copy kernels vs tile geometry.

    python -m tpudas_torch.tools.probe_pipeline [--T 129024] [--C 2048]

The counterpart of ``tools/probe_pipeline.py`` on the CUDA card: the
same geometry lists at the same size (T = 129,024 rows x C = 2,048
float32 channels, 1.057 GB).  P1 (:func:`~tpudas_torch.ops.hbm_probe.copy_heads`)
reads every (rows, cb) tile — ``cb*4`` contiguous bytes per row — in
the default or the ``k_fastest`` block order; P2
(:func:`~tpudas_torch.ops.hbm_probe.copy_heads_pstream`) keeps P tiles
in flight per block.  Each line gives ms per call, the read rate and its
share of the H100's data-sheet rate
(:data:`~tpudas_torch.device.HBM_BYTES_PER_S`), with the bytes actually
read as the numerator (``t_eff`` rows for P2, which can be fewer than
T).  Times come from :func:`tpudas_torch.tools.harness.measure` (CUDA
events); the card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import subprocess

from tpudas_torch.device import HBM_BYTES_PER_S
from tpudas_torch.ops.hbm_probe import copy_heads, copy_heads_pstream, heads_rows
from tpudas_torch.tools.harness import measure

__all__ = [
    "C", "T", "HBM_BYTES_PER_S", "P1_GEOMETRIES", "P2_GEOMETRIES",
    "card_line", "p1_records", "p2_records", "main",
]

C = 2048
T = 129024  # 16128 * 8

# (rows, cb, k_fastest), as tools/probe_pipeline.py:120-130
P1_GEOMETRIES = (
    (1024, 128, False),
    (1024, 512, False),
    (1024, 1024, False),
    (512, 2048, False),
    (256, 2048, False),
    (1024, 2048, False),
    (2048, 2048, False),
    (1024, 128, True),
    (1024, 512, True),
)
# (P, rows, cb), as tools/probe_pipeline.py:147-154
P2_GEOMETRIES = (
    (1, 1024, 128),
    (2, 1024, 128),
    (4, 1024, 128),
    (8, 1024, 128),
    (4, 512, 128),
    (4, 1024, 256),
)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def _record(label, t_eff, C, dt, **geom):
    read = t_eff * C * 4
    written = read // 8
    return {
        "probe": label, **geom, "t_eff": t_eff, "ms": dt * 1e3,
        "read_bytes": read, "written_bytes": written,
        "read_bytes_per_s": read / dt,
        "share_of_peak": read / dt / HBM_BYTES_PER_S,
        "bound_ms": (read + written) / HBM_BYTES_PER_S * 1e3,
    }


def p1_records(T=T, C=C, device=None, iters=96):
    """One record per P1 geometry: ms, bytes read, read rate, share of
    the data-sheet rate and the bound (bytes read + written over it)."""
    recs = []
    for rows, cb, kf in P1_GEOMETRIES:
        dt = measure(lambda x, r=rows, c=cb, k=kf: copy_heads(x, r, c, k),
                     T, C, iters, device=device)
        recs.append(_record("P1", heads_rows(T, rows), C, dt, rows=rows,
                            cb=cb, k_fastest=bool(kf)))
    return recs


def p2_records(T=T, C=C, device=None, iters=96):
    """One record per P2 geometry, rates over ``t_eff`` rows."""
    recs = []
    for P, rows, cb in P2_GEOMETRIES:
        dt = measure(
            lambda x, p=P, r=rows, c=cb: copy_heads_pstream(x, p, r, c),
            T, C, iters, device=device,
        )
        recs.append(_record("P2", heads_rows(T, rows, P), C, dt, P=P,
                            rows=rows, cb=cb))
    return recs


def _line(rec):
    geom = (f"P={rec['P']} rows={rec['rows']:5d} cb={rec['cb']:4d}      "
            if rec["probe"] == "P2" else
            f"rows={rec['rows']:5d} cb={rec['cb']:5d} "
            f"kfast={int(rec['k_fastest'])}")
    gbps = rec["read_bytes_per_s"] / 1e9
    return (f"{geom}  {rec['ms']:7.3f} ms  {gbps:7.1f} GB/s "
            f"({rec['share_of_peak'] * 100:4.1f}% of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def main(argv=None):
    """Run the sweep, print one line per geometry, return the records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--C", type=int, default=C)
    ap.add_argument("--iters", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions (a dry run, no device numbers)")
    args = ap.parse_args(argv)
    print(card_line() if args.device != "cpu" else "cpu dry run", flush=True)
    recs = []
    for rec in p1_records(args.T, args.C, args.device, args.iters):
        print(_line(rec), flush=True)
        recs.append(rec)
    # the P-stream question: does keeping more tiles in flight lift the
    # single-stream rate?
    for rec in p2_records(args.T, args.C, args.device, args.iters):
        print(_line(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
