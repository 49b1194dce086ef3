"""Probe: HBM read rate of the ring reader vs ring geometry.

    python -m tpudas_torch.tools.probe_dma [--T 129024] [--C 2048]

The counterpart of ``tools/probe_dma.py`` on the CUDA card, at the same
size (T = 129,024 x C = 2,048 float32, 1.057 GB) and over the same
(rows, nbuf) list.  P3 (:func:`~tpudas_torch.ops.hbm_probe.ring_reader`)
runs one block per SM; each streams its share of the (rows, C) chunks
through an nbuf-slot shared-memory ring with nbuf - 1 bulk copies in
flight.  Beside it, two PyTorch calls over the same array: ``torch.sum``
(it reads every byte: the counterpart of the XLA reduce the TPU probe
was compared with) and a device-to-device ``copy_`` (reads and writes
every byte).  Each line gives ms per call, the read rate and its share
of the H100's data-sheet rate
(:data:`~tpudas_torch.device.HBM_BYTES_PER_S`); times come from
:func:`tpudas_torch.tools.harness.measure` (CUDA events).
"""

from __future__ import annotations

import argparse

import torch

from tpudas_torch.device import HBM_BYTES_PER_S
from tpudas_torch.ops.hbm_probe import ring_reader
from tpudas_torch.tools.harness import measure
from tpudas_torch.tools.probe_pipeline import C, T, card_line

__all__ = ["P3_GEOMETRIES", "library_records", "p3_records", "main"]

# (rows, nbuf), as tools/probe_dma.py:97-106
P3_GEOMETRIES = (
    (512, 2),
    (256, 2),
    (256, 4),
    (128, 4),
    (128, 8),
    (64, 8),
    (512, 4),
    (256, 8),
)


def p3_records(T=T, C=C, device=None, iters=96):
    """One record per P3 geometry: ms, bytes read (whole chunks), read
    rate, share of the data-sheet rate and the bound."""
    recs = []
    for rows, nbuf in P3_GEOMETRIES:
        dt = measure(lambda x, r=rows, n=nbuf: ring_reader(x, r, n),
                     T, C, iters, device=device)
        read = (T // rows) * rows * C * 4
        recs.append({
            "probe": "P3", "rows": rows, "nbuf": nbuf, "ms": dt * 1e3,
            "read_bytes": read, "written_bytes": 4,
            "read_bytes_per_s": read / dt,
            "share_of_peak": read / dt / HBM_BYTES_PER_S,
            "bound_ms": (read + 4) / HBM_BYTES_PER_S * 1e3,
        })
    return recs


def library_records(T=T, C=C, device=None, iters=96):
    """``torch.sum`` and a device-to-device ``copy_`` of the whole
    array: the yardsticks the port never calls."""
    n = T * C * 4
    out = {}

    def copy(x):
        dst = out.get("dst")
        if dst is None:
            dst = out["dst"] = torch.empty_like(x)
        dst.copy_(x)

    dt_sum = measure(torch.sum, T, C, iters, device=device)
    dt_copy = measure(copy, T, C, iters, device=device)
    return [
        {"probe": "torch.sum", "ms": dt_sum * 1e3, "read_bytes": n,
         "written_bytes": 4, "read_bytes_per_s": n / dt_sum,
         "share_of_peak": n / dt_sum / HBM_BYTES_PER_S,
         "bound_ms": (n + 4) / HBM_BYTES_PER_S * 1e3},
        {"probe": "copy_", "ms": dt_copy * 1e3, "read_bytes": n,
         "written_bytes": n, "read_bytes_per_s": n / dt_copy,
         "moved_bytes_per_s": 2 * n / dt_copy,
         "share_of_peak": 2 * n / dt_copy / HBM_BYTES_PER_S,
         "bound_ms": 2 * n / HBM_BYTES_PER_S * 1e3},
    ]


def _line(rec):
    if rec["probe"] == "P3":
        geom = f"rows={rec['rows']:4d} nbuf={rec['nbuf']}"
    else:
        geom = f"{rec['probe']:<14s}"
    gbps = rec["read_bytes_per_s"] / 1e9
    extra = (f", {rec['moved_bytes_per_s'] / 1e9:.1f} GB/s read + written"
             if "moved_bytes_per_s" in rec else "")
    return (f"{geom}  {rec['ms']:7.3f} ms  {gbps:7.1f} GB/s read "
            f"({rec['share_of_peak'] * 100:4.1f}% of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s{extra})")


def main(argv=None):
    """Run the sweep and the yardsticks, print one line each, return the
    records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--C", type=int, default=C)
    ap.add_argument("--iters", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions (a dry run, no device numbers)")
    args = ap.parse_args(argv)
    print(card_line() if args.device != "cpu" else "cpu dry run", flush=True)
    recs = p3_records(args.T, args.C, args.device, args.iters)
    recs += library_records(args.T, args.C, args.device, args.iters)
    for rec in recs:
        print(_line(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
