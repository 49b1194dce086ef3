"""The control of the check that decides ``correct``, and the faults a
cell can have, read on the card at the cell's own size.

    python3 portbench/control.py --workload edge10k.archive \\
        --seeds 11 12 13
    python3 portbench/control.py --workload edge10k.catchup \\
        --seeds 11 12 13 --fault state_unchanged --seconds 8

The control is the reference put in the program's place and computed
in TF32, the precision below the configurations' float32 with TF32 off.
For each seed it makes the cell's pool (without files), the outputs the
cell's traffic makes due, their float64 reference and the TF32
control, and judges the control by the cell's limits as a run judges a
folder.  With ``--fault`` it runs the cell for ``--seconds`` with the
fault planted in the program (:mod:`portbench.faults`) and reports the
run's own verdict.  Each seed prints one JSON line; both have to come
out ``"correct": false``.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def control_reading(workload, seed, device, root=None,
                    config_overrides=None) -> dict:
    """{"seed", "max_rel_err", "limit", "outputs"} of the control."""
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness.drivers import load_driver
    from portbench.yardstick import datagen
    from portbench.run import verdict
    from portbench.yardstick import reference as ref_mod

    cell = cell_mod.resolve(workload, root or cell_mod.ROOT)
    cfg = dict(cell["config"], **(config_overrides or {}))
    dev = torch.device(device)
    pool = datagen.describe(cfg, seed)
    x = datagen.pool_samples(cfg, seed, dev)
    traffic = cell["traffic"]
    segments = load_driver(traffic["driver"], cell["pb_dir"]).due(
        cfg, pool, traffic, cell["pb_dir"])
    times, M = ref_mod.operator(cfg, pool, segments, cell["pb_dir"])
    ref = ref_mod.apply(M, x, pool["scale"], dev)
    ctl = ref_mod.apply(M, x, pool["scale"], dev, precision="tf32")
    missing, rel = ref_mod.compare(times, times, ctl, ref,
                                   ref_mod.denominators(ref))
    return {"seed": seed, "correct": verdict(missing, rel, cell["limits"]),
            "max_rel_err": rel, "limit": cell["limits"]["max_rel_err"],
            "outputs": len(times)}


def fault_reading(workload, fault, seed, seconds, device) -> dict:
    """{"seed", "fault", "correct", "attempted", "failed", "checks"} of
    one run of ``workload`` with ``fault`` planted."""
    from portbench import faults
    from portbench.run import run_cell

    with faults.planted(fault, workload):
        result, checks = run_cell(workload, seed, seconds, 0, device=device)
    return {"seed": seed, "fault": fault, "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fault:
            rec = fault_reading(args.workload, args.fault, seed,
                                args.seconds, args.device)
        else:
            rec = control_reading(args.workload, seed, args.device)
        rec["workload"] = args.workload
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
