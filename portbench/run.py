"""Run one cell of the port's benchmark (``BENCHMARK.json``) on this
machine's card and print its result as the last line of standard
output.

    python3 portbench/run.py --workload edge10k.archive --seed 7 \\
        --seconds 30 --trace 0

Set-up makes the cell's pool of tdas files from ``--seed`` (on the
card), builds the program's job or runner and runs one warm pass or
replay: every kernel is built and loaded before the window.  The window
then runs the traffic's driver closed loop for ``--seconds``.  With
``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the cell's per-layer metrics, with ``0`` its end-to-end ones;
a cell with an end-to-end metric read from the device's trace has the
card's work (and no host activity) recorded with ``0`` too.
Once the window has closed and the program's state is freed, the
outputs the window wrote are read back and compared with the plain
float64 reference (:mod:`portbench.yardstick.reference`); the numbers
compared and their limits are printed last on standard error and last
in the line.

Exits 2 with no result where there is no CUDA card, or fewer than the
cell asks for; 3 where the process holds a module of JAX or of the JAX
package once the window has closed; 4 where the checkout lacks the
program.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# the program's kernels build into build/tpudas_torch/ of the checkout;
# these caches of the libraries it may use stay in the checkout too
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_ROOT, "build", "portbench", "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(_ROOT, "build", "portbench", "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpudas")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or
    the JAX package's, compared whole: the port's ``tpudas_torch`` is
    another name."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".", 1)[0] for name in names}
                  & set(FORBIDDEN))


def pin_cpus() -> list:
    """Keep this process, and every thread it starts later, on the
    first half of the CPUs it may use; returns them.

    The program reads each file of a window on one thread, a copy out
    of the page cache whose rate depends on the CPU it runs on: on one
    8-vCPU H100 host, vCPUs 0-3 read a 60 s file at ~5.0 GB/s and 4-7
    at ~3.7 GB/s (on another, the other way round), and a thread the
    scheduler moves between them reads at either rate from one window
    to the next.  On one half the rate holds still within a run."""
    cpus = sorted(os.sched_getaffinity(0))
    keep = cpus[:max(1, len(cpus) // 2)]
    os.sched_setaffinity(0, keep)
    return keep


def verdict(missing, rel, limits) -> bool:
    """Whether one folder's outputs (or the control's) pass the cell's
    limits: no output missing or extra beyond ``missing_outputs``, and
    ``max_rel_err`` within its limit."""
    return (missing <= limits["missing_outputs"]
            and rel <= limits["max_rel_err"])


def _device_info(torch, device, chips, peak):
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": peak}


def run_cell(workload, seed, seconds, trace, device=None, root=None,
             config_overrides=None):
    """One run of ``workload``; returns (result dict, checks dict).
    ``device`` defaults to the first CUDA card; tests pass ``"cpu"``
    and shrink the configuration with ``config_overrides``."""
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness.drivers import load_driver
    from portbench.harness.program import Probe
    from portbench.harness.trace import summarize, traced
    from portbench.yardstick import datagen
    from portbench.yardstick import reference as ref_mod

    cell = cell_mod.resolve(workload, root or cell_mod.ROOT)
    cfg = dict(cell["config"], **(config_overrides or {}))
    traffic = cell["traffic"]
    device = torch.device(device or "cuda:0")
    cuda = device.type == "cuda"
    workdir = tempfile.mkdtemp(prefix="portbench-")
    probe = Probe()
    driver = None
    try:
        t_pool = time.perf_counter()
        pool = datagen.make_pool(cfg, seed, os.path.join(workdir, "pool"),
                                 device)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t_pool = time.perf_counter() - t_pool
        driver = load_driver(traffic["driver"], cell["pb_dir"])(
            cfg, traffic, pool, device, workdir, probe)
        driver.setup()
        setup_s = time.perf_counter() - _T_START

        from tpudas_torch.obs.registry import MetricsRegistry, use_registry

        registry = MetricsRegistry()
        probe.reset()
        # an end-to-end metric read from the device's trace has the
        # card's work recorded in every run, the host's only with --trace
        on_device = any(m["source"] == "device_trace"
                        for m in cell["end_to_end"])
        with use_registry(registry), traced(bool(trace) or on_device,
                                            device.type,
                                            host=bool(trace)) as tr:
            probe.tracing = bool(trace)
            window_s = driver.window(seconds, bool(trace))
            probe.tracing = False
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        ctx = {
            "cell": cell, "config": cfg, "traffic": traffic, "pool": pool,
            "setup_s": setup_s, "window_s": window_s,
            "work_samples": driver.work_samples(), "jobs": driver.jobs,
            "walls": list(driver.walls), "timings": driver.timings(),
            "load_s": probe.load_s, "load_bytes": probe.load_bytes,
            "registry": registry,
            "segments": driver.segments(cell["pb_dir"]), "trace": None,
        }
        driver.close()
        if tr.prof is not None:
            ctx["trace"] = summarize(tr.prof, workdir, probe.spans)
            tr.prof = None

        wanted = cell["per_layer"] if trace else cell["end_to_end"]
        metrics = {}
        for m in wanted:
            value = cell_mod.load_reader(m["name"], cell["pb_dir"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        folders = list(driver.folders)
        driver = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check: every folder the window wrote against the reference
        t_check = time.perf_counter()
        times, M = ref_mod.operator(cfg, pool, ctx["segments"],
                                   cell["pb_dir"])
        ref = ref_mod.apply(M, datagen.read_pool(pool), pool["scale"],
                            device)
        denom = ref_mod.denominators(ref)
        missing, worst, failed = 0, 0.0, 0
        lim = cell["limits"]
        for folder in folders:
            got_t, got = ref_mod.read_folder(folder)
            miss, rel = ref_mod.compare(times, got_t, got, ref, denom)
            missing += miss
            worst = max(worst, rel)
            if not verdict(miss, rel, lim):
                failed += 1
        checks = {
            "missing_outputs": {"value": missing,
                                "limit": lim["missing_outputs"]},
            "max_rel_err": {"value": worst, "limit": lim["max_rel_err"]},
        }
        correct = bool(folders) and failed == 0
        result = {
            "correct": correct,
            "attempted": len(folders),
            "failed": failed,
            "metrics": metrics,
            "device": _device_info(torch, device, cell["chips"], peak),
        }
        if trace and ctx["trace"] is not None:
            result["device"]["busy_s"] = ctx["trace"]["busy_s"]
            result["device"]["window_s"] = ctx["trace"]["window_s"]
            result["breakdown"] = {
                "device_ops": ctx["trace"]["device_ops"],
                "idle_gaps": ctx["trace"]["idle_gaps"],
            }
        result["checks"] = checks
        print(f"portbench: setup {setup_s:.3f} s (pool {t_pool:.3f} s), "
              f"window {window_s:.3f} s, "
              f"check {time.perf_counter() - t_check:.3f} s, "
              f"{len(folders)} folders", file=sys.stderr)
        w = sorted(ctx["walls"])
        print(f"portbench: {len(w)} pass or round walls, min {w[0]:.4f} "
              f"median {w[len(w) // 2]:.4f} max {w[-1]:.4f} sum {sum(w):.3f} "
              f"s; host read "
              f"{ctx['load_bytes'] / max(ctx['load_s'], 1e-9) / 1e9:.3f} "
              f"GB/s over {ctx['load_s']:.3f} s", file=sys.stderr)
        return result, checks
    finally:
        if driver is not None:
            driver.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cpus = pin_cpus()

    import importlib.util

    import torch

    from portbench.harness.cell import resolve

    if importlib.util.find_spec("tpudas_torch") is None:
        print("portbench: the program (tpudas_torch) is not in this "
              "checkout", file=sys.stderr)
        return 4
    chips = resolve(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: on CPUs {cpus[0]}-{cpus[-1]}", file=sys.stderr)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
