"""B3's share of its roofline in the catch-up window: the least time of
each round's stateful cascade step over the round's new rows (input
read once, output and carry written once, the carry read once;
``portbench.yardstick.cost.stream_step_cost``) at the published peaks,
over the traced time of the fused step's kernels A and B."""

from portbench.harness.trace import kernel_seconds
from portbench.yardstick import cost, plan


def read(ctx):
    if ctx["trace"] is None:
        return None
    spent = kernel_seconds(ctx["trace"], "stage01_kernel",
                           "fused_cascade_kernel")
    if not spent:
        return None
    cfg = ctx["config"]
    dt = float(cfg["output_sample_interval"])
    fs = float(cfg["fs_hz"])
    stages = plan.cascade(fs, int(round(dt * fs)), plan.corner_hz(dt),
                          int(cfg["filter_order"]))
    pool = ctx["pool"]
    step = cost.bound_s(cost.stream_step_cost(stages, pool["rows_file"],
                                              int(pool["n_ch"]), 2))
    rounds = ctx["jobs"] * pool["n_files"]
    return 100.0 * step * rounds / spent
