"""B1's share of its roofline in the archive window: the least time of
every window's cascade (input read once, output written once, two
operations a tap and output; ``portbench.yardstick.cost``) at the
published peaks, over the traced time of the strided-FIR kernel."""

from portbench.harness.trace import kernel_seconds
from portbench.yardstick import cost, plan


def read(ctx):
    if ctx["trace"] is None:
        return None
    spent = kernel_seconds(ctx["trace"], "fir_v2_kernel")
    if not spent:
        return None
    cfg = ctx["config"]
    dt = float(cfg["output_sample_interval"])
    fs = float(cfg["fs_hz"])
    stages = plan.cascade(fs, int(round(dt * fs)), plan.corner_hz(dt),
                          int(cfg["filter_order"]))
    n_ch = int(ctx["pool"]["n_ch"])
    least = sum(
        cost.bound_s(cost.stages_step_cost(stages, [0] * len(stages),
                                           r1 - r0, n_ch, 2))
        for r0, r1, _ in ctx["segments"])
    return 100.0 * least * ctx["jobs"] / spent
