"""The FFT stream's share of its roofline in the catch-up window: the
least time of every overlap-save step of a replay (the block's int16
rows read once, its float32 filtered rows written once, the float32
carry read and written once, two real FFTs of the step's 5-smooth
length a channel; ``portbench.yardstick.cost.fft_step_cost``) over the
blocks the stream's reference schedules, times the replays, at the
published peaks, over the traced time of every kernel of the window
(the FFT stream is all the cell's device work)."""

import math

from portbench.harness.trace import kernel_seconds
from portbench.yardstick import cost, plan


def read(ctx):
    if ctx["trace"] is None:
        return None
    spent = kernel_seconds(ctx["trace"])
    if not spent:
        return None
    cfg, pool = ctx["config"], ctx["pool"]
    dt_out = float(cfg["output_sample_interval"])
    buff = math.ceil(float(cfg["edge_buffer"]) / dt_out)
    carry = 2 * -(-buff * plan.step_ns(dt_out) // int(pool["dt_ns"]))
    least = sum(
        cost.bound_s(cost.fft_step_cost(plan.next_5smooth(r1 - r0),
                                        r1 - r0 - carry, carry,
                                        int(pool["n_ch"]), 2))
        for r0, r1, _idx in ctx["segments"])
    return 100.0 * least * ctx["jobs"] / spent
