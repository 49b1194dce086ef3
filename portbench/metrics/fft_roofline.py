"""The FFT engine's share of its roofline in the archive window: the
least time of every window (int16 input read once, output written
once, two real FFTs of the window's 5-smooth length a channel;
``portbench.yardstick.cost``) at the published peaks, over the traced
time of every kernel of the window (the FFT engine is all the cell's
device work)."""

from portbench.harness.trace import kernel_seconds
from portbench.yardstick import cost, plan


def read(ctx):
    if ctx["trace"] is None:
        return None
    spent = kernel_seconds(ctx["trace"])
    if not spent:
        return None
    n_ch = int(ctx["pool"]["n_ch"])
    least = sum(
        cost.bound_s(cost.fft_window_cost(plan.next_5smooth(r1 - r0), r1 - r0,
                                          len(idx), n_ch, 2))
        for r0, r1, idx in ctx["segments"])
    return 100.0 * least * ctx["jobs"] / spent
