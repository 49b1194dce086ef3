"""The device's idle share of the traced window: one less the
union of its kernels, copies and sets over the window, in per cent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
