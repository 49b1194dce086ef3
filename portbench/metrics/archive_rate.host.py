"""``archive_rate`` where it is read per layer: input channel-samples
that the window's archive passes committed to output files, over the
wall of the whole window, in millions a second (the harness's clock,
in the traced run)."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return ctx["work_samples"] / ctx["window_s"] / 1e6
