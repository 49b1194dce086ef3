"""The card time an archive pass holds: the union of the device's
kernels, copies and sets over the window (the profiler's trace), over
the window's passes, in milliseconds.  The card's share of a pass, and
its floor once the host read no longer paces it."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["busy_s"] or not ctx["jobs"]:
        return None
    return 1000.0 * tr["busy_s"] / ctx["jobs"]
