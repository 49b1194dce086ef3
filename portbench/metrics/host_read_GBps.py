"""The host read's rate: payload bytes the window's reads returned over
the seconds ``LFProc._load_window`` took (timed from the harness),
in GB a second."""


def read(ctx):
    if not ctx["load_s"] or not ctx["load_bytes"]:
        return None
    return ctx["load_bytes"] / ctx["load_s"] / 1e9
