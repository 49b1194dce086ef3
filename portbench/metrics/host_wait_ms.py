"""Mean milliseconds a real-time round spent in its ``host_wait`` phase
(``tpudas_stream_round_phase_seconds{phase="host_wait"}``, the program's
round-phase timeline) over the window's rounds."""


def read(ctx):
    hist = ctx["registry"].get("tpudas_stream_round_phase_seconds")
    if hist is None:
        return None
    snap = hist.snapshot(phase="host_wait")
    if not snap["count"]:
        return None
    return 1000.0 * snap["sum"] / snap["count"]
