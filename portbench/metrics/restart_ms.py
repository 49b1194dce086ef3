"""Mean milliseconds of a real-time runner's start: the program's
``stream.runner_start`` spans, around ``build_runner`` (its output
folder's startup audit among it) in ``run_lowpass_realtime``."""


def read(ctx):
    hist = ctx["registry"].get("tpudas_span_seconds")
    if hist is None:
        return None
    snap = hist.snapshot(name="stream.runner_start")
    if not snap["count"]:
        return None
    return 1000.0 * snap["sum"] / snap["count"]
