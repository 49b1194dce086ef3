"""Mean milliseconds of one output write: the program's
``lfproc.write_output`` spans, around each call of
``LFProc._write_output``."""


def read(ctx):
    hist = ctx["registry"].get("tpudas_span_seconds")
    if hist is None:
        return None
    snap = hist.snapshot(name="lfproc.write_output")
    if not snap["count"]:
        return None
    return 1000.0 * snap["sum"] / snap["count"]
