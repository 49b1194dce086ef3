"""The batch driver's own host time a pass, in milliseconds: the
seconds of the program's ``lfproc.process_time_range`` spans less those
of its ``lfproc.read_wait`` (the wait on the prefetch thread's read),
``lfproc.compute`` (staged-copy wait, kernels, output sync) and
``lfproc.write_output`` spans, over the passes."""

_OUT = ("lfproc.read_wait", "lfproc.compute", "lfproc.write_output")


def read(ctx):
    hist = ctx["registry"].get("tpudas_span_seconds")
    if hist is None:
        return None
    passes = hist.snapshot(name="lfproc.process_time_range")
    inner = [hist.snapshot(name=n) for n in _OUT]
    if not passes["count"] or not all(s["count"] for s in inner):
        return None
    rest = passes["sum"] - sum(s["sum"] for s in inner)
    return 1000.0 * rest / passes["count"]
