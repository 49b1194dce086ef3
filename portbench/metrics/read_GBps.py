"""The host read's rate timed from inside the program: the payload
bytes the window reads returned (``tpudas_window_read_bytes_total``)
over the seconds of the program's own ``lfproc.load_window`` spans
(``tpudas_span_seconds``), in GB a second.  The span covers the read
alone; ``host_read_GBps`` times ``LFProc._load_window`` whole."""


def read(ctx):
    reg = ctx["registry"]
    nbytes = reg.get("tpudas_window_read_bytes_total")
    hist = reg.get("tpudas_span_seconds")
    if nbytes is None or hist is None:
        return None
    seconds = hist.snapshot(name="lfproc.load_window")["sum"]
    if not seconds or not nbytes.value():
        return None
    return nbytes.value() / seconds / 1e9
