"""Milliseconds a real-time round spent copying its stream blocks to
the device: the program's ``stream.h2d`` spans over the window's rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count)."""


def read(ctx):
    reg = ctx["registry"]
    spans = reg.get("tpudas_span_seconds")
    phases = reg.get("tpudas_stream_round_phase_seconds")
    if spans is None or phases is None:
        return None
    rounds = phases.snapshot(phase="host_wait")["count"]
    snap = spans.snapshot(name="stream.h2d")
    if not rounds or not snap["count"]:
        return None
    return 1000.0 * snap["sum"] / rounds
