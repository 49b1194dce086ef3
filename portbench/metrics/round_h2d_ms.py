"""Milliseconds a real-time round spent copying its stream blocks to
the device: the program's ``stream.h2d`` spans over the window's rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.h2d")
