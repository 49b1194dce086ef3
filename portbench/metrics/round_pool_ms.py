"""Milliseconds a real-time round spent pooling its payload: the
program's ``stream.pool`` spans (the residual joined to the new rows,
each block made contiguous) over the window's rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.pool")
