"""Milliseconds a real-time round spent copying its filtered blocks
back to the host: the program's ``stream.fetch`` spans over the
window's rounds (``tpudas_stream_round_phase_seconds{phase="host_wait"}``
count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.fetch")
