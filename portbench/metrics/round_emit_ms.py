"""Milliseconds a real-time round spent on the host turning its fetched
blocks into outputs (the FFT stream's seam join and lerp, the skip and
the output writes it calls): the program's ``stream.emit`` spans over
the window's rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.emit")
