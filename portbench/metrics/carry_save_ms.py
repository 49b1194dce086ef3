"""Milliseconds a real-time round spent committing the stream's carry
(serialized, rotated to ``.prev`` and written with its checksums): the
program's ``stream.carry_save`` spans over the window's rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count); a
runner's first save, of the unopened carry, is among them."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.carry_save")
