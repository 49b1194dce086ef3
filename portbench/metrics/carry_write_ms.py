"""Milliseconds a real-time round spent writing the stream's carry: the
``.npz`` streamed into its tmp file under its crc, and it and its
sidecars renamed (``.prev`` rotation included), the program's
``stream.carry_write`` spans inside ``stream.carry_save`` over the
window's rounds (``tpudas_stream_round_phase_seconds{phase="host_wait"}``
count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "stream.carry_write")
