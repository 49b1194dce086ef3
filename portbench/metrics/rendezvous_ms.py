"""Milliseconds a member's real-time round spent waiting at the batched
fleet's rendezvous for its peers: the program's ``fleet.rendezvous``
spans over the window's member rounds
(``tpudas_stream_round_phase_seconds{phase="host_wait"}`` count)."""

from portbench.harness.program import span_ms_per_round


def read(ctx):
    return span_ms_per_round(ctx, "fleet.rendezvous")
