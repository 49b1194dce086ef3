"""The share of the catch-up window that the runners spend outside
their rounds, in per cent: what the program's round-phase timeline
(every phase of every round, ``tpudas_stream_round_phase_seconds``)
leaves of the window's wall.  That is each replay's restart (the runner
built, its startup audit, the spool indexed), the last poll that finds
the backlog drained, and the runner's close."""

from tpudas_torch.obs.phases import PHASES


def read(ctx):
    hist = ctx["registry"].get("tpudas_stream_round_phase_seconds")
    if hist is None or not ctx["window_s"]:
        return None
    inside = sum(hist.snapshot(phase=p)["sum"] for p in PHASES)
    if not inside:
        return None
    return 100.0 * (1.0 - inside / ctx["window_s"])
