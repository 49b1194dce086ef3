"""The share of the member device steps that the batched fleet ran in a
stacked launch, in per cent: ``tpudas_fleet_batch_stacked_members_total``
over that plus ``tpudas_fleet_batch_solo_launches_total`` (the program's
counters, over the window)."""


def read(ctx):
    reg = ctx["registry"]
    stacked = reg.value("tpudas_fleet_batch_stacked_members_total")
    steps = stacked + reg.value("tpudas_fleet_batch_solo_launches_total")
    return 100.0 * stacked / steps if steps else None
