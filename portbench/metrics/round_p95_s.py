"""The 95th percentile of the window's real-time round walls (the
harness's clock, from the poll boundary before a round to the round's
``on_round`` callback), linear between order statistics."""

import numpy as np


def read(ctx):
    if not ctx["walls"]:
        return None
    return float(np.percentile(np.asarray(ctx["walls"]), 95))
