"""The share of the carry leaves' bytes that the window's carry saves
copied from the card through a page-locked staging buffer, in per cent:
``tpudas_stream_carry_staged_bytes_total{path="pinned"}`` over that plus
``{path="direct"}``, the bytes of leaves already on the host (the
program's counter, over the window)."""


def read(ctx):
    reg = ctx["registry"]
    pinned = reg.value("tpudas_stream_carry_staged_bytes_total",
                       path="pinned")
    staged = pinned + reg.value("tpudas_stream_carry_staged_bytes_total",
                                path="direct")
    return 100.0 * pinned / staged if staged else None
