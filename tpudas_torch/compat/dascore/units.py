"""``dascore.units`` over the port (``from dascore.units import s``)."""

from tpudas_torch.core.units import (
    Quantity,
    Unit,
    get_seconds,
    h,
    minute,
    ms,
    ns,
    s,
    us,
)

__all__ = ["Quantity", "Unit", "ns", "us", "ms", "s", "minute", "h", "get_seconds"]
