"""``dascore.utils.mapping`` over the port (``FrozenDict``)."""

from tpudas_torch.core.mapping import FrozenDict

__all__ = ["FrozenDict"]
