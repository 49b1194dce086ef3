"""``dascore.utils`` over the port."""

from tpudas_torch.compat.dascore.utils import mapping

__all__ = ["mapping"]
