"""tpudas_torch: the PyTorch/CUDA port of tpudas.

The module layout mirrors ``tpudas/`` so each counterpart is found at
the same path.  The port imports torch, numpy, scipy and the standard
library only; the JAX package is its reference, never its dependency.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`tpudas_torch.device`).
"""

from tpudas_torch.device import resolve_device

__all__ = ["resolve_device"]
