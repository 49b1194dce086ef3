"""The single place that decides which device the port runs on.

Entry points take an explicit ``device`` argument.  ``None`` means the
CUDA card, and raises when there is none: the port never drops to the
CPU on its own, because a CPU run of a GPU pipeline is a different
program (other kernels, other speed).  ``"cpu"`` is the explicit
request the tests make; the kernels' wrappers then run their plain
PyTorch versions.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> a CUDA device (raises when
    CUDA is unavailable); ``"cpu"`` -> the CPU; anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"tpudas_torch runs on 'cuda' or 'cpu', got {str(dev)!r}"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return dev
