"""The single place that decides which device the port runs on.

Entry points take an explicit ``device`` argument.  ``None`` means the
CUDA card, and raises when there is none: the port never drops to the
CPU on its own, because a CPU run of a GPU pipeline is a different
program (other kernels, other speed).  ``"cpu"`` is the explicit
request the tests make; the kernels' wrappers then run their plain
PyTorch versions.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = [
    "HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "default_device", "resolve_device",
]

# The card's data-sheet peaks, the port's one copy (NVIDIA H100 SXM data
# sheet): HBM3 bandwidth, and float32 FLOP/s without the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the process-wide default of default_device(); None: the card
_default = None
_default_lock = threading.Lock()


@contextlib.contextmanager
def default_device(device):
    """Make ``device`` what ``None`` means for the block, in every
    thread of the process: the port's counterpart of
    ``jax.default_device``.  It is process wide, not per thread or
    context, because the runners' prefetch and member threads (and a
    notebook's feeder threads) resolve devices too.  Outside it ``None``
    means the card and raises without one.  The port never enters it
    itself and no environment variable sets it: it lets code that
    passes no device (the notebooks, ``LFProc(sp)``) run on the CPU at
    the caller's request.  Nests; restores the previous default on
    exit.  Yields the resolved device."""
    global _default
    dev = resolve_device(device)
    with _default_lock:
        prev, _default = _default, dev
    try:
        yield dev
    finally:
        with _default_lock:
            _default = prev


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> a CUDA device (raises when
    CUDA is unavailable); ``"cpu"`` -> the CPU; anything else raises.
    Inside :func:`default_device`, ``None`` is that block's device."""
    if device is None and _default is not None:
        return _default
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
