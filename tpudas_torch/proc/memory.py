"""Memory-model chunk sizing (reference lf_das.py:90-107).

The port's counterpart of :mod:`tpudas.proc.memory`.  Sizes the
overlap-save window so one in-flight chunk — raw window plus the
processing working set — fits a memory budget:
``bytes/sec = rate * n_ch * bytes_per_element * processing_factor *
safety``.  On the card the budget is usable device memory.  The
default ``processing_factor`` stays at the reference's 5.
``chip_smoke.py`` phase 4 measures the batch cascade's peak device
memory in the same terms (peak bytes over one window's samples x 8
bytes): 0.51 with the prefetch thread's staging (two int16 windows
resident) and 0.40 without, at 60 s x 10,000 channels of int16 on an
NVIDIA H100 80GB HBM3 at 700 W — the default is about ten times
generous there.

Distinct from this device model is LFProc's host-side byte budget
``_STAGE_MAX_BYTES`` (2 GiB): the largest window the prefetch thread
stages into its two page-locked buffers.
"""

from __future__ import annotations

__all__ = ["get_patch_time"]


def get_patch_time(
    memory_size,
    sampling_rate,
    num_ch,
    bytes_per_element=8,
    processing_factor=5,
    memory_safety_factor=1.2,
):
    """Chunk length (seconds) that fits ``memory_size`` MB of memory."""
    mb_per_second = (
        sampling_rate
        * num_ch
        * bytes_per_element
        * processing_factor
        * memory_safety_factor
        / 1e6
    )
    return memory_size / mb_per_second
