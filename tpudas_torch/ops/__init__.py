"""Device operators for Patch operations.

The port's counterpart of :mod:`tpudas.ops`, with its names.  Each
operator runs on the CUDA card by default and on the CPU when asked
(``device="cpu"``); ``engine="numpy"`` (or ``"host"``/``"scipy"``) is the
float64 host reference the notebooks call explicitly.  The polyphase
FIR cascade (:mod:`tpudas_torch.ops.fir`) and its hand-written CUDA
kernels (:mod:`tpudas_torch.ops.fir_kernel`,
:mod:`tpudas_torch.ops.fused_kernel`) are imported where they run,
never here.
"""

from tpudas_torch.ops.filter import fft_lowpass_response, patch_pass_filter
from tpudas_torch.ops.median import patch_median_filter
from tpudas_torch.ops.resample import interp_indices_weights, patch_interpolate
from tpudas_torch.ops.rolling import PatchRoller

__all__ = [
    "patch_pass_filter",
    "fft_lowpass_response",
    "patch_interpolate",
    "interp_indices_weights",
    "PatchRoller",
    "patch_median_filter",
]
