"""Processing-orchestration layer.

The public surface mirrors the JAX package's ``tpudas.proc`` (the
reference's ``lf_das`` module): the ``LFProc`` chunked overlap-save
engine, the self-calibrating edge probe, the memory-model chunk sizer,
the file naming helpers and the QC waterfall plot.  The joint low-pass
+ rolling-mean pass is :mod:`tpudas_torch.proc.joint`; the real-time
drivers are in :mod:`tpudas_torch.proc.streaming`, and
``run_rolling_realtime`` also resolves here on first use.
"""

from tpudas_torch.proc.edge import down_sample_processing, get_edge_effect_time
from tpudas_torch.proc.lfproc import LFProc, check_merge
from tpudas_torch.proc.memory import get_patch_time
from tpudas_torch.proc.naming import get_filename, get_timestr
from tpudas_torch.viz.waterfall import waterfall_plot

__all__ = [
    "LFProc",
    "check_merge",
    "get_timestr",
    "get_filename",
    "get_patch_time",
    "down_sample_processing",
    "get_edge_effect_time",
    "waterfall_plot",
]


def __getattr__(name):
    # the driver imports the fleet engine, which imports this package's
    # LFProc: resolved on first use, not at package import
    if name == "run_rolling_realtime":
        from tpudas_torch.proc.streaming import run_rolling_realtime

        return run_rolling_realtime
    raise AttributeError(name)
