"""Processing engines: the overlap-save low-pass + decimate (LFProc),
the joint low-pass + rolling-mean pass (JointProc, in
:mod:`tpudas_torch.proc.joint`), the memory-model chunk sizer and the
real-time rolling driver (:func:`run_rolling_realtime`, in
:mod:`tpudas_torch.proc.streaming`)."""

from tpudas_torch.proc.memory import get_patch_time

__all__ = ["get_patch_time", "run_rolling_realtime"]


def __getattr__(name):
    # the driver imports the fleet engine, which imports this package's
    # LFProc: resolved on first use, not at package import
    if name == "run_rolling_realtime":
        from tpudas_torch.proc.streaming import run_rolling_realtime

        return run_rolling_realtime
    raise AttributeError(name)
