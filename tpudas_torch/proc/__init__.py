"""Processing engines: the overlap-save low-pass + decimate (LFProc),
the joint low-pass + rolling-mean pass (JointProc, in
:mod:`tpudas_torch.proc.joint`) and the memory-model chunk sizer."""

from tpudas_torch.proc.memory import get_patch_time

__all__ = ["get_patch_time"]
