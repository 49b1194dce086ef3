"""Processing engines: the overlap-save low-pass + decimate (LFProc)."""
