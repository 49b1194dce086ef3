"""Output file naming contract.

Reproduces the reference byte-for-byte (lf_das.py:23-31): output files
are ``LFDAS_<t0>_<t1>.h5`` where each timestamp is the ms-precision ISO
string truncated to 21 characters (i.e. one sub-second digit) with ":"
removed for Windows-path compatibility. Resume and merge tooling relies
on these names sorting chronologically.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_timestr", "get_filename"]


def get_timestr(bgtime) -> str:
    """datetime64 → 'YYYY-MM-DDTHHMMSS.m' (21 chars pre-strip, ms→1 digit)."""
    t = np.datetime64(bgtime).astype("datetime64[ms]")
    return str(t)[:21].replace(":", "")


def get_filename(bgtime, edtime) -> str:
    """The ``LFDAS_<t0>_<t1>.h5`` output-name contract."""
    return f"LFDAS_{get_timestr(bgtime)}_{get_timestr(edtime)}.h5"
