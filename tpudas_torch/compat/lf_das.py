"""``lf_das`` over the port: the counterpart of the repo's ``lf_das.py``.

The notebooks import the processing layer as ``from lf_das import
LFProc, get_edge_effect_time, get_patch_time, waterfall_plot`` and the
private naming helper ``from lf_das import _get_filename``.  This module
maps those names onto the port; the underscored aliases mirror the
reference's private names.
"""

from tpudas_torch.proc.edge import (
    down_sample_processing as _down_sample_processing,
    get_edge_effect_time,
)
from tpudas_torch.proc.lfproc import LFProc, check_merge as _check_merge
from tpudas_torch.proc.memory import get_patch_time
from tpudas_torch.proc.naming import (
    get_filename as _get_filename,
    get_timestr as _get_timestr,
)
from tpudas_torch.viz.waterfall import waterfall_plot

__all__ = [
    "LFProc",
    "get_edge_effect_time",
    "get_patch_time",
    "waterfall_plot",
    "_check_merge",
    "_get_timestr",
    "_get_filename",
    "_down_sample_processing",
]
