"""Visualization / QC plotting (matplotlib is imported only when a
plot is drawn)."""

from tpudas_torch.viz.waterfall import patch_waterfall, waterfall_plot

__all__ = ["waterfall_plot", "patch_waterfall"]
