"""The DASCore-compatible entry over the port.

The repo's user contract is ``import dascore as dc`` and ``from lf_das
import LFProc, ...``: the top-level ``dascore/`` and ``lf_das.py`` shims
serve it over the JAX package.  These modules serve it over the port,
name for name:

- :mod:`tpudas_torch.compat.dascore` (with ``.units`` and
  ``.utils.mapping``) is ``dascore/``;
- :mod:`tpudas_torch.compat.lf_das` is ``lf_das.py``.

Use them as ``import tpudas_torch.compat.dascore as dc`` and ``from
tpudas_torch.compat.lf_das import LFProc``.  The notebook and script
runner (:mod:`tpudas_torch.tools.notebooks`) resolves the plain
``dascore`` / ``lf_das`` imports of the repo's notebooks to them.
"""
