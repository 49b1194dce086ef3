"""Run the repo's notebooks and example scripts on the port.

The notebooks (``notebooks/*.ipynb``) and the examples
(``examples/*.py``) are written against the JAX package's surface:
``import dascore as dc``, ``from lf_das import LFProc, ...`` and
``from tpudas.<module> import ...``.  This runner executes their code
unmodified with those names resolved to the port, through a
``sys.meta_path`` finder installed ahead of every other:

- ``tpudas`` and ``tpudas.<module>`` -> ``tpudas_torch`` and
  ``tpudas_torch.<module>`` (the same module objects);
- ``dascore`` and ``dascore.<module>`` -> :mod:`tpudas_torch.compat.dascore`
  and its modules;
- ``lf_das`` -> :mod:`tpudas_torch.compat.lf_das`;
- ``_env`` (the examples' JAX platform shim) -> an empty module.

It refuses to start when ``jax`` or a real ``tpudas`` module is already
loaded, so it runs in a fresh interpreter of its own, and at the end it
checks that ``jax`` was never imported and that every ``tpudas*``
module in ``sys.modules`` is an alias of a port module.
``JAX_PLATFORMS`` is dropped from the environment first (the examples'
``_env`` would import ``jax`` when it names ``cpu``).

What the runner sets for the code it runs:

- the real-time drivers poll at the interval the code asks for (the
  edge notebooks' ``TPUDAS_NB_POLL``), not at the reference cadence
  clamp, max(125 s, file duration, 3 x edge buffer): the notebooks'
  "demo uses a fast poll", which the clamp would stretch to two 125 s
  sleeps a notebook;
- on a host without h5py (the card's) every file the code writes or
  reads as ``dasdae`` is tdas under the same name (the readers sniff
  the format from the magic bytes);
- on a host without matplotlib a cell that fails only because it is
  missing (``ModuleNotFoundError`` naming it) is listed under
  ``cells_without_matplotlib`` and the notebook goes on; any other
  error ends the run.

For each notebook it prints one JSON line: the notebook, the cells run
(of the code cells), the cells without matplotlib, the wall seconds,
the launches of the hand-written kernels (B1 ``fir_decimate``, B3
``fused_cascade``) and the files the notebook wrote; each notebook gets
a working folder of its own (``TPUDAS_NB_WORKDIR``).  A script gets the
same line, with its arguments.  The last line is the import check, with
the format the ``dasdae`` files were written in.

    python -m tpudas_torch.tools.notebooks notebooks/*.ipynb \\
        [--device cpu] [--out report.json] [--workdir DIR]
    python -m tpudas_torch.tools.notebooks --script examples/batch_low_pass.py \\
        [--device cpu] -- --quick --fs 100 --n-ch 8

Options:
    --device cpu     run on the CPU (the plain versions of the kernels):
                     the code passes no device, so the run is inside
                     :func:`tpudas_torch.device.default_device`; without
                     it the code runs on the card and raises without one
    --out PATH       also write every line, and the import check, to PATH
    --workdir DIR    the notebooks' working folders go under DIR (default
                     a temporary folder)

Exit code 0 when every notebook or the script ran, 1 when one raised.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.abc
import importlib.util
import json
import os
import runpy
import sys
import tempfile
import time
import types

if __package__ in (None, ""):  # run as a script: put the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

__all__ = ["AliasFinder", "alias_target", "check_imports", "main",
           "run_notebook", "run_script"]

# (alias prefix, port prefix): the longest match wins
_ALIASES = (
    ("tpudas", "tpudas_torch"),
    ("dascore", "tpudas_torch.compat.dascore"),
    ("lf_das", "tpudas_torch.compat.lf_das"),
)
_EMPTY = ("_env",)


def alias_target(name: str) -> str | None:
    """The port module an aliased name resolves to, or None."""
    for alias, target in _ALIASES:
        if name == alias or name.startswith(alias + "."):
            return target + name[len(alias):]
    return None


class _AliasLoader(importlib.abc.Loader):
    """Hands out an already-imported module under another name."""

    def __init__(self, module):
        self.module = module
        self.spec = module.__spec__

    def create_module(self, spec):
        return self.module

    def exec_module(self, module):
        # the import system stamps the alias's spec on the module it
        # created: give the port module its own back
        module.__spec__ = self.spec


class AliasFinder(importlib.abc.MetaPathFinder):
    """Resolves ``tpudas*``, ``dascore*`` and ``lf_das`` to the port and
    ``_env`` to an empty module (see the module docstring)."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname in _EMPTY:
            module = types.ModuleType(fullname)
            module.__spec__ = importlib.util.spec_from_loader(fullname, None)
            return importlib.util.spec_from_loader(
                fullname, _AliasLoader(module))
        port_name = alias_target(fullname)
        if port_name is None:
            return None
        module = importlib.import_module(port_name)
        return importlib.util.spec_from_loader(
            fullname, _AliasLoader(module),
            is_package=hasattr(module, "__path__"))


def _real_tpudas_modules() -> list:
    return sorted(k for k in sys.modules
                  if k == "tpudas" or k.startswith("tpudas."))


def check_imports() -> dict:
    """Whether ``jax`` was imported, and every ``tpudas*`` /
    ``dascore*`` / ``lf_das`` entry of ``sys.modules`` that is not the
    port module it stands for."""
    bad = []
    for name, module in list(sys.modules.items()):
        port_name = alias_target(name)
        if port_name is not None and module is not sys.modules.get(port_name):
            bad.append(name)
    return {"jax_imported": "jax" in sys.modules,
            "aliases": len(_real_tpudas_modules()),
            "not_aliases": sorted(bad)}


def _launches() -> dict:
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    return {"fir_decimate": fir_decimate.launches,
            "fused_cascade": fused_cascade.launches}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _files(folder: str, skip=("raw",)) -> list:
    """The files under ``folder`` (relative paths), without ``skip``."""
    out = []
    for root, dirs, names in os.walk(folder):
        rel = os.path.relpath(root, folder)
        if rel.split(os.sep)[0] in skip:
            dirs[:] = []
            continue
        out += [os.path.normpath(os.path.join(rel, n)) for n in names]
    return sorted(out)


def _code_cells(path: str) -> list:
    with open(path) as fh:
        nb = json.load(fh)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _without(exc: BaseException, module: str) -> bool:
    """Whether ``exc`` is only ``module`` missing."""
    return (isinstance(exc, ModuleNotFoundError) and exc.name is not None
            and (exc.name == module or exc.name.startswith(module + ".")))


def _installed(module: str) -> bool:
    return importlib.util.find_spec(module) is not None


def _close_figures() -> None:
    if "matplotlib.pyplot" in sys.modules:
        sys.modules["matplotlib.pyplot"].close("all")


def run_notebook(path: str, workdir: str) -> dict:
    """Execute ``path``'s code cells in order, unmodified, in one
    namespace, with ``TPUDAS_NB_WORKDIR`` set to ``workdir``; returns
    the notebook's line.  Raises what a cell raises, except matplotlib
    missing on a host without it."""
    cells = _code_cells(path)
    name = os.path.basename(path)
    os.environ["TPUDAS_NB_WORKDIR"] = workdir
    no_mpl = not _installed("matplotlib")
    skipped = []
    ns = {"__name__": "__main__"}
    before = _launches()
    t0 = time.perf_counter()
    for i, src in enumerate(cells):
        try:
            exec(compile(src, f"{name}:cell{i}", "exec"), ns)
        except Exception as exc:
            if not (no_mpl and _without(exc, "matplotlib")):
                raise
            skipped.append(f"cell{i}")
    wall = time.perf_counter() - t0
    _close_figures()
    return {"notebook": name, "cells_run": len(cells) - len(skipped),
            "cells": len(cells), "cells_without_matplotlib": skipped,
            "wall_s": wall, "launches": _delta(before),
            "outputs": _files(workdir)}


def run_script(path: str, argv: list) -> dict:
    """Run ``path`` as ``__main__`` with ``argv``; returns its line."""
    before = _launches()
    saved = sys.argv
    sys.argv = [path, *argv]
    t0 = time.perf_counter()
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    wall = time.perf_counter() - t0
    _close_figures()
    return {"script": os.path.basename(path), "argv": list(argv),
            "wall_s": wall, "launches": _delta(before)}


def _unclamped_poll() -> None:
    from tpudas_torch.fleet import engine

    engine.clamp_poll_interval = (
        lambda requested, file_duration, edge_buffer: float(requested))


def _use_tdas_for_dasdae() -> None:
    from tpudas_torch.io import registry

    registry._FORMATS["dasdae"] = registry._FORMATS["tdas"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    script_args: list = []
    if "--" in argv:
        cut = argv.index("--")
        argv, script_args = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(
        prog="python -m tpudas_torch.tools.notebooks",
        description="Run the repo's notebooks or an example on the port.")
    ap.add_argument("notebooks", nargs="*")
    ap.add_argument("--script", default=None)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if bool(args.notebooks) == bool(args.script):
        ap.error("give notebooks, or --script (not both)")
    if "jax" in sys.modules or _real_tpudas_modules():
        print("notebooks: jax or the JAX package is already imported; "
              "run this in a fresh interpreter", file=sys.stderr)
        return 2
    os.environ.pop("JAX_PLATFORMS", None)
    os.environ.setdefault("MPLBACKEND", "Agg")
    sys.meta_path.insert(0, AliasFinder())
    _unclamped_poll()
    h5_format = "dasdae" if _installed("h5py") else "tdas"
    if h5_format == "tdas":
        _use_tdas_for_dasdae()
    from contextlib import nullcontext

    from tpudas_torch.device import default_device

    workdir = args.workdir or tempfile.mkdtemp(prefix="tpudas_torch_nb_")
    lines, rc = [], 0
    ctx = default_device(args.device) if args.device else nullcontext()
    with ctx:
        try:
            if args.script:
                lines.append(run_script(args.script, script_args))
                print(json.dumps(lines[-1]), flush=True)
            for path in args.notebooks:
                stem = os.path.splitext(os.path.basename(path))[0]
                lines.append(run_notebook(path, os.path.join(workdir, stem)))
                print(json.dumps(lines[-1]), flush=True)
        except Exception as exc:
            rc = 1
            print(json.dumps({"failed": f"{type(exc).__name__}: {exc}"}),
                  flush=True)
            raise
        finally:
            check = check_imports()
            print(json.dumps({"imports": check, "h5_format": h5_format}),
                  flush=True)
            if args.out:
                with open(args.out, "w") as fh:
                    json.dump({"lines": lines, "imports": check,
                               "h5_format": h5_format,
                               "device": args.device or "cuda",
                               "workdir": workdir}, fh, indent=1)
    if check["jax_imported"] or check["not_aliases"]:
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
