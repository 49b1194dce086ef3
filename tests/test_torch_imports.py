"""The port stands alone: importing every tpudas_torch module pulls in
neither JAX nor any module of the JAX package, and the processing path
imports without h5py and pandas (both optional on the card's host)."""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (the port's tests import both frameworks)
import torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import tpudas_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    tpudas_torch.__path__, "tpudas_torch."))
for m in mods:
    importlib.import_module(m)
loaded = sorted(sys.modules)
print(json.dumps({"mods": mods, "loaded": loaded}))
"""


def _probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _top(name):
    return name.split(".")[0]


def test_port_imports_no_jax_no_tpudas_no_h5py_no_pandas():
    res = _probe()
    for mod in (
        "tpudas_torch.ops.fir_kernel",
        "tpudas_torch.ops.fused_kernel",
        "tpudas_torch.ops.hbm_probe",
        "tpudas_torch.ops.fftlen",
        "tpudas_torch.ops.filter",
        "tpudas_torch.ops.resample",
        "tpudas_torch.tools",
        "tpudas_torch.tools.harness",
        "tpudas_torch.tools.probe_pipeline",
        "tpudas_torch.tools.probe_dma",
        "tpudas_torch.proc.edge",
        "tpudas_torch.proc.lfproc",
        "tpudas_torch.proc.stream",
        "tpudas_torch.proc.ingest",
        "tpudas_torch.proc.streaming",
        "tpudas_torch.fleet.config",
        "tpudas_torch.fleet.engine",
        "tpudas_torch.integrity.checksum",
        "tpudas_torch.utils.profiling",
    ):
        assert mod in res["mods"]
    loaded = res["loaded"]
    # exact-name/prefix check: "tpudas_torch" itself starts with "tpudas"
    assert [n for n in loaded if _top(n) in ("jax", "jaxlib")] == []
    assert [n for n in loaded if _top(n) == "tpudas"] == []
    assert [n for n in loaded if _top(n) in ("h5py", "pandas")] == []
    assert "torch" in loaded
