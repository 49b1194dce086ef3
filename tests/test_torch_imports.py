"""The port stands alone: importing every tpudas_torch module pulls in
neither JAX nor any module of the JAX package, and the processing path
imports without h5py, pandas and matplotlib (all optional on the card's
host); ``chip_smoke.py`` imports neither JAX nor the JAX package
either."""

import ast
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
        "tpudas_torch.ops.rolling",
        "tpudas_torch.native",
        "tpudas_torch.io.index",
        "tpudas_torch.io.registry",
        "tpudas_torch.io.spool",
        "tpudas_torch.testing",
        "tpudas_torch.io.tdas",
        "tpudas_torch.tools",
        "tpudas_torch.tools.harness",
        "tpudas_torch.tools.probe_pipeline",
        "tpudas_torch.tools.probe_dma",
        "tpudas_torch.tools.fsck",
        "tpudas_torch.tools.crash_drill",
        "tpudas_torch.proc.edge",
        "tpudas_torch.proc.joint",
        "tpudas_torch.proc.memory",
        "tpudas_torch.proc.lfproc",
        "tpudas_torch.proc.stream",
        "tpudas_torch.proc.ingest",
        "tpudas_torch.proc.streaming",
        "tpudas_torch.fleet.config",
        "tpudas_torch.fleet.engine",
        "tpudas_torch.fleet.batch",
        "tpudas_torch.fleet.fleet",
        "tpudas_torch.integrity.audit",
        "tpudas_torch.integrity.checksum",
        "tpudas_torch.integrity.resource",
        "tpudas_torch.utils.atomicio",
        "tpudas_torch.detect",
        "tpudas_torch.detect.operators",
        "tpudas_torch.detect.ledger",
        "tpudas_torch.detect.runner",
        "tpudas_torch.ops.median",
        "tpudas_torch.obs",
        "tpudas_torch.obs.collect",
        "tpudas_torch.obs.flight",
        "tpudas_torch.obs.health",
        "tpudas_torch.obs.phases",
        "tpudas_torch.obs.registry",
        "tpudas_torch.obs.trace",
        "tpudas_torch.obs.devprof",
        "tpudas_torch.tools.obs_report",
        "tpudas_torch.resilience.faults",
        "tpudas_torch.resilience.quarantine",
        "tpudas_torch.utils.profiling",
        "tpudas_torch.codec",
        "tpudas_torch.codec.codecs",
        "tpudas_torch.codec.frame",
        "tpudas_torch.serve",
        "tpudas_torch.serve.tiles",
        "tpudas_torch.serve.query",
        "tpudas_torch.serve.http",
        "tpudas_torch.serve.pool",
        "tpudas_torch.live",
        "tpudas_torch.live.hub",
        "tpudas_torch.live.protocol",
        "tpudas_torch.live.sse",
        "tpudas_torch.tools.serve_pool",
        "tpudas_torch.tools.store_scrub",
        "tpudas_torch.tools.backfill_drill",
        "tpudas_torch.store",
        "tpudas_torch.store.base",
        "tpudas_torch.store.posix",
        "tpudas_torch.store.fake",
        "tpudas_torch.store.retry",
        "tpudas_torch.store.replica",
        "tpudas_torch.store.cache",
        "tpudas_torch.store.s3",
        "tpudas_torch.store.tileplane",
        "tpudas_torch.backfill",
        "tpudas_torch.backfill.queue",
        "tpudas_torch.backfill.runner",
        "tpudas_torch.backfill.stitch",
        "tpudas_torch.backfill.objqueue",
        "tpudas_torch.viz",
        "tpudas_torch.viz.waterfall",
        "tpudas_torch.parallel",
        "tpudas_torch.parallel.mesh",
        "tpudas_torch.parallel.sharding",
        "tpudas_torch.parallel.halo",
        "tpudas_torch.parallel.pipeline",
        "tpudas_torch.parallel.batch",
        "tpudas_torch.parallel.distributed",
        "tpudas_torch.compat",
        "tpudas_torch.compat.dascore",
        "tpudas_torch.compat.dascore.units",
        "tpudas_torch.compat.dascore.utils",
        "tpudas_torch.compat.dascore.utils.mapping",
        "tpudas_torch.compat.lf_das",
        "tpudas_torch.tools.notebooks",
    ):
        assert mod in res["mods"]
    loaded = res["loaded"]
    # exact-name/prefix check: "tpudas_torch" itself starts with "tpudas"
    assert [n for n in loaded if _top(n) in ("jax", "jaxlib")] == []
    assert [n for n in loaded if _top(n) == "tpudas"] == []
    assert [n for n in loaded if _top(n) in ("h5py", "pandas")] == []
    # the waterfall draws with matplotlib, imported only when it draws
    assert [n for n in loaded if _top(n) == "matplotlib"] == []
    # S3 has no client on either machine: boto3 is imported only when
    # an S3Store is built without an injected client
    assert [n for n in loaded if _top(n) in ("boto3", "botocore")] == []
    assert "torch" in loaded


def _imported_modules(path):
    """Every module name an ``import`` or ``from ... import`` in the
    file at ``path`` names, at any depth of its syntax tree."""
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_chip_smoke_imports_no_jax_no_tpudas():
    names = _imported_modules(os.path.join(REPO, "chip_smoke.py"))
    assert "tpudas_torch" in {_top(n) for n in names}
    assert [n for n in names if _top(n) in ("jax", "jaxlib", "tpudas")] == []


def test_card_tests_import_no_jax_no_tpudas():
    """The card's tests run where JAX is not installed: the file imports
    neither JAX nor the JAX package (the tiling mirror's parity with the
    JAX stage lives in tests/test_torch_fir_tiled.py, on the CPU)."""
    names = _imported_modules(os.path.join(REPO, "tests", "test_torch_gpu.py"))
    assert "tpudas_torch" in {_top(n) for n in names}
    assert [n for n in names if _top(n) in ("jax", "jaxlib", "tpudas")] == []


def test_operator_tools_import_no_jax_no_tpudas():
    """The fsck and the crash drill, whose workers import inside
    functions: no import at any depth names JAX or the JAX package."""
    for name in ("fsck.py", "crash_drill.py", "serve_pool.py",
                 "store_scrub.py", "backfill_drill.py", "obs_report.py"):
        names = _imported_modules(
            os.path.join(REPO, "tpudas_torch", "tools", name))
        assert "tpudas_torch" in {_top(n) for n in names}, name
        assert [n for n in names
                if _top(n) in ("jax", "jaxlib", "tpudas")] == [], name


def test_parallel_modules_import_no_jax_no_tpudas():
    """The parallel layer: no import at any depth (the distributed hooks
    import inside functions) names JAX or the JAX package, and the
    package exports the eight names of ``tpudas/parallel/__init__.py``;
    the JAX ``compat`` shim has no counterpart (there is no
    ``shard_map``)."""
    import tpudas.parallel as jpar
    import tpudas_torch.parallel as tpar

    d = os.path.join(REPO, "tpudas_torch", "parallel")
    for name in sorted(os.listdir(d)):
        if name.endswith(".py"):
            names = _imported_modules(os.path.join(d, name))
            assert [n for n in names
                    if _top(n) in ("jax", "jaxlib", "tpudas")] == [], name
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert len(tpar.__all__) == 8
    assert all(callable(getattr(tpar, n)) for n in tpar.__all__)
    assert not os.path.exists(os.path.join(d, "compat.py"))


def test_pyramid_modules_import_no_jax_no_tpudas():
    """codec, serve, live, viz, store and backfill: no import at any
    depth names JAX or the JAX package, and matplotlib is imported only
    inside a function."""
    for sub in ("codec", "serve", "live", "viz", "store", "backfill"):
        d = os.path.join(REPO, "tpudas_torch", sub)
        for name in sorted(os.listdir(d)):
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            names = _imported_modules(path)
            assert [n for n in names
                    if _top(n) in ("jax", "jaxlib", "tpudas")] == [], path
            tree = ast.parse(open(path).read(), filename=path)
            top = [n for n in tree.body
                   if isinstance(n, (ast.Import, ast.ImportFrom))]
            for node in top:
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                assert all(_top(m) != "matplotlib" for m in mods), path


_WORKER_PROBE = r"""
import json, sys
from tpudas_torch.serve import pool
# what a spawned pool worker imports before it serves
from tpudas_torch.serve.http import DASServer  # noqa: F401
import tpudas_torch.live.sse  # noqa: F401  (the bridge subscriber)
import tpudas_torch.store  # noqa: F401  (a store_url worker's mount)
import torch
print(json.dumps({"loaded": sorted(sys.modules),
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_pool_worker_import_path():
    """A serve-pool worker's import path (the server, the live bridge,
    the object-store mount) loads neither JAX, the JAX package, matplotlib nor any kernel
    module, and creates no CUDA context."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _WORKER_PROBE], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = res["loaded"]
    assert [n for n in loaded
            if _top(n) in ("jax", "jaxlib", "tpudas", "matplotlib")] == []
    assert [n for n in loaded if n.startswith("tpudas_torch.ops")] == []
    assert "tpudas_torch.serve.http" in loaded
    assert res["cuda_initialized"] is False


_POOL_PROBE = r"""
import json, sys
import tpudas_torch.serve.pool  # noqa: F401
import torch
print(json.dumps({"loaded": sorted(sys.modules),
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_pool_module_loads_no_kernel_module():
    """``import tpudas_torch.serve.pool`` alone, in a fresh interpreter:
    the package's re-exports (``tpudas_torch/__init__.py`` and the
    subpackages') must not pull a kernel wrapper or the kernel builder
    into a pool worker, nor create a CUDA context (the invariant of
    ``tpudas_torch/serve/pool.py``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _POOL_PROBE], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = set(res["loaded"])
    for mod in ("tpudas_torch.ops.fir_kernel", "tpudas_torch.ops.fused_kernel",
                "tpudas_torch.ops._build"):
        assert mod not in loaded, mod
    assert res["cuda_initialized"] is False
    assert [n for n in loaded
            if _top(n) in ("jax", "jaxlib", "tpudas", "matplotlib", "h5py")] == []


def test_compat_and_runner_import_no_jax_no_tpudas():
    """The DASCore-compatible entry and the notebook runner: no import
    at any depth names JAX or the JAX package (the runner maps the
    notebooks' ``tpudas`` imports to the port at run time)."""
    paths = [os.path.join(REPO, "tpudas_torch", "tools", "notebooks.py")]
    for dirpath, _dirs, files in os.walk(
            os.path.join(REPO, "tpudas_torch", "compat")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) == 7
    for path in paths:
        names = _imported_modules(path)
        if not path.endswith(os.path.join("compat", "__init__.py")):
            assert "tpudas_torch" in {_top(n) for n in names}, path
        assert [n for n in names
                if _top(n) in ("jax", "jaxlib", "tpudas", "dascore", "lf_das")
                ] == [], path
