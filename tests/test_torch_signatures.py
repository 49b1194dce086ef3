"""Signature parity: a JAX-style call works on the port unchanged.

Both trees are parsed with ``ast`` (nothing is imported).  For every
module of ``tpudas/`` with a counterpart at the same path under
``tpudas_torch/``, every public function, class and method of the JAX
module must exist in the port's (a method may be inherited from a class
of the same module), and every public function and method both define
must accept each JAX parameter name, with the JAX positional parameters
at the same positions (so a positional JAX call binds the same
arguments).  The port may add parameters after them (``device=``, most
often).  Only the documented differences below may stand.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "tpudas")
PORT_ROOT = os.path.join(REPO, "tpudas_torch")

# (module, public name) -> why the port has no counterpart
NO_COUNTERPART = {
    ("proc/lfproc.py", "PallasVerificationError"): (
        "the JAX window path's check of its Pallas lowering against its "
        "XLA one; the port's window path has one lowering, B1, held to "
        "its plain version by the tests and chip_smoke.py"),
}

# (module, function, JAX parameter) -> why the port takes another
PARAM_DIFFERENCES = {
    ("parallel/halo.py", "exchange_halo_time", "block"): (
        "the JAX function runs inside shard_map on one shard's block; "
        "the port's takes the list of a time axis's blocks (``blocks``), "
        "this rank's entries as tensors"),
}

# JAX modules whose counterpart lives under other names
MODULES_ELSEWHERE = {
    "ops/pallas_fir.py": (
        "the Pallas kernels: tpudas_torch/csrc/*.cu, bound by "
        "ops/fir_kernel.py, ops/fused_kernel.py and ops/hbm_probe.py"),
    "parallel/compat.py": "the shard_map keyword shim: the port has no "
                          "shard_map",
    "utils/compile_cache.py": (
        "the persistent XLA compile cache: the port's kernels are cached "
        "by ops/_build.py under the tpudas_compile_cache_* names"),
}


def _modules():
    out = []
    for dirpath, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), JAX_ROOT)
                out.append(rel.replace(os.sep, "/"))
    return out


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def _defs(path: str) -> dict:
    """``{name: node}`` of the module's public functions and classes and
    ``{"Class.method": node}`` of their public methods, a class's
    methods including those it inherits from a class of the module."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls, seen=()):
        out = {}
        for base in cls.bases:
            if (isinstance(base, ast.Name) and base.id in classes
                    and base.id not in seen):
                out.update(methods(classes[base.id], seen + (cls.name,)))
        for sub in cls.body:
            if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and _public(sub.name)):
                out[sub.name] = sub
        return out

    out = {}
    kinds = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    for node in tree.body:
        if not isinstance(node, kinds) or node.name.startswith("_"):
            continue
        out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for mname, sub in methods(node).items():
                out[f"{node.name}.{mname}"] = sub
    return out


def _params(fn) -> tuple:
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    return positional, [p.arg for p in a.kwonlyargs], a.kwarg is not None


def _gaps(rel: str) -> list:
    jdefs = _defs(os.path.join(JAX_ROOT, rel))
    tdefs = _defs(os.path.join(PORT_ROOT, rel))
    gaps = []
    for name, jnode in jdefs.items():
        tnode = tdefs.get(name)
        if tnode is None:
            if (rel, name) not in NO_COUNTERPART:
                gaps.append(f"{rel}::{name} has no counterpart")
            continue
        if isinstance(jnode, ast.ClassDef) or isinstance(tnode, ast.ClassDef):
            continue
        jpos, jkw, _ = _params(jnode)
        tpos, tkw, tvarkw = _params(tnode)
        for i, p in enumerate(jpos):
            if (rel, name, p) in PARAM_DIFFERENCES:
                continue
            if p in tpos:
                if tpos.index(p) != i:
                    gaps.append(f"{rel}::{name} takes {p!r} at position "
                                f"{tpos.index(p)}, the JAX one at {i}")
            elif p in tkw or tvarkw:
                gaps.append(f"{rel}::{name} takes {p!r} by keyword only")
            else:
                gaps.append(f"{rel}::{name} lacks parameter {p!r}")
        for p in jkw:
            if (p not in tpos and p not in tkw and not tvarkw
                    and (rel, name, p) not in PARAM_DIFFERENCES):
                gaps.append(f"{rel}::{name} lacks keyword {p!r}")
    return gaps


PAIRED = [m for m in _modules()
          if os.path.isfile(os.path.join(PORT_ROOT, m))]


def test_every_jax_module_has_a_port_counterpart():
    missing = [m for m in _modules()
               if m not in PAIRED and m not in MODULES_ELSEWHERE]
    assert missing == []
    for m in MODULES_ELSEWHERE:  # the list holds no stale entry
        assert m not in PAIRED and os.path.isfile(os.path.join(JAX_ROOT, m))


@pytest.mark.parametrize("rel", PAIRED)
def test_port_accepts_the_jax_signatures(rel):
    assert _gaps(rel) == []


def test_documented_differences_are_still_differences():
    """Each listed difference holds: the name is still missing, or the
    parameter still differs (a closed gap leaves the list)."""
    for rel, name in NO_COUNTERPART:
        assert name not in _defs(os.path.join(PORT_ROOT, rel))
        assert name in _defs(os.path.join(JAX_ROOT, rel))
    for rel, name, param in PARAM_DIFFERENCES:
        tpos, tkw, _ = _params(_defs(os.path.join(PORT_ROOT, rel))[name])
        jpos, jkw, _ = _params(_defs(os.path.join(JAX_ROOT, rel))[name])
        assert param in jpos + jkw and param not in tpos + tkw
