"""No silent broad ``except`` in the port that the JAX package does not
have: the port's side of ``tests/test_excepts_lint.py``.

``tools/check_excepts.py`` (``lint_source`` and ``load_allowlist``,
imported, not edited) flags every handler that catches ``Exception``
(or ``BaseException``, or is bare) and neither re-raises nor logs nor
counts.  Over ``tpudas_torch/``, each flagged site must be a site the
JAX allowlist (``tools/except_allowlist.txt``) grandfathers at the same
path under ``tpudas/`` and the same qualname, or one of the port-only
sites below, each kept here with its reason.  So the port's "no
fallback that hides" rule cannot erode silently: a new silent handler
fails this test until it re-raises, logs, counts, or is argued here.
"""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# path::qualname -> why the handler may stay silent
PORT_ONLY = {
    "tpudas_torch/fleet/batch.py::_settle": (
        "the batch executor hands a dispatch's error to every waiting "
        "member, which re-raises it in its own thread (the JAX executor "
        "settles inline and has no such handler)"),
}


def _lint():
    spec = importlib.util.spec_from_file_location(
        "_check_excepts", os.path.join(REPO, "tools", "check_excepts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_sources():
    for dirpath, dirs, files in os.walk(os.path.join(REPO, "tpudas_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield os.path.relpath(path, REPO).replace(os.sep, "/"), path


def _flagged(allowed):
    mod = _lint()
    out = []
    for rel, path in _port_sources():
        with open(path) as fh:
            out += mod.lint_source(rel, fh.read(), allowed)
    return out


def _jax_allowlist_in_port_paths():
    allowed = _lint().load_allowlist(REPO)
    return {"tpudas_torch/" + a[len("tpudas/"):]
            for a in allowed if a.startswith("tpudas/")}


def test_every_silent_handler_is_a_jax_one_or_argued():
    allowed = _jax_allowlist_in_port_paths() | set(PORT_ONLY)
    assert _flagged(allowed) == []


def test_the_lint_sees_the_port():
    """Not vacuous: without the allowlist the lint flags the port's
    grandfathered sites, and each port-only entry is one of them."""
    flagged = {p.split(": silent")[0] for p in _flagged(set())}
    assert len(flagged) > 20
    assert set(PORT_ONLY) <= flagged
    # every mapped JAX entry the port uses names a real port site
    used = flagged & _jax_allowlist_in_port_paths()
    assert len(used) == len(flagged) - len(PORT_ONLY)
