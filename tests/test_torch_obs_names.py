"""The port's metric and span names are the JAX package's.

``tools/check_metrics.py::collect_names`` (imported, not edited) reads
the literal names passed to ``.counter(`` / ``.gauge(`` /
``.histogram(`` and ``span(`` in each source; over ``tpudas_torch/``
they must equal those over ``tpudas/``, so a dashboard or a runbook
written for the JAX package reads the port's ``metrics.prom`` and
flight ring.  A documented exception would be listed here with its
ROADMAP reference; there is none.  The run-time half is
``tests/test_torch_realtime.py::_assert_obs_artifacts`` (the same
``# TYPE`` names in both drivers' ``metrics.prom``).
"""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names one package emits and the other does not, with the ROADMAP entry
# that documents each: none
METRIC_EXCEPTIONS: dict = {}
SPAN_EXCEPTIONS: dict = {}


def _collect_names():
    spec = importlib.util.spec_from_file_location(
        "_check_metrics", os.path.join(REPO, "tools", "check_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.collect_names


def _names(package):
    collect = _collect_names()
    metrics, spans = {}, {}
    for dirpath, dirs, files in os.walk(os.path.join(REPO, package)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as fh:
                ms, ss = collect(fh.read())
            rel = os.path.relpath(path, REPO)
            for kind, name in ms:
                metrics.setdefault(name, set()).add(kind)
            for name in ss:
                spans.setdefault(name, set()).add(rel)
    return metrics, spans


def test_metric_names_equal_the_jax_packages():
    jax_metrics, _ = _names("tpudas")
    port_metrics, _ = _names("tpudas_torch")
    assert len(jax_metrics) > 150
    missing = sorted(set(jax_metrics) - set(port_metrics) - set(METRIC_EXCEPTIONS))
    extra = sorted(set(port_metrics) - set(jax_metrics) - set(METRIC_EXCEPTIONS))
    assert missing == [] and extra == []


def test_metric_kinds_equal_the_jax_packages():
    """A name is a counter, a gauge or a histogram in both packages."""
    jax_metrics, _ = _names("tpudas")
    port_metrics, _ = _names("tpudas_torch")
    differ = {n: (port_metrics[n], jax_metrics[n])
              for n in set(port_metrics) & set(jax_metrics)
              if port_metrics[n] != jax_metrics[n]}
    assert differ == {}


def test_span_names_equal_the_jax_packages():
    _, jax_spans = _names("tpudas")
    _, port_spans = _names("tpudas_torch")
    assert len(jax_spans) >= 50
    missing = sorted(set(jax_spans) - set(port_spans) - set(SPAN_EXCEPTIONS))
    extra = sorted(set(port_spans) - set(jax_spans) - set(SPAN_EXCEPTIONS))
    assert missing == [] and extra == []


# string literals shaped like a metric name that are not metrics
NOT_METRICS = {
    # the JAX persistent compile cache's default folder
    # (tpudas/utils/compile_cache.py); the port's cache is its build
    # directory (tpudas_torch/ops/_build.py)
    "tpudas_jax_cache",
}


def _name_literals(package):
    """Every string literal shaped ``tpudas_<name>`` in ``package``:
    the metric names ``collect_names`` reads and those it cannot (a
    name held in a tuple, as the window timings' are)."""
    import ast
    import re

    shape = re.compile(r"^tpudas_[a-z0-9_]+$")
    out = set()
    for dirpath, dirs, files in os.walk(os.path.join(REPO, package)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as fh:
                    tree = ast.parse(fh.read())
                out |= {n.value for n in ast.walk(tree)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)
                        and shape.match(n.value)
                        and not n.value.startswith("tpudas_torch")}
    return out - NOT_METRICS


def test_every_metric_shaped_literal_is_in_both():
    jax_names, port_names = _name_literals("tpudas"), _name_literals(
        "tpudas_torch")
    assert "tpudas_window_device_seconds_total" in jax_names
    assert sorted(jax_names ^ port_names) == []


def test_compile_cache_metrics_map_the_library_cache(tmp_path, monkeypatch):
    """``tpudas_compile_cache_*`` on the port's kernel library cache
    (``ops/_build.py``; ROADMAP C, documented differences): ``enabled``
    1, ``entries`` the libraries in the build directory, a hit a library
    loaded from the cache without nvcc, a miss an nvcc build."""
    import ctypes.util

    import pytest

    from tpudas_torch.obs import registry as tregistry
    from tpudas_torch.ops import _build

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    for n in ("libfir_decimate-0.so", "libstreamio-1.so", "notes.txt"):
        (tmp_path / n).write_bytes(b"")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_so_path", lambda name: (None, libc))
    reg = tregistry.MetricsRegistry()
    try:
        with tregistry.use_registry(reg):
            # a library already in the cache: no nvcc ran (the source's
            # library exists), then its first load is a hit
            monkeypatch.setitem(_build._INFO, "cache_probe", {"cached": True})
            monkeypatch.setattr(_build, "build_libraries",
                                lambda names: _build._count_cache())
            _build.load_library("cache_probe")
            _build.load_library("cache_probe")  # loaded once: one hit
            assert reg.value("tpudas_compile_cache_enabled") == 1
            assert reg.value("tpudas_compile_cache_entries") == 2
            assert reg.value("tpudas_compile_cache_hits_total") == 1
            assert reg.get("tpudas_compile_cache_misses_total") is None
            # a library nvcc built in this process: a miss, no hit
            _build._LIBS.pop("cache_probe", None)
            _build._INFO["cache_probe"] = {"cached": False}
            _build._count_cache(misses=1)
            _build.load_library("cache_probe")
            assert reg.value("tpudas_compile_cache_misses_total") == 1
            assert reg.value("tpudas_compile_cache_hits_total") == 1
    finally:
        _build._LIBS.pop("cache_probe", None)
