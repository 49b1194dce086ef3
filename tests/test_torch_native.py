"""The port's native tdas runtime (tpudas_torch.native + io.tdas) against
its own numpy path and the JAX package's reader and writer.

Small multi-file tdas spools (100 Hz x 7 channels, 3 x 10 s, int16 and
float32) written by the JAX package's ``make_synthetic_spool``.  The
port's native assemblers, its numpy path (``TPUDAS_NO_NATIVE=1``) and
the JAX package's ``assemble_window_patch`` (native, and its numpy
fallback) must give byte-equal arrays; the native writer must write the
bytes the numpy writers write.  A failed build raises and does not fall
back.
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

import tpudas.io.tdas as jtdas
from tpudas.io.spool import spool as jspool
from tpudas.testing import make_synthetic_spool, synthetic_patch as jpatch
from tpudas_torch import native
from tpudas_torch.io import tdas
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.testing import synthetic_patch as tpatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = np.datetime64("2023-03-22T00:00:00", "ns")

PAYLOADS = {
    "int16": {"dtype": "int16", "scale": 1e-4},
    "float32": {"dtype": "float32"},
}
# windows: inside one file, across two, across all three; each with
# all channels and with a distance selection (channels 2..5)
WINDOWS = {
    "one-file": (2.0, 7.5),
    "two-files": (5.0, 15.0),
    "three-files": (0.0, 29.99),
}
DISTANCES = {"all": None, "ch2-5": (10.0, 25.0)}


@pytest.fixture(scope="module", params=sorted(PAYLOADS))
def src(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"native-{request.param}")
    make_synthetic_spool(d, n_files=3, file_duration=10.0, fs=100.0, n_ch=7,
                         noise=0.01, format="tdas",
                         write_kwargs=PAYLOADS[request.param])
    return str(d)


def _bounds(window):
    lo, hi = window
    return (T0 + np.timedelta64(int(lo * 1e9), "ns"),
            T0 + np.timedelta64(int(hi * 1e9), "ns"))


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dist", sorted(DISTANCES))
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_assemble_window_patch_native_numpy_and_jax_byte_equal(
        src, window, dist, monkeypatch):
    t_lo, t_hi = _bounds(WINDOWS[window])
    sel = DISTANCES[dist]
    plan = tspool(src).update().select(distance=sel).window_plan(t_lo, t_hi)
    jsp = jspool(src).update()
    if sel is not None:
        jsp = jsp.select(distance=sel)
    jplan = jsp.native_window_plan(t_lo, t_hi)
    assert plan is not None and jplan is not None
    assert [s[1:] for s in plan["segments"]] == [s[1:] for s in jplan["segments"]]
    native_patch = tdas.assemble_window_patch(plan)
    got = native_patch.host_data()
    jax_native = jtdas.assemble_window_patch(jplan).host_data()
    monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    numpy_path = tdas.assemble_window_patch(plan).host_data()
    monkeypatch.setattr(jtdas, "load_streamio", lambda: None)
    jax_numpy = jtdas.assemble_window_patch(jplan).host_data()
    for other in (numpy_path, jax_native, jax_numpy):
        assert _same(got, other)
    assert got.shape[1] == (4 if sel else 7)
    assert np.array_equal(native_patch.coords["time"],
                          jtdas.assemble_window_patch(jplan).coords["time"])


@pytest.mark.parametrize("no_native", [False, True])
def test_assemble_window_decodes_like_jax(src, no_native, monkeypatch):
    """The float32 assembler (int16 files decoded) and the raw one,
    called with explicit segments, over all three files."""
    t_lo, t_hi = _bounds(WINDOWS["three-files"])
    plan = tspool(src).update().window_plan(t_lo, t_hi)
    args = (plan["segments"], 1, 6, plan["total_rows"])
    if no_native:
        monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    dec = tdas.assemble_window(*args)
    assert dec.dtype == np.float32
    assert _same(dec, jtdas.assemble_window(*args))
    code = tdas.read_tdas_header(plan["segments"][0][0])["dtype_code"]
    raw = tdas.assemble_window_raw(*args, dtype_code=code)
    assert _same(raw, jtdas.assemble_window_raw(*args, dtype_code=code))


def test_assemble_into_a_given_destination(src):
    """``out`` is filled in place (the prefetch thread's page-locked
    buffer); a destination of the wrong shape, dtype or layout raises."""
    plan = tspool(src).update().window_plan(*_bounds(WINDOWS["two-files"]))
    shape, dtype = tdas.window_array_spec(plan)
    out = np.full(shape, 7, dtype)
    patch = tdas.assemble_window_patch(plan, out=out)
    assert np.shares_memory(patch.host_data(), out)
    assert _same(out, tdas.assemble_window_patch(plan).host_data())
    for bad in (np.empty((shape[0] + 1, shape[1]), dtype),
                np.empty(shape, np.float64),
                np.empty(shape[::-1], dtype).T):
        with pytest.raises(ValueError, match="out must be"):
            tdas.assemble_window_patch(plan, out=bad)


@pytest.mark.parametrize("no_native", [False, True])
def test_read_tdas_block_matches_jax(src, no_native, monkeypatch):
    path = sorted(p for p in os.listdir(src) if p.endswith(".tdas"))[1]
    path = os.path.join(src, path)
    if no_native:
        monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    got = tdas.read_tdas_block(path, 123, 877, 1, 6, n_threads=3)
    assert _same(got, jtdas.read_tdas_block(path, 123, 877, 1, 6))
    with pytest.raises(ValueError, match="out of bounds"):
        tdas.read_tdas_block(path, 0, 1001, 0, 7)


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_write_tdas_native_numpy_and_jax_byte_identical(payload, tmp_path,
                                                        monkeypatch):
    kw = PAYLOADS[payload]
    t_patch = tpatch(t0=T0, duration=3.0, fs=100.0, n_ch=5, noise=0.01)
    j_patch = jpatch(t0=T0, duration=3.0, fs=100.0, n_ch=5, noise=0.01)
    assert np.array_equal(t_patch.host_data(), np.asarray(j_patch.host_data()))
    tdas.write_tdas(t_patch, tmp_path / "native.tdas", **kw)
    jtdas.write_tdas(j_patch, tmp_path / "jax.tdas", **kw)
    monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    tdas.write_tdas(t_patch, tmp_path / "numpy.tdas", **kw)
    data = {n: (tmp_path / f"{n}.tdas").read_bytes()
            for n in ("native", "numpy", "jax")}
    assert data["native"] == data["numpy"] == data["jax"]
    assert len(data["native"]) == 64 + 300 * 5 * (2 if payload == "int16" else 4)


def test_failed_build_raises_and_does_not_fall_back(src, tmp_path,
                                                     monkeypatch):
    """A compiler that fails makes every native reader raise with its
    output; only TPUDAS_NO_NATIVE=1 reads with numpy."""
    import tpudas_torch.ops._build as build

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "false")
    plan = tspool(src).update().window_plan(*_bounds(WINDOWS["two-files"]))
    with pytest.raises(RuntimeError, match="building streamio.cpp failed"):
        native.load_streamio()
    with pytest.raises(RuntimeError, match="building streamio.cpp failed"):
        tdas.assemble_window_patch(plan)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-tpudas")
    with pytest.raises(RuntimeError, match="not found"):
        native.load_streamio()
    monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    assert tdas.assemble_window_patch(plan).host_data().shape[0] == 1001


_BUILD = r"""
import sys
from pathlib import Path
import tpudas_torch.ops._build as build
build.build_dir = lambda: Path(sys.argv[1])
from tpudas_torch import native
lib = native.load_streamio()
print(native.streamio_path().name, bool(lib.tdas_assemble_window_raw))
"""


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Three processes build into one empty directory at once (as test
    workers do): each compiles to its own temp name and renames it into
    place, so every one loads a whole library and no temp file stays."""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    names = {o.split()[0] for o, _ in outs}
    assert len(names) == 1 and {o.split()[1] for o, _ in outs} == {"True"}
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
