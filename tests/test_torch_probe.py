"""The port's HBM read probes against the TPU probes they replace.

``tools/probe_pipeline.py`` (P1 ``copy_kernel``, P2
``copy_kernel_pstream``) and ``tools/probe_dma.py`` (P3
``manual_reader``) are imported read-only, their module-level ``T``/``C``
patched down to 4,096 x 256, and run in Pallas' TPU interpret mode on
the CPU.  The same seeded numpy array goes through the port's wrappers
on ``device="cpu"`` (their plain versions).  P1/P2 are head copies and
must be bit-equal; P3 is a sum, held within 1e-6 of the sum of the
absolute terms (the TPU accumulates in float32, the port in float64).
"""

import os
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpudas_torch.ops import hbm_probe
from tpudas_torch.ops.hbm_probe import (
    copy_heads,
    copy_heads_plain,
    copy_heads_pstream,
    heads_rows,
    ring_reader,
    ring_reader_plain,
)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")
T, C = 4096, 256


@pytest.fixture(scope="module")
def tpu_probes():
    # the tools add their own directory (and ".") to sys.path on import;
    # restore it so no other test sees tools/ as top-level modules
    saved = list(sys.path)
    sys.path.insert(0, TOOLS)
    try:
        import probe_dma
        import probe_pipeline
    finally:
        sys.path[:] = saved
    return probe_pipeline, probe_dma


@pytest.fixture
def small(tpu_probes, monkeypatch):
    pp, pd = tpu_probes
    for mod in (pp, pd):
        monkeypatch.setattr(mod, "T", T)
        monkeypatch.setattr(mod, "C", C)
    return pp, pd


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(3).standard_normal((T, C)).astype(np.float32)


@pytest.mark.parametrize("rows,cb,k_fastest", [
    (256, 64, False), (256, 64, True), (512, 128, False), (128, 256, True),
    (1024, 32, False),
])
def test_p1_equals_tpu_copy_kernel(small, x_np, rows, cb, k_fastest):
    pp, _ = small
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pp.copy_kernel(rows, cb, k_fastest)(x_np))
    got = copy_heads(torch.from_numpy(x_np), rows, cb, k_fastest)
    assert got.shape == (T // 8, C)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("P,rows,cb", [
    (1, 512, 64), (2, 512, 64), (3, 512, 64), (4, 256, 128), (4, 128, 256),
])
def test_p2_equals_tpu_pstream(small, x_np, P, rows, cb):
    pp, _ = small
    with pltpu.force_tpu_interpret_mode():
        fn, t_eff = pp.copy_kernel_pstream(P, rows, cb)
        ref = np.asarray(fn(x_np))
    assert t_eff == heads_rows(T, rows, P)
    if (P, rows) == (3, 512):
        assert t_eff == 3072  # fewer rows than T are read and credited
    got = copy_heads_pstream(torch.from_numpy(x_np), P, rows, cb)
    assert got.shape == (t_eff // 8, C)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows,nbuf", [(256, 4), (128, 8), (512, 2)])
def test_p3_equals_tpu_manual_reader(small, x_np, rows, nbuf):
    _, pd = small
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pd.manual_reader(rows, nbuf)(x_np))
    got = ring_reader(torch.from_numpy(x_np), rows, nbuf)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    terms = np.abs(x_np[0 : (T // rows) * rows : rows]).astype(np.float64).sum()
    assert abs(float(got) - float(ref[0, 0])) <= 1e-6 * terms


def test_plain_versions_are_the_stated_functions(x_np):
    x = torch.from_numpy(x_np)
    head = copy_heads_plain(x, 256, 64)
    np.testing.assert_array_equal(head.numpy()[:32], x_np[:32])
    np.testing.assert_array_equal(head.numpy()[32:64], x_np[256:288])
    s = ring_reader_plain(x, 100)  # 40 whole chunks; the 96 tail rows unread
    ref = np.float32(x_np[0:4000:100].astype(np.float64).sum())
    assert float(s) == float(ref)


def test_cpu_wrappers_run_plain_without_launching(x_np):
    x = torch.from_numpy(x_np)
    before = (copy_heads.launches, copy_heads_pstream.launches,
              ring_reader.launches)
    copy_heads(x, 256, 64)
    copy_heads_pstream(x, 2, 256, 64)
    ring_reader(x, 256, 4)
    assert (copy_heads.launches, copy_heads_pstream.launches,
            ring_reader.launches) == before
    assert hbm_probe._lib is None  # nothing was built


@pytest.mark.parametrize("call,match", [
    (lambda x: copy_heads(x, 100, 64), "multiple of 8"),
    (lambda x: copy_heads(x, 0, 64), "multiple of 8"),
    (lambda x: copy_heads(x, 256, 100), "does not divide"),
    (lambda x: copy_heads_pstream(x, 2, 12, 64), "multiple of 8"),
    (lambda x: copy_heads_pstream(x, 2, 256, 96), "does not divide"),
    (lambda x: copy_heads_pstream(x, 0, 256, 64), "P must be"),
    (lambda x: ring_reader(x, 0, 2), "rows must be"),
    (lambda x: ring_reader(x, 128, 0), "nbuf must be"),
    (lambda x: copy_heads(x.double(), 256, 64), "float32"),
    (lambda x: copy_heads(x.t(), 256, 64), "contiguous"),
    (lambda x: ring_reader(x[:, 0], 128, 2), r"\(T, C\)"),
])
def test_wrapper_geometry_errors_raise(x_np, call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.from_numpy(x_np))


def test_probe_tools_dry_run_on_cpu(capsys):
    """The entry points sweep the TPU tools' own geometry lists end to
    end on the plain versions (a short T), crediting only the rows a
    geometry reads."""
    from tpudas_torch.tools import probe_dma, probe_pipeline

    argv = ["--T", "2048", "--iters", "1", "--device", "cpu"]
    recs = probe_pipeline.main(argv) + probe_dma.main(argv)
    out = capsys.readouterr().out
    assert "cpu dry run" in out and "nbuf=8" in out and "kfast=1" in out
    kinds = [r["probe"] for r in recs]
    assert kinds == ["P1"] * 9 + ["P2"] * 6 + ["P3"] * 8 + ["torch.sum", "copy_"]
    p2 = {(r["P"], r["rows"]): r for r in recs if r["probe"] == "P2"}
    assert p2[(2, 1024)]["t_eff"] == 2048
    assert p2[(8, 1024)]["t_eff"] == 0 and p2[(8, 1024)]["read_bytes"] == 0
    for rec in recs:
        assert rec["ms"] > 0
        if rec["probe"] in ("P1", "P2") and rec["t_eff"]:
            assert rec["written_bytes"] * 8 == rec["read_bytes"]
            assert rec["read_bytes"] == rec["t_eff"] * 2048 * 4
    copy = recs[-1]
    assert copy["written_bytes"] == copy["read_bytes"] == 2048 * 2048 * 4


def test_harness_without_cuda_and_without_device_raises(monkeypatch):
    from tpudas_torch.tools.harness import measure

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure(torch.sum, 64, 8, iters=1)
