"""tpudas_torch's stateful stream step against the JAX package's.

The same numpy blocks (the uneven schedule of ``tests/test_fused.py``,
5 channels, the three plans it uses) go through
``tpudas.ops.fir.cascade_decimate_stream`` and the port's on the CPU.
Outputs and every carry leaf must agree within 1e-5 of each channel's
scale: the two sum the same f32 products in different orders.  Within
the port, the plain fused step must equal the per-stage chain byte for
byte, as the reference's ``fused-xla`` scan equals its chain.
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.ops import fir as jfir
from tpudas_torch.ops import fir
from tpudas_torch.ops.fused_kernel import fused_cascade, fused_cascade_plain

REL_TOL = 1e-5
PLANS = [(100.0, 100), (200.0, 40), (50.0, 7)]
N_CH = 5


def _plans(fs, ratio):
    """The same design in both packages (taps bit-equal)."""
    corner = 0.45 * fs / ratio
    return fir.design_cascade(fs, ratio, corner, 4), jfir.design_cascade(
        fs, ratio, corner, 4
    )


def _blocks(ratio, seed=0, n_ch=N_CH, nan_gap=False):
    rng = np.random.default_rng(seed)
    blocks = [
        rng.standard_normal((n * ratio, n_ch)).astype(np.float32)
        for n in (50, 13, 1, 27, 40)
    ]
    if nan_gap:
        blocks[1][ratio : 2 * ratio, 2] = np.nan
        blocks[3][-ratio // 2 :, 0] = np.nan
    return blocks


def _run_port(plan, blocks, engine, qscale=None):
    carry = fir.cascade_stream_init(plan, blocks[0].shape[1], "cpu")
    outs = []
    for b in blocks:
        y, carry = fir.cascade_decimate_stream(
            torch.from_numpy(b), carry, plan, engine, qscale=qscale
        )
        outs.append(y.numpy())
    return np.concatenate(outs), [c.numpy() for c in carry]


def _run_jax(plan, blocks, engine):
    carry = jfir.cascade_stream_init(plan, blocks[0].shape[1])
    outs = []
    for b in blocks:
        y, carry = jfir.cascade_decimate_stream(b, carry, plan, engine)
        outs.append(np.asarray(y))
    return np.concatenate(outs), [np.asarray(c) for c in carry]


def _assert_close(got, ref, tol=REL_TOL):
    assert got.shape == ref.shape
    if not got.size:
        return
    scale = np.abs(ref).max(axis=0)
    floor = max(float(scale.max()) * 1e-7, 1e-30)
    err = np.abs(got - ref).max(axis=0)
    assert (err <= tol * np.maximum(scale, floor)).all(), float(err.max())


@pytest.mark.parametrize("fs,ratio", PLANS)
@pytest.mark.parametrize(
    "port_engine,jax_engine", [("torch", "xla"), ("fused-torch", "fused-xla")]
)
def test_stream_matches_jax(fs, ratio, port_engine, jax_engine):
    plan, jplan = _plans(fs, ratio)
    blocks = _blocks(ratio)
    y, carry = _run_port(plan, blocks, port_engine)
    yj, carry_j = _run_jax(jplan, blocks, jax_engine)
    _assert_close(y, yj)
    assert len(carry) == len(carry_j)
    for a, b in zip(carry, carry_j):
        _assert_close(a, b)


def test_fused_torch_matches_jax_fused_pallas():
    """The TPU kernel itself (interpret mode on the CPU) on one plan."""
    plan, jplan = _plans(100.0, 100)
    blocks = _blocks(100, seed=1)
    y, carry = _run_port(plan, blocks, "fused-torch")
    yj, carry_j = _run_jax(jplan, blocks, "fused-pallas")
    _assert_close(y, yj)
    for a, b in zip(carry, carry_j):
        _assert_close(a, b)


@pytest.mark.parametrize("fs,ratio", PLANS)
@pytest.mark.parametrize("nan_gap", [False, True])
def test_fused_plain_byte_equal_to_chain(fs, ratio, nan_gap):
    """The plain fused loop replays the chain's arithmetic chunk by
    chunk: outputs and every carry leaf equal, NaN gaps included."""
    plan, _ = _plans(fs, ratio)
    blocks = _blocks(ratio, seed=2, nan_gap=nan_gap)
    y0, c0 = _run_port(plan, blocks, "torch")
    y1, c1 = _run_port(plan, blocks, "fused-torch")
    np.testing.assert_array_equal(y0, y1)
    for a, b in zip(c0, c1):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk_out", [1, 3, 40])
def test_fused_plain_chunking_does_not_change_the_result(chunk_out):
    plan, _ = _plans(100.0, 100)
    x = torch.from_numpy(_blocks(100, seed=3)[4])  # 40 outputs
    sizes = fir.stream_carry_sizes(plan)
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    ref, rc = fused_cascade_plain(x, carry, plan.stages, sizes, chunk_out=40)
    got, gc = fused_cascade_plain(x, carry, plan.stages, sizes,
                                  chunk_out=chunk_out)
    assert torch.equal(got, ref)
    for a, b in zip(gc, rc):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "fs,ratio",
    PLANS + [(1000.0, 1000), (1000.0, 10), (200.0, 8), (500.0, 50),
             (100.0, 1), (250.0, 125)],
)
def test_stream_geometry_matches_jax(fs, ratio):
    plan, jplan = _plans(fs, ratio)
    assert fir.stream_carry_sizes(plan) == jfir.stream_carry_sizes(jplan)
    assert fir.stream_warmup_outputs(plan) == jfir.stream_warmup_outputs(jplan)
    for n_out in (1, 7, 20, 60, 64):
        assert fir.fused_chunk_outputs(plan, n_out) == (
            jfir.fused_chunk_outputs(jplan, n_out)
        )
    T = 60 * plan.ratio
    assert fir.fused_intermediate_bytes(plan, T, 9) == (
        jfir.fused_intermediate_bytes(jplan, T, 9)
    )


def test_flagship_geometry():
    """The numbers the CUDA kernel's design rests on."""
    plan, _ = _plans(1000.0, 1000)
    assert [int(R) for R, _ in plan.stages] == [8, 5, 5, 5]
    assert [len(h) for _, h in plan.stages] == [43, 29, 33, 125]
    assert fir.stream_carry_sizes(plan) == (688, 24, 28, 120)
    assert fir.stream_warmup_outputs(plan) == 26
    assert fir.fused_intermediate_bytes(plan, 60000, 10000) == (
        (7500 + 1500 + 300) * 10000 * 4
    )


def test_chunk_outputs_divides(monkeypatch):
    plan, jplan = _plans(1000.0, 1000)
    for n_out in (1, 7, 20, 64, 40):
        c = fir.fused_chunk_outputs(plan, n_out)
        assert n_out % c == 0 and 1 <= c <= 8
    monkeypatch.setenv("TPUDAS_FUSED_CHUNK", "4")
    assert fir.fused_chunk_outputs(plan, 20) == 4
    assert jfir.fused_chunk_outputs(jplan, 20) == 4


def test_resolver_literals_and_threshold(monkeypatch):
    plan, jplan = _plans(100.0, 100)
    assert fir.STREAM_ENGINES == (
        "auto", "cuda", "torch", "fused", "fused-cuda", "fused-torch"
    )
    for bad in ("warp", "xla", "fused-xla", "fused-pallas"):
        with pytest.raises(ValueError, match="stream engine"):
            fir.resolve_stream_engine(bad, plan, 100, 4, "cpu")
    assert fir.resolve_stream_engine("auto", plan, 100, 4, "cpu") == "torch"
    assert fir.resolve_stream_engine("torch", plan, 100, 4, "cpu") == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        fir.resolve_stream_engine("fused-cuda", plan, 100, 4, "cpu")
    # the same threshold picks the same family in both packages
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "1000000")
    assert fir.resolve_stream_engine("fused", plan, 100, 4, "cpu") == "torch"
    assert jfir.resolve_stream_engine("fused", jplan, 100, 4) == "xla"
    assert fir.resolve_stream_engine(
        "fused-torch", plan, 100, 4, "cpu") == "fused-torch"
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "1")
    assert fir.resolve_stream_engine(
        "fused", plan, 100, 4, "cpu") == "fused-torch"
    assert jfir.resolve_stream_engine("fused", jplan, 100, 4) == "fused-xla"
    assert fir.stream_stage_engines(plan, 100, 4, "fused", "cpu") == (
        ["fused-torch"] * len(plan.stages)
    )


def test_stream_step_rejects_bad_input():
    plan, _ = _plans(100.0, 100)
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    x = torch.zeros((150, N_CH))
    with pytest.raises(ValueError, match="multiple"):
        fir.cascade_decimate_stream(x, carry, plan, "torch")
    x = torch.zeros((200, N_CH))
    with pytest.raises(ValueError, match="stream_carry_sizes"):
        fir.cascade_decimate_stream(x, carry[:-1], plan, "torch")
    with pytest.raises(ValueError, match="channel"):
        fir.cascade_decimate_stream(
            torch.zeros((200, N_CH + 1)), carry, plan, "torch")
    with pytest.raises(ValueError, match="qscale"):
        fir.cascade_decimate_stream(x, carry, plan, "torch", qscale=1e-4)


@pytest.mark.parametrize("engine", ["torch", "fused-torch"])
def test_quantized_block_equals_dequantized(engine):
    """A raw int16 block with its scale gives exactly what the
    dequantized float32 block gives; the carry stays float32."""
    plan, _ = _plans(200.0, 40)
    rng = np.random.default_rng(4)
    raw = [
        (rng.standard_normal((n * 40, N_CH)) * 3000).astype(np.int16)
        for n in (13, 1, 27)
    ]
    qs = np.float32(3e-4)
    y_q, c_q = _run_port(plan, raw, engine, qscale=qs)
    deq = [(torch.from_numpy(b).float() * torch.tensor(qs)).numpy() for b in raw]
    y_f, c_f = _run_port(plan, deq, engine)
    np.testing.assert_array_equal(y_q, y_f)
    for a, b in zip(c_q, c_f):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_crossover_between_engines_mid_stream():
    """The carry moves freely between the chain and the fused step:
    alternating engines equals the pure chain byte for byte."""
    plan, _ = _plans(100.0, 100)
    blocks = _blocks(100, seed=5)
    y0, c0 = _run_port(plan, blocks, "torch")
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    outs = []
    for b, eng in zip(blocks, ["torch", "fused-torch", "fused-torch",
                               "auto", "fused-torch"]):
        y, carry = fir.cascade_decimate_stream(
            torch.from_numpy(b), carry, plan, eng)
        outs.append(y.numpy())
    np.testing.assert_array_equal(y0, np.concatenate(outs))
    for a, b in zip(c0, carry):
        np.testing.assert_array_equal(a, b.numpy())


def test_numpy_carry_leaves_resume():
    """A loaded carry arrives as numpy arrays; the step moves them to
    the block's device and returns fresh tensors."""
    plan, _ = _plans(100.0, 100)
    blocks = _blocks(100, seed=6)
    y0, c0 = _run_port(plan, blocks, "torch")
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    y, carry = fir.cascade_decimate_stream(
        torch.from_numpy(blocks[0]), carry, plan, "fused-torch")
    host = tuple(c.numpy().copy() for c in carry)
    outs = [y.numpy()]
    carry = host
    for b in blocks[1:]:
        y, carry = fir.cascade_decimate_stream(
            torch.from_numpy(b), carry, plan, "torch")
        outs.append(y.numpy())
    np.testing.assert_array_equal(y0, np.concatenate(outs))


def test_fused_wrapper_on_cpu_runs_plain_without_launching():
    plan, _ = _plans(100.0, 100)
    sizes = fir.stream_carry_sizes(plan)
    x = torch.from_numpy(_blocks(100, seed=7)[1])
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    before = fused_cascade.launches
    y, new = fused_cascade(x, carry, plan.stages, sizes)
    ry, rnew = fused_cascade_plain(x, carry, plan.stages, sizes)
    assert fused_cascade.launches == before
    assert torch.equal(y, ry)
    for a, b, old in zip(new, rnew, carry):
        assert torch.equal(a, b)
        assert a.data_ptr() != old.data_ptr() or not a.numel()
    with pytest.raises(ValueError, match="carry leaf"):
        fused_cascade(x, tuple(c[:, :2] for c in carry), plan.stages, sizes)
    with pytest.raises(TypeError, match="float32 or int16"):
        fused_cascade(x.double(), carry, plan.stages, sizes)
