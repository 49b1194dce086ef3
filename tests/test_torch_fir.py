"""tpudas_torch.ops.fir / fir_kernel against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
function and its port.  Design math is bit-equal (it is the same
numpy/scipy code).  Stage and cascade outputs agree within 1e-5
relative per channel: the JAX side runs the Pallas kernel in interpret
mode (exact f32 dots) or the XLA formulation, the port its plain
PyTorch stage, and the two sum the same f32 products in different
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudas.ops import fir as jfir
from tpudas.ops.pallas_fir import fir_decimate_pallas
from tpudas.proc.lfproc import output_corner as j_output_corner
from tpudas_torch.ops import fir as tfir
from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain
from tpudas_torch.proc.lfproc import output_corner

REL_TOL = 1e-5  # per channel: same f32 products, different sum order

# (fs_in, ratio, corner, order): the flagship 1 kHz -> 1 Hz, the test
# spools' 200 Hz -> 1 Hz, and off-flagship ratios / orders
DESIGNS = [
    (1000.0, 1000, 0.45, 4),
    (200.0, 200, 0.45, 4),
    (100.0, 100, 0.45, 4),
    (1000.0, 60, 7.5, 4),
    (500.0, 64, 3.0, 6),
    (250.0, 7, 16.0, 2),
]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max(axis=0)
    scale = np.abs(ref).max(axis=0)
    return float((err / np.maximum(scale, scale.max() * 1e-7)).max())


def _window(T, C, seed, int16=False):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 200.0
    x = (np.sin(2 * np.pi * 0.05 * t)[:, None] * (1 + np.arange(C) / C)
         + 0.5 * np.sin(2 * np.pi * 25 * t)[:, None]
         + 0.02 * rng.standard_normal((T, C)))
    if int16:
        return np.round(x / 1e-4).astype(np.int16)
    return x.astype(np.float32)


@pytest.mark.parametrize("design", DESIGNS, ids=lambda d: f"{d[0]:g}Hz-r{d[1]}")
def test_design_bit_equal(design):
    p = tfir.design_cascade(*design)
    q = jfir.design_cascade(*design)
    assert (p.ratio, p.delay, p.fs_in, p.corner, p.order) == (
        q.ratio, q.delay, q.fs_in, q.corner, q.order
    )
    assert len(p.stages) == len(q.stages)
    for (ra, ha), (rb, hb) in zip(p.stages, q.stages):
        assert ra == rb
        assert ha.dtype == hb.dtype == np.float32
        assert np.array_equal(ha, hb)


def test_output_corner_equal():
    for dt in (1.0, 0.5, 0.1, 2.0):
        assert output_corner(dt) == j_output_corner(dt)


def test_plan_from_arrays_round_trips_a_jax_plan():
    q = jfir.design_cascade(1000.0, 1000, 0.45)
    p = tfir.plan_from_arrays(
        [(R, np.asarray(h)) for R, h in q.stages], q.ratio, q.delay,
        q.fs_in, q.corner, q.order,
    )
    assert p == tfir.design_cascade(1000.0, 1000, 0.45)
    x = _window(6000, 5, seed=1)
    a = tfir.cascade_decimate(x, p, 2000, 3, device="cpu")
    b = tfir.cascade_decimate(
        x, tfir.design_cascade(1000.0, 1000, 0.45), 2000, 3, device="cpu"
    )
    assert torch.equal(a, b)


def test_plan_from_arrays_rejects_inconsistent_plans():
    q = jfir.design_cascade(200.0, 200, 0.45)
    stages = [(R, np.asarray(h)) for R, h in q.stages]
    with pytest.raises(ValueError, match="delay"):
        tfir.plan_from_arrays(stages, q.ratio, q.delay + 1, 200.0, 0.45, 4)
    with pytest.raises(ValueError, match="multiply"):
        tfir.plan_from_arrays(stages, 2 * q.ratio, q.delay, 200.0, 0.45, 4)
    with pytest.raises(ValueError, match="odd"):
        tfir.plan_from_arrays([(5, np.ones(4))], 5, 2, 200.0, 0.45, 4)


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("stage", [0, 3])
def test_plain_stage_matches_pallas_interpret_and_xla(stage, int16):
    """Ragged T (short of (n_out + B) * R) and C (not a lane multiple):
    the port's plain stage vs the Pallas kernel in interpret mode and
    vs the XLA polyphase formulation."""
    plan = jfir.design_cascade(1000.0, 1000, 0.45)
    R, h = plan.stages[stage]
    hb = jfir._block_taps(np.asarray(h), R)
    n_out = 130
    T = (n_out + hb.shape[0]) * R - 11
    x = _window(T, 37, seed=stage, int16=int16)
    got = fir_decimate_plain(torch.from_numpy(x), torch.from_numpy(hb), R, n_out)
    pal = fir_decimate_pallas(jnp.asarray(x), hb, R, n_out=n_out, interpret=True)
    xla = jfir._polyphase_stage_xla(
        jnp.asarray(x).astype(jnp.float32), jnp.asarray(hb), R, n_out
    )
    assert got.shape == (n_out, 37) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(pal)) <= REL_TOL
    assert _rel(got.numpy(), np.asarray(xla)) <= REL_TOL


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    plan = tfir.design_cascade(200.0, 200, 0.45)
    R, h = plan.stages[0]
    hb = torch.from_numpy(jfir._block_taps(np.asarray(h), R))
    x = torch.from_numpy(_window(900, 9, seed=3))
    before = fir_decimate.launches
    assert torch.equal(fir_decimate(x, hb, R, 100), fir_decimate_plain(x, hb, R, 100))
    assert fir_decimate.launches == before


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda x, hb: (x.double(), hb), "float32 or int16"),
        (lambda x, hb: (x[:, ::2], hb), "contiguous"),
        (lambda x, hb: (x[:, 0], hb), r"\(T, C\)"),
        (lambda x, hb: (x, hb.double()), "taps"),
    ],
    ids=["dtype", "contiguity", "rank", "tap-dtype"],
)
def test_wrapper_rejects_bad_inputs(bad, match):
    x = torch.zeros((80, 6), dtype=torch.float32)
    hb = torch.zeros((3, 8), dtype=torch.float32)
    x, hb = bad(x, hb)
    with pytest.raises((TypeError, ValueError), match=match):
        fir_decimate(x, hb, 8, 5)


# phase - delay: positive, negative, and more negative than one time
# tile of the stage kernel (TILE_OUTPUTS outputs x R = 8 rows)
SHIFTS = {"phase>delay": 777, "phase<delay": -901, "phase<<delay": -2600}


def _cascade_vs_jax(shift, quantized):
    plan_j = jfir.design_cascade(200.0, 200, 0.45)
    plan_t = tfir.design_cascade(200.0, 200, 0.45)
    phase = plan_j.delay + SHIFTS[shift]
    n_out = 9
    T = phase + (n_out - 1) * 200 + plan_j.delay + 50
    x = _window(T, 13, seed=4, int16=quantized)
    qs = 1e-4 if quantized else None
    ref = jfir.cascade_decimate(jnp.asarray(x), plan_j, phase, n_out, "xla",
                                qscale=qs)
    got = tfir.cascade_decimate(x, plan_t, phase, n_out, qscale=qs,
                                device="cpu")
    assert got.device.type == "cpu" and got.shape == (n_out, 13)
    assert _rel(got.numpy(), np.asarray(ref)) <= REL_TOL


@pytest.mark.parametrize("shift", list(SHIFTS))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "qscale"])
def test_cascade_matches_jax(shift, quantized):
    _cascade_vs_jax(shift, quantized)


@pytest.mark.parametrize("shift", list(SHIFTS))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "qscale"])
def test_cascade_kernel_path_matches_jax(monkeypatch, shift, quantized):
    """The kernel path's control flow on the CPU: stage 0 reads from
    row phase - delay (no shifted copy), int16 stays int16 into stage 0
    and the scale multiplies its output; ``fir_decimate`` on a CPU
    tensor runs the plain stage with that first row."""
    monkeypatch.setattr(tfir, "resolve_cascade_engine", lambda e, d: "cuda")
    shifts = []
    plain_shift = tfir.shift_to_phase
    monkeypatch.setattr(tfir, "shift_to_phase",
                        lambda *a: shifts.append(a) or plain_shift(*a))
    _cascade_vs_jax(shift, quantized)
    assert shifts == []


def test_cascade_qscale_equals_decoded_input():
    plan = tfir.design_cascade(200.0, 200, 0.45)
    q = _window(6000, 4, seed=5, int16=True)
    dec = q.astype(np.float32) * np.float32(1e-4)
    a = tfir.cascade_decimate(q, plan, 3000, 5, qscale=1e-4, device="cpu")
    b = tfir.cascade_decimate(dec, plan, 3000, 5, device="cpu")
    assert torch.equal(a, b)  # the plain path dequantizes first


def test_cascade_engine_literals():
    plan = tfir.design_cascade(200.0, 200, 0.45)
    x = torch.from_numpy(_window(6000, 3, seed=6))
    with pytest.raises(ValueError, match="cuda"):
        tfir.cascade_decimate(x, plan, 3000, 5, engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        tfir.cascade_decimate(x, plan, 3000, 5, engine="pallas")
    with pytest.raises(ValueError, match="qscale"):
        tfir.cascade_decimate(x, plan, 3000, 5, qscale=0.5)
    a = tfir.cascade_decimate(x, plan, 3000, 5, engine="torch")
    b = tfir.cascade_decimate(x, plan, 3000, 5, engine="auto")
    assert torch.equal(a, b)
    assert tfir.stage_engines(plan, 5, device="cpu") == ["torch"] * 3


def test_numpy_input_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = tfir.design_cascade(200.0, 200, 0.45)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfir.cascade_decimate(_window(6000, 3, seed=7), plan, 3000, 5)


@pytest.mark.parametrize("n_out", [1, 40, 1000])
@pytest.mark.parametrize("design", DESIGNS[:3], ids=lambda d: f"{d[0]:g}Hz-r{d[1]}")
def test_chain_layout_equals_jax_xla_layout(design, n_out):
    p = tfir.design_cascade(*design)
    q = jfir.design_cascade(*design)
    (lt, rows_t) = tfir.chain_layout(p, n_out, device="cpu")
    (lj, rows_j) = jfir.chain_layout(q, n_out, 16, "xla")
    assert rows_t == rows_j == tfir.cascade_input_need(p, n_out)
    assert [k for _, k in lt] == [k for _, k in lj]


@pytest.mark.parametrize("design", DESIGNS, ids=lambda d: f"{d[0]:g}Hz-r{d[1]}")
def test_edge_support_and_impulse_response_equal(design):
    p = tfir.design_cascade(*design)
    q = jfir.design_cascade(*design)
    assert np.array_equal(tfir.impulse_response(p), jfir.impulse_response(q))
    for tol in (1e-2, 1e-3, 1e-4):
        assert tfir.edge_support_samples(p, tol) == jfir.edge_support_samples(q, tol)
