"""The plain mirror of the fused step's two-kernel split.

``fused_cascade_split_plain`` walks kernel A's time tiles (stages 0-1,
``K_1`` stage-1 outputs a tile, each tile recomputing the stage-0 halo
its z_1 rows need, the first tile's rows below p_1 from carry_1, the
last tile's rows ending with carry_1') and then runs the remaining
stages as ``fused_cascade_plain``.  Here, on the CPU at 64 channels, it
must equal ``fused_cascade_plain`` within 1e-6 of each channel's scale
(outputs and every carry leaf; the same float32 products summed in
other groupings) for the flagship plan (1 kHz -> 1 Hz), the uneven block
sequence, one- and two-stage plans, and tiles that do and do not divide
the block's stage-1 outputs; and equal the JAX package's
``cascade_decimate_stream(..., engine="fused")`` within 1e-5 at the
same seeds (the bound of ``test_torch_stream.py``).
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.ops import fir as jfir
from tpudas_torch.ops import fir
from tpudas_torch.ops.fused_kernel import (
    fused_cascade_plain,
    fused_cascade_split_plain,
    fused_stage01,
    stage01_plain,
    stage1_tile,
)

N_CH = 64
TOL = 1e-6
JAX_TOL = 1e-5
QSCALE = 1e-4
FLAGSHIP = (1000.0, 1000)
# the flagship's block sizes (60, 8 and 1 outputs) and the uneven sequence
SEQS = {"60-8-1": (60, 8, 1), "uneven": (50, 13, 1, 27, 40)}
# (fs, ratio) -> plans of one stage (7:1) and two stages (8:1, 5:1)
SMALL = {"one-stage": (50.0, 7), "two-stage": (200.0, 40)}


@pytest.fixture(autouse=True)
def one_thread():
    """The blocks are small: one intra-op thread per test worker (the
    suite runs several workers at once) keeps each test well under a
    second instead of contending for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(fs, ratio, pkg=fir):
    corner = 0.45 * fs / ratio
    return pkg.design_cascade(fs, ratio, corner, 4)


def _blocks(ratio, seq, seed, int16):
    rng = np.random.default_rng(seed)
    t = np.arange(sum(seq) * ratio) / 1000.0
    x = (np.sin(2 * np.pi * 0.05 * t)[:, None] * (1 + np.arange(N_CH) / N_CH)
         + 0.5 * np.sin(2 * np.pi * 25 * t)[:, None]
         + 0.02 * rng.standard_normal((t.size, N_CH)))
    x = np.round(x / QSCALE).astype(np.int16) if int16 else x.astype(np.float32)
    cuts = np.cumsum([0, *(n * ratio for n in seq)])
    return [np.ascontiguousarray(x[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


def _run(step, plan, blocks, qscale, **kw):
    sizes = fir.stream_carry_sizes(plan)
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    ys = []
    for b in blocks:
        y, carry = step(torch.from_numpy(b), carry, plan.stages, sizes,
                        qscale=qscale, **kw)
        ys.append(y.numpy())
    return np.concatenate(ys), [c.numpy() for c in carry]


def _assert_close(got, ref, tol):
    assert got.shape == ref.shape
    if not got.size:
        return
    scale = np.abs(ref).max(axis=0)
    floor = max(float(scale.max()) * 1e-7, 1e-30)
    err = np.abs(got - ref).max(axis=0)
    assert (err <= tol * np.maximum(scale, floor)).all(), float(err.max())


def _assert_same(a, b, tol=TOL):
    (ya, ca), (yb, cb) = a, b
    _assert_close(ya, yb, tol)
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        _assert_close(x, y, tol)


@pytest.mark.parametrize("k1", [None, 7, 25])
@pytest.mark.parametrize("seq", sorted(SEQS))
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_split_matches_plain_flagship(seq, int16, k1):
    """K_1 = 50 (the kernel's: divides a 60- or 8-output block's 1,500
    or 200 stage-1 outputs, not a 1-output block's 25), 7 (divides none)
    and 25 (divides every one)."""
    plan = _plan(*FLAGSHIP)
    blocks = _blocks(plan.ratio, SEQS[seq], seed=len(seq), int16=int16)
    qs = QSCALE if int16 else None
    _assert_same(_run(fused_cascade_split_plain, plan, blocks, qs, k1=k1),
                 _run(fused_cascade_plain, plan, blocks, qs))


@pytest.mark.parametrize("k1", [None, 3, 1])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_split_matches_plain_short_plans(name, k1):
    """A one-stage plan (kernel A with the identity as stage 1 writes y)
    and a two-stage plan (kernel A alone)."""
    plan = _plan(*SMALL[name])
    blocks = _blocks(plan.ratio, SEQS["uneven"], seed=3, int16=False)
    _assert_same(_run(fused_cascade_split_plain, plan, blocks, None, k1=k1),
                 _run(fused_cascade_plain, plan, blocks, None))


@pytest.mark.parametrize("seq", sorted(SEQS))
def test_split_matches_jax_fused(seq, monkeypatch):
    """The split against the JAX package's fused step at the same seed
    (the fused size threshold cleared so "fused" runs the fused step)."""
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    plan, jplan = _plan(*FLAGSHIP), _plan(*FLAGSHIP, pkg=jfir)
    blocks = _blocks(plan.ratio, SEQS[seq], seed=11, int16=False)
    carry = jfir.cascade_stream_init(jplan, N_CH)
    ys = []
    for b in blocks:
        y, carry = jfir.cascade_decimate_stream(b, carry, jplan, "fused")
        ys.append(np.asarray(y))
    ref = (np.concatenate(ys), [np.asarray(c) for c in carry])
    _assert_same(_run(fused_cascade_split_plain, plan, blocks, None), ref,
                 JAX_TOL)


def test_tile_and_halo_at_the_flagship():
    """K_1 = 50: 274 stage-0 outputs a tile, 24 of them the halo."""
    plan = _plan(*FLAGSHIP)
    (R1, h1) = plan.stages[1]
    k1 = stage1_tile(R1)
    halo = len(h1) - R1
    assert (k1, halo, k1 * R1 + halo) == (50, 24, 274)
    assert halo / (k1 * R1) <= 0.10


def test_stage01_wrapper_runs_the_mirror_on_the_cpu():
    """Kernel A's wrapper on a CPU tensor is the mirror's first part."""
    plan = _plan(*FLAGSHIP)
    (x,) = _blocks(plan.ratio, (3,), seed=5, int16=True)
    x = torch.from_numpy(x)
    sizes = fir.stream_carry_sizes(plan)
    carry = fir.cascade_stream_init(plan, N_CH, "cpu")
    u, new = fused_stage01(x, carry[:2], plan.stages[:2], sizes[:2], QSCALE)
    u2, new2 = stage01_plain(x, carry[:2], plan.stages[:2], sizes[:2], QSCALE)
    assert u.shape == (3 * 25, N_CH)
    assert torch.equal(u, u2) and all(map(torch.equal, new, new2))


def test_split_refuses_a_stage1_that_carries_more_than_its_halo():
    plan = _plan(*FLAGSHIP)
    sizes = list(fir.stream_carry_sizes(plan))
    sizes[1] += 1
    carry = [torch.zeros((p, N_CH)) for p in sizes]
    x = torch.zeros((plan.ratio, N_CH))
    with pytest.raises(ValueError, match="exactly its halo"):
        stage01_plain(x, carry[:2], plan.stages[:2], sizes[:2])
