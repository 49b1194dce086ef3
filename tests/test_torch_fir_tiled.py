"""The strided-FIR kernel's tiling, walked on the CPU.

``fir_decimate_tiled_plain`` computes the stage as the CUDA kernel of
``csrc/fir_decimate.cu`` does: channel stripes of one 128-byte row
segment, time tiles of ``TILE_OUTPUTS`` outputs, tap frames in chunks
of ``chunk_frames``, rows outside ``[0, T)`` (a negative first row
``row0`` included) staged as zero, and the kernel's order of fused
multiply-adds.  It is held to ``fir_decimate_plain`` within 1e-6 per
channel (the same float32 products summed in another order; at 4,095
taps to a float64 evaluation, see the long-tap test), and to the
JAX package's Pallas stage in interpret mode on the equivalently
shifted input within 1e-5, as tests/test_torch_fir.py holds the plain
stage.  The plain stage's ``row0`` is bit-equal to the stage on the
left-padded or sliced window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudas.ops import fir as jfir
from tpudas.ops.pallas_fir import fir_decimate_pallas
from tpudas_torch.ops import fir as tfir
from tpudas_torch.ops.fir_kernel import (
    TILE_OUTPUTS,
    chunk_frames,
    fir_decimate_plain,
    fir_decimate_tiled_plain,
)

MIRROR_TOL = 1e-6  # mirror vs plain: same f32 products, other order
JAX_TOL = 1e-5  # as tests/test_torch_fir.py

PLAN = tfir.design_cascade(1000.0, 1000, 0.45)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max(axis=0)
    scale = np.abs(ref).max(axis=0)
    return float((err / np.maximum(scale, scale.max() * 1e-7)).max())


def _window(T, C, seed, int16=False):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 1000.0
    x = (np.sin(2 * np.pi * 0.05 * t)[:, None] * (1 + np.arange(C) / C)
         + 0.5 * np.sin(2 * np.pi * 25 * t)[:, None]
         + 0.02 * rng.standard_normal((T, C)))
    if int16:
        return np.round(x / 1e-4).astype(np.int16)
    return x.astype(np.float32)


def _stage(i):
    R, hb = tfir.blocked_taps(PLAN, "cpu")[i]
    return R, hb


def _shifted(x, row0):
    """The window as shift_to_phase leaves it for first row ``row0``."""
    if row0 < 0:
        return np.concatenate([np.zeros((-row0, x.shape[1]), x.dtype), x])
    return x[row0:]


# first rows: more than one time tile's rows before the window, at it,
# inside it
ROW0S = [-(TILE_OUTPUTS * 8 + 53), 0, 37]


@pytest.mark.parametrize("row0", ROW0S, ids=lambda r: f"row0={r}")
@pytest.mark.parametrize("C", [37, 333])
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("stage", [0, 1, 3], ids=lambda s: f"stage{s}")
def test_tiled_mirror_matches_plain(stage, int16, C, row0):
    """The flagship stages (R = 8 and 5) at ragged T and C: n_out is
    not a multiple of the tile and T is short of the last output's
    rows."""
    R, hb = _stage(stage)
    T = 1500
    n_out = (T - row0) // R - hb.shape[0] + 4
    x = torch.from_numpy(_window(T, C, seed=stage + C, int16=int16))
    got = fir_decimate_tiled_plain(x, hb, R, n_out, row0)
    ref = fir_decimate_plain(x, hb, R, n_out, row0)
    assert got.shape == (n_out, C) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref.numpy()) <= MIRROR_TOL


@pytest.mark.parametrize("row0", [-1000, 0])
def test_tiled_mirror_long_taps(row0):
    """4,095 taps at R = 5: several tap-frame chunks per tile.  At this
    length the plain version's own float32 error (its 819-term frame sum
    runs in sequence) is ~1.7e-6 of the output, so the mirror is held
    to a float64 evaluation of the stage within 1e-6 and to the plain
    version within 1e-5, the kernel's tolerance on the card.  The taps
    are a designed low-pass, as a stage of that length is."""
    from scipy.signal import firwin

    B, R = 819, 5
    assert chunk_frames(R, B) < B
    hb = firwin(B * R, 0.8 / R).astype(np.float32).reshape(B, R)
    n_out = TILE_OUTPUTS + 13
    x = _window((n_out + B) * R - 7, 37, seed=12)
    got = fir_decimate_tiled_plain(torch.from_numpy(x), torch.from_numpy(hb),
                                   R, n_out, row0)
    xs = _shifted(x, row0).astype(np.float64)
    xs = np.concatenate([xs, np.zeros(((n_out + B) * R, x.shape[1]))])
    h = hb.astype(np.float64).reshape(-1)
    exact = np.stack([h @ xs[k * R : k * R + B * R] for k in range(n_out)])
    assert _rel(got.numpy(), exact) <= MIRROR_TOL
    ref = fir_decimate_plain(torch.from_numpy(x), torch.from_numpy(hb), R,
                             n_out, row0)
    assert _rel(got.numpy(), ref.numpy()) <= JAX_TOL


def test_tiled_mirror_all_zero_input_gives_exact_zeros():
    R, hb = _stage(0)
    x = torch.zeros((900, 70), dtype=torch.int16)
    assert not fir_decimate_tiled_plain(x, hb, R, 100, -200).any()


@pytest.mark.parametrize("row0", [-301, 0, 45])
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_tiled_mirror_matches_pallas_interpret(int16, row0):
    R, hb = _stage(0)
    n_out = 70
    x = _window(900, 37, seed=3, int16=int16)
    got = fir_decimate_tiled_plain(torch.from_numpy(x), hb, R, n_out, row0)
    pal = fir_decimate_pallas(jnp.asarray(_shifted(x, row0)), hb.numpy(), R,
                              n_out=n_out, interpret=True)
    assert _rel(got.numpy(), np.asarray(pal)) <= JAX_TOL


@pytest.mark.parametrize("s", [1, 8, 3173])
def test_plain_first_row_is_the_shifted_stage(s):
    """row0 = -s is the stage on the window left-padded by s zero rows,
    and row0 = +s the stage on the window without its first s rows,
    bit for bit."""
    R, hb = _stage(0)
    x = _window(4000, 9, seed=s, int16=True)
    n_out = 300
    for row0 in (-s, s):
        got = fir_decimate_plain(torch.from_numpy(x), hb, R, n_out, row0)
        ref = fir_decimate_plain(
            torch.from_numpy(np.ascontiguousarray(_shifted(x, row0))), hb, R,
            n_out)
        assert torch.equal(got, ref)
    jx = jfir.shift_to_phase(jnp.asarray(x), 0, s)
    assert np.array_equal(np.asarray(jx), _shifted(x, -s))
