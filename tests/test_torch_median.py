"""The port's median despike (tpudas_torch.ops.median) against the JAX
package's and scipy's.

Odd sizes only, so the median is an element of each window: the port
(``device="cpu"``) must be bit-equal to ``tpudas.ops.median`` and to
``scipy.ndimage.median_filter`` (reflect boundary), NaN included (a NaN
in a window gives NaN, as ``jnp.median`` does), and slicing the stack
over channels must not change a value.
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter as scipy_median

from tpudas.ops.median import median_filter as jax_median
from tpudas.testing import synthetic_patch as jax_patch
from tpudas_torch.ops.median import median_filter
from tpudas_torch.testing import synthetic_patch


def _data(dtype, nan=False, shape=(64, 13), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype == "int16":
        return np.round(1000 * x).astype(np.int16)
    x = x.astype(np.float32)
    if nan:
        x[10, 3] = np.nan
        x[40:42, 7] = np.nan
    return x


CASES = {
    "9x1": dict(size=(9, 1)),
    "5": dict(size=5),
    "3x1": dict(size=(3, 1)),
    "time-only-axes": dict(size=9, axes=(0,)),
    "channel-only-axes": dict(size=3, axes=(1,)),
}


@pytest.mark.parametrize("dtype", ["float32", "int16", "float32-nan"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_equal_to_jax(case, dtype):
    x = _data(dtype.split("-")[0], nan=dtype.endswith("nan"))
    got = median_filter(x, device="cpu", **CASES[case])
    want = np.asarray(jax_median(x, **CASES[case]))
    assert got.dtype == want.dtype == x.dtype
    assert np.array_equal(got, want, equal_nan=True)
    if dtype.endswith("nan"):
        assert np.isnan(got).sum() > np.isnan(x).sum()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("size", [(9, 1), 5, (3, 1), (1, 5)])
def test_bit_equal_to_scipy(size, dtype):
    x = _data(dtype)
    assert np.array_equal(median_filter(x, size, device="cpu"),
                          scipy_median(x, size=size))


@pytest.mark.parametrize("size", [(9, 1), 5, (1, 3)])
def test_channel_slices_change_no_value(size, monkeypatch):
    from tpudas_torch.ops import median as median_mod

    x = _data("float32", nan=True, shape=(50, 29))
    whole = median_filter(x, size, device="cpu")
    # a 4-byte budget: one channel per slice
    monkeypatch.setattr(median_mod, "_MAX_STACK_BYTES", 4)
    assert median_filter(x, size, device="cpu").tobytes() == whole.tobytes()
    monkeypatch.setattr(median_mod, "_MAX_STACK_BYTES", 400 * 50 * 9)
    tensor = median_filter(torch.from_numpy(x), size)
    assert isinstance(tensor, torch.Tensor)
    assert tensor.numpy().tobytes() == whole.tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(dim="time")], ids=["2d", "time"])
def test_patch_median_filter_matches_jax(kw):
    args = dict(t0=np.datetime64("2023-03-22T00:00:00", "ns"), duration=4.0,
                fs=25.0, n_ch=11, seed=3, noise=0.5)
    p_port, p_jax = synthetic_patch(**args), jax_patch(**args)
    assert np.array_equal(p_port.host_data(), np.asarray(p_jax.data))
    size = 9 if kw else 5
    got = p_port.median_filter(size=size, device="cpu", **kw)
    want = p_jax.median_filter(size=size, **kw)
    assert np.array_equal(got.host_data(), np.asarray(want.data))
    assert np.array_equal(got.coords["time"], p_port.coords["time"])
    host = p_port.median_filter(size=size, engine="scipy", **kw)
    assert np.array_equal(host.host_data(), got.host_data())


def test_even_size_and_bad_tuple_raise():
    x = _data("float32")
    with pytest.raises(ValueError, match="odd"):
        median_filter(x, 4, device="cpu")
    with pytest.raises(ValueError, match="one entry per filtered axis"):
        median_filter(x, (3, 3, 3), device="cpu")


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        median_filter(_data("float32"), 5)
    p = synthetic_patch(t0=np.datetime64("2023-03-22T00:00:00", "ns"),
                        duration=1.0, fs=25.0, n_ch=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.median_filter(size=5)
