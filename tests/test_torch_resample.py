"""tpudas_torch's resampling against the JAX package's.

``interp_indices_weights`` is host numpy copied from the JAX package and
must be bit-equal.  ``gather_lerp`` and ``patch_interpolate`` compute the
same float32 lerp ``lo + (hi - lo) * w``, but XLA contracts its
multiply-add into one FMA while torch rounds the product first: they
differ by at most one rounding of the product, so they are held within
1e-6 of each channel's scale (measured: 1.7e-5 relative on single small
samples, ~1e-7 of the channel's scale).  The host engine is bit-equal.
``lowpass_resample`` (FFT filter + lerp) is held within 1e-5 of each
channel's scale (two FFT libraries).
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.core.patch import Patch as JPatch
from tpudas.ops import resample as jres
from tpudas.proc.lfproc import lowpass_resample as jlowpass_resample
from tpudas_torch.core.patch import Patch
from tpudas_torch.ops import resample as tres
from tpudas_torch.proc.lfproc import lowpass_resample

T0 = np.datetime64("2023-03-22T00:00:00", "ns")


def _assert_lerp_close(got, ref):
    got = got.reshape(got.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(got - ref).max(axis=0) <= 1e-6 * scale).all()


def _axis(n, step_ns, start=T0):
    return start + (np.arange(n) * step_ns).astype("timedelta64[ns]")


@pytest.mark.parametrize("src,dst", [
    (_axis(1000, 5_000_000), _axis(400, 12_000_000)),
    (_axis(1000, 5_000_000), _axis(50, 110_000_000, T0 - np.timedelta64(1, "s"))),
    (np.arange(100) * 0.5, np.linspace(-3, 60, 77)),
], ids=["datetime", "clamped", "numeric"])
def test_interp_indices_weights_bit_equal(src, dst):
    idx, w = tres.interp_indices_weights(src, dst)
    ji, jw = jres.interp_indices_weights(src, dst)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(w, jw)


def test_interp_rejects_bad_axes():
    with pytest.raises(ValueError, match="at least 2"):
        tres.interp_indices_weights(np.array([1.0]), np.array([1.0]))
    with pytest.raises(ValueError, match="strictly increasing"):
        tres.interp_indices_weights(np.array([1.0, 1.0, 2.0]), np.array([1.0]))


@pytest.mark.parametrize("shape", [(300,), (300, 5)])
def test_gather_lerp_matches_jax(shape):
    rng = np.random.default_rng(11)
    data = rng.standard_normal(shape).astype(np.float32)
    idx, w = tres.interp_indices_weights(np.arange(300.0),
                                         np.linspace(0, 299, 91))
    ref = np.asarray(jres.gather_lerp(data, idx, w))
    got = tres.gather_lerp(torch.from_numpy(data), idx, w).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    _assert_lerp_close(got, ref)


@pytest.mark.parametrize("engine", [None, "host"])
def test_patch_interpolate_matches_jax(engine):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1000, 4)).astype(np.float32)
    kw = dict(coords={"time": _axis(1000, 5_000_000),
                      "distance": np.arange(4) * 2.0},
              dims=("time", "distance"), attrs={"d_time": 0.005})
    new = _axis(300, 16_000_000)
    got = Patch(data=x, **kw).interpolate(time=new, engine=engine,
                                          device="cpu")
    ref = JPatch(data=x, **kw).interpolate(time=new, engine=engine)
    np.testing.assert_array_equal(got.coords["time"], ref.coords["time"])
    if engine == "host":
        np.testing.assert_array_equal(got.host_data(), np.asarray(ref.data))
    else:
        _assert_lerp_close(got.host_data(), np.asarray(ref.data))
    assert got.attrs["time_step"] == ref.attrs["time_step"]


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_lowpass_resample_matches_jax(int16):
    rng = np.random.default_rng(13)
    t = np.arange(6001) * 0.005
    x = (np.sin(2 * np.pi * 0.2 * t)[:, None] * (1 + np.arange(5))
         + 0.3 * rng.standard_normal((6001, 5)))
    src = _axis(6001, 5_000_000)
    idx, w = tres.interp_indices_weights(src, _axis(2400, 12_500_000))
    qs = None
    if int16:
        x, qs = np.round(x / 1e-4).astype(np.int16), 1e-4
    else:
        x = x.astype(np.float32)
    ref = np.asarray(jlowpass_resample(x, 0.005, 36.0, idx, w, order=4,
                                       qscale=qs))
    got = lowpass_resample(x, 0.005, 36.0, idx, w, order=4, qscale=qs,
                           device="cpu").numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(got - ref).max(axis=0) <= 1e-5 * scale).all()
