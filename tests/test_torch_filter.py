"""tpudas_torch's FFT engine against the JAX package's.

The same seeded numpy input goes through ``tpudas.ops.filter`` and
``tpudas_torch.ops.filter`` (``device="cpu"``).  Both sample the same
float32 Butterworth^2 response on the same 5-smooth ``nfft`` grid; the
two FFT libraries (pocketfft/ducc under JAX, PocketFFT/MKL under torch)
round differently, so filtered data is held within 1e-5 of each
channel's scale.  The host reference (scipy ``sosfiltfilt``) and the
FFT sizing are copies and must be bit-equal.  The edge probe is held to
the JAX package's value for the notebooks' arguments.
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.core.patch import Patch as JPatch
from tpudas.ops import fftlen as jfftlen
from tpudas.ops import filter as jfilter
from tpudas.proc import edge as jedge
from tpudas_torch.core.patch import Patch
from tpudas_torch.ops import fftlen, filter as tfilter
from tpudas_torch.proc import edge as tedge

REL_TOL = 1e-5


def _assert_close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    if ref.ndim == 1:
        got, ref = got[:, None], ref[:, None]
    scale = np.abs(ref).max(axis=0)
    err = np.abs(got - ref).max(axis=0)
    assert (err <= tol * np.maximum(scale, 1e-30)).all(), float(err.max())


def test_next_fft_len_equal_over_a_range():
    for n in list(range(0, 3000)) + [60001, 63174, 80001, 129024, 182952]:
        assert fftlen.next_tpu_fft_len(n) == jfftlen.next_tpu_fft_len(n)


@pytest.mark.parametrize("band", [(None, 4.5), (0.5, None), (0.5, 4.5)],
                         ids=["low", "high", "band"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_fft_pass_filter_matches_jax(band, ndim):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3001, 6)).astype(np.float32)
    x += np.sin(np.arange(3001) * 0.01)[:, None].astype(np.float32)
    if ndim == 1:
        x = x[:, 2].copy()
    low, high = band
    ref = np.asarray(jfilter.fft_pass_filter(x, 0.01, low=low, high=high,
                                             order=4))
    got = tfilter.fft_pass_filter(x, 0.01, low=low, high=high, order=4,
                                  device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _assert_close(got.numpy(), ref)


def test_lowpass_response_matches_jax():
    ref = np.asarray(jfilter.fft_lowpass_response(60750, 0.001, 0.45, 4))
    got = tfilter.fft_lowpass_response(60750, 0.001, 0.45, 4, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("band", [(None, 4.5), (0.5, None), (0.5, 4.5),
                                  (None, None)])
def test_host_sosfiltfilt_bit_equal(band):
    x = np.random.default_rng(8).standard_normal((2000, 3))
    ref = jfilter._host_sosfiltfilt(x, 0.01, band[0], band[1], 4)
    got = tfilter._host_sosfiltfilt(x, 0.01, band[0], band[1], 4)
    np.testing.assert_array_equal(got, ref)


def _patches(x, d=0.01):
    t = np.datetime64("2023-03-22T00:00:00", "ns") + (
        np.arange(x.shape[0]) * int(d * 1e9)).astype("timedelta64[ns]")
    kw = dict(coords={"time": t, "distance": np.arange(x.shape[1]) * 1.0},
              dims=("time", "distance"), attrs={"d_time": d})
    return Patch(data=x, **kw), JPatch(data=x, **kw)


@pytest.mark.parametrize("engine", [None, "host"])
def test_patch_pass_filter_matches_jax(engine):
    x = np.random.default_rng(9).standard_normal((1500, 4)).astype(np.float32)
    tp, jp = _patches(x)
    got = tp.pass_filter(time=(None, 4.0), engine=engine, device="cpu")
    ref = jp.pass_filter(time=(None, 4.0), engine=engine)
    assert isinstance(got.data, np.ndarray)
    np.testing.assert_array_equal(got.coords["time"], ref.coords["time"])
    if engine == "host":
        np.testing.assert_array_equal(got.host_data(), np.asarray(ref.data))
    else:
        _assert_close(got.host_data(), np.asarray(ref.data))
    with pytest.raises(ValueError, match="Nyquist"):
        tp.pass_filter(time=(None, 80.0), device="cpu")
    with pytest.raises(ValueError, match="exactly one dim"):
        tp.pass_filter(device="cpu")


@pytest.mark.parametrize("si,total,freq", [
    (0.001, 200.0, 1.0), (0.01, 180.0, 1.0), (0.01, 60.0, 5.0),
    (0.005, 120.0, 0.5),
])
def test_edge_effect_time_matches_jax(si, total, freq):
    """The notebooks' edge probe (get_edge_effect_time(dt, memory,
    freq=...)) through the port's own filter and gather-lerp."""
    ref = jedge.get_edge_effect_time(si, total, freq=freq)
    got = tedge.get_edge_effect_time(si, total, freq=freq, device="cpu")
    assert got == ref


def test_edge_probe_chunk_too_small_raises():
    with pytest.raises(ValueError, match="too close to half"):
        tedge.get_edge_effect_time(0.01, 10.0, freq=0.2, device="cpu")
