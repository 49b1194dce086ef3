"""The yardstick's frozen copies held to the port's own functions at
small sizes: the cascade design, the composite filter and the stream's
lag, the cost counts, the window schedule and time grid, the FFT length
and response, the tdas format and the synthetic signal."""

import os

import numpy as np
import pytest
import torch

from portbench.yardstick import cost, datagen, plan, tdasfmt

DESIGNS = [(1000.0, 1000, 1.0), (100.0, 100, 1.0), (200.0, 40, 0.2),
           (1000.0, 500, 0.5)]


def _port_plan(fs, ratio, dt):
    from tpudas_torch.ops.fir import design_cascade
    from tpudas_torch.proc.lfproc import output_corner

    return design_cascade(fs, ratio, output_corner(dt), 4)


@pytest.mark.parametrize("fs,ratio,dt", DESIGNS)
def test_cascade_taps_equal_the_port(fs, ratio, dt):
    port = _port_plan(fs, ratio, dt)
    mine = plan.cascade(fs, ratio, plan.corner_hz(dt), 4)
    assert [R for R, _ in mine] == [R for R, _ in port.stages]
    for (_, h), (_, hp) in zip(mine, port.stages):
        assert h.dtype == np.float32
        np.testing.assert_array_equal(h, hp)
    assert plan.delay(mine) == port.delay


@pytest.mark.parametrize("fs,ratio,dt", DESIGNS)
def test_composite_filter_and_stream_lag(fs, ratio, dt):
    from tpudas_torch.ops.fir import (
        impulse_response,
        stream_carry_sizes,
        stream_warmup_outputs,
    )

    port = _port_plan(fs, ratio, dt)
    stages = plan.cascade(fs, ratio, plan.corner_hz(dt), 4)
    np.testing.assert_allclose(plan.composite(stages),
                               impulse_response(port), rtol=0, atol=1e-15)
    assert plan.stream_lag_outputs(stages) == stream_warmup_outputs(port)
    assert cost.carry_sizes(stages) == stream_carry_sizes(port)


@pytest.mark.parametrize("T,C,in_bytes", [(60000, 10000, 2), (1000, 16, 4),
                                          (8191, 3, 2)])
def test_cost_counts_equal_the_port(T, C, in_bytes):
    from tpudas_torch.ops.filter import fft_step_cost
    from tpudas_torch.ops.fir import stages_step_cost, stream_step_cost

    port = _port_plan(1000.0, 1000, 1.0)
    stages = plan.cascade(1000.0, 1000, plan.corner_hz(1.0), 4)
    sizes = (5, 0, 7, 1)
    assert (cost.stages_step_cost(stages, sizes, T, C, in_bytes)
            == stages_step_cost(port.stages, sizes, T, C, in_bytes))
    assert (cost.stream_step_cost(stages, T, C, in_bytes)
            == stream_step_cost(port, T, C, in_bytes))
    rows = 2 * 10000
    assert (cost.fft_step_cost(plan.next_5smooth(T + rows), T, rows, C,
                               in_bytes)
            == fft_step_cost(T, rows, C, in_bytes))


def test_fft_window_cost_reads_and_writes_once():
    c = cost.fft_window_cost(60750, 60001, 40, 10000, 2)
    assert c["bytes"] == 60001 * 10000 * 2 + 40 * 10000 * 4
    assert c["flops"] == pytest.approx(10000 * 5 * 60750 * np.log2(60750))
    assert cost.bound_s(c) == max(c["bytes"] / 3.35e12, c["flops"] / 67e12)


@pytest.mark.parametrize("n_grid,patch,buff", [(120, 60, 10), (181, 60, 10),
                                               (61, 60, 10), (1, 60, 10),
                                               (1000, 100, 7)])
def test_schedule_equals_the_port(n_grid, patch, buff):
    from tpudas_torch.proc.lfproc import schedule_windows

    assert plan.schedule_windows(n_grid, patch, buff) == schedule_windows(
        n_grid, patch, buff)


def test_grid_and_fft_length_equal_the_port():
    from tpudas_torch.core.timeutils import build_time_grid
    from tpudas_torch.ops.fftlen import next_tpu_fft_len

    bg = np.datetime64("2023-03-22T00:00:00", "ns")
    ed = bg + np.timedelta64(120, "s")
    for dt in (1.0, 0.25, 0.0333):
        want = build_time_grid(bg, ed, dt).astype(np.int64)
        got = plan.time_grid(int(bg.astype(np.int64)),
                             int(ed.astype(np.int64)), dt)
        np.testing.assert_array_equal(got, want)
    for n in (1, 2, 7, 49, 60001, 39001, 120001):
        assert plan.next_5smooth(n) == next_tpu_fft_len(n)


def test_fft_response_equals_the_port():
    from tpudas_torch.ops.filter import fft_lowpass_response

    nfft, d_sec = 60750, 1e-3
    port = fft_lowpass_response(nfft, d_sec, 0.45, 4, device="cpu").numpy()
    f = np.arange(nfft // 2 + 1) / (nfft * d_sec)
    np.testing.assert_allclose(plan.butter2(f, 0.45, 4), port, rtol=2e-6,
                               atol=1e-7)
    hc = plan.fft_kernel(nfft, d_sec, 0.45, 4)
    np.testing.assert_allclose(np.fft.rfft(hc).real, plan.butter2(f, 0.45, 4),
                               atol=1e-12)


def test_tdas_format_equals_the_port(tmp_path, monkeypatch):
    from tpudas_torch.core.patch import Patch
    from tpudas_torch.io.tdas import read_tdas, write_tdas

    monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
    rng = np.random.default_rng(3)
    t0 = np.datetime64("2023-03-22T00:00:00", "ns")
    q = rng.integers(-30000, 30000, size=(50, 7)).astype(np.int16)
    mine = tdasfmt.write(tmp_path / "mine.tdas", q, int(t0.astype(np.int64)),
                         1_000_000, scale=1e-4, d0=0.0, dx=5.0)
    theirs = read_tdas(mine)[0]
    np.testing.assert_array_equal(
        theirs.host_data(), q.astype(np.float32) * np.float32(1e-4))
    y = rng.standard_normal((3, 7)).astype(np.float32)
    patch = Patch(data=y,
                  coords={"time": t0 + np.arange(3) * np.timedelta64(1, "s"),
                          "distance": np.arange(7) * 5.0},
                  dims=("time", "distance"))
    path = write_tdas(patch, str(tmp_path / "port.tdas"))
    hdr, back = tdasfmt.read(path)
    np.testing.assert_array_equal(back, y.astype(np.float64))
    np.testing.assert_array_equal(
        tdasfmt.times_ns(hdr),
        (t0 + np.arange(3) * np.timedelta64(1, "s")).astype(np.int64))
    with open(mine, "rb") as fh:
        head = fh.read(64)
    assert head == tdasfmt.pack_header(int(t0.astype(np.int64)), 1_000_000,
                                       50, 7, 1, 1e-4, 0.0, 5.0)


def test_signal_equals_the_ports_synthetic_stream():
    from tpudas_torch.testing import synthetic_patch

    cfg = {"n_ch": 12, "fs_hz": 200.0, "d_ch_m": 5.0}
    params = {"lf_freq": 0.05, "hf_freq": 25.0, "hf_amp": 0.5, "noise": 0.0,
              "scale": float(np.float32(1e-4)), "lf_phase": 0.0,
              "hf_phase": 0.0}
    got = datagen.make_block(cfg, params, 0, 400, None,
                             torch.device("cpu")).numpy()
    want = synthetic_patch(duration=2.0, fs=200.0, n_ch=12).host_data()
    want_q = np.clip(np.round(want / params["scale"]), -32768, 32767)
    assert np.abs(got.astype(np.int64) - want_q).max() <= 1


def test_pool_is_a_function_of_the_seed(tmp_path):
    cfg = {"n_ch": 8, "fs_hz": 100.0, "d_ch_m": 5.0, "file_seconds": 3.0,
           "pool_files": 2, "int16_scale": 1e-4,
           "signal": {"lf_freq_hz": 0.05, "hf_freq_hz": 25.0, "hf_amp": 0.5,
                      "noise": 0.02}}
    dev = torch.device("cpu")
    a = datagen.make_pool(cfg, 2**31 + 5, tmp_path / "a", dev)
    b = datagen.pool_samples(cfg, 2**31 + 5, dev)
    c = datagen.pool_samples(cfg, 2**31 + 6, dev)
    np.testing.assert_array_equal(datagen.read_pool(a), b)
    assert b.shape == c.shape == (600, 8)
    assert (b != c).any()
    assert sorted(os.listdir(tmp_path / "a")) == ["raw_0000.tdas",
                                                  "raw_0001.tdas"]


def test_fft_stream_schedule_equals_the_port():
    """The FFT stream reference's quantum and block split are the
    stream's own (``tpudas_torch.proc.stream``)."""
    from tpudas_torch.proc import stream

    from portbench.yardstick import reference

    fft = reference.load_engine_reference("fft")
    assert fft.QUANTUM == stream._FFT_QUANTUM
    for n_units, cap in [(0, 468), (468, 468), (469, 468), (1000, 7),
                         (5, 1), (937, 468)]:
        assert fft._pow2_blocks(n_units, cap) == stream._pow2_blocks(
            n_units, cap)
