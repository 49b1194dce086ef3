"""tpudas_torch on the CUDA card: each kernel against its plain version,
the cascade, the FFT engine and LFProc on the card against the same
port on the CPU.

Every test here carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the JAX package, so it also runs on the card's host, where JAX is
not installed (the repo's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from tpudas_torch.io.spool import spool
from tpudas_torch.ops import fir
from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.testing import make_synthetic_spool

REL_TOL = 1e-5  # kernel vs plain: same f32 products, different order

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    err = (got - ref).abs().amax(dim=0)
    scale = ref.abs().amax(dim=0)
    return float((err / scale.clamp_min(float(scale.max()) * 1e-7)).max())


def _window(T, C, seed, int16=False):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 1000.0
    x = (np.sin(2 * np.pi * 0.05 * t)[:, None] * (1 + np.arange(C) / C)
         + 0.5 * np.sin(2 * np.pi * 25 * t)[:, None]
         + 0.02 * rng.standard_normal((T, C)))
    if int16:
        return np.round(x / 1e-4).astype(np.int16)
    return x.astype(np.float32)


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_kernel_matches_plain_at_every_flagship_stage(cuda_device, int16):
    plan = fir.design_cascade(1000.0, 1000, 0.45)
    for R, hb in fir.blocked_taps(plan, cuda_device):
        n_out = 517
        x = torch.from_numpy(
            _window((n_out + hb.shape[0]) * R - 5, 1000, seed=R, int16=int16)
        ).to(cuda_device)
        before = fir_decimate.launches
        got = fir_decimate(x, hb, R, n_out)
        assert fir_decimate.launches == before + 1
        ref = fir_decimate_plain(x, hb, R, n_out)
        assert _rel(got, ref) <= REL_TOL


def test_refused_launch_raises_without_fallback(cuda_device):
    # R = 64 with 256+ taps needs > 227 KB of shared memory: the launcher
    # refuses it and the wrapper raises instead of running the plain stage
    hb = torch.ones((8, 64), device=cuda_device)
    x = torch.ones((4096, 32), device=cuda_device)
    before = fir_decimate.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        fir_decimate(x, hb, 64, 10)
    assert fir_decimate.launches == before


def test_cascade_on_card_matches_cpu(cuda_device):
    plan = fir.design_cascade(1000.0, 1000, 0.45)
    x = _window(60001, 300, seed=9, int16=True)
    got = fir.cascade_decimate(x, plan, 10000, 40, qscale=1e-4,
                               device=cuda_device)
    ref = fir.cascade_decimate(x, plan, 10000, 40, qscale=1e-4, device="cpu")
    assert got.device.type == "cuda"
    assert _rel(got, ref) <= REL_TOL


def test_lfproc_on_card_matches_cpu(cuda_device, tmp_path):
    src = tmp_path / "src"
    make_synthetic_spool(
        src, n_files=3, file_duration=60.0, fs=1000.0, n_ch=40, noise=0.02,
        format="tdas", write_kwargs={"dtype": "int16", "scale": 1e-4},
    )
    outs = {}
    for name, dev in (("cuda", cuda_device), ("cpu", "cpu")):
        lfp = LFProc(spool(str(src)).sort("time").update(), device=dev)
        lfp.update_processing_parameter(
            output_sample_interval=1.0, process_patch_size=60,
            edge_buff_size=10,
        )
        lfp.set_output_folder(str(tmp_path / name), delete_existing=True)
        # outputs as tdas: the card's host may lack h5py
        lfp._write_output = lambda patch, path: patch.io.write(
            os.path.splitext(path)[0] + ".tdas", "tdas"
        )
        before = fir_decimate.launches
        lfp.process_time_range(np.datetime64("2023-03-22T00:00:00"),
                               np.datetime64("2023-03-22T00:03:00"))
        outs[name] = (lfp, fir_decimate.launches - before)
    lfp, launches = outs["cuda"]
    assert lfp.engine_counts == {"cascade-cuda": 4, "cascade-torch": 0,
                                 "fft": 0}
    assert launches == 4 * 4 and outs["cpu"][1] == 0
    assert sorted(os.listdir(tmp_path / "cuda")) == sorted(
        os.listdir(tmp_path / "cpu")
    )
    a = spool(str(tmp_path / "cuda")).update().chunk(time=None)[0]
    b = spool(str(tmp_path / "cpu")).update().chunk(time=None)[0]
    assert np.array_equal(a.coords["time"], b.coords["time"])
    assert _rel(torch.from_numpy(a.host_data()),
                torch.from_numpy(b.host_data())) <= REL_TOL


# -- the fused cascade kernel (B3) ------------------------------------------


def _stream_blocks(plan, n_list, C, seed, int16):
    """Consecutive blocks of one synthetic stream, on the card."""
    x = _window(sum(n_list) * plan.ratio, C, seed=seed, int16=int16)
    cuts = np.cumsum([0] + [n * plan.ratio for n in n_list])
    return [torch.from_numpy(np.ascontiguousarray(x[a:b])).cuda()
            for a, b in zip(cuts[:-1], cuts[1:])]


def _run_fused(step, plan, blocks, carry, qscale):
    sizes = fir.stream_carry_sizes(plan)
    ys = []
    for x in blocks:
        y, carry = step(x, carry, plan.stages, sizes, qscale=qscale)
        ys.append(y)
    return torch.cat(ys), carry


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_fused_kernel_matches_plain_on_flagship_blocks(cuda_device, int16):
    from tpudas_torch.ops.fused_kernel import fused_cascade, fused_cascade_plain

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    qs = 1e-4 if int16 else None
    # block sizes of the stream's power-of-two split, ragged width
    blocks = _stream_blocks(plan, [60, 8, 1, 1, 27, 3], 1000, 5, int16)
    carry = fir.cascade_stream_init(plan, 1000, cuda_device)
    before = fused_cascade.launches
    y, ck = _run_fused(fused_cascade, plan, blocks, carry, qs)
    assert fused_cascade.launches == before + len(blocks)
    ry, cp = _run_fused(fused_cascade_plain, plan, blocks, carry, qs)
    assert _rel(y, ry) <= REL_TOL
    for a, b in zip(ck, cp):
        assert _rel(a, b) <= REL_TOL


def test_fused_kernel_nan_set_within_plain(cuda_device):
    from tpudas_torch.ops.fused_kernel import fused_cascade, fused_cascade_plain

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    (x,) = _stream_blocks(plan, [40], 300, 6, False)
    x[plan.ratio : 2 * plan.ratio, 2] = float("nan")
    x[-plan.ratio // 2 :, 0] = float("nan")
    carry = fir.cascade_stream_init(plan, 300, cuda_device)
    y, _ = _run_fused(fused_cascade, plan, [x], carry, None)
    ry, _ = _run_fused(fused_cascade_plain, plan, [x], carry, None)
    nk, npl = torch.isnan(y), torch.isnan(ry)
    assert bool(npl.any()) and not bool((nk & ~npl).any())
    both = ~nk & ~npl
    err = (y[both] - ry[both]).abs().max() / ry[both].abs().max()
    assert float(err) <= REL_TOL


def test_fused_kernel_carry_round_trip(cuda_device, tmp_path):
    """A kernel carry saved to disk and loaded resumes on the kernel as
    if the stream had never stopped, and crosses to the per-stage
    chain."""
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.stream import StreamCarry, load_carry, save_carry

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    blocks = _stream_blocks(plan, [20, 13, 7], 500, 7, True)
    carry = fir.cascade_stream_init(plan, 500, cuda_device)
    y_all, _ = _run_fused(fused_cascade, plan, blocks, carry, 1e-4)
    y1, c1 = _run_fused(fused_cascade, plan, blocks[:1], carry, 1e-4)
    save_carry(StreamCarry(0, 10**9, 1.0, 10, 4, "fused", 60, bufs=c1),
               str(tmp_path))
    loaded = load_carry(str(tmp_path)).bufs  # numpy leaves, as on resume
    before = fused_cascade.launches
    y2, c2 = fir.cascade_decimate_stream(blocks[1], loaded, plan,
                                         "fused-cuda", qscale=1e-4)
    assert fused_cascade.launches == before + 1
    y3, _ = fir.cascade_decimate_stream(blocks[2], c2, plan, "auto",
                                        qscale=1e-4)
    assert _rel(torch.cat([y1, y2, y3]), y_all) <= REL_TOL


def test_fused_kernel_refuses_a_plan_it_cannot_hold(cuda_device):
    """Stage 0's taps beyond the kernel's staged rows: the wrapper
    raises instead of running another engine."""
    from tpudas_torch.ops.fused_kernel import fused_cascade

    h = np.full(300, 1.0 / 300, np.float32)
    stages, sizes = [(2, h)], (298,)
    x = torch.zeros((20, 64), device=cuda_device)
    carry = (torch.zeros((298, 64), device=cuda_device),)
    before = fused_cascade.launches
    with pytest.raises(ValueError, match="does not fit"):
        fused_cascade(x, carry, stages, sizes)
    assert fused_cascade.launches == before


# -- the HBM read probes (P1-P3) ----------------------------------------------


@pytest.mark.parametrize("rows,cb,k_fastest", [
    (256, 64, False), (256, 64, True), (512, 256, False), (1024, 128, True),
    (64, 2048, False),
])
def test_copy_heads_kernel_bit_equal_to_plain(cuda_device, rows, cb, k_fastest):
    from tpudas_torch.ops.hbm_probe import copy_heads, copy_heads_plain

    g = torch.Generator(device=cuda_device).manual_seed(rows + cb)
    x = torch.randn((4096 + 3 * rows // 2, 2048), generator=g,
                    device=cuda_device)
    before = copy_heads.launches
    got = copy_heads(x, rows, cb, k_fastest)
    torch.cuda.synchronize()
    assert copy_heads.launches == before + 1
    assert torch.equal(got, copy_heads_plain(x, rows, cb, k_fastest))


@pytest.mark.parametrize("P,rows,cb", [
    (1, 512, 64), (2, 512, 64), (3, 512, 64), (4, 256, 128), (8, 128, 256),
])
def test_copy_heads_pstream_kernel_bit_equal_to_plain(cuda_device, P, rows, cb):
    from tpudas_torch.ops.hbm_probe import (
        copy_heads_pstream,
        copy_heads_pstream_plain,
    )

    g = torch.Generator(device=cuda_device).manual_seed(P)
    x = torch.randn((4096, 256), generator=g, device=cuda_device)
    before = copy_heads_pstream.launches
    got = copy_heads_pstream(x, P, rows, cb)
    torch.cuda.synchronize()
    assert copy_heads_pstream.launches == before + 1
    assert torch.equal(got, copy_heads_pstream_plain(x, P, rows, cb))


@pytest.mark.parametrize("rows,nbuf", [(256, 4), (128, 8), (512, 2), (7, 3)])
def test_ring_reader_kernel_matches_plain(cuda_device, rows, nbuf):
    from tpudas_torch.ops.hbm_probe import ring_reader, ring_reader_plain

    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((40960, 256), generator=g, device=cuda_device)
    before = ring_reader.launches
    got = ring_reader(x, rows, nbuf)
    torch.cuda.synchronize()
    assert ring_reader.launches == before + 1
    n = x.shape[0] // rows
    terms = float(x[0 : n * rows : rows].abs().sum(dtype=torch.float64))
    assert abs(float(got) - float(ring_reader_plain(x, rows, nbuf))) <= (
        1e-6 * terms
    )


def test_probe_kernel_refuses_misaligned_geometry(cuda_device):
    from tpudas_torch.ops.hbm_probe import copy_heads

    x = torch.zeros((1024, 258), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        copy_heads(x, 256, 6)


# -- the FFT engine --------------------------------------------------------------


def test_fft_engine_on_card_matches_cpu(cuda_device):
    from tpudas_torch.ops.resample import interp_indices_weights
    from tpudas_torch.proc.lfproc import lowpass_resample

    x = _window(60001, 300, seed=21, int16=True)
    t = np.datetime64("2023-03-22T00:00:00", "ns") + np.arange(60001).astype(
        "timedelta64[ms]")
    idx, w = interp_indices_weights(t, t[5000:55000:1100])
    got = lowpass_resample(x, 1e-3, 0.409, idx, w, qscale=1e-4,
                           device=cuda_device)
    ref = lowpass_resample(x, 1e-3, 0.409, idx, w, qscale=1e-4, device="cpu")
    assert got.device.type == "cuda"
    assert _rel(got, ref) <= REL_TOL
