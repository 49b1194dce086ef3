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


@pytest.mark.parametrize("row0", [-3173, -5, 0, 777])
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_kernel_first_row_matches_plain(cuda_device, int16, row0):
    """A first row before the window (more than one time tile of
    outputs before it), at it and inside it: rows below 0 read as
    zero."""
    plan = fir.design_cascade(1000.0, 1000, 0.45)
    R, hb = fir.blocked_taps(plan, cuda_device)[0]
    x = torch.from_numpy(_window(20000, 1000, seed=5, int16=int16)).to(
        cuda_device)
    got = fir_decimate(x, hb, R, 2400, row0)
    assert _rel(got, fir_decimate_plain(x, hb, R, 2400, row0)) <= REL_TOL


# (C, dtype, elements the window starts past an aligned address, the
# copy width the wrapper must pick)
WIDTH_CASES = [
    (2048, torch.int16, 0, 16), (1000, torch.int16, 0, 16),
    (1002, torch.float32, 0, 8), (1004, torch.int16, 0, 8),
    (333, torch.float32, 0, 4), (778, torch.int16, 0, 4),
    (777, torch.int16, 0, 2), (2048, torch.int16, 1, 2),
]


def _at_offset(x, offset):
    """``x`` copied into storage that starts ``offset`` elements past an
    aligned address (a window whose address only the element size
    divides)."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("C,dtype,offset,width", WIDTH_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_kernel_matches_plain_at_every_copy_width(cuda_device, C, dtype,
                                                  offset, width):
    from tpudas_torch.ops.fir_kernel import copy_width

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    R, hb = fir.blocked_taps(plan, cuda_device)[0]
    x = torch.from_numpy(_window(6000, C, seed=C, int16=dtype == torch.int16))
    x = _at_offset(x.to(cuda_device), offset)
    assert copy_width(x) == width
    before = dict(fir_decimate.launches_by_width)
    got = fir_decimate(x, hb, R, 700, -3173)
    assert fir_decimate.launches_by_width[width] == before[width] + 1
    assert _rel(got, fir_decimate_plain(x, hb, R, 700, -3173)) <= REL_TOL


def test_kernel_long_taps_match_plain(cuda_device):
    """4,095 taps (R = 5): several tap-frame chunks a tile."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    hb = torch.randn(819, 5, device=cuda_device, generator=g) / 819.0
    x = torch.from_numpy(_window((300 + 819) * 5, 333, seed=12)).to(
        cuda_device)
    got = fir_decimate(x, hb, 5, 300, -40)
    assert _rel(got, fir_decimate_plain(x, hb, 5, 300, -40)) <= REL_TOL


def test_kernel_matches_the_tiled_mirror(cuda_device):
    """The kernel and its CPU mirror sum the same products in the same
    order (the mirror's fused multiply-add rounds through float64)."""
    from tpudas_torch.ops.fir_kernel import fir_decimate_tiled_plain

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    for R, hb in fir.blocked_taps(plan, cuda_device):
        x = torch.from_numpy(_window(3000, 333, seed=R, int16=R == 8))
        n_out = 3000 // R - hb.shape[0] + 9
        got = fir_decimate(x.to(cuda_device), hb, R, n_out, -301)
        ref = fir_decimate_tiled_plain(x, hb.cpu(), R, n_out, -301)
        assert _rel(got, ref) <= 1e-6


def test_kernel_never_runs_the_plain_stage(cuda_device, monkeypatch):
    from tpudas_torch.ops import fir_kernel

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain stage")

    monkeypatch.setattr(fir_kernel, "fir_decimate_plain", refuse)
    plan = fir.design_cascade(1000.0, 1000, 0.45)
    x = _window(60001, 64, seed=3, int16=True)
    got = fir.cascade_decimate(x, plan, 10000, 40, qscale=1e-4,
                               device=cuda_device)
    assert got.shape == (40, 64) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("C,dtype,offset,width", WIDTH_CASES[::2],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_refused_launch_raises_without_fallback(cuda_device, C, dtype, offset,
                                                width):
    # R = 64: one time tile of 32 outputs stages 2,048 rows, a 2-slot
    # ring 512 KB of shared memory, over the 227 KB a block may have:
    # the launcher refuses at every copy width and the wrapper raises
    # instead of running the plain stage
    hb = torch.ones((8, 64), device=cuda_device)
    x = _at_offset(torch.ones((4096, C), dtype=dtype, device=cuda_device),
                   offset)
    before = fir_decimate.launches, dict(fir_decimate.launches_by_width)
    with pytest.raises(RuntimeError, match="cudaError"):
        fir_decimate(x, hb, 64, 10)
    assert (fir_decimate.launches, fir_decimate.launches_by_width) == before


def test_failed_build_raises(cuda_device, monkeypatch, tmp_path):
    """A kernel library that does not build raises from the wrapper; no
    other engine runs."""
    from tpudas_torch.ops import _build, fir_kernel

    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(fir_kernel, "_lib", None)
    x = torch.ones((4096, 64), device=cuda_device)
    hb = torch.ones((6, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fir_decimate(x, hb, 8, 10)


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


@pytest.mark.parametrize("engine", ["auto", "fft"])
def test_lfproc_staged_byte_identical_to_serial_on_card(cuda_device, tmp_path,
                                                         monkeypatch, engine):
    """The prefetch thread's pinned buffers and side-stream H2D give the
    bytes of the serial path with the numpy reader; ten windows, so each
    pinned buffer is refilled four times."""
    src = tmp_path / "src"
    make_synthetic_spool(
        src, n_files=4, file_duration=30.0, fs=1000.0, n_ch=300, noise=0.02,
        format="tdas", write_kwargs={"dtype": "int16", "scale": 1e-4},
    )
    runs = {}
    for name in ("staged", "serial"):
        if name == "serial":
            monkeypatch.setenv("TPUDAS_H2D_STAGE", "0")
            monkeypatch.setenv("TPUDAS_NO_NATIVE", "1")
        lfp = LFProc(spool(str(src)).sort("time").update(), device=cuda_device)
        lfp.update_processing_parameter(
            output_sample_interval=1.0, process_patch_size=30,
            edge_buff_size=10, engine=engine,
        )
        lfp.set_output_folder(str(tmp_path / name), delete_existing=True)
        lfp._write_output = lambda patch, path: patch.io.write(
            os.path.splitext(path)[0] + ".tdas", "tdas"
        )
        lfp.process_time_range(np.datetime64("2023-03-22T00:00:00"),
                               np.datetime64("2023-03-22T00:02:00"))
        runs[name] = lfp
    windows = sum(runs["staged"].engine_counts.values())
    assert windows == 10
    assert runs["staged"].staged_windows == runs["staged"].native_windows == 10
    assert runs["serial"].staged_windows == runs["serial"].native_windows == 0
    names = sorted(os.listdir(tmp_path / "staged"))
    assert names == sorted(os.listdir(tmp_path / "serial"))
    for n in names:
        assert ((tmp_path / "staged" / n).read_bytes()
                == (tmp_path / "serial" / n).read_bytes()), n


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


@pytest.mark.parametrize("ratio", [1000, 40, 7])
def test_fused_split_kernels_match_mirror_and_plain(cuda_device, ratio):
    """Kernel A (+ kernel B for more than two stages) against the plain
    mirror of the split and the plain step on the card, over the
    flagship's 60/8/1-output blocks (a two- and a one-stage plan too);
    every step launches A, and B when the plan has more than two
    stages."""
    from tpudas_torch.ops.fused_kernel import (
        fused_cascade,
        fused_cascade_plain,
        fused_cascade_split_plain,
        fused_stage01,
        stage01_plain,
    )

    plan = fir.design_cascade(1000.0, ratio, 450.0 / ratio)
    blocks = _stream_blocks(plan, [60, 8, 1], 1000, 8, True)
    carry = fir.cascade_stream_init(plan, 1000, cuda_device)
    steps, kernels = fused_cascade.launches, fused_cascade.kernel_launches
    y, ck = _run_fused(fused_cascade, plan, blocks, carry, 1e-4)
    per_step = 2 if len(plan.stages) > 2 else 1
    assert fused_cascade.launches == steps + len(blocks)
    assert fused_cascade.kernel_launches == kernels + per_step * len(blocks)
    for ref in (fused_cascade_split_plain, fused_cascade_plain):
        ry, cp = _run_fused(ref, plan, blocks, carry, 1e-4)
        assert _rel(y, ry) <= REL_TOL
        for a, b in zip(ck, cp):
            assert _rel(a, b) <= REL_TOL
    sizes = fir.stream_carry_sizes(plan)
    args = (blocks[0], carry[:2], plan.stages[:2], sizes[:2], 1e-4)
    u, n = fused_stage01(*args)
    ru, rn = stage01_plain(*args)
    assert _rel(u, ru) <= REL_TOL
    for a, b in zip(n, rn):
        assert _rel(a, b) <= REL_TOL


def test_fused_kernel_refuses_a_plan_it_cannot_hold(cuda_device):
    """Stage 0's taps beyond the kernel's staged rows: the wrapper
    raises instead of running another engine."""
    from tpudas_torch.ops.fused_kernel import fused_cascade

    h = np.full(300, 1.0 / 300, np.float32)
    stages, sizes = [(2, h)], (298,)
    x = torch.zeros((20, 64), device=cuda_device)
    carry = (torch.zeros((298, 64), device=cuda_device),)
    before = fused_cascade.launches, fused_cascade.kernel_launches
    with pytest.raises(ValueError, match="does not fit"):
        fused_cascade(x, carry, stages, sizes)
    assert (fused_cascade.launches, fused_cascade.kernel_launches) == before
    # kernel B's stages refused: neither kernel launches
    h2 = np.full(4000, 1.0 / 4000, np.float32)
    stages = [(2, np.ones(3, np.float32) / 3), (2, np.ones(3, np.float32) / 3),
              (2, h2)]
    sizes = (1, 1, 3998)
    x = torch.zeros((40, 64), device=cuda_device)
    carry = tuple(torch.zeros((p, 64), device=cuda_device) for p in sizes)
    with pytest.raises(ValueError, match="does not fit"):
        fused_cascade(x, carry, stages, sizes)
    assert (fused_cascade.launches, fused_cascade.kernel_launches) == before


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


# ---------------------------------------------------------------------------
# the batched fleet's stacked steps: B1 and B3 on the channel-packed block

# ragged widths: the members sit at odd int16 offsets of the packed block,
# where B1 stages with another copy width than solo
STACK_WIDTHS = (1001, 777, 3, 64, 1499)


@pytest.mark.parametrize("engine", ["cuda", "fused-cuda"])
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_stacked_step_equals_solo_on_card(cuda_device, engine, int16):
    """The stacked step launches the member's own engine once on the
    packed block; every member's output and carry leaves equal its solo
    step's, byte for byte, over blocks of 8, 1 and 3 outputs."""
    from tpudas_torch.ops.fused_kernel import fused_cascade

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    qs = 1e-4 if int16 else None
    carries = [fir.cascade_stream_init(plan, w, cuda_device)
               for w in STACK_WIDTHS]
    solo = list(carries)
    b1, b3 = fir_decimate.launches, fused_cascade.launches
    fir.cascade_decimate_stream_stacked.launches.clear()
    n_out = (8, 1, 3)
    for rnd, n in enumerate(n_out):
        blocks = [torch.from_numpy(_window(n * 1000, w, 60 + 7 * rnd + i,
                                           int16)).to(cuda_device)
                  for i, w in enumerate(STACK_WIDTHS)]
        res = fir.cascade_decimate_stream_stacked(blocks, carries, plan,
                                                  engine, qscale=qs)
        carries = [c for _y, c in res]
        for i, b in enumerate(blocks):
            y, solo[i] = fir.cascade_decimate_stream(b, solo[i], plan, engine,
                                                     qscale=qs)
            assert torch.equal(res[i][0], y), (engine, STACK_WIDTHS[i], n)
            for u, v in zip(carries[i], solo[i]):
                assert torch.equal(u, v), (engine, STACK_WIDTHS[i], n)
    steps = len(n_out) * (1 + len(STACK_WIDTHS))
    if engine == "cuda":
        assert fir_decimate.launches - b1 == 4 * steps
    else:
        assert fused_cascade.launches - b3 == steps
    assert fir.cascade_decimate_stream_stacked.launches == {
        (engine, sum(STACK_WIDTHS)): len(n_out)}


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_fft_stacked_step_equals_solo_on_card(cuda_device, int16):
    """The stacked FFT step (each member's step at its own width)
    equals each member's solo step on the card, over three carried
    blocks."""
    from tpudas_torch.ops.filter import (
        fft_pass_filter_stream,
        fft_pass_filter_stream_stacked,
        fft_stream_init,
    )

    qs = 1e-4 if int16 else None
    widths = STACK_WIDTHS + (1,)
    carries = [fft_stream_init(512, w) for w in widths]
    solo = list(carries)
    for rnd in range(3):
        blocks = [torch.from_numpy(_window(4096, w, 80 + 7 * rnd + i,
                                           int16)).to(cuda_device)
                  for i, w in enumerate(widths)]
        res = fft_pass_filter_stream_stacked(blocks, carries, 1e-3,
                                             high=0.45, qscale=qs)
        carries = [c for _y, c in res]
        for i, b in enumerate(blocks):
            y, solo[i] = fft_pass_filter_stream(b, solo[i], 1e-3, high=0.45,
                                                qscale=qs)
            assert y.device.type == "cuda"
            assert torch.equal(res[i][0], y), widths[i]
            assert torch.equal(carries[i], solo[i]), widths[i]


def _detect_rows(T=300, C=257, seed=5):
    rng = np.random.default_rng(seed)
    rows = (0.1 * rng.standard_normal((T, C))).astype(np.float32)
    rows[150:180, 3] += 5.0
    rows[60:70] = np.nan
    return rows, np.arange(T, dtype=np.int64) * 1_000_000_000


@pytest.mark.parametrize("cuts", [[], [100, 101, 257]], ids=["whole", "cut"])
def test_detect_operators_on_card_match_cpu(cuda_device, cuts):
    """STA/LTA on the card is byte-equal to the CPU (elementwise float32
    ops, each rounded on its own on both); the RMS track within 1e-6 of
    the largest |value|; the events equal."""
    from tpudas_torch.detect.operators import make_operator

    rows, t_ns = _detect_rows()
    specs = [("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
             ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5,
                      "baseline": 20.0})]
    for spec in specs:
        got = {}
        for dev in ("cpu", "cuda"):
            op = make_operator(spec, device=dev)
            st = op.init_state(rows.shape[1], 1_000_000_000)
            evs, scores = [], []
            for lo, hi in zip([0] + cuts, cuts + [rows.shape[0]]):
                res, st = op.process(rows[lo:hi], t_ns[lo:hi],
                                     1_000_000_000, st)
                evs.extend(res.events)
                if res.scores is not None:
                    scores.append(res.scores)
            got[dev] = (evs, scores, st)
        (ev_c, sc_c, st_c), (ev_g, sc_g, st_g) = got["cpu"], got["cuda"]
        key = ("op", "kind", "channel", "t_ns", "t_peak_ns", "t_end_ns")
        assert [[e[k] for k in key] for e in ev_g] == [
            [e[k] for k in key] for e in ev_c]
        if spec[0] == "stalta":
            assert [e["score"] for e in ev_g] == [e["score"] for e in ev_c]
            for k in st_c:
                assert np.asarray(st_g[k]).tobytes() == np.asarray(
                    st_c[k]).tobytes(), k
        else:
            a, b = np.concatenate(sc_g), np.concatenate(sc_c)
            assert np.nanmax(np.abs(a - b)) <= 1e-6 * np.nanmax(np.abs(b))


def test_detect_run_defaults_to_the_card(cuda_device, tmp_path):
    """run_lowpass_realtime(detect=True) with device=None runs the
    operators on the card; its detection equals a CPU run's."""
    from tpudas_torch.detect import runner as det_runner
    from tpudas_torch.detect.ledger import load_events
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    src = str(tmp_path / "src")
    make_synthetic_spool(src, n_files=3, file_duration=20.0, fs=50.0,
                         n_ch=4, noise=0.01, format="tdas")
    ops = [("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2})]
    seen = []
    real_open = det_runner.DetectPipeline.open.__func__

    def spy(cls, *a, **k):
        pipe = real_open(cls, *a, **k)
        seen.extend(op.device.type for op in pipe.ops)
        return pipe

    outs = {}
    for dev in (None, "cpu"):
        out = str(tmp_path / f"out-{dev}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(det_runner.DetectPipeline, "open", classmethod(spy))
            mp.setattr(fleet_engine, "LFProc", TdasLFProc)
            run_lowpass_realtime(
                source=src, output_folder=out,
                start_time="2023-03-22T00:00:00", output_sample_interval=1.0,
                edge_buffer=5.0, process_patch_size=20, poll_interval=0.0,
                sleep_fn=lambda _s: None, detect=True, detect_operators=ops,
                device=dev)
        outs[dev] = load_events(out)
    assert seen == ["cuda", "cpu"]
    key = ("op", "channel", "t_ns", "t_peak_ns", "t_end_ns")
    assert [[e[k] for k in key] for e in outs[None]] == [
        [e[k] for k in key] for e in outs["cpu"]]


@pytest.mark.parametrize("size", [5, (9, 1)])
def test_median_on_card_bit_equal_to_cpu(cuda_device, size):
    from tpudas_torch.ops.median import median_filter

    rng = np.random.default_rng(2)
    x = rng.standard_normal((180, 1001)).astype(np.float32)
    x[7, 5] = np.nan
    assert median_filter(x, size).tobytes() == median_filter(
        x, size, device="cpu").tobytes()


def test_audit_repairs_a_folder_the_card_wrote(cuda_device, tmp_path):
    """A stream folder written on the card (the fused step, detection
    on, tdas outputs): clean as written; damaged, the audit repairs it
    (the carry promoted from ``.prev``, a stale tmp removed, a ledger
    surplus truncated) and a second audit is clean and empty; the
    resumed run on the card then finds nothing left to repair."""
    from tpudas_torch.detect.ledger import event_line, load_events
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.integrity.audit import audit
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.proc.stream import CARRY_FILENAME
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    pool, src, out = (str(tmp_path / n) for n in ("pool", "src", "out"))
    make_synthetic_spool(pool, n_files=4, file_duration=20.0, fs=50.0,
                         n_ch=4, noise=0.01, format="tdas")
    ops = [("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2})]
    os.makedirs(src)

    def run(upto):
        for name in sorted(os.listdir(pool))[:upto]:
            if name.endswith(".tdas") and not os.path.exists(
                    os.path.join(src, name)):
                os.link(os.path.join(pool, name), os.path.join(src, name))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
            mp.setattr(fleet_engine, "LFProc", TdasLFProc)
            return run_lowpass_realtime(
                source=src, output_folder=out,
                start_time="2023-03-22T00:00:00", output_sample_interval=1.0,
                edge_buffer=5.0, process_patch_size=20, poll_interval=0.0,
                sleep_fn=lambda _s: None, engine="fused", stateful=True,
                detect=True, detect_operators=ops)

    assert run(3) == 1
    rep = audit(out)
    assert rep["clean"] and not rep["issues"]
    carry = os.path.join(out, CARRY_FILENAME)
    with open(carry, "r+b") as fh:
        fh.seek(64)
        b = fh.read(1)
        fh.seek(64)
        fh.write(bytes([b[0] ^ 0xFF]))
    with open(carry + ".tmp.999", "wb") as fh:
        fh.write(b"junk")
    evs = load_events(out)
    assert evs
    fake = dict(evs[-1], seq=len(evs))
    with open(os.path.join(out, ".detect", "events.jsonl"), "a") as fh:
        fh.write(event_line(fake) + "\n")
    rep = audit(out)
    assert rep["clean"]
    assert sorted((i["artifact"], i["action"]) for i in rep["issues"]) == [
        ("carry", "promoted_prev"), ("events", "truncated"),
        ("tmp", "removed")]
    again = audit(out)
    assert again["clean"] and not again["issues"]
    reg = MetricsRegistry()
    with use_registry(reg):
        assert run(4) == 1
    assert reg.value("tpudas_integrity_audit_runs_total") == 1
    assert reg.value("tpudas_integrity_audit_repairs_total",
                     kind="promoted_prev") == 0


@pytest.mark.parametrize("op", ["mean", "min", "max"])
def test_block_reduce_on_card_matches_host(cuda_device, op):
    """The pyramid's device reduction (``block_reduce(engine="torch")``)
    on the card against the host float64 one: min and max exact, the
    mean within 1e-6 of the largest |value| (float32 window sums)."""
    from tpudas_torch.serve.tiles import block_reduce

    rng = np.random.default_rng(11)
    x = rng.standard_normal((1024, 2048)).astype(np.float32)
    x[40:44, 7] = np.nan
    got = block_reduce(x, 4, op, engine="torch", device=cuda_device)
    ref = block_reduce(x, 4, op).astype(np.float32)
    assert got.shape == ref.shape == (256, 2048)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    if op == "mean":
        assert (np.abs(got[fin] - ref[fin]).max()
                <= 1e-6 * np.abs(ref[fin]).max())
    else:
        assert np.array_equal(got[fin], ref[fin])
    # the card's answer on a card tensor too
    t = block_reduce(torch.from_numpy(x).to(cuda_device), 4, op,
                     engine="torch")
    assert np.array_equal(t, got, equal_nan=True)


def test_pyramid_stream_on_card(cuda_device, tmp_path, monkeypatch):
    """``run_lowpass_realtime(pyramid=True)`` on the card: the tree is
    the one-shot sync over the stream's own outputs."""
    import hashlib

    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.proc.streaming import run_lowpass_realtime
    from tpudas_torch.serve.tiles import sync_pyramid

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    monkeypatch.setattr(fleet_engine, "LFProc", TdasLFProc)
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
    src = str(tmp_path / "src")
    make_synthetic_spool(src, n_files=3, file_duration=30.0, fs=100.0,
                         n_ch=8, noise=0.01, format="tdas")
    out = str(tmp_path / "out")
    run_lowpass_realtime(src, out, "2023-03-22T00:00:00",
                         output_sample_interval=1.0, edge_buffer=8.0,
                         process_patch_size=40, poll_interval=0.0,
                         sleep_fn=lambda _: None, stateful=True,
                         pyramid=True, device=cuda_device)

    def tree(folder):
        res = {}
        base = os.path.join(folder, ".tiles")
        for d, _s, files in os.walk(base):
            for n in files:
                if ".prev" not in n and ".tmp" not in n:
                    with open(os.path.join(d, n), "rb") as fh:
                        res[os.path.relpath(os.path.join(d, n), base)] = (
                            hashlib.sha256(fh.read()).hexdigest())
        return res

    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    for n in os.listdir(out):
        if n.startswith("LFDAS_"):
            os.link(os.path.join(out, n), os.path.join(ref, n))
    sync_pyramid(ref)
    assert tree(out) == tree(ref) and "tails.npy" in tree(out)


def test_obs_stream_on_card(cuda_device, tmp_path, monkeypatch):
    """A 2-round ``fused`` stream on the card with health on and the
    flight ring at its default: every phase observed once a round, the
    health snapshot validates, and the ring's round records (each after
    its ``stream.round`` span) read back through the port's reader of
    the JAX ring format; B3 ran every block."""
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.obs.health import read_health, validate_health
    from tpudas_torch.obs.phases import PHASES, phase_seconds_snapshot
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    monkeypatch.setattr(fleet_engine, "LFProc", TdasLFProc)
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    monkeypatch.delenv("TPUDAS_FLIGHT", raising=False)
    pool = str(tmp_path / "pool")
    make_synthetic_spool(pool, n_files=3, file_duration=30.0, fs=100.0,
                         n_ch=8, noise=0.01, format="tdas")
    names = sorted(n for n in os.listdir(pool) if n.endswith(".tdas"))
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    os.makedirs(src)
    for n in names[:2]:
        os.link(os.path.join(pool, n), os.path.join(src, n))
    fed = []

    def sleep(_s):
        if not fed:
            fed.append(1)
            os.link(os.path.join(pool, names[2]), os.path.join(src, names[2]))

    reg = MetricsRegistry()
    before = fused_cascade.launches
    with use_registry(reg):
        assert run_lowpass_realtime(
            src, out, "2023-03-22T00:00:00", output_sample_interval=1.0,
            edge_buffer=8.0, process_patch_size=40, poll_interval=0.0,
            sleep_fn=sleep, stateful=True, engine="fused", health=True,
            device=cuda_device) == 2
    assert fused_cascade.launches > before
    snap = phase_seconds_snapshot(reg)
    assert {p: s["count"] for p, s in snap.items()} == dict.fromkeys(
        PHASES, 2)
    health = read_health(out)
    assert validate_health(health) is health and health["rounds"] == 2
    ring = read_flight(out)
    rounds = [r for r in ring if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [1, 2]
    for r in rounds:
        assert sorted(r["phases"]) == sorted(PHASES)
        i = ring.index(r)
        assert any(x["kind"] == "span" and x["name"] == "stream.round"
                   and x.get("round") == r["round"] for x in ring[:i])
    assert reg.value("tpudas_health_write_errors_total") == 0.0


def test_live_fused_stream_on_card(cuda_device, tmp_path, monkeypatch):
    """A 2-round ``fused`` stream on the card with ``live=True``: a
    ``/live`` subscriber of a port ``DASServer`` gets one delta a round,
    each equal to the hub's ring frame at its level; the snapshot equals
    ``/query`` of its window; B3 ran every block and the round records
    carry the ``live`` block."""
    import base64
    import io
    import json
    import threading
    import urllib.request

    from tpudas_torch.codec import decode_tile
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.live.hub import find_hub, reset_hubs
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.streaming import run_lowpass_realtime
    from tpudas_torch.serve.http import DASServer

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    monkeypatch.setattr(fleet_engine, "LFProc", TdasLFProc)
    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    reset_hubs()
    pool = str(tmp_path / "pool")
    make_synthetic_spool(pool, n_files=3, file_duration=30.0, fs=100.0,
                         n_ch=8, noise=0.01, format="tdas")
    names = sorted(n for n in os.listdir(pool) if n.endswith(".tdas"))
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    os.makedirs(src)
    for n in names[:2]:
        os.link(os.path.join(pool, n), os.path.join(src, n))
    os.makedirs(out)

    def read_events(url, want, timeout=30.0):
        resp = urllib.request.urlopen(url, timeout=timeout)
        buf, events = b"", []
        while len(events) < want:
            chunk = resp.read(256)
            if not chunk:
                break
            buf += chunk
            *blocks, rest = buf.split(b"\n\n")
            buf = rest
            for block in blocks:
                fields = dict(line.split(": ", 1) for line in
                              block.decode().splitlines() if ": " in line)
                if "event" in fields:
                    events.append((fields["event"],
                                   json.loads(fields["data"])))
        resp.close()
        return events

    with DASServer(out, port=0) as srv:
        got = {}
        fed = []

        def sleep(_s):
            if not fed:
                fed.append(1)
                os.link(os.path.join(pool, names[2]),
                        os.path.join(src, names[2]))

        def subscribe():
            while find_hub(folder=os.path.abspath(out)) is None:
                threading.Event().wait(0.01)
            got["live"] = read_events(
                srv.base_url + "/live?window=0&heartbeat=0.5&level=1"
                "&last_id=0&max_frames=2", want=3)

        before = fused_cascade.launches
        reader = threading.Thread(target=subscribe, daemon=True)
        reader.start()
        assert run_lowpass_realtime(
            src, out, "2023-03-22T00:00:00", output_sample_interval=1.0,
            edge_buffer=8.0, process_patch_size=40, poll_interval=0.0,
            sleep_fn=sleep, stateful=True, engine="fused", pyramid=True,
            live=True, device=cuda_device) == 2
        reader.join(timeout=60)
        assert fused_cascade.launches > before
        hub = find_hub(folder=os.path.abspath(out))
        ring = {f.seq: f for f in hub._ring}
        deltas = [d for ev, d in got["live"] if ev == "delta"]
        assert [d["seq"] for d in deltas] == [1, 2]
        for d in deltas:
            np.testing.assert_array_equal(
                decode_tile(base64.b64decode(d["blob"])),
                ring[d["seq"]].level_array(d["level"]))
        snap = [d for ev, d in read_events(
            srv.base_url + "/live?window=20&heartbeat=0.5&max_frames=1",
            want=2) if ev == "snapshot"][0]
        t0, n, step = snap["t0_ns"], snap["rows"], snap["step_ns"]
        with urllib.request.urlopen(
                srv.base_url + f"/query?t0={t0}&t1={t0 + n * step}",
                timeout=30) as r:
            pulled = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(
            decode_tile(base64.b64decode(snap["blob"])),
            pulled.astype(np.float32))
    rounds = [r for r in read_flight(out) if r["kind"] == "round"]
    assert [r["live"]["published"] for r in rounds] == [1, 1]
    reset_hubs()


@pytest.mark.parametrize("engine", ["fused", "auto"])
def test_backfill_shards_on_card_equal_sequential(cuda_device, tmp_path,
                                                  monkeypatch, engine):
    """A backfill of 2 shards drained on the card (B3 under ``fused``,
    B1 under ``auto``), each shard opening its stream cold at its lead
    and draining in bounded rounds, stitched with pyramid and
    detection: byte-equal to the sequential realtime run on the card
    over the same archive (outputs, pyramid tree, detect state); tdas
    outputs through the drill's seam (the card's host may lack h5py)."""
    from tpudas_torch.backfill import plan_backfill, run_worker
    from tpudas_torch.backfill import stitch as stitch_mod
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.integrity.audit import audit_backfill
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.proc.streaming import run_lowpass_realtime
    from tpudas_torch.tools import backfill_drill as drill
    from tpudas_torch.tools.crash_drill import (
        _atomic_tdas_class,
        _content_hash,
        _detect_state,
        _pyramid_tree,
    )

    monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", "0")
    monkeypatch.setattr(fleet_engine, "LFProc",
                        _atomic_tdas_class(fleet_engine.LFProc))
    monkeypatch.setattr(stitch_mod, "_write_rows", drill._atomic_tdas_rows)
    t0 = "2023-03-22T00:00:00"
    src, root, seq = (str(tmp_path / n) for n in ("src", "q", "seq"))
    make_synthetic_spool(src, n_files=6, file_duration=20.0, fs=50.0,
                         n_ch=64, noise=0.01, format="tdas")
    t1 = np.datetime64(t0) + np.timedelta64(120, "s")
    kw = dict(output_sample_interval=1.0, edge_buffer=5.0,
              process_patch_size=20, engine=engine, pyramid=True,
              detect=True, detect_operators=drill.DETECT_OPS)
    plan_backfill(root, src, t0, t1, shard_seconds=60.0,
                  ingest_limit_sec=35.0, **kw)
    launches = (fused_cascade.launches, fir_decimate.launches)
    tally = run_worker(root, worker="card", settle=0.0, max_wall=300,
                       device=cuda_device)
    assert tally["committed"] == 2 and tally["stitched"], tally
    if engine == "fused":
        assert fused_cascade.launches > launches[0]
    else:
        assert fir_decimate.launches > launches[1]
    assert audit_backfill(root, repair=False)["clean"]
    run_lowpass_realtime(source=src, output_folder=seq, start_time=t0,
                         poll_interval=0.0, sleep_fn=lambda _s: None,
                         device=cuda_device, **kw)
    res = os.path.join(root, "result")
    assert _content_hash(res) == _content_hash(seq)
    assert _pyramid_tree(res) == _pyramid_tree(seq)
    assert _detect_state(res) == _detect_state(seq)


def _fused_stream(x, plan, splits, qscale):
    """The fused step over ``x`` cut into blocks of ``splits`` outputs,
    from a zero carry: (concatenated outputs, final carry)."""
    from tpudas_torch.ops.fir import cascade_stream_init, stream_carry_sizes
    from tpudas_torch.ops.fused_kernel import fused_cascade

    sizes = stream_carry_sizes(plan)
    carry = cascade_stream_init(plan, x.shape[1], x.device)
    ys, r0 = [], 0
    for n in splits:
        rows = n * plan.ratio
        y, carry = fused_cascade(x[r0:r0 + rows].contiguous(), carry,
                                 plan.stages, sizes, qscale=qscale)
        ys.append(y)
        r0 += rows
    return torch.cat(ys), carry


@pytest.mark.parametrize("int16", [False, True], ids=["f32", "int16"])
def test_fused_kernel_is_chunk_invariant(cuda_device, int16):
    """B3 at the flagship plan: the same stream cut into blocks three
    ways (whole minutes, ragged, single outputs) gives bit-equal
    outputs and carries, as the backfill's stitch needs (a shard's
    blocks start elsewhere than the sequential run's).  Kernel B's ring
    read once assigned taps to partial sums by where the ring wrapped,
    which differed with the split."""
    from tpudas_torch.proc.lfproc import output_corner

    plan = fir.design_cascade(1000.0, 1000, output_corner(1.0))
    n_out = 120
    x = torch.from_numpy(
        _window(n_out * plan.ratio, 256, seed=9, int16=int16)).to(
        cuda_device)
    qs = 1e-4 if int16 else None
    splits = ([60, 60], [7, 53, 29, 31], [1, 1, 1, 57, 3, 57])
    runs = [_fused_stream(x, plan, s, qs) for s in splits]
    y0, c0 = runs[0]
    for (y, c), s in zip(runs[1:], splits[1:]):
        assert torch.equal(y, y0), s
        assert all(torch.equal(a, b) for a, b in zip(c, c0)), s


def test_devprof_event_path_on_card(cuda_device, monkeypatch):
    """The device telemetry on the card: each CUDA stream step (B3 under
    ``fused``, the B1 chain under ``auto``, a stacked B3 step over two
    members, the FFT step) is one launch bracketed by a pair of timing
    events on the current stream; ``round_collect`` waits on the parked
    end events, never on the whole device (``torch.cuda.synchronize`` is
    made to raise), and gives positive device seconds no larger than
    the steps' host wall."""
    import time

    from tpudas_torch.obs import devprof
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry
    from tpudas_torch.ops.filter import fft_pass_filter_stream

    devprof.reset()
    plan = fir.design_cascade(1000.0, 1000, 0.45)
    C = 2048
    x = torch.from_numpy(_window(60000, C, 5, int16=True)).to(cuda_device)
    carry = fir.cascade_stream_init(plan, C, cuda_device)
    reg = MetricsRegistry()
    with use_registry(reg), devprof.stream_scope("card"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for eng in ("fused", "auto"):
            _y, carry = fir.cascade_decimate_stream(x, carry, plan, eng,
                                                    qscale=1e-4)
        with devprof.wave_scope(["a", "b"]):
            fir.cascade_decimate_stream_stacked(
                [x[:, :1000].contiguous(), x[:, 1000:].contiguous()],
                [tuple(c[:, :1000].contiguous() for c in carry),
                 tuple(c[:, 1000:].contiguous() for c in carry)],
                plan, "fused-cuda", qscale=1e-4)
        fft_pass_filter_stream(x, torch.zeros((2000, C), device=cuda_device),
                               0.001, high=0.45, qscale=1e-4)

        def refuse(*_a, **_k):
            raise AssertionError("round_collect synchronized the device")

        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        d = devprof.round_collect()
        wall = time.perf_counter() - t0
        monkeypatch.undo()
    snap = devprof.devprof_snapshot(calibrate=False)
    assert d["launches"] == 3.0 and 0 < d["device_execute_s"] <= wall
    assert snap["pending"] == 0
    engines = {(e["engine"], e["stacked"], e["stream"]): e["launches"]
               for e in snap["launches"]}
    assert engines == {("fused-cuda", "0", "card"): 1.0,
                       ("cuda", "0", "card"): 1.0,
                       ("fft", "0", "card"): 1.0,
                       ("fused-cuda", "1", "a"): 0.5,
                       ("fused-cuda", "1", "b"): 0.5}
    assert all(s["device_seconds"] > 0 for s in snap["streams"].values())
    devprof.reset()


def test_devprof_never_blocks_the_dispatching_thread(cuda_device):
    """A launch still running on the card is parked: ``note_launch``
    returns at once (``Event.query()`` does not wait), the entry stays
    pending, and ``round_collect`` then waits for it and counts its
    device seconds."""
    import time

    from tpudas_torch.obs import devprof
    from tpudas_torch.obs.registry import MetricsRegistry, use_registry

    devprof.reset()
    with use_registry(MetricsRegistry()), devprof.stream_scope("busy"):
        torch.cuda.synchronize()
        t0 = devprof.launch_start(cuda_device)
        torch.cuda._sleep(int(1e9))  # about half a second of device spin
        t_host = time.perf_counter()
        devprof.note_launch("probe", t0, None)
        devprof.note_launch("probe", devprof.launch_start(cuda_device),
                            None)
        host_s = time.perf_counter() - t_host
        parked = len(devprof._state.pending)
        d = devprof.round_collect()
    assert host_s < 0.05, host_s
    assert parked == 2
    assert d["launches"] == 2.0 and d["device_execute_s"] > 0.1
    devprof.reset()


def _card_mesh(cuda_device, time_shards, ch_shards):
    """Shards all on the one card: the mesh layout a one-card host can
    run (copies between cards are not exercised)."""
    from tpudas_torch.parallel.mesh import DeviceMesh

    dev = torch.device("cuda", 0)
    return DeviceMesh([[dev] * ch_shards for _ in range(time_shards)])


@pytest.mark.parametrize("C", [10000, 6001, 1001])
def test_mesh_b1_byte_equal_to_single_on_card(cuda_device, C):
    """B1 under a [cuda:0] x 2 channel mesh, a (time=2, ch=2) mesh (each
    time shard from its own first row, another tile phase) and window
    DP: bit-equal to the unsharded kernel path, and that path within
    1e-5 of the plain version.  Widths whose shards change the copy
    width (10000/2 int16 vs 1001/2 padded) included."""
    from tpudas_torch.parallel.batch import batched_cascade_decimate
    from tpudas_torch.parallel.pipeline import sharded_cascade_decimate

    plan = fir.design_cascade(1000.0, 1000, 0.45)
    rng = np.random.default_rng(C)
    # 70 outputs: each of 2 time shards holds 35,000 rows, more than the
    # flagship cascade's right halo, so the time-sharded layout fits
    x = rng.integers(-3000, 3000, (70 * 1000 + 9001, C), dtype=np.int16)
    phase, n_out = 9000, 70
    ref = fir.cascade_decimate(torch.from_numpy(x).to(cuda_device), plan,
                               phase, n_out, qscale=1e-4)
    if C <= 1001:  # the plain version on the host, at a narrow width
        plain = fir.cascade_decimate(x, plan, phase, n_out, qscale=1e-4,
                                     device="cpu")
        assert _rel(ref, plain) <= REL_TOL
    before = fir_decimate.launches
    got = fir.cascade_decimate(x, plan, phase, n_out, qscale=1e-4,
                               mesh=_card_mesh(cuda_device, 1, 2))
    assert fir_decimate.launches - before == 2 * 4
    assert torch.equal(got, ref)
    tsh = sharded_cascade_decimate(_card_mesh(cuda_device, 2, 2), x, plan,
                                   phase, n_out, qscale=1e-4)
    assert tsh is not None and torch.equal(tsh, ref)
    dp = batched_cascade_decimate(_card_mesh(cuda_device, 2, 1),
                                  np.stack([x, x]), plan, phase, n_out,
                                  qscale=1e-4)
    assert torch.equal(dp[0], ref) and torch.equal(dp[1], ref)


@pytest.mark.parametrize("C,shards", [(10000, 2), (6001, 4)])
def test_mesh_b3_stream_byte_equal_to_single_on_card(cuda_device, C,
                                                     shards):
    """B3 (and the B1 chain) as sharded stream steps: outputs and every
    carry leaf bit-equal to the unsharded step over an uneven block
    sequence; 6001 channels over 4 shards are 1501 a shard, not a
    multiple of 8 (kernel A's scalar loads)."""
    from tpudas_torch.ops.fused_kernel import fused_cascade
    from tpudas_torch.parallel.sharding import ShardedTensor, gather_leaves
    from tpudas_torch.proc.lfproc import output_corner

    plan = fir.design_cascade(1000.0, 1000, output_corner(1.0))
    mesh = _card_mesh(cuda_device, 1, shards)
    rng = np.random.default_rng(11)
    x = rng.integers(-3000, 3000, (24 * plan.ratio, C), dtype=np.int16)
    for engine in ("fused-cuda", "cuda"):
        ref = fir.cascade_stream_init(plan, C, cuda_device)
        sh = fir.cascade_stream_init(plan, C, cuda_device)
        off = 0
        for n in (16, 3, 5):
            blk = x[off * plan.ratio:(off + n) * plan.ratio]
            off += n
            before = fused_cascade.launches
            y_ref, ref = fir.cascade_decimate_stream(
                torch.from_numpy(blk).to(cuda_device), ref, plan, engine,
                qscale=1e-4)
            if engine == "fused-cuda":
                assert fused_cascade.launches - before == 1
            before = fused_cascade.launches
            y, sh = fir.cascade_decimate_stream(blk, sh, plan, engine,
                                                qscale=1e-4, mesh=mesh)
            if engine == "fused-cuda":
                assert fused_cascade.launches - before == shards
            assert torch.equal(y, y_ref), (engine, n)
            assert all(isinstance(b, ShardedTensor) for b in sh)
        for a, b in zip(gather_leaves(sh, C), gather_leaves(ref, C)):
            assert np.array_equal(a, b), engine


def test_window_dp_reraises_a_kernel_launch_error(cuda_device, tmp_path,
                                                  monkeypatch):
    """A kernel that fails to launch inside a window-DP batch is
    re-raised: window DP is not latched off around a broken kernel."""
    import tpudas_torch.parallel.batch as batch_mod
    from tpudas_torch.ops import fir_kernel
    from tpudas_torch.ops._build import KernelError
    from tpudas_torch.utils.logging import set_log_handler

    class TdasLFProc(LFProc):
        # outputs as tdas: the card's host may lack h5py
        def _write_output(self, patch, path):
            patch.io.write(os.path.splitext(path)[0] + ".tdas", "tdas")

    d = tmp_path / "raw"
    make_synthetic_spool(d, n_files=6, file_duration=30.0, fs=100.0,
                         n_ch=6, noise=0.01, format="tdas")
    armed = {"on": False}
    real_launch, real_batch = fir_kernel._launch, batch_mod.batched_cascade_decimate

    def launch(*a, **k):
        if armed["on"]:
            raise KernelError("fir_decimate kernel launch failed: injected")
        return real_launch(*a, **k)

    def batch(*a, **k):
        armed["on"] = True
        return real_batch(*a, **k)

    monkeypatch.setattr(fir_kernel, "_launch", launch)
    monkeypatch.setattr(batch_mod, "batched_cascade_decimate", batch)
    events = []
    set_log_handler(events.append)
    lfp = TdasLFProc(spool(str(d)).sort("time").update(),
                     mesh=_card_mesh(cuda_device, 2, 1), device=cuda_device)
    lfp.update_processing_parameter(output_sample_interval=1.0,
                                    process_patch_size=60, edge_buff_size=10,
                                    window_dp=True)
    lfp.set_output_folder(str(tmp_path / "out"), delete_existing=True)
    try:
        with pytest.raises(KernelError, match="injected"):
            lfp.process_time_range(np.datetime64("2023-03-22T00:00:00"),
                                   np.datetime64("2023-03-22T00:03:00"))
    finally:
        set_log_handler(None)
    assert armed["on"] and lfp._window_dp_ok
    assert not [e for e in events if e["event"] == "window_dp_fallback"]
