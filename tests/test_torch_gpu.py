"""tpudas_torch on the CUDA card: the kernel against its plain version,
the cascade and LFProc on the card against the same port on the CPU.

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
    assert lfp.engine_counts == {"cascade-cuda": 4, "cascade-torch": 0}
    assert launches == 4 * 4 and outs["cpu"][1] == 0
    assert sorted(os.listdir(tmp_path / "cuda")) == sorted(
        os.listdir(tmp_path / "cpu")
    )
    a = spool(str(tmp_path / "cuda")).update().chunk(time=None)[0]
    b = spool(str(tmp_path / "cpu")).update().chunk(time=None)[0]
    assert np.array_equal(a.coords["time"], b.coords["time"])
    assert _rel(torch.from_numpy(a.host_data()),
                torch.from_numpy(b.host_data())) <= REL_TOL
