"""tpudas_torch.proc.lfproc.LFProc against the JAX package's LFProc.

Small spools (200 Hz x 16 channels, 4 x 30 s) written by the JAX
package's ``make_synthetic_spool`` — dasdae, and int16 tdas — go
through ``tpudas.proc.lfproc.LFProc`` and through the port's LFProc on
the CPU (plain PyTorch stages).  File names and time coordinates must
be identical, data within 1e-5 of each channel's scale (the two sum
the same f32 products in different orders).
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.io.spool import spool as jspool
from tpudas.proc.lfproc import LFProc as JLFProc
from tpudas.testing import make_synthetic_spool
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.proc.lfproc import LFProc

T1 = "2023-03-22T00:00:00"
TMID = "2023-03-22T00:01:00"
T2 = "2023-03-22T00:02:00"
REL_TOL = 1e-5

FORMATS = {
    "dasdae": ("dasdae", None),
    "tdas-int16": ("tdas", {"dtype": "int16", "scale": 1e-4}),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def src(request, tmp_path_factory):
    fmt, wk = FORMATS[request.param]
    d = tmp_path_factory.mktemp(f"src-{request.param}")
    make_synthetic_spool(
        d, n_files=4, file_duration=30.0, fs=200.0, n_ch=16, noise=0.02,
        format=fmt, write_kwargs=wk,
    )
    return str(d)


def _configure(lfp, out, **para):
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=40, edge_buff_size=10,
        **para,
    )
    lfp.set_output_folder(str(out), delete_existing=True)
    return lfp


def _run_port(src, out, t1=T1, t2=T2, **para):
    lfp = _configure(LFProc(tspool(src).sort("time").update(), device="cpu"),
                     out, **para)
    lfp.process_time_range(np.datetime64(t1), np.datetime64(t2))
    return lfp


def _run_jax(src, out, **para):
    lfp = _configure(JLFProc(jspool(src).sort("time").update()), out, **para)
    lfp.process_time_range(np.datetime64(T1), np.datetime64(T2))
    return lfp


def _outputs(folder):
    names = sorted(os.listdir(folder))
    return names, [tspool(os.path.join(folder, n))[0] for n in names]


def _assert_close(a, b):
    da, db = a.host_data(), b.host_data()
    assert da.shape == db.shape
    scale = np.abs(db).max(axis=0)
    assert (np.abs(da - db).max(axis=0) <= REL_TOL * scale).all()


def test_lfproc_matches_jax(src, tmp_path):
    port = _run_port(src, tmp_path / "port")
    _run_jax(src, tmp_path / "jax")
    names_t, pt = _outputs(tmp_path / "port")
    names_j, pj = _outputs(tmp_path / "jax")
    assert names_t == names_j and len(names_t) == 5
    assert all(n.startswith("LFDAS_") and n.endswith(".h5") for n in names_t)
    for a, b in zip(pt, pj):
        assert np.array_equal(a.coords["time"], b.coords["time"])
        assert np.array_equal(a.coords["distance"], b.coords["distance"])
        _assert_close(a, b)
    assert port.engine_counts == {"cascade-cuda": 0, "cascade-torch": 5,
                                  "fft": 0}
    int16 = "tdas" in os.path.basename(src)
    assert port.quantized_windows == (5 if int16 else 0)


def test_resume_continues_seam_free(src, tmp_path):
    """Kill-and-resume (the edge-loop contract): a second
    process_time_range from the output folder's state continues the
    1 Hz grid without a seam or a gap."""
    out = tmp_path / "resumed"
    _run_port(src, out, t2=TMID)
    lfp = LFProc(tspool(src).sort("time").update(), device="cpu")
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=40, edge_buff_size=10,
    )
    lfp.set_output_folder(str(out), delete_existing=False)
    t_last = lfp.get_last_processed_time()
    lfp.process_time_range(t_last - np.timedelta64(9, "s"), np.datetime64(T2))
    merged = tspool(str(out)).update().chunk(time=None)
    assert len(merged) == 1
    steps = np.diff(merged[0].coords["time"].astype(np.int64))
    assert np.all(steps == 1_000_000_000)
    full = _run_port(src, tmp_path / "full")
    assert full.engine_counts["cascade-torch"] == 5
    b = tspool(str(tmp_path / "full")).update().chunk(time=None)[0]
    ta, tb = merged[0].coords["time"], b.coords["time"]
    lo, hi = max(ta[0], tb[0]), min(ta[-1], tb[-1])
    asel, bsel = merged[0].select(time=(lo, hi)), b.select(time=(lo, hi))
    scale = np.abs(bsel.host_data()).max()
    assert np.abs(asel.host_data() - bsel.host_data()).max() < 5e-3 * scale


def test_gap_split_matches_jax(tmp_path):
    d = tmp_path / "gappy"
    make_synthetic_spool(d, n_files=2, file_duration=30.0, fs=200.0, n_ch=4,
                         noise=0.0)
    make_synthetic_spool(d, n_files=2, file_duration=30.0, fs=200.0, n_ch=4,
                         noise=0.0, start="2023-03-22T00:02:00", prefix="late")
    t2 = "2023-03-22T00:03:00"
    port = _configure(LFProc(tspool(str(d)).sort("time").update(),
                             device="cpu"), tmp_path / "port", on_gap="split")
    port.process_time_range(np.datetime64(T1), np.datetime64(t2))
    ref = _configure(JLFProc(jspool(str(d)).sort("time").update()),
                     tmp_path / "jax", on_gap="split")
    ref.process_time_range(np.datetime64(T1), np.datetime64(t2))
    names_t, pt = _outputs(tmp_path / "port")
    names_j, pj = _outputs(tmp_path / "jax")
    assert names_t == names_j and len(names_t) >= 2
    for a, b in zip(pt, pj):
        assert np.array_equal(a.coords["time"], b.coords["time"])
        _assert_close(a, b)


def test_gap_raises_like_the_reference(tmp_path):
    d = tmp_path / "gappy"
    make_synthetic_spool(d, n_files=2, file_duration=30.0, fs=200.0, n_ch=4)
    make_synthetic_spool(d, n_files=2, file_duration=30.0, fs=200.0, n_ch=4,
                         start="2023-03-22T00:02:00", prefix="late")
    lfp = _configure(LFProc(tspool(str(d)).sort("time").update(),
                            device="cpu"), tmp_path / "out")
    with pytest.raises(Exception, match="Gap in data exists"):
        lfp.process_time_range(np.datetime64(T1),
                               np.datetime64("2023-03-22T00:03:00"))


def test_fft_engine_matches_jax(src, tmp_path):
    """engine="fft": every window through the FFT engine, in both
    packages; same names and grid, data within 1e-5 per channel (the
    same float32 response, two FFT libraries)."""
    port = _run_port(src, tmp_path / "port", engine="fft")
    _run_jax(src, tmp_path / "jax", engine="fft")
    names_t, pt = _outputs(tmp_path / "port")
    names_j, pj = _outputs(tmp_path / "jax")
    assert names_t == names_j and len(names_t) == 5
    for a, b in zip(pt, pj):
        assert np.array_equal(a.coords["time"], b.coords["time"])
        _assert_close(a, b)
    assert port.engine_counts == {"cascade-cuda": 0, "cascade-torch": 0,
                                  "fft": 5}
    int16 = "tdas" in os.path.basename(src)
    assert port.quantized_windows == (5 if int16 else 0)


def _auto_both(tmp_path, t2, n_files, **para):
    d = tmp_path / "src"
    make_synthetic_spool(d, n_files=n_files, file_duration=30.0, fs=200.0,
                         n_ch=4, noise=0.02)
    lfps = []
    for name, cls, sp, kw in (
        ("port", LFProc, tspool(str(d)).sort("time").update(), {"device": "cpu"}),
        ("jax", JLFProc, jspool(str(d)).sort("time").update(), {}),
    ):
        lfp = cls(sp, **kw)
        lfp.update_processing_parameter(**para)
        lfp.set_output_folder(str(tmp_path / name))
        lfp.process_time_range(np.datetime64(T1), np.datetime64(t2))
        lfps.append(lfp)
    names_t, pt = _outputs(tmp_path / "port")
    names_j, pj = _outputs(tmp_path / "jax")
    assert names_t == names_j and names_t
    for a, b in zip(pt, pj):
        assert np.array_equal(a.coords["time"], b.coords["time"])
        _assert_close(a, b)
    return lfps[0], len(names_t)


def test_non_aligned_grid_under_auto_needs_the_fft_slice(tmp_path):
    """A 12 ms grid over 5 ms samples (ratio 2.4, not sample-aligned)
    under engine="auto": every window routes to the FFT engine, as in
    the JAX package."""
    port, n = _auto_both(
        tmp_path, "2023-03-22T00:00:20", 1, output_sample_interval=0.012,
        process_patch_size=400, edge_buff_size=50,
    )
    assert port.engine_counts["fft"] == n and n >= 2
    assert port.engine_counts["cascade-torch"] == 0


def test_small_halo_under_auto_needs_the_fft_slice(tmp_path):
    """A 1-sample halo is smaller than the cascade's support: under
    engine="auto" the windows route to the FFT engine, as in the JAX
    package."""
    port, n = _auto_both(
        tmp_path, TMID, 2, output_sample_interval=1.0, process_patch_size=20,
        edge_buff_size=1,
    )
    assert port.engine_counts["fft"] == n and n >= 2
    assert port.engine_counts["cascade-torch"] == 0


@pytest.mark.parametrize("engine", ["fft", "fused"])
def test_unported_engines_raise(engine):
    """Every engine of the reference is ported and accepted: "fft" (the
    FFT engine) and "fused" (the stream kernel); an unknown name raises
    as the reference does."""
    lfp = LFProc(device="cpu")
    lfp.update_processing_parameter(engine=engine)
    assert lfp.parameters["engine"] == engine
    assert engine in LFProc._ENGINES
    with pytest.raises(ValueError, match="engine"):
        lfp.update_processing_parameter(engine="bogus")


def test_cascade_request_on_a_non_aligned_grid_raises(tmp_path):
    d = tmp_path / "src"
    make_synthetic_spool(d, n_files=1, file_duration=30.0, fs=200.0, n_ch=4)
    lfp = LFProc(tspool(str(d)).sort("time").update(), device="cpu")
    lfp.update_processing_parameter(
        output_sample_interval=0.012, process_patch_size=400,
        edge_buff_size=50, engine="cascade",
    )
    lfp.set_output_folder(str(tmp_path / "out"))
    with pytest.raises(ValueError, match="use engine='auto' or 'fft'"):
        lfp.process_time_range(np.datetime64(T1),
                               np.datetime64("2023-03-22T00:00:20"))


def test_lfproc_without_cuda_and_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LFProc()
    with pytest.raises(RuntimeError):
        LFProc(device="cuda")
    assert LFProc(device="cpu").device.type == "cpu"


def test_parameters_surface_matches_reference():
    port, ref = LFProc(device="cpu"), JLFProc()
    for key in ("output_sample_interval", "process_patch_size",
                "edge_buff_size", "data_gap_tolorance", "on_gap",
                "filter_order", "engine"):
        assert port.parameters[key] == ref.parameters[key]
    with pytest.raises(TypeError):
        port.parameters["edge_buff_size"] = 3  # type: ignore[index]
    port.update_processing_parameter(data_gap_tolerance=4.0)
    assert port.parameters["data_gap_tolorance"] == 4.0
    with pytest.raises(Exception, match="output folder"):
        port.process_time_range(np.datetime64(T1), np.datetime64(T2))
