"""The DASCore-compatible entry of the port (``tpudas_torch.compat``)
against the repo's shims over the JAX package (``dascore``, ``lf_das``).

The cases of ``tests/test_compat.py`` replay condensed notebook cells
with the notebooks' own spellings; here each runs once through each
package's entry, on one synthetic spool, and the results are held to
each other: output file names equal, data within 1e-5 of each channel's
scale (the cascade's tolerance: the two sum the same float32 products
in other orders).  The port's calls pass no device, as the notebooks'
do, so they run inside ``default_device("cpu")`` (the plain versions of
the kernels).
"""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

import dascore as jdc
import lf_das as jlf
import tpudas_torch.compat.dascore as tdc
import tpudas_torch.compat.lf_das as tlf
from tpudas.testing import make_synthetic_spool
from tpudas_torch.compat.dascore.units import s as ts
from tpudas_torch.compat.dascore.utils.mapping import FrozenDict as TFrozenDict
from tpudas_torch.device import default_device
from dascore.units import s as js

FS = 100.0
REL_TOL = 1e-5
ENTRIES = {
    "jax": (jdc, jlf, js),
    "port": (tdc, tlf, ts),
}


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("compat_raw")
    make_synthetic_spool(
        d, n_files=6, file_duration=30.0, fs=FS, n_ch=12, noise=0.01
    )
    return str(d)


@pytest.fixture
def on_cpu():
    with default_device("cpu"):
        yield


def _assert_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.nanmax(np.abs(b), axis=0)
    diff = np.nanmax(np.abs(a - b), axis=0)
    assert (diff <= REL_TOL * scale).all(), (diff / scale).max()
    assert (np.isnan(a) == np.isnan(b)).all()


def _assert_same_folders(port_dir, jax_dir):
    names = sorted(n for n in os.listdir(jax_dir) if n.endswith(".h5"))
    assert names and names == sorted(
        n for n in os.listdir(port_dir) if n.endswith(".h5"))
    for n in names:
        a = tdc.spool(os.path.join(port_dir, n))[0]
        b = jdc.spool(os.path.join(jax_dir, n))[0]
        assert np.array_equal(np.asarray(a.coords["time"]),
                              np.asarray(b.coords["time"])), n
        _assert_close(a.data, b.data)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_lf_das_public_surface(entry):
    # every name the notebooks import from lf_das exists
    _dc, lf, _s = ENTRIES[entry]
    for name in ("LFProc", "get_edge_effect_time", "get_patch_time",
                 "waterfall_plot", "_get_filename", "_get_timestr",
                 "_check_merge", "_down_sample_processing"):
        assert callable(getattr(lf, name)), name
    params = (lf.LFProc(device="cpu") if entry == "port"
              else lf.LFProc()).parameters
    assert type(params).__name__ == "FrozenDict"
    if entry == "port":
        assert isinstance(params, TFrozenDict)
    # the same defaults through both entries
    jparams = jlf.LFProc().parameters
    assert dict(params) == dict(jparams)


def _rolling_flow(dc, lf, s, data_path, output):
    """rolling_mean_dascore.ipynb cells 5-9 condensed."""
    os.makedirs(output, exist_ok=True)
    sp = dc.spool(data_path).sort("time").update()
    patch_0 = sp[0]
    gauge_length = patch_0.attrs["gauge_length"]
    sampling_interval = patch_0.attrs["d_time"]
    sampling_rate = 1 / (sampling_interval / np.timedelta64(1, "s"))
    d_t = 1.0
    window = d_t * s
    step = d_t * s
    scale_iDAS = float((116 * sampling_rate / gauge_length) / 1e9)
    sub_sp = sp.select(distance=(0.0, 25.0))
    for patch in sub_sp:
        rolling_mean_patch = patch.rolling(
            time=window, step=step, engine="numpy"
        ).mean()
        new_scaled_patch = rolling_mean_patch.new(
            data=np.asarray(rolling_mean_patch.data) * scale_iDAS
        )
        filename = lf._get_filename(
            new_scaled_patch.attrs["time_min"], new_scaled_patch.attrs["time_max"]
        )
        new_scaled_patch.io.write(output + "/" + filename, "dasdae")
    rolling_spool = dc.spool(output).chunk(time=None)
    rolling_merged_patch = rolling_spool[0]
    data = np.asarray(rolling_merged_patch.data)
    n_samples = data.shape[0]
    time_axis = np.linspace(0, int(n_samples * d_t), n_samples, endpoint=False)
    time_axis[np.isnan(data[:, 0])] = np.nan
    time_no_nans = time_axis[~np.isnan(time_axis)]
    no_nans = rolling_merged_patch.dropna("time")
    assert time_no_nans.shape[0] == np.asarray(no_nans.data).shape[0]
    return data, np.asarray(no_nans.data)


def test_rolling_mean_notebook_flow(data_path, tmp_path, on_cpu):
    got = {}
    for entry, (dc, lf, s) in ENTRIES.items():
        got[entry] = _rolling_flow(dc, lf, s, data_path,
                                   str(tmp_path / f"rolling-{entry}"))
    _assert_same_folders(str(tmp_path / "rolling-port"),
                         str(tmp_path / "rolling-jax"))
    for a, b in zip(got["port"], got["jax"]):
        _assert_close(a, b)


def _edge_flow(dc, lf, data_path, output):
    """low_pass_dascore_edge.ipynb cell 11 resume arithmetic."""
    d_t = 1.0
    edge_buffer = 8.0
    sp = dc.spool(data_path).update()
    sub_sp = sp.select(distance=(0.0, 55.0))
    lfp = lf.LFProc(sub_sp)
    lfp.update_processing_parameter(
        output_sample_interval=d_t,
        process_patch_size=40,
        edge_buff_size=int(np.ceil(edge_buffer / d_t)),
    )
    lfp.set_output_folder(output, delete_existing=False)
    t_1 = np.datetime64("2023-03-22T00:00:00")
    t_2 = np.datetime64(sub_sp[-1].attrs["time_max"])
    lfp.process_time_range(t_1, t_2)
    t_2b = lfp.get_last_processed_time()
    assert isinstance(t_2b, np.datetime64)
    buffer = int((np.ceil(edge_buffer / d_t) - 1) * d_t)
    t_1b = t_2b - np.timedelta64(buffer, "s")
    assert t_1b < t_2b
    return t_2b, t_1b


def test_edge_notebook_resume_idiom(data_path, tmp_path, on_cpu):
    got = {entry: _edge_flow(dc, lf, data_path, str(tmp_path / f"edge-{entry}"))
           for entry, (dc, lf, _s) in ENTRIES.items()}
    assert got["port"] == got["jax"]
    _assert_same_folders(str(tmp_path / "edge-port"),
                         str(tmp_path / "edge-jax"))


def test_down_sample_processing_pipeline(data_path, on_cpu):
    """_down_sample_processing: corner 0.4/dt + uniform-grid resample."""
    outs = {}
    for entry, (dc, lf, _s) in ENTRIES.items():
        sp = dc.spool(data_path).update()
        patch = sp[0]
        out = patch.pipe(lf._down_sample_processing, freq=1.0)
        assert out.attrs["time_step"] == np.timedelta64(1, "s")
        assert np.asarray(out.data).shape[1] == np.asarray(patch.data).shape[1]
        outs[entry] = out
    assert np.array_equal(np.asarray(outs["port"].coords["time"]),
                          np.asarray(outs["jax"].coords["time"]))
    _assert_close(outs["port"].data, outs["jax"].data)


def _batch_flow(dc, lf, data_path, output):
    """low_pass_dascore.ipynb cells 3-11 condensed."""
    sp = dc.spool(data_path).sort("time").update()
    assert len(sp.get_contents()) == 6
    patch_0 = sp[0]
    sampling_interval = patch_0.attrs["time_step"]
    sampling_rate = 1 / (sampling_interval / np.timedelta64(1, "s"))
    ch_start, ch_end = 2, 10
    d_1 = patch_0.coords["distance"][ch_start]
    d_2 = patch_0.coords["distance"][ch_end]
    sub_sp = sp.select(distance=(d_1, d_2),
                       time=("2023-03-22 00:00:00", "2023-03-22 00:03:00"))
    patch_length, d_t, tolerance = 60.0, 1.0, 1e-3
    edge_buffer = lf.get_edge_effect_time(
        sampling_interval=1 / sampling_rate, total_T=patch_length,
        tol=tolerance, freq=1 / d_t,
    )
    lfp = lf.LFProc(sub_sp)
    lfp.update_processing_parameter(
        output_sample_interval=d_t,
        process_patch_size=int(patch_length / d_t),
        edge_buff_size=int(np.ceil(edge_buffer / d_t)),
    )
    lfp.set_output_folder(output, delete_existing=False)
    lfp.process_time_range(np.datetime64("2023-03-22T00:00:00"),
                           np.datetime64("2023-03-22T00:03:00"))
    result = dc.spool(output).chunk(time=None)[0]
    assert np.asarray(result.data).shape[1] == ch_end - ch_start + 1
    assert result.attrs["time_step"] == np.timedelta64(1, "s")
    gauge_length = patch_0.attrs["gauge_length"]
    scale_iDAS = float((116 * sampling_rate / gauge_length) / 1e9)
    filtered = np.asarray(result.data)
    mean_array = np.mean(filtered[:, 0:2], axis=1).reshape(-1, 1)
    demeaned = (filtered - mean_array) * scale_iDAS
    ax = result.new(data=demeaned).viz.waterfall(scale=0.01)
    assert ax is not None
    return edge_buffer, demeaned


@pytest.mark.slow
def test_batch_low_pass_notebook_flow(data_path, tmp_path, on_cpu):
    import matplotlib.pyplot as plt

    got = {entry: _batch_flow(dc, lf, data_path, str(tmp_path / entry))
           for entry, (dc, lf, _s) in ENTRIES.items()}
    plt.close("all")
    assert got["port"][0] == got["jax"][0]
    _assert_same_folders(str(tmp_path / "port"), str(tmp_path / "jax"))
    _assert_close(got["port"][1], got["jax"][1])


@pytest.mark.slow
def test_waterfall_plot_signature(tmp_path):
    """lf_das.waterfall_plot with the notebook's (channel x time) input,
    through both entries: the same JPEG size class, both written."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((32, 300))
    for entry, (_dc, lf, _s) in ENTRIES.items():
        lf.waterfall_plot(
            data, 0, 200, 0, 30, 100, 1.0, 50.0, 1.0,
            "test title", str(tmp_path), f"qc_plot_{entry}",
        )
        assert (tmp_path / f"qc_plot_{entry}.jpeg").exists()
