"""The port's rolling reductions and JointProc against the JAX package's.

``rolling_reduce`` / ``PatchRoller`` / ``Patch.rolling`` take the same
seeded numpy input in both packages: the NaN warm-up prefix and the
output positions must be identical, min/max exact, mean/sum/std within
1e-6 of each channel's scale on the device engines (float32 sums of
the same terms in another order) and 1e-12 on the float64 host
engines.  JointProc runs over small spools (100 Hz x 6 channels, 6 x
30 s; dasdae and int16 tdas): its LF files must be byte-identical to the
port's own LFProc, and its rolling files must carry the JAX JointProc's
names and time grid with data within 1e-5 of each channel's scale (a
window mean of 200 float32 terms summed in another order).
"""

import filecmp
import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.core.patch import Patch as JPatch
from tpudas.io.spool import spool as jspool
from tpudas.ops.rolling import rolling_reduce as jrolling_reduce
from tpudas.proc.joint import JointProc as JJointProc
from tpudas.testing import make_synthetic_spool
from tpudas_torch.core.patch import Patch
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.ops.rolling import rolling_reduce
from tpudas_torch.proc.joint import JointProc
from tpudas_torch.proc.lfproc import LFProc

T1 = np.datetime64("2023-03-22T00:00:00", "ns")
T2 = np.datetime64("2023-03-22T00:03:00", "ns")
FS = 100.0
DEVICE_TOL = 1e-6
HOST_TOL = 1e-12
JOINT_TOL = 1e-5

# (w, s): step 1, step inside the window, step == window, step past the
# window, a long window, no complete window in 60 rows
GEOMETRIES = [(5, 1), (7, 3), (10, 10), (3, 5), (50, 7), (61, 4)]
OPS = ["mean", "sum", "min", "max"]


def _data(seed, shape=(60, 6), dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.arange(1, shape[1] + 1) + 3.0
    if dtype == np.int16:
        return np.round(x * 1000).astype(np.int16)
    return x.astype(dtype)


def _assert_rolled(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    if not ok.any():
        return
    scale = np.nanmax(np.abs(ref), axis=0)
    err = np.where(ok, np.abs(got - ref), 0.0).max(axis=0)
    assert (err <= tol * scale + 1e-30).all(), err / scale


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("w,s", GEOMETRIES)
def test_rolling_reduce_matches_jax(w, s, op):
    x = _data(w * 10 + s)
    got = rolling_reduce(x, w, s, op, device="cpu")
    ref = jrolling_reduce(x, w, s, op)
    assert got.dtype.is_floating_point and str(got.dtype) == "torch.float32"
    _assert_rolled(got.numpy(), ref, 0.0 if op in ("min", "max")
                   else DEVICE_TOL)
    host = rolling_reduce(x, w, s, op, engine="numpy")
    assert host.dtype == np.float64
    _assert_rolled(host, jrolling_reduce(x, w, s, op, engine="numpy"),
                   HOST_TOL)


@pytest.mark.parametrize("engine", [None, "host"])
def test_rolling_reduce_other_axis_and_int16(engine):
    """Time on axis 1, int16 input (cast to float32 in both)."""
    x = _data(3, shape=(4, 90), dtype=np.int16)
    got = rolling_reduce(x, 9, 4, "mean", axis=1, engine=engine,
                         device="cpu")
    ref = jrolling_reduce(x, 9, 4, "mean", axis=1, engine=engine)
    got = got.numpy() if engine is None else got
    _assert_rolled(got.T, np.asarray(ref).T,
                   DEVICE_TOL if engine is None else HOST_TOL)


def _patches(seed):
    x = _data(seed, shape=(200, 5))
    t = T1 + np.arange(200) * np.timedelta64(10_000_000, "ns")
    coords = {"time": t, "distance": np.arange(5) * 2.0}
    return (Patch(data=x, coords=coords, dims=("time", "distance")),
            JPatch(data=x, coords=coords, dims=("time", "distance")))


@pytest.mark.parametrize("op", OPS + ["std"])
@pytest.mark.parametrize("engine", [None, "numpy"])
def test_patch_rolling_matches_jax(op, engine):
    tp, jp = _patches(11)
    kw = dict(time=0.25, step=0.1, engine=engine)
    got = getattr(tp.rolling(device="cpu", **kw), op)()
    ref = getattr(jp.rolling(**kw), op)()
    assert np.array_equal(got.coords["time"], ref.coords["time"])
    assert got.attrs["time_step"] == ref.attrs["time_step"]
    assert got.attrs["time_min"] == ref.attrs["time_min"]
    tol = (0.0 if op in ("min", "max") else
           DEVICE_TOL if engine is None else HOST_TOL)
    _assert_rolled(got.host_data(), np.asarray(ref.host_data()),
                   tol if op != "std" else 10 * tol)
    # the warm-up prefix, dropped as the reference notebook does
    first = got.dropna("time")
    assert first.coords["time"][0] == ref.coords["time"][3]


def test_patch_rolling_rejects_what_jax_rejects():
    tp, jp = _patches(12)
    for p in (tp, jp):
        with pytest.raises(ValueError, match="shorter than one sample"):
            p.rolling(time=0.001)
        with pytest.raises(ValueError, match="exactly one dim"):
            p.rolling(time=1.0, distance=1.0)


FORMATS = {
    "dasdae": ("dasdae", None),
    "tdas-int16": ("tdas", {"dtype": "int16", "scale": 1e-4}),
}


@pytest.fixture(scope="module", params=sorted(FORMATS))
def raw_dir(request, tmp_path_factory):
    fmt, wk = FORMATS[request.param]
    d = tmp_path_factory.mktemp(f"joint-{request.param}")
    make_synthetic_spool(d, n_files=6, file_duration=30.0, fs=FS, n_ch=6,
                         noise=0.01, format=fmt, write_kwargs=wk)
    return str(d)


CFG = dict(output_sample_interval=1.0, process_patch_size=60,
           edge_buff_size=10, rolling_window=2.0, rolling_step=1.0)


def _joint(cls, sp, out, **kw):
    lfp = cls(sp, **kw)
    lfp.update_processing_parameter(**CFG)
    lfp.set_output_folder(str(out / "lf"), delete_existing=True)
    lfp.set_rolling_output_folder(str(out / "roll"), delete_existing=True)
    lfp.process_time_range(T1, T2)
    return lfp


def test_joint_lf_byte_identical_and_rolling_matches_jax(raw_dir, tmp_path):
    port = _joint(JointProc, tspool(raw_dir).sort("time").update(),
                  tmp_path / "port", device="cpu")
    assert port.rolling_windows == sum(port.engine_counts.values()) == 4
    assert port.staged_windows == 4
    plain = LFProc(tspool(raw_dir).sort("time").update(), device="cpu")
    plain.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=60, edge_buff_size=10)
    plain.set_output_folder(str(tmp_path / "plain"), delete_existing=True)
    plain.process_time_range(T1, T2)
    names = sorted(os.listdir(tmp_path / "plain"))
    assert sorted(os.listdir(tmp_path / "port" / "lf")) == names
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / "lf" / n,
                           tmp_path / "plain" / n, shallow=False)
    _joint(JJointProc, jspool(raw_dir).sort("time").update(), tmp_path / "jax")
    roll = sorted(os.listdir(tmp_path / "port" / "roll"))
    assert roll == sorted(os.listdir(tmp_path / "jax" / "roll"))
    for n in roll:
        a = tspool(str(tmp_path / "port" / "roll" / n))[0]
        b = tspool(str(tmp_path / "jax" / "roll" / n))[0]
        assert np.array_equal(a.coords["time"], b.coords["time"])
        assert a.attrs["time_step"] == b.attrs["time_step"]
        da, db = a.host_data(), b.host_data()
        scale = np.abs(db).max(axis=0)
        assert (np.abs(da - db).max(axis=0) <= JOINT_TOL * scale).all()
    # seam-free, on the run's grid, equal to the float64 trailing mean
    merged = tspool(str(tmp_path / "port" / "roll")).update().chunk(time=None)
    assert len(merged) == 1
    times = merged[0].coords["time"]
    off = (times - T1) / np.timedelta64(1, "s")
    assert np.array_equal(off, np.arange(off[0], off[0] + len(off)))
    raw = tspool(raw_dir).update().chunk(time=None)[0]
    x = raw.host_data().astype(np.float64)
    i = ((times - raw.coords["time"][0]) / np.timedelta64(10, "ms")).astype(int)
    ref = np.stack([x[k - 199 : k + 1].mean(axis=0) for k in i])
    scale = np.abs(x).max(axis=0)
    assert (np.abs(merged[0].host_data() - ref).max(axis=0)
            <= JOINT_TOL * scale).all()


def test_joint_halo_violation_raises_like_jax(raw_dir, tmp_path):
    """A rolling window longer than the edge halo is refused before any
    file is written, in both packages."""
    for cls, sp, kw in (
        (JointProc, tspool(raw_dir).sort("time").update(), {"device": "cpu"}),
        (JJointProc, jspool(raw_dir).sort("time").update(), {}),
    ):
        lfp = cls(sp, **kw)
        lfp.update_processing_parameter(**{**CFG, "rolling_window": 12.0})
        out = tmp_path / cls.__module__.split(".")[0]
        lfp.set_output_folder(str(out / "lf"), delete_existing=True)
        lfp.set_rolling_output_folder(str(out / "roll"), delete_existing=True)
        with pytest.raises(ValueError, match="exceeds the edge halo"):
            lfp.process_time_range(T1, T2)
        assert os.listdir(out / "lf") == [] == os.listdir(out / "roll")
