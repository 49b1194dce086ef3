"""The names the port lacked beside the JAX package's public signatures,
held to the JAX package: ``tpudas_torch.testing``'s fault harness and
helpers, ``register_format``, ``DirectoryIndex.to_dataframe``,
``DirectorySpool.native_window_plan``, ``chunk(overlap=)``,
``StreamConfig.fields_for_kind``, ``BatchGroupFormer.clear``,
``Counters.add_measured``, and the JAX parameter orders of
``chain_layout`` / ``stage_engines`` / ``shift_to_phase``."""

import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pandas as pd
import pytest
import torch

import tpudas.io.registry as jregistry
import tpudas.testing as jtesting
import tpudas_torch.io.registry as tregistry
import tpudas_torch.testing as ttesting

T0 = "2023-03-22T00:00:00"


# ---------------------------------------------------------------------------
# tpudas_torch.testing


def test_testing_exports_the_jax_names():
    assert sorted(ttesting.__all__) == sorted(jtesting.__all__)
    from tpudas_torch.resilience import faults

    for name in ("FAULT_SITES", "FaultPlan", "FaultSpec",
                 "TransientFaultError", "install_fault_plan"):
        assert getattr(ttesting, name) is getattr(faults, name)
    assert ttesting.FAULT_SITES == jtesting.FAULT_SITES


@pytest.mark.parametrize("lf_freq", [0.05, 1.3])
def test_lowfreq_truth_equals_jax(lf_freq):
    times = (np.datetime64(T0, "ns")
             + np.arange(0, 10**10, 7 * 10**7).astype("timedelta64[ns]"))
    dists = np.arange(11, dtype=np.float64) * 5.0
    want = jtesting.lowfreq_truth(times, dists, lf_freq=lf_freq)
    got = ttesting.lowfreq_truth(times, dists, lf_freq=lf_freq)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("nbytes,seed", [(512, 0), (97, 3), (4, 1)])
def test_write_corrupt_file_bytes_equal_jax(tmp_path, nbytes, seed):
    a = jtesting.write_corrupt_file(str(tmp_path / "j.h5"), nbytes, seed)
    b = ttesting.write_corrupt_file(str(tmp_path / "t.h5"), nbytes, seed)
    assert b == str(tmp_path / "t.h5")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert tregistry.sniff_format(b) == jregistry.sniff_format(a) == "dasdae"


def test_enospc_error_equals_jax():
    for args in ((), ("disk full",)):
        j, t = jtesting.enospc_error(*args), ttesting.enospc_error(*args)
        assert type(t) is type(j) and t.args == j.args
        assert t.errno == j.errno


def test_fault_harness_through_testing_fires(tmp_path):
    """A ``FaultSpec`` built from ``tpudas_torch.testing``'s names fires
    at the port's ``fs.write_enospc`` site with the ENOSPC error."""
    from tpudas_torch.utils.atomicio import atomic_write_text

    plan = ttesting.FaultPlan(ttesting.FaultSpec(
        "fs.write_enospc", exc=ttesting.enospc_error(), times=1))
    with ttesting.install_fault_plan(plan):
        with pytest.raises(OSError) as err:
            atomic_write_text(str(tmp_path / "x.txt"), "x")
    assert err.value.errno == 28 and plan.fired


# ---------------------------------------------------------------------------
# io


@pytest.fixture
def toy_format(monkeypatch):
    """A toy format (magic ``TOYF`` + the array's ``.npy`` bytes)
    registered in both packages; the registries are restored after."""
    import io

    for reg in (jregistry, tregistry):
        monkeypatch.setattr(reg, "_FORMATS", dict(reg._FORMATS))
        monkeypatch.setattr(reg, "_SNIFFERS", list(reg._SNIFFERS))

    def write(arr, path, **_kw):
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr))
        with open(path, "wb") as fh:
            fh.write(b"TOYF" + buf.getvalue())

    def read(path, **_kw):
        with open(path, "rb") as fh:
            return [np.load(io.BytesIO(fh.read()[4:]))]

    def scan(path):
        return {"path": str(path), "format": "toy"}

    for reg in (jregistry, tregistry):
        reg.register_format("TOY", read, write, scan,
                            sniff=lambda head: head[:4] == b"TOYF")
    return write


def test_register_format_round_trips_in_both_packages(tmp_path, toy_format):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = {}
    for name, reg in (("jax", jregistry), ("port", tregistry)):
        path = str(tmp_path / f"{name}.toy")
        reg.write_patch(arr, path, format="toy")
        assert reg.sniff_format(path) == "toy"
        (back,) = reg.read_file(path)
        assert np.array_equal(back, arr)
        assert reg.scan_file(path) == {"path": path, "format": "toy"}
        with open(path, "rb") as fh:
            got[name] = fh.read()
        # re-registering replaces the sniffer, not adds a second one
        reg.register_format("toy", *reg._FORMATS["toy"],
                            sniff=lambda head: head[:4] == b"TOYF")
        assert [n for n, _p in reg._SNIFFERS].count("toy") == 1
    assert got["jax"] == got["port"]
    assert sorted(tregistry._FORMATS) == sorted(jregistry._FORMATS)


@pytest.fixture(scope="module")
def tdas_spool(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("restored-tdas"))
    jtesting.make_synthetic_spool(d, n_files=3, file_duration=4.0, fs=50.0,
                                  n_ch=6, format="tdas")
    return d


def test_to_dataframe_equals_jax(tdas_spool, tmp_path):
    from tpudas.io.index import DirectoryIndex as JIndex
    from tpudas_torch.io.index import DirectoryIndex as TIndex

    want = JIndex(tdas_spool).update().to_dataframe()
    got = TIndex(tdas_spool).update().to_dataframe()
    assert len(got) == 3
    pd.testing.assert_frame_equal(
        got.sort_values("path").reset_index(drop=True),
        want.sort_values("path").reset_index(drop=True))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    pd.testing.assert_frame_equal(TIndex(empty).update().to_dataframe(),
                                  JIndex(empty).update().to_dataframe())


def _spool_modules():
    """The two ``io/spool.py`` modules (each ``io`` package's ``spool``
    attribute is the function)."""
    import importlib

    return (importlib.import_module("tpudas.io.spool"),
            importlib.import_module("tpudas_torch.io.spool"))


def _plan_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for key in a:
        if key == "segments":
            assert [tuple(s) for s in a[key]] == [tuple(s) for s in b[key]]
        else:
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


@pytest.mark.parametrize("window,distance", [
    ((1.0, 9.5), None),
    ((0.0, 3.98), (5.0, 20.0)),
    ((2.5, 11.0), None),
])
def test_native_window_plan_equals_jax(tdas_spool, window, distance):
    jspool, tspool = _spool_modules()

    t0 = np.datetime64(T0, "ns")
    lo, hi = (t0 + np.timedelta64(int(s * 1e9), "ns") for s in window)
    plans = []
    for mod in (jspool, tspool):
        sp = mod.spool(tdas_spool).update()
        if distance is not None:
            sp = sp.select(distance=distance)
        plans.append(sp.native_window_plan(lo, hi))
    assert plans[0] is not None
    _plan_equal(plans[1], plans[0])


def test_native_window_plan_none_where_jax_is_none(tmp_path):
    jspool, tspool = _spool_modules()

    d = str(tmp_path / "h5")
    jtesting.make_synthetic_spool(d, n_files=2, file_duration=4.0, fs=50.0,
                                  n_ch=4)
    t0 = np.datetime64(T0, "ns")
    lo, hi = t0, t0 + np.timedelta64(6, "s")
    assert jspool.spool(d).update().native_window_plan(lo, hi) is None
    assert tspool.spool(d).update().native_window_plan(lo, hi) is None


@pytest.mark.parametrize("overlap", [None, 0, 2.0])
def test_chunk_accepts_overlap(tdas_spool, overlap):
    _jspool, tspool = _spool_modules()
    sp = tspool.spool(tdas_spool).update()
    want = sp.chunk(time=None)
    got = sp.chunk(time=None, overlap=overlap)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0].host_data(), want[0].host_data())
    # positionally, as DASCore's chunk(time, overlap) takes them
    assert len(sp.chunk(None, overlap)) == 1


# ---------------------------------------------------------------------------
# fleet, profiling


@pytest.mark.parametrize("kw", [
    dict(kind="lowpass", start_time=T0, output_sample_interval=1.0,
         edge_buffer=5.0, process_patch_size=20),
    dict(kind="rolling", window=2.0, step=1.0),
])
def test_fields_for_kind_equals_jax(kw):
    from tpudas.fleet import config as jconfig
    from tpudas_torch.fleet import config as tconfig

    got = tconfig.StreamConfig(**kw).fields_for_kind()
    assert got == jconfig.StreamConfig(**kw).fields_for_kind()
    for name in ("COMMON_FIELDS", "LOWPASS_ONLY_FIELDS", "ROLLING_ONLY_FIELDS",
                 "LOWPASS_FIELDS", "ROLLING_FIELDS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    fields = {f for f in tconfig.StreamConfig.__dataclass_fields__}
    assert set(got) <= fields


def test_batch_group_former_clear():
    from tpudas_torch.fleet.batch import BatchGroupFormer

    former = BatchGroupFormer()
    former._memo.update(a=1, b=2)
    former.invalidate("a")
    assert former._memo == {"b": 2}
    former.clear()
    assert former._memo == {}


def test_add_measured_equals_jax():
    from tpudas.obs.registry import MetricsRegistry as JReg
    from tpudas.obs.registry import use_registry as juse
    from tpudas.utils.profiling import Counters as JCounters
    from tpudas_torch.obs.registry import MetricsRegistry as TReg
    from tpudas_torch.obs.registry import use_registry as tuse
    from tpudas_torch.utils.profiling import Counters as TCounters

    out = []
    for reg_cls, use, counters in ((JReg, juse, JCounters),
                                   (TReg, tuse, TCounters)):
        reg = reg_cls()
        with use(reg):
            c = counters()
            c.add_measured(1000, 2.5, 0.25)
            c.add_measured(500, 1.0, 0.5)
        out.append((c.channel_samples, c.data_seconds, c.wall_seconds,
                    c.last_wall,
                    reg.value("tpudas_proc_channel_samples_total"),
                    reg.value("tpudas_proc_data_seconds_total"),
                    reg.value("tpudas_proc_wall_seconds_total")))
    assert out[0] == out[1] == (1500, 3.5, 0.75, 0.5, 1500, 3.5, 0.75)


# ---------------------------------------------------------------------------
# ops: the JAX parameter orders


def test_chain_layout_takes_the_jax_positionals():
    from tpudas.ops import fir as jfir
    from tpudas_torch.ops import fir as tfir

    plan = jfir.design_cascade(100.0, 20, 0.45, 4)
    tplan = tfir.design_cascade(100.0, 20, 0.45, 4)
    (lt, rows_t) = tfir.chain_layout(tplan, 50, 16, "torch", device="cpu")
    (lj, rows_j) = jfir.chain_layout(plan, 50, 16, "xla")
    assert rows_t == rows_j
    assert [k for _e, k in lt] == [k for _e, k in lj]
    assert tfir.stage_engines(tplan, 50, 16, "torch", device="cpu") == [
        "torch"] * len(tplan.stages)
    with pytest.raises(TypeError):  # device stays a keyword
        tfir.chain_layout(tplan, 50, 16, "torch", "cpu")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("phase", [2, 9, 5])
def test_shift_to_phase_axis_equals_jax(axis, phase):
    from tpudas.ops import fir as jfir
    from tpudas_torch.ops import fir as tfir

    x = np.random.default_rng(phase).standard_normal((12, 7)).astype(
        np.float32)
    want = np.asarray(jfir.shift_to_phase(x, phase, 5, axis=axis))
    got = tfir.shift_to_phase(torch.from_numpy(x), phase, 5, axis=axis)
    assert np.array_equal(got.numpy(), want)
