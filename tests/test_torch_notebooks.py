"""The repo's four notebooks, unmodified, on the port.

``python -m tpudas_torch.tools.notebooks`` executes every code cell of
``notebooks/*.ipynb`` in one fresh interpreter with ``dascore``,
``lf_das`` and ``tpudas.*`` resolved to the port (``--device cpu``:
the cells pass no device; the edge notebooks poll at their own 0.5 s,
not at the reference's 125 s cadence clamp), at the
JAX notebook test's configuration (``tests/test_notebooks.py``: 8
channels, 100 Hz, ``TPUDAS_NB_POLL=0.5``).  Every cell must run and
``jax`` must stay unimported.  The outputs are then held to the JAX
package on the same synthetic spools:

- the batch notebooks' folders (``LFProc``; the rolling mean): the same
  file names, data within 1e-5 of each channel's scale;
- the edge notebooks poll on the wall clock, so their round splits (and
  how much of the feed a run sees) differ from run to run: their merged
  output is held to the JAX runner over the same raw folder on the
  common interior, within 1e-4 of the maximum (the stream-vs-batch bound
  of ``tests/test_stream_state.py:148``).

Two examples run through ``--script`` at their smallest arguments.  The
JAX notebooks themselves are not run here (``tests/test_notebooks.py``,
``slow``).
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = [
    "low_pass_tpudas.ipynb",
    "rolling_mean_tpudas.ipynb",
    "low_pass_tpudas_edge.ipynb",
    "rolling_mean_tpudas_edge.ipynb",
]
NB_ENV = {"TPUDAS_NB_NCH": "8", "TPUDAS_NB_FS": "100.0",
          "TPUDAS_NB_POLL": "0.5"}
REL_TOL = 1e-5
STREAM_TOL = 1e-4


def _runner(args, timeout=240, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    out = subprocess.run(
        [sys.executable, "-m", "tpudas_torch.tools.notebooks", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    return lines


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One runner process over the four notebooks; returns (workdir,
    {notebook: line}, import check)."""
    wd = str(tmp_path_factory.mktemp("nb"))
    lines = _runner(
        [*(os.path.join("notebooks", n) for n in NOTEBOOKS), "--device",
         "cpu", "--workdir", wd, "--out",
         os.path.join(wd, "report.json")], env_extra=NB_ENV)
    by_nb = {ln["notebook"]: ln for ln in lines if "notebook" in ln}
    (last,) = [ln for ln in lines if "imports" in ln]
    assert last["h5_format"] == "dasdae"  # h5py is installed here
    return wd, by_nb, last["imports"]


def _folder(wd, nb, sub):
    return os.path.join(wd, os.path.splitext(nb)[0], sub)


def _assert_close(a, b, tol=REL_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert (np.isnan(a) == np.isnan(b)).all()
    scale = np.nanmax(np.abs(b), axis=0)
    diff = np.nanmax(np.abs(a - b), axis=0)
    assert (diff <= tol * scale).all(), (diff / scale).max()


def test_every_cell_runs_without_jax(run):
    _wd, by_nb, check = run
    assert sorted(by_nb) == sorted(NOTEBOOKS)
    for nb, line in by_nb.items():
        assert line["cells_run"] == line["cells"] > 0, nb
        assert line["cells_without_matplotlib"] == [], nb
        # the CPU runs the plain versions: no kernel launch
        assert line["launches"] == {"fir_decimate": 0, "fused_cascade": 0}
        assert line["outputs"], nb
        assert line["wall_s"] > 0
    assert check == {"jax_imported": False, "aliases": check["aliases"],
                     "not_aliases": []}
    assert check["aliases"] >= 5  # tpudas, tpudas.testing, tpudas.io...
    report = json.load(open(os.path.join(_wd, "report.json")))
    assert report["imports"] == check and report["device"] == "cpu"


def _jax_low_pass(raw, out):
    """low_pass_tpudas.ipynb cells 2-5 through the JAX package's shims."""
    import dascore as dc
    from lf_das import LFProc, get_edge_effect_time, get_patch_time

    sp = dc.spool(raw).sort("time").update()
    content_df = sp.get_contents()
    patch0 = sp[0]
    d_time = patch0.attrs["time_step"] / np.timedelta64(1, "s")
    num_ch = len(patch0.coords["distance"])
    patch_length = get_patch_time(2000, 1.0 / d_time, num_ch)
    edge_buffer = get_edge_effect_time(
        sampling_interval=d_time, total_T=min(patch_length, 120.0),
        tol=1e-3, freq=1.0)
    lfp = LFProc(sp)
    lfp.update_processing_parameter(
        output_sample_interval=1.0, process_patch_size=60,
        edge_buff_size=max(10, int(np.ceil(edge_buffer))))
    lfp.set_output_folder(out, delete_existing=True)
    lfp.process_time_range(np.datetime64(str(content_df["time_min"].min())),
                           np.datetime64(str(content_df["time_max"].max())))


def _jax_rolling(raw, out):
    """rolling_mean_tpudas.ipynb cells 2-3 through the JAX shims."""
    import dascore as dc
    from dascore.units import s
    from lf_das import _get_filename

    os.makedirs(out, exist_ok=True)
    sp = dc.spool(raw).sort("time").update()
    d_time = sp[0].attrs["d_time"] / np.timedelta64(1, "s")
    scale_iDAS = 116 * (1.0 / d_time) / 10.0 / 1e9
    for patch in sp:
        rolled = patch.rolling(time=1.0 * s, step=1.0 * s,
                               engine="numpy").mean()
        rolled = rolled.new(data=np.asarray(rolled.data) * scale_iDAS)
        fname = _get_filename(rolled.attrs["time_min"],
                              rolled.attrs["time_max"])
        rolled.io.write(os.path.join(out, fname), "dasdae")


def _h5_names(folder):
    return sorted(n for n in os.listdir(folder) if n.endswith(".h5"))


@pytest.mark.parametrize("nb,sub,jax_run", [
    ("low_pass_tpudas.ipynb", "results", _jax_low_pass),
    ("rolling_mean_tpudas.ipynb", "rolling_results", _jax_rolling),
])
def test_batch_notebook_outputs_match_jax(run, tmp_path, nb, sub, jax_run):
    import dascore as dc

    wd, _by_nb, _check = run
    port_out = _folder(wd, nb, sub)
    jout = str(tmp_path / "jax")
    jax_run(_folder(wd, nb, "raw"), jout)
    names = _h5_names(jout)
    assert names and _h5_names(port_out) == names
    for n in names:
        a = dc.spool(os.path.join(port_out, n))[0]
        b = dc.spool(os.path.join(jout, n))[0]
        assert np.array_equal(np.asarray(a.coords["time"]),
                              np.asarray(b.coords["time"])), n
        _assert_close(a.data, b.data)


def _link_raw(raw, dst):
    os.makedirs(dst)
    for n in os.listdir(raw):
        if n.endswith(".h5"):
            os.link(os.path.join(raw, n), os.path.join(dst, n))
    return dst


def _jax_edge_low_pass(raw, out):
    from lf_das import get_edge_effect_time
    from tpudas.proc.streaming import run_lowpass_realtime

    edge_buffer = get_edge_effect_time(
        sampling_interval=1 / 100.0, total_T=60.0, tol=1e-3, freq=1.0)
    run_lowpass_realtime(
        source=raw, output_folder=out, start_time="2023-03-22T00:00:00",
        output_sample_interval=1.0, edge_buffer=edge_buffer,
        process_patch_size=60, poll_interval=0.5, file_duration=0.0,
        sleep_fn=lambda _s: None)


def _jax_edge_rolling(raw, out):
    from tpudas.proc.streaming import run_rolling_realtime

    run_rolling_realtime(
        source=raw, output_folder=out, window=1.0, step=1.0,
        scale=116 * 100.0 / 10.0 / 1e9, poll_interval=0.5,
        sleep_fn=lambda _s: None)


@pytest.mark.parametrize("nb,sub,jax_run,dropna", [
    ("low_pass_tpudas_edge.ipynb", "edge_results", _jax_edge_low_pass, False),
    ("rolling_mean_tpudas_edge.ipynb", "edge_rolling_results",
     _jax_edge_rolling, True),
])
def test_edge_notebook_output_matches_jax_on_the_common_interior(
        run, tmp_path, nb, sub, jax_run, dropna):
    import dascore as dc

    wd, _by_nb, _check = run
    jout = str(tmp_path / "jax")
    jax_run(_link_raw(_folder(wd, nb, "raw"), str(tmp_path / "raw")), jout)

    def merged(folder):
        (patch,) = dc.spool(folder).update().chunk(time=None)
        if dropna:
            patch = patch.dropna("time")
        return (np.asarray(patch.coords["time"]).astype("datetime64[ns]"),
                np.asarray(patch.data, np.float64))

    (pt, pd), (jt, jd) = merged(_folder(wd, nb, sub)), merged(jout)
    common, ip, ij = np.intersect1d(pt, jt, return_indices=True)
    # one output grid: the overlap of the two runs is their common
    # samples, and the port's run saw at least the first 8 files
    lo, hi = max(pt[0], jt[0]), min(pt[-1], jt[-1])
    assert np.array_equal(common, pt[(pt >= lo) & (pt <= hi)])
    assert np.array_equal(common, jt[(jt >= lo) & (jt <= hi)])
    assert common.size >= 200
    diff = np.abs(pd[ip] - jd[ij]).max()
    assert diff <= STREAM_TOL * np.abs(jd[ij]).max(), diff


@pytest.mark.parametrize("script,args", [
    ("batch_low_pass.py", ["--quick", "--fs", "100", "--n-ch", "8"]),
    ("edge_low_pass.py", ["--fs", "50", "--n-ch", "4", "--extra-files", "1"]),
])
def test_examples_run_on_the_port(tmp_path, script, args):
    lines = _runner(["--script", os.path.join("examples", script),
                     "--device", "cpu", "--",
                     "--workdir", str(tmp_path), *args])
    (line,) = [ln for ln in lines if "script" in ln]
    (check,) = [ln["imports"] for ln in lines if "imports" in ln]
    assert line["script"] == script and line["argv"][-len(args):] == args
    assert check["jax_imported"] is False and check["not_aliases"] == []
    assert line["launches"] == {"fir_decimate": 0, "fused_cascade": 0}
    results = os.path.join(str(tmp_path), "results")
    names = _h5_names(results)
    assert names and all(n.startswith("LFDAS_") for n in names)
