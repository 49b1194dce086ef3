"""The harness rehearsed on the CPU at a small width: every cell runs
end to end on the plain paths and proves correct; no module of JAX or
of the JAX package is loaded; a new configuration, traffic mix, driver
and metric are taken as files; the TF32 control and the faults a cell
can have come out not correct; a stream's carry is checked and cleared
each replay; and, on a card, a short run of every cell proves
correct."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import control
from portbench import faults
from portbench import run as pb_run
from portbench.harness import cell as cell_mod
from portbench.harness.drivers import DRIVERS, Catchup, load_driver
from portbench.yardstick import reference as ref_mod

ROOT = cell_mod.ROOT
CELLS = ("edge10k.archive", "edge10k-fft.archive", "edge10k.catchup",
         "edge10k-fft.catchup")
SMALL = {"n_ch": 16}
SEED = 2**31 + 17


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_proves_correct(workload, trace):
    result, checks = pb_run.run_cell(workload, SEED, 0.5, trace,
                                     device="cpu", config_overrides=SMALL)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks["missing_outputs"]["value"] == 0
    cell = cell_mod.resolve(workload)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert "breakdown" in result
        assert result["device"]["window_s"] > 0
    else:
        # on the CPU every end-to-end metric but the device trace's
        on_host = {m["name"] for m in wanted if m["source"] != "device_trace"}
        assert "setup_s" in on_host
        assert set(result["metrics"]) == on_host
        assert "busy_s" not in result["device"] and "breakdown" not in result
    assert list(result)[-1] == "checks"


def test_no_jax_module_after_every_cell():
    script = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import run\n"
        f"for w in {CELLS!r}:\n"
        f"    r, _ = run.run_cell(w, 5, 0.2, 1, device='cpu',"
        f" config_overrides={SMALL!r})\n"
        "    assert r['correct'], (w, r)\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
        "print('TORCH_PORT', 'tpudas_torch' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "TORCH_PORT True" in out.stdout


def test_forbidden_names_compare_whole_top_level_names():
    port = ["tpudas_torch", "tpudas_torch.ops.fir", "jaxtyping", "flaxen"]
    assert pb_run.forbidden_modules(port) == []
    assert pb_run.forbidden_modules(port + ["tpudas.proc", "jax._src"]) == [
        "jax", "tpudas"]


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pb_run, "pin_cpus",
                        lambda: sorted(os.sched_getaffinity(0)))
    rc = pb_run.main(["--workload", "edge10k.archive", "--seed", "1",
                      "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def _digest(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "portbench")
    pb = root / "portbench"
    with open(pb / "configs" / "edge10k.json") as fh:
        cfg = json.load(fh)
    cfg.update(name="edge8", n_ch=8, fs_hz=200.0, file_seconds=30.0)
    (pb / "configs" / "edge8.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "archive3.json").write_text(json.dumps(
        {"driver": "archive", "warm_passes": 0}))
    (pb / "limits" / "edge8.archive3.json").write_text(json.dumps(
        {"missing_outputs": 0, "max_rel_err": 1e-5}))
    (pb / "metrics" / "passes_done.py").write_text(
        "def read(ctx):\n    return float(ctx['jobs'])\n")
    (pb / "drivers").mkdir(exist_ok=True)
    (pb / "drivers" / "halfpool.py").write_text(
        "from portbench.harness.drivers import Archive\n\n\n"
        "class Driver(Archive):\n"
        "    \"\"\"Passes over the pool's first file only.\"\"\"\n\n"
        "    def setup(self):\n"
        "        self.pool = dict(self.pool, n_files=1)\n"
        "        self.n_rows = self.pool['rows_file']\n"
        "        super().setup()\n")
    (pb / "traffic" / "halfpool.json").write_text(json.dumps(
        {"driver": "halfpool", "warm_passes": 0}))
    (pb / "limits" / "edge8.halfpool.json").write_text(json.dumps(
        {"missing_outputs": 0, "max_rel_err": 1e-5}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "edge8", "source": "x",
                             "file": "portbench/configs/edge8.json",
                             "reduced": [], "why": "x"})
    new_cells = ["edge8.archive3", "edge8.halfpool"]
    for name in new_cells:
        bench["workloads"].append({"name": name, "config": "edge8",
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "passes_done", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "batch driver",
                               "moves": "archive_rate",
                               "workloads": new_cells})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "archive_rate":
            m["workloads"].extend(new_cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cell_mod.resolve("edge8.archive3", str(root))
    assert cell["config"]["n_ch"] == 8
    assert cell["traffic"]["driver"] == "archive"
    assert [m["name"] for m in cell["per_layer"]] == ["passes_done"]
    result, _ = pb_run.run_cell("edge8.archive3", 3, 0.2, 1, device="cpu",
                                root=str(root))
    assert result["correct"]
    assert result["metrics"]["passes_done"]["value"] >= 1
    cell = cell_mod.resolve("edge8.halfpool", str(root))
    assert cell["traffic"]["driver"] == "halfpool"
    driver = load_driver("halfpool", cell["pb_dir"])
    assert driver.__module__ == "pb_driver_halfpool"
    result, checks = pb_run.run_cell("edge8.halfpool", 3, 0.2, 1,
                                     device="cpu", root=str(root))
    assert result["correct"], checks
    assert result["metrics"]["passes_done"]["value"] >= 1
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_is_not_correct(workload):
    limit = cell_mod.resolve(workload)["limits"]["max_rel_err"]
    for seed in (1, 2, SEED):
        rec = control.control_reading(workload, seed, "cpu",
                                      config_overrides={"n_ch": 64})
        assert rec["max_rel_err"] > limit, rec
        assert not rec["correct"], rec


@pytest.mark.parametrize(
    "workload,fault", [(w, f.__name__) for w, f, _ in faults.FAULTS],
    ids=[f"{w}-_{f.__name__}" for w, f, _ in faults.FAULTS])
def test_a_planted_fault_is_not_correct(workload, fault):
    with faults.planted(fault, workload):
        result, checks = pb_run.run_cell(workload, SEED, 0.2, 0,
                                         device="cpu",
                                         config_overrides=SMALL)
    assert not result["correct"], checks
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", ["edge10k.archive", "edge10k.catchup"])
@pytest.mark.parametrize("seam", ["add_load", "add_write"])
def test_a_bypassed_seam_fails_the_run(monkeypatch, workload, seam):
    """A program that no longer calls ``_load_window`` or
    ``_write_output`` ends the run with no result, not with a metric
    silently dropped."""
    from portbench.harness.program import Probe

    monkeypatch.setattr(Probe, seam, lambda self, *a: None)
    with pytest.raises(RuntimeError, match="bypassed the harness's seams"):
        pb_run.run_cell(workload, SEED, 0.2, 0, device="cpu",
                        config_overrides=SMALL)


def test_a_missing_output_is_not_correct(monkeypatch):
    from tpudas_torch.proc.lfproc import LFProc

    orig = LFProc._emit_window_output
    calls = []

    def drop_one(self, *a, **k):
        calls.append(1)
        if len(calls) == 5:
            return None
        return orig(self, *a, **k)

    monkeypatch.setattr(LFProc, "_emit_window_output", drop_one)
    result, checks = pb_run.run_cell("edge10k.archive", SEED, 0.2, 0,
                                     device="cpu", config_overrides=SMALL)
    assert not result["correct"]
    assert checks["missing_outputs"]["value"] > 0


def test_the_fft_stream_is_checked_block_by_block(monkeypatch):
    """The FFT stream filters block by block, so one window over the
    whole span is not what it computes.  With a 5 s edge buffer, where
    the response's tail past the buffer is large, the whole-span
    reference fails the stream's outputs and the block schedule
    (``stream_segments``) passes them."""
    small = dict(SMALL, edge_buffer=5.0)
    result, checks = pb_run.run_cell("edge10k-fft.catchup", SEED, 0.2, 0,
                                     device="cpu", config_overrides=small)
    assert result["correct"], checks
    real = ref_mod.load_engine_reference

    def whole_span(name, pb_dir=ref_mod.PB_DIR):
        mod = real(name, pb_dir)
        del mod.stream_segments
        return mod

    monkeypatch.setattr(ref_mod, "load_engine_reference", whole_span)
    result, whole = pb_run.run_cell("edge10k-fft.catchup", SEED, 0.2, 0,
                                    device="cpu", config_overrides=small)
    assert not result["correct"]
    assert whole["missing_outputs"]["value"] == 0
    assert whole["max_rel_err"]["value"] > 10 * whole["max_rel_err"]["limit"]


@pytest.mark.parametrize("workload", ["edge10k.catchup",
                                      "edge10k-fft.catchup"])
def test_a_sound_replay_keeps_only_its_outputs(tmp_path, workload):
    import torch

    from portbench.harness.program import Probe
    from portbench.yardstick import datagen

    cell = cell_mod.resolve(workload)
    cfg = dict(cell["config"], **SMALL)
    cpu = torch.device("cpu")
    pool = datagen.make_pool(cfg, SEED, str(tmp_path / "pool"), cpu)
    driver = Catchup(cfg, cell["traffic"], pool, cpu, str(tmp_path),
                     Probe())
    try:
        driver.setup()
        driver.window(0.0, False)
    finally:
        driver.close()
    assert len(driver.folders) == 1
    for folder in [str(tmp_path / "out_warm0")] + driver.folders:
        names = os.listdir(folder)
        assert names and all(n.startswith("LFDAS_") for n in names), names


@pytest.mark.parametrize("fault", ["missing", "older"])
def test_a_replay_that_breaks_the_commit_order_ends_the_run(monkeypatch,
                                                            fault):
    """A replay whose folder lacks the stream's carry, or holds one last
    written before its newest output, ends the run with no result."""
    from tpudas_torch.proc import stream

    orig = stream.save_carry

    def save_carry(carry, folder):
        path = os.path.join(folder, stream.CARRY_FILENAME)
        if fault == "older":
            orig(carry, folder)
            st = os.stat(path)
            os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns - 10**10))
        return path

    monkeypatch.setattr(stream, "save_carry", save_carry)
    with pytest.raises(RuntimeError, match="commit order"):
        pb_run.run_cell("edge10k-fft.catchup", SEED, 0.2, 0, device="cpu",
                        config_overrides=SMALL)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_proves_correct_on_the_card(card, workload):
    result, checks = pb_run.run_cell(workload, 77, 3.0, 0, device=card)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {
        m["name"] for m in cell_mod.resolve(workload)["end_to_end"]}


def test_benchmark_file_names_its_files():
    bench = _bench()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = cell_mod.resolve(w["name"])
        name = cell["traffic"]["driver"]
        assert name in DRIVERS or os.path.isfile(os.path.join(
            ROOT, "portbench", "drivers", f"{name}.py"))
        assert hasattr(load_driver(name), "due")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(cell_mod.load_reader(m["name"]), "read")
    np.testing.assert_equal(sorted(os.listdir(os.path.join(
        ROOT, "portbench", "limits"))),
        sorted(f"{w['name']}.json" for w in bench["workloads"]))
