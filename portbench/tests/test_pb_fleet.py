"""The multi-well cell ``multiwell50k.catchup`` rehearsed on the CPU at a
small size: a batched fleet of one member a well, every member step
stacked, checked well by well against its own data.  Two wells' results
swapped where the stacked step hands them back, every well given the
same files, and the reference in TF32 each come out not correct; the
two fleet readers find nothing where the program recorded nothing."""

import os
import subprocess
import sys

import pytest

from portbench import control
from portbench import run as pb_run
from portbench.harness import cell as cell_mod
from portbench.harness.drivers import Catchup, load_driver
from portbench.yardstick import datagen

ROOT = cell_mod.ROOT
CELL = "multiwell50k.catchup"
# 32 ch a well, 20 s files, two stream steps a well's round
SMALL = {"n_ch": 32, "file_seconds": 20.0, "process_patch_size": 20}
SEED = 2**31 + 41


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_proves_correct_and_every_step_stacks(trace):
    result, checks = pb_run.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                                     config_overrides=SMALL)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks["missing_outputs"]["value"] == 0
    m = result["metrics"]
    if trace:
        assert m["stacked_share"]["value"] == 100.0
        assert m["rendezvous_ms"]["value"] > 0
        for name in ("read_decode_ms", "round_h2d_ms"):
            assert m[name]["value"] > 0
    else:
        assert set(m) == {"stream_rate", "setup_s"}


def _swap_two(fn):
    def swapped(*a, **k):
        out = fn(*a, **k)
        if len(out) >= 2:
            out[0], out[1] = out[1], out[0]
        return out
    return swapped


def _swap_carries(fn):
    def swapped(*a, **k):
        out = fn(*a, **k)
        if len(out) >= 2:
            (y0, c0), (y1, c1) = out[0], out[1]
            out[0], out[1] = (y0, c1), (y1, c0)
        return out
    return swapped


@pytest.mark.parametrize("fault", [_swap_two, _swap_carries],
                         ids=["results", "carries"])
def test_two_wells_swapped_at_the_unpacking_is_not_correct(monkeypatch,
                                                           fault):
    from tpudas_torch.ops import fir

    monkeypatch.setattr(fir, "cascade_decimate_stream_stacked",
                        fault(fir.cascade_decimate_stream_stacked))
    result, checks = pb_run.run_cell(CELL, SEED, 0.2, 0, device="cpu",
                                     config_overrides=SMALL)
    assert not result["correct"], checks
    assert checks["missing_outputs"]["value"] == 0
    assert checks["max_rel_err"]["value"] > 10 * checks["max_rel_err"][
        "limit"]


def test_every_well_on_the_same_files_misses_outputs(monkeypatch):
    from portbench.harness import drivers

    real_load = drivers.load_driver

    def load(name, pb_dir=drivers.PB_DIR):
        cls = real_load(name, pb_dir)
        glob = cls._replay.__globals__
        real = glob["well_files"]
        glob["well_files"] = lambda pool, wells, k: real(pool, wells, 0)
        return cls

    monkeypatch.setattr(drivers, "load_driver", load)
    result, checks = pb_run.run_cell(CELL, SEED, 0.2, 0, device="cpu",
                                     config_overrides=SMALL)
    assert not result["correct"]
    assert checks["missing_outputs"]["value"] > 0


def test_each_wells_segment_is_a_single_stream_shifted():
    cell = cell_mod.resolve(CELL)
    cfg = cell["config"]
    pool = datagen.describe(cfg, SEED)
    wells = load_driver("fleet_catchup").due(cfg, pool, cell["traffic"])
    single = dict(cfg, reference="cascade", pool_files=2)
    (one,) = Catchup.due(single, datagen.describe(single, SEED),
                         cell_mod.resolve("edge10k.catchup")["traffic"])
    assert len(wells) == cfg["wells"] == 5
    rows = 2 * pool["rows_file"]
    for k, (r0, r1, grid) in enumerate(wells):
        assert (r0, r1) == (one[0] + k * rows, one[1] + k * rows)
        assert grid == [g + k * 120 for g in one[2]]
    grids = [g for _r0, _r1, grid in wells for g in grid]
    assert len(set(grids)) == len(grids)


def test_the_tf32_control_is_not_correct():
    limit = cell_mod.resolve(CELL)["limits"]["max_rel_err"]
    for seed in (1, SEED):
        rec = control.control_reading(CELL, seed, "cpu",
                                      config_overrides=dict(SMALL, n_ch=64))
        assert rec["max_rel_err"] > limit, rec
        assert not rec["correct"], rec


def test_no_jax_module_after_the_cell():
    script = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import run\n"
        f"r, _ = run.run_cell({CELL!r}, 5, 0.2, 1, device='cpu',"
        f" config_overrides={SMALL!r})\n"
        "assert r['correct'], r\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


# the two fleet readers


def _read(name, reg):
    return cell_mod.load_reader(name).read({"registry": reg})


def test_the_fleet_readers_find_nothing_without_the_programs_records():
    from tpudas_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    for name in ("rendezvous_ms", "stacked_share"):
        assert _read(name, reg) is None
    # a program with no rendezvous span (one before it was added) and
    # the round phases recorded
    reg.histogram("tpudas_stream_round_phase_seconds",
                  labelnames=("phase",)).observe(0.5, phase="host_wait")
    reg.histogram("tpudas_span_seconds", labelnames=("name",)).observe(
        0.1, name="stream.h2d")
    assert _read("rendezvous_ms", reg) is None
    reg.counter("tpudas_fleet_batch_solo_launches_total")
    assert _read("stacked_share", reg) is None


def test_the_fleet_readers_read_a_seeded_registry():
    from tpudas_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    phases = reg.histogram("tpudas_stream_round_phase_seconds",
                           labelnames=("phase",))
    for _ in range(4):
        phases.observe(1.0, phase="host_wait")
    spans = reg.histogram("tpudas_span_seconds", labelnames=("name",))
    for s in (0.25, 0.5, 0.125, 0.125):
        spans.observe(s, name="fleet.rendezvous")
    spans.observe(9.0, name="stream.h2d")
    assert _read("rendezvous_ms", reg) == pytest.approx(250.0)
    reg.counter("tpudas_fleet_batch_stacked_members_total").inc(10)
    assert _read("stacked_share", reg) == 100.0
    reg.counter("tpudas_fleet_batch_solo_launches_total").inc(5)
    assert _read("stacked_share", reg) == pytest.approx(200.0 / 3)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_the_cell_proves_correct_on_the_card(card):
    result, checks = pb_run.run_cell(CELL, 78, 3.0, 1, device=card)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["stacked_share"]["value"] == 100.0
    assert set(result["metrics"]) == {
        m["name"] for m in cell_mod.resolve(CELL)["per_layer"]}
