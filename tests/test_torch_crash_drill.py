"""The port's SIGKILL crash drill (tpudas_torch/tools/crash_drill.py).

Real SIGKILLs of fresh worker interpreters at seeded points, on the CPU
(the plain versions of the kernels), with the stateful carry, the
detect operators, the tile pyramid, the health files and the flight
recorder on: right after the kills the flight ring must replay the last
committed round (all its phases, its ``stream.round`` span), after the
drain the folder must audit clean, no worker's startup audit may have
raised, and the outputs, the stream carry, the pyramid tree and the
detect state must equal an uninterrupted control's
(``tests/test_integrity.py`` holds the JAX drill the same way).  Every
wait of the drill carries its own limit (``ready_timeout`` /
``run_timeout``), so a hung worker fails the test instead of holding
it.  The tier-1 smoke is 2 cycles under ``engine="fused"``; the ``slow``
cases drill each engine longer and the batched fleet.
"""

import os

import pytest

from tpudas_torch.tools.crash_drill import run_drill, run_fleet_drill

LIMITS = dict(device="cpu", ready_timeout=60.0, run_timeout=60.0)


def _assert_drill_ok(rep):
    assert rep["kills"] >= 1, rep["cycle_log"]
    assert rep["audit_clean"] and rep["audit_issues"] == 0
    assert rep["audit_errors"] == 0
    for key in ("outputs_match", "carry_match", "pyramid_match",
                "detect_match"):
        assert rep[key], (key, rep["difference"])
    assert rep["detect_events"] > 0  # the comparison is not vacuous
    assert rep["pyramid_files"] > 0
    assert rep["pyramid_errors"] == rep["control_pyramid_errors"] == 0
    # the flight ring as the kills left it: the last committed round's
    # record with every phase, preceded by its stream.round span
    flight = rep["flight"]
    assert flight["ok"] and flight["phases_complete"], flight
    assert flight["rounds"] >= 2 and flight["last_round_spans"] >= 1
    assert set(rep["flight_repairs"]) <= {"truncated", "removed"}
    assert rep["ok"]
    assert rep["launches"] == {"fused_cascade": 0,
                               "fused_cascade_kernels": 0,
                               "fir_decimate": 0}  # plain versions only
    assert all(r >= 0 for r in rep["recover_s"])


def _completed_tiles(rep, suffix):
    tiles = os.path.join(rep["workdir"], "out", ".tiles", "L1")
    return [n for n in os.listdir(tiles) if n.endswith(suffix)]


def test_sigkill_drill_smoke(tmp_path, monkeypatch):
    # 8-row tiles: the stream completes tiles, so a kill can land in a
    # tile write
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    rep = run_drill(engine="fused", cycles=2, seed=0,
                    workdir=str(tmp_path / "drill"), **LIMITS)
    _assert_drill_ok(rep)
    assert _completed_tiles(rep, ".npy")
    assert rep["epochs"] >= 3
    assert len(rep["audit_seconds"]) == 2 + 2 + 1  # one per drilled worker
    # one fresh worker per cycle (cold, warm, kills, drain, the control's
    # epochs), every one started before its task and stopped after it
    logs = os.path.join(rep["workdir"], "logs")
    tasks = [d for d in os.listdir(logs)
             if os.path.isfile(os.path.join(logs, d, "go.json"))]
    assert len(tasks) == 2 + 2 + 1 + rep["epochs"]
    assert all(s > 0 for s in rep["worker_start_s"])


def test_sigkill_drill_mesh_smoke(tmp_path, monkeypatch):
    """The ``--mesh`` drill under the fused engine (the JAX package's
    ``test_smoke_fused_mesh_drill``): seeded SIGKILL cycles on the
    channel-sharded stream (2 logical CPU shards, 4 channels: 2 a
    shard) end audit-clean and equal to the single-device control."""
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    rep = run_drill(engine="fused", cycles=2, seed=7, mesh=2,
                    workdir=str(tmp_path / "drill"), **LIMITS)
    assert rep["mesh"] == 2
    _assert_drill_ok(rep)


def test_sigkill_drill_compressed_pyramid(tmp_path, monkeypatch):
    """The drill under a compressed store (workers and control alike):
    the ``.tpt`` tiles match file for file."""
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    monkeypatch.setenv("TPUDAS_CODEC", "bitshuffle-deflate")
    rep = run_drill(engine="auto", cycles=2, seed=3,
                    workdir=str(tmp_path / "drill"), **LIMITS)
    _assert_drill_ok(rep)
    assert _completed_tiles(rep, ".tpt")


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["fused", "auto", "fft"])
def test_sigkill_drill_each_engine(tmp_path, engine):
    rep = run_drill(engine=engine, cycles=6, seed=1,
                    workdir=str(tmp_path / "drill"), **LIMITS)
    _assert_drill_ok(rep)


@pytest.mark.slow
def test_sigkill_drill_async_ingest(tmp_path):
    rep = run_drill(engine="fused", cycles=4, seed=2, async_ingest=True,
                    workdir=str(tmp_path / "drill"), **LIMITS)
    _assert_drill_ok(rep)


@pytest.mark.slow
def test_sigkill_fleet_drill_batched(tmp_path):
    rep = run_fleet_drill(engine="fused", streams=2, batched=True, cycles=4,
                          seed=0, workdir=str(tmp_path / "fleet"), **LIMITS)
    assert rep["kills"] >= 1
    assert rep["audit_clean"] and rep["audit_errors"] == 0
    assert sorted(rep["streams_match"]) == ["s00", "s01"]
    assert all(s["ok"] for s in rep["streams_match"].values()), (
        rep["streams_match"])
    assert rep["detect_events"] > 0 and rep["ok"]


def test_cli_refuses_unported_options(tmp_path, monkeypatch, capsys):
    """Every option is ported.  ``--mesh 2`` runs the drilled cycles
    channel-sharded over two logical CPU shards and the control on one
    device, and the drill holds (the sharded path survives the kills
    byte-identical to the unsharded run); ``--live`` runs the drilled
    cycles live-on with never-drained subscribers and the control
    live-off, and the drill holds (the live plane holds nothing
    durable)."""
    import json

    from tpudas_torch.tools.crash_drill import main

    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    report = str(tmp_path / "mesh.json")
    assert main(["--mesh", "2", "--cycles", "2", "--engines", "auto",
                 "--device", "cpu", "--workdir", str(tmp_path / "mesh"),
                 "--out", report]) == 0
    payload = json.load(open(report))
    rep = payload["engines"]["auto"]
    assert payload["mesh"] == 2 and rep["mesh"] == 2
    _assert_drill_ok(rep)
    with pytest.raises(SystemExit):
        main(["--mesh", "2", "--streams", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--live", "--streams", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="engine"):
        run_drill(engine="cascade", cycles=0, device="cpu")
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    report = str(tmp_path / "live.json")
    assert main(["--live", "--live-subs", "4", "--cycles", "2",
                 "--engines", "fused", "--device", "cpu", "--workdir",
                 str(tmp_path / "drill"), "--out", report]) == 0
    assert "crash_drill: OK" in capsys.readouterr().out
    payload = json.load(open(report))
    rep = payload["engines"]["fused"]
    assert payload["live"] is True and rep["live"] is True
    assert rep["live_subs"] == 4
    _assert_drill_ok(rep)
