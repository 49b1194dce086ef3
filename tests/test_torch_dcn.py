"""The port's mesh across ``torch.distributed`` ranks: the counterpart of
``tests/dcn_worker.py`` / ``tests/test_distributed.py``'s two-process
JAX mesh.

Two ``gloo`` processes, each with 4 logical CPU shards, join one group
through ``initialize_multihost`` (``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``) and build the global ``(time=2,
ch=4)`` mesh from ``global_mesh_devices``: its time axis crosses the
process boundary, so every halo between the time shards crosses ranks.
The pair runs once (a module-scoped fixture) and saves what it computed;
each check below is a test of its own over those results, against the
port's single-process functions (``torch.equal``) and the JAX
package's (``cascade_decimate`` within 1e-5 per channel), both computed
here on the CPU.  Each process has a 300 s hang guard and is killed in
``finally``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.ops import fir as jfir
from tpudas_torch.ops import fir as tfir
from tpudas_torch.parallel.mesh import DeviceMesh, RankDevice, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HANG_GUARD_S = 300

# the cascade cases: (name, plan args, n_out, channels, int16)
CASES = {
    "worker": ((100.0, 20, 0.45, 4), 800, 8, False),
    "flagship": ((1000.0, 1000, None), 60, 64, False),
    "flagship_int16": ((1000.0, 1000, None), 60, 64, True),
}
QSCALE = 0.004
LOWPASS = dict(T=1600, C=8, d_sec=0.01, corner=5.0, ratio=4, halo=96)
# n_out: the worker plan's outputs of a 4000-row window
BATCH = dict(W=5, T=4000, C=6, w=25, s=10, n_out=73)


def _plan_args(args):
    from tpudas_torch.proc.lfproc import output_corner

    fs, ratio, corner = args[:3]
    return (fs, ratio, output_corner(1.0) if corner is None else corner,
            *args[3:])


def _case_input(name):
    """The seeded (T, C) input of a cascade case and its phase/n_out."""
    args, n_out, n_ch, int16 = CASES[name]
    plan = tfir.design_cascade(*_plan_args(args))
    T = n_out * plan.ratio
    rng = np.random.default_rng(len(name))
    if int16:
        x = rng.integers(-2000, 2000, size=(T, n_ch), dtype=np.int16)
    else:
        x = rng.standard_normal((T, n_ch)).astype(np.float32)
    return plan, x, plan.delay, n_out


def _lowpass_input():
    rng = np.random.default_rng(7)
    return rng.standard_normal((LOWPASS["T"], LOWPASS["C"])).astype(
        np.float32)


def _batch_input():
    rng = np.random.default_rng(11)
    return rng.standard_normal(
        (BATCH["W"], BATCH["T"], BATCH["C"])).astype(np.float32)


_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.environ["REPO"])
from tpudas_torch.ops.fir import design_cascade
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel.distributed import (
    global_mesh_devices, initialize_multihost, is_distributed,
    process_allgather)
from tpudas_torch.parallel.mesh import DeviceMesh
from tpudas_torch.parallel.sharding import ShardedTensor, shards_from_callback
from tpudas_torch.parallel.halo import exchange_halo_time
from tpudas_torch.parallel.pipeline import (
    sharded_cascade_decimate, sharded_lowpass_decimate)
from tpudas_torch.parallel.batch import (
    batched_cascade_decimate, batched_rolling_mean)

assert initialize_multihost(device="cpu") is True
rank = dist.get_rank()
assert rank == int(os.environ["PROCESS_ID"]) and is_distributed()
devs = global_mesh_devices(local_devices=[torch.device("cpu")] * 4)
assert [d.rank for d in devs] == [0] * 4 + [1] * 4, devs
# the time axis spans the two processes: row 0 on rank 0, row 1 on rank 1
mesh = DeviceMesh([devs[:4], devs[4:]], ("time", "ch"))
assert mesh.spans_ranks
assert mesh.local_coords() == [(rank, c) for c in range(4)]
out, meta = {}, {"rank": rank}


# the cross-rank directions of the transfer counter: bytes this rank
# received, by kind and transport
def rank_bytes(reg):
    snap = reg.snapshot().get("tpudas_parallel_transfer_bytes_total")
    return {lab["direction"]: v for lab, v in (snap or {}).get("series", [])
            if ":" in lab["direction"]}

# the inputs the test wrote: every rank holds the same host arrays
inputs = dict(np.load(os.path.join(os.environ["OUT"], "inputs.npz")))
with open(os.path.join(os.environ["OUT"], "cases.json")) as fh:
    cases = json.load(fh)

# an all-reduce sum of this rank's shards (the JAX worker's psum)
T, C = 16, 8
g = np.arange(T * C, dtype=np.float32).reshape(T, C)
arr = shards_from_callback(g.shape, mesh, ("time", "ch"), lambda ix: g[ix])
assert len(arr) == 4 and arr.shape == (T, C)
total = torch.stack([s.sum() for s in arr]).sum().reshape(1)
dist.all_reduce(total)
meta["psum"] = float(total.item())

# halo shifts across the rank boundary
h = 2
reg = MetricsRegistry()
with use_registry(reg):
    ext = exchange_halo_time(arr, h, "time", n_shards=2, mesh=mesh,
                             coords=arr.coords)
    left = [e[: T // 2] for e in ext]
    ext = exchange_halo_time(arr, h, "time", n_shards=2, left=False,
                             right=True, mesh=mesh, coords=arr.coords)
    right = [e[h : h + T // 2] for e in ext]
meta["halo_traffic"] = rank_bytes(reg)
for name, parts in (("left_shift", left), ("right_shift", right)):
    st = ShardedTensor(parts, coords=arr.coords, spec=arr.spec,
                       global_shape=arr.shape, mesh=mesh)
    out[name] = process_allgather(st, tiled=True).numpy()
out["allgather_rows"] = process_allgather(
    torch.full((2, 3), float(rank)), tiled=True).numpy()

# the product's time-sharded cascade (B1's plain stage on the CPU)
reg = MetricsRegistry()
with use_registry(reg):
    for name, c in cases["cascade"].items():
        plan = design_cascade(*c["plan"])
        x = inputs["cascade_" + name]
        y = sharded_cascade_decimate(mesh, x, plan, plan.delay, c["n_out"],
                                     "torch", qscale=c["qscale"])
        assert isinstance(y, ShardedTensor) and len(y) == 4, type(y)
        out["cascade_" + name] = process_allgather(y, tiled=True).numpy()
meta["cascade_traffic"] = rank_bytes(reg)

lp = cases["lowpass"]
y = sharded_lowpass_decimate(mesh, inputs["lowpass"], lp["d_sec"],
                             lp["corner"], lp["ratio"], lp["halo"])
out["lowpass"] = process_allgather(y, tiled=True).numpy()

# the batch axis across ranks: each rank runs its own windows
b = cases["batch"]
stack = inputs["batch"]
plan = design_cascade(*cases["cascade"]["worker"]["plan"])
y = batched_cascade_decimate(mesh, stack, plan, plan.delay, b["n_out"],
                             "torch", batch_axis="time", ch_axis="ch")
meta["batched_local_windows"] = int(sum(
    int(p.abs().sum(dim=(1, 2)).gt(0).sum()) for p in y))
out["batched_cascade"] = process_allgather(y, tiled=True).numpy()
y = batched_rolling_mean(mesh, stack, b["w"], b["s"], batch_axis="time")
out["batched_rolling"] = process_allgather(y, tiled=True).numpy()
# a batch axis that does not cross the ranks: every slot of "ch" lies on
# rank 0's row, so rank 1 holds no shard and sends an empty payload
y = batched_rolling_mean(mesh, stack, b["w"], b["s"], batch_axis="ch")
meta["ch_slots_held"] = len(y)
out["batched_rolling_ch"] = process_allgather(y, tiled=True).numpy()

# the drivers refuse a rank-spanning mesh
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.joint import JointProc
from tpudas_torch.parallel.mesh import resolve_mesh

raised = {}
for what, call in (("LFProc", lambda: LFProc(mesh=mesh, device="cpu")),
                   ("JointProc", lambda: JointProc(mesh=mesh, device="cpu")),
                   ("resolve_mesh", lambda: resolve_mesh(mesh))):
    try:
        call()
        raised[what] = None
    except ValueError as exc:
        raised[what] = str(exc)
meta["raised"] = raised
meta["jax_imported"] = "jax" in sys.modules
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
with open(os.path.join(os.environ["OUT"], f"rank{rank}.json"), "w") as fh:
    json.dump(meta, fh)
dist.barrier()
dist.destroy_process_group()
print("rank-ok", rank, flush=True)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two rank processes once; ``[(npz, meta), ...]`` by rank."""
    out = str(tmp_path_factory.mktemp("dcn"))
    inputs, cases = {}, {"cascade": {}, "lowpass": LOWPASS, "batch": BATCH}
    for name, (args, _n, _c, int16) in CASES.items():
        plan, x, _phase, n_out = _case_input(name)
        inputs["cascade_" + name] = x
        cases["cascade"][name] = {"plan": list(_plan_args(args)),
                                  "n_out": n_out,
                                  "qscale": QSCALE if int16 else None}
    inputs["lowpass"] = _lowpass_input()
    inputs["batch"] = _batch_input()
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    with open(os.path.join(out, "cases.json"), "w") as fh:
        json.dump(cases, fh)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
            env.update(REPO=REPO, OUT=out, PYTHONPATH=REPO,
                       OMP_NUM_THREADS="2",
                       COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES="2", PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # each process's guard counts from the pair's start
        deadline = time.monotonic() + HANG_GUARD_S
        logs = [p.communicate(
            timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        assert f"rank-ok {rank}" in log, log[-3000:]
    res = []
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.json")) as fh:
            meta = json.load(fh)
        res.append((dict(np.load(os.path.join(out, f"rank{rank}.npz"))),
                    meta))
    return res


def _both(ranks, key):
    """Rank 0's gathered ``key``, after checking rank 1 gathered the
    same bytes."""
    a, b = ranks[0][0][key], ranks[1][0][key]
    assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return a


def test_ranks_build_the_global_mesh_without_jax(ranks):
    for rank, (_out, meta) in enumerate(ranks):
        assert meta["rank"] == rank
        assert meta["jax_imported"] is False


def test_all_reduce_sum(ranks):
    want = float(np.arange(16 * 8, dtype=np.float32).sum())
    for _out, meta in ranks:
        assert meta["psum"] == want


def test_allgather_of_a_rank_local_tensor(ranks):
    got = _both(ranks, "allgather_rows")
    assert np.array_equal(got, np.repeat(np.arange(2.0), 2)[:, None]
                          * np.ones((1, 3), np.float32))


@pytest.mark.parametrize("side", ["left_shift", "right_shift"])
def test_halo_shift_equals_the_numpy_shift(ranks, side):
    """A two-sided exchange's left halo shifts the stream down (zeros at
    its start); a one-sided look-ahead exchange shifts it up (zeros at
    its end).  Each rank receives one halo a column shard, across the
    rank boundary, over gloo."""
    g = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    h = 2
    want = np.zeros_like(g)
    if side == "left_shift":
        want[h:] = g[:-h]
    else:
        want[:-h] = g[h:]
    assert np.array_equal(_both(ranks, side), want)


def test_halo_bytes_are_counted_by_transport(ranks):
    """Rank 0's row receives right halos only, rank 1's left halos only,
    4 column shards of 2 x 2 float32 each, all over gloo (CPU)."""
    for rank, (_out, meta) in enumerate(ranks):
        got = meta["halo_traffic"]
        # the two-sided exchange: 4 halos in; the one-sided: rank 0 4 in
        want = 4 * 2 * 2 * 4 * (2 if rank == 0 else 1)
        assert got == {"halo:gloo": want}, got


def _per_channel_close(got, want, tol=1e-5):
    err = np.abs(got.astype(np.float64) - want).max(axis=0)
    scale = np.maximum(np.abs(want).max(axis=0), 1.0)
    assert (err <= tol * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cascade_equals_the_single_process_port(ranks, name):
    plan, x, phase, n_out = _case_input(name)
    qscale = QSCALE if x.dtype == np.int16 else None
    want = tfir.cascade_decimate(x, plan, phase, n_out, "torch",
                                 qscale=qscale, device="cpu")
    got = _both(ranks, "cascade_" + name)
    assert got.shape == (n_out, x.shape[1]) and got.dtype == np.float32
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cascade_within_1e5_of_jax(ranks, name):
    args, _n, _c, _i = CASES[name]
    _plan, x, phase, n_out = _case_input(name)
    jplan = jfir.design_cascade(*_plan_args(args))
    qscale = QSCALE if x.dtype == np.int16 else None
    want = np.asarray(jfir.cascade_decimate(x, jplan, phase, n_out, "xla",
                                            qscale=qscale), np.float64)
    _per_channel_close(_both(ranks, "cascade_" + name), want)


def test_flagship_halo_crossed_ranks(ranks):
    """Every time shard of rank 0 received its look-ahead halo from rank
    1: the flagship's covers stage 0's carry and the rest of the
    cascade's input need (26,688 rows a shard at 60 outputs)."""
    from tpudas_torch.parallel.pipeline import sharded_cascade_layout

    mesh = make_mesh(8, time_shards=2, device="cpu")
    halo_bytes = gather_bytes = 0
    for name, (args, n_out, n_ch, int16) in CASES.items():
        plan = tfir.design_cascade(*_plan_args(args))
        n_loc, _t, halo = sharded_cascade_layout(mesh, plan, plan.delay,
                                                 n_out, n_out * plan.ratio)
        if name.startswith("flagship"):
            assert halo == 26688
        halo_bytes += 4 * halo * (n_ch // 4) * (2 if int16 else 4)
        gather_bytes += n_loc * n_ch * 4  # the other rank's float32 rows
    assert ranks[0][1]["cascade_traffic"] == {"halo:gloo": halo_bytes,
                                              "allgather:gloo": gather_bytes}
    # rank 1 holds the last time shard: zeros, no halo received
    assert ranks[1][1]["cascade_traffic"] == {"allgather:gloo": gather_bytes}


def _local_mesh():
    """The process-local counterpart of the ranks' mesh: (time=2, ch=4)
    logical CPU shards of this process."""
    return make_mesh(8, time_shards=2, device="cpu")


def test_sharded_lowpass_equals_the_single_process_run(ranks):
    from tpudas_torch.parallel.pipeline import sharded_lowpass_decimate

    lp = LOWPASS
    want = sharded_lowpass_decimate(_local_mesh(), _lowpass_input(),
                                    lp["d_sec"], lp["corner"], lp["ratio"],
                                    lp["halo"])
    assert torch.equal(torch.from_numpy(_both(ranks, "lowpass")), want)


def test_batched_cascade_equals_the_single_process_run(ranks):
    from tpudas_torch.parallel.batch import batched_cascade_decimate

    plan, _x, _p, _n = _case_input("worker")
    n_out = BATCH["n_out"]
    assert n_out == (BATCH["T"] - 2 * plan.delay) // plan.ratio
    want = batched_cascade_decimate(_local_mesh(), _batch_input(), plan,
                                    plan.delay, n_out, "torch",
                                    batch_axis="time", ch_axis="ch")
    got = _both(ranks, "batched_cascade")
    assert got.shape == (BATCH["W"], n_out, BATCH["C"])
    assert torch.equal(torch.from_numpy(got), want)
    # 5 windows over 2 slots: 3 on rank 0, 2 on rank 1, each counted
    # once a column shard with data (6 channels over 4 shards of 2: the
    # last shard is pad only)
    assert [m["batched_local_windows"] for _o, m in ranks] == [9, 6]


def test_batched_rolling_equals_the_single_process_run(ranks):
    from tpudas_torch.parallel.batch import batched_rolling_mean

    want = batched_rolling_mean(_local_mesh(), _batch_input(), BATCH["w"],
                                BATCH["s"], batch_axis="time")
    got = torch.from_numpy(_both(ranks, "batched_rolling"))
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_a_rank_holding_no_slot_still_gathers(ranks):
    """``batched_rolling_mean``'s default batch axis ``ch`` does not
    cross the ranks: rank 0 runs all 4 slots, rank 1 none, and both
    gather the process-local result."""
    from tpudas_torch.parallel.batch import batched_rolling_mean

    assert [m["ch_slots_held"] for _o, m in ranks] == [4, 0]
    want = batched_rolling_mean(_local_mesh(), _batch_input(), BATCH["w"],
                                BATCH["s"])
    got = torch.from_numpy(_both(ranks, "batched_rolling_ch"))
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("what", ["LFProc", "JointProc", "resolve_mesh"])
def test_drivers_refuse_the_rank_spanning_mesh(ranks, what):
    for _out, meta in ranks:
        msg = meta["raised"][what]
        assert msg is not None and "spans torch.distributed ranks" in msg


# ---------------------------------------------------------------------------
# in this process: a mesh with entries on a rank this process is not


def _foreign_mesh():
    return DeviceMesh([[RankDevice(0, CPU)] * 2, [RankDevice(1, CPU)] * 2])


def test_mesh_of_this_ranks_entries_is_process_local():
    mesh = DeviceMesh([[RankDevice(0, CPU)] * 2] * 2)
    assert not mesh.spans_ranks
    assert mesh.local_coords() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.axis_devices("ch") == [CPU, CPU]
    assert _foreign_mesh().spans_ranks
    assert _foreign_mesh().local_coords() == [(0, 0), (0, 1)]
    assert _foreign_mesh().rank_of((1, 0)) == 1
    with pytest.raises(ValueError, match="RankDevice"):
        DeviceMesh([RankDevice(0, CPU), CPU])


def _runner(kind, tmp_path):
    from tpudas_torch.proc.streaming import (
        run_lowpass_realtime,
        run_rolling_realtime,
    )

    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    out = str(tmp_path / "out")
    if kind == "lowpass":
        return lambda: run_lowpass_realtime(
            source=str(src), output_folder=out,
            start_time="2023-03-22T00:00:00", output_sample_interval=1.0,
            edge_buffer=5.0, process_patch_size=20, max_rounds=1,
            sleep_fn=lambda _s: None, mesh=_foreign_mesh(), device="cpu")
    return lambda: run_rolling_realtime(
        source=str(src), output_folder=out, window=2.0, step=1.0,
        max_rounds=1, sleep_fn=lambda _s: None, mesh=_foreign_mesh(),
        device="cpu")


@pytest.mark.parametrize("driver", [
    "LFProc", "JointProc", "run_lowpass_realtime", "run_rolling_realtime",
    "cascade_decimate_stream", "fft_pass_filter_stream", "cascade_decimate",
])
def test_every_driver_names_the_rank_spanning_mesh(driver, tmp_path):
    from tpudas_torch.ops.filter import fft_pass_filter_stream, fft_stream_init
    from tpudas_torch.proc.joint import JointProc
    from tpudas_torch.proc.lfproc import LFProc

    mesh = _foreign_mesh()
    plan = tfir.design_cascade(100.0, 20, 0.45, 4)
    x = np.zeros((40, 4), np.float32)
    calls = {
        "LFProc": lambda: LFProc(mesh=mesh, device="cpu"),
        "JointProc": lambda: JointProc(mesh=mesh, device="cpu"),
        "run_lowpass_realtime": _runner("lowpass", tmp_path),
        "run_rolling_realtime": _runner("rolling", tmp_path),
        "cascade_decimate_stream": lambda: tfir.cascade_decimate_stream(
            x, tfir.cascade_stream_init(plan, 4, device="cpu"), plan,
            "torch", mesh=mesh, device="cpu"),
        "fft_pass_filter_stream": lambda: fft_pass_filter_stream(
            x, fft_stream_init(8, 4), 0.01, high=5.0, mesh=mesh,
            device="cpu"),
        "cascade_decimate": lambda: tfir.cascade_decimate(
            x, plan, plan.delay, 1, "torch", mesh=mesh, device="cpu"),
    }
    with pytest.raises(ValueError, match="spans torch.distributed ranks"):
        calls[driver]()
    assert not os.path.exists(str(tmp_path / "out"))
