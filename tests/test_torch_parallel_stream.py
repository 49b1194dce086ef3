"""The port's mesh hooks end to end, against the single-device port and
the JAX package.

``LFProc(mesh=...)`` (channel-sharded, time-sharded with its halo,
window data-parallel), ``JointProc`` under a mesh, the stateful
``run_lowpass_realtime(mesh=...)`` / ``TPUDAS_MESH`` with its carry
sharded on the devices and gathered on the save cadence only, carries
resumed across layouts and across the two packages, and the multi-host
hooks of ``tpudas_torch.parallel.distributed`` (mocked, and two real
``gloo`` processes).  Port meshes are ``make_mesh(..., device="cpu")``
(logical CPU shards); the JAX side uses the virtual host devices of
``conftest.py``.  Within the port every layout writes the bytes of the
unsharded run; across the packages the data agree within 1e-5 of each
channel's scale, against the JAX package's single-device result.
"""

import hashlib
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from tpudas.io.spool import spool as jspool
from tpudas.parallel.mesh import make_mesh as jax_make_mesh
from tpudas.proc.lfproc import LFProc as JLFProc
from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.testing import make_synthetic_spool
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel.mesh import DeviceMesh, make_mesh
from tpudas_torch.proc.joint import JointProc
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.stream import CARRY_FILENAME, load_carry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.utils.logging import set_log_handler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
T1 = np.datetime64("2023-03-22T00:00:00")
T2 = np.datetime64("2023-03-22T00:03:00")
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def require_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _assert_close(got, ref, tol=REL_TOL):
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(got - ref).max(axis=0) <= tol * scale).all()


def _merged(out, pkg="port"):
    sp = tspool if pkg == "port" else jspool
    merged = sp(str(out)).update().chunk(time=None)
    assert len(merged) == 1, "the output has a seam"
    return merged[0]


def _files(out) -> dict:
    """Every output file's bytes (LF files, and a carry when present)."""
    got = {}
    for name in sorted(os.listdir(out)):
        if name.startswith("LFDAS_") or name == CARRY_FILENAME:
            with open(os.path.join(out, name), "rb") as fh:
                got[name] = hashlib.sha256(fh.read()).hexdigest()
    return got


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """6 x 30 s at 100 Hz, 12 channels: dasdae and raw-int16 tdas."""
    out = {}
    for fmt, wk in (("dasdae", None),
                    ("tdas", {"dtype": "int16", "scale": 1e-4})):
        d = tmp_path_factory.mktemp(f"mesh-raw-{fmt}")
        make_synthetic_spool(d, n_files=6, file_duration=30.0, fs=100.0,
                             n_ch=12, noise=0.01, format=fmt,
                             write_kwargs=wk)
        out[fmt] = str(d)
    return out


def _run(cls, src, out, mesh=None, sp=tspool, **para):
    kw = {} if cls is JLFProc else {"device": CPU}
    lfp = cls(sp(src).sort("time").update(), mesh=mesh, **kw)
    lfp.update_processing_parameter(output_sample_interval=1.0,
                                    process_patch_size=60,
                                    edge_buff_size=10, **para)
    lfp.set_output_folder(str(out), delete_existing=True)
    lfp.process_time_range(T1, T2)
    return lfp


class TestLFProcMesh:
    """The batch engine over a mesh: files byte-identical to the
    single-device run, the same engines counted, the single-device run
    within 1e-5 of the JAX package's."""

    @pytest.mark.parametrize("time_shards,engine,fmt", [
        (1, "auto", "dasdae"), (2, "auto", "dasdae"), (4, "auto", "tdas"),
        (2, "auto", "tdas"), (1, "fft", "dasdae"), (2, "fft", "tdas"),
    ])
    def test_sharded_files_byte_identical(self, raw, tmp_path, time_shards,
                                          engine, fmt):
        events = []
        set_log_handler(events.append)
        try:
            single = _run(LFProc, raw[fmt], tmp_path / "single",
                          engine=engine)
            mesh = make_mesh(8, time_shards=time_shards, device=CPU)
            sharded = _run(LFProc, raw[fmt], tmp_path / "sharded",
                           mesh=mesh, engine=engine)
        finally:
            set_log_handler(None)
        assert _files(tmp_path / "single") == _files(tmp_path / "sharded")
        assert sharded.engine_counts == single.engine_counts
        logged = [e["mesh"] for e in events if e["event"] == "window_engine"]
        assert logged.count(None) == logged.count(mesh.shape) == 4
        _run(JLFProc, raw[fmt], tmp_path / "jax", sp=jspool, engine=engine)
        a, b = _merged(tmp_path / "single"), _merged(tmp_path / "jax", "jax")
        assert np.array_equal(a.coords["time"], b.coords["time"])
        _assert_close(a.host_data(), b.host_data())

    @pytest.mark.parametrize("fmt", ["dasdae", "tdas"])
    def test_lfproc_window_dp_byte_equal(self, raw, tmp_path, fmt):
        """window_dp batches the steady-state windows over the mesh's
        time axis, byte-identical to the serial run."""
        events = []
        set_log_handler(events.append)
        try:
            serial = _run(LFProc, raw[fmt], tmp_path / "serial")
            dp = _run(LFProc, raw[fmt], tmp_path / "dp",
                      mesh=make_mesh(8, time_shards=2, device=CPU),
                      window_dp=True)
        finally:
            set_log_handler(None)
        batches = [e for e in events if e["event"] == "window_dp_batch"]
        assert batches and sum(e["windows"] for e in batches) >= 2
        assert dp._window_dp_ok and sum(dp.engine_counts.values()) == 4
        assert dp.engine_counts == serial.engine_counts
        assert _files(tmp_path / "serial") == _files(tmp_path / "dp")

    def test_joint_proc_under_mesh(self, raw, tmp_path):
        """JointProc's LF and rolling files under a channel mesh and a
        time mesh are the unsharded JointProc's bytes."""
        outs = {}
        for name, mesh in (("single", None),
                           ("ch", make_mesh(4, device=CPU)),
                           ("time", make_mesh(8, time_shards=2, device=CPU))):
            lfp = JointProc(tspool(raw["tdas"]).sort("time").update(),
                            mesh=mesh, device=CPU)
            lfp.update_processing_parameter(
                output_sample_interval=1.0, process_patch_size=60,
                edge_buff_size=10, rolling_window=1.0, rolling_step=1.0)
            lfp.set_output_folder(str(tmp_path / name), delete_existing=True)
            lfp.set_rolling_output_folder(str(tmp_path / f"{name}-roll"),
                                          delete_existing=True)
            lfp.process_time_range(T1, T2)
            assert lfp.rolling_windows == 4
            outs[name] = (_files(tmp_path / name),
                          _files(tmp_path / f"{name}-roll"))
        assert outs["single"] == outs["ch"] == outs["time"]

    def test_streaming_driver_takes_time_mesh(self, raw, tmp_path):
        """A time-sharded mesh sends the driver to the window (rewind)
        path: seam-free, the unsharded rewind run's bytes."""
        outs = {}
        for name, mesh in (("single", None),
                           ("mesh", make_mesh(8, time_shards=2, device=CPU))):
            out = tmp_path / name
            rounds = run_lowpass_realtime(
                raw["dasdae"], str(out), str(T1), output_sample_interval=1.0,
                edge_buffer=10.0, process_patch_size=60, poll_interval=0.0,
                sleep_fn=lambda s: None, max_rounds=3, mesh=mesh,
                stateful=False if mesh is None else None, device=CPU)
            assert rounds >= 1
            assert not os.path.exists(out / CARRY_FILENAME)
            _merged(out)
            outs[name] = _files(out)
        assert outs["single"] == outs["mesh"]

    def test_mesh_without_ch_axis_or_of_another_device_rejected(self):
        from jax.sharding import Mesh

        with pytest.raises(ValueError, match="'ch' axis"):
            JLFProc(None, mesh=Mesh(np.array(jax.devices()[:8]).reshape(
                2, 4), ("a", "b")))
        with pytest.raises(ValueError, match="'ch' axis"):
            LFProc(None, mesh=DeviceMesh([["cpu"] * 4] * 2, ("a", "b")),
                   device=CPU)
        with pytest.raises(ValueError, match="another device type"):
            LFProc(None, mesh=DeviceMesh(["meta"] * 2), device=CPU)


# ---------------------------------------------------------------------------
# the stateful stream under a channel mesh


FS, N_CH, FILE_SEC = 100.0, 10, 30.0  # 10 ch: pad-and-mask over 4 shards
DETECT_OPS = (
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5, "baseline": 20.0}),
)


def _feed(src, first, n=1):
    make_synthetic_spool(
        src, n_files=n, file_duration=FILE_SEC, fs=FS, n_ch=N_CH,
        noise=0.05,
        start=T1 + np.timedelta64(int(first * FILE_SEC * 1e9), "ns"),
        prefix=f"raw{first:03d}",
    )


def _drive(src, out, mesh, driver=run_lowpass_realtime, feed_rounds=2,
           max_rounds=6, hooks=False, **kw):
    """3 initial files (unless ``src`` exists), one more fed before each
    of ``feed_rounds`` polls; terminates on no growth."""
    if not os.path.isdir(src):
        _feed(src, 0, 3)
    state = {"fed": 0}

    def sleep(_):
        if state["fed"] < feed_rounds:
            state["fed"] += 1
            _feed(src, 2 + state["fed"])

    if driver is run_lowpass_realtime:
        kw.setdefault("device", CPU)
    else:
        kw.setdefault("flight", False)
    if hooks:
        kw.update(pyramid=True, detect=True, detect_operators=DETECT_OPS)
    return driver(
        source=str(src), output_folder=str(out), start_time=str(T1),
        output_sample_interval=1.0, edge_buffer=10.0, process_patch_size=60,
        poll_interval=0.0, sleep_fn=sleep, max_rounds=max_rounds, mesh=mesh,
        **kw,
    )


def _tree(out, sub):
    root = os.path.join(str(out), sub)
    tree = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in sorted(names):
            if ".prev" in name or ".tmp" in name or name.endswith(".npz"):
                continue
            with open(os.path.join(dirpath, name), "rb") as fh:
                tree[os.path.relpath(os.path.join(dirpath, name), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return tree


def _assert_carries_equal(a, b):
    a, b = load_carry(str(a)), load_carry(str(b))
    assert a is not None and b is not None
    assert a._meta() == b._meta()
    for x, y in zip(a.bufs, b.bufs):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert (a.residual is None) == (b.residual is None)
    if a.residual is not None:
        assert np.array_equal(a.residual, b.residual)


class TestShardedRealtimeEquivalence:
    @pytest.mark.parametrize("engine,hooks", [("auto", True),
                                              ("fused", False),
                                              ("fft", False)])
    def test_sharded_run_byte_identical(self, tmp_path, monkeypatch, engine,
                                        hooks):
        """``mesh=DeviceMesh`` and ``TPUDAS_MESH=4`` runs == the
        single-device run: outputs, the ``.npz`` carry byte for byte,
        and (with the hooks) the pyramid tiles and the detect ledger."""
        from tpudas_torch.obs.health import read_health

        monkeypatch.delenv("TPUDAS_MESH", raising=False)
        monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "16")
        legs = {"single": None, "mesh": make_mesh(4, device=CPU), "env": None}
        for name, mesh in legs.items():
            if name == "env":
                monkeypatch.setenv("TPUDAS_MESH", "4")
            assert _drive(tmp_path / f"src-{name}", tmp_path / name, mesh,
                          engine=engine, hooks=hooks, health=True) == 3
            monkeypatch.delenv("TPUDAS_MESH", raising=False)
            assert read_health(str(tmp_path / name))["mode"] == "stateful"
        for name in ("mesh", "env"):
            assert _files(tmp_path / "single") == _files(tmp_path / name)
            _assert_carries_equal(tmp_path / "single", tmp_path / name)
            if hooks:
                for sub in (".tiles", ".detect"):
                    ref = _tree(tmp_path / "single", sub)
                    assert ref and ref == _tree(tmp_path / name, sub)

    def test_carry_save_cadence_moves_no_bytes_between_saves(self, tmp_path):
        """``carry_save_every=4`` keeps the carry on the devices between
        saves: the same saves as the JAX driver's at each cadence, gather
        traffic only in rounds that save, and the same end state."""
        from tpudas.obs.registry import MetricsRegistry as JReg
        from tpudas.obs.registry import use_registry as juse

        saves = {}
        gathers = {}
        for name, every in (("each", 1), ("cadence", 4)):
            reg = MetricsRegistry()
            per_round = []

            def on_round(rnd, _lfp, reg=reg, per_round=per_round):
                per_round.append((
                    reg.value("tpudas_stream_carry_saves_total"),
                    reg.value("tpudas_parallel_transfer_bytes_total",
                              direction="gather")))

            with use_registry(reg):
                _drive(tmp_path / f"src-{name}", tmp_path / name,
                       make_mesh(4, device=CPU), carry_save_every=every,
                       on_round=on_round)
            saves[name] = reg.value("tpudas_stream_carry_saves_total")
            gathers[name] = per_round
            # the clean-termination flush gathers after the last round
            assert reg.value("tpudas_parallel_transfer_bytes_total",
                             direction="gather") > 0, name
            jreg = JReg()
            with juse(jreg):
                _drive(tmp_path / f"jsrc-{name}", tmp_path / f"j{name}",
                       jax_make_mesh(4), driver=jax_realtime,
                       carry_save_every=every)
            assert saves[name] == jreg.value(
                "tpudas_stream_carry_saves_total"), name
        assert saves["cadence"] < saves["each"]
        quiet = 0
        for name, per_round in gathers.items():
            prev = (0.0, 0.0)
            for n_saves, n_bytes in per_round:
                # gather bytes move only in a round that saves (the save
                # of a carry not yet opened moves none)
                saved, moved = n_saves > prev[0], n_bytes > prev[1]
                assert saved or not moved, name
                quiet += not saved
                prev = (n_saves, n_bytes)
        assert quiet >= 2  # the cadence run's rounds without a save
        assert _files(tmp_path / "each") == _files(tmp_path / "cadence")

    def test_carry_is_layout_independent_across_restarts(self, tmp_path):
        """A run stops sharded and resumes single-device (or the
        reverse) from the saved carry, byte-identical to a control that
        never changed layout."""
        mesh = make_mesh(4, device=CPU)
        for name, (m1, m2) in {"ctrl": (None, None),
                               "shard_then_single": (mesh, None),
                               "single_then_shard": (None, mesh)}.items():
            src, out = tmp_path / f"src-{name}", tmp_path / name
            _drive(src, out, m1, feed_rounds=1, max_rounds=2)
            _feed(src, 4)
            _drive(src, out, m2, feed_rounds=0)
        for name in ("shard_then_single", "single_then_shard"):
            assert _files(tmp_path / "ctrl") == _files(tmp_path / name), name

    def test_carry_resumes_across_packages(self, tmp_path, cpu_mesh4):
        """A carry saved by a sharded port run resumes under the JAX
        driver, sharded or not; a carry saved by a sharded JAX run
        resumes under the port, sharded or not.  Every final stream is
        within 1e-5 of the port's single-device control, and the two
        port resumes of one JAX carry are byte-identical."""
        mesh = make_mesh(4, device=CPU)
        src = tmp_path / "src"
        ctrl = tmp_path / "ctrl"
        _drive(src, ctrl, None, feed_rounds=1, max_rounds=2)
        firsts = {"port": tmp_path / "port1", "jax": tmp_path / "jax1"}
        _drive(src, firsts["port"], mesh, feed_rounds=0, max_rounds=2)
        _drive(src, firsts["jax"], cpu_mesh4, driver=jax_realtime,
               feed_rounds=0, max_rounds=2)
        _feed(src, 4)
        _drive(src, ctrl, None, feed_rounds=0)
        legs = {
            "port_to_jax_single": ("port", jax_realtime, None),
            "port_to_jax_mesh": ("port", jax_realtime, cpu_mesh4),
            "jax_to_port_mesh": ("jax", run_lowpass_realtime, mesh),
            "jax_to_port_single": ("jax", run_lowpass_realtime, None),
        }
        ref = _merged(ctrl)
        for name, (first, driver, m2) in legs.items():
            out = tmp_path / name
            shutil.copytree(firsts[first], out)
            assert _drive(src, out, m2, driver=driver, feed_rounds=0) == 1
            got = _merged(out, "port" if driver is run_lowpass_realtime
                          else "jax")
            assert np.array_equal(got.coords["time"], ref.coords["time"])
            _assert_close(got.host_data(), ref.host_data())
        assert (_files(tmp_path / "jax_to_port_mesh")
                == _files(tmp_path / "jax_to_port_single"))


# ---------------------------------------------------------------------------
# multi-host hooks


class TestInitializeMultihost:
    """``initialize_multihost`` with ``init_process_group`` mocked: the
    JAX hook's cases (``tests/test_distributed.py``)."""

    @pytest.fixture(autouse=True)
    def calls(self, monkeypatch):
        import torch.distributed

        import tpudas_torch.parallel.distributed as dist

        monkeypatch.setattr(dist, "_initialized", False)
        for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        seen = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: seen.append(kw))
        self.dist = dist
        return seen

    def test_noop_without_config(self, calls):
        assert self.dist.initialize_multihost() is False
        assert calls == [] and not self.dist.is_distributed()

    def test_env_parsing(self, calls, monkeypatch):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
        monkeypatch.setenv("NUM_PROCESSES", "8")
        monkeypatch.setenv("PROCESS_ID", "3")
        assert self.dist.initialize_multihost(device=CPU) is True
        assert calls == [{"backend": "gloo",
                          "init_method": "tcp://10.0.0.1:8476",
                          "world_size": 8, "rank": 3}]

    def test_explicit_args_beat_env_and_nccl_on_the_card(self, calls,
                                                         monkeypatch):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "env:1")
        monkeypatch.setenv("NUM_PROCESSES", "2")
        monkeypatch.setenv("PROCESS_ID", "1")
        assert self.dist.initialize_multihost("arg:2", 4, 2,
                                              device="cuda") is True
        assert calls == [{"backend": "nccl", "init_method": "tcp://arg:2",
                          "world_size": 4, "rank": 2}]

    def test_process_zero_is_not_dropped_and_idempotent(self, calls):
        assert self.dist.initialize_multihost("h:1", 2, 0, device=CPU)
        assert calls[0]["rank"] == 0
        assert self.dist.initialize_multihost("h:1", 2, 0) is False
        assert len(calls) == 1

    def test_global_mesh_devices_are_this_process(self):
        import torch

        assert self.dist.global_mesh_devices(CPU) == [torch.device("cpu")]


_RANK = r"""
import os, sys
import torch
import torch.distributed as dist
from tpudas_torch.parallel.distributed import (
    initialize_multihost, is_distributed)

assert initialize_multihost(device="cpu") is True
assert initialize_multihost(device="cpu") is False  # idempotent
rank = dist.get_rank()
assert rank == int(os.environ["PROCESS_ID"]) and is_distributed()
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
assert t.item() == 3.0, t
# one right halo: rank 1's head rows extend rank 0's time shard
T_loc, C, h = 8, 3, 2
full = torch.arange(2 * T_loc * C, dtype=torch.float32).reshape(-1, C)
mine = full[rank * T_loc:(rank + 1) * T_loc]
if rank == 1:
    dist.send(mine[:h].contiguous(), dst=0)
else:
    buf = torch.empty((h, C))
    dist.recv(buf, src=1)
    assert torch.equal(torch.cat([mine, buf]), full[:T_loc + h])
dist.barrier()
dist.destroy_process_group()
print("rank-ok", rank)
"""


def test_two_gloo_processes_all_reduce_and_halo():
    """Two real processes join a ``gloo`` group from the environment the
    JAX hook reads (process 0 the coordinator), all-reduce, and pass
    one halo from rank 1 to rank 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, COORDINATOR_ADDRESS=f"localhost:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank-ok {rank}" in out
