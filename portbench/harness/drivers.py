"""The general traffic drivers.  A traffic file names one by its
``driver`` key and gives its parameters; the driver runs the program
over the cell's pool, closed loop, and says which outputs are due.
``archive`` and ``catchup`` are built in; any other name is the file
``portbench/drivers/<driver>.py``, whose ``Driver`` class has the
interface of :class:`_Driver` (:func:`load_driver`).

``archive``: batch reprocessing.  One ``LFProc`` job, as a user's
archive job holds one; each pass is ``process_time_range`` over the
whole pool into a fresh output folder, one pass at a time.

``catchup``: an edge box catching up after an outage.  Each replay is
a fresh ``run_lowpass_realtime`` runner in a fresh output folder over a
fresh watched folder that holds the pool's first ``initial_files``
files; at each poll the interrogator (this driver) hard-links the next
``files_per_poll`` files in, so the backlog costs no new bytes.  The
clock is virtual: the poll's sleep returns at once.  The runner ends
when the spool stops growing; the next replay restarts it.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import time

import numpy as np
import torch

from portbench.harness.program import lfproc_class
from portbench.harness.trace import annotate
from portbench.yardstick import plan as P

PB_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRY = ".stream_carry.npz"  # the stream's committed carry, by its name


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _buff(cfg) -> int:
    return int(np.ceil(float(cfg["edge_buffer"])
                       / float(cfg["output_sample_interval"])))


class _Driver:
    """``setup`` builds the program and runs the warm jobs; ``window``
    runs jobs closed loop for a number of seconds; ``timings``,
    ``segments`` and the static ``due(cfg, pool, traffic, pb_dir)``
    (the outputs a job makes due, as (r0, r1, grid indices) segments)
    feed the metrics and the check; ``close`` undoes the set-up."""

    def __init__(self, cfg, traffic, pool, device, workdir, probe):
        self.cfg, self.traffic, self.pool = cfg, traffic, pool
        self.device, self.workdir, self.probe = device, workdir, probe
        self.n_rows = pool["rows_file"] * pool["n_files"]
        self.folders = []  # output folders of the measured window
        self.walls = []  # each pass's or round's wall, seconds
        self.jobs = 0  # passes or replays in the window

    def work_samples(self) -> int:
        """Input channel-samples the window's jobs committed."""
        return self.jobs * self.n_rows * int(self.pool["n_ch"])


class Archive(_Driver):
    def setup(self):
        from tpudas_torch.io.spool import spool

        cls = lfproc_class(self.probe)
        src = os.path.dirname(self.pool["paths"][0])
        self.lfp = cls(spool(src).sort("time").update(),
                       device=self.device)
        self.lfp.update_processing_parameter(
            output_sample_interval=float(self.cfg["output_sample_interval"]),
            process_patch_size=int(self.cfg["process_patch_size"]),
            edge_buff_size=_buff(self.cfg),
            engine=self.cfg["engine"],
            filter_order=int(self.cfg["filter_order"]),
        )
        self.bg = np.datetime64(int(self.pool["t0_ns"]), "ns")
        self.ed = np.datetime64(
            int(self.pool["t0_ns"] + self.n_rows * self.pool["dt_ns"]), "ns")
        for i in range(int(self.traffic["warm_passes"])):
            folder = os.path.join(self.workdir, f"warm{i}")
            mark = self.probe.mark()
            self._pass(folder)
            self.probe.check(mark, folder)

    def _pass(self, folder):
        self.lfp.set_output_folder(folder)
        self.lfp.process_time_range(self.bg, self.ed)
        _sync(self.device)

    def window(self, seconds, tracing):
        self.timings0 = dict(self.lfp.timings)
        t0 = time.perf_counter()
        while True:
            folder = os.path.join(self.workdir, f"pass{self.jobs:04d}")
            mark = self.probe.mark()
            ts = time.perf_counter()
            with annotate("pb.pass", tracing):
                self._pass(folder)
            self.walls.append(time.perf_counter() - ts)
            self.probe.check(mark, folder)
            self.folders.append(folder)
            self.jobs += 1
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def timings(self) -> dict:
        return {k: v - self.timings0.get(k, 0.0)
                for k, v in self.lfp.timings.items()}

    def segments(self, pb_dir=None) -> list:
        return self.due(self.cfg, self.pool, self.traffic, pb_dir)

    @staticmethod
    def due(cfg, pool, traffic, pb_dir=None) -> list:
        """[(r0, r1, grid indices)]: each scheduled window's rows and
        the grid points it emits."""
        n_rows = pool["rows_file"] * pool["n_files"]
        grid = P.time_grid(pool["t0_ns"],
                           pool["t0_ns"] + n_rows * pool["dt_ns"],
                           float(cfg["output_sample_interval"]))
        out = []
        for sl, sh, el, eh in P.schedule_windows(
                len(grid), int(cfg["process_patch_size"]), _buff(cfg)):
            r0, r1 = P.rows_between(grid[sl], grid[sh], pool["t0_ns"],
                                    pool["dt_ns"], n_rows)
            out.append((r0, r1, list(range(el, eh))))
        return out

    def close(self):
        self.lfp = None


class Catchup(_Driver):
    def setup(self):
        import tpudas_torch.fleet.engine as fleet_engine

        # the runner builds its LFProc each round from this module name
        self._engine_mod = fleet_engine
        self._saved_cls = fleet_engine.LFProc
        fleet_engine.LFProc = lfproc_class(self.probe)
        for i in range(int(self.traffic["warm_replays"])):
            self._replay(f"warm{i}", tracing=False)

    def _replay(self, tag, tracing):
        from tpudas_torch.proc.streaming import run_lowpass_realtime

        src = os.path.join(self.workdir, f"src_{tag}")
        out = os.path.join(self.workdir, f"out_{tag}")
        os.makedirs(src)
        paths = list(self.pool["paths"])
        first = int(self.traffic["initial_files"])
        per_poll = int(self.traffic["files_per_poll"])

        def link(upto):
            for p in paths[:upto]:
                dst = os.path.join(src, os.path.basename(p))
                if not os.path.exists(dst):
                    os.link(p, dst)

        linked = [first]
        link(first)
        mark = self.probe.mark()
        bounds, walls = [time.perf_counter()], []

        def sleep(_delay):
            bounds.append(time.perf_counter())
            if linked[0] < len(paths):
                linked[0] = min(len(paths), linked[0] + per_poll)
                link(linked[0])

        def on_round(_rnd, _lfp):
            walls.append(time.perf_counter() - bounds[-1])

        with annotate("pb.replay", tracing):
            rounds = run_lowpass_realtime(
                src, out, np.datetime64(int(self.pool["t0_ns"]), "ns"),
                output_sample_interval=float(
                    self.cfg["output_sample_interval"]),
                edge_buffer=float(self.cfg["edge_buffer"]),
                process_patch_size=int(self.cfg["process_patch_size"]),
                poll_interval=0.0, sleep_fn=sleep, on_round=on_round,
                engine=self.cfg["engine"],
                filter_order=int(self.cfg["filter_order"]),
                device=self.device,
            )
            _sync(self.device)
        if linked[0] != len(paths):
            raise RuntimeError(f"replay {tag} ended with {linked[0]} of "
                               f"{len(paths)} files linked")
        if rounds != len(walls):
            raise RuntimeError(f"replay {tag}: {rounds} rounds, "
                               f"{len(walls)} round callbacks")
        self.probe.check(mark, out)
        check_carry(out)
        return out, walls

    def window(self, seconds, tracing):
        t0 = time.perf_counter()
        while True:
            out, walls = self._replay(f"{self.jobs:04d}", tracing)
            self.folders.append(out)
            self.walls.extend(walls)
            self.jobs += 1
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def timings(self) -> dict:
        return {}

    def segments(self, pb_dir=None) -> list:
        return self.due(self.cfg, self.pool, self.traffic, pb_dir)

    @staticmethod
    def due(cfg, pool, traffic, pb_dir=None) -> list:
        """The configuration's reference's own ``stream_segments`` of
        the traffic, where it has one (a stream that filters block by
        block); else one segment: the stream holds every row from its
        start and emits from the edge buffer on as far as whole steps
        arrived."""
        from portbench.yardstick import reference

        ref = reference.load_engine_reference(
            cfg["reference"], pb_dir or reference.PB_DIR)
        if hasattr(ref, "stream_segments"):
            return ref.stream_segments(cfg, pool, traffic)
        n_rows = pool["rows_file"] * pool["n_files"]
        first, last = ref.stream_emits(cfg, n_rows)
        return [(0, n_rows, list(range(first, last + 1)))]

    def close(self):
        self._engine_mod.LFProc = self._saved_cls


def check_carry(folder):
    """Raise unless ``folder`` holds the stream's carry, last written at
    or after its newest ``LFDAS_`` output; then remove everything in it
    but those outputs."""
    names = os.listdir(folder)
    outputs = [os.stat(os.path.join(folder, n)).st_mtime_ns
               for n in names if n.startswith("LFDAS_")]
    carry = (os.stat(os.path.join(folder, CARRY)).st_mtime_ns
             if CARRY in names else None)
    if carry is None or (outputs and carry < max(outputs)):
        raise RuntimeError(
            f"the stream broke its commit order in {folder}: carry "
            f"{'missing' if carry is None else f'written at {carry} ns'}"
            f", newest of {len(outputs)} outputs at "
            f"{max(outputs, default=None)} ns")
    for n in names:
        if not n.startswith("LFDAS_"):
            path = os.path.join(folder, n)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)


DRIVERS = {"archive": Archive, "catchup": Catchup}


def load_driver(name: str, pb_dir: str = PB_DIR):
    """The driver class a traffic file names: a built-in one, else the
    ``Driver`` of ``drivers/<name>.py``, loaded by its file."""
    if name in DRIVERS:
        return DRIVERS[name]
    path = os.path.join(pb_dir, "drivers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "pb_driver_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver
