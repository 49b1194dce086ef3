"""Process-level crash drill: SIGKILL the port's realtime driver at seeded
random points, then prove the folder audits clean and resumes byte for
byte.

The port's counterpart of ``tools/crash_drill.py``.  The drill kills the
*process* (``SIGKILL``: no handlers, no cleanup, the power-cut model) at
points drawn from a seeded RNG, so a kill can land inside any write:
mid-``np.savez`` of the carry, between a score tile and its manifest,
inside an output file.

One drill (per engine):

1. feed a source spool and run two uninterrupted worker cycles (cold,
   then warm) to calibrate the processing wall time;
2. for each of N cycles: feed one more interrogator file — but only
   when the previous cycle ran to completion (epoch gating, below) —
   start the driver in a fresh interpreter (``subprocess.Popen``:
   stateful carry and the detect operators on) and SIGKILL it
   ``uniform(0.02, 0.95 * calib)`` seconds after it is ready;
3. run one final uninterrupted cycle to drain, then assert that
   :func:`tpudas_torch.integrity.audit.audit` reports **clean** (every
   worker already audited and repaired at startup, so this run must
   find nothing left) and that no worker's startup audit raised;
4. replay the same epoch schedule uninterrupted into a fresh control
   folder (its feed hard-linked from the drilled one) and assert:

   - the merged output content (time grid + float32 samples) is byte
     for byte the same — file boundaries depend on the round schedule,
     so files are compared by merged content, not by name;
   - the stream carry is the same, parsed (meta and every array);
   - the tile pyramid is the same file by file (tiles, tails and
     manifest; ``.prev`` rungs and tmp leftovers excluded, they depend
     on the append schedule): ``pyramid_match`` and ``pyramid_files``;
   - the detect state is the same: the events ledger byte for byte,
     the score tiles file by file, and the detect carry parsed (the
     ``.npz`` container embeds zip timestamps).

**Epoch gating.**  The carry advances only when a round completes, so
every processing attempt spans [end of the last completed epoch → end
of the fed data]: holding the feed fixed until a cycle completes makes
the killed run's consumption schedule equal to an uninterrupted run
over the same epochs — the strongest claim that can hold byte for byte,
because the FFT engine's per-block masking depends on the block
schedule.

**Workers.**  Each cycle runs in a fresh interpreter
(``subprocess.Popen``, never a fork), started ahead of its cycle
(:class:`_WorkerPool`, ``PREWARM`` at a time): it warms up — its
imports, and on the card the kernel libraries and one synchronized op —
then waits for its task, and writes ``<out>.ready`` when it starts it,
so kills land in processing, not in ``import torch`` or in context
creation, and the seconds a process takes to reach the card overlap the
cycles before it.  The parent builds the libraries before the first
cycle (:func:`tpudas_torch.ops._build.build_libraries`), so no worker
runs nvcc.  Each worker prints one JSON line
(``{"drill_worker": ...}``) after its startup audit, after each
committed round and at exit: its audit errors and repairs, the audit's
seconds, the seconds from ready to the round's commit, and its kernel
launches.  ``recover_s`` in the report is, for every cycle that follows
a killed one, the seconds from its ready marker to its first committed
round: the user's time to recover.

The workers and the control run with the tile pyramid and the health
files on (``pyramid=True``, ``health=True``) and the flight recorder at
its default (on), as the JAX drill's do.  Right after the kill cycles,
before the drain, :func:`_flight_replay_check` reads the drilled
folder's flight ring as an operator arriving at the killed box would:
the last committed round's ``round`` record must carry every phase and
be preceded by that round's ``stream.round`` span.  Its keys are the
report's ``flight`` entry and its ``ok`` joins the drill's; the flight
repairs the workers' startup audits made are in ``flight_repairs``.

``--live`` drills the live push plane: every drilled cycle runs with
``TPUDAS_LIVE=1`` and ``--live-subs`` in-process subscribers attached
after its first round and never drained (``TPUDAS_CRASH_DRILL_SUBS``),
so kills land while the degrade ladder sheds, and the control replays
live-off.  The live plane holds no durable state, so the comparisons
above are the whole claim for it.  Not with ``--streams``.

``--mesh N`` channel-shards every drilled cycle over N devices
(``TPUDAS_MESH=N`` in the workers: N cards, or N logical CPU shards
with ``--device cpu``), while the control replays on a single device:
the sharded path must survive the kills and stay byte-identical to the
unsharded run.  Not with ``--streams``.

CLI:

    python3 tpudas_torch/tools/crash_drill.py [--cycles 25] [--seed 0] \\
        [--engines fused,auto,fft] [--device cuda|cpu] [--streams N \\
        [--batched]] [--async-ingest] [--live [--live-subs 32]] \\
        [--mesh N] [--tdas-output] [--workdir DIR] [--out PATH] \\
        [--log PATH]

``tests/test_torch_crash_drill.py`` runs a small seeded smoke on the
CPU in tier-1 and more cycles under ``-m slow``; ``chip_smoke.py --only
crash`` runs it on the card at 10,000 channels.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

if __package__ in (None, ""):  # run as a script: put the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

__all__ = [
    "DETECT_OPS",
    "ENGINES",
    "SMALL",
    "main",
    "run_drill",
    "run_fleet_drill",
]

T0 = "2023-03-22T00:00:00"
ENGINES = ("fused", "auto", "fft")
# thresholds for which the drill's noisy synthetic stream yields ledger
# events (an empty ledger would match vacuously)
DETECT_OPS = (
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5, "baseline": 20.0}),
)
# the JAX drill's stream: 50 Hz x 4 channels in 20 s dasdae files, 1 s
# output, 5 s edge buffer
SMALL = {
    "fs": 50.0, "file_sec": 20.0, "n_ch": 4, "noise": 0.01,
    "format": "dasdae", "write_kwargs": None, "dt_out": 1.0,
    "edge": 5.0, "patch_out": 20, "detect_ops": DETECT_OPS,
}
WORKER_MAX_ROUNDS = 8
# a fresh worker interpreter's warm-up (imports, the card's context),
# from its launch; then its task's ready marker, from the end of the
# warm-up or the task's hand-over, whichever is later
START_TIMEOUT_S = 300.0
READY_TIMEOUT_S = 300.0
RUN_TIMEOUT_S = 600.0
STANDBY_MAX_S = 3600.0  # a started worker's longest wait for its task
PREWARM = 2  # workers started ahead of their cycle
_LINE_KEY = "drill_worker"


# ---------------------------------------------------------------------------
# the worker (runs in the process being killed)

def _atomic_tdas_class(base):
    """A subclass of ``base`` (an ``LFProc``) writing each output as
    tdas under the same stem, to a per-process tmp name that is then
    ``os.replace``d into place: a kill leaves a ``*.tmp.<pid>`` the
    audit sweeps, never a torn output the spool would read."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.utils.atomicio import tmp_path_for

    class AtomicTdasOutput(base):
        def _write_output(self, patch, path):
            final = os.path.splitext(path)[0] + ".tdas"
            tmp = tmp_path_for(final)
            write_tdas(patch, tmp)
            os.replace(tmp, final)

    return AtomicTdasOutput


def _worker_counts() -> dict:
    """This process's kernel launches, startup-audit counters and
    swallowed pyramid-append errors."""
    from tpudas_torch.obs.registry import get_registry
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    reg = get_registry()
    return {
        "audit_errors": reg.value("tpudas_integrity_audit_errors_total"),
        "audit_runs": reg.value("tpudas_integrity_audit_runs_total"),
        "audit_seconds": reg.histogram(
            "tpudas_integrity_audit_seconds").snapshot()["sum"],
        "pyramid_errors": reg.value("tpudas_serve_pyramid_errors_total"),
        "launches": {
            "fused_cascade": fused_cascade.launches,
            "fused_cascade_kernels": fused_cascade.kernel_launches,
            "fir_decimate": fir_decimate.launches,
        },
    }


def _say(event: str, t_ready: float, **extra) -> None:
    line = {"event": event, "pid": os.getpid(),
            "since_ready_s": time.time() - t_ready, **_worker_counts(),
            **extra}
    print(json.dumps({_LINE_KEY: line}), flush=True)


def _warm_up(cfg: dict, engine: str, state: dict):
    """Everything before the task: the round's imports, the output seam,
    the kernel libraries and the card's context; each startup audit then
    reports its repairs (``state["t_ready"]`` dates the lines).  Returns
    the device."""
    if engine == "fused":
        # the CPU drill stream is tiny: drop the fused size threshold so
        # the drilled path is the fused step
        os.environ.setdefault("TPUDAS_FUSED_MIN_ELEMS", "0")
    import importlib.util

    import scipy.signal  # noqa: F401  (the filter designs of round 1)
    import torch

    import tpudas_torch.detect.runner  # noqa: F401
    import tpudas_torch.fleet.fleet  # noqa: F401
    import tpudas_torch.proc.streaming  # noqa: F401
    from tpudas_torch.device import resolve_device
    from tpudas_torch.fleet import engine as fleet_engine
    audit_mod = importlib.import_module("tpudas_torch.integrity.audit")

    if importlib.util.find_spec("h5py") is not None:
        import h5py  # noqa: F401  (the dasdae reader and writer)

    device = resolve_device(cfg.get("device"))
    if cfg.get("tdas_output"):
        fleet_engine.LFProc = _atomic_tdas_class(fleet_engine.LFProc)
    if device.type == "cuda":
        from tpudas_torch.ops._build import load_library

        for name in ("fir_decimate", "fused_cascade"):
            load_library(name)
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize()
    real_audit = audit_mod.audit

    def reporting_audit(folder, *a, **k):
        rep = real_audit(folder, *a, **k)
        repairs: dict = {}
        for it in rep["issues"]:
            repairs[it["action"]] = repairs.get(it["action"], 0) + 1
        _say("audit", state["t_ready"], repairs=repairs,
             clean=rep["clean"], folder=os.path.basename(folder),
             issues=[[it["artifact"], os.path.relpath(it["path"], folder),
                      it["status"], it["action"], it["detail"]]
                     for it in rep["issues"]])
        return rep

    audit_mod.audit = reporting_audit
    return device


def _wait_for_task(slot: str):
    """The task the parent writes to ``<slot>/go.json``; None when the
    parent is gone or none came within ``STANDBY_MAX_S``."""
    parent = os.getppid()
    go = os.path.join(slot, "go.json")
    t0 = time.time()
    while not os.path.isfile(go):
        if os.getppid() != parent or time.time() - t0 > STANDBY_MAX_S:
            return None
        time.sleep(0.005)
    with open(go) as fh:
        return json.load(fh)


def _stream_kwargs(cfg: dict, engine: str) -> dict:
    return dict(
        start_time=T0, output_sample_interval=cfg["dt_out"],
        edge_buffer=cfg["edge"], process_patch_size=cfg["patch_out"],
        poll_interval=0.0, engine=engine, stateful=True, detect=True,
        detect_operators=[tuple(op) for op in cfg["detect_ops"]],
        pyramid=True, health=True,
    )


def _worker(slot: str, engine: str, cfg: dict) -> int:
    """A worker process: warm up, mark ``<slot>/warm``, wait for the
    task, write the ready marker, then run the driver — the plain
    ``run_lowpass_realtime``, or with ``streams`` > 0 one
    ``FleetEngine`` over N streams with the same per-stream
    configuration (so each stream's single-stream control is the plain
    worker)."""
    state = {"t_ready": None}
    device = _warm_up(cfg, engine, state)
    with open(os.path.join(slot, "warm"), "w") as fh:
        fh.write(repr(time.time()))
    task = _wait_for_task(slot)
    if task is None:
        return 0
    os.environ.update(task["env"])
    src, out, streams = task["src"], task["out"], int(task["streams"])
    os.makedirs(out, exist_ok=True)
    state["t_ready"] = t_ready = time.time()
    with open(out + ".ready", "w") as fh:
        fh.write(str(os.getpid()))
    kw = _stream_kwargs(cfg, engine)
    sleep = lambda _s: time.sleep(0.01)  # noqa: E731
    # --live: a roster of never-drained subscribers, attached once the
    # hub exists, so kills land while the degrade ladder sheds (the
    # live plane is memory only: nothing durable may change for it)
    n_subs = int(os.environ.get("TPUDAS_CRASH_DRILL_SUBS", "0"))
    attached: list = []

    def on_round(rnd, _lfp):
        if n_subs and not attached:
            from tpudas_torch.live.hub import find_hub

            hub = find_hub(folder=out)
            if hub is not None:
                attached.extend(hub.subscribe() for _ in range(n_subs))
        _say("round", t_ready, round=rnd)

    if streams:
        from tpudas_torch.fleet import FleetEngine, StreamConfig, StreamSpec

        config = StreamConfig(kind="lowpass", **kw)
        specs = [StreamSpec(stream_id=f"s{i:02d}",
                            source=os.path.join(src, f"s{i:02d}"),
                            config=config) for i in range(streams)]
        FleetEngine(out, specs, max_rounds=WORKER_MAX_ROUNDS, sleep_fn=sleep,
                    device=device,
                    on_round=lambda sid, rnd, _lfp: _say(
                        "round", t_ready, round=rnd, stream=sid)).run()
    else:
        from tpudas_torch.proc.streaming import run_lowpass_realtime

        run_lowpass_realtime(
            src, out, kw.pop("start_time"), device=device, sleep_fn=sleep,
            max_rounds=WORKER_MAX_ROUNDS, on_round=on_round, **kw)
    _say("exit", t_ready)
    return 0


# ---------------------------------------------------------------------------
# the parent harness

def _feed(src: str, first_index: int, n_files: int, cfg: dict) -> list:
    """Write ``n_files`` interrogator files into ``src``, continuing the
    stream at file ``first_index``; returns their names."""
    import numpy as np

    from tpudas_torch.testing import make_synthetic_spool

    start = np.datetime64(T0, "ns") + np.timedelta64(
        int(round(first_index * cfg["file_sec"] * 1e9)), "ns")
    paths = make_synthetic_spool(
        src, n_files=n_files, file_duration=cfg["file_sec"], fs=cfg["fs"],
        n_ch=cfg["n_ch"], noise=cfg["noise"], start=start,
        format=cfg["format"], prefix=f"raw{first_index:04d}",
        write_kwargs=cfg["write_kwargs"])
    return [os.path.basename(p) for p in paths]


def _link(src_from: str, src_to: str, names) -> None:
    """Hard-link ``names`` of ``src_from`` into ``src_to``."""
    os.makedirs(src_to, exist_ok=True)
    for name in names:
        dst = os.path.join(src_to, name)
        if not os.path.exists(dst):
            os.link(os.path.join(src_from, name), dst)


def _rm_ready(out: str) -> None:
    try:
        os.remove(out + ".ready")
    except OSError:
        pass


def _worker_lines(log_file: str) -> list:
    lines = []
    with open(log_file, "rb") as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw.startswith(b"{"):
                continue
            try:
                obj = json.loads(raw)
            except ValueError:
                continue  # a line a kill cut short
            if isinstance(obj, dict) and _LINE_KEY in obj:
                lines.append(obj[_LINE_KEY])
    return lines


class _WorkerPool:
    """Worker processes started ahead of their cycle.  Each is a fresh
    interpreter (``subprocess.Popen``, never a fork of this process)
    that warms up — imports, the card's context, the kernel libraries —
    and then waits for its task, so the seconds a process takes to
    reach the card overlap the cycles before it.  ``PREWARM`` workers
    wait at any time; :meth:`close` stops them."""

    def __init__(self, engine: str, cfg: dict, logs: str):
        self.engine, self.cfg, self.logs = engine, cfg, logs
        self.waiting: list = []
        self.count = 0
        os.makedirs(logs, exist_ok=True)
        env = dict(os.environ)
        env.pop("TPUDAS_MESH", None)
        if env.pop("PYTHONDONTWRITEBYTECODE", None):
            # where no bytecode is written, the workers share one cache
            # of their own: each interpreter after the first imports
            # without compiling
            env.setdefault("PYTHONPYCACHEPREFIX",
                           os.path.join(os.path.dirname(logs), "pycache"))
        self.env = env

    def prewarm(self) -> None:
        """Start ``PREWARM`` workers now, so their warm-up overlaps the
        caller's set-up (the first feed)."""
        while len(self.waiting) < PREWARM:
            self._start()

    def _start(self) -> None:
        slot = os.path.join(self.logs, f"worker-{self.count:04d}")
        self.count += 1
        os.makedirs(slot)
        log_fh = open(slot + ".log", "wb")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", slot,
             self.engine, json.dumps(self.cfg)],
            env=self.env, stdout=log_fh, stderr=subprocess.STDOUT)
        self.waiting.append({"proc": proc, "slot": slot, "log_fh": log_fh,
                             "log_file": slot + ".log",
                             "started": time.time()})

    def take(self, upcoming=None) -> dict:
        """The next worker; then keep ``PREWARM`` waiting, or as many as
        the ``upcoming`` cycles after this one need."""
        if not self.waiting:
            self._start()
        worker = self.waiting.pop(0)
        want = PREWARM if upcoming is None else min(PREWARM, upcoming)
        while len(self.waiting) < want:
            self._start()
        return worker

    def close(self) -> None:
        for worker in self.waiting:
            _stop(worker)
        self.waiting = []


def _stop(worker: dict) -> None:
    proc = worker["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)
    worker["log_fh"].close()


def _run_cycle(pool, src, out, kill_after, streams=0, env_extra=None,
               upcoming=None, log_path=None, ready_timeout=READY_TIMEOUT_S,
               run_timeout=RUN_TIMEOUT_S) -> dict:
    """One cycle on the pool's next worker; ``kill_after`` seconds after
    it is ready send SIGKILL (None: let it finish, within
    ``run_timeout``).  The worker must end its warm-up within
    :data:`START_TIMEOUT_S` of its launch, then be ready within
    ``ready_timeout`` (a fresh interpreter's imports are slow on a
    loaded host, not hung).  ``streams`` > 0 runs the fleet (``src``
    is then the root holding one spool per stream).  ``env_extra`` overlays the
    worker's environment; ``upcoming`` counts the cycles still to come,
    when known.  Returns {killed, start, wall, work, lines}:
    the seconds from the worker's start to the end of its warm-up, from
    ready to the end (or the kill), from ready to its exit line (None
    when killed), and its JSON lines (``_LINE_KEY``)."""
    _rm_ready(out)
    worker = pool.take(upcoming)
    proc, log_file = worker["proc"], worker["log_file"]
    task = {"src": src, "out": out, "streams": int(streams),
            "env": dict(env_extra or {})}
    go = os.path.join(worker["slot"], "go.json")
    with open(go + ".tmp", "w") as fh:
        json.dump(task, fh)
    os.replace(go + ".tmp", go)
    killed = False
    try:
        ready = out + ".ready"
        warm = os.path.join(worker["slot"], "warm")
        t_warm = None  # when this wait saw the warm-up end
        while not os.path.isfile(ready):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"crash-drill worker exited rc={proc.returncode} "
                    f"before becoming ready (see {log_file})")
            now = time.time()
            if t_warm is None and os.path.isfile(warm):
                t_warm = now
            if t_warm is None:
                if now - worker["started"] > START_TIMEOUT_S:
                    raise RuntimeError(
                        f"crash-drill worker not warm {START_TIMEOUT_S} s "
                        f"after its launch (see {log_file})")
            elif now - t_warm > ready_timeout:
                raise RuntimeError(
                    f"crash-drill worker not ready in {ready_timeout} s "
                    f"(see {log_file})")
            time.sleep(0.002)
        t_ready = time.time()
        if kill_after is None:
            try:
                proc.wait(timeout=run_timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"crash-drill worker still running after "
                    f"{run_timeout} s (see {log_file})") from None
            if proc.returncode != 0:
                raise RuntimeError(
                    f"uninterrupted crash-drill worker failed "
                    f"rc={proc.returncode} (see {log_file})")
        else:
            while proc.poll() is None and time.time() - t_ready < kill_after:
                time.sleep(0.002)
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
                killed = True
            elif proc.returncode != 0:
                raise RuntimeError(
                    f"crash-drill worker failed rc={proc.returncode} "
                    f"(see {log_file})")
        wall = time.time() - t_ready
    finally:
        _stop(worker)
    if log_path:
        with open(log_file, "rb") as src_fh, open(log_path, "ab") as dst:
            dst.write(src_fh.read())
    with open(os.path.join(worker["slot"], "warm")) as fh:
        start = float(fh.read()) - worker["started"]
    lines = _worker_lines(log_file)
    # the worker's own work: ready to its exit line (the interpreter's
    # teardown after it is no crash window)
    work = next((ln["since_ready_s"] for ln in lines
                 if ln["event"] == "exit"), None)
    return {"killed": killed, "start": start, "wall": wall, "work": work,
            "lines": lines}


def _content_hash(folder: str) -> str:
    """sha256 of the merged output content: the ns time grid plus the
    float32 samples, whatever the file boundaries."""
    import numpy as np

    from tpudas_torch.io.spool import spool as make_spool

    h = hashlib.sha256()
    sp = make_spool(folder).sort("time").update()
    for patch in sp.chunk(time=None):
        d = patch.host_data()
        ax = patch.axis_of("time")
        if ax != 0:
            d = np.moveaxis(d, ax, 0)
        times = (np.asarray(patch.coords["time"])
                 .astype("datetime64[ns]").astype(np.int64))
        h.update(times.tobytes())
        h.update(np.ascontiguousarray(np.asarray(d, np.float32)).tobytes())
    return h.hexdigest()


def _output_difference(a: str, b: str):
    """Where the merged outputs of folders ``a`` and ``b`` first differ,
    in words; None when they are equal."""
    import numpy as np

    from tpudas_torch.io.spool import spool as make_spool

    def merged(folder):
        return make_spool(folder).sort("time").update().chunk(time=None)

    pa, pb = merged(a), merged(b)
    if len(pa) != len(pb):
        return f"{len(pa)} merged patches against {len(pb)}"
    for i, (x, y) in enumerate(zip(pa, pb)):
        tx = np.asarray(x.coords["time"]).astype("datetime64[ns]")
        ty = np.asarray(y.coords["time"]).astype("datetime64[ns]")
        if tx.shape != ty.shape or (tx != ty).any():
            n = min(tx.size, ty.size)
            k = int(np.argmax(tx[:n] != ty[:n])) if (tx[:n] != ty[:n]).any() \
                else n
            return (f"patch {i}: time grids differ ({tx.size} against "
                    f"{ty.size} samples, first at index {k})")
        dx = np.asarray(x.host_data(), np.float32)
        dy = np.asarray(y.host_data(), np.float32)
        if x.axis_of("time") != 0:
            dx = np.moveaxis(dx, x.axis_of("time"), 0)
            dy = np.moveaxis(dy, y.axis_of("time"), 0)
        bad = dx.view(np.uint32) != dy.view(np.uint32)
        if bad.any():
            r, c = (int(v) for v in np.argwhere(bad)[0])
            rows = np.unique(np.nonzero(bad)[0])
            return (f"patch {i}: {int(bad.sum())} samples differ in "
                    f"{rows.size} rows, first at {tx[r]} channel {c} "
                    f"({dx[r, c]!r} against {dy[r, c]!r})")
    return None


def _carry_difference(a: str, b: str):
    """The stream-carry fields and arrays of ``a`` and ``b`` that
    differ, in words; None when they are equal."""
    import numpy as np

    from tpudas_torch.proc.stream import load_carry

    ca, cb = load_carry(a), load_carry(b)
    if ca is None or cb is None:
        return f"carry present: {ca is not None} against {cb is not None}"
    ma, mb = ca._meta(), cb._meta()
    diff = [f"{k}: {ma[k]!r} against {mb.get(k)!r}" for k in ma
            if ma[k] != mb.get(k)]
    for i, (x, y) in enumerate(zip(ca.bufs, cb.bufs)):
        if np.asarray(x).tobytes() != np.asarray(y).tobytes():
            diff.append(f"buf_{i}")
    ra, rb = ca.residual, cb.residual
    if (ra is None) != (rb is None) or (
            ra is not None and np.asarray(ra).tobytes()
            != np.asarray(rb).tobytes()):
        diff.append("residual")
    return "; ".join(diff) or None


def _hash_arrays(h, meta: dict, arrays) -> None:
    import numpy as np

    h.update(json.dumps(meta, sort_keys=True).encode())
    for key, arr in arrays:
        arr = np.asarray(arr)
        h.update(str(key).encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())


def _carry_state(folder: str):
    """sha256 of the stream carry, parsed (meta and every array; the
    ``.npz`` container embeds zip timestamps), or None without one."""
    from tpudas_torch.proc.stream import load_carry

    carry = load_carry(folder)
    if carry is None:
        return None
    arrays = [(f"buf_{i}", b) for i, b in enumerate(carry.bufs)]
    if carry.residual is not None:
        arrays.append(("residual", carry.residual))
    h = hashlib.sha256()
    _hash_arrays(h, carry._meta(), arrays)
    return h.hexdigest()


def _pyramid_tree(folder: str) -> dict:
    """{relpath: sha256} of the pyramid files (``.prev`` rungs and tmp
    leftovers excluded — they depend on the append schedule)."""
    from tpudas_torch.serve.tiles import TILE_DIRNAME
    from tpudas_torch.utils.atomicio import is_tmp_name

    tiles = os.path.join(folder, TILE_DIRNAME)
    out = {}
    for dirpath, _dirnames, filenames in os.walk(tiles):
        for name in sorted(filenames):
            if ".prev" in name or is_tmp_name(name):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()
            out[os.path.relpath(path, tiles)] = digest
    return out


def _detect_state(folder: str) -> dict:
    """The committed detect state, ready to compare: the ledger's bytes,
    a digest of every score tile and tails file, and a digest of the
    parsed detect carry.  ``.prev`` rungs depend on the commit schedule
    and are left out."""
    from tpudas_torch.detect.ledger import DETECT_DIRNAME, ScoreStore
    from tpudas_torch.detect.runner import load_detect_carry
    from tpudas_torch.utils.atomicio import is_tmp_name

    det = os.path.join(folder, DETECT_DIRNAME)
    out: dict = {"present": os.path.isdir(det)}
    if not out["present"]:
        return out
    ledger = os.path.join(det, "events.jsonl")
    if os.path.isfile(ledger):
        with open(ledger, "rb") as fh:
            out["ledger_sha"] = hashlib.sha256(fh.read()).hexdigest()
    carry = load_detect_carry(folder)
    if carry is not None:
        h = hashlib.sha256()
        _hash_arrays(h, carry["meta"], [
            (f"op{i}_{key}", st[key])
            for i, st in enumerate(carry["states"]) for key in sorted(st)])
        out["carry_sha"] = h.hexdigest()
    scores = ScoreStore.scores_dir(folder)
    tree = {}
    if os.path.isdir(scores):
        for name in sorted(os.listdir(scores)):
            if ".prev" in name or is_tmp_name(name):
                continue
            path = os.path.join(scores, name)
            if os.path.isfile(path):
                with open(path, "rb") as fh:
                    tree[name] = hashlib.sha256(fh.read()).hexdigest()
    out["scores"] = tree
    return out


def _worker_summary(cycles: list) -> dict:
    """Sum the workers' last JSON lines: audit errors, repairs (and the
    flight-ring repairs among them) and seconds, swallowed pyramid
    errors, kernel launches; ``recover_s`` of every cycle that followed
    a killed one; each worker's seconds from its start to ready."""
    errors, launches, repairs, audit_s, recover = 0, {}, {}, [], []
    flight_repairs: dict = {}
    pyramid_errors = 0
    prev_killed = False
    for cyc in cycles:
        lines = cyc["lines"]
        if lines:
            last = lines[-1]
            errors += int(last["audit_errors"])
            pyramid_errors += int(last["pyramid_errors"])
            for k, v in last["launches"].items():
                launches[k] = launches.get(k, 0) + int(v)
        for ln in lines:
            if ln["event"] == "audit":
                cyc["audit_issues"] = ln["issues"]
                audit_s.append(ln["audit_seconds"])
                for k, v in ln["repairs"].items():
                    repairs[k] = repairs.get(k, 0) + int(v)
                for it in ln["issues"]:
                    if it[0] == "flight":
                        flight_repairs[it[3]] = (
                            flight_repairs.get(it[3], 0) + 1)
        first_round = next((ln for ln in lines if ln["event"] == "round"),
                           None)
        cyc["recover_s"] = (first_round["since_ready_s"]
                            if prev_killed and first_round else None)
        if cyc["recover_s"] is not None:
            recover.append(cyc["recover_s"])
        prev_killed = cyc["killed"]
    return {"audit_errors": errors, "pyramid_errors": pyramid_errors,
            "audit_repairs": repairs, "flight_repairs": flight_repairs,
            "audit_seconds": audit_s, "launches": launches,
            "recover_s": recover,
            "worker_start_s": [cyc["start"] for cyc in cycles]}


def _flight_replay_check(folder: str) -> dict:
    """What the on-disk flight ring holds at the moment an operator
    would arrive at a SIGKILLed box (taken right after the kill cycles,
    before the drain): the last committed round's record, with all its
    phases, preceded by that round's spans.  The recorder flushes a
    round's spans and its ``round`` record in one write, so a surviving
    round record implies its spans survived too; this checks that end
    to end."""
    from tpudas_torch.obs.flight import read_flight
    from tpudas_torch.obs.phases import PHASES

    recs = read_flight(folder)
    rounds = [r for r in recs if r.get("kind") == "round"]
    if not rounds:
        return {"ok": False, "rounds": 0,
                "reason": "no committed round records in the ring"}
    last = rounds[-1]
    spans = [
        r for r in recs
        if r.get("kind") == "span" and r.get("round") == last["round"]
    ]
    has_round_span = any(r.get("name") == "stream.round" for r in spans)
    phases_complete = sorted(last.get("phases", {})) == sorted(PHASES)
    return {
        "ok": bool(has_round_span and phases_complete),
        "rounds": len(rounds),
        "last_round": last.get("round"),
        "last_round_spans": len(spans),
        "phases_complete": phases_complete,
        "records_total": len(recs),
    }


def _kill_cycles(run, cycles, seed, est, feed_next):
    """The seeded SIGKILL cycles with epoch gating: ``feed_next()`` adds
    the next epoch's files, ``run(kill_after)`` one cycle.  Returns the
    cycles' records."""
    import numpy as np

    rng = np.random.default_rng(seed)
    log = []
    advance = True  # the last cycle completed its epoch
    for _c in range(int(cycles)):
        if advance:
            feed_next()
        kill_after = float(rng.uniform(0.02, est * 0.95))
        r = run(kill_after)
        advance = not r["killed"]
        if not r["killed"]:
            # the worker outran the timer: track its real work so later
            # draws keep landing inside the work window
            est = max(0.5 * est + 0.5 * (r["work"] or r["wall"]), 0.2)
        log.append({"kill_after": kill_after, **r})
    return log


def _cycle_record(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "lines"}


def run_drill(engine: str = "fused", cycles: int = 25, seed: int = 0,
              workdir: str | None = None, files_init: int = 2,
              files_per_cycle: int = 1, log_path: str | None = None,
              async_ingest: bool = False, device=None, shape=None,
              tdas_output: bool = False, feed=None,
              ready_timeout=READY_TIMEOUT_S,
              run_timeout=RUN_TIMEOUT_S, live: bool = False,
              live_subs: int = 32, mesh: int = 0) -> dict:
    """One full drill for ``engine``; returns the report with ``ok``
    True when the final audit is clean, no startup audit raised, and the
    outputs, the stream carry, the pyramid and the detect state match
    the control's.

    ``device`` is where the workers filter (default the CUDA card;
    ``"cpu"`` runs the plain versions).  ``shape`` overrides
    :data:`SMALL`'s stream (rate, width, file length, format, output
    parameters, detect operators).  ``tdas_output`` makes the workers
    write tdas outputs (for a host without h5py).  ``feed(src,
    first_index, n_files)`` writes the stream's files ``first_index``
    on into ``src`` and returns their names (default: synthesized at
    ``shape``).  ``async_ingest`` runs every drilled cycle with
    ``TPUDAS_INGEST_PREFETCH=2`` and the control with the synchronous
    slice loop (``0``).  ``live`` runs every drilled cycle with the live
    push plane on and ``live_subs`` never-drained subscribers
    (``TPUDAS_LIVE=1``), the control live-off.  ``mesh`` > 0 runs every
    drilled cycle channel-sharded over that many devices
    (``TPUDAS_MESH``), the control on a single device."""
    from tpudas_torch.integrity.audit import audit

    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    cfg = {**SMALL, **(shape or {}), "device": device,
           "tdas_output": bool(tdas_output)}
    tag = (f"crash_drill_{engine}_" + ("async_" if async_ingest else "")
           + ("live_" if live else "") + (f"mesh{mesh}_" if mesh else ""))
    workdir = workdir or tempfile.mkdtemp(prefix=tag)
    src = os.path.join(workdir, "src")
    out = os.path.join(workdir, "out")
    ctrl = os.path.join(workdir, "ctrl")
    logs = os.path.join(workdir, "logs")
    drill_env: dict = {}
    ctrl_env: dict = {}
    if async_ingest:
        drill_env["TPUDAS_INGEST_PREFETCH"] = "2"
        ctrl_env["TPUDAS_INGEST_PREFETCH"] = "0"
    if live:
        drill_env["TPUDAS_LIVE"] = "1"
        drill_env["TPUDAS_CRASH_DRILL_SUBS"] = str(int(live_subs))
        ctrl_env["TPUDAS_LIVE"] = "0"
    if mesh:
        # the workers' pool drops TPUDAS_MESH, so the control is the
        # single-device run
        drill_env["TPUDAS_MESH"] = str(int(mesh))
    limits = dict(log_path=log_path, ready_timeout=ready_timeout,
                  run_timeout=run_timeout)

    pool = _WorkerPool(engine, cfg, logs)

    def cycle(kill_after, where=src, to=out, env=drill_env, upcoming=None):
        return _run_cycle(pool, where, to, kill_after, env_extra=env,
                          upcoming=upcoming, **limits)

    feed = feed or (lambda where, first, n: _feed(where, first, n, cfg))
    t_start = time.time()
    # epochs: every feed event's file names, replayed for the control
    epochs = []
    n_files = [files_init]

    def feed_next():
        epochs.append(feed(src, n_files[0], files_per_cycle))
        n_files[0] += files_per_cycle

    try:
        pool.prewarm()  # the first workers warm up during the first feed
        epochs.append(feed(src, 0, files_init))
        cold = cycle(None)  # seeds the carry
        feed_next()
        warm = cycle(None)  # the estimate the kill times are drawn from
        log = _kill_cycles(cycle, cycles, seed,
                           max(warm["work"] or warm["wall"], 0.2), feed_next)
        # the flight ring as the kills left it, before the drain
        flight = _flight_replay_check(out)
        drain = cycle(None)  # the resumed run finishes what the kills left
        report = audit(out, repair=True)
        ctrl_cycles = []
        for i, names in enumerate(epochs):
            _link(src, os.path.join(workdir, "ctrl_src"), names)
            ctrl_cycles.append(cycle(
                None, os.path.join(workdir, "ctrl_src"), ctrl, ctrl_env,
                upcoming=len(epochs) - 1 - i))
    finally:
        pool.close()
    drilled = [cold, warm, *log, drain]
    summary = _worker_summary(drilled)
    summary["control_pyramid_errors"] = _worker_summary(
        ctrl_cycles)["pyramid_errors"]
    outputs_match = _content_hash(out) == _content_hash(ctrl)
    carry_out, carry_ctrl = _carry_state(out), _carry_state(ctrl)
    carry_match = carry_out is not None and carry_out == carry_ctrl
    det_out, det_ctrl = _detect_state(out), _detect_state(ctrl)
    detect_match = det_out == det_ctrl
    pyr_out, pyr_ctrl = _pyramid_tree(out), _pyramid_tree(ctrl)
    pyramid_match = pyr_out == pyr_ctrl
    # what differs first, for the report of a failed drill
    difference = {
        "outputs": None if outputs_match else _output_difference(out, ctrl),
        "carry": None if carry_match else _carry_difference(out, ctrl),
        "pyramid": None if pyramid_match else sorted(
            k for k in set(pyr_out) | set(pyr_ctrl)
            if pyr_out.get(k) != pyr_ctrl.get(k)),
        "detect": None if detect_match else sorted(
            k for k in set(det_out) | set(det_ctrl)
            if det_out.get(k) != det_ctrl.get(k)),
    }
    detect_events = 0
    if det_out.get("ledger_sha"):
        from tpudas_torch.detect.ledger import load_events

        detect_events = len(load_events(out))
    clean = bool(report["clean"])
    return {
        "engine": engine,
        "device": str(device) if device is not None else "cuda",
        "async_ingest": bool(async_ingest),
        "live": bool(live),
        "live_subs": int(live_subs) if live else 0,
        "mesh": int(mesh),
        "cycles": int(cycles),
        "seed": int(seed),
        "kills": sum(int(r["killed"]) for r in log),
        "epochs": len(epochs),
        "cold_wall_s": cold["wall"],
        "warm_wall_s": warm["wall"],
        "warm_work_s": warm["work"],
        "drill_wall_s": time.time() - t_start,
        "audit_clean": clean,
        "audit_issues": len(report["issues"]),
        "final_audit_s": report["elapsed_s"],
        "outputs_match": bool(outputs_match),
        "carry_match": bool(carry_match),
        "pyramid_match": bool(pyramid_match),
        "pyramid_files": len(pyr_out),
        "detect_match": bool(detect_match),
        "detect_events": int(detect_events),
        "flight": flight,
        "difference": difference,
        **summary,
        "cycle_log": [_cycle_record(r) for r in log],
        "drain": _cycle_record(drain),
        "workdir": workdir,
        "ok": bool(clean and outputs_match and carry_match
                   and pyramid_match and detect_match and flight["ok"]
                   and summary["audit_errors"] == 0),
    }


def run_fleet_drill(engine: str = "fused", streams: int = 4,
                    cycles: int = 12, seed: int = 0,
                    workdir: str | None = None, files_init: int = 2,
                    files_per_cycle: int = 1, log_path: str | None = None,
                    batched: bool = False, device=None, shape=None,
                    tdas_output: bool = False, feed=None,
                    ready_timeout=READY_TIMEOUT_S,
                    run_timeout=RUN_TIMEOUT_S) -> dict:
    """The fleet drill: SIGKILL a ``streams``-wide
    :class:`~tpudas_torch.fleet.FleetEngine` mid-interleave for
    ``cycles`` seeded cycles, then prove
    :func:`~tpudas_torch.integrity.audit.audit_fleet` is clean and every
    stream's outputs, carry, pyramid and detect state equal a single-stream
    control replay of the same epoch schedule.  Every stream is fed the
    same files each epoch (hard links), so one control covers all N.
    ``batched`` runs the drilled cycles with ``TPUDAS_FLEET_BATCHED=1``
    (stacked steps); the control never batches.  ``device``, ``shape``,
    ``tdas_output`` and ``feed`` are :func:`run_drill`'s."""
    from tpudas_torch.integrity.audit import audit_fleet

    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    cfg = {**SMALL, **(shape or {}), "device": device,
           "tdas_output": bool(tdas_output)}
    streams = int(streams)
    drill_env = {"TPUDAS_FLEET_BATCHED": "1" if batched else "0"}
    workdir = workdir or tempfile.mkdtemp(
        prefix=f"crash_drill_fleet{streams}_{engine}_")
    files = os.path.join(workdir, "files")
    src_root = os.path.join(workdir, "src")
    out = os.path.join(workdir, "out")
    ctrl = os.path.join(workdir, "ctrl")
    logs = os.path.join(workdir, "logs")
    sids = [f"s{i:02d}" for i in range(streams)]
    limits = dict(log_path=log_path, ready_timeout=ready_timeout,
                  run_timeout=run_timeout)

    pool = _WorkerPool(engine, cfg, logs)

    def fleet_cycle(kill_after):
        return _run_cycle(pool, src_root, out, kill_after, streams=streams,
                          env_extra=drill_env, **limits)

    write = feed or (lambda where, first, n: _feed(where, first, n, cfg))
    epochs = []
    n_files = [0]

    def feed(count):
        names = write(files, n_files[0], count)
        for sid in sids:
            _link(files, os.path.join(src_root, sid), names)
        epochs.append(names)
        n_files[0] += count

    t_start = time.time()
    try:
        pool.prewarm()  # the first workers warm up during the first feed
        feed(files_init)
        cold = fleet_cycle(None)
        feed(files_per_cycle)
        warm = fleet_cycle(None)
        log = _kill_cycles(fleet_cycle, cycles, seed,
                           max(warm["work"] or warm["wall"], 0.2),
                           lambda: feed(files_per_cycle))
        drain = fleet_cycle(None)
        report = audit_fleet(out, repair=True)
        ctrl_src = os.path.join(workdir, "ctrl_src")
        ctrl_cycles = []
        for i, names in enumerate(epochs):
            _link(files, ctrl_src, names)
            ctrl_cycles.append(_run_cycle(
                pool, ctrl_src, ctrl, None, upcoming=len(epochs) - 1 - i,
                **limits))
    finally:
        pool.close()
    summary = _worker_summary([cold, warm, *log, drain])
    summary["control_pyramid_errors"] = _worker_summary(
        ctrl_cycles)["pyramid_errors"]
    ctrl_hash = _content_hash(ctrl)
    ctrl_carry = _carry_state(ctrl)
    ctrl_det = _detect_state(ctrl)
    ctrl_pyr = _pyramid_tree(ctrl)
    detect_events = 0
    if ctrl_det.get("ledger_sha"):
        from tpudas_torch.detect.ledger import load_events

        detect_events = len(load_events(ctrl))
    per_stream = {}
    for sid in sids:
        sdir = os.path.join(out, sid)
        entry = {
            "outputs_match": _content_hash(sdir) == ctrl_hash,
            "carry_match": (ctrl_carry is not None
                            and _carry_state(sdir) == ctrl_carry),
            "pyramid_match": _pyramid_tree(sdir) == ctrl_pyr,
            "detect_match": _detect_state(sdir) == ctrl_det,
        }
        entry["ok"] = all(entry.values())
        entry["pyramid_files"] = len(_pyramid_tree(sdir))
        per_stream[sid] = entry
    all_match = all(e["ok"] for e in per_stream.values())
    return {
        "engine": engine,
        "device": str(device) if device is not None else "cuda",
        "streams": streams,
        "batched": bool(batched),
        "cycles": int(cycles),
        "seed": int(seed),
        "kills": sum(int(r["killed"]) for r in log),
        "epochs": len(epochs),
        "cold_wall_s": cold["wall"],
        "warm_wall_s": warm["wall"],
        "warm_work_s": warm["work"],
        "drill_wall_s": time.time() - t_start,
        "audit_clean": bool(report["clean"]),
        "audit_issues": report["issues_total"],
        "streams_match": per_stream,
        "detect_events": int(detect_events),
        **summary,
        "cycle_log": [_cycle_record(r) for r in log],
        "workdir": workdir,
        "ok": bool(report["clean"] and all_match
                   and summary["audit_errors"] == 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engines", default="fused,auto,fft",
                    help="comma-separated list of fused, auto and fft")
    ap.add_argument("--device", default=None,
                    help="where the workers filter (default cuda; cpu "
                    "runs the plain versions)")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--log", default=None, help="worker stdout log file")
    ap.add_argument("--workdir", default=None,
                    help="drill scratch directory (default: a fresh "
                    "mkdtemp), one subdirectory per engine")
    ap.add_argument("--streams", type=int, default=0,
                    help="drill a FleetEngine of N streams in one process "
                    "per cycle (each stream compared to a single-stream "
                    "control)")
    ap.add_argument("--batched", action="store_true",
                    help="run the drilled fleet cycles batched "
                    "(TPUDAS_FLEET_BATCHED=1); requires --streams")
    ap.add_argument("--async-ingest", action="store_true",
                    help="drilled cycles with TPUDAS_INGEST_PREFETCH=2, "
                    "the control with 0; not with --streams")
    ap.add_argument("--tdas-output", action="store_true",
                    help="workers write tdas outputs (a host without h5py)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="channel-shard the drilled cycles over N devices "
                    "(TPUDAS_MESH=N), the control single-device; not with "
                    "--streams")
    ap.add_argument("--live", action="store_true",
                    help="drilled cycles with the live push plane on "
                    "(TPUDAS_LIVE=1) and --live-subs never-drained "
                    "subscribers, the control live-off; not with "
                    "--streams")
    ap.add_argument("--live-subs", type=int, default=32,
                    help="in-process subscribers per drilled cycle for "
                    "--live")
    args = ap.parse_args(argv)
    if args.streams and args.mesh:
        ap.error("--streams and --mesh are mutually exclusive")
    if args.batched and not args.streams:
        ap.error("--batched drills the fleet scheduler; requires --streams")
    if args.streams and args.async_ingest:
        ap.error("--async-ingest drills the single-stream worker")
    if args.streams and args.live:
        ap.error("--live drills the single-stream worker")
    if args.device in (None, "cuda"):
        from tpudas_torch.device import resolve_device
        from tpudas_torch.ops._build import build_libraries

        resolve_device(args.device)  # no card: raise before any cycle
        build_libraries(("fir_decimate", "fused_cascade"))
    results = {}
    ok = True
    for engine in [e for e in args.engines.split(",") if e]:
        wd = os.path.join(args.workdir, engine) if args.workdir else None
        common = dict(engine=engine, cycles=args.cycles, seed=args.seed,
                      log_path=args.log, workdir=wd, device=args.device,
                      tdas_output=args.tdas_output)
        if args.streams:
            print(f"crash_drill: engine={engine} cycles={args.cycles} "
                  f"seed={args.seed} streams={args.streams} "
                  f"batched={int(args.batched)}", flush=True)
            rep = run_fleet_drill(streams=args.streams, batched=args.batched,
                                  **common)
            matched = sum(1 for s in rep["streams_match"].values()
                          if s["ok"])
            print(f"crash_drill: {engine}: kills={rep['kills']} "
                  f"audit_clean={rep['audit_clean']} "
                  f"audit_errors={rep['audit_errors']} "
                  f"streams_match={matched}/{rep['streams']} "
                  f"(events={rep['detect_events']})", flush=True)
        else:
            print(f"crash_drill: engine={engine} cycles={args.cycles} "
                  f"seed={args.seed} async_ingest={args.async_ingest} "
                  f"live={args.live} mesh={args.mesh}", flush=True)
            rep = run_drill(async_ingest=args.async_ingest, live=args.live,
                            live_subs=args.live_subs, mesh=args.mesh,
                            **common)
            print(f"crash_drill: {engine}: kills={rep['kills']} "
                  f"audit_clean={rep['audit_clean']} "
                  f"audit_errors={rep['audit_errors']} "
                  f"outputs_match={rep['outputs_match']} "
                  f"carry_match={rep['carry_match']} "
                  f"pyramid_match={rep['pyramid_match']} "
                  f"(files={rep['pyramid_files']}) "
                  f"detect_match={rep['detect_match']} "
                  f"(events={rep['detect_events']}, "
                  f"recover_s={rep['recover_s']}) "
                  f"flight_replay={rep['flight']['ok']} "
                  f"(flight_rounds={rep['flight']['rounds']})", flush=True)
        results[engine] = rep
        ok = ok and rep["ok"]
    payload = {"cycles": args.cycles, "seed": args.seed,
               "streams": args.streams, "batched": args.batched,
               "async_ingest": args.async_ingest, "live": args.live,
               "mesh": args.mesh, "device": args.device,
               "ok": ok, "engines": results}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    print(f"crash_drill: {'OK' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        sys.exit(_worker(sys.argv[2], sys.argv[3], json.loads(sys.argv[4])))
    sys.exit(main())
