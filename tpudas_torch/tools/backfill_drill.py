"""Multi-worker backfill chaos drill: SIGKILL + injected claim/commit
faults against one shared queue, then prove exactly-once came true.

The port's counterpart of ``tools/backfill_drill.py``, the cluster-scale
sibling of :mod:`tpudas_torch.tools.crash_drill`: one synthetic archive,
one :mod:`tpudas_torch.backfill` queue, N worker subprocesses draining
it concurrently.  The parent:

1. plans the queue over a seeded synthetic archive;
2. runs a 1-worker **uninterrupted control** (separate root, same
   plan) and a plain **sequential reference** (the realtime driver
   with pyramid + detect over the same archive);
3. keeps N chaos workers alive against the drill root, SIGKILLing a
   seeded-random live worker ``kills`` times (kill timers start at
   worker READY, so kills land in claim/drain/commit windows, not in
   ``import torch`` or the card's context creation), and handing every
   third/fourth spawn an injected fault plan that raises at
   ``backfill.claim`` / ``backfill.commit`` — a worker dying at the two
   nastiest protocol points;
4. respawns replacements until every shard is committed and the
   stitch lands (stale leases from killed workers must be reclaimed
   by the survivors — that IS the mechanism under test);
5. asserts ``audit_backfill`` is **clean** and the drill's stitched
   result is **byte-identical** to both the 1-worker control (merged
   output content, pyramid tree file-by-file, events-ledger bytes,
   score tiles, parsed detect carry) and the sequential reference;
6. reports the lease/claim/renew/commit overhead fraction from the
   done markers.

**Workers.**  Each worker is a fresh interpreter started once; it warms
up (its imports, and on the card the kernel libraries through
:func:`tpudas_torch.backfill.runner.prepare_device` and one
synchronized op) before it writes its READY marker, then drains shards
until the queue resolves.  A worker is respawned only after it died
(a kill or an injected fault).  Each worker that exits on its own
writes ``.workers/<id>.report.json``: its tally, the seconds from its
spawn to READY (``start_s``), its kernel launches and its own registry's
shard walls and store retries (:data:`REPORTED_METRICS`).

``device`` (``--device cuda|cpu``, default the card) is where the
workers, the control and the sequential reference filter;
``tdas_output`` (``--tdas-output``) writes tdas outputs for a host
without h5py, through :func:`apply_tdas_seam` — applied here, in the
drill's processes, never in the library.

CLI::

    python -m tpudas_torch.tools.backfill_drill \\
        [--workers 4] [--kills 6] [--shards 8] [--seed 0] \\
        [--device cuda|cpu] [--tdas-output] [--out PATH] [--log PATH]

``--store`` runs the drill on the OBJECT-STORE queue
(:mod:`tpudas_torch.backfill.objqueue`) instead: worker subprocesses
share NOTHING but a ``file://`` object store (each drains into a
private scratch directory), SIGKILLs land the same way, every worker's
store plane additionally rides a scripted network-fault storm
(``store.op`` raises absorbed by the retry layer), and a second
in-process leg (:func:`run_store_fault_matrix`) replays the job on the
fault-injected FAKE backend (5xx storms, lost responses, torn uploads,
latency spikes) asserting its stitched result byte-identical to an
unfaulted POSIX-store control.  ``audit_backfill_store`` must come back
clean and the materialized result byte-identical to the sequential
realtime run.

``--store --replicas N`` runs the chaos leg against a ``replica:``
store — one ``file://`` primary + N posix mirrors.  One mirror is
SEVERED (its root replaced by a plain file, so every write from every
worker subprocess fails into the hinted-handoff journal) for the whole
SIGKILL window, healed after the queue resolves, and converged by
drain + anti-entropy scrub; the drill then asserts every replica tree
is byte-identical to the primary and the result byte-identical to the
single-store control.  The in-process :func:`run_replica_drill` is the
same story on fault-injected fakes (a ``partition`` rule severs one
mirror) — it additionally proves the drain is zero-re-upload (a second
drain moves nothing, the scrub repairs nothing).

``tests/test_torch_backfill.py``, ``tests/test_torch_store_replica.py``
and ``tests/test_torch_store_backfill.py`` run it on the CPU (the
subprocess drills under ``-m slow``);
``chip_smoke.py --only backfill`` drives the same workers on the card
at 10,000 channels.
"""

from __future__ import annotations

import argparse
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
    "apply_tdas_seam",
    "main",
    "run_backfill_drill",
    "run_replica_drill",
    "run_store_backfill_drill",
    "run_store_fault_matrix",
]

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
N_CH = 4
DT_OUT = 1.0
EDGE_SEC = 5.0
PATCH_OUT = 20
SHARD_SEC = 60.0
LEASE_TTL = 15.0
DETECT_OPS = (
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5,
             "baseline": 20.0}),
)
WORKERS_DIRNAME = ".workers"


# ---------------------------------------------------------------------------
# the output seam (a host without h5py)

def _atomic_tdas_rows(staging: str, patches) -> tuple:
    """The stitch's row writer, writing each merged patch as tdas under
    the stem the library would give its ``LFDAS_*.h5``, to a per-process
    tmp name that is then ``os.replace``d into place (the audit sweeps
    only ``LFDAS_*.h5``, so a kill must never leave a torn ``.tdas``)."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.proc.naming import get_filename
    from tpudas_torch.utils.atomicio import tmp_path_for

    rows = files = 0
    for patch in patches:
        taxis = patch.coords["time"]
        if taxis.size == 0:
            continue
        name = get_filename(patch.attrs["time_min"], patch.attrs["time_max"])
        final = os.path.join(staging, os.path.splitext(name)[0] + ".tdas")
        tmp = tmp_path_for(final)
        write_tdas(patch, tmp)
        os.replace(tmp, final)
        rows += int(taxis.size)
        files += 1
    return rows, files


def apply_tdas_seam() -> None:
    """Make this process write tdas outputs: the runners' ``LFProc``
    (the crash drill's :func:`~tpudas_torch.tools.crash_drill.
    _atomic_tdas_class`) and the stitch's row writer.  Idempotent."""
    from tpudas_torch.backfill import stitch as stitch_mod
    from tpudas_torch.fleet import engine as fleet_engine
    from tpudas_torch.tools.crash_drill import _atomic_tdas_class

    if not getattr(fleet_engine.LFProc, "_tdas_seam", False):
        cls = _atomic_tdas_class(fleet_engine.LFProc)
        cls._tdas_seam = True
        fleet_engine.LFProc = cls
    stitch_mod._write_rows = _atomic_tdas_rows


def _warm_device(device):
    """The device, with (on the card) the kernel libraries loaded and
    the context created by one synchronized op."""
    import torch

    from tpudas_torch.backfill.runner import prepare_device

    dev = prepare_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    return dev


def _launches() -> dict:
    from tpudas_torch.ops.fir_kernel import fir_decimate
    from tpudas_torch.ops.fused_kernel import fused_cascade

    return {
        "fused_cascade": fused_cascade.launches,
        "fused_cascade_kernels": fused_cascade.kernel_launches,
        "fir_decimate": fir_decimate.launches,
    }


# the worker's own registry series it reports (the parent cannot read a
# worker's registry): shard walls, store retries and network errors
REPORTED_METRICS = (
    "tpudas_backfill_shard_seconds",
    "tpudas_backfill_shards_committed_total",
    "tpudas_backfill_shards_reclaimed_total",
    "tpudas_backfill_overhead_seconds_total",
    "tpudas_store_retries_total",
    "tpudas_store_network_errors_total",
    "tpudas_store_ops_total",
)


def _metric_totals(names=REPORTED_METRICS) -> dict:
    """Each metric of ``names`` summed over its label series: a
    counter's value, a histogram's ``{"count", "sum"}``."""
    from tpudas_torch.obs.registry import get_registry

    snap = get_registry().snapshot()
    out = {}
    for name in names:
        m = snap.get(name)
        series = [] if m is None else [v for _labels, v in m["series"]]
        # a histogram no process observed yet reads as an empty one
        if (m["kind"] == "histogram" if m is not None
                else name.endswith("_seconds")):
            out[name] = {"count": sum(v["count"] for v in series),
                         "sum": sum(v["sum"] for v in series)}
        else:
            out[name] = sum(series)
    return out


def _install_fault(fault: str) -> None:
    """``site:at[xN]`` — an uncaught raise at a protocol point, i.e. a
    worker dying there; ``store:at[xN]`` — a network storm at the
    ``store.op`` site, absorbed by the retry layer."""
    if not fault:
        return
    from tpudas_torch.resilience.faults import (
        FaultPlan,
        FaultSpec,
        install_fault_plan,
    )
    from tpudas_torch.store import StoreNetworkError

    site, _, rest = fault.partition(":")
    at, _, times = rest.partition("x")
    spec_kwargs = {}
    if site == "store":
        site = "store.op"
        spec_kwargs["exc"] = StoreNetworkError
    install_fault_plan(
        FaultPlan(
            FaultSpec(
                site, "raise", at=int(at or 1), times=int(times or 1),
                **spec_kwargs,
            )
        )
    )


# ---------------------------------------------------------------------------
# the worker subprocess

def _worker_main(cfg: dict) -> int:
    """One chaos worker (``cfg["mode"]`` ``"fs"`` or ``"store"``): warm
    up, optionally install an injected fault plan, mark READY, drain
    the queue, write its report."""
    t_spawn = float(cfg["spawned_unix"])
    import tpudas_torch.backfill  # noqa: F401  (the drain's imports)
    import tpudas_torch.detect.runner  # noqa: F401
    import tpudas_torch.proc.streaming  # noqa: F401

    device = _warm_device(cfg.get("device"))
    if cfg.get("tdas_output"):
        apply_tdas_seam()
    _install_fault(cfg.get("fault", ""))
    ready_dir = cfg["ready_dir"]
    wid = cfg["worker"]
    os.makedirs(ready_dir, exist_ok=True)
    t_ready = time.time()
    with open(os.path.join(ready_dir, wid + ".ready"), "w") as fh:
        fh.write(str(os.getpid()))
    if cfg["mode"] == "store":
        from tpudas_torch.backfill.objqueue import run_store_worker
        from tpudas_torch.store import store_from_url

        tally = run_store_worker(
            store_from_url(cfg["url"]), cfg["prefix"],
            scratch=cfg["scratch"], worker=wid, stitch=True,
            lease_ttl=float(cfg.get("lease_ttl", LEASE_TTL)),
            idle_poll=0.1, device=device,
        )
    else:
        from tpudas_torch.backfill import run_worker

        tally = run_worker(
            cfg["root"], worker=wid, stitch=True,
            lease_ttl=float(cfg.get("lease_ttl", LEASE_TTL)),
            settle=float(cfg.get("settle", 0.02)), idle_poll=0.1,
            device=device,
        )
    report = {
        "worker": wid, "pid": os.getpid(), "device": str(device),
        "start_s": t_ready - t_spawn, "drain_s": time.time() - t_ready,
        "launches": _launches(), "metrics": _metric_totals(),
        "tally": {k: v for k, v in tally.items() if k != "counts"},
    }
    path = os.path.join(ready_dir, wid + ".report.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(report, fh)
    os.replace(path + ".tmp", path)
    return 0


def spawn_worker(cfg: dict, log_fh=None):
    """Start one worker interpreter for ``cfg`` (see
    :func:`_worker_main`); its stdout/stderr go to ``log_fh``."""
    cfg = dict(cfg, spawned_unix=time.time())
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker-json",
         json.dumps(cfg)],
        stdout=log_fh if log_fh is not None else subprocess.DEVNULL,
        stderr=subprocess.STDOUT if log_fh is not None else (
            subprocess.DEVNULL
        ),
    )


def _spawn(root, worker_id, fault="", log_fh=None, settle=0.02,
           device=None, tdas_output=False):
    return spawn_worker(
        {"mode": "fs", "root": root, "worker": worker_id, "fault": fault,
         "settle": settle, "device": device, "tdas_output": tdas_output,
         "ready_dir": os.path.join(root, WORKERS_DIRNAME)},
        log_fh,
    )


def is_ready(ready_dir, worker_id) -> bool:
    return os.path.isfile(os.path.join(ready_dir, worker_id + ".ready"))


def worker_reports(ready_dir) -> dict:
    """``{worker: report}`` of every worker that exited on its own."""
    out = {}
    if not os.path.isdir(ready_dir):
        return out
    for name in sorted(os.listdir(ready_dir)):
        if name.endswith(".report.json"):
            with open(os.path.join(ready_dir, name)) as fh:
                rep = json.load(fh)
            out[rep["worker"]] = rep
    return out


def stop_all(procs: dict) -> None:
    """SIGKILL and reap every worker still running."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# the parent harness

def _build_archive(src: str, n_files: int) -> None:
    import numpy as np

    from tpudas_torch.testing import make_synthetic_spool

    make_synthetic_spool(
        src, n_files=n_files, file_duration=FILE_SEC, fs=FS,
        n_ch=N_CH, noise=0.01, start=np.datetime64(T0),
    )


def _plan(root: str, src: str, n_files: int) -> dict:
    import numpy as np

    from tpudas_torch.backfill import plan_backfill

    t_end = np.datetime64(T0) + np.timedelta64(
        int(n_files * FILE_SEC * 1e9), "ns"
    )
    return plan_backfill(
        root, src, T0, t_end, shard_seconds=SHARD_SEC,
        output_sample_interval=DT_OUT, edge_buffer=EDGE_SEC,
        process_patch_size=PATCH_OUT, pyramid=True, detect=True,
        detect_operators=DETECT_OPS, ingest_limit_sec=40.0,
    )


def _sequential(src: str, out: str, device) -> None:
    """The sequential reference: the realtime driver, pyramid + detect
    on — the stitched result must match a LIVE run too."""
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    run_lowpass_realtime(
        source=src, output_folder=out, start_time=T0,
        output_sample_interval=DT_OUT, edge_buffer=EDGE_SEC,
        process_patch_size=PATCH_OUT, poll_interval=0.0,
        sleep_fn=lambda _s: None, pyramid=True, detect=True,
        detect_operators=DETECT_OPS, device=device,
    )


def overhead_fraction(root: str) -> tuple:
    """(overhead_s, shard_wall_s) summed over the done markers."""
    from tpudas_torch.backfill.queue import DONE_DIRNAME
    from tpudas_torch.integrity.checksum import read_json_verified

    done_dir = os.path.join(root, DONE_DIRNAME)
    over = wall = 0.0
    for name in sorted(os.listdir(done_dir)):
        if not name.endswith(".json"):
            continue
        try:
            payload, _ = read_json_verified(
                os.path.join(done_dir, name), "backfill_done"
            )
        except (OSError, ValueError):
            continue
        over += float(payload.get("overhead_s", 0.0))
        wall += float(payload.get("wall_s", 0.0))
    return over, wall


def _chaos_loop(spawn_one, procs, ready_dir, workers, kills, rng, est,
                resolved_fn, stitched_fn, deadline, what):
    """Keep ``workers`` alive until the queue resolves and the stitch
    lands, SIGKILLing a seeded-random READY worker ``kills`` times;
    returns the kills that landed."""
    kills_done = 0
    while True:
        if time.time() > deadline:
            raise TimeoutError(f"{what} exceeded its wall limit")
        for wid in list(procs):
            if procs[wid].poll() is not None:
                del procs[wid]
        resolved = resolved_fn()
        stitched = stitched_fn()
        if resolved and stitched and not procs:
            return kills_done
        if resolved and stitched:
            time.sleep(0.1)
            continue
        if kills_done < kills and procs:
            live_ready = [w for w in sorted(procs)
                          if is_ready(ready_dir, w)]
            if live_ready:
                victim = live_ready[int(rng.integers(0, len(live_ready)))]
                time.sleep(float(rng.uniform(0.05, est)))
                if procs[victim].poll() is None:
                    os.kill(procs[victim].pid, signal.SIGKILL)
                    procs[victim].wait()
                    kills_done += 1
                del procs[victim]
        # keep the pool at strength until the queue resolves AND the
        # stitch lands — a kill landing on the last live worker
        # mid-stitch must still get a successor (which adopts or
        # re-stitches)
        while len(procs) < workers and not (resolved and stitched):
            spawn_one()
        time.sleep(0.05)


def run_backfill_drill(
    workers: int = 4,
    kills: int = 6,
    shards: int = 8,
    seed: int = 0,
    workdir: str | None = None,
    log_path: str | None = None,
    max_wall: float = 1200.0,
    device=None,
    tdas_output: bool = False,
) -> dict:
    """One full chaos drill; returns the report dict with ``ok`` True
    when the audit is clean and every byte-identity comparison holds."""
    import numpy as np

    from tpudas_torch.backfill import BackfillQueue, run_worker
    from tpudas_torch.integrity.audit import audit_backfill
    from tpudas_torch.tools.crash_drill import (
        _content_hash,
        _detect_state,
        _pyramid_tree,
    )

    if tdas_output:
        apply_tdas_seam()
    workers = int(workers)
    n_files = int(round(shards * SHARD_SEC / FILE_SEC))
    workdir = workdir or tempfile.mkdtemp(
        prefix=f"backfill_drill_w{workers}_"
    )
    src = os.path.join(workdir, "src")
    root = os.path.join(workdir, "queue")
    ctrl_root = os.path.join(workdir, "ctrl")
    seq = os.path.join(workdir, "seq")
    ready_dir = os.path.join(root, WORKERS_DIRNAME)
    log_fh = open(log_path, "ab") if log_path else None
    procs: dict = {}
    try:
        _build_archive(src, n_files)
        _plan(root, src, n_files)
        _plan(ctrl_root, src, n_files)
        # the 1-worker uninterrupted control (in-process, no faults)
        t0 = time.time()
        run_worker(
            ctrl_root, worker="ctrl", settle=0.0,
            lease_ttl=LEASE_TTL, max_wall=max_wall, device=device,
        )
        ctrl_wall = time.time() - t0
        _sequential(src, seq, device)
        # chaos: keep `workers` live against the queue, kill on a
        # seeded schedule, hand every 3rd spawn a claim fault and
        # every 4th a commit fault (an uncaught raise = a worker
        # dying at the protocol's nastiest points)
        rng = np.random.default_rng(seed)
        est = max(ctrl_wall / max(shards, 1), 0.4)
        queue = BackfillQueue(root, worker="parent", settle=0.0)
        spawn_i = 0
        faults_injected = []

        def spawn_one():
            nonlocal spawn_i
            wid = f"w{spawn_i:03d}"
            fault = ""
            if spawn_i % 3 == 1:
                fault = f"backfill.claim:{int(rng.integers(1, 4))}"
            elif spawn_i % 4 == 2:
                fault = f"backfill.commit:{int(rng.integers(1, 3))}"
            if fault:
                faults_injected.append(f"{wid}={fault}")
            procs[wid] = _spawn(root, wid, fault, log_fh, device=device,
                                tdas_output=tdas_output)
            spawn_i += 1

        for _ in range(workers):
            spawn_one()
        kills_done = _chaos_loop(
            spawn_one, procs, ready_dir, workers, kills, rng, est,
            queue.resolved,
            lambda: os.path.isfile(os.path.join(root, "result.done.json")),
            time.time() + max_wall, f"backfill drill ({queue.counts()})",
        )
        # a final clean pass picks up anything the last kill dropped
        # (also exercises the "nothing to do" worker path)
        final = run_worker(
            root, worker="final", settle=0.0, lease_ttl=LEASE_TTL,
            max_wall=max_wall, device=device,
        )
        report = audit_backfill(root, repair=True)
        res = os.path.join(root, "result")
        ctrl_res = os.path.join(ctrl_root, "result")
        over_s, wall_s = overhead_fraction(root)
        comp = {
            "outputs_match_control": (
                _content_hash(res) == _content_hash(ctrl_res)
            ),
            "pyramid_match_control": (
                _pyramid_tree(res) == _pyramid_tree(ctrl_res)
            ),
            "detect_match_control": (
                _detect_state(res) == _detect_state(ctrl_res)
            ),
            "outputs_match_sequential": (
                _content_hash(res) == _content_hash(seq)
            ),
            "pyramid_match_sequential": (
                _pyramid_tree(res) == _pyramid_tree(seq)
            ),
            "detect_match_sequential": (
                _detect_state(res) == _detect_state(seq)
            ),
        }
        ok = bool(
            report["clean"]
            and not report["parked"]
            and all(comp.values())
            and kills_done >= min(kills, 1)
        )
        return {
            "workers": workers,
            "kills": kills_done,
            "kills_requested": int(kills),
            "shards": int(shards),
            "seed": int(seed),
            "spawns": spawn_i,
            "faults_injected": faults_injected,
            "audit_clean": bool(report["clean"]),
            "audit_issues": report["issues_total"],
            "parked": report["parked"],
            **comp,
            "final_worker": {
                k: final[k]
                for k in ("committed", "adopted", "lost", "parked")
            },
            "overhead_s": round(over_s, 4),
            "shard_wall_s": round(wall_s, 4),
            "overhead_fraction": (
                round(over_s / wall_s, 5) if wall_s else None
            ),
            "ctrl_wall_s": round(ctrl_wall, 3),
            "worker_reports": worker_reports(ready_dir),
            "workdir": workdir,
            "ok": ok,
        }
    finally:
        stop_all(procs)
        if log_fh is not None:
            log_fh.close()


# ---------------------------------------------------------------------------
# the object-store drill: same chaos, no shared filesystem

def _spawn_store(url, prefix, scratch_root, ready_dir, worker_id,
                 fault="", log_fh=None, device=None, tdas_output=False):
    return spawn_worker(
        {"mode": "store", "url": url, "prefix": prefix,
         "scratch": os.path.join(scratch_root, worker_id),
         "ready_dir": ready_dir, "worker": worker_id, "fault": fault,
         "device": device, "tdas_output": tdas_output},
        log_fh,
    )


def _plan_store(store, prefix: str, src: str, n_files: int) -> dict:
    import numpy as np

    from tpudas_torch.backfill.objqueue import plan_backfill_store

    t_end = np.datetime64(T0) + np.timedelta64(
        int(n_files * FILE_SEC * 1e9), "ns"
    )
    return plan_backfill_store(
        store, prefix, src, T0, t_end, shard_seconds=SHARD_SEC,
        output_sample_interval=DT_OUT, edge_buffer=EDGE_SEC,
        process_patch_size=PATCH_OUT, pyramid=True, detect=True,
        detect_operators=DETECT_OPS, ingest_limit_sec=40.0,
    )


def materialize_result(store, prefix: str, dest: str) -> int:
    """Token-verified download of the stitched result objects."""
    from tpudas_torch.backfill.objqueue import (
        RESULT_MANIFEST_KEY,
        RESULT_PREFIX,
        StoreBackfillQueue,
    )

    queue = StoreBackfillQueue(store, prefix, worker="drill-reader")
    manifest = queue._get_verified(queue._key(RESULT_MANIFEST_KEY))[0]
    if manifest is None:
        raise RuntimeError(f"no verifying result manifest under {prefix}")
    base = queue._key(RESULT_PREFIX)
    os.makedirs(dest, exist_ok=True)
    n = 0
    for rel, tok in manifest["objects"].items():
        data, got = store.get(f"{base}/{rel}")
        if got != tok:
            raise RuntimeError(
                f"result object {rel!r} token {got!r} != manifest {tok!r}"
            )
        path = os.path.join(dest, *rel.split("/"))
        os.makedirs(os.path.dirname(path) or dest, exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)
        n += 1
    return n


def store_overhead(store, prefix: str) -> tuple:
    """(overhead_s, shard_wall_s) summed over the done markers."""
    from tpudas_torch.backfill.objqueue import (
        DONE_PREFIX,
        StoreBackfillQueue,
    )

    queue = StoreBackfillQueue(store, prefix, worker="drill-reader")
    over = wall = 0.0
    for key in store.list(queue._key(DONE_PREFIX)):
        payload = queue._get_verified(key)[0]
        if payload is None:
            continue
        over += float(payload.get("overhead_s", 0.0))
        wall += float(payload.get("wall_s", 0.0))
    return over, wall


def _run_store_control(bucket: str, src: str, n_files: int,
                       scratch: str, max_wall: float, device=None) -> str:
    """The uninterrupted POSIX-store control: plan + 1 worker over a
    ``file://`` store, result materialized locally.  Returns the
    materialized result directory."""
    from tpudas_torch.backfill.objqueue import run_store_worker
    from tpudas_torch.store import store_from_url

    store = store_from_url(f"file://{bucket}")
    _plan_store(store, "job", src, n_files)
    run_store_worker(
        store, "job", scratch=scratch, worker="ctrl",
        lease_ttl=LEASE_TTL, max_wall=max_wall, idle_poll=0.05,
        device=device,
    )
    dest = bucket + ".result"
    materialize_result(store, "job", dest)
    return dest


def run_store_fault_matrix(src: str, n_files: int, workdir: str,
                           ctrl_res: str, max_wall: float,
                           device=None) -> dict:
    """The fake-backend fault matrix: two in-process workers drain
    the job through a retry-wrapped fake store under scripted 5xx
    storms, lost responses (CAS included), torn uploads, and latency
    spikes — then the stitched result must be byte-identical to the
    unfaulted POSIX-store control and the audit clean."""
    import threading

    from tpudas_torch.backfill.objqueue import run_store_worker
    from tpudas_torch.integrity.audit import audit_backfill_store
    from tpudas_torch.store import (
        FakeObjectStore,
        FaultInjector,
        FaultRule,
        RetryingStore,
    )
    from tpudas_torch.tools.crash_drill import _content_hash, _pyramid_tree

    raw = FakeObjectStore(FaultInjector(
        # three 5xx storms scattered over the run, any op
        FaultRule(kind="unavailable", at=5, times=3),
        FaultRule(kind="unavailable", at=60, times=3),
        FaultRule(kind="unavailable", at=200, times=2),
        # lost responses on mutations, the CAS path included
        FaultRule(kind="lost", op="cas", at=2, times=1),
        FaultRule(kind="lost", op="cas", at=9, times=1),
        FaultRule(kind="lost", op="put", at=20, times=1),
        # torn uploads of shard objects (retries re-put clean)
        FaultRule(kind="torn", op="put", match="shards/", at=4,
                  times=1),
        FaultRule(kind="torn", op="put", match="shards/", at=30,
                  times=1),
        # latency spikes on reads
        FaultRule(kind="latency", op="get", at=3, times=4,
                  seconds=0.02),
    ))
    store = RetryingStore(raw, sleep_fn=lambda _s: None)
    _plan_store(store, "job", src, n_files)

    tallies = {}

    def _drain(name):
        tallies[name] = run_store_worker(
            store, "job",
            scratch=os.path.join(workdir, f"fake-scratch-{name}"),
            worker=name, max_wall=max_wall, idle_poll=0.02,
            sleep_fn=lambda _s: None, lease_ttl=LEASE_TTL, device=device,
        )

    threads = [
        threading.Thread(target=_drain, args=(f"fw{i}",))
        for i in (1, 2)
    ]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    report = audit_backfill_store(store, "job", repair=True)
    res = os.path.join(workdir, "fake-result")
    materialize_result(store, "job", res)
    fired = {}
    for kind, _op, _key, _hit in raw.injector.fired:
        fired[kind] = fired.get(kind, 0) + 1
    return {
        "faults_fired": fired,
        "audit_clean": bool(report["clean"]),
        "audit_issues": report["issues_total"],
        "committed": sum(
            t["committed"] + t["adopted"] for t in tallies.values()
        ),
        "outputs_match_posix_control": (
            _content_hash(res) == _content_hash(ctrl_res)
        ),
        "pyramid_match_posix_control": (
            _pyramid_tree(res) == _pyramid_tree(ctrl_res)
        ),
        "wall_s": round(wall, 3),
    }


def store_tree(store, prefix: str = "") -> dict:
    """{key: sha256(bytes)} of every committed object — the replica
    byte-identity comparison (tokens are crc-len; the drill compares
    actual content digests)."""
    import hashlib

    return {
        key: hashlib.sha256(store.get(key)[0]).hexdigest()
        for key in store.list(prefix)
    }


def run_replica_drill(
    shards: int = 2,
    workers: int = 2,
    workdir: str | None = None,
    max_wall: float = 600.0,
    device=None,
) -> dict:
    """The in-process replication drill: drain a small job through a
    ``ReplicatedStore`` over three fakes with ONE MIRROR SEVERED (an
    injector ``partition`` rule) for the whole run, then heal → drain
    the hinted-handoff journal → anti-entropy scrub, and assert:

    - every deferred mirror write landed in the journal and drained
      (``handoff_fully_drained``);
    - the drain was zero-re-upload: a second drain moves nothing and
      the scrub repairs nothing (``drain_idempotent``);
    - all three replica trees are byte-identical to each other AND to
      an unfaulted single-store control (``replicas_identical``,
      ``outputs_match_control``);
    - exactly ``shards`` commits happened across the workers — CAS
      pinned to the primary lost/doubled nothing
      (``commits_exact``)."""
    import threading

    from tpudas_torch.backfill.objqueue import run_store_worker
    from tpudas_torch.integrity.audit import audit_backfill_store
    from tpudas_torch.store import FakeObjectStore, RetryingStore
    from tpudas_torch.store.replica import ReplicatedStore

    n_files = int(round(shards * SHARD_SEC / FILE_SEC))
    workdir = workdir or tempfile.mkdtemp(prefix="replica_drill_")
    src = os.path.join(workdir, "src")
    _build_archive(src, n_files)

    # unfaulted single-store control
    ctrl = RetryingStore(FakeObjectStore(), sleep_fn=lambda _s: None)
    _plan_store(ctrl, "job", src, n_files)
    run_store_worker(
        ctrl, "job", scratch=os.path.join(workdir, "ctrl-scratch"),
        worker="ctrl", max_wall=max_wall, idle_poll=0.02,
        sleep_fn=lambda _s: None, lease_ttl=LEASE_TTL, device=device,
    )
    ctrl_res = os.path.join(workdir, "ctrl-result")
    materialize_result(ctrl, "job", ctrl_res)

    # the replicated store: primary + 2 mirrors, each retry-wrapped
    raws = [FakeObjectStore() for _ in range(3)]
    members = [
        RetryingStore(r, sleep_fn=lambda _s: None) for r in raws
    ]
    repl = ReplicatedStore(
        members[0], members[1:],
        journal_dir=os.path.join(workdir, "journal"),
    )
    _plan_store(repl, "job", src, n_files)
    # sever mirror 0 AFTER the plan fanned out — mid-job, every
    # subsequent write to it must fail into the handoff journal
    rule = raws[1].injector.partition()

    tallies = {}

    def _drain_job(name):
        tallies[name] = run_store_worker(
            repl, "job",
            scratch=os.path.join(workdir, f"scratch-{name}"),
            worker=name, max_wall=max_wall, idle_poll=0.02,
            sleep_fn=lambda _s: None, lease_ttl=LEASE_TTL, device=device,
        )

    threads = [
        threading.Thread(target=_drain_job, args=(f"rw{i}",))
        for i in range(int(workers))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    journaled = repl.journal.pending_counts()[0]
    # heal, drain, prove idempotence, scrub
    raws[1].injector.heal(rule)
    drained = repl.drain_handoff()
    drained_again = repl.drain_handoff()
    scrub = repl.scrub("", repair=True)
    audit = audit_backfill_store(repl, "job", repair=True)

    res = os.path.join(workdir, "result")
    materialize_result(repl, "job", res)
    trees = [store_tree(m) for m in members]
    commits = sum(
        t["committed"] + t["adopted"] for t in tallies.values()
    )
    checks = {
        "mirror_writes_journaled": journaled > 0,
        "handoff_fully_drained": (
            drained["copied"] + drained["deleted"]
            + drained["already_synced"] + drained["vanished"] > 0
            and drained["failed"] == 0
            and not any(repl.journal.pending_counts().values())
        ),
        "drain_idempotent": (
            all(v == 0 for v in drained_again.values())
            and sum(scrub["repairs"].values()) == 0
        ),
        "scrub_clean": bool(scrub["clean"]),
        "audit_clean": bool(audit["clean"]),
        "replicas_identical": (
            trees[0] == trees[1] == trees[2]
            and repl.verify_identical()
        ),
        "outputs_match_control": (
            store_tree(repl, "job/result")
            == store_tree(ctrl, "job/result")
        ),
        "commits_exact": commits == int(shards),
    }
    return {
        "mode": "replica",
        "shards": int(shards),
        "workers": int(workers),
        "journaled": journaled,
        "drained": drained,
        "scrub": {
            k: scrub[k] for k in ("repairs", "clean", "objects")
        },
        "tallies": {
            k: {kk: t[kk] for kk in ("committed", "adopted", "lost")}
            for k, t in tallies.items()
        },
        **checks,
        "workdir": workdir,
        "ok": all(checks.values()),
    }


def _sever_posix(root: str) -> None:
    """Sever a posix mirror: its root becomes a plain FILE, so every
    op from every process fails (makedirs/open raise OSError) instead
    of silently recreating a fresh tree."""
    os.rename(root, root + ".severed")
    with open(root, "w") as fh:
        fh.write("severed by backfill_drill\n")


def _heal_posix(root: str) -> None:
    os.unlink(root)
    os.rename(root + ".severed", root)


def run_store_backfill_drill(
    workers: int = 3,
    kills: int = 4,
    shards: int = 4,
    seed: int = 0,
    workdir: str | None = None,
    log_path: str | None = None,
    max_wall: float = 1200.0,
    replicas: int = 0,
    device=None,
    tdas_output: bool = False,
) -> dict:
    """The object-store chaos drill: worker subprocesses sharing only
    a ``file://`` object store, SIGKILLed on a seeded schedule, with
    protocol-point deaths and per-worker network storms injected —
    then the audit must be clean and the result byte-identical to the
    POSIX-store control AND the sequential realtime run; the fake
    fault-matrix leg rides on the same archive.

    ``replicas=N`` (N >= 1) runs the same chaos against a
    ``replica:`` store with N posix mirrors; mirror 1 is severed (root
    replaced by a file) for the whole SIGKILL window and healed after
    the queue resolves — the audit's scrub must then converge every
    replica tree byte-identical to the primary."""
    import numpy as np

    from tpudas_torch.backfill.objqueue import StoreBackfillQueue
    from tpudas_torch.integrity.audit import audit_backfill_store
    from tpudas_torch.store import store_from_url
    from tpudas_torch.tools.crash_drill import (
        _content_hash,
        _detect_state,
        _pyramid_tree,
    )

    if tdas_output:
        apply_tdas_seam()
    workers = int(workers)
    replicas = int(replicas)
    n_files = int(round(shards * SHARD_SEC / FILE_SEC))
    workdir = workdir or tempfile.mkdtemp(
        prefix=f"store_drill_w{workers}_"
    )
    src = os.path.join(workdir, "src")
    bucket = os.path.join(workdir, "bucket")
    ctrl_bucket = os.path.join(workdir, "bucket_ctrl")
    scratch_root = os.path.join(workdir, "scratch")
    ready_dir = os.path.join(workdir, WORKERS_DIRNAME)
    seq = os.path.join(workdir, "seq")
    url = f"file://{bucket}"
    mirror_roots = []
    env_before = os.environ.get("TPUDAS_REPLICA_JOURNAL")
    if replicas:
        mirror_roots = [
            os.path.join(workdir, f"bucket_m{i + 1}")
            for i in range(replicas)
        ]
        url = "replica:" + ",".join(
            [f"file://{bucket}"]
            + [f"file://{r}" for r in mirror_roots]
        )
        # one shared journal dir: worker subprocesses append their
        # own m<i>-<pid>.jsonl files there, the parent drains them —
        # a killed worker's deferred writes survive its death
        os.environ["TPUDAS_REPLICA_JOURNAL"] = os.path.join(
            workdir, "handoff-journal"
        )
    prefix = "job"
    severed = False
    log_fh = open(log_path, "ab") if log_path else None
    procs: dict = {}
    try:
        _build_archive(src, n_files)
        store = store_from_url(url)
        _plan_store(store, prefix, src, n_files)
        t0 = time.time()
        ctrl_res = _run_store_control(
            ctrl_bucket, src, n_files,
            os.path.join(workdir, "ctrl-scratch"), max_wall, device,
        )
        ctrl_wall = time.time() - t0
        _sequential(src, seq, device)
        rng = np.random.default_rng(seed)
        est = max(ctrl_wall / max(shards, 1), 0.4)
        queue = StoreBackfillQueue(store, prefix, worker="parent")
        done_key = queue._key("result.done.json")
        spawn_i = 0
        faults_injected = []

        def spawn_one():
            nonlocal spawn_i
            wid = f"w{spawn_i:03d}"
            fault = ""
            if spawn_i % 3 == 1:
                fault = f"backfill.claim:{int(rng.integers(1, 4))}"
            elif spawn_i % 4 == 2:
                fault = f"backfill.commit:{int(rng.integers(1, 3))}"
            elif spawn_i % 4 == 3:
                # a network storm this worker's retry layer must absorb
                fault = f"store:{int(rng.integers(3, 40))}x3"
            if fault:
                faults_injected.append(f"{wid}={fault}")
            procs[wid] = _spawn_store(
                url, prefix, scratch_root, ready_dir, wid, fault,
                log_fh, device=device, tdas_output=tdas_output,
            )
            spawn_i += 1

        for _ in range(workers):
            spawn_one()
        if replicas:
            # sever mirror 1 for the ENTIRE chaos window: every
            # worker's fan-out writes to it must fail into the
            # shared handoff journal (or, for writes a SIGKILL raced,
            # be found by the scrub's token diff)
            _sever_posix(mirror_roots[0])
            severed = True
        kills_done = _chaos_loop(
            spawn_one, procs, ready_dir, workers, kills, rng, est,
            queue.resolved, lambda: store.head(done_key) is not None,
            time.time() + max_wall, "store drill",
        )
        replica_block = None
        if replicas:
            # heal the severed mirror; the audit below runs the
            # anti-entropy scrub (journal drain + token-diff repair)
            _heal_posix(mirror_roots[0])
            severed = False
        report = audit_backfill_store(store, prefix, repair=True)
        if replicas:
            from tpudas_torch.store.replica import find_replicated

            repl = find_replicated(store)
            trees = [
                store_tree(m)
                for m in (repl.primary, *repl.mirrors)
            ]
            replica_block = {
                "replicas": replicas,
                "scrub": {
                    k: report["replication"][k]
                    for k in ("drained", "repairs", "clean")
                },
                "handoff_pending": repl.journal.pending_counts(),
                "replicas_identical": all(
                    t == trees[0] for t in trees[1:]
                ),
            }
        res = os.path.join(workdir, "result")
        materialize_result(store, prefix, res)
        over_s, wall_s = store_overhead(store, prefix)
        comp = {
            "outputs_match_control": (
                _content_hash(res) == _content_hash(ctrl_res)
            ),
            "pyramid_match_control": (
                _pyramid_tree(res) == _pyramid_tree(ctrl_res)
            ),
            "detect_match_control": (
                _detect_state(res) == _detect_state(ctrl_res)
            ),
            "outputs_match_sequential": (
                _content_hash(res) == _content_hash(seq)
            ),
            "pyramid_match_sequential": (
                _pyramid_tree(res) == _pyramid_tree(seq)
            ),
            "detect_match_sequential": (
                _detect_state(res) == _detect_state(seq)
            ),
        }
        matrix = run_store_fault_matrix(
            src, n_files, workdir, ctrl_res, max_wall, device,
        )
        ok = bool(
            report["clean"]
            and not report["parked"]
            and all(comp.values())
            and kills_done >= min(kills, 1)
            and matrix["audit_clean"]
            and matrix["outputs_match_posix_control"]
            and matrix["pyramid_match_posix_control"]
            and (replica_block is None or (
                replica_block["replicas_identical"]
                and replica_block["scrub"]["clean"]
                and not any(
                    replica_block["handoff_pending"].values()
                )
            ))
        )
        return {
            "mode": "store" if not replicas else "store-replica",
            "replication": replica_block,
            "workers": workers,
            "kills": kills_done,
            "kills_requested": int(kills),
            "shards": int(shards),
            "seed": int(seed),
            "spawns": spawn_i,
            "faults_injected": faults_injected,
            "audit_clean": bool(report["clean"]),
            "audit_issues": report["issues_total"],
            "parked": report["parked"],
            **comp,
            "fault_matrix": matrix,
            "overhead_s": round(over_s, 4),
            "shard_wall_s": round(wall_s, 4),
            "overhead_fraction": (
                round(over_s / wall_s, 5) if wall_s else None
            ),
            "ctrl_wall_s": round(ctrl_wall, 3),
            "worker_reports": worker_reports(ready_dir),
            "workdir": workdir,
            "ok": ok,
        }
    finally:
        stop_all(procs)
        if severed:
            _heal_posix(mirror_roots[0])
        if replicas:
            if env_before is None:
                os.environ.pop("TPUDAS_REPLICA_JOURNAL", None)
            else:
                os.environ["TPUDAS_REPLICA_JOURNAL"] = env_before
        if log_fh is not None:
            log_fh.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--kills", type=int, default=6)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the workers filter (default cuda; cpu "
                    "runs the plain versions)")
    ap.add_argument("--tdas-output", action="store_true",
                    help="write tdas outputs (a host without h5py)")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--log", default=None, help="worker stdout log file")
    ap.add_argument(
        "--store", action="store_true",
        help="drill the object-store queue (file:// chaos leg + "
             "fault-injected fake backend leg) instead of the "
             "shared-filesystem queue",
    )
    ap.add_argument(
        "--replicas", type=int, default=0, metavar="N",
        help="with --store: drill a replica: store with N posix "
             "mirrors, one severed for the SIGKILL window then "
             "healed + scrubbed",
    )
    args = ap.parse_args(argv)
    if args.replicas and not args.store:
        ap.error("--replicas requires --store")
    if args.device in (None, "cuda"):
        from tpudas_torch.device import resolve_device
        from tpudas_torch.ops._build import build_libraries

        resolve_device(args.device)  # no card: raise before any worker
        build_libraries(("fir_decimate", "fused_cascade"))
    run = run_store_backfill_drill if args.store else run_backfill_drill
    kwargs = {}
    if args.store:
        kwargs["replicas"] = args.replicas
    rep = run(
        workers=args.workers, kills=args.kills, shards=args.shards,
        seed=args.seed, log_path=args.log, device=args.device,
        tdas_output=args.tdas_output, **kwargs,
    )
    print(json.dumps(
        {k: v for k, v in rep.items() if k != "workdir"}, indent=1
    ))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rep, fh, indent=1)
    print(f"backfill_drill: {'OK' if rep['ok'] else 'FAILED'}")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker-json":
        sys.exit(_worker_main(json.loads(sys.argv[2])))
    sys.exit(main())
