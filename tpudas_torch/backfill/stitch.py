"""Deterministic stitching: N committed shards → one sequential result.

Once every shard is committed, the stitched result is a pure function
of the plan and the shard bytes — so ANY worker (or all of them,
racing) can build it, and a 4-worker chaos run must produce a result
**byte-identical** to a single-worker uninterrupted control:

1. **Rows.**  For each shard in plan order, read its output files and
   keep only the rows on ``[t0, t1)`` (the first shard keeps its
   initial transient, the last keeps its tail) — the warm-up lead
   made every kept row bit-identical to the sequential run's, so
   concatenation IS the sequential output.  Rows are written to the
   result as one deterministic file per contiguous segment per shard
   (file *boundaries* differ from a realtime run's round-schedule
   chunking, which is why output equality is judged on merged content
   — exactly the crash drill's rule).
2. **Pyramid.**  ``sync_pyramid`` over the stitched files — the
   offline oracle the realtime incremental append is already proven
   byte-identical to, so the tile/tails/manifest bytes match a live
   run's.
3. **Detect.**  A fresh :class:`~tpudas_torch.detect.runner.DetectPipeline`
   file-backed catch-up over the stitched rows — operators are
   chunk-invariant by contract, so the events ledger and score tiles
   are byte-identical to a live run's.
4. **Commit.**  The same commit-wins discipline as shards: build in
   ``result.work.<token>``, one atomic rename to ``result/``, then
   the crc-stamped ``result.done.json`` marker (a crash between the
   two is adopted by ``audit_backfill``).
"""

from __future__ import annotations

import os
import shutil
import time as _time

import numpy as np

from tpudas_torch.backfill.queue import (
    RESULT_DIRNAME,
    RESULT_DONE_FILENAME,
    BackfillQueue,
    commit_rename,
)
from tpudas_torch.integrity.checksum import write_json_checksummed
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import fault_point
from tpudas_torch.utils.logging import log_event

__all__ = ["stitch_backfill"]


def _write_rows(staging: str, patches) -> tuple[int, int]:
    """Write merged patches as result output files; returns
    (rows, files)."""
    from tpudas_torch.io.registry import write_patch
    from tpudas_torch.proc.naming import get_filename

    rows = files = 0
    for patch in patches:
        taxis = patch.coords["time"]
        if taxis.size == 0:
            continue
        name = get_filename(patch.attrs["time_min"], patch.attrs["time_max"])
        write_patch(patch, os.path.join(staging, name), "dasdae")
        rows += int(taxis.size)
        files += 1
    return rows, files


def _shard_window(plan: dict, idx: int):
    """The keep-window for shard ``idx``: ``[t0, t1)`` as inclusive
    ns datetime64 select bounds (``t1 - 1 ns`` so the boundary row
    belongs to exactly one shard); open at the archive's ends so the
    first shard keeps the initial transient and the last its tail."""
    shards = plan["shards"]
    sh = shards[idx]
    lo = (
        None if idx == 0
        else np.datetime64(int(sh["t0_ns"]), "ns")
    )
    hi = (
        None if idx == len(shards) - 1
        else np.datetime64(int(sh["t1_ns"]) - 1, "ns")
    )
    return lo, hi


def _write_result_marker(done_path, queue, rows, files, shards,
                         wall_s, adopted=False) -> None:
    payload = {
        "worker": queue.worker,
        "rows": int(rows),
        "files": int(files),
        "shards": int(shards),
        "wall_s": round(float(wall_s), 4),
    }
    if adopted:
        payload["adopted"] = True
    write_json_checksummed(done_path, payload, durable=True)


def _adopt_result(root, queue, final, done_path) -> dict | None:
    """Finish a crashed stitch commit: ``result/`` exists (the rename
    landed — a complete stitch by construction) but the marker is
    missing.  Verify the directory and write the marker, mirroring
    the shard commit's adoption; a directory that does not verify is
    removed so the next call re-stitches.  Returns the status dict,
    or None when the adoption failed (re-stitch)."""
    from tpudas_torch.integrity.audit import audit

    report = audit(final, repair=True)
    if not report["clean"]:
        shutil.rmtree(final, ignore_errors=True)
        log_event(
            "backfill_result_adopt_failed",
            root=root,
            issues=len(report["issues"]),
        )
        return None
    _write_result_marker(
        done_path, queue, rows=0, files=0,
        shards=len(queue.plan["shards"]), wall_s=0.0, adopted=True,
    )
    log_event("backfill_result_adopted", root=root)
    return {"status": "committed", "result": final, "adopted": True}


def stitch_backfill(root, queue: BackfillQueue | None = None,
                    worker: str | None = None, device=None) -> dict:
    """Build + commit the stitched result for a fully-drained queue.
    Returns a status dict: ``committed`` | ``already`` (a result is
    already committed) | ``unstitchable`` (parked/unresolved shards
    remain — counted in the payload).  A ``result/`` directory
    without its marker (a stitcher crashed between the rename and
    the marker write) is **adopted** — verified and marked — rather
    than re-stitched; losing the commit-wins rename takes the same
    adoption path, so the marker always lands.  The detect recompute
    runs on ``device`` (default the CUDA card)."""
    from tpudas_torch.io.spool import spool as make_spool

    root = str(root)
    if queue is None:
        queue = BackfillQueue(root, worker=worker)
    done_path = os.path.join(root, RESULT_DONE_FILENAME)
    final = os.path.join(root, RESULT_DIRNAME)
    if os.path.isfile(done_path):
        return {"status": "already", "result": final}
    if os.path.isdir(final):
        # a crashed stitcher's commit window: rename landed, marker
        # missing — adopt instead of rebuilding and losing forever
        adopted = _adopt_result(root, queue, final, done_path)
        if adopted is not None:
            return adopted
    if not queue.all_done():
        counts = queue.counts()
        log_event("backfill_unstitchable", **counts)
        return {"status": "unstitchable", "counts": counts}
    plan = queue.plan
    cfg = plan["config"]
    token = f"{queue.worker}.{os.getpid()}"
    staging = os.path.join(root, f"{RESULT_DIRNAME}.work.{token}")
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    t0 = _time.perf_counter()
    rows_total = files_total = 0
    with span("backfill.stitch", shards=len(plan["shards"])):
        for idx, sh in enumerate(plan["shards"]):
            sdir = queue.shard_dir(sh["id"])
            lo, hi = _shard_window(plan, idx)
            sp = make_spool(sdir).sort("time").update()
            if lo is not None or hi is not None:
                sp = sp.select(time=(lo, hi))
            rows, files = _write_rows(staging, sp.chunk(time=None))
            rows_total += rows
            files_total += files
        if cfg.get("pyramid"):
            from tpudas_torch.serve.tiles import sync_pyramid

            sync_pyramid(staging)
        if cfg.get("detect") and cfg.get("detect_operators"):
            from tpudas_torch.detect.runner import DetectPipeline

            ops = tuple(
                (name, dict(params))
                for name, params in cfg["detect_operators"]
            )
            pipe = DetectPipeline.open(
                staging, operators=ops,
                step_sec=float(cfg["output_sample_interval"]),
                device=device,
            )
            pipe.process_round([])
        from tpudas_torch.backfill.runner import scrub_index_cache

        scrub_index_cache(staging)
        # the stitch commit: same commit-wins rename discipline as a
        # shard's (and the same fault site, so the drill can kill it)
        fault_point("backfill.commit", path=final, shard="result")
        if not commit_rename(staging, final):
            # another stitcher's rename won; discard our staging and
            # make sure THEIR marker lands (they may have crashed in
            # their commit window — adoption keeps the queue unwedged)
            shutil.rmtree(staging, ignore_errors=True)
            get_registry().counter(
                "tpudas_backfill_double_commits_total",
                "shard or stitch executions that lost the "
                "commit-wins rename (their staging was discarded)",
            ).inc()
            if os.path.isfile(done_path):
                return {"status": "already", "result": final}
            adopted = _adopt_result(root, queue, final, done_path)
            if adopted is not None:
                return adopted
            return {"status": "lost", "result": final}
        _write_result_marker(
            done_path, queue, rows=rows_total, files=files_total,
            shards=len(plan["shards"]),
            wall_s=_time.perf_counter() - t0,
        )
    get_registry().counter(
        "tpudas_backfill_stitch_rows_total",
        "output rows stitched into committed backfill results",
    ).inc(rows_total)
    log_event(
        "backfill_stitched",
        root=root,
        rows=rows_total,
        files=files_total,
        shards=len(plan["shards"]),
    )
    return {"status": "committed", "result": final, "rows": rows_total}
