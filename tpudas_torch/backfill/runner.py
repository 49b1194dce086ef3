"""Drain-mode shard execution: the streaming engine, pointed backward.

One shard = one :class:`tpudas_torch.fleet.engine.LowpassStreamRunner` over
the archive slice, with the realtime poll loop replaced by
drain-as-fast-as-possible: ``step()`` until ``terminate``, no poll
sleeps, the source slice capped by the runner's ``time_range`` and
each round bounded by ``ingest_limit_sec`` (so the shard lease is
renewed between rounds, never mid-unbounded-round).  Everything the
realtime path earned rides along unchanged — the per-round fault
boundary (transient retry with backoff, corrupt-file quarantine),
ENOSPC resource shedding, crc-stamped carry, startup integrity
audit — because it IS the realtime code path.

Failure policy per shard:

- transient/corrupt/resource failures: retried by the shard's own
  fault boundary exactly as a live stream would (the retry sleep
  renews the lease in bounded slices);
- :class:`~tpudas_torch.backfill.queue.LeaseLostError` (another worker
  reclaimed a wedged-looking lease): the shard is abandoned
  mid-drain — the thief's execution is authoritative, this staging
  directory becomes an orphan for ``audit_backfill`` to sweep;
- fatal failures (config/programming errors, exhausted retries): the
  shard is **parked** in the queue (counted, fsck-able) and the
  worker moves to the next shard instead of dying;
- ``KeyboardInterrupt``/``SystemExit``/SIGKILL: crash-only — the
  worker just dies; its leases go stale and other workers reclaim.

The port's worker takes a ``device`` (default the CUDA card, through
:func:`tpudas_torch.device.resolve_device`; the tests pass ``"cpu"``).
The device is run control, never part of the plan: ``backfill.json``
stays byte-compatible with the JAX package's.  On the card the worker
builds the kernels of its engine before it claims a shard, so a
kernel that does not build kills the worker instead of parking every
shard.

:func:`run_worker` is the whole worker: claim → drain → commit,
looping until every shard is done or parked, then (optionally) race
the deterministic stitch — also commit-wins, so N workers may all
try.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np

from tpudas_torch.backfill.queue import BackfillQueue, Lease, LeaseLostError
from tpudas_torch.device import resolve_device
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import classify_failure
from tpudas_torch.utils.logging import log_event

__all__ = [
    "execute_shard", "prepare_device", "run_worker", "scrub_index_cache",
    "shard_spec",
]


def scrub_index_cache(folder: str) -> None:
    """Remove the directory-index cache (and its ``.prev``) before a
    commit rename: the cache records absolute paths, which the rename
    invalidates — and the index is regenerable by construction, so
    readers of the committed directory simply rescan."""
    from tpudas_torch.io.index import INDEX_FILENAME

    for name in (INDEX_FILENAME, INDEX_FILENAME + ".prev"):
        path = os.path.join(folder, name)
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

# a retry backoff is slept in lease-renewable slices no longer than
# this, so a long transient backoff cannot let the lease expire
_RENEW_SLICE_SEC = 5.0


def shard_spec(plan: dict, shard: dict):
    """The :class:`~tpudas_torch.fleet.config.StreamSpec` for one shard:
    the lowpass config rebuilt from the plan, ``start_time`` pulled
    back by the warm-up lead (grid-aligned, so the shard's decimation
    phase — and with it byte-identity inside ``[t0, t1)`` — matches
    the sequential run's)."""
    from tpudas_torch.fleet.config import StreamConfig, StreamSpec

    cfg = dict(plan["config"])
    lead_ns = int(round(float(plan["lead_seconds"]) * 1e9))
    start_ns = max(int(shard["t0_ns"]) - lead_ns, int(plan["t0_ns"]))
    ops = cfg.get("detect_operators")
    if ops is not None:
        # JSON round-trips tuples to lists; the registry accepts both
        ops = tuple((name, dict(params)) for name, params in ops)
    config = StreamConfig(
        kind="lowpass",
        start_time=np.datetime64(start_ns, "ns"),
        output_sample_interval=cfg["output_sample_interval"],
        edge_buffer=cfg["edge_buffer"],
        process_patch_size=cfg["process_patch_size"],
        engine=cfg.get("engine"),
        distance=cfg.get("distance"),
        on_gap=cfg.get("on_gap"),
        filter_order=cfg.get("filter_order"),
        data_gap_tolerance=cfg.get("data_gap_tolerance"),
        # shards write output files + carry only; pyramid and detect
        # state are derived ONCE from the stitched rows (stitch.py) —
        # per-shard serve/detect state near a cold boundary would
        # diverge from the sequential run's
        pyramid=False,
        detect=False,
        detect_operators=ops,
        health=False,
        quarantine=True,
        stateful=True,
        poll_interval=0.0,
    )
    return StreamSpec(
        stream_id=shard["id"], source=plan["source"], config=config
    )


def _drain_cap_ns(plan: dict, shard: dict) -> int:
    """The input-slice cap: the shard end plus the tail lead (the
    stateful engine's emitted head trails its ingested head by
    warmup-minus-delay output steps, so the slice must extend past
    ``t1`` for the kept rows to reach it), clamped to the archive
    slice end."""
    tail_ns = int(round(float(plan["tail_seconds"]) * 1e9))
    return min(int(shard["t1_ns"]) + tail_ns, int(plan["t1_ns"]))


def prepare_device(device=None):
    """The worker's device (default the CUDA card; raises without
    one).  On the card the CUDA kernels of the stream path are built
    (and loaded) here, once per worker, so a build failure raises
    before the worker claims anything."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from tpudas_torch.ops.fir_kernel import _kernel_lib as fir_lib
        from tpudas_torch.ops.fused_kernel import _kernel_lib as fused_lib

        fir_lib()
        fused_lib()
    return dev


def execute_shard(
    queue: BackfillQueue, lease: Lease, sleep_fn=_time.sleep, device=None
) -> str:
    """Drain one claimed shard into its staging directory and commit.
    Returns ``"committed"`` | ``"lost"`` | ``"parked"``.  Raises
    :class:`LeaseLostError` when the lease is stolen mid-drain and
    lets ``KeyboardInterrupt``/``SystemExit`` propagate (crash-only).
    The shard runs on ``device`` (default the CUDA card; an
    unavailable device raises rather than parks).
    """
    from tpudas_torch.fleet.engine import LowpassStreamRunner

    device = resolve_device(device)
    plan = queue.plan
    shard = queue.shard(lease.shard)
    staging = queue.staging_dir(lease)
    t_wall = _time.perf_counter()
    try:
        runner = LowpassStreamRunner(
            shard_spec(plan, shard), staging, device=device
        )
    except Exception as exc:
        # a shard that cannot even build its runner (config error) is
        # parked, not a worker death — mirrors the fleet's build-time
        # park
        log_event(
            "backfill_runner_build_failed",
            shard=lease.shard,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        queue.park(lease, exc, classify_failure(exc))
        return "parked"
    runner.time_range = (
        None, np.datetime64(_drain_cap_ns(plan, shard), "ns")
    )
    runner.ingest_limit_sec = plan.get("ingest_limit_sec")
    try:
        with span("backfill.shard", shard=lease.shard):
            while True:
                queue.renew(lease)
                res = runner.step()
                if res.status == "terminate":
                    break
                if res.status == "retry":
                    # sleep the boundary's backoff in lease-renewable
                    # slices — a 60 s transient backoff must not let
                    # the lease expire under us
                    remaining = float(res.delay)
                    while remaining > 0:
                        sleep_fn(min(remaining, _RENEW_SLICE_SEC))
                        remaining -= _RENEW_SLICE_SEC
                        queue.renew(lease)
            runner.finish()
    except LeaseLostError:
        raise
    except Exception as exc:
        kind = classify_failure(exc)
        log_event(
            "backfill_shard_failed",
            shard=lease.shard,
            kind=kind,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        runner.record_fatal(exc)
        queue.park(lease, exc, kind)
        return "parked"
    wall = _time.perf_counter() - t_wall
    get_registry().histogram(
        "tpudas_backfill_shard_seconds",
        "wall seconds to drain one shard (claim to commit)",
    ).observe(wall)
    scrub_index_cache(staging)
    # pre-commit verification: the staging directory must fsck clean
    # (it was audited at runner startup; a drain that left damage
    # behind must not become the authoritative shard)
    from tpudas_torch.integrity.audit import audit

    report = audit(staging, repair=True)
    if not report["clean"]:
        err = RuntimeError(
            f"staging for {lease.shard} failed post-drain audit "
            f"({len(report['issues'])} issue(s))"
        )
        queue.park(lease, err, "corrupt")
        return "parked"
    return queue.commit(
        lease, staging,
        wall_s=round(wall, 4), rounds=int(runner.rounds),
    )


def run_worker(
    root,
    worker: str | None = None,
    stitch: bool = True,
    idle_poll: float = 0.25,
    max_wall: float | None = None,
    sleep_fn=_time.sleep,
    device=None,
    **queue_kwargs,
) -> dict:
    """One backfill worker, end to end: claim shards (reclaiming stale
    leases) until every shard is done or parked, then optionally race
    the stitch.  Returns the worker's tally.  ``max_wall`` bounds the
    loop for tests; production workers wait out other workers' leases
    (a dead worker's lease goes stale after ``lease_ttl``).
    ``device`` (default the CUDA card) runs every shard and the
    stitch's detect recompute."""
    device = prepare_device(device)
    queue = BackfillQueue(root, worker=worker, **queue_kwargs)
    tally = {
        "worker": queue.worker, "committed": 0, "adopted": 0,
        "lost": 0, "parked": 0, "stitched": False,
    }
    t0 = _time.perf_counter()
    while True:
        if max_wall is not None and _time.perf_counter() - t0 > max_wall:
            raise TimeoutError(
                f"backfill worker exceeded max_wall={max_wall}s "
                f"with queue counts {queue.counts()}"
            )
        lease = queue.claim_next()
        if lease is None:
            if queue.resolved():
                break
            sleep_fn(idle_poll)  # other workers hold live leases
            continue
        if os.path.isdir(queue.shard_dir(lease.shard)):
            # a crashed commit (rename landed, marker missing): adopt
            outcome = queue.adopt(lease)
            if outcome == "committed":
                tally["adopted"] += 1
            continue
        try:
            outcome = execute_shard(
                queue, lease, sleep_fn=sleep_fn, device=device
            )
        except LeaseLostError as exc:
            log_event(
                "backfill_lease_lost",
                shard=lease.shard,
                worker=queue.worker,
                error=str(exc)[:200],
            )
            continue
        tally[outcome] = tally.get(outcome, 0) + 1
    if stitch and queue.all_done():
        from tpudas_torch.backfill.stitch import stitch_backfill

        result = stitch_backfill(root, queue=queue, device=device)
        tally["stitched"] = result["status"] in ("committed", "already")
        tally["stitch_status"] = result["status"]
    tally["counts"] = queue.counts()
    log_event("backfill_worker_done", **{
        k: v for k, v in tally.items() if k != "counts"
    })
    return tally
