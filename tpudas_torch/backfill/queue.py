"""The filesystem-backed backfill work queue: shards, leases, commits.

One backfill job lives entirely under one **root directory** on a
filesystem every worker can reach (NFS, a shared volume — the same
place the fleet already keeps per-stream state)::

    root/
      backfill.json            # the crc-stamped plan (written once)
      shards/<id>/             # committed shard output (atomic rename)
      shards/<id>.work.<tok>/  # a claim's private staging directory
      .leases/<id>.json        # the live lease (worker, pid, deadline)
      .done/<id>.json          # the crc-stamped exactly-once marker
      .parked/<id>.json        # fatal-shard park record (fsck-able)
      result/                  # the stitched result (tpudas_torch.backfill.stitch)
      result.done.json         # the stitch's commit marker

**The plan** (:func:`plan_backfill`) splits an archive slice
``[t0, t1)`` into time shards on the output grid.  Each shard is one
:class:`tpudas_torch.fleet.config.StreamSpec`-shaped job: drain the archive
slice ``[t0 - lead, t1 + lead]`` through the streaming engine into a
private staging directory.  ``lead`` (default two edge buffers,
rounded up to the output grid) is the warm-up margin that rebuilds the
FIR cascade's finite state exactly, so a shard's rows inside
``[t0, t1)`` are bit-identical to a single sequential run's — the
same rewind argument the drivers' crash-resume already proves.

**Leases.**  A worker claims a shard by atomically writing
``.leases/<id>.json`` (worker id, pid, token, heartbeat, deadline),
re-reading after a settle to confirm its token survived (two racing
claimers: last write wins whole, the loser backs off — counted).  The
worker renews the lease every drain round; ANY worker may reclaim a
shard whose lease deadline has passed, so a SIGKILLed or wedged
worker's shards are re-executed, not lost.  The lease is an
*optimization*, never the correctness mechanism: double execution is
resolved by the commit-wins rule below, so clock skew across hosts
costs duplicated work at worst.  Size ``lease_ttl`` comfortably above
one drain round (``ingest_limit_sec`` bounds the round).

**Exactly-once commit.**  A drained, audit-clean staging directory is
committed by ONE atomic ``os.rename(staging, shards/<id>)`` — the
filesystem refuses the second rename, so exactly one execution's
bytes become the shard, no matter how many workers raced —
followed by the crc-stamped ``.done/<id>.json`` marker.  A crash
between the two leaves a committed directory without a marker; the
next claimer (or ``audit_backfill``) *adopts* it: re-verify the
directory, write the marker, done.  Re-execution is therefore
idempotent end to end: claim → drain → rename-or-lose → marker.

Fault sites: ``backfill.claim`` fires at the head of every
claim/steal write, ``backfill.commit`` just before the rename —
``tpudas_torch/tools/backfill_drill.py`` kills workers at both.
"""

from __future__ import annotations

import math
import os
import shutil
import time as _time
from dataclasses import dataclass

from tpudas_torch.integrity.checksum import (
    read_json_verified,
    write_json_checksummed,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import fault_point
from tpudas_torch.utils.logging import log_event

__all__ = [
    "DONE_DIRNAME",
    "LEASES_DIRNAME",
    "PARKED_DIRNAME",
    "PLAN_FILENAME",
    "RESULT_DIRNAME",
    "RESULT_DONE_FILENAME",
    "SHARDS_DIRNAME",
    "BackfillQueue",
    "Lease",
    "LeaseLostError",
    "build_plan",
    "load_plan",
    "plan_backfill",
]

PLAN_FILENAME = "backfill.json"
SHARDS_DIRNAME = "shards"
LEASES_DIRNAME = ".leases"
DONE_DIRNAME = ".done"
PARKED_DIRNAME = ".parked"
RESULT_DIRNAME = "result"
RESULT_DONE_FILENAME = "result.done.json"

_PLAN_VERSION = 1
# config keys the plan persists verbatim (all JSON-serializable; the
# worker rebuilds a StreamConfig from them per shard)
_PLAN_CONFIG_KEYS = (
    "output_sample_interval",
    "edge_buffer",
    "process_patch_size",
    "engine",
    "distance",
    "pyramid",
    "detect",
    "detect_operators",
    "on_gap",
    "filter_order",
    "data_gap_tolerance",
)


def commit_rename(staging: str, final: str) -> bool:
    """The exactly-once primitive both shard and stitch commits
    share: ONE atomic ``os.rename(staging, final)``.  Returns True
    when this execution's rename won; False when another execution's
    ``final`` already stands (commit-wins — the caller discards its
    staging).  Any rename failure that is NOT the commit-wins race
    re-raises."""
    if os.path.isdir(final):
        return False
    try:
        os.rename(staging, final)
    except OSError:
        # the commit-wins race: final appeared between the check and
        # our rename — anything else is a real error
        if not os.path.isdir(final):
            raise
        return False
    return True


class LeaseLostError(RuntimeError):
    """This worker's lease was stolen (stale deadline + reclaim) —
    abandon the shard mid-drain; the thief re-executes it and the
    orphaned staging directory is swept by ``audit_backfill``."""


@dataclass
class Lease:
    """One live claim: identity + the running overhead account the
    done marker records (claim + renew + commit bookkeeping wall)."""

    shard: str
    token: str
    worker: str
    overhead_s: float = 0.0


def _ns(t) -> int:
    import numpy as np

    from tpudas_torch.core.timeutils import to_datetime64

    return int(
        to_datetime64(t).astype("datetime64[ns]").astype(np.int64)
    )


def _grid_ceil(seconds: float, d_t: float) -> float:
    """``seconds`` rounded UP to the output grid (lead/shard lengths
    must be grid multiples or the shard's decimation phase — and with
    it byte-identity — breaks)."""
    return math.ceil(float(seconds) / float(d_t) - 1e-9) * float(d_t)


def _source_step_sec(source) -> float | None:
    """The archive's input sample step, from the index alone."""
    import numpy as np

    from tpudas_torch.io.spool import spool as make_spool

    try:
        row = make_spool(source).update().contents()[0]
        span_ns = (
            np.datetime64(row["time_max"], "ns")
            - np.datetime64(row["time_min"], "ns")
        ) / np.timedelta64(1, "ns")
        n_time = int(row["ntime"])
        if n_time < 2 or span_ns <= 0:
            return None
        return float(span_ns / 1e9 / (n_time - 1))
    except Exception as exc:
        log_event(
            "backfill_source_probe_failed",
            source=str(source),
            error=f"{type(exc).__name__}: {str(exc)[:120]}",
        )
        return None


def default_leads(source, d_t, edge_buffer, order=None) -> tuple:
    """(head_lead, tail_lead) seconds for one shard, derived from the
    actual cascade plan over the archive's sample rate.

    *Head*: a shard opens its stream cold at ``t0 - head_lead`` with
    a ``plan.delay``-sample zero prepad (the stream feed origin); its
    emitted rows become bit-identical to the sequential run's once
    that prepad has fully flushed through every cascade stage's
    carried state — ``delay/ratio`` output steps after the stream
    start (measured exact: taint ends at ``start + ceil(delay/ratio)``
    steps).  *Tail*: the stateful engine's emitted head trails the
    ingested head by ``(warmup + 1 - delay/ratio)`` output steps
    (tpudas_torch.ops.fir stream formulation), so the input slice must
    extend that far past ``t1`` for the kept rows to reach it.

    Falls back to ``(2*edge, 2*edge) + a generous warmup guess`` when
    the plan cannot be designed (fft engine, non-integer ratio) —
    stitching still works there, but byte-identity to a sequential
    run is only promised for the chunk-invariant cascade/fused
    engines anyway."""
    d_t = float(d_t)
    edge = float(edge_buffer)
    buff_out = math.ceil(edge / d_t)
    d_in = _source_step_sec(source)
    if d_in is not None and d_in > 0:
        ratio = d_t / d_in
        if abs(ratio - round(ratio)) < 1e-9:
            try:
                from tpudas_torch.ops.fir import (
                    design_cascade,
                    stream_warmup_outputs,
                )
                from tpudas_torch.proc.lfproc import output_corner

                plan = design_cascade(
                    1.0 / d_in, int(round(ratio)), output_corner(d_t),
                    4 if order is None else int(order),
                )
                warmup = stream_warmup_outputs(plan)
                delay_steps = plan.delay / float(plan.ratio)
                head = _grid_ceil((delay_steps + 3) * d_t, d_t)
                tail = _grid_ceil(
                    (warmup + 2 - delay_steps) * d_t + 2 * d_t, d_t
                )
                return max(head, _grid_ceil(buff_out * d_t, d_t)), (
                    max(tail, d_t)
                )
            except Exception as exc:
                log_event(
                    "backfill_lead_plan_failed",
                    error=f"{type(exc).__name__}: {str(exc)[:120]}",
                )
    # conservative fallback: no plan to consult
    return _grid_ceil(4 * edge, d_t), _grid_ceil(8 * edge, d_t)


def build_plan(
    source,
    t0,
    t1,
    shard_seconds: float,
    output_sample_interval: float,
    edge_buffer: float,
    process_patch_size: int,
    engine=None,
    distance=None,
    pyramid: bool = True,
    detect: bool = False,
    detect_operators=None,
    lead_seconds: float | None = None,
    tail_seconds: float | None = None,
    ingest_limit_sec: float | None = 600.0,
    **extra_config,
) -> dict:
    """The pure planning step: cut ``[t0, t1)`` into shards, derive
    the warm-up leads, and return the plan dict — no filesystem or
    store touched (beyond probing the SOURCE archive for lead
    derivation).  :func:`plan_backfill` persists it to a directory
    root; the object-store queue persists the same dict as a
    create-only object."""
    d_t = float(output_sample_interval)
    t0_ns, t1_ns = _ns(t0), _ns(t1)
    if t1_ns <= t0_ns:
        raise ValueError(f"empty archive slice: t1 {t1!r} <= t0 {t0!r}")
    shard_sec = _grid_ceil(shard_seconds, d_t)
    if shard_sec <= 0:
        raise ValueError(f"shard_seconds must be > 0, got {shard_seconds}")
    if lead_seconds is None or tail_seconds is None:
        head_auto, tail_auto = default_leads(
            source, d_t, edge_buffer,
            order=extra_config.get("filter_order"),
        )
        if lead_seconds is None:
            lead_seconds = head_auto
        if tail_seconds is None:
            tail_seconds = tail_auto
    lead_sec = _grid_ceil(lead_seconds, d_t)
    tail_sec = _grid_ceil(tail_seconds, d_t)
    shard_ns = int(round(shard_sec * 1e9))
    shards = []
    k = 0
    lo = t0_ns
    while lo < t1_ns:
        hi = min(lo + shard_ns, t1_ns)
        shards.append({"id": f"sh{k:05d}", "t0_ns": lo, "t1_ns": hi})
        lo = hi
        k += 1
    config = {
        "output_sample_interval": d_t,
        "edge_buffer": float(edge_buffer),
        "process_patch_size": int(process_patch_size),
        "engine": engine,
        "distance": distance,
        "pyramid": bool(pyramid),
        "detect": bool(detect),
        "detect_operators": detect_operators,
        **extra_config,
    }
    unknown = sorted(set(config) - set(_PLAN_CONFIG_KEYS))
    if unknown:
        raise ValueError(f"unknown backfill config key(s): {unknown}")
    return {
        "version": _PLAN_VERSION,
        "source": os.path.abspath(str(source)),
        "t0_ns": t0_ns,
        "t1_ns": t1_ns,
        "shard_seconds": shard_sec,
        "lead_seconds": lead_sec,
        "tail_seconds": tail_sec,
        "ingest_limit_sec": (
            None if ingest_limit_sec is None else float(ingest_limit_sec)
        ),
        "config": config,
        "shards": shards,
    }


def plan_backfill(root, source, t0, t1, **kwargs) -> dict:
    """Write the crc-stamped plan for one backfill job and return it.

    The archive slice ``[t0, t1)`` is cut into shards of
    ``shard_seconds`` (rounded up to the output grid; the last shard
    takes the remainder).  ``lead_seconds`` is the per-shard warm-up
    margin (default derived from the cascade plan, grid-rounded).  The
    remaining keywords mirror the lowpass driver knobs the workers
    rebuild a :class:`~tpudas_torch.fleet.config.StreamConfig` from (see
    :func:`build_plan`); ``pyramid`` / ``detect`` are applied at
    STITCH time (shards themselves write only output files + carry —
    serve/detect state near a cold shard boundary would differ from
    the sequential run's, so it is derived once, deterministically,
    from the stitched rows).

    Raises ``FileExistsError`` when the root already holds a plan —
    a queue is immutable once written (workers may already be
    claiming against it).
    """
    root = str(root)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, PLAN_FILENAME)
    if os.path.isfile(path):
        raise FileExistsError(
            f"{path} already exists; a backfill plan is immutable "
            "(make a new root to re-plan)"
        )
    plan = build_plan(source, t0, t1, **kwargs)
    write_json_checksummed(path, plan, durable=True)
    for d in (SHARDS_DIRNAME, LEASES_DIRNAME, DONE_DIRNAME, PARKED_DIRNAME):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    get_registry().gauge(
        "tpudas_backfill_shards", "time shards in the backfill plan"
    ).set(len(plan["shards"]))
    log_event(
        "backfill_planned",
        root=root,
        shards=len(plan["shards"]),
        shard_seconds=plan["shard_seconds"],
        lead_seconds=plan["lead_seconds"],
        tail_seconds=plan["tail_seconds"],
    )
    return plan


def load_plan(root) -> dict:
    """Read + verify the plan; raises on a missing/torn plan (a queue
    whose plan cannot be trusted must not be drained)."""
    path = os.path.join(str(root), PLAN_FILENAME)
    payload, status = read_json_verified(path, "backfill_plan")
    if status == "mismatch":
        raise ValueError(f"backfill plan {path} failed its crc32 check")
    if int(payload.get("version", -1)) != _PLAN_VERSION:
        raise ValueError(
            f"unknown backfill plan version {payload.get('version')!r}"
        )
    return payload


class BackfillQueue:
    """Lease/commit operations for one worker over one backfill root.

    ``clock`` (seconds, ``time.time``) is injectable so lease-expiry
    tests need no real waiting; ``settle`` is the claim's
    write-then-reread confirmation delay (0 in single-threaded
    tests)."""

    def __init__(
        self,
        root,
        worker: str | None = None,
        lease_ttl: float = 60.0,
        settle: float = 0.05,
        clock=_time.time,
    ):
        self.root = str(root)
        self.worker = str(
            worker
            if worker is not None
            else f"{os.uname().nodename}.{os.getpid()}"
        )
        self.lease_ttl = float(lease_ttl)
        self.settle = float(settle)
        self.clock = clock
        self.plan = load_plan(self.root)
        self._claim_seq = 0

    # -- paths ---------------------------------------------------------
    def shard(self, shard_id: str) -> dict:
        for sh in self.plan["shards"]:
            if sh["id"] == shard_id:
                return sh
        raise KeyError(f"unknown shard {shard_id!r}")

    def shard_dir(self, shard_id: str) -> str:
        return os.path.join(self.root, SHARDS_DIRNAME, shard_id)

    def staging_dir(self, lease: Lease) -> str:
        return os.path.join(
            self.root, SHARDS_DIRNAME,
            f"{lease.shard}.work.{lease.token}",
        )

    def _lease_path(self, shard_id: str) -> str:
        return os.path.join(self.root, LEASES_DIRNAME, shard_id + ".json")

    def _done_path(self, shard_id: str) -> str:
        return os.path.join(self.root, DONE_DIRNAME, shard_id + ".json")

    def _parked_path(self, shard_id: str) -> str:
        return os.path.join(self.root, PARKED_DIRNAME, shard_id + ".json")

    # -- state reads ---------------------------------------------------
    def _now_ns(self) -> int:
        return int(float(self.clock()) * 1e9)

    def read_lease(self, shard_id: str) -> dict | None:
        """The current lease payload, or None when absent/torn (a torn
        lease is claimable — it protects nothing)."""
        try:
            payload, status = read_json_verified(
                self._lease_path(shard_id), "backfill_lease"
            )
        except (OSError, ValueError):
            return None
        return None if status == "mismatch" else payload

    def is_done(self, shard_id: str) -> bool:
        try:
            _, status = read_json_verified(
                self._done_path(shard_id), "backfill_done"
            )
        except (OSError, ValueError):
            return False
        return status != "mismatch"

    def is_parked(self, shard_id: str) -> bool:
        return os.path.isfile(self._parked_path(shard_id))

    def shard_state(self, shard_id: str) -> str:
        """``done`` | ``parked`` | ``adoptable`` (committed directory
        without its marker — a crash between rename and marker) |
        ``leased`` | ``stale`` (lease expired) | ``open``.

        The lease is consulted BEFORE the directory: a live lease
        over a committed directory is a worker INSIDE its commit
        (between the rename and the marker write) — clobbering it
        would let a second worker adopt concurrently and overwrite
        the committer's marker.  Only an expired (or absent) lease
        makes the directory adoptable."""
        if self.is_done(shard_id):
            return "done"
        if self.is_parked(shard_id):
            return "parked"
        lease = self.read_lease(shard_id)
        live = (
            lease is not None
            and int(lease.get("deadline_ns", 0)) >= self._now_ns()
        )
        if os.path.isdir(self.shard_dir(shard_id)):
            return "leased" if live else "adoptable"
        if lease is None:
            return "open"
        return "leased" if live else "stale"

    def counts(self) -> dict:
        counts = {
            "done": 0, "parked": 0, "adoptable": 0,
            "leased": 0, "stale": 0, "open": 0,
        }
        for sh in self.plan["shards"]:
            counts[self.shard_state(sh["id"])] += 1
        return counts

    def resolved(self) -> bool:
        """Every shard is done or parked — nothing left to execute."""
        return all(
            self.shard_state(sh["id"]) in ("done", "parked")
            for sh in self.plan["shards"]
        )

    def all_done(self) -> bool:
        return all(self.is_done(sh["id"]) for sh in self.plan["shards"])

    # -- claim / renew / release --------------------------------------
    def try_claim(self, shard_id: str) -> Lease | None:
        """Claim (or reclaim) one shard: write the lease, settle,
        re-read, confirm the token survived.  Returns None when the
        shard is not claimable or the settle re-read shows another
        worker won the write race."""
        t0 = _time.perf_counter()
        reg = get_registry()
        state = self.shard_state(shard_id)
        if state not in ("open", "stale", "adoptable"):
            return None
        lease_path = self._lease_path(shard_id)
        with span("backfill.claim", shard=shard_id):
            fault_point("backfill.claim", path=lease_path, shard=shard_id)
            now = self._now_ns()
            token = f"{self.worker}.{os.getpid()}.{self._claim_seq}"
            self._claim_seq += 1
            write_json_checksummed(
                lease_path,
                {
                    "shard": shard_id,
                    "worker": self.worker,
                    "pid": os.getpid(),
                    "token": token,
                    "heartbeat_ns": now,
                    "deadline_ns": now + int(self.lease_ttl * 1e9),
                    "stolen": state == "stale",
                },
            )
            if self.settle:
                _time.sleep(self.settle)
            current = self.read_lease(shard_id)
        if current is None or current.get("token") != token:
            reg.counter(
                "tpudas_backfill_claim_conflicts_total",
                "shard claims lost to another worker's concurrent "
                "lease write (the settle re-read disagreed)",
            ).inc()
            return None
        if state == "stale":
            reg.counter(
                "tpudas_backfill_shards_reclaimed_total",
                "shards reclaimed from a stale lease (the previous "
                "worker died or wedged; the shard is re-executed)",
            ).inc()
            log_event(
                "backfill_shard_reclaimed",
                shard=shard_id,
                worker=self.worker,
                previous=str(current.get("stolen", "")),
            )
        lease = Lease(shard=shard_id, token=token, worker=self.worker)
        lease.overhead_s += _time.perf_counter() - t0
        return lease

    def claim_next(self) -> Lease | None:
        """The next claimable shard in plan order, or None when no
        shard is currently claimable (all done/parked/validly
        leased)."""
        for sh in self.plan["shards"]:
            lease = self.try_claim(sh["id"])
            if lease is not None:
                return lease
        return None

    def renew(self, lease: Lease) -> None:
        """Extend this worker's lease; raises :class:`LeaseLostError`
        when another worker reclaimed it (stop draining — the thief's
        execution is now authoritative)."""
        t0 = _time.perf_counter()
        current = self.read_lease(lease.shard)
        if current is None or current.get("token") != lease.token:
            raise LeaseLostError(
                f"lease on {lease.shard} lost to "
                f"{None if current is None else current.get('worker')!r}"
            )
        now = self._now_ns()
        write_json_checksummed(
            self._lease_path(lease.shard),
            {
                **current,
                "heartbeat_ns": now,
                "deadline_ns": now + int(self.lease_ttl * 1e9),
            },
        )
        get_registry().counter(
            "tpudas_backfill_lease_renewals_total",
            "shard lease heartbeat renewals",
        ).inc()
        lease.overhead_s += _time.perf_counter() - t0

    def release(self, lease: Lease) -> None:
        """Drop this worker's lease (only if still ours — never
        clobber a thief's live lease)."""
        current = self.read_lease(lease.shard)
        if current is not None and current.get("token") == lease.token:
            try:
                os.remove(self._lease_path(lease.shard))
            except OSError as exc:
                log_event(
                    "backfill_lease_release_failed",
                    shard=lease.shard,
                    error=f"{type(exc).__name__}: {str(exc)[:120]}",
                )

    # -- commit / park -------------------------------------------------
    def _write_done(self, shard_id, lease, extra) -> None:
        write_json_checksummed(
            self._done_path(shard_id),
            {
                "shard": shard_id,
                "worker": lease.worker,
                "token": lease.token,
                "committed_ns": self._now_ns(),
                **extra,
            },
            durable=True,
        )

    def commit(self, lease: Lease, staging: str, **extra) -> str:
        """The exactly-once commit: atomically rename ``staging`` to
        the shard directory, then write the done marker.  Returns
        ``"committed"``, or ``"lost"`` when another execution's rename
        won (commit-wins: this worker's staging is discarded, the
        marker — written by the winner or adopted — stands).  Extra
        keywords (wall_s, rounds, ...) are recorded in the marker."""
        t0 = _time.perf_counter()
        reg = get_registry()
        final = self.shard_dir(lease.shard)
        with span("backfill.commit", shard=lease.shard):
            fault_point("backfill.commit", path=final, shard=lease.shard)
            if not commit_rename(staging, final):
                reg.counter(
                    "tpudas_backfill_double_commits_total",
                    "shard or stitch executions that lost the "
                    "commit-wins rename (their staging was discarded)",
                ).inc()
                shutil.rmtree(staging, ignore_errors=True)
                self.release(lease)
                log_event(
                    "backfill_commit_lost",
                    shard=lease.shard,
                    worker=self.worker,
                )
                return "lost"
            lease.overhead_s += _time.perf_counter() - t0
            self._write_done(
                lease.shard, lease,
                {"overhead_s": round(lease.overhead_s, 6), **extra},
            )
            self.release(lease)
        reg.counter(
            "tpudas_backfill_shards_committed_total",
            "shards committed exactly-once (rename + done marker)",
        ).inc()
        reg.counter(
            "tpudas_backfill_overhead_seconds_total",
            "wall seconds spent in lease claim/renew/commit "
            "bookkeeping (the <2%-of-shard-wall budget)",
        ).inc(lease.overhead_s)
        log_event(
            "backfill_shard_committed",
            shard=lease.shard,
            worker=self.worker,
            **{k: v for k, v in extra.items() if k != "digests"},
        )
        return "committed"

    def adopt(self, lease: Lease, **extra) -> str:
        """Finish a crashed commit: the shard directory exists (the
        rename landed) but the marker is missing — verify the
        directory and write the marker.  Returns ``"committed"`` or
        ``"failed"`` (directory does not verify: it is removed so the
        shard re-executes)."""
        from tpudas_torch.integrity.audit import audit

        if self.is_done(lease.shard):
            # the original committer's marker landed after our claim
            # (a wedged worker finishing late): its record stands
            self.release(lease)
            return "committed"
        final = self.shard_dir(lease.shard)
        report = audit(final, repair=True)
        if not report["clean"]:
            shutil.rmtree(final, ignore_errors=True)
            self.release(lease)
            log_event(
                "backfill_adopt_failed",
                shard=lease.shard,
                issues=len(report["issues"]),
            )
            return "failed"
        self._write_done(
            lease.shard, lease, {"adopted": True, **extra}
        )
        self.release(lease)
        get_registry().counter(
            "tpudas_backfill_shards_committed_total",
            "shards committed exactly-once (rename + done marker)",
        ).inc()
        log_event("backfill_shard_adopted", shard=lease.shard)
        return "committed"

    def park(self, lease: Lease, exc: BaseException, kind: str) -> None:
        """Park a shard whose execution failed terminally (fatal
        fault, exhausted retries): the shard is counted, fsck-able,
        and skipped by every claimer — the worker moves on instead of
        dying.  The queue can never stitch while parked shards
        remain."""
        write_json_checksummed(
            self._parked_path(lease.shard),
            {
                "shard": lease.shard,
                "worker": self.worker,
                "kind": kind,
                "error": f"{type(exc).__name__}: {str(exc)[:300]}",
                "parked_ns": self._now_ns(),
            },
            durable=True,
        )
        self.release(lease)
        get_registry().counter(
            "tpudas_backfill_shards_parked_total",
            "shards parked after a terminal execution failure "
            "(fsck-able; the worker keeps draining the rest)",
        ).inc()
        log_event(
            "backfill_shard_parked",
            shard=lease.shard,
            kind=kind,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
