"""The object-store backfill queue: no shared filesystem anywhere.

Same job, same exactly-once guarantees, different substrate: N
workers on N hosts coordinate entirely through one object store —
conditional puts where the POSIX queue had atomic renames.  Layout
under one job prefix::

    <prefix>/backfill.json          # the plan: create-only put (immutable)
    <prefix>/leases/<id>.json       # CAS'd lease (claim/renew/steal)
    <prefix>/shards/<id>/<file>     # shard output objects (unconditional)
    <prefix>/shards/<id>/.shard.json# upload manifest: keys + digests,
                                    # uploaded AFTER every output object
    <prefix>/done/<id>.json         # create-only exactly-once marker
    <prefix>/parked/<id>.json       # create-only park record
    <prefix>/result/<file>          # the stitched result objects
    <prefix>/result.json            # the result's upload manifest
    <prefix>/result.done.json       # create-only stitch marker

How each POSIX mechanism translates:

**Claim/steal** was write-settle-reread (last write wins whole);
here it is strictly stronger: ``put_if(if_absent)`` to claim an open
shard, ``put_if(if_token=<stale lease's token>)`` to steal an
expired one — the store itself serializes racing claimers, and the
loser gets :class:`~tpudas_torch.store.base.CASConflictError` instead of a
settle race.  **Renew** CASes the lease on the token read back, so a
renew racing a steal loses definitively
(:class:`~tpudas_torch.backfill.queue.LeaseLostError`).

**Commit** was one atomic rename; an object store has no rename, so
the commit is a three-step upload protocol whose LAST step is the
atomic one: (1) put every staged output file under ``shards/<id>/``
— unconditional, because shard bytes are deterministic, so racing
executions write identical objects; (2) put ``.shard.json``, the
upload manifest naming every object and its content token — the
"directory is complete" signal a rename used to give for free;
(3) ``put_if(if_absent)`` the done marker — the single atomic event
that makes exactly one execution THE commit.  A conflict at (3) is
the commit-wins race, answered the same way as the rename version:
discard local staging, the winner's marker stands.

**Adoption** (crash inside the commit window): a shard with a
verifying ``.shard.json`` — every listed object present with its
listed token — but no done marker is adopted by writing the marker;
an upload manifest that does NOT verify means the crash was mid-step
(1)/(2) and the shard simply re-executes over the debris (uploads
are idempotent).  ``audit_backfill`` classifies the same states from
``list()`` + token verification — no directory walk.

Shard EXECUTION is untouched: each worker drains into a private
local scratch directory through the unmodified
:func:`tpudas_torch.backfill.runner.execute_shard` (it duck-types the
queue), with all the realtime fault machinery riding along.  Only
coordination and durability moved off the filesystem.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time as _time

from tpudas_torch.backfill.queue import (
    Lease,
    LeaseLostError,
    build_plan,
    _PLAN_VERSION,
)
from tpudas_torch.integrity.checksum import (
    stamp_json,
    strip_stamp,
    verify_json_obj,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.resilience.faults import fault_point
from tpudas_torch.store.base import CASConflictError, ObjectNotFoundError
from tpudas_torch.utils.logging import log_event

__all__ = [
    "SHARD_MANIFEST_NAME",
    "StoreBackfillQueue",
    "load_plan_store",
    "plan_backfill_store",
    "run_store_worker",
    "stitch_store_backfill",
]

PLAN_KEY = "backfill.json"
LEASES_PREFIX = "leases"
SHARDS_PREFIX = "shards"
DONE_PREFIX = "done"
PARKED_PREFIX = "parked"
RESULT_PREFIX = "result"
RESULT_MANIFEST_KEY = "result.json"
RESULT_DONE_KEY = "result.done.json"
SHARD_MANIFEST_NAME = ".shard.json"


def _dumps(obj: dict) -> bytes:
    """Stamped canonical bytes for a coordination object (same crc
    stamp discipline as every on-disk JSON artifact)."""
    return (json.dumps(stamp_json(obj), indent=1) + "\n").encode()


def _loads_verified(data: bytes):
    """``(payload, ok)`` — a torn/mismatched object protects nothing,
    exactly like a torn lease file never did."""
    try:
        obj = json.loads(data.decode())
    except (ValueError, AttributeError):
        return None, False
    status = verify_json_obj(obj)
    if status == "mismatch" or not isinstance(obj, dict):
        return None, False
    return strip_stamp(obj), True


def plan_backfill_store(store, prefix: str, source, t0, t1,
                        **kwargs) -> dict:
    """Plan one object-store backfill job: the pure
    :func:`~tpudas_torch.backfill.queue.build_plan` persisted as a
    CREATE-ONLY object — the store's conditional put is what makes
    the plan immutable (a second planner gets the conflict, not a
    clobber)."""
    prefix = str(prefix).strip("/")
    plan = build_plan(source, t0, t1, **kwargs)
    key = f"{prefix}/{PLAN_KEY}" if prefix else PLAN_KEY
    try:
        store.put_if(key, _dumps(plan), if_absent=True)
    except CASConflictError:
        raise FileExistsError(
            f"object {key!r} already exists; a backfill plan is "
            "immutable (use a new prefix to re-plan)"
        ) from None
    get_registry().gauge(
        "tpudas_backfill_shards", "time shards in the backfill plan"
    ).set(len(plan["shards"]))
    log_event(
        "backfill_planned", root=f"store:{prefix}",
        shards=len(plan["shards"]),
        shard_seconds=plan["shard_seconds"],
        lead_seconds=plan["lead_seconds"],
        tail_seconds=plan["tail_seconds"],
    )
    return plan


def load_plan_store(store, prefix: str) -> dict:
    prefix = str(prefix).strip("/")
    key = f"{prefix}/{PLAN_KEY}" if prefix else PLAN_KEY
    data, _token = store.get(key)
    payload, ok = _loads_verified(data)
    if not ok:
        raise ValueError(f"backfill plan {key!r} failed its crc32 check")
    if int(payload.get("version", -1)) != _PLAN_VERSION:
        raise ValueError(
            f"unknown backfill plan version {payload.get('version')!r}"
        )
    return payload


class StoreBackfillQueue:
    """Lease/commit operations for one worker over one object-store
    backfill prefix.  Surface-compatible with
    :class:`~tpudas_torch.backfill.queue.BackfillQueue` as far as
    :func:`~tpudas_torch.backfill.runner.execute_shard` duck-types it
    (``plan`` / ``shard`` / ``staging_dir`` / ``renew`` / ``park`` /
    ``commit``); ``scratch`` is this worker's PRIVATE local directory
    for staging drains — never shared, wiped freely."""

    def __init__(self, store, prefix: str, scratch=None,
                 worker: str | None = None, lease_ttl: float = 60.0,
                 clock=_time.time):
        self.store = store
        self.prefix = str(prefix).strip("/")
        self.scratch = str(
            scratch if scratch is not None
            else tempfile.mkdtemp(prefix="tpudas-backfill-")
        )
        os.makedirs(self.scratch, exist_ok=True)
        self.worker = str(
            worker if worker is not None
            else f"{os.uname().nodename}.{os.getpid()}"
        )
        self.lease_ttl = float(lease_ttl)
        self.clock = clock
        self.plan = load_plan_store(store, self.prefix)
        self._claim_seq = 0
        # lease object tokens as last read/written by THIS worker:
        # renew CASes against them
        self._lease_tokens: dict = {}

    # -- keys / paths --------------------------------------------------
    def _key(self, *parts) -> str:
        rel = "/".join(str(p) for p in parts)
        return f"{self.prefix}/{rel}" if self.prefix else rel

    def shard(self, shard_id: str) -> dict:
        for sh in self.plan["shards"]:
            if sh["id"] == shard_id:
                return sh
        raise KeyError(f"unknown shard {shard_id!r}")

    def shard_prefix(self, shard_id: str) -> str:
        return self._key(SHARDS_PREFIX, shard_id)

    def staging_dir(self, lease: Lease) -> str:
        return os.path.join(
            self.scratch, f"{lease.shard}.work.{lease.token}"
        )

    def _lease_key(self, shard_id: str) -> str:
        return self._key(LEASES_PREFIX, shard_id + ".json")

    def _done_key(self, shard_id: str) -> str:
        return self._key(DONE_PREFIX, shard_id + ".json")

    def _parked_key(self, shard_id: str) -> str:
        return self._key(PARKED_PREFIX, shard_id + ".json")

    def _manifest_key(self, shard_id: str) -> str:
        return f"{self.shard_prefix(shard_id)}/{SHARD_MANIFEST_NAME}"

    # -- state reads ---------------------------------------------------
    def _now_ns(self) -> int:
        return int(float(self.clock()) * 1e9)

    def _get_verified(self, key: str):
        """``(payload, store_token)`` or ``(None, None)`` for one
        coordination object (absent or torn both read as None — a
        torn lease protects nothing)."""
        try:
            data, token = self.store.get(key)
        except ObjectNotFoundError:
            return None, None
        payload, ok = _loads_verified(data)
        return (payload, token) if ok else (None, token)

    def read_lease(self, shard_id: str) -> dict | None:
        payload, token = self._get_verified(self._lease_key(shard_id))
        # memoize the OBJECT token unconditionally (None when absent):
        # claiming over a torn lease replaces it by CAS, and a vanished
        # lease must clear the memo or later CASes chase a ghost
        self._lease_tokens[shard_id] = token
        return payload

    def is_done(self, shard_id: str) -> bool:
        return self._get_verified(self._done_key(shard_id))[0] is not None

    def is_parked(self, shard_id: str) -> bool:
        return self.store.head(self._parked_key(shard_id)) is not None

    def shard_manifest(self, shard_id: str) -> dict | None:
        return self._get_verified(self._manifest_key(shard_id))[0]

    def manifest_verifies(self, shard_id: str) -> bool:
        """True when the shard's upload manifest exists and every
        object it names is present with its recorded token — the
        object-store equivalent of "the renamed directory exists"."""
        manifest = self.shard_manifest(shard_id)
        if manifest is None:
            return False
        base = self.shard_prefix(shard_id)
        for name, tok in manifest.get("objects", {}).items():
            if self.store.head(f"{base}/{name}") != tok:
                return False
        return True

    def shard_state(self, shard_id: str) -> str:
        """Same vocabulary as the POSIX queue: ``done`` | ``parked``
        | ``adoptable`` (verifying upload manifest, no marker, no
        live lease) | ``leased`` | ``stale`` | ``open``."""
        if self.is_done(shard_id):
            return "done"
        if self.is_parked(shard_id):
            return "parked"
        lease = self.read_lease(shard_id)
        live = (
            lease is not None
            and int(lease.get("deadline_ns", 0)) >= self._now_ns()
        )
        if live:
            return "leased"
        if self.shard_manifest(shard_id) is not None:
            return "adoptable"
        return "open" if lease is None else "stale"

    def counts(self) -> dict:
        counts = {
            "done": 0, "parked": 0, "adoptable": 0,
            "leased": 0, "stale": 0, "open": 0,
        }
        for sh in self.plan["shards"]:
            counts[self.shard_state(sh["id"])] += 1
        return counts

    def resolved(self) -> bool:
        return all(
            self.shard_state(sh["id"]) in ("done", "parked")
            for sh in self.plan["shards"]
        )

    def all_done(self) -> bool:
        return all(self.is_done(sh["id"]) for sh in self.plan["shards"])

    # -- claim / renew / release --------------------------------------
    def try_claim(self, shard_id: str) -> Lease | None:
        """Claim an open shard (create-only put) or steal a stale one
        (CAS on the stale lease's object token).  The store serializes
        racing claimers: exactly one conditional put wins, no settle
        window."""
        t0 = _time.perf_counter()
        reg = get_registry()
        state = self.shard_state(shard_id)
        if state not in ("open", "stale", "adoptable"):
            return None
        lease_key = self._lease_key(shard_id)
        with span("backfill.claim", shard=shard_id):
            fault_point("backfill.claim", path=lease_key, shard=shard_id)
            now = self._now_ns()
            token = f"{self.worker}.{os.getpid()}.{self._claim_seq}"
            self._claim_seq += 1
            payload = {
                "shard": shard_id,
                "worker": self.worker,
                "pid": os.getpid(),
                "token": token,
                "heartbeat_ns": now,
                "deadline_ns": now + int(self.lease_ttl * 1e9),
                "stolen": state == "stale",
            }
            # shard_state above just refreshed the memo: None = no
            # lease object (create-only claim), a token = stale or
            # torn lease object (atomic CAS steal)
            stale_token = self._lease_tokens.get(shard_id)
            try:
                if stale_token is None:
                    obj_token = self.store.put_if(
                        lease_key, _dumps(payload), if_absent=True
                    )
                else:
                    obj_token = self.store.put_if(
                        lease_key, _dumps(payload), if_token=stale_token
                    )
            except CASConflictError:
                reg.counter(
                    "tpudas_backfill_claim_conflicts_total",
                    "shard claims lost to another worker's concurrent "
                    "lease write (the settle re-read disagreed)",
                ).inc()
                return None
        self._lease_tokens[shard_id] = obj_token
        if state == "stale":
            reg.counter(
                "tpudas_backfill_shards_reclaimed_total",
                "shards reclaimed from a stale lease (the previous "
                "worker died or wedged; the shard is re-executed)",
            ).inc()
            log_event(
                "backfill_shard_reclaimed", shard=shard_id,
                worker=self.worker, previous="stale-lease",
            )
        lease = Lease(shard=shard_id, token=token, worker=self.worker)
        lease.overhead_s += _time.perf_counter() - t0
        return lease

    def claim_next(self) -> Lease | None:
        for sh in self.plan["shards"]:
            lease = self.try_claim(sh["id"])
            if lease is not None:
                return lease
        return None

    def renew(self, lease: Lease) -> None:
        """CAS the lease forward on its object token; any conflict or
        foreign token is a definitive steal —
        :class:`LeaseLostError`."""
        t0 = _time.perf_counter()
        current = self.read_lease(lease.shard)
        if current is None or current.get("token") != lease.token:
            raise LeaseLostError(
                f"lease on {lease.shard} lost to "
                f"{None if current is None else current.get('worker')!r}"
            )
        now = self._now_ns()
        try:
            self._lease_tokens[lease.shard] = self.store.put_if(
                self._lease_key(lease.shard),
                _dumps({
                    **current,
                    "heartbeat_ns": now,
                    "deadline_ns": now + int(self.lease_ttl * 1e9),
                }),
                if_token=self._lease_tokens.get(lease.shard),
            )
        except CASConflictError as exc:
            raise LeaseLostError(
                f"lease on {lease.shard} CAS-stolen mid-renew"
            ) from exc
        get_registry().counter(
            "tpudas_backfill_lease_renewals_total",
            "shard lease heartbeat renewals",
        ).inc()
        lease.overhead_s += _time.perf_counter() - t0

    def release(self, lease: Lease) -> None:
        current = self.read_lease(lease.shard)
        if current is not None and current.get("token") == lease.token:
            try:
                self.store.delete(self._lease_key(lease.shard))
            except OSError as exc:
                log_event(
                    "backfill_lease_release_failed", shard=lease.shard,
                    error=f"{type(exc).__name__}: {str(exc)[:120]}",
                )

    # -- commit / adopt / park ----------------------------------------
    def _upload_staging(self, shard_id: str, staging: str) -> dict:
        """Steps (1) and (2) of the commit protocol: every staged
        file as an object, then the upload manifest naming them all.
        Returns the manifest payload."""
        objects = {}
        base = self.shard_prefix(shard_id)
        for dirpath, _dirnames, filenames in os.walk(staging):
            rel_dir = os.path.relpath(dirpath, staging)
            for name in sorted(filenames):
                if ".tmp." in name:
                    continue
                rel = (
                    name if rel_dir == "."
                    else f"{rel_dir.replace(os.sep, '/')}/{name}"
                )
                with open(os.path.join(dirpath, name), "rb") as fh:
                    data = fh.read()
                objects[rel] = self.store.put(f"{base}/{rel}", data)
        manifest = {
            "shard": shard_id,
            "objects": objects,
            "count": len(objects),
        }
        self.store.put(self._manifest_key(shard_id), _dumps(manifest))
        return manifest

    def _write_done(self, shard_id: str, lease: Lease, extra: dict) -> (
        bool
    ):
        """Step (3): the create-only marker.  True = this execution
        IS the commit; False = another execution's marker stands."""
        payload = {
            "shard": shard_id,
            "worker": lease.worker,
            "token": lease.token,
            "committed_ns": self._now_ns(),
            **extra,
        }
        try:
            self.store.put_if(
                self._done_key(shard_id), _dumps(payload), if_absent=True
            )
            return True
        except CASConflictError:
            return False

    def commit(self, lease: Lease, staging: str, **extra) -> str:
        """Upload-then-mark exactly-once commit (see module doc).
        Returns ``"committed"`` | ``"lost"``; either way the local
        staging directory is consumed."""
        t0 = _time.perf_counter()
        reg = get_registry()
        with span("backfill.commit", shard=lease.shard):
            fault_point(
                "backfill.commit",
                path=self.shard_prefix(lease.shard), shard=lease.shard,
            )
            manifest = self._upload_staging(lease.shard, staging)
            lease.overhead_s += _time.perf_counter() - t0
            won = self._write_done(
                lease.shard, lease,
                {
                    "overhead_s": round(lease.overhead_s, 6),
                    "objects": int(manifest["count"]),
                    **extra,
                },
            )
            shutil.rmtree(staging, ignore_errors=True)
            self.release(lease)
        if not won:
            reg.counter(
                "tpudas_backfill_double_commits_total",
                "shard or stitch executions that lost the "
                "commit-wins rename (their staging was discarded)",
            ).inc()
            log_event(
                "backfill_commit_lost", shard=lease.shard,
                worker=self.worker,
            )
            return "lost"
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
            "backfill_shard_committed", shard=lease.shard,
            worker=self.worker,
            **{k: v for k, v in extra.items() if k != "digests"},
        )
        return "committed"

    def adopt(self, lease: Lease, **extra) -> str:
        """Finish a crashed commit: a verifying upload manifest
        without its marker gets the marker; anything less re-executes
        (``"failed"`` — the debris is overwritten idempotently by the
        re-run's uploads)."""
        if self.is_done(lease.shard):
            self.release(lease)
            return "committed"
        if not self.manifest_verifies(lease.shard):
            # mid-upload crash: delete the manifest (if any) so the
            # shard re-executes cleanly over the debris
            self.store.delete(self._manifest_key(lease.shard))
            self.release(lease)
            log_event("backfill_adopt_failed", shard=lease.shard,
                      issues=-1)
            return "failed"
        won = self._write_done(lease.shard, lease,
                               {"adopted": True, **extra})
        self.release(lease)
        if won:
            get_registry().counter(
                "tpudas_backfill_shards_committed_total",
                "shards committed exactly-once (rename + done marker)",
            ).inc()
            log_event("backfill_shard_adopted", shard=lease.shard)
        return "committed"

    def park(self, lease: Lease, exc: BaseException, kind: str) -> None:
        payload = {
            "shard": lease.shard,
            "worker": self.worker,
            "kind": kind,
            "error": f"{type(exc).__name__}: {str(exc)[:300]}",
            "parked_ns": self._now_ns(),
        }
        try:
            self.store.put_if(
                self._parked_key(lease.shard), _dumps(payload),
                if_absent=True,
            )
        except CASConflictError:
            pass  # another worker parked it first — same verdict
        self.release(lease)
        get_registry().counter(
            "tpudas_backfill_shards_parked_total",
            "shards parked after a terminal execution failure "
            "(fsck-able; the worker keeps draining the rest)",
        ).inc()
        log_event(
            "backfill_shard_parked", shard=lease.shard, kind=kind,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )

    # -- materialization (stitch / serve reads) -----------------------
    def materialize_shard(self, shard_id: str, dest: str) -> int:
        """Download one committed shard's objects into ``dest`` (the
        stitcher's local working copy); token-verified against the
        upload manifest.  Returns the object count."""
        manifest = self.shard_manifest(shard_id)
        if manifest is None:
            raise ObjectNotFoundError(self._manifest_key(shard_id))
        base = self.shard_prefix(shard_id)
        os.makedirs(dest, exist_ok=True)
        for rel, tok in manifest.get("objects", {}).items():
            data, got = self.store.get(f"{base}/{rel}")
            if got != tok:
                raise ValueError(
                    f"shard {shard_id} object {rel!r} token {got!r} != "
                    f"manifest {tok!r} (torn or tampered upload)"
                )
            path = os.path.join(dest, *rel.split("/"))
            os.makedirs(os.path.dirname(path) or dest, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
        return int(manifest.get("count", 0))


def stitch_store_backfill(store, prefix: str, queue=None,
                          worker: str | None = None,
                          scratch=None, device=None) -> dict:
    """The deterministic stitch over an object-store queue: download
    committed shards to local scratch, reuse the POSIX stitcher's row
    merge/pyramid/detect machinery verbatim, upload the result, and
    commit with a create-only marker (commit-wins, any worker may
    race).  The detect recompute runs on ``device`` (default the CUDA
    card)."""
    from tpudas_torch.backfill.stitch import _shard_window, _write_rows
    from tpudas_torch.io.spool import spool as make_spool

    if queue is None:
        queue = StoreBackfillQueue(
            store, prefix, scratch=scratch, worker=worker
        )
    done_key = queue._key(RESULT_DONE_KEY)
    if store.head(done_key) is not None:
        return {"status": "already", "result": queue._key(RESULT_PREFIX)}
    if not queue.all_done():
        counts = queue.counts()
        log_event("backfill_unstitchable", **counts)
        return {"status": "unstitchable", "counts": counts}
    plan = queue.plan
    cfg = plan["config"]
    token = f"{queue.worker}.{os.getpid()}"
    staging = os.path.join(
        queue.scratch, f"{RESULT_PREFIX}.work.{token}"
    )
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    t0 = _time.perf_counter()
    rows_total = files_total = 0
    with span("backfill.stitch", shards=len(plan["shards"])):
        shard_scratch = os.path.join(queue.scratch, "stitch-shards")
        for idx, sh in enumerate(plan["shards"]):
            sdir = os.path.join(shard_scratch, sh["id"])
            if not os.path.isdir(sdir):
                queue.materialize_shard(sh["id"], sdir)
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
        fault_point(
            "backfill.commit", path=queue._key(RESULT_PREFIX),
            shard="result",
        )
        # upload the result + its manifest, then the create-only
        # marker — same three-step protocol as a shard commit
        objects = {}
        for dirpath, _dirnames, filenames in os.walk(staging):
            rel_dir = os.path.relpath(dirpath, staging)
            for name in sorted(filenames):
                if ".tmp." in name:
                    continue
                rel = (
                    name if rel_dir == "."
                    else f"{rel_dir.replace(os.sep, '/')}/{name}"
                )
                with open(os.path.join(dirpath, name), "rb") as fh:
                    data = fh.read()
                objects[rel] = store.put(
                    queue._key(RESULT_PREFIX, rel), data
                )
        store.put(
            queue._key(RESULT_MANIFEST_KEY),
            _dumps({"objects": objects, "count": len(objects)}),
        )
        marker = {
            "worker": queue.worker,
            "rows": int(rows_total),
            "files": int(files_total),
            "shards": len(plan["shards"]),
            "wall_s": round(_time.perf_counter() - t0, 4),
        }
        shutil.rmtree(staging, ignore_errors=True)
        try:
            store.put_if(done_key, _dumps(marker), if_absent=True)
        except CASConflictError:
            get_registry().counter(
                "tpudas_backfill_double_commits_total",
                "shard or stitch executions that lost the "
                "commit-wins rename (their staging was discarded)",
            ).inc()
            return {
                "status": "already",
                "result": queue._key(RESULT_PREFIX),
            }
    get_registry().counter(
        "tpudas_backfill_stitch_rows_total",
        "output rows stitched into committed backfill results",
    ).inc(rows_total)
    log_event(
        "backfill_stitched", root=f"store:{queue.prefix}",
        rows=rows_total, files=files_total, shards=len(plan["shards"]),
    )
    return {
        "status": "committed",
        "result": queue._key(RESULT_PREFIX),
        "rows": rows_total,
    }


def run_store_worker(store, prefix: str, scratch=None,
                     worker: str | None = None, stitch: bool = True,
                     idle_poll: float = 0.25,
                     max_wall: float | None = None,
                     sleep_fn=_time.sleep, device=None,
                     **queue_kwargs) -> dict:
    """One object-store backfill worker, end to end — the exact
    :func:`~tpudas_torch.backfill.runner.run_worker` loop (claim → adopt or
    drain → commit → stitch race) on the store substrate.  The worker
    shares NOTHING with its peers but the store.  ``device`` (default
    the CUDA card) runs every shard and the stitch's detect recompute."""
    from tpudas_torch.backfill.runner import execute_shard, prepare_device

    device = prepare_device(device)
    queue = StoreBackfillQueue(
        store, prefix, scratch=scratch, worker=worker, **queue_kwargs
    )
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
            sleep_fn(idle_poll)
            continue
        if queue.manifest_verifies(lease.shard):
            # a crashed commit (uploads + manifest landed, marker
            # missing): adopt instead of re-draining
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
                "backfill_lease_lost", shard=lease.shard,
                worker=queue.worker, error=str(exc)[:200],
            )
            continue
        tally[outcome] = tally.get(outcome, 0) + 1
    if stitch and queue.all_done():
        result = stitch_store_backfill(
            store, prefix, queue=queue, device=device
        )
        tally["stitched"] = result["status"] in ("committed", "already")
        tally["stitch_status"] = result["status"]
    # replicated store: before this worker exits, push any writes a
    # down mirror missed (the handoff journal) at mirrors that have
    # healed meanwhile — workers drain their own debt, scrub only
    # mops up after crashes
    from tpudas_torch.store.replica import find_replicated

    repl = find_replicated(store)
    if repl is not None:
        tally["handoff_drained"] = repl.drain_handoff()
    tally["counts"] = queue.counts()
    log_event("backfill_worker_done", **{
        k: v for k, v in tally.items() if k != "counts"
    })
    return tally
