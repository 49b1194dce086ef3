"""Replicated object store: one primary + N mirrors, self-healing.

The object store makes serving and backfill stateless over a single
:class:`~tpudas_torch.store.base.ObjectStore`; this module removes that
store as a single point of failure.  A :class:`ReplicatedStore`
implements the exact same contract over **one primary and N mirrors**
(any mix of posix / s3 / fake backends, composed via the
``replica:urlA,urlB,...`` spec of :func:`tpudas_torch.store.store_from_url`)
with a write/read discipline that keeps every guarantee of the single store intact:

**Write discipline** follows the immutable/mutable split of
:mod:`tpudas_torch.store.base`:

- **Immutable puts fan out write-through.**  The primary write must
  succeed (its token is the caller's answer); each mirror is then
  written best-effort.  A mirror that is down does NOT fail the put —
  the miss is recorded in a crc-stamped **hinted-handoff journal**
  (:class:`HandoffJournal`) and drained when the mirror heals.  The
  drain is idempotent by token compare: a mirror already holding the
  primary's bytes is skipped outright (zero re-uploads), so crashed
  drains, concurrent drains, and re-drains all converge.
- **Mutable CAS is pinned to the primary.**  ``put_if`` (leases,
  done markers, manifests) runs against the primary ONLY — the
  exactly-once commit and lease-steal semantics of the backfill are
  untouched by replication.  Mirrors receive the post-CAS bytes as
  plain best-effort copies (journaled on failure), i.e. they are
  caught up asynchronously and NEVER participate in coordination.
  While the primary is unreachable, CAS fails with
  :class:`~tpudas_torch.store.base.StoreNetworkError` — coordination is
  unavailable, never split-brained.

**Read path** walks a failover ladder: primary → mirrors in spec
order → (one layer up) the NVMe cache's stale-but-verified rung.  A
mirror known to be behind on a key (a pending handoff entry) is
counted as divergence and SKIPPED — a stale copy is never silently
served.  Absence is only definitive from the primary: when the
primary is down and no mirror holds the key, the ladder raises
``StoreNetworkError`` (so the cache rung above can degrade honestly)
rather than asserting "not found" from a replica that may be behind.

**Anti-entropy scrub** (:meth:`ReplicatedStore.scrub`, operator CLI
``tpudas_torch/tools/store_scrub.py``, wired into ``fsck --store``):
drains the journal, lists every replica, diffs by content token,
repairs mirrors from the primary (missing + mismatched objects),
restores primary-lost objects from mirrors, and sweeps torn-upload
debris on every replica.  After a clean scrub all replica trees are
byte-identical.  **Promotion** (:func:`promote`,
``store_scrub.py --promote K``) reconciles surviving replicas onto a
chosen mirror for disaster recovery after a lost primary: objects the
target lacks are copied in from any survivor; conflicting keys keep
the target's copy (counted + logged — pick the most caught-up mirror,
the scrub report shows divergence per mirror).

Everything is surfaced: ``tpudas_store_replica_*`` metrics,
``store.replicate`` / ``store.scrub`` spans, and a ``replication``
block in the remote-pyramid ``/healthz`` snapshot.  Drilled by
``tpudas_torch/tools/backfill_drill.py --store --replicas N`` and the
in-process :func:`tpudas_torch.tools.backfill_drill.run_replica_drill`.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from tpudas_torch.integrity.checksum import (
    stamp_json,
    strip_stamp,
    verify_json_obj,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.store.base import (
    ObjectNotFoundError,
    ObjectStore,
    StoreError,
    StoreNetworkError,
)
from tpudas_torch.utils.logging import log_event

__all__ = [
    "HandoffJournal",
    "ReplicatedStore",
    "find_replicated",
    "promote",
]

# exceptions a mirror fan-out absorbs into the handoff journal: every
# honest storage failure (StoreNetworkError is an OSError subclass;
# posix raises plain OSError; StoreError covers backend misconfig).
# Programming errors (TypeError & friends) still propagate.
_MIRROR_FAILURES = (StoreError, OSError)


def _journaled(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {str(exc)[:160]}"


class HandoffJournal:
    """Crc-stamped hinted-handoff journal for one replicated store.

    One JSONL file per (mirror, process) under ``journal_dir`` —
    ``m<i>-<pid>.jsonl`` — so concurrent workers on one host never
    interleave writes; :meth:`load_pending` folds every process's file
    for a mirror together (last entry per key wins).  Each line is a
    crc-stamped JSON object (:func:`tpudas_torch.integrity.checksum.stamp_json`)
    so a torn tail protects nothing and is skipped on load, exactly
    like every other durable JSON artifact of the platform.

    Entries record the failed operation (``put`` or ``delete``), the
    key, and the content token the mirror SHOULD hold — the drain's
    zero-re-upload short-circuit compares the mirror's current token
    against the primary's before moving any bytes."""

    def __init__(self, journal_dir: str, n_mirrors: int):
        self.dir = os.path.abspath(str(journal_dir))
        self.n_mirrors = int(n_mirrors)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # mirror index -> {key: entry}; the in-memory view of THIS
        # process's journal plus whatever load_pending folded in
        self._pending: dict = {i: {} for i in range(self.n_mirrors)}
        self._loaded = False

    def _my_file(self, mirror: int) -> str:
        return os.path.join(self.dir, f"m{int(mirror)}-{os.getpid()}.jsonl")

    def _mirror_files(self, mirror: int) -> list:
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return []
        want = f"m{int(mirror)}-"
        return [
            os.path.join(self.dir, n) for n in names
            if n.startswith(want) and n.endswith(".jsonl")
        ]

    # -- write side ----------------------------------------------------
    def record(self, mirror: int, key: str, op: str,
               token: str | None, error: str = "") -> None:
        entry = {
            "key": str(key), "op": str(op), "token": token,
            "ts": time.time(), "error": error,
        }
        line = json.dumps(stamp_json(dict(entry))) + "\n"
        with self._lock:
            self._pending[int(mirror)][str(key)] = entry
            try:
                with open(self._my_file(mirror), "a") as fh:
                    fh.write(line)
            except OSError:
                pass  # in-memory entry still drains this process

    # -- read side -----------------------------------------------------
    def load_pending(self, mirror: int) -> dict:
        """``{key: entry}`` folding every process's journal file for
        ``mirror`` under the in-memory view (disk first, so this
        process's later entries win)."""
        out: dict = {}
        for path in self._mirror_files(mirror):
            try:
                with open(path) as fh:
                    lines = fh.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue  # torn tail
                if (not isinstance(obj, dict)
                        or verify_json_obj(obj) == "mismatch"):
                    continue
                entry = strip_stamp(obj)
                if "key" in entry:
                    out[str(entry["key"])] = entry
        with self._lock:
            out.update(self._pending[int(mirror)])
        return out

    def pending(self, mirror: int, key: str) -> bool:
        """True when THIS process knows ``mirror`` is behind on
        ``key`` (the read ladder's known-divergent skip)."""
        with self._lock:
            return str(key) in self._pending[int(mirror)]

    def pending_counts(self) -> dict:
        with self._lock:
            return {
                i: len(v) for i, v in sorted(self._pending.items())
            }

    def clear(self, mirror: int, keys) -> None:
        """Drop drained keys from memory and compact the on-disk
        files (every process's — drains are idempotent, so whichever
        process compacts last wins harmlessly)."""
        keys = set(str(k) for k in keys)
        with self._lock:
            for k in keys:
                self._pending[int(mirror)].pop(k, None)
            survivors = dict(self._pending[int(mirror)])
        for path in self._mirror_files(mirror):
            if os.path.basename(path) == os.path.basename(
                self._my_file(mirror)
            ):
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
        # rewrite this process's file with the survivors only
        try:
            if survivors:
                body = "".join(
                    json.dumps(stamp_json(dict(e))) + "\n"
                    for e in survivors.values()
                )
                with open(self._my_file(mirror), "w") as fh:
                    fh.write(body)
            else:
                try:
                    os.unlink(self._my_file(mirror))
                except FileNotFoundError:
                    pass
        except OSError:
            pass


class ReplicatedStore(ObjectStore):
    """The :class:`ObjectStore` contract over one primary + N mirrors.

    ``primary`` and each mirror are plain stores (typically each
    retry-wrapped by :func:`tpudas_torch.store.store_from_url`, so failover
    is attributable per backend in ``/metrics``).  The composite
    itself is NOT retry-wrapped: the members already absorb transient
    faults, and a member that stays down is exactly what the handoff
    journal and the failover ladder exist for.

    Public methods override the base class directly (the members
    carry the per-op spans/metrics/fault sites); the composite adds
    the ``store.replicate`` fan-out span and the
    ``tpudas_store_replica_*`` accounting."""

    def __init__(self, primary: ObjectStore, mirrors,
                 journal_dir: str | None = None):
        self.primary = primary
        self.mirrors = list(mirrors)
        self.backend = (
            f"replica({primary.backend}+{len(self.mirrors)}m)"
        )
        if journal_dir is None:
            journal_dir = os.environ.get("TPUDAS_REPLICA_JOURNAL") or (
                tempfile.mkdtemp(prefix="tpudas-replica-journal-")
            )
        self.journal = HandoffJournal(journal_dir, len(self.mirrors))
        self._lock = threading.Lock()
        self._failover_reads = 0
        self._divergence = 0
        self._last_scrub: dict | None = None
        get_registry().gauge(
            "tpudas_store_replica_mirrors",
            "mirror count behind the replicated store",
        ).set(len(self.mirrors))
        self._pending_gauge()

    # -- accounting ----------------------------------------------------
    def _mirror_tag(self, i: int) -> str:
        return self.mirrors[i].backend

    def _pending_gauge(self) -> None:
        counts = self.journal.pending_counts()
        gauge = get_registry().gauge(
            "tpudas_store_replica_handoff_pending",
            "handoff-journal entries awaiting drain, per mirror",
            labelnames=("mirror",),
        )
        for i, n in counts.items():
            gauge.set(n, mirror=f"m{i}")

    def _count_journaled(self, i: int) -> None:
        get_registry().counter(
            "tpudas_store_replica_handoff_journaled_total",
            "mirror writes deferred into the hinted-handoff journal",
            labelnames=("mirror",),
        ).inc(mirror=f"m{i}")
        self._pending_gauge()

    def _count_mirror_write(self, i: int) -> None:
        get_registry().counter(
            "tpudas_store_replica_mirror_writes_total",
            "successful write-through fan-out writes, per mirror",
            labelnames=("mirror",),
        ).inc(mirror=f"m{i}")

    def _count_failover(self, backend: str, op: str) -> None:
        with self._lock:
            self._failover_reads += 1
        get_registry().counter(
            "tpudas_store_replica_failover_reads_total",
            "reads served by a replica below the primary rung",
            labelnames=("op", "backend"),
        ).inc(op=op, backend=backend)

    def _count_divergence(self, why: str) -> None:
        with self._lock:
            self._divergence += 1
        get_registry().counter(
            "tpudas_store_replica_divergence_total",
            "divergent replica copies detected (token compare / "
            "known-behind journal entries) — never silently served",
            labelnames=("why",),
        ).inc(why=why)

    # -- write fan-out -------------------------------------------------
    def _fan_out(self, key: str, data: bytes | None, op: str) -> None:
        """Best-effort write-through of an applied primary mutation to
        every mirror; failures become journal entries, never caller
        errors."""
        token = (
            None if data is None else self.primary.token_for(data)
        )
        with span("store.replicate", key=key, op=op,
                  mirrors=len(self.mirrors)):
            for i, mirror in enumerate(self.mirrors):
                try:
                    if op == "delete":
                        mirror.delete(key)
                    else:
                        mirror.put(key, data)
                    self._count_mirror_write(i)
                except _MIRROR_FAILURES as exc:
                    self.journal.record(
                        i, key, op, token, error=_journaled(exc)
                    )
                    self._count_journaled(i)
                    log_event(
                        "store_replica_handoff", key=key, op=op,
                        mirror=self._mirror_tag(i),
                        error=_journaled(exc),
                    )

    def put(self, key: str, data: bytes) -> str:
        token = self.primary.put(key, data)
        self._fan_out(key, bytes(data), "put")
        return token

    def put_if(self, key: str, data: bytes, *,
               if_token: str | None = None,
               if_absent: bool = False) -> str:
        # CAS pinned to the primary: a conflict or network error here
        # propagates untouched BEFORE any mirror sees bytes, so the
        # exactly-once protocols never observe a half-replicated CAS
        token = self.primary.put_if(
            key, data, if_token=if_token, if_absent=if_absent
        )
        self._fan_out(key, bytes(data), "put")
        return token

    def delete(self, key: str) -> bool:
        removed = self.primary.delete(key)
        self._fan_out(key, None, "delete")
        return removed

    # -- read ladder ---------------------------------------------------
    def _ladder(self, op: str, key: str, fn):
        """Primary → mirrors; mirrors known behind on ``key`` are
        skipped (divergence), absence below the primary is never
        asserted.  ``fn(store)`` raises ObjectNotFoundError for a
        missing key (get) or returns None (head)."""
        try:
            return fn(self.primary)
        except StoreNetworkError as primary_exc:
            last = primary_exc
        for i, mirror in enumerate(self.mirrors):
            if self.journal.pending(i, key):
                self._count_divergence("journal_pending")
                continue
            try:
                out = fn(mirror)
            except ObjectNotFoundError:
                # the mirror may simply be behind; absence is only
                # definitive from the primary — try the next rung
                self._count_divergence("mirror_missing")
                continue
            except StoreNetworkError as exc:
                last = exc
                continue
            if op == "head" and out is None:
                self._count_divergence("mirror_missing")
                continue
            self._count_failover(self._mirror_tag(i), op)
            return out
        raise StoreNetworkError(
            f"replicated {op} of {key!r} failed on every rung "
            f"(primary + {len(self.mirrors)} mirrors)"
        ) from last

    def get(self, key: str) -> tuple:
        return self._ladder("get", key, lambda s: s.get(key))

    def head(self, key: str):
        return self._ladder("head", key, lambda s: s.head(key))

    def list(self, prefix: str = "") -> list:
        try:
            return self.primary.list(prefix)
        except StoreNetworkError:
            pass
        for i, mirror in enumerate(self.mirrors):
            try:
                out = mirror.list(prefix)
            except StoreNetworkError:
                continue
            self._count_failover(self._mirror_tag(i), "list")
            return out
        raise StoreNetworkError(
            f"replicated list of {prefix!r} failed on every rung"
        )

    def list_uploads(self, prefix: str = "") -> list:
        """Union of torn-upload debris across every reachable replica
        (fsck must see a mirror's debris too)."""
        seen: set = set()
        for store in (self.primary, *self.mirrors):
            try:
                seen.update(store.list_uploads(prefix))
            except _MIRROR_FAILURES:
                continue
        return sorted(seen)

    def abort_upload(self, key: str) -> bool:
        aborted = False
        for store in (self.primary, *self.mirrors):
            try:
                aborted = store.abort_upload(key) or aborted
            except _MIRROR_FAILURES:
                continue
        return aborted

    def exists(self, key: str) -> bool:
        return self.head(key) is not None

    def token_for(self, data: bytes) -> str:
        return self.primary.token_for(data)

    # -- handoff drain -------------------------------------------------
    def drain_handoff(self) -> dict:
        """Replay the journal against every mirror that answers.
        Idempotent by token compare — an entry whose mirror already
        matches the primary is dropped without moving bytes (zero
        re-uploads).  Entries whose mirror is still down stay
        journaled.  Returns
        ``{"copied", "deleted", "already_synced", "vanished",
        "failed"}`` totals."""
        totals = {
            "copied": 0, "deleted": 0, "already_synced": 0,
            "vanished": 0, "failed": 0,
        }
        for i, mirror in enumerate(self.mirrors):
            entries = self.journal.load_pending(i)
            if not entries:
                continue
            drained = []
            for key, entry in sorted(entries.items()):
                try:
                    outcome = self._drain_one(mirror, key, entry)
                except _MIRROR_FAILURES:
                    totals["failed"] += 1
                    continue
                totals[outcome] += 1
                drained.append(key)
            if drained:
                self.journal.clear(i, drained)
                get_registry().counter(
                    "tpudas_store_replica_handoff_drained_total",
                    "handoff-journal entries resolved against a "
                    "healed mirror",
                    labelnames=("mirror",),
                ).inc(len(drained), mirror=f"m{i}")
                log_event(
                    "store_replica_handoff_drained",
                    mirror=self._mirror_tag(i), drained=len(drained),
                )
        self._pending_gauge()
        return totals

    def _drain_one(self, mirror, key: str, entry: dict) -> str:
        if entry.get("op") == "delete":
            if mirror.head(key) is None:
                return "already_synced"
            mirror.delete(key)
            return "deleted"
        try:
            data, primary_token = self.primary.get(key)
        except ObjectNotFoundError:
            # the primary no longer holds it (deleted since): the
            # hint is obsolete; delete the mirror copy if any
            if mirror.delete(key):
                return "deleted"
            return "vanished"
        if mirror.head(key) == primary_token:
            return "already_synced"
        mirror.put(key, data)
        return "copied"

    # -- anti-entropy scrub --------------------------------------------
    def _tokens(self, store, prefix: str) -> dict:
        return {k: store.head(k) for k in store.list(prefix)}

    def scrub(self, prefix: str = "", repair: bool = True) -> dict:
        """One anti-entropy pass: drain the journal, diff every
        replica against the primary by content token, repair mirrors
        from the primary, restore primary-lost objects from mirrors,
        sweep torn-upload debris everywhere.  Returns a report with a
        per-mirror repair matrix; ``clean`` is True when (after
        repair) every replica tree is token-identical and debris-free.
        Run it on demand (the ``store_scrub`` tool), from fsck, or on
        a cadence (:class:`ScrubLoop`)."""
        t0 = time.perf_counter()
        with span("store.scrub", prefix=prefix, repair=repair):
            drained = self.drain_handoff() if repair else (
                self.journal.pending_counts()
            )
            primary_tokens = self._tokens(self.primary, prefix)
            repairs = {"missing": 0, "mismatch": 0, "restored": 0,
                       "torn_swept": 0}
            # phase 1: list every mirror once, restore primary-lost
            # objects FIRST — so phase 2 repairs every other mirror
            # against a complete primary in the same pass
            rows = []
            token_maps = []
            for i, mirror in enumerate(self.mirrors):
                row = {
                    "mirror": self._mirror_tag(i),
                    "missing": 0, "mismatch": 0, "extra": 0,
                    "repaired": 0, "unreachable": False,
                }
                try:
                    token_maps.append(self._tokens(mirror, prefix))
                except _MIRROR_FAILURES:
                    row["unreachable"] = True
                    token_maps.append(None)
                rows.append(row)
            for i, mirror in enumerate(self.mirrors):
                if token_maps[i] is None:
                    continue
                extras = sorted(
                    set(token_maps[i]) - set(primary_tokens)
                )
                for key in extras:
                    # write-through means the primary sees every key
                    # first, so a mirror-only object is a primary LOSS
                    # (or a delete whose journal died with its host —
                    # immutable artifacts make resurrection harmless;
                    # run fsck before scrub to sweep true debris)
                    rows[i]["extra"] += 1
                    self._count_divergence("scrub_extra")
                    if repair:
                        data, _tok = mirror.get(key)
                        self.primary.put(key, data)
                        primary_tokens[key] = self.primary.token_for(
                            data
                        )
                        rows[i]["repaired"] += 1
                        repairs["restored"] += 1
            # phase 2: repair each mirror from the (now complete)
            # primary
            matrix = []
            for i, mirror in enumerate(self.mirrors):
                row = rows[i]
                mirror_tokens = token_maps[i]
                if mirror_tokens is None:
                    matrix.append(row)
                    continue
                for key, token in sorted(primary_tokens.items()):
                    have = mirror_tokens.get(key)
                    if have == token:
                        continue
                    kind = "missing" if have is None else "mismatch"
                    row[kind] += 1
                    self._count_divergence(f"scrub_{kind}")
                    if repair:
                        data, _tok = self.primary.get(key)
                        mirror.put(key, data)
                        row["repaired"] += 1
                        repairs[kind] += 1
                matrix.append(row)
            torn = []
            for store in (self.primary, *self.mirrors):
                try:
                    debris = store.list_uploads(prefix)
                except _MIRROR_FAILURES:
                    continue
                for key in debris:
                    torn.append(f"{store.backend}:{key}")
                    if repair:
                        store.abort_upload(key)
                        repairs["torn_swept"] += 1
        total_repairs = sum(repairs.values())
        if repair and total_repairs:
            ctr = get_registry().counter(
                "tpudas_store_replica_scrub_repairs_total",
                "objects repaired by the anti-entropy scrubber",
                labelnames=("kind",),
            )
            for kind, n in repairs.items():
                if n:
                    ctr.inc(n, kind=kind)
        get_registry().counter(
            "tpudas_store_replica_scrub_runs_total",
            "anti-entropy scrub passes",
        ).inc()
        clean = (
            (not torn or repair)
            and all(
                not r["unreachable"]
                and (repair or (r["missing"] == r["mismatch"]
                                == r["extra"] == 0))
                and (not repair or r["repaired"] == (
                    r["missing"] + r["mismatch"] + r["extra"]))
                for r in matrix
            )
        )
        report = {
            "prefix": prefix,
            "repair": bool(repair),
            "objects": len(primary_tokens),
            "drained": drained,
            "matrix": matrix,
            "repairs": repairs,
            "torn_swept": torn,
            "clean": bool(clean),
            "elapsed_s": round(time.perf_counter() - t0, 4),
        }
        with self._lock:
            self._last_scrub = {
                k: report[k]
                for k in ("clean", "repairs", "elapsed_s", "objects")
            }
        if total_repairs or torn:
            log_event(
                "store_replica_scrubbed", prefix=prefix,
                repairs=total_repairs, torn=len(torn),
                clean=report["clean"],
            )
        return report

    def verify_identical(self, prefix: str = "") -> bool:
        """Drill assertion: every replica holds the identical
        key→token map under ``prefix``."""
        want = self._tokens(self.primary, prefix)
        return all(
            self._tokens(m, prefix) == want for m in self.mirrors
        )

    # -- health --------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``replication`` block of ``/healthz``'s store entry."""
        with self._lock:
            last_scrub = self._last_scrub
            failovers = self._failover_reads
            divergence = self._divergence
        return {
            "backend": self.backend,
            "mirrors": [m.backend for m in self.mirrors],
            "handoff_pending": self.journal.pending_counts(),
            "failover_reads": failovers,
            "divergence": divergence,
            "last_scrub": last_scrub,
        }


class ScrubLoop:
    """Background anti-entropy: scrub (+ drain) on a cadence until
    stopped.  One daemon thread; failures are logged and counted,
    never raised into the owner."""

    def __init__(self, store: ReplicatedStore, prefix: str = "",
                 interval_s: float = 60.0):
        self.store = store
        self.prefix = str(prefix)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_report: dict | None = None

    def start(self) -> "ScrubLoop":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tpudas-store-scrub", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.last_report = self.store.scrub(
                    self.prefix, repair=True
                )
            except Exception as exc:  # keep the loop alive
                log_event(
                    "store_replica_scrub_error",
                    error=_journaled(exc),
                )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def find_replicated(store) -> ReplicatedStore | None:
    """The :class:`ReplicatedStore` inside an (optionally wrapped)
    store handle, or None — how serving/backfill/fsck discover the
    replication plane without typing against it."""
    seen = 0
    while store is not None and seen < 8:
        if isinstance(store, ReplicatedStore):
            return store
        store = getattr(store, "inner", None)
        seen += 1
    return None


def promote(target: ObjectStore, survivors, prefix: str = "",
            repair: bool = True) -> dict:
    """Disaster recovery: reconcile surviving replicas onto
    ``target``, the mirror being promoted to primary after the old
    primary is lost.  Objects the target lacks are copied in from any
    survivor that holds them; keys where replicas disagree keep the
    TARGET's copy (counted — choose the most caught-up mirror; the
    scrub report's divergence matrix is the guide); torn-upload
    debris on the target is swept.  After promotion, restart every
    component with the promoted member FIRST in the ``replica:`` spec
    and run a full scrub to converge the remaining mirrors."""
    t0 = time.perf_counter()
    with span("store.scrub", prefix=prefix, promote=True):
        try:
            have = {k: target.head(k) for k in target.list(prefix)}
        except _MIRROR_FAILURES as exc:
            raise StoreError(
                f"promotion target unreachable: {_journaled(exc)}"
            )
        copied = 0
        conflicts = []
        unreachable = []
        for survivor in survivors:
            if survivor is target:
                continue
            try:
                theirs = {
                    k: survivor.head(k) for k in survivor.list(prefix)
                }
            except _MIRROR_FAILURES:
                unreachable.append(survivor.backend)
                continue
            for key, token in sorted(theirs.items()):
                mine = have.get(key)
                if mine == token:
                    continue
                if mine is None:
                    if repair:
                        data, _tok = survivor.get(key)
                        target.put(key, data)
                        have[key] = target.token_for(data)
                        copied += 1
                elif key not in (c["key"] for c in conflicts):
                    conflicts.append({
                        "key": key, "kept": mine,
                        "survivor": survivor.backend, "theirs": token,
                    })
        swept = 0
        if repair:
            for key in target.list_uploads(prefix):
                target.abort_upload(key)
                swept += 1
    get_registry().counter(
        "tpudas_store_replica_promotions_total",
        "mirror-to-primary promotion reconciliations",
    ).inc()
    report = {
        "target": target.backend,
        "prefix": prefix,
        "repair": bool(repair),
        "copied": copied,
        "conflicts": conflicts,
        "conflicts_total": len(conflicts),
        "torn_swept": swept,
        "unreachable": unreachable,
        "elapsed_s": round(time.perf_counter() - t0, 4),
    }
    log_event(
        "store_replica_promoted", target=target.backend,
        copied=copied, conflicts=len(conflicts),
        unreachable=len(unreachable),
    )
    return report
