"""The port's replicated object-store plane (tpudas_torch.store.replica).

Every case of ``tests/test_store_replica.py``, against the port on the
CPU:

Primary + N-mirror composition through ``store_from_url``, the
write-through fan-out with its crc-stamped hinted-handoff journal
(idempotent token-compare drain, zero re-uploads), CAS pinned to the
primary, the read failover ladder (primary → mirrors → the NVMe
cache's stale-but-verified rung, divergence counted and never
silently served), the anti-entropy scrubber, primary promotion, and
the in-process replication drill smoke.
"""

import json
import os
import sys

import pytest

from tpudas_torch.integrity.checksum import stamp_json
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.store import (
    CASConflictError,
    FakeObjectStore,
    ObjectNotFoundError,
    ReadThroughCache,
    ReplicatedStore,
    RetryingStore,
    StoreError,
    StoreNetworkError,
    find_replicated,
    store_from_url,
)
from tpudas_torch.store.replica import HandoffJournal, ScrubLoop, promote

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _registry():
    return MetricsRegistry()


def _replicated(tmp_path, n_mirrors=2):
    """(repl, raw_fakes): a ReplicatedStore over bare fakes (no retry
    wrapper — faults must fire exactly once) with a journal in
    tmp_path."""
    raws = [FakeObjectStore() for _ in range(n_mirrors + 1)]
    repl = ReplicatedStore(
        raws[0], raws[1:], journal_dir=str(tmp_path / "journal")
    )
    return repl, raws


class TestComposition:
    def test_store_from_url_replica_spec(self, tmp_path):
        url = (
            f"replica:fake:tsr-p,file://{tmp_path}/m1,fake:tsr-m2"
        )
        store = store_from_url(url)
        assert isinstance(store, ReplicatedStore)
        assert find_replicated(store) is store
        # members are individually retry-wrapped; the composite is not
        assert isinstance(store.primary, RetryingStore)
        assert all(isinstance(m, RetryingStore) for m in store.mirrors)
        assert len(store.mirrors) == 2
        assert store.backend.startswith("replica(")

    def test_replica_spec_needs_two_members(self):
        with pytest.raises(StoreError):
            store_from_url("replica:fake:only-one")

    def test_find_replicated_through_wrappers(self, tmp_path):
        repl, _ = _replicated(tmp_path)
        assert find_replicated(repl) is repl
        assert find_replicated(FakeObjectStore()) is None
        assert find_replicated(None) is None

    def test_journal_dir_env(self, tmp_path, monkeypatch):
        jd = tmp_path / "env-journal"
        monkeypatch.setenv("TPUDAS_REPLICA_JOURNAL", str(jd))
        store = store_from_url("replica:fake:tje-p,fake:tje-m")
        assert store.journal.dir == str(jd)
        assert os.path.isdir(str(jd))


class TestWriteFanOut:
    def test_put_reaches_every_replica(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        token = repl.put("a/k", b"payload")
        for raw in raws:
            assert raw.get("a/k") == (b"payload", token)
        assert repl.verify_identical()

    def test_delete_fans_out(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        assert repl.delete("a/k") is True
        for raw in raws:
            assert raw.head("a/k") is None

    def test_down_mirror_journals_not_fails(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        rule = raws[1].injector.partition()
        with use_registry(_registry()) as reg:
            token = repl.put("a/k", b"x")
            assert reg.counter(
                "tpudas_store_replica_handoff_journaled_total", "",
                labelnames=("mirror",),
            ).value(mirror="m0") == 1
        assert token == repl.token_for(b"x")  # caller unaffected
        assert raws[0].get("a/k")[0] == b"x"  # primary landed
        assert raws[2].get("a/k")[0] == b"x"  # healthy mirror landed
        assert repl.journal.pending(0, "a/k")
        assert repl.journal.pending_counts() == {0: 1, 1: 0}
        raws[1].injector.heal(rule)

    def test_drain_is_idempotent_by_token(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        rule = raws[1].injector.partition()
        repl.put("a/k", b"x")
        repl.put("a/j", b"y")
        raws[1].injector.heal(rule)
        # the mirror already holds one key's exact bytes (an earlier
        # drain that crashed after copying, say): zero re-uploads
        raws[1].put("a/k", b"x")
        drained = repl.drain_handoff()
        assert drained["copied"] == 1
        assert drained["already_synced"] == 1
        assert drained["failed"] == 0
        assert repl.journal.pending_counts() == {0: 0, 1: 0}
        # and a second drain has nothing at all to do
        assert all(
            v == 0 for v in repl.drain_handoff().values()
        )
        assert repl.verify_identical()

    def test_drain_of_deleted_key_deletes_mirror_copy(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        rule = raws[1].injector.partition()
        repl.delete("a/k")
        raws[1].injector.heal(rule)
        drained = repl.drain_handoff()
        assert drained["deleted"] == 1
        assert raws[1].head("a/k") is None
        assert repl.verify_identical()

    def test_drain_against_still_down_mirror_keeps_entry(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        raws[1].injector.partition()
        repl.put("a/k", b"x")
        drained = repl.drain_handoff()
        assert drained["failed"] == 1
        assert repl.journal.pending(0, "a/k")  # still owed


class TestCASPinning:
    def test_cas_commits_on_primary_then_mirrors_catch_up(
            self, tmp_path):
        repl, raws = _replicated(tmp_path)
        token = repl.put_if("m/lease", b"mine", if_absent=True)
        assert raws[0].get("m/lease") == (b"mine", token)
        # mirrors got the post-CAS bytes as plain copies
        for raw in raws[1:]:
            assert raw.get("m/lease")[0] == b"mine"
        with pytest.raises(CASConflictError):
            repl.put_if("m/lease", b"rival", if_absent=True)

    def test_cas_conflict_never_touches_mirrors(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put_if("m/lease", b"mine", if_absent=True)
        with pytest.raises(CASConflictError):
            repl.put_if("m/lease", b"rival", if_absent=True)
        for raw in raws:
            assert raw.get("m/lease")[0] == b"mine"

    def test_cas_with_primary_down_is_unavailable_not_split_brain(
            self, tmp_path):
        """While the primary is unreachable, coordination is DOWN —
        a mirror never takes the CAS, so two sides of a partition
        cannot both win a lease."""
        repl, raws = _replicated(tmp_path)
        raws[0].injector.partition()
        with pytest.raises(StoreNetworkError):
            repl.put_if("m/lease", b"mine", if_absent=True)
        for raw in raws[1:]:
            assert raw.head("m/lease") is None

    def test_mirror_down_during_cas_journals_the_copy(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        rule = raws[1].injector.partition()
        repl.put_if("m/lease", b"mine", if_absent=True)
        assert repl.journal.pending(0, "m/lease")
        raws[1].injector.heal(rule)
        assert repl.drain_handoff()["copied"] == 1
        assert raws[1].get("m/lease")[0] == b"mine"


class TestReadLadder:
    def test_absence_from_primary_is_definitive(self, tmp_path):
        repl, _raws = _replicated(tmp_path)
        with pytest.raises(ObjectNotFoundError):
            repl.get("a/missing")
        assert repl.head("a/missing") is None
        assert repl.exists("a/missing") is False

    def test_failover_to_mirror_counted(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        healthy = repl.get("a/k")
        raws[0].injector.partition()
        with use_registry(_registry()) as reg:
            assert repl.get("a/k") == healthy  # byte-identical
            assert repl.head("a/k") == healthy[1]
            assert repl.list("a") == ["a/k"]
            assert reg.counter(
                "tpudas_store_replica_failover_reads_total", "",
                labelnames=("op", "backend"),
            ).value(op="get", backend="fake") == 1

    def test_known_behind_mirror_skipped_divergence_counted(
            self, tmp_path):
        """A mirror owed a journal entry for the key is known
        divergent: the ladder must skip it, not serve its stale
        bytes."""
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"v1")
        rule = raws[1].injector.partition()
        repl.put("a/k", b"v2")  # mirror 0 still holds v1
        raws[1].injector.heal(rule)
        raws[0].injector.partition()  # now force the ladder down
        with use_registry(_registry()) as reg:
            data, _tok = repl.get("a/k")
            assert data == b"v2"  # mirror 1 (in sync), NOT mirror 0
            assert reg.counter(
                "tpudas_store_replica_divergence_total", "",
                labelnames=("why",),
            ).value(why="journal_pending") == 1

    def test_mirror_missing_key_is_not_absence(self, tmp_path):
        """Primary down + a mirror that never got the key: the ladder
        keeps descending (another mirror may hold it) and, when no
        rung can serve, reports UNAVAILABLE — never 'not found' from
        a replica that may be behind."""
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        raws[1]._objects.pop("a/k")  # silently lost on mirror 0
        raws[0].injector.partition()
        assert repl.get("a/k")[0] == b"x"  # mirror 1 serves
        raws[2].injector.partition()
        with pytest.raises(StoreNetworkError):
            repl.get("a/k")
        with pytest.raises(StoreNetworkError):
            repl.head("a/k")

    def test_torn_debris_unioned_across_replicas(self, tmp_path):
        from tpudas_torch.store import FaultInjector, FaultRule

        repl, raws = _replicated(tmp_path, n_mirrors=1)
        raws[1].injector.add(
            FaultRule(kind="torn", op="put", match="a/")
        )
        repl.put("a/k", b"x")  # mirror's copy tears -> journaled
        assert repl.list_uploads() == ["a/k"]
        assert repl.abort_upload("a/k") is True
        assert repl.list_uploads() == []


class TestCacheLadderUnderReplication:
    """Satellite 4: every rung of primary → mirror → NVMe
    stale-but-verified serves byte-identical data and is counted
    distinctly."""

    def _rig(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        cache = ReadThroughCache(str(tmp_path / "cache"))
        repl.put("t/obj", b"tile-bytes")
        return repl, raws, cache

    def test_three_rungs_byte_identical_and_counted(self, tmp_path):
        repl, raws, cache = self._rig(tmp_path)
        with use_registry(_registry()) as reg:
            # rung 1: primary serves (cache miss -> fetch)
            healthy = cache.get_through(repl, "t/obj")
            assert healthy[0] == b"tile-bytes"
            # rung 2: primary severed -> mirror serves, cache reuses
            # the probe path; bytes identical
            raws[0].injector.partition()
            cache.invalidate_prefix("t")  # force a real refetch
            assert cache.get_through(repl, "t/obj") == healthy
            failovers = reg.counter(
                "tpudas_store_replica_failover_reads_total", "",
                labelnames=("op", "backend"),
            )
            # head probe + get both failed over
            assert failovers.value(op="get", backend="fake") >= 1
            # rung 3: EVERYTHING severed -> the cache's verified copy
            for raw in raws[1:]:
                raw.injector.partition()
            stale = cache.get_through(repl, "t/obj")
            assert stale == healthy
            assert cache.degraded() is True
            assert reg.counter(
                "tpudas_store_cache_stale_served_total", ""
            ).value() >= 1
            # heal -> the ladder comes back up, cache un-degrades
            for raw in raws:
                raw.injector.heal(None)
            assert cache.get_through(repl, "t/obj") == healthy
            assert cache.degraded() is False

    def test_no_rung_never_serves_silently_wrong(self, tmp_path):
        """A key the cache has never verified + every replica down =
        an error, not a fabrication."""
        repl, raws, cache = self._rig(tmp_path)
        for raw in raws:
            raw.injector.partition()
        with pytest.raises(StoreNetworkError):
            cache.get_through(repl, "t/obj")


class TestJournal:
    def test_lines_are_crc_stamped_and_torn_tail_skipped(
            self, tmp_path):
        j = HandoffJournal(str(tmp_path / "j"), 1)
        j.record(0, "a/k", "put", "deadbeef-3")
        path = j._my_file(0)
        with open(path) as fh:
            obj = json.loads(fh.readline())
        assert "_crc32" in obj
        # torn tail: a half-written line and garbage must not poison
        # the fold
        with open(path, "a") as fh:
            fh.write('{"key": "a/torn", "op": "pu')
        with open(path, "a") as fh:
            fh.write("\nnot json at all\n")
        pending = HandoffJournal(str(tmp_path / "j"), 1).load_pending(0)
        assert list(pending) == ["a/k"]

    def test_tampered_line_rejected(self, tmp_path):
        j = HandoffJournal(str(tmp_path / "j"), 1)
        entry = {"key": "a/evil", "op": "put", "token": None, "ts": 0}
        stamped = stamp_json(dict(entry))
        stamped["key"] = "a/other"  # bytes no longer match the stamp
        with open(j._my_file(0), "a") as fh:
            fh.write(json.dumps(stamped) + "\n")
        assert HandoffJournal(
            str(tmp_path / "j"), 1
        ).load_pending(0) == {}

    def test_folds_other_processes_files(self, tmp_path):
        """A worker that died mid-debt leaves m<i>-<pid>.jsonl behind;
        any other process's drain must see those entries."""
        jdir = str(tmp_path / "j")
        dead = HandoffJournal(jdir, 1)
        dead.record(0, "a/dead", "put", "cafebabe-4")
        # pose as a DIFFERENT process: rename the file to a foreign pid
        os.rename(
            dead._my_file(0), os.path.join(jdir, "m0-99999.jsonl")
        )
        mine = HandoffJournal(jdir, 1)
        assert "a/dead" in mine.load_pending(0)
        mine.clear(0, ["a/dead"])
        assert mine.load_pending(0) == {}
        # the foreign file was compacted away
        assert not os.path.exists(os.path.join(jdir, "m0-99999.jsonl"))

    def test_last_entry_per_key_wins(self, tmp_path):
        j = HandoffJournal(str(tmp_path / "j"), 1)
        j.record(0, "a/k", "put", "11111111-1")
        j.record(0, "a/k", "delete", None)
        pending = j.load_pending(0)
        assert pending["a/k"]["op"] == "delete"


class TestScrubAndPromotion:
    def test_scrub_repairs_missing_mismatch_extra(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k1", b"one")
        repl.put("a/k2", b"two")
        # fabricate divergence BEHIND the journal's back (a crashed
        # worker whose journal never made it to disk)
        raws[1]._objects.pop("a/k1")              # missing
        raws[1]._objects["a/k2"] = b"stale"       # mismatch
        raws[2]._objects["a/extra"] = b"lost"     # primary lost it
        report = repl.scrub("", repair=True)
        assert report["clean"]
        # the restored "a/extra" is then copied to the OTHER mirror too,
        # so it shows up once as "restored" and once as "missing"
        assert report["repairs"] == {
            "missing": 2, "mismatch": 1, "restored": 1,
            "torn_swept": 0,
        }
        assert repl.verify_identical()
        assert raws[0].get("a/extra")[0] == b"lost"  # restored

    def test_scrub_no_repair_reports_only(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        raws[1]._objects.pop("a/k")
        report = repl.scrub("", repair=False)
        assert not report["clean"]
        assert report["matrix"][0]["missing"] == 1
        assert report["matrix"][0]["repaired"] == 0
        assert raws[1].head("a/k") is None  # untouched

    def test_scrub_sweeps_torn_debris_everywhere(self, tmp_path):
        repl, raws = _replicated(tmp_path, n_mirrors=1)
        raws[1]._uploads.add("a/torn")
        report = repl.scrub("", repair=True)
        assert report["repairs"]["torn_swept"] == 1
        assert raws[1].list_uploads() == []
        assert report["clean"]

    def test_scrub_unreachable_mirror_not_clean(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        raws[1].injector.partition()
        repl.put("a/k", b"x")
        report = repl.scrub("", repair=True)
        assert not report["clean"]
        assert report["matrix"][0]["unreachable"]
        assert not report["matrix"][1]["unreachable"]

    def test_scrub_runs_in_background_loop(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        repl.put("a/k", b"x")
        raws[1]._objects.pop("a/k")
        loop = ScrubLoop(repl, interval_s=0.02).start()
        try:
            deadline = 200
            while loop.last_report is None and deadline:
                import time

                time.sleep(0.01)
                deadline -= 1
            assert loop.last_report is not None
            assert repl.verify_identical()
        finally:
            loop.stop()

    def test_promote_reconciles_onto_target(self, tmp_path):
        """DR: the primary is LOST; the chosen mirror absorbs what
        the other survivors hold, keeps its own copy on conflicts."""
        repl, raws = _replicated(tmp_path)
        repl.put("a/common", b"everywhere")
        # mirror 1 (raws[2]) saw a write mirror 0 missed, and they
        # disagree on one key
        raws[2]._objects["a/late"] = b"only-on-m1"
        raws[1]._objects["a/contested"] = b"target-copy"
        raws[2]._objects["a/contested"] = b"other-copy"
        report = promote(raws[1], [raws[2]])
        assert report["copied"] == 1  # a/late came over
        assert raws[1].get("a/late")[0] == b"only-on-m1"
        assert report["conflicts_total"] == 1
        assert raws[1].get("a/contested")[0] == b"target-copy"  # kept

    def test_promote_sweeps_target_debris(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        raws[1]._uploads.add("a/torn")
        report = promote(raws[1], [raws[2]])
        assert report["torn_swept"] == 1

    def test_audit_backfill_store_carries_replication_block(
            self, tmp_path):
        """fsck --store with a replica: URL folds the scrub verdict
        into clean."""
        from tpudas_torch.backfill.objqueue import plan_backfill_store
        from tpudas_torch.integrity.audit import audit_backfill_store
        from tpudas_torch.testing import make_synthetic_spool

        import numpy as np

        src = str(tmp_path / "src")
        make_synthetic_spool(
            src, n_files=2, file_duration=20.0, fs=50.0, n_ch=4,
            noise=0.01, start=np.datetime64("2023-03-22T00:00:00"),
        )
        repl, raws = _replicated(tmp_path)
        plan_backfill_store(
            repl, "job", src, "2023-03-22T00:00:00",
            "2023-03-22T00:00:40", shard_seconds=40.0,
            output_sample_interval=1.0, edge_buffer=5.0,
            process_patch_size=20,
        )
        raws[1]._objects.pop(sorted(raws[1]._objects)[0])  # diverge
        report = audit_backfill_store(repl, "job", repair=True)
        assert "replication" in report
        assert report["replication"]["clean"]
        assert report["clean"]
        assert repl.verify_identical()

    def test_snapshot_shape(self, tmp_path):
        repl, raws = _replicated(tmp_path)
        raws[1].injector.partition()
        repl.put("a/k", b"x")
        repl.scrub("", repair=False)
        snap = repl.snapshot()
        assert snap["mirrors"] == ["fake", "fake"]
        assert snap["handoff_pending"] == {0: 1, 1: 0}
        assert snap["last_scrub"]["clean"] is False
        assert "failover_reads" in snap and "divergence" in snap


class TestReplicaDrillSmoke:
    def test_in_process_replica_drill(self, tmp_path):
        """Tier-1 smoke of the full story: sever one mirror mid-job,
        drain the job with two workers, heal, drain the journal,
        scrub — replica trees byte-identical to a single-store
        control, zero re-uploads, zero CAS commits lost or doubled."""
        from tpudas_torch.tools.backfill_drill import run_replica_drill

        rep = run_replica_drill(
            shards=2, workers=2, workdir=str(tmp_path / "drill"),
            device="cpu",
        )
        assert rep["ok"], {
            k: v for k, v in rep.items() if k != "workdir"
        }

    @pytest.mark.slow
    def test_subprocess_replica_drill(self, tmp_path):
        """The full subprocess matrix: SIGKILLs + a posix mirror
        severed for the kill window (out of the tier-1 budget)."""
        from tpudas_torch.tools.backfill_drill import run_store_backfill_drill

        rep = run_store_backfill_drill(
            workers=2, kills=2, shards=2, replicas=2,
            workdir=str(tmp_path / "drill"), device="cpu",
        )
        assert rep["ok"], {
            k: v for k, v in rep.items() if k != "workdir"
        }
        assert rep["replication"]["replicas_identical"]
