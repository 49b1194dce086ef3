"""The port's cluster backfill (tpudas_torch.backfill) on the CPU.

Every case of ``tests/test_backfill.py``, run against the port with
``device="cpu"`` (the plain PyTorch versions of the kernels): lease
claim/renew/steal determinism, exactly-once commit (idempotent
double-commit, commit-wins), KeyboardInterrupt kills at
``backfill.claim`` / ``backfill.commit`` / ``round.body`` with the
drained and stitched result byte-identical to an uninterrupted control
and to a plain sequential realtime run, fatal-shard park, ENOSPC
shedding inside a shard, the runner's drain clamps (``time_range``,
``ingest_limit_sec``, held to the JAX runner's ``_more_to_drain`` /
``terminate`` sequence), and ``audit_backfill`` classify/repair.

Then the cross-package cases: ``backfill.json`` byte-equal from both
packages' ``plan_backfill``; a queue half-drained by one package and
finished and stitched by the other (leases, done markers and plan read
both ways; the result within 1e-5 per channel of each package's own);
``audit_backfill`` reports and repairs equal over the same damage; and
stitched == 1-worker control == sequential run, byte for byte within
the port, under the ``torch`` and ``fused-torch`` engines.  The chaos
drill runs under ``-m slow`` as in the JAX package, and its in-process
fault matrix in tier-1 (``tests/test_torch_store_backfill.py``).
"""

import errno
import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest

from tpudas_torch.backfill import (
    BackfillQueue,
    LeaseLostError,
    load_plan,
    plan_backfill,
)
from tpudas_torch.backfill import run_worker as _run_worker
from tpudas_torch.backfill import stitch_backfill as _stitch_backfill
from tpudas_torch.backfill.queue import (
    DONE_DIRNAME,
    LEASES_DIRNAME,
    RESULT_DONE_FILENAME,
    SHARDS_DIRNAME,
)
from tpudas_torch.backfill.runner import execute_shard as _execute_shard
from tpudas_torch.integrity.audit import audit_backfill
from tpudas_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    install_fault_plan,
)
from tpudas_torch.testing import make_synthetic_spool
from tpudas_torch.tools.crash_drill import (
    _content_hash,
    _detect_state,
    _pyramid_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the port's entry points default to the card; these tests run the
# plain versions on the CPU
CPU = "cpu"
run_worker = functools.partial(_run_worker, device=CPU)
stitch_backfill = functools.partial(_stitch_backfill, device=CPU)
execute_shard = functools.partial(_execute_shard, device=CPU)


def enospc_error(msg: str = "injected: no space left on device") -> OSError:
    """An ``OSError`` carrying ``errno.ENOSPC`` (the JAX package's
    ``enospc_error`` of its testing module)."""
    return OSError(errno.ENOSPC, msg)

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
N_CH = 4
DT = 1.0
EDGE = 5.0
N_FILES = 6  # 120 s archive
SHARD_SEC = 60.0
DETECT_OPS = (
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5,
             "baseline": 20.0}),
)


def _t_end():
    return np.datetime64(T0) + np.timedelta64(
        int(N_FILES * FILE_SEC * 1e9), "ns"
    )


def _plan(root, src, **overrides):
    kwargs = dict(
        shard_seconds=SHARD_SEC,
        output_sample_interval=DT,
        edge_buffer=EDGE,
        process_patch_size=20,
        pyramid=False,
        detect=False,
        ingest_limit_sec=35.0,
    )
    kwargs.update(overrides)
    return plan_backfill(root, src, T0, _t_end(), **kwargs)


class FakeClock:
    def __init__(self, t=1_000_000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, sec):
        self.t += float(sec)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("bf_archive") / "src")
    make_synthetic_spool(
        src, n_files=N_FILES, file_duration=FILE_SEC, fs=FS,
        n_ch=N_CH, noise=0.01, start=np.datetime64(T0),
    )
    return src


@pytest.fixture(scope="module")
def sequential_ref(archive, tmp_path_factory):
    """The oracle: a plain realtime run over the archive with
    pyramid + detect on."""
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    out = str(tmp_path_factory.mktemp("bf_seq") / "out")
    run_lowpass_realtime(
        source=archive, output_folder=out, start_time=T0,
        output_sample_interval=DT, edge_buffer=EDGE,
        process_patch_size=20, poll_interval=0.0,
        sleep_fn=lambda _s: None, pyramid=True, detect=True,
        detect_operators=DETECT_OPS, device=CPU,
    )
    return out


@pytest.fixture(scope="module")
def control(archive, tmp_path_factory):
    """The 1-worker uninterrupted control over a full-feature plan."""
    root = str(tmp_path_factory.mktemp("bf_ctrl") / "root")
    _plan(root, archive, pyramid=True, detect=True,
          detect_operators=DETECT_OPS)
    tally = run_worker(root, worker="ctrl", settle=0.0, max_wall=300)
    assert tally["stitched"]
    return root


class TestPlan:
    def test_shard_grid_and_remainder(self, archive, tmp_path):
        plan = _plan(str(tmp_path / "q"), archive, shard_seconds=50.0)
        shards = plan["shards"]
        assert [s["id"] for s in shards] == [
            f"sh{k:05d}" for k in range(len(shards))
        ]
        # contiguous tiling of [t0, t1)
        assert shards[0]["t0_ns"] == plan["t0_ns"]
        assert shards[-1]["t1_ns"] == plan["t1_ns"]
        for a, b in zip(shards, shards[1:]):
            assert a["t1_ns"] == b["t0_ns"]
        # leads are plan-derived, grid-rounded, positive
        assert plan["lead_seconds"] % DT == 0
        assert plan["tail_seconds"] % DT == 0
        assert plan["lead_seconds"] > 0 and plan["tail_seconds"] > 0

    def test_plan_is_immutable(self, archive, tmp_path):
        root = str(tmp_path / "q")
        _plan(root, archive)
        with pytest.raises(FileExistsError):
            _plan(root, archive)

    def test_unknown_config_key_rejected(self, archive, tmp_path):
        with pytest.raises(ValueError, match="unknown backfill config"):
            _plan(str(tmp_path / "q"), archive, bogus_knob=1)

    def test_torn_plan_refused(self, archive, tmp_path):
        root = str(tmp_path / "q")
        _plan(root, archive)
        path = os.path.join(root, "backfill.json")
        with open(path) as fh:
            payload = json.load(fh)
        payload["t1_ns"] += 1  # stamp now mismatches
        with open(path, "w") as fh:
            json.dump(payload, fh)
        with pytest.raises(ValueError, match="crc32"):
            load_plan(root)


class TestLease:
    def _queue(self, root, worker, clock, ttl=30.0):
        return BackfillQueue(
            root, worker=worker, lease_ttl=ttl, settle=0.0, clock=clock
        )

    def test_claim_renew_release(self, archive, tmp_path):
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = self._queue(root, "wa", clock)
        qb = self._queue(root, "wb", clock)
        lease = qa.try_claim("sh00000")
        assert lease is not None and lease.worker == "wa"
        assert qa.shard_state("sh00000") == "leased"
        # a live lease is not claimable by anyone else
        assert qb.try_claim("sh00000") is None
        before = qa.read_lease("sh00000")["deadline_ns"]
        clock.advance(10.0)
        qa.renew(lease)
        assert qa.read_lease("sh00000")["deadline_ns"] > before
        qa.release(lease)
        assert qa.shard_state("sh00000") == "open"

    def test_stale_lease_is_stolen_and_renew_raises(
        self, archive, tmp_path
    ):
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = self._queue(root, "wa", clock, ttl=5.0)
        qb = self._queue(root, "wb", clock, ttl=5.0)
        lease_a = qa.try_claim("sh00000")
        assert lease_a is not None
        assert qb.try_claim("sh00000") is None
        clock.advance(6.0)  # past wa's deadline
        assert qb.shard_state("sh00000") == "stale"
        lease_b = qb.try_claim("sh00000")
        assert lease_b is not None and lease_b.worker == "wb"
        # the dead worker's resurrection must notice the theft
        with pytest.raises(LeaseLostError):
            qa.renew(lease_a)
        # and its release must not clobber the thief's lease
        qa.release(lease_a)
        assert qb.read_lease("sh00000")["worker"] == "wb"

    def test_claim_next_walks_plan_order(self, archive, tmp_path):
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = self._queue(root, "wa", clock)
        claimed = [qa.claim_next().shard for _ in range(2)]
        assert claimed == ["sh00000", "sh00001"]

    def test_settle_reread_detects_lost_race(self, archive, tmp_path):
        """Two claimers racing one shard: the loser's settle re-read
        sees the winner's token and backs off (simulated by writing
        the winner's lease inside the loser's settle window via a
        zero-settle interleave)."""
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = self._queue(root, "wa", clock)
        qb = self._queue(root, "wb", clock)
        lease_a = qa.try_claim("sh00000")
        assert lease_a is not None
        # wb writes over wa's lease directly (the last-write-wins
        # race), then wa's next renew acts as its settle re-read
        from tpudas_torch.integrity.checksum import write_json_checksummed

        now = int(clock() * 1e9)
        write_json_checksummed(
            os.path.join(root, LEASES_DIRNAME, "sh00000.json"),
            {
                "shard": "sh00000", "worker": "wb", "pid": 1,
                "token": "wb.1.0", "heartbeat_ns": now,
                "deadline_ns": now + 30_000_000_000, "stolen": False,
            },
        )
        with pytest.raises(LeaseLostError):
            qa.renew(lease_a)


class TestExecuteAndStitch:
    def test_single_worker_matches_sequential_run(
        self, control, sequential_ref
    ):
        """THE tentpole claim, in-process: a backfill drain + stitch
        is byte-identical to a single sequential realtime run —
        merged output content, pyramid tree file-by-file, events
        ledger bytes, score tiles, parsed detect carry."""
        res = os.path.join(control, "result")
        assert _content_hash(res) == _content_hash(sequential_ref)
        assert _pyramid_tree(res) == _pyramid_tree(sequential_ref)
        assert _detect_state(res) == _detect_state(sequential_ref)

    def test_drain_uses_bounded_rounds(self, archive, control):
        """ingest_limit_sec chunks the drain into multiple bounded
        rounds (the lease-renewal cadence) — visible in the done
        markers' round counts."""
        from tpudas_torch.integrity.checksum import read_json_verified

        done = os.path.join(control, DONE_DIRNAME)
        rounds = []
        for name in sorted(os.listdir(done)):
            payload, _ = read_json_verified(
                os.path.join(done, name), "backfill_done"
            )
            rounds.append(payload.get("rounds", 0))
        assert rounds and all(r >= 1 for r in rounds)

    def test_kill_at_claim_commit_round_then_resume_identical(
        self, archive, control, tmp_path
    ):
        """KeyboardInterrupt (the in-process SIGKILL stand-in — it
        bypasses every ``except Exception``) at backfill.claim,
        backfill.commit, and round.body in three successive worker
        incarnations; a fourth clean worker drains what is left.  The
        stitched result must be byte-identical to the uninterrupted
        control."""
        root = str(tmp_path / "q")
        _plan(root, archive, pyramid=True, detect=True,
              detect_operators=DETECT_OPS)
        clock = FakeClock()
        kill_sites = ("backfill.claim", "backfill.commit", "round.body")
        for i, site in enumerate(kill_sites):
            plan = FaultPlan(
                FaultSpec(site, exc=KeyboardInterrupt, at=i + 1)
            )
            with install_fault_plan(plan):
                with pytest.raises(KeyboardInterrupt):
                    run_worker(
                        root, worker=f"w{i}", settle=0.0,
                        lease_ttl=5.0, clock=clock, max_wall=300,
                    )
            assert plan.fired, site
            clock.advance(6.0)  # the dead worker's lease goes stale
        tally = run_worker(
            root, worker="wfinal", settle=0.0, lease_ttl=5.0,
            clock=clock, max_wall=300,
        )
        assert tally["stitched"], tally
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["clean"], report["issues"]
        res = os.path.join(root, "result")
        ctrl_res = os.path.join(control, "result")
        assert _content_hash(res) == _content_hash(ctrl_res)
        assert _pyramid_tree(res) == _pyramid_tree(ctrl_res)
        assert _detect_state(res) == _detect_state(ctrl_res)

    def test_double_commit_is_idempotent(self, archive, tmp_path):
        """Worker A drains a shard and dies just before its commit;
        worker B reclaims, re-executes, commits.  A's resurrected
        commit must LOSE (commit-wins), discard its staging, and
        leave B's done marker byte-identical."""
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = BackfillQueue(
            root, worker="wa", settle=0.0, lease_ttl=5.0, clock=clock
        )
        lease_a = qa.try_claim("sh00000")
        plan = FaultPlan(
            FaultSpec("backfill.commit", exc=KeyboardInterrupt, at=1)
        )
        with install_fault_plan(plan):
            with pytest.raises(KeyboardInterrupt):
                execute_shard(qa, lease_a, sleep_fn=lambda _s: None)
        staging_a = qa.staging_dir(lease_a)
        assert os.path.isdir(staging_a)  # fully drained, uncommitted
        clock.advance(6.0)
        qb = BackfillQueue(
            root, worker="wb", settle=0.0, lease_ttl=5.0, clock=clock
        )
        lease_b = qb.try_claim("sh00000")
        assert lease_b is not None
        assert execute_shard(
            qb, lease_b, sleep_fn=lambda _s: None
        ) == "committed"
        done_path = os.path.join(root, DONE_DIRNAME, "sh00000.json")
        with open(done_path, "rb") as fh:
            marker_before = fh.read()
        # A comes back from the dead and retries ITS commit
        outcome = qa.commit(lease_a, staging_a)
        assert outcome == "lost"
        assert not os.path.isdir(staging_a)  # discarded, not merged
        with open(done_path, "rb") as fh:
            assert fh.read() == marker_before  # B's commit stands
        assert qb.is_done("sh00000")

    def test_fatal_shard_parks_queue_still_drains(
        self, archive, tmp_path
    ):
        """A fatal failure inside one shard's drain parks THAT shard
        (counted, fsck-able); the worker commits the rest and the
        stitch refuses until an operator clears the park."""
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        plan = FaultPlan(
            FaultSpec("round.body", exc=ValueError("bad shard"), at=1)
        )
        with install_fault_plan(plan):
            tally = run_worker(
                root, worker="w0", settle=0.0, lease_ttl=5.0,
                clock=clock, max_wall=300,
            )
        assert tally["parked"] == 1
        assert tally["committed"] == 1  # the other shard drained
        assert not tally["stitched"]
        assert tally.get("stitch_status") is None
        queue = BackfillQueue(root, worker="chk", clock=clock)
        counts = queue.counts()
        assert counts["parked"] == 1 and counts["done"] == 1
        result = stitch_backfill(root, queue=queue)
        assert result["status"] == "unstitchable"
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["parked"] == ["sh00000"]
        # operator repair: clear the park, re-drain, stitch lands
        os.remove(os.path.join(root, ".parked", "sh00000.json"))
        tally2 = run_worker(
            root, worker="w1", settle=0.0, lease_ttl=5.0,
            clock=clock, max_wall=300,
        )
        assert tally2["committed"] == 1 and tally2["stitched"]

    def test_enospc_inside_shard_sheds_then_commits(
        self, archive, control, tmp_path
    ):
        """A full disk mid-shard (injected at the carry save) rides
        the resource retry ladder — crash-equivalent retry, shed
        writers — and the shard still commits with the stitched bytes
        matching the control."""
        root = str(tmp_path / "q")
        _plan(root, archive, pyramid=True, detect=True,
              detect_operators=DETECT_OPS)
        clock = FakeClock()
        plan = FaultPlan(
            FaultSpec("carry.save", exc=enospc_error(), at=1, times=2)
        )
        with install_fault_plan(plan):
            tally = run_worker(
                root, worker="w0", settle=0.0, lease_ttl=30.0,
                clock=clock, max_wall=300, sleep_fn=lambda _s: None,
            )
        assert plan.fired
        assert tally["stitched"], tally
        assert tally["parked"] == 0
        res = os.path.join(root, "result")
        ctrl_res = os.path.join(control, "result")
        assert _content_hash(res) == _content_hash(ctrl_res)
        assert _pyramid_tree(res) == _pyramid_tree(ctrl_res)

    def test_adoption_finishes_a_crashed_commit(self, archive, tmp_path):
        """The crash window between the commit rename and the done
        marker: the next claimer adopts the committed directory
        instead of re-executing."""
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        run_worker(
            root, worker="w0", settle=0.0, lease_ttl=5.0, clock=clock,
            stitch=False, max_wall=300,
        )
        # simulate the crash window: drop one done marker
        os.remove(os.path.join(root, DONE_DIRNAME, "sh00001.json"))
        queue = BackfillQueue(
            root, worker="w1", settle=0.0, clock=clock
        )
        assert queue.shard_state("sh00001") == "adoptable"
        tally = run_worker(
            root, worker="w1", settle=0.0, lease_ttl=5.0, clock=clock,
            max_wall=300,
        )
        assert tally["adopted"] == 1
        assert queue.is_done("sh00001")


class TestDrainModeHooks:
    def test_time_range_caps_ingest(self, archive, tmp_path):
        """The engine's drain-mode cap: a runner with time_range set
        never emits past the cap (plus the held-back edge)."""
        from tpudas_torch.backfill.runner import shard_spec
        from tpudas_torch.fleet.engine import LowpassStreamRunner, drive

        root = str(tmp_path / "q")
        plan = _plan(root, archive)
        out = str(tmp_path / "out")
        cap_ns = plan["shards"][0]["t1_ns"]
        runner = LowpassStreamRunner(
            shard_spec(plan, plan["shards"][0]), out, device=CPU
        )
        runner.time_range = (None, np.datetime64(int(cap_ns), "ns"))
        drive(runner, sleep_fn=lambda _s: None)
        sp_hash_rows = []
        from tpudas_torch.io.spool import spool as make_spool

        sp = make_spool(out).sort("time").update()
        for p in sp.chunk(time=None):
            ts = (
                np.asarray(p.coords["time"])
                .astype("datetime64[ns]")
                .astype(np.int64)
            )
            sp_hash_rows.append(ts)
        assert sp_hash_rows, "shard drain emitted nothing"
        assert int(np.concatenate(sp_hash_rows).max()) < cap_ns

    def test_ingest_limit_bounds_rounds(self, archive, tmp_path):
        """ingest_limit_sec chunks a static-archive drain into
        multiple rounds instead of one unbounded one, and the
        no-growth terminate still fires at the end."""
        from tpudas_torch.backfill.runner import shard_spec
        from tpudas_torch.fleet.engine import LowpassStreamRunner, drive

        root = str(tmp_path / "q")
        plan = _plan(root, archive)
        out = str(tmp_path / "out")
        runner = LowpassStreamRunner(
            shard_spec(plan, plan["shards"][0]), out, device=CPU
        )
        runner.ingest_limit_sec = 30.0
        drive(runner, sleep_fn=lambda _s: None)
        assert runner.rounds >= 2  # the 60 s shard took >= 2 bites


class TestAuditBackfill:
    def _drained(self, archive, tmp_path, name="q"):
        root = str(tmp_path / name)
        _plan(root, archive)
        clock = FakeClock()
        run_worker(
            root, worker="w0", settle=0.0, lease_ttl=5.0, clock=clock,
            max_wall=300,
        )
        return root, clock

    def test_stale_lease_and_orphan_staging_swept(
        self, archive, tmp_path
    ):
        root, clock = self._drained(archive, tmp_path)
        # fabricate a dead worker's leftovers: a stale lease + staging
        from tpudas_torch.integrity.checksum import write_json_checksummed

        now = int(clock() * 1e9)
        write_json_checksummed(
            os.path.join(root, LEASES_DIRNAME, "sh00001.json"),
            {
                "shard": "sh00001", "worker": "dead", "pid": 1,
                "token": "dead.1.0", "heartbeat_ns": now,
                "deadline_ns": now - 1, "stolen": False,
            },
        )
        orphan = os.path.join(
            root, SHARDS_DIRNAME, "sh00001.work.dead.1.0"
        )
        os.makedirs(orphan)
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["clean"], report["issues"]
        statuses = {
            (i["artifact"], i["status"]) for i in report["issues"]
        }
        assert ("backfill_lease", "stale_lease") in statuses
        assert ("backfill_staging", "orphan") in statuses
        assert not os.path.isdir(orphan)
        # second audit: nothing left
        report2 = audit_backfill(root, repair=True, clock=clock)
        assert report2["clean"] and not report2["issues"]

    def test_live_lease_and_its_staging_left_alone(
        self, archive, tmp_path
    ):
        root, clock = self._drained(archive, tmp_path)
        from tpudas_torch.integrity.checksum import write_json_checksummed

        os.remove(os.path.join(root, DONE_DIRNAME, "sh00001.json"))
        import shutil

        shutil.rmtree(os.path.join(root, SHARDS_DIRNAME, "sh00001"))
        now = int(clock() * 1e9)
        write_json_checksummed(
            os.path.join(root, LEASES_DIRNAME, "sh00001.json"),
            {
                "shard": "sh00001", "worker": "alive", "pid": 1,
                "token": "alive.1.0", "heartbeat_ns": now,
                "deadline_ns": now + 60_000_000_000, "stolen": False,
            },
        )
        live = os.path.join(
            root, SHARDS_DIRNAME, "sh00001.work.alive.1.0"
        )
        os.makedirs(live)
        report = audit_backfill(root, repair=True, clock=clock)
        assert os.path.isdir(live)  # a live claim's staging survives
        paths = {i["path"] for i in report["issues"]}
        assert live not in paths

    def test_commit_crash_window_adopted(self, archive, tmp_path):
        root, clock = self._drained(archive, tmp_path)
        os.remove(os.path.join(root, DONE_DIRNAME, "sh00000.json"))
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["clean"], report["issues"]
        actions = {i["action"] for i in report["issues"]}
        assert "adopted_commit" in actions
        queue = BackfillQueue(root, worker="chk", clock=clock)
        assert queue.is_done("sh00000")

    def test_torn_done_marker_removed_then_adopted(
        self, archive, tmp_path
    ):
        root, clock = self._drained(archive, tmp_path)
        path = os.path.join(root, DONE_DIRNAME, "sh00000.json")
        with open(path, "r+") as fh:
            fh.seek(0)
            fh.write('{"shard": "XX"')  # torn mid-write
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["clean"], report["issues"]
        queue = BackfillQueue(root, worker="chk", clock=clock)
        assert queue.is_done("sh00000")  # re-adopted from the bytes

    def test_half_stitched_result_removed(self, archive, tmp_path):
        root, clock = self._drained(archive, tmp_path)
        clock2 = clock
        stitch_backfill(
            root,
            queue=BackfillQueue(
                root, worker="st", settle=0.0, clock=clock2
            ),
        )
        # the crash window between the result rename and its marker
        os.remove(os.path.join(root, RESULT_DONE_FILENAME))
        report = audit_backfill(root, repair=True, clock=clock)
        assert report["clean"], report["issues"]
        assert not os.path.isdir(os.path.join(root, "result"))
        # a re-stitch rebuilds it deterministically
        result = stitch_backfill(
            root,
            queue=BackfillQueue(
                root, worker="st2", settle=0.0, clock=clock2
            ),
        )
        assert result["status"] == "committed"

    def test_unreadable_plan_is_not_clean(self, tmp_path):
        root = str(tmp_path / "q")
        os.makedirs(root)
        with open(os.path.join(root, "backfill.json"), "w") as fh:
            fh.write("{")
        report = audit_backfill(root, repair=True)
        assert not report["clean"]
        assert "unreadable backfill plan" in report["error"]


class TestCommitWindowRegression:
    """The stitch crash window must be
    adoptable, and a live lease over a committed directory must not
    be clobbered by a concurrent adopter."""

    def test_marker_less_result_adopted_not_lost(
        self, archive, tmp_path
    ):
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        run_worker(
            root, worker="w0", settle=0.0, lease_ttl=5.0, clock=clock,
            max_wall=300,
        )
        # the crash window: rename landed, marker write never did
        os.remove(os.path.join(root, RESULT_DONE_FILENAME))
        result = stitch_backfill(
            root,
            queue=BackfillQueue(
                root, worker="st", settle=0.0, clock=clock
            ),
        )
        assert result["status"] == "committed"
        assert result.get("adopted") is True
        assert os.path.isfile(os.path.join(root, RESULT_DONE_FILENAME))
        # and the queue reads as fully stitched from here on
        again = stitch_backfill(
            root,
            queue=BackfillQueue(
                root, worker="st2", settle=0.0, clock=clock
            ),
        )
        assert again["status"] == "already"

    def test_live_lease_protects_commit_window(self, archive, tmp_path):
        """A committed directory whose lease is still LIVE is a worker
        inside its commit (between rename and marker): it must read
        as leased, never adoptable."""
        root = str(tmp_path / "q")
        _plan(root, archive)
        clock = FakeClock()
        qa = BackfillQueue(
            root, worker="wa", settle=0.0, lease_ttl=30.0, clock=clock
        )
        lease = qa.try_claim("sh00000")
        assert lease is not None
        os.makedirs(qa.shard_dir("sh00000"))
        qb = BackfillQueue(
            root, worker="wb", settle=0.0, lease_ttl=30.0, clock=clock
        )
        assert qb.shard_state("sh00000") == "leased"
        assert qb.try_claim("sh00000") is None
        # once the lease expires the window is adoptable
        clock.advance(31.0)
        assert qb.shard_state("sh00000") == "adoptable"


class TestBackfillDrill:
    """The chaos drill of ``tests/test_integrity.py::TestBackfillDrill``
    (worker subprocesses, seeded SIGKILLs, injected claim/commit
    faults), against the port on the CPU, with the JAX package's
    ``slow`` marks."""

    @pytest.mark.slow
    def test_smoke_two_workers_two_kills(self, tmp_path):
        from tpudas_torch.tools.backfill_drill import run_backfill_drill

        rep = run_backfill_drill(workers=2, kills=2, shards=4, seed=3,
                                 workdir=str(tmp_path / "drill"),
                                 device=CPU, max_wall=600.0)
        assert rep["kills"] >= 1, rep
        assert rep["audit_clean"], rep
        assert rep["parked"] == [], rep
        for key in (
            "outputs_match_control",
            "pyramid_match_control",
            "detect_match_control",
            "outputs_match_sequential",
            "pyramid_match_sequential",
            "detect_match_sequential",
        ):
            assert rep[key], (key, rep)
        assert rep["ok"], rep

    @pytest.mark.slow
    def test_full_backfill_drill(self, tmp_path):
        from tpudas_torch.tools.backfill_drill import run_backfill_drill

        rep = run_backfill_drill(workers=4, kills=6, shards=8, seed=0,
                                 workdir=str(tmp_path / "drill"),
                                 device=CPU, max_wall=1200.0)
        assert rep["kills"] >= 6, rep
        assert rep["ok"], rep


def test_worker_subprocess_drains_and_reports(archive, control, tmp_path):
    """One drill worker interpreter (the path the card's workers take):
    it warms up, marks READY, drains the whole queue, stitches, and
    writes its report; the result equals the in-process control.  Its
    own time limit: the process is killed if it outlives it."""
    from tpudas_torch.tools import backfill_drill as drill

    root = str(tmp_path / "q")
    _plan(root, archive, pyramid=True, detect=True,
          detect_operators=DETECT_OPS)
    proc = drill._spawn(root, "solo", device=CPU)
    try:
        assert proc.wait(timeout=240) == 0
    finally:
        drill.stop_all({"solo": proc})
    ready_dir = os.path.join(root, drill.WORKERS_DIRNAME)
    assert drill.is_ready(ready_dir, "solo")
    rep = drill.worker_reports(ready_dir)["solo"]
    assert rep["device"] == CPU and rep["start_s"] > 0
    assert rep["tally"]["committed"] == 2 and rep["tally"]["stitched"]
    res = os.path.join(root, "result")
    ctrl_res = os.path.join(control, "result")
    assert _content_hash(res) == _content_hash(ctrl_res)
    assert _pyramid_tree(res) == _pyramid_tree(ctrl_res)
    assert _detect_state(res) == _detect_state(ctrl_res)


# ---------------------------------------------------------------------------
# within the port: the chunk-invariant engines


# the stream engine each case runs on the CPU: ``auto`` is the plain
# per-stage chain ("torch"); ``fused`` with no size threshold is the
# plain fused step ("fused-torch")
ENGINE_CASES = {"torch": ("auto", None), "fused-torch": ("fused", "0")}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_stitched_equals_control_equals_sequential(archive, tmp_path,
                                                   monkeypatch, case):
    """The CPU side of the chunk-invariance question: a shard opens its
    stream cold at ``t0 - head_lead`` and drains in bounded rounds, so
    its blocks split the stream elsewhere than the sequential run's.
    Under the plain per-stage chain and the plain fused step the
    stitched result (a worker killed at its first commit, another
    finishing) is byte-identical to the 1-worker control and to the
    sequential run: outputs, pyramid and detect state."""
    from tpudas_torch.ops.fir import resolve_stream_engine
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    engine, min_elems = ENGINE_CASES[case]
    if min_elems is not None:
        monkeypatch.setenv("TPUDAS_FUSED_MIN_ELEMS", min_elems)
    assert resolve_stream_engine(engine, plan=True, T=1, n_ch=1,
                                 device=CPU) == case
    kw = dict(pyramid=True, detect=True, detect_operators=DETECT_OPS,
              engine=engine)
    ctrl, root = str(tmp_path / "ctrl"), str(tmp_path / "q")
    _plan(ctrl, archive, **kw)
    _plan(root, archive, **kw)
    assert run_worker(ctrl, worker="c", settle=0.0, max_wall=300)["stitched"]
    clock = FakeClock()
    plan = FaultPlan(FaultSpec("backfill.commit", exc=KeyboardInterrupt,
                               at=1))
    with install_fault_plan(plan):
        with pytest.raises(KeyboardInterrupt):
            run_worker(root, worker="w0", settle=0.0, lease_ttl=5.0,
                       clock=clock, max_wall=300)
    clock.advance(6.0)
    tally = run_worker(root, worker="w1", settle=0.0, lease_ttl=5.0,
                       clock=clock, max_wall=300)
    assert tally["stitched"] and tally["committed"] == 2, tally
    seq = str(tmp_path / "seq")
    run_lowpass_realtime(
        source=archive, output_folder=seq, start_time=T0,
        output_sample_interval=DT, edge_buffer=EDGE,
        process_patch_size=20, poll_interval=0.0,
        sleep_fn=lambda _s: None, pyramid=True, detect=True,
        detect_operators=DETECT_OPS, engine=engine, device=CPU,
    )
    res, ctrl_res = (os.path.join(r, "result") for r in (root, ctrl))
    for other in (ctrl_res, seq):
        assert _content_hash(res) == _content_hash(other), other
        assert _pyramid_tree(res) == _pyramid_tree(other), other
        assert _detect_state(res) == _detect_state(other), other


# ---------------------------------------------------------------------------
# the drain clamps, held to the JAX runner


def _step_sequence(runner, limit=40):
    """(status, rounds, _more_to_drain) after every step until the
    runner terminates."""
    seq = []
    for _ in range(limit):
        res = runner.step()
        seq.append((res.status, runner.rounds, runner._more_to_drain))
        if res.status == "terminate":
            runner.finish()
            return seq
    raise AssertionError(f"no terminate in {limit} steps: {seq}")


CLAMPS = {
    "limit30": dict(ingest_limit_sec=30.0, cap=None),
    "limit20-cap": dict(ingest_limit_sec=20.0, cap="t1"),
    "cap-only": dict(ingest_limit_sec=None, cap="t1"),
    "limit-whole": dict(ingest_limit_sec=1000.0, cap=None),
}


@pytest.mark.parametrize("clamp", sorted(CLAMPS))
def test_drain_clamps_match_jax_sequence(archive, tmp_path, clamp):
    """The port's ``time_range`` / ``ingest_limit_sec`` runner steps
    through the JAX runner's sequence of statuses, round counts and
    ``_more_to_drain`` flags (a bounded round keeps draining, the first
    no-growth poll after the last bounded round terminates, as at
    ``tpudas/fleet/engine.py:733``), and emits the same time grid."""
    import jax  # noqa: F401  (conftest pins JAX to the CPU)

    from tpudas.backfill.runner import shard_spec as jshard_spec
    from tpudas.fleet.engine import LowpassStreamRunner as JRunner
    from tpudas_torch.backfill.runner import shard_spec
    from tpudas_torch.fleet.engine import LowpassStreamRunner

    c = CLAMPS[clamp]
    plan = _plan(str(tmp_path / "q"), archive)
    shard = plan["shards"][0]
    runners = {
        "jax": JRunner(jshard_spec(plan, shard), str(tmp_path / "j")),
        "port": LowpassStreamRunner(shard_spec(plan, shard),
                                    str(tmp_path / "t"), device=CPU),
    }
    seqs = {}
    for name, runner in runners.items():
        if c["cap"]:
            runner.time_range = (
                None, np.datetime64(int(shard["t1_ns"]), "ns"))
        runner.ingest_limit_sec = c["ingest_limit_sec"]
        seqs[name] = _step_sequence(runner)
    assert seqs["port"] == seqs["jax"]
    if c["ingest_limit_sec"] is not None and c["ingest_limit_sec"] < 60:
        assert any(more for _s, _r, more in seqs["port"])
        assert seqs["port"][-1][0] == "terminate"

    def grid(folder):
        from tpudas_torch.io.spool import spool as make_spool

        sp = make_spool(folder).sort("time").update()
        return np.concatenate([
            np.asarray(p.coords["time"]).astype("datetime64[ns]")
            for p in sp.chunk(time=None)])

    np.testing.assert_array_equal(grid(str(tmp_path / "t")),
                                  grid(str(tmp_path / "j")))


# ---------------------------------------------------------------------------
# across the packages


PLAN_CASES = {
    "minimal": dict(),
    "full": dict(pyramid=True, detect=True, detect_operators=DETECT_OPS),
    "fused-50s": dict(engine="fused", shard_seconds=50.0,
                      ingest_limit_sec=None),
    "leads": dict(lead_seconds=7.0, tail_seconds=9.0, filter_order=4),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_json_byte_equal_across_packages(archive, tmp_path, case):
    """Both packages' ``plan_backfill`` over the same archive write the
    same ``backfill.json`` bytes: the leads come from the design math
    (bit-equal), and no field of the plan holds a wall time, a host or
    a device."""
    import jax  # noqa: F401

    from tpudas.backfill import plan_backfill as jax_plan

    kw = dict(shard_seconds=SHARD_SEC, output_sample_interval=DT,
              edge_buffer=EDGE, process_patch_size=20, pyramid=False,
              detect=False, ingest_limit_sec=35.0)
    kw.update(PLAN_CASES[case])
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    plan_backfill(t, archive, T0, _t_end(), **kw)
    jax_plan(j, archive, T0, _t_end(), **kw)
    with open(os.path.join(t, "backfill.json"), "rb") as a, \
            open(os.path.join(j, "backfill.json"), "rb") as b:
        assert a.read() == b.read()
    plan = load_plan(t)
    assert sorted(plan) == sorted([
        "version", "source", "t0_ns", "t1_ns", "shard_seconds",
        "lead_seconds", "tail_seconds", "ingest_limit_sec", "config",
        "shards"])


def _merged(folder):
    """(times ns, float32 rows) of the merged output content."""
    from tpudas_torch.io.spool import spool as make_spool

    ts, rows = [], []
    for p in make_spool(folder).sort("time").update().chunk(time=None):
        d = p.host_data()
        if p.axis_of("time") != 0:
            d = np.moveaxis(d, p.axis_of("time"), 0)
        ts.append(np.asarray(p.coords["time"]).astype("datetime64[ns]"))
        rows.append(np.asarray(d, np.float32))
    return np.concatenate(ts), np.concatenate(rows)


def _within_1e5_per_channel(a_dir, b_dir):
    ta, da = _merged(a_dir)
    tb, db = _merged(b_dir)
    np.testing.assert_array_equal(ta, tb)
    scale = np.maximum(np.nanmax(np.abs(db), axis=0), 1e-30)
    err = np.nanmax(np.abs(da - db), axis=0) / scale
    assert np.all(err <= 1e-5), err
    np.testing.assert_array_equal(np.isnan(da), np.isnan(db))


@pytest.fixture(scope="module")
def jax_control(archive, tmp_path_factory):
    """The JAX package's own 1-worker stitched result over the same
    full-feature plan as :func:`control`."""
    import jax  # noqa: F401

    from tpudas.backfill import plan_backfill as jax_plan
    from tpudas.backfill import run_worker as jax_worker

    root = str(tmp_path_factory.mktemp("bf_jctrl") / "root")
    jax_plan(root, archive, T0, _t_end(), shard_seconds=SHARD_SEC,
             output_sample_interval=DT, edge_buffer=EDGE,
             process_patch_size=20, pyramid=True, detect=True,
             detect_operators=DETECT_OPS, ingest_limit_sec=35.0)
    assert jax_worker(root, worker="jctrl", settle=0.0,
                      max_wall=300)["stitched"]
    return root


@pytest.mark.parametrize("direction", ["jax-then-port", "port-then-jax"])
def test_queue_drains_across_packages(archive, control, jax_control,
                                      tmp_path, direction):
    """A queue planned and half-drained by one package is finished and
    stitched by the other: the plan, the first package's lease and done
    marker and its committed shard read both ways, and the stitched
    outputs are within 1e-5 per channel of each package's own stitched
    result (the cascade sums in another order across frameworks)."""
    import tpudas.backfill as jbf
    from tpudas.backfill import run_worker as jax_worker

    root = str(tmp_path / "q")
    planner = plan_backfill if direction == "port-then-jax" else (
        jbf.plan_backfill)
    planner(root, archive, T0, _t_end(), shard_seconds=SHARD_SEC,
            output_sample_interval=DT, edge_buffer=EDGE,
            process_patch_size=20, pyramid=True, detect=True,
            detect_operators=DETECT_OPS, ingest_limit_sec=35.0)
    clock = FakeClock()
    first, second = (
        (jax_worker, run_worker) if direction == "jax-then-port"
        else (run_worker, jax_worker))
    # after the first package: one shard done, the second's lease held
    # by the dead worker — read identically by both packages
    import tpudas.resilience.faults as jfaults
    import tpudas_torch.resilience.faults as tfaults

    faults = tfaults if first is run_worker else jfaults
    plan = faults.FaultPlan(faults.FaultSpec(
        "backfill.claim", exc=KeyboardInterrupt, at=2))
    with faults.install_fault_plan(plan):
        with pytest.raises(KeyboardInterrupt):
            first(root, worker="first", settle=0.0, lease_ttl=5.0,
                  clock=clock, max_wall=300)
    qt = BackfillQueue(root, worker="chk", settle=0.0, clock=clock)
    qj = jbf.BackfillQueue(root, worker="chk", settle=0.0, clock=clock)
    assert qt.plan == qj.plan
    assert qt.counts() == qj.counts()
    for sh in qt.plan["shards"]:
        sid = sh["id"]
        assert qt.shard_state(sid) == qj.shard_state(sid)
        assert qt.read_lease(sid) == qj.read_lease(sid)
    assert qt.is_done("sh00000") and qj.is_done("sh00000")
    clock.advance(6.0)
    tally = second(root, worker="second", settle=0.0, lease_ttl=5.0,
                   clock=clock, max_wall=300)
    assert tally["committed"] == 1 and tally["stitched"], tally
    assert qt.counts() == qj.counts() == {
        "done": 2, "parked": 0, "adoptable": 0, "leased": 0, "stale": 0,
        "open": 0}
    res = os.path.join(root, "result")
    _within_1e5_per_channel(res, os.path.join(control, "result"))
    _within_1e5_per_channel(res, os.path.join(jax_control, "result"))
    # both packages' audits find the mixed queue clean
    from tpudas.integrity.audit import audit_backfill as jax_audit

    assert audit_backfill(root, repair=False, clock=clock)["clean"]
    assert jax_audit(root, repair=False, clock=clock)["clean"]


def _damage_matrix(root, clock):
    """The same damage, applied to a drained and stitched queue: a
    dead worker's stale lease and orphan staging, a commit whose done
    marker was lost, a torn done marker, a half-stitched result (marker
    gone) and a parked shard record."""
    from tpudas_torch.integrity.checksum import write_json_checksummed

    now = int(clock() * 1e9)
    write_json_checksummed(
        os.path.join(root, LEASES_DIRNAME, "sh00001.json"),
        {"shard": "sh00001", "worker": "dead", "pid": 1,
         "token": "dead.1.0", "heartbeat_ns": now, "deadline_ns": now - 1,
         "stolen": False},
    )
    os.makedirs(os.path.join(root, SHARDS_DIRNAME, "sh00001.work.dead.1.0"))
    os.remove(os.path.join(root, DONE_DIRNAME, "sh00000.json"))
    with open(os.path.join(root, DONE_DIRNAME, "sh00001.json"), "r+") as fh:
        fh.write('{"shard": "XX"')
    os.remove(os.path.join(root, RESULT_DONE_FILENAME))
    write_json_checksummed(
        os.path.join(root, ".parked", "sh00009.json"),
        {"shard": "sh00009", "kind": "fatal", "error": "x"},
    )


def _rel_report(rep, root):
    out = dict(rep)
    out.pop("elapsed_s", None)
    out["root"] = os.path.relpath(out["root"], root) if "root" in out else None
    out["issues"] = sorted(
        (i["artifact"], os.path.relpath(i["path"], root), i["status"],
         i["action"]) for i in rep["issues"])
    out.pop("shards", None)
    return out


def _tree(root):
    return sorted(
        os.path.relpath(os.path.join(d, n), root)
        for d, _dirs, names in os.walk(root) for n in names
        if ".tpudas_index" not in n)


@pytest.mark.parametrize("repair", [True, False])
def test_audit_backfill_equal_across_packages(archive, tmp_path, repair):
    """The same damage matrix over two copies of one drained queue: the
    port's ``audit_backfill`` and the JAX package's report the same
    issues, statuses and actions, leave the same files, and a second
    audit by the other package finds nothing more."""
    import jax  # noqa: F401

    from tpudas.integrity.audit import audit_backfill as jax_audit

    base = str(tmp_path / "base")
    _plan(base, archive)
    clock = FakeClock()
    assert run_worker(base, worker="w0", settle=0.0, lease_ttl=5.0,
                      clock=clock, max_wall=300)["stitched"]
    roots = {}
    for name in ("port", "jax"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(base, roots[name])
        _damage_matrix(roots[name], clock)
    rep_t = audit_backfill(roots["port"], repair=repair, clock=clock)
    rep_j = jax_audit(roots["jax"], repair=repair, clock=clock)
    assert rep_t["issues"], rep_t
    assert _rel_report(rep_t, roots["port"]) == _rel_report(
        rep_j, roots["jax"])
    assert _tree(roots["port"]) == _tree(roots["jax"])
    if repair:
        assert jax_audit(roots["port"], repair=True, clock=clock)["clean"]
        assert audit_backfill(roots["jax"], repair=True, clock=clock)[
            "clean"]


def test_worker_runs_on_the_card_unless_asked(archive, tmp_path,
                                              monkeypatch):
    """The port's workers default to the CUDA card: without one, a
    worker raises before it claims a shard (no lease is written), and
    the plan never names a device."""
    import torch

    from tpudas_torch.backfill.objqueue import run_store_worker
    from tpudas_torch.store import FakeObjectStore
    from tpudas_torch.tools.backfill_drill import _plan_store

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "q")
    _plan(root, archive)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_worker(root, worker="w0", settle=0.0, max_wall=30)
    assert os.listdir(os.path.join(root, LEASES_DIRNAME)) == []
    store = FakeObjectStore()
    _plan_store(store, "job", archive, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_store_worker(store, "job", scratch=str(tmp_path / "s"),
                         worker="w0", max_wall=30)
    assert store.list("job/leases") == []
    with open(os.path.join(root, "backfill.json")) as fh:
        assert "device" not in fh.read()
