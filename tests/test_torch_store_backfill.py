"""The port's object-store backfill (tpudas_torch.backfill.objqueue).

Every case of ``tests/test_store_backfill.py``, against the port on the
CPU (``device="cpu"``): backfill with NO shared filesystem.

The object-store queue's exactly-once machinery under the race
matrix: create-only plan, CAS lease claim/steal/renew, the three-step
upload-then-mark commit (double-commit race, lost conditional put on
the done marker, crashed-commit adoption, mid-upload re-execution),
torn uploads classified and aborted by the store fsck
(``audit_backfill_store`` + the port's ``fsck --store``), and the
acceptance leg: two workers sharing nothing but a fake object store
drain + stitch a job byte-identical to a plain sequential realtime
run.
"""

import functools
import json
import os
import sys
import threading

import numpy as np
import pytest

from tpudas_torch.backfill.objqueue import (
    DONE_PREFIX,
    LEASES_PREFIX,
    RESULT_DONE_KEY,
    RESULT_PREFIX,
    StoreBackfillQueue,
    load_plan_store,
    plan_backfill_store,
)
from tpudas_torch.backfill.objqueue import run_store_worker as _run_store_worker
from tpudas_torch.backfill.objqueue import (
    stitch_store_backfill as _stitch_store_backfill,
)
from tpudas_torch.backfill.queue import LeaseLostError
from tpudas_torch.integrity.audit import audit_backfill_store
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.store import (
    FakeObjectStore,
    FaultInjector,
    FaultRule,
    RetryingStore,
    StoreNetworkError,
    store_from_url,
)
from tpudas_torch.testing import make_synthetic_spool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpudas_torch.tools.crash_drill import _content_hash  # noqa: E402

# the port's entry points default to the card; these tests run the
# plain versions on the CPU
run_store_worker = functools.partial(_run_store_worker, device="cpu")
stitch_store_backfill = functools.partial(
    _stitch_store_backfill, device="cpu"
)

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
N_CH = 4
DT = 1.0
EDGE = 5.0
N_FILES = 6  # 120 s archive
SHARD_SEC = 60.0


def _t_end():
    return np.datetime64(T0) + np.timedelta64(
        int(N_FILES * FILE_SEC * 1e9), "ns"
    )


def _plan(store, prefix, src, **overrides):
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
    return plan_backfill_store(store, prefix, src, T0, _t_end(), **kwargs)


class FakeClock:
    def __init__(self, t=1_000_000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, sec):
        self.t += float(sec)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("sbf_archive") / "src")
    make_synthetic_spool(
        src, n_files=N_FILES, file_duration=FILE_SEC, fs=FS,
        n_ch=N_CH, noise=0.01, start=np.datetime64(T0),
    )
    return src


@pytest.fixture(scope="module")
def sequential_ref(archive, tmp_path_factory):
    """The oracle: one uninterrupted realtime run over the archive."""
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    out = str(tmp_path_factory.mktemp("sbf_seq") / "out")
    run_lowpass_realtime(
        source=archive, output_folder=out, start_time=T0,
        output_sample_interval=DT, edge_buffer=EDGE,
        process_patch_size=20, poll_interval=0.0,
        sleep_fn=lambda _s: None, pyramid=False, device="cpu",
    )
    return out


def _queue(store, prefix, tmp_path, worker, **kw):
    return StoreBackfillQueue(
        store, prefix, scratch=str(tmp_path / f"scratch-{worker}"),
        worker=worker, **kw,
    )


def _fabricate_staging(tmp_path, name):
    """A tiny deterministic staging directory standing in for a
    drained shard (the commit protocol never looks inside the
    bytes)."""
    staging = tmp_path / name
    staging.mkdir(parents=True)
    (staging / "rows.npy").write_bytes(b"rows-bytes-v1")
    sub = staging / "sub"
    sub.mkdir()
    (sub / "extra.bin").write_bytes(b"extra-bytes-v1")
    return str(staging)


class TestPlan:
    def test_plan_is_create_only(self, archive, tmp_path):
        store = FakeObjectStore()
        plan = _plan(store, "job", archive)
        assert len(plan["shards"]) == 2
        with pytest.raises(FileExistsError):
            _plan(store, "job", archive)
        loaded = load_plan_store(store, "job")
        assert loaded["shards"] == plan["shards"]

    def test_torn_plan_refused(self, archive, tmp_path):
        from tpudas_torch.backfill.objqueue import _dumps

        store = FakeObjectStore()
        _plan(store, "job", archive)
        # flip payload bytes under the stamp: the crc gate refuses
        data, _tok = store.get("job/backfill.json")
        torn = data.replace(b'"shard_seconds"', b'"shard_SECONDS"')
        assert torn != data
        store.put("job/backfill.json", torn)
        with pytest.raises(ValueError, match="crc32"):
            load_plan_store(store, "job")
        # an unstamped alien object is refused on version instead
        store.put("job2/backfill.json", _dumps({"version": -9}))
        with pytest.raises(ValueError, match="version"):
            load_plan_store(store, "job2")


class TestLeaseProtocol:
    def test_claim_is_exclusive(self, archive, tmp_path):
        store = FakeObjectStore()
        _plan(store, "job", archive)
        q1 = _queue(store, "job", tmp_path, "w1")
        q2 = _queue(store, "job", tmp_path, "w2")
        lease = q1.claim_next()
        assert lease is not None
        assert q2.try_claim(lease.shard) is None
        assert q2.shard_state(lease.shard) == "leased"

    def test_stale_lease_stolen_by_cas_and_renew_loses(
        self, archive, tmp_path
    ):
        store = FakeObjectStore()
        _plan(store, "job", archive)
        clock = FakeClock()
        q1 = _queue(store, "job", tmp_path, "w1",
                    lease_ttl=10.0, clock=clock)
        q2 = _queue(store, "job", tmp_path, "w2",
                    lease_ttl=10.0, clock=clock)
        lease1 = q1.claim_next()
        clock.advance(30.0)  # w1 wedged past its deadline
        assert q2.shard_state(lease1.shard) == "stale"
        lease2 = q2.try_claim(lease1.shard)
        assert lease2 is not None
        # the steal was an atomic CAS: w1's renew loses definitively
        with pytest.raises(LeaseLostError):
            q1.renew(lease1)
        q2.renew(lease2)  # the thief's lease renews fine

    def test_torn_lease_protects_nothing(self, archive, tmp_path):
        store = FakeObjectStore()
        _plan(store, "job", archive)
        q = _queue(store, "job", tmp_path, "w1")
        shard = q.plan["shards"][0]["id"]
        store.put(
            f"job/{LEASES_PREFIX}/{shard}.json", b"{garbage torn"
        )
        assert q.claim_next() is not None  # claimed straight over it


class TestCommitRaces:
    def test_double_commit_race_exactly_once(self, archive, tmp_path):
        """Two workers hold (stale-stolen) leases on the same shard
        and both run the full commit protocol; exactly one create-only
        marker put wins."""
        store = FakeObjectStore()
        _plan(store, "job", archive)
        clock = FakeClock()
        q1 = _queue(store, "job", tmp_path, "w1",
                    lease_ttl=10.0, clock=clock)
        q2 = _queue(store, "job", tmp_path, "w2",
                    lease_ttl=10.0, clock=clock)
        lease1 = q1.claim_next()
        clock.advance(30.0)
        lease2 = q2.try_claim(lease1.shard)
        s1 = _fabricate_staging(tmp_path, "stage1")
        s2 = _fabricate_staging(tmp_path, "stage2")
        assert q2.commit(lease2, s2) == "committed"
        assert q1.commit(lease1, s1) == "lost"
        # the winner's marker stands; the shard is done exactly once
        marker = q1._get_verified(q1._done_key(lease1.shard))[0]
        assert marker["worker"] == "w2"
        assert q1.shard_state(lease1.shard) == "done"
        assert q1.manifest_verifies(lease1.shard)

    def test_lost_done_marker_cas_recovered(self, archive, tmp_path):
        """Race-matrix leg: the done marker's conditional put applies
        but the response drops.  The retry layer's token re-read must
        recognize its OWN marker — commit reports committed, not
        lost."""
        raw = FakeObjectStore(FaultInjector(
            FaultRule(kind="lost", op="cas", match=f"{DONE_PREFIX}/"),
        ))
        store = RetryingStore(raw, sleep_fn=lambda _s: None)
        _plan(store, "job", archive)
        q = _queue(store, "job", tmp_path, "w1")
        lease = q.claim_next()
        staging = _fabricate_staging(tmp_path, "stage")
        with use_registry(MetricsRegistry()) as reg:
            assert q.commit(lease, staging) == "committed"
            assert reg.counter(
                "tpudas_store_cas_recovered_total", "",
                labelnames=("backend",),
            ).value(backend="fake") == 1
        assert q.is_done(lease.shard)

    def test_crashed_commit_adopted(self, archive, tmp_path):
        """Uploads + manifest landed, the marker didn't (crash inside
        the commit window): the next claimer adopts instead of
        re-draining."""
        store = FakeObjectStore()
        _plan(store, "job", archive)
        q1 = _queue(store, "job", tmp_path, "w1")
        lease = q1.claim_next()
        q1._upload_staging(
            lease.shard, _fabricate_staging(tmp_path, "stage")
        )
        q1.release(lease)  # worker dies before _write_done

        q2 = _queue(store, "job", tmp_path, "w2")
        assert q2.shard_state(lease.shard) == "adoptable"
        lease2 = q2.try_claim(lease.shard)
        assert q2.manifest_verifies(lease2.shard)
        assert q2.adopt(lease2) == "committed"
        marker = q2._get_verified(q2._done_key(lease2.shard))[0]
        assert marker["adopted"] is True

    def test_mid_upload_crash_reexecutes(self, archive, tmp_path):
        """A manifest that does NOT verify (crash mid-step-1/2, or a
        corrupt object) re-executes: adopt refuses and clears the
        manifest so the re-run commits cleanly over the debris."""
        store = FakeObjectStore()
        _plan(store, "job", archive)
        q = _queue(store, "job", tmp_path, "w1")
        lease = q.claim_next()
        q._upload_staging(
            lease.shard, _fabricate_staging(tmp_path, "stage")
        )
        # one object's bytes rot under the manifest's token
        store.put(
            f"{q.shard_prefix(lease.shard)}/rows.npy", b"corrupted"
        )
        assert not q.manifest_verifies(lease.shard)
        assert q.adopt(lease) == "failed"
        assert q.shard_manifest(lease.shard) is None
        assert q.shard_state(lease.shard) == "open"


class TestStoreFsck:
    def test_torn_upload_classified_and_aborted(
        self, archive, tmp_path
    ):
        tag = "fsck-torn"
        raw = store_from_url(f"fake:{tag}", retry=False)
        _plan(raw, "job", archive)
        q = _queue(raw, "job", tmp_path, "w1")
        lease = q.claim_next()
        raw.injector.add(FaultRule(
            kind="torn", op="put", match="rows.npy",
        ))
        with pytest.raises(StoreNetworkError):
            q._upload_staging(
                lease.shard, _fabricate_staging(tmp_path, "stage")
            )
        q.release(lease)
        assert raw.list_uploads("job") != []

        from tpudas_torch.tools.fsck import main as fsck_main

        out = tmp_path / "report.json"
        rc = fsck_main([
            "job", "--store", f"fake:{tag}", "--out", str(out),
        ])
        assert rc == 0
        report = json.loads(out.read_text())
        assert report["clean"]
        assert any(
            i["artifact"] == "store_upload" and i["status"] == "torn"
            and i["action"] == "aborted"
            for i in report["issues"]
        )
        assert raw.list_uploads("job") == []

    def test_audit_classifies_and_repairs_the_matrix(
        self, archive, tmp_path
    ):
        """Fabricated debris across the classification matrix: torn
        done marker, stale lease, done-without-manifest, orphan
        object, torn result marker — one repair pass leaves the job
        clean and re-runnable."""
        store = FakeObjectStore()
        _plan(store, "job", archive)
        clock = FakeClock()
        q = _queue(store, "job", tmp_path, "w1",
                   lease_ttl=10.0, clock=clock)
        s_a, s_b = (sh["id"] for sh in q.plan["shards"])
        # shard A: committed, then its done marker torn + an orphan
        lease = q.try_claim(s_a)
        q.commit(lease, _fabricate_staging(tmp_path, "stage"))
        store.put(f"job/{DONE_PREFIX}/{s_a}.json", b"{torn")
        store.put(f"{q.shard_prefix(s_a)}/stray.bin", b"stray")
        # shard B: a lease whose worker died long ago
        q.try_claim(s_b)
        clock.advance(1e6)
        # result: a torn stitch marker
        store.put(f"job/{RESULT_DONE_KEY}", b"{also torn")

        report = audit_backfill_store(
            store, "job", repair=True, clock=clock,
        )
        assert report["clean"]
        seen = {
            (i["artifact"], i["status"], i["action"])
            for i in report["issues"]
        }
        assert ("backfill_done", "torn", "removed") in seen
        assert (
            "backfill_commit", "torn", "adopted_commit"
        ) in seen  # the torn marker's verifying manifest re-adopted
        assert ("backfill_lease", "stale_lease", "removed") in seen
        assert ("store_object", "orphan", "removed") in seen
        assert ("backfill_result", "torn", "removed") in seen
        # shard A's verifying manifest was re-adopted, not re-executed
        assert q.shard_state(s_a) == "done"
        # second pass: nothing left to say
        again = audit_backfill_store(
            store, "job", repair=True, clock=clock,
        )
        assert again["clean"] and again["issues"] == []


class TestEndToEnd:
    def test_two_workers_no_shared_fs_byte_identical(
        self, archive, sequential_ref, tmp_path
    ):
        """The acceptance leg: two workers coordinate ONLY through
        the object store (private scratch dirs each), and the stitched
        result is byte-identical to the sequential oracle."""
        store = store_from_url("fake:e2e-two-workers")
        _plan(store, "job", archive)
        results = {}

        def _run(name):
            results[name] = run_store_worker(
                store, "job",
                scratch=str(tmp_path / f"scratch-{name}"),
                worker=name, max_wall=120, idle_poll=0.01,
                sleep_fn=lambda _s: None,
            )

        threads = [
            threading.Thread(target=_run, args=(f"w{i}",), daemon=True)
            for i in (1, 2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        # a time limit of its own: a wedged worker fails the test
        assert not any(t.is_alive() for t in threads)
        done = sum(
            r["committed"] + r["adopted"] for r in results.values()
        )
        assert done == 2  # every shard exactly once across the fleet
        assert any(r["stitched"] for r in results.values())

        # materialize the stitched result and compare content hashes
        q = _queue(store, "job", tmp_path, "reader")
        dest = str(tmp_path / "result")
        os.makedirs(dest)
        manifest = q._get_verified("job/result.json")[0]
        for rel, _tok in manifest["objects"].items():
            data, _t = store.get(f"job/{RESULT_PREFIX}/{rel}")
            path = os.path.join(dest, *rel.split("/"))
            os.makedirs(os.path.dirname(path) or dest, exist_ok=True)
            with open(path, "wb") as fh:
                fh.write(data)
        assert _content_hash(dest) == _content_hash(sequential_ref)

        # the job audits clean afterwards
        report = audit_backfill_store(store, "job", repair=False)
        assert report["clean"]

    def test_stitch_is_commit_wins(self, archive, tmp_path):
        store = store_from_url("fake:e2e-stitch-race")
        _plan(store, "job", archive)
        tally = run_store_worker(
            store, "job", scratch=str(tmp_path / "scratch"),
            worker="w1", max_wall=300, idle_poll=0.01,
            sleep_fn=lambda _s: None,
        )
        assert tally["stitched"]
        second = stitch_store_backfill(
            store, "job", worker="w2",
            scratch=str(tmp_path / "scratch2"),
        )
        assert second["status"] == "already"


# ---------------------------------------------------------------------------
# the drill's in-process legs (tier-1; the subprocess drills are slow)


def test_store_fault_matrix(archive, tmp_path):
    """``run_store_fault_matrix`` of the port's backfill drill: two
    in-process workers drain a job through a retry-wrapped fake store
    under 5xx storms, lost responses (CAS included), torn uploads and
    latency spikes; the audit is clean and the result equals an
    unfaulted ``file://`` store control byte for byte."""
    from tpudas_torch.tools import backfill_drill as drill

    n_files = int(round(2 * drill.SHARD_SEC / drill.FILE_SEC))
    src = str(tmp_path / "src")
    drill._build_archive(src, n_files)
    ctrl = drill._run_store_control(
        str(tmp_path / "bucket"), src, n_files,
        str(tmp_path / "ctrl-scratch"), 120.0, device="cpu")
    rep = drill.run_store_fault_matrix(src, n_files, str(tmp_path), ctrl,
                                       120.0, device="cpu")
    assert rep["audit_clean"], rep
    assert rep["committed"] == 2, rep
    assert rep["outputs_match_posix_control"], rep
    assert rep["pyramid_match_posix_control"], rep
    assert set(rep["faults_fired"]) >= {"unavailable", "lost", "torn"}


# ---------------------------------------------------------------------------
# across the packages


@pytest.mark.parametrize("direction", ["jax-then-port", "port-then-jax"])
def test_store_queue_drains_across_packages(archive, sequential_ref,
                                            tmp_path, direction):
    """A ``file://`` store job planned and half-drained by one package
    (a worker commits the first shard, then dies at its second claim)
    is finished and stitched by the other: the plan, the dead worker's
    lease, the done marker and the shard manifest read the same through
    both packages, and the result is within 1e-5 per channel of the
    port's sequential run (the cascade sums in another order across
    frameworks)."""
    import jax  # noqa: F401

    import tpudas.backfill.objqueue as jobj
    import tpudas.resilience.faults as jfaults
    import tpudas.store as jstore
    import tpudas_torch.resilience.faults as tfaults
    import tpudas_torch.store as tstore
    from tpudas_torch.backfill import objqueue as tobj

    from test_torch_backfill import _within_1e5_per_channel

    bucket = str(tmp_path / "bucket")
    stores = {"jax": jstore.PosixStore(bucket),
              "port": tstore.PosixStore(bucket)}
    first, second = direction.split("-then-")
    planner = jobj.plan_backfill_store if first == "jax" else (
        tobj.plan_backfill_store)
    planner(stores[first], "job", archive, T0, _t_end(),
            shard_seconds=SHARD_SEC, output_sample_interval=DT,
            edge_buffer=EDGE, process_patch_size=20, pyramid=False,
            detect=False, ingest_limit_sec=35.0)
    workers = {"jax": jobj.run_store_worker, "port": run_store_worker}
    faults = {"jax": jfaults, "port": tfaults}[first]
    clock = FakeClock()
    plan = faults.FaultPlan(faults.FaultSpec(
        "backfill.claim", exc=KeyboardInterrupt, at=2))
    with faults.install_fault_plan(plan):
        with pytest.raises(KeyboardInterrupt):
            workers[first](stores[first], "job",
                           scratch=str(tmp_path / "s1"), worker="first",
                           lease_ttl=5.0, clock=clock, max_wall=120,
                           idle_poll=0.01, sleep_fn=lambda _s: None)
    qs = {
        "jax": jobj.StoreBackfillQueue(stores["jax"], "job", worker="chk",
                                       clock=clock),
        "port": tobj.StoreBackfillQueue(stores["port"], "job",
                                        worker="chk", clock=clock),
    }
    assert qs["port"].plan == qs["jax"].plan
    assert qs["port"].counts() == qs["jax"].counts()
    for sh in qs["port"].plan["shards"]:
        sid = sh["id"]
        for call in ("shard_state", "read_lease", "is_done",
                     "shard_manifest", "manifest_verifies"):
            assert (getattr(qs["port"], call)(sid)
                    == getattr(qs["jax"], call)(sid)), (call, sid)
    assert qs["port"].is_done("sh00000")
    clock.advance(6.0)
    tally = workers[second](stores[second], "job",
                            scratch=str(tmp_path / "s2"), worker="second",
                            lease_ttl=5.0, clock=clock, max_wall=120,
                            idle_poll=0.01, sleep_fn=lambda _s: None)
    assert tally["committed"] == 1 and tally["stitched"], tally
    from tpudas_torch.tools.backfill_drill import materialize_result

    dest = str(tmp_path / "result")
    materialize_result(stores["port"], "job", dest)
    _within_1e5_per_channel(dest, sequential_ref)
    assert audit_backfill_store(stores["port"], "job",
                                repair=False)["clean"]
    from tpudas.integrity.audit import audit_backfill_store as jax_audit

    assert jax_audit(stores["jax"], "job", repair=False)["clean"]


def _damaged_store_job(mod_store, mod_obj, archive, tmp_path, name, clock):
    """The damage matrix of ``test_audit_classifies_and_repairs_the_matrix``
    built through one package's store and queue."""
    store = mod_store.FakeObjectStore()
    mod_obj.plan_backfill_store(
        store, "job", archive, T0, _t_end(), shard_seconds=SHARD_SEC,
        output_sample_interval=DT, edge_buffer=EDGE, process_patch_size=20,
        pyramid=False, detect=False, ingest_limit_sec=35.0)
    q = mod_obj.StoreBackfillQueue(
        store, "job", scratch=str(tmp_path / f"scratch-{name}"),
        worker="w1", lease_ttl=10.0, clock=clock)
    s_a, s_b = (sh["id"] for sh in q.plan["shards"])
    lease = q.try_claim(s_a)
    q.commit(lease, _fabricate_staging(tmp_path, f"stage-{name}"))
    store.put(f"job/{DONE_PREFIX}/{s_a}.json", b"{torn")
    store.put(f"{q.shard_prefix(s_a)}/stray.bin", b"stray")
    q.try_claim(s_b)
    store.put(f"job/{RESULT_DONE_KEY}", b"{also torn")
    store.injector.add(mod_store.FaultRule(kind="torn", op="put",
                                           match="torn-upload"))
    with pytest.raises(Exception):
        store.put("job/shards/sh00001/torn-upload", b"half")
    return store


@pytest.mark.parametrize("repair", [True, False])
def test_audit_backfill_store_equal_across_packages(archive, tmp_path,
                                                    repair):
    """The same damage (a torn done marker over a verifying manifest, a
    stray object, a dead worker's lease, a torn result marker, a torn
    upload) built through each package's store: the two
    ``audit_backfill_store`` reports list the same issues and repairs,
    and the stores end with the same keys and uploads."""
    import jax  # noqa: F401

    import tpudas.backfill.objqueue as jobj
    import tpudas.store as jstore
    import tpudas_torch.store as tstore
    from tpudas.integrity.audit import audit_backfill_store as jax_audit
    from tpudas_torch.backfill import objqueue as tobj

    reports, stores = {}, {}
    for name, ms, mo, fn in (("port", tstore, tobj, audit_backfill_store),
                             ("jax", jstore, jobj, jax_audit)):
        clock = FakeClock()
        stores[name] = _damaged_store_job(ms, mo, archive, tmp_path, name,
                                          clock)
        clock.advance(1e6)
        rep = fn(stores[name], "job", repair=repair, clock=clock)
        rep.pop("elapsed_s", None)
        reports[name] = rep
    assert reports["port"]["issues"]
    assert reports["port"] == reports["jax"]
    assert stores["port"].list("job") == stores["jax"].list("job")
    assert (stores["port"].list_uploads("job")
            == stores["jax"].list_uploads("job"))
