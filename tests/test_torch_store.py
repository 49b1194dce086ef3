"""The port's object-store tile plane (tpudas_torch.store) on the CPU.

Every case of ``tests/test_store.py``, against the port:

Backend contract (posix + fake through one parametrized surface),
scripted fault injection (5xx, lost response, torn upload, offline),
idempotency-aware retry with lost-CAS token-re-read recovery, the NVMe
read-through cache's stale-but-verified degradation ladder, and the
pyramid publisher / remote reader — including the race-matrix legs
that live at this layer: lost conditional put converging exactly-once,
and cache poisoning after a generation-bump CAS of the manifest.
"""

import os
import sys

import numpy as np
import pytest

from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.serve.tiles import (
    MANIFEST_FILENAME,
    TileStore,
    rebuild_pyramid,
    sync_pyramid,
)
from tpudas_torch.store import (
    CASConflictError,
    FakeObjectStore,
    FaultInjector,
    FaultRule,
    ObjectNotFoundError,
    PosixStore,
    PyramidPublisher,
    ReadThroughCache,
    RemotePyramid,
    RetryingStore,
    StoreError,
    StoreNetworkError,
    store_from_url,
    token_of,
)
from tpudas_torch.testing import make_synthetic_spool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _registry():
    reg = MetricsRegistry()
    return reg


@pytest.fixture(params=["posix", "fake"])
def backend(request, tmp_path):
    if request.param == "posix":
        return PosixStore(str(tmp_path / "store"))
    return FakeObjectStore()


class TestContract:
    def test_roundtrip_and_tokens(self, backend):
        token = backend.put("a/b/obj.bin", b"payload")
        assert token == backend.token_for(b"payload")
        data, token2 = backend.get("a/b/obj.bin")
        assert data == b"payload" and token2 == token
        assert backend.head("a/b/obj.bin") == token
        assert backend.exists("a/b/obj.bin")
        assert backend.head("a/b/missing") is None
        with pytest.raises(ObjectNotFoundError):
            backend.get("a/b/missing")

    def test_list_is_prefix_scoped_and_sorted(self, backend):
        for key in ("p/z", "p/a", "p/sub/x", "q/other"):
            backend.put(key, key.encode())
        assert backend.list("p") == ["p/a", "p/sub/x", "p/z"]
        assert backend.list("p/sub") == ["p/sub/x"]
        assert backend.list("p/su") == []  # prefix is path-segment-wise
        assert "q/other" in backend.list()

    def test_delete_is_idempotent(self, backend):
        backend.put("k", b"x")
        assert backend.delete("k") is True
        assert backend.delete("k") is False
        assert backend.head("k") is None

    def test_bad_keys_refused(self, backend):
        for key in ("", "/abs", "../up", "a/../../b", "a\\b"):
            with pytest.raises(StoreError):
                backend.put(key, b"x")

    def test_put_if_needs_exactly_one_precondition(self, backend):
        with pytest.raises(StoreError):
            backend.put_if("k", b"x")
        with pytest.raises(StoreError):
            backend.put_if("k", b"x", if_token="t", if_absent=True)

    def test_create_only_cas(self, backend):
        token = backend.put_if("lease", b"mine", if_absent=True)
        assert token == backend.token_for(b"mine")
        with pytest.raises(CASConflictError):
            backend.put_if("lease", b"rival", if_absent=True)
        assert backend.get("lease")[0] == b"mine"

    def test_if_match_cas(self, backend):
        t1 = backend.put("m", b"v1")
        t2 = backend.put_if("m", b"v2", if_token=t1)
        assert backend.get("m") == (b"v2", t2)
        # the stale token now loses, and the object is untouched
        with pytest.raises(CASConflictError):
            backend.put_if("m", b"v3", if_token=t1)
        assert backend.get("m")[0] == b"v2"
        # CAS against a missing object also loses
        with pytest.raises(CASConflictError):
            backend.put_if("absent", b"x", if_token=t1)

    def test_token_formula(self):
        assert token_of(b"") == "00000000-0"
        tok = token_of(b"abc")
        crc, _, length = tok.partition("-")
        assert len(crc) == 8 and length == "3"


class TestPosix:
    def test_tmp_files_invisible_but_listed_as_uploads(self, tmp_path):
        store = PosixStore(str(tmp_path))
        store.put("s/real", b"ok")
        # a crashed writer's tmp debris, planted directly
        debris = tmp_path / "s" / "half.tmp.999"
        debris.write_bytes(b"partial")
        assert store.list("s") == ["s/real"]
        assert store.list_uploads("s") == ["s/half.tmp.999"]
        assert store.abort_upload("s/half.tmp.999") is True
        assert store.list_uploads("s") == []
        assert store.abort_upload("s/real") is False  # not a tmp name
        assert store.get("s/real")[0] == b"ok"


class TestFakeFaults:
    def test_unavailable_fires_before_apply(self):
        store = FakeObjectStore(FaultInjector(
            FaultRule(kind="unavailable", op="put", match="victim"),
        ))
        with pytest.raises(StoreNetworkError):
            store.put("victim", b"x")
        assert store.head("victim") is None  # nothing applied
        store.put("victim", b"x")  # rule window passed
        assert store.get("victim")[0] == b"x"

    def test_lost_fires_after_apply(self):
        store = FakeObjectStore(FaultInjector(
            FaultRule(kind="lost", op="put", match="victim"),
        ))
        with pytest.raises(StoreNetworkError):
            store.put("victim", b"x")
        # the write LANDED; only the response was dropped
        assert store.get("victim")[0] == b"x"

    def test_torn_upload_leaves_debris_not_objects(self):
        store = FakeObjectStore(FaultInjector(
            FaultRule(kind="torn", op="put", match="victim"),
        ))
        with pytest.raises(StoreNetworkError):
            store.put("s/victim", b"x")
        assert store.list("s") == []  # readers never see partials
        assert store.list_uploads("s") == ["s/victim"]
        assert store.abort_upload("s/victim") is True
        assert store.list_uploads() == []

    def test_offline_fails_everything(self):
        store = FakeObjectStore()
        store.put("k", b"x")
        store.injector.set_offline(True)
        for call in (
            lambda: store.get("k"),
            lambda: store.head("k"),
            lambda: store.put("k2", b"y"),
            lambda: store.list(),
        ):
            with pytest.raises(StoreNetworkError):
                call()
        store.injector.set_offline(False)
        assert store.get("k")[0] == b"x"

    def test_latency_rule_sleeps(self):
        slept = []
        inj = FaultInjector(
            FaultRule(kind="latency", op="get", seconds=0.25),
            sleep_fn=slept.append,
        )
        store = FakeObjectStore(inj)
        store.put("k", b"x")
        store.get("k")
        assert slept == [0.25]

    def test_rule_hit_window(self):
        store = FakeObjectStore(FaultInjector(
            FaultRule(kind="unavailable", op="get", at=2, times=2),
        ))
        store.put("k", b"x")
        store.get("k")  # hit 1: clean
        for _ in range(2):  # hits 2-3: fire
            with pytest.raises(StoreNetworkError):
                store.get("k")
        store.get("k")  # hit 4: clean again

    def test_partition_scoped_to_prefix(self):
        """A partition severs ONE subtree; the rest keeps answering
        (how replication drills take down a single mirror's keys)."""
        store = FakeObjectStore()
        store.put("a/k", b"x")
        store.put("b/k", b"y")
        rule = store.injector.partition(match="a/")
        for call in (
            lambda: store.get("a/k"),
            lambda: store.put("a/k2", b"z"),
            lambda: store.head("a/k"),
        ):
            with pytest.raises(StoreNetworkError):
                call()
        # the unmatched subtree is untouched
        assert store.get("b/k")[0] == b"y"
        store.put("b/k2", b"z")
        # unbounded until healed — well past any hit-window default
        for _ in range(5):
            with pytest.raises(StoreNetworkError):
                store.head("a/k")
        assert store.injector.heal(rule) == 1
        assert store.get("a/k")[0] == b"x"
        assert store.head("a/k2") is None  # severed put never applied

    def test_partition_nothing_applied(self):
        store = FakeObjectStore()
        store.injector.partition(match="v")
        with pytest.raises(StoreNetworkError):
            store.put("v1", b"x")
        with pytest.raises(StoreNetworkError):
            store.put_if("v2", b"x", if_absent=True)
        store.injector.heal("v")
        assert store.list() == []

    def test_partition_whole_store_and_heal_by_match(self):
        store = FakeObjectStore()
        store.put("k", b"x")
        store.injector.partition()
        store.injector.partition()
        with pytest.raises(StoreNetworkError):
            store.get("k")
        # heal(None) lifts every match-everything partition at once
        assert store.injector.heal(None) == 2
        assert store.get("k")[0] == b"x"

    def test_partition_op_scoped(self):
        """op="put" severs writes only — reads still answer (an
        asymmetric partition, e.g. a read-only degraded mirror)."""
        store = FakeObjectStore()
        store.put("k", b"x")
        rule = store.injector.partition(op="put")
        with pytest.raises(StoreNetworkError):
            store.put("k2", b"y")
        assert store.get("k")[0] == b"x"
        store.injector.heal(rule)
        store.put("k2", b"y")

    def test_partition_fired_log(self):
        store = FakeObjectStore()
        store.injector.partition(match="p/")
        with pytest.raises(StoreNetworkError):
            store.put("p/k", b"x")
        kinds = [k for k, _op, _key, _hit in store.injector.fired]
        assert "partition" in kinds


class TestRetry:
    def _wrapped(self, *rules):
        sleeps = []
        store = RetryingStore(
            FakeObjectStore(FaultInjector(*rules)),
            sleep_fn=sleeps.append,
        )
        return store, sleeps

    def test_blind_retry_rides_out_a_5xx_storm(self):
        store, sleeps = self._wrapped(
            FaultRule(kind="unavailable", op="put", times=3),
        )
        with use_registry(_registry()) as reg:
            assert store.put("k", b"x") == token_of(b"x")
            assert reg.counter(
                "tpudas_store_retries_total", "",
                labelnames=("op", "backend"),
            ).value(op="put", backend="fake") == 3
        assert len(sleeps) == 3
        # capped-exponential backoff: non-decreasing, bounded
        assert sleeps == sorted(sleeps)
        assert all(0 < s <= store.policy.max_delay for s in sleeps)

    def test_patience_runs_out(self):
        store, _ = self._wrapped(
            FaultRule(kind="unavailable", op="get", times=99),
        )
        store.inner.put("k", b"x")
        with use_registry(_registry()) as reg:
            with pytest.raises(StoreNetworkError):
                store.get("k")
            # the member is down: counted per backend so a replicated
            # composite's failover is attributable in /metrics
            assert reg.counter(
                "tpudas_store_retry_exhausted_total", "",
                labelnames=("op", "backend"),
            ).value(op="get", backend="fake") == 1

    def test_lost_put_converges(self):
        store, _ = self._wrapped(FaultRule(kind="lost", op="put"))
        assert store.put("k", b"x") == token_of(b"x")
        assert store.inner.get("k")[0] == b"x"

    def test_lost_cas_recovered_by_token_reread(self):
        """The lost-conditional-put leg of the race matrix: the CAS
        applies, the response drops, and the retry layer must confirm
        its OWN write landed instead of re-issuing (which would
        conflict against itself and miscount a success as a lost
        race)."""
        store, sleeps = self._wrapped(FaultRule(kind="lost", op="cas"))
        with use_registry(_registry()) as reg:
            token = store.put_if("marker", b"mine", if_absent=True)
            assert token == token_of(b"mine")
            assert reg.counter(
                "tpudas_store_cas_recovered_total", "",
                labelnames=("backend",),
            ).value(backend="fake") == 1
        assert store.inner.get("marker")[0] == b"mine"
        assert sleeps == []  # recovery is one head, no backoff
        # and the marker still refuses a second writer: exactly-once
        with pytest.raises(CASConflictError):
            store.put_if("marker", b"rival", if_absent=True)

    def test_lost_cas_with_unreachable_reread_still_recovers(self):
        """Worst case: the response drops AND the confirm head fails.
        The eventual CASConflictError carrying our own token is the
        write confirming itself."""
        store, _ = self._wrapped(
            FaultRule(kind="lost", op="cas"),
            FaultRule(kind="unavailable", op="head", times=1),
        )
        assert store.put_if(
            "marker", b"mine", if_absent=True
        ) == token_of(b"mine")
        assert store.inner.get("marker")[0] == b"mine"

    def test_genuine_conflict_never_retried(self):
        store, sleeps = self._wrapped()
        store.put("m", b"theirs")
        with pytest.raises(CASConflictError):
            store.put_if("m", b"mine", if_absent=True)
        assert sleeps == []
        assert store.inner.get("m")[0] == b"theirs"

    def test_store_from_url_fake_is_shared_per_tag(self):
        a = store_from_url("fake:test-shared")
        b = store_from_url("fake:test-shared", retry=False)
        assert isinstance(a, RetryingStore)
        a.put("k", b"x")
        assert b.get("k")[0] == b"x"
        assert a.inner is b


class _CountingStore:
    """Forwarding wrapper that tallies ops — what the cache tests use
    to prove which calls did (not) reach the cold tier."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = {"get": 0, "head": 0}

    def get(self, key):
        self.calls["get"] += 1
        return self.inner.get(key)

    def head(self, key):
        self.calls["head"] += 1
        return self.inner.head(key)


class TestCache:
    def test_miss_then_hit_then_freshness(self, tmp_path):
        remote = _CountingStore(FakeObjectStore())
        remote.inner.put("k", b"v1")
        cache = ReadThroughCache(str(tmp_path / "c"))
        assert cache.get_through(remote, "k") == (b"v1", token_of(b"v1"))
        assert remote.calls == {"get": 1, "head": 0}
        # hit: one freshness head, no get
        assert cache.get_through(remote, "k")[0] == b"v1"
        assert remote.calls == {"get": 1, "head": 1}
        # the object moved; the probe notices and refetches
        remote.inner.put("k", b"v2")
        assert cache.get_through(remote, "k")[0] == b"v2"
        assert remote.calls["get"] == 2

    def test_immutable_skips_the_probe(self, tmp_path):
        remote = _CountingStore(FakeObjectStore())
        remote.inner.put("t", b"tile")
        cache = ReadThroughCache(str(tmp_path / "c"))
        cache.get_through(remote, "t", immutable=True)
        cache.get_through(remote, "t", immutable=True)
        assert remote.calls == {"get": 1, "head": 0}

    def test_stale_but_verified_when_cold_tier_down(self, tmp_path):
        store = FakeObjectStore()
        store.put("k", b"warm")
        cache = ReadThroughCache(str(tmp_path / "c"))
        cache.get_through(store, "k")
        store.injector.set_offline(True)
        data, _tok = cache.get_through(store, "k")
        assert data == b"warm"
        assert cache.degraded()
        snap = cache.snapshot()
        assert snap["degraded"] and snap["stale_served"] == 1
        # a key never cached has nothing verified to serve
        with pytest.raises(StoreNetworkError):
            cache.get_through(store, "never-seen")
        store.injector.set_offline(False)
        cache.get_through(store, "k")
        assert not cache.degraded()

    def test_corrupt_entry_deleted_not_served(self, tmp_path):
        store = FakeObjectStore()
        store.put("k", b"good-bytes")
        cache = ReadThroughCache(str(tmp_path / "c"))
        cache.get_through(store, "k")
        # flip payload bits behind the cache's back
        (entry,) = [
            p for p in (tmp_path / "c").iterdir()
            if p.name.endswith(".obj")
        ]
        blob = bytearray(entry.read_bytes())
        blob[-1] ^= 0xFF
        entry.write_bytes(bytes(blob))
        store.injector.set_offline(True)
        with pytest.raises(StoreNetworkError):
            cache.get_through(store, "k")  # corrupt ≠ servable
        store.injector.set_offline(False)
        assert cache.get_through(store, "k")[0] == b"good-bytes"

    def test_lru_eviction_by_bytes(self, tmp_path):
        store = FakeObjectStore()
        for i in range(4):
            store.put(f"k{i}", bytes([i]) * 100)
        cache = ReadThroughCache(str(tmp_path / "c"), max_bytes=250)
        for i in range(4):
            cache.get_through(store, f"k{i}")
        snap = cache.snapshot()
        assert snap["entries"] == 2 and snap["bytes"] <= 250

    def test_invalidate_prefix(self, tmp_path):
        store = FakeObjectStore()
        for key in ("s/a", "s/b", "other/c"):
            store.put(key, b"x")
        cache = ReadThroughCache(str(tmp_path / "c"))
        for key in ("s/a", "s/b", "other/c"):
            cache.get_through(store, key)
        assert cache.invalidate_prefix("s") == 2
        assert cache.snapshot()["entries"] == 1

    def test_warm_restart_inherits_entries(self, tmp_path):
        store = FakeObjectStore()
        store.put("k", b"x")
        ReadThroughCache(str(tmp_path / "c")).get_through(store, "k")
        reborn = ReadThroughCache(str(tmp_path / "c"))
        assert reborn.snapshot()["entries"] == 1
        counting = _CountingStore(store)
        reborn.get_through(counting, "k", immutable=True)
        assert counting.calls == {"get": 0, "head": 0}


FS = 50.0
T0 = "2023-03-22T00:00:00"


@pytest.fixture(scope="module")
def pyramid_folder(tmp_path_factory):
    """A small real pyramid (one realtime run + sync) every tileplane
    test publishes from."""
    from tpudas_torch.proc.streaming import run_lowpass_realtime

    src = str(tmp_path_factory.mktemp("tp_src") / "a")
    make_synthetic_spool(
        src, n_files=6, file_duration=20.0, fs=FS, n_ch=4,
        noise=0.01, start=np.datetime64(T0),
    )
    out = str(tmp_path_factory.mktemp("tp_out") / "out")
    run_lowpass_realtime(
        source=src, output_folder=out, start_time=T0,
        output_sample_interval=1.0, edge_buffer=5.0,
        process_patch_size=20, poll_interval=0.0,
        sleep_fn=lambda _s: None, pyramid=False, device="cpu",
    )
    sync_pyramid(out, tile_len=16)
    return out


def _remote(store, tmp_path, name):
    cache = ReadThroughCache(str(tmp_path / f"{name}-cache"))
    return RemotePyramid(
        store, "streams/a", cache, str(tmp_path / f"{name}-mirror"),
        min_refresh_s=0.0,
    )


class TestTilePlane:
    def test_publish_then_remote_read_byte_identical(
        self, pyramid_folder, tmp_path
    ):
        store = FakeObjectStore()
        pub = PyramidPublisher(store, "streams/a", pyramid_folder)
        first = pub.publish()
        assert first["tiles"] > 0 and first["manifest"]
        # steady state: nothing changed, nothing moves
        assert pub.publish() == {"tiles": 0, "manifest": False}

        local = TileStore.open(pyramid_folder)
        remote = _remote(store, tmp_path, "r1")
        for level in range(len(local.levels)):
            n = int(local.n(level))
            mine = remote.read(level, 0, n, "mean")
            theirs = local.read(level, 0, n, "mean")
            np.testing.assert_array_equal(mine, theirs)

    def test_restarted_publisher_reuploads_nothing(
        self, pyramid_folder, tmp_path
    ):
        store = FakeObjectStore()
        PyramidPublisher(store, "streams/a", pyramid_folder).publish()
        n_objects = len(store.snapshot_keys())
        reborn = PyramidPublisher(store, "streams/a", pyramid_folder)
        assert reborn.publish() == {"tiles": 0, "manifest": False}
        assert len(store.snapshot_keys()) == n_objects

    def test_restarted_publisher_catches_up_on_stale_token(
        self, pyramid_folder, tmp_path
    ):
        """A single stale token (our process restarted; the artifact
        is still single-writer) is NOT split-brain: the bounded
        re-read loop catches up and the publish lands."""
        import shutil

        work = str(tmp_path / "work")
        shutil.copytree(pyramid_folder, work)
        store = FakeObjectStore()
        PyramidPublisher(store, "streams/a", work).publish()
        manifest_key = f"streams/a/{MANIFEST_FILENAME}"
        pub = PyramidPublisher(store, "streams/a", work)
        pub._seed()
        # the object moves once behind our back (our own earlier
        # incarnation's write we never heard about) ...
        store.put(manifest_key, b'{"generation": 0, "old": true}')
        # ... and the local pyramid has moved on since
        local_manifest = os.path.join(pub.tiles_dir, MANIFEST_FILENAME)
        with open(local_manifest, "rb") as fh:
            moved_on = fh.read() + b"\n"
        with open(local_manifest, "wb") as fh:
            fh.write(moved_on)
        assert pub._publish_mutable() is True
        assert store.get(manifest_key)[0] == moved_on

    def test_second_writer_split_brain_surfaces_as_conflict(
        self, pyramid_folder, tmp_path
    ):
        """A rival that keeps moving the manifest (true split-brain:
        two live writers on one stream) must surface as
        CASConflictError, never be papered over."""

        class _RacingStore(FakeObjectStore):
            def _put_if(self, key, data, if_token, if_absent):
                if key.endswith(MANIFEST_FILENAME):
                    with self._lock:
                        prev = self._objects.get(key, b"{}")
                        self._objects[key] = prev + b" "
                return super()._put_if(key, data, if_token, if_absent)

        store = _RacingStore()
        pub = PyramidPublisher(store, "streams/a", pyramid_folder)
        with pytest.raises(CASConflictError):
            pub.publish()

    def test_cache_poisoning_after_generation_bump(
        self, pyramid_folder, tmp_path
    ):
        """Race-matrix leg: a rebuild re-encodes tiles under UNCHANGED
        names and CAS-bumps the manifest generation.  A reader holding
        pre-bump mirror/cache entries must drop them — serving the old
        bytes against the new manifest is the poisoning case."""
        import shutil

        work = str(tmp_path / "work")
        shutil.copytree(pyramid_folder, work)
        store = FakeObjectStore()
        pub = PyramidPublisher(store, "streams/a", work)
        pub.publish()
        remote = _remote(store, tmp_path, "r2")
        ts = remote.open()
        gen0 = remote._generation
        before = remote.read(0, 0, ts.tile_len, "mean")
        assert remote.cache.snapshot()["entries"] > 0

        # rebuild with a coarser pyramid: same tile names, new bytes
        rebuild_pyramid(work, factor=2, tile_len=16)
        pub2 = PyramidPublisher(store, "streams/a", work)
        pub2.publish()

        remote.refresh(force=True)
        assert remote._generation == gen0 + 1
        assert remote.cache.snapshot()["entries"] == 0  # flushed
        ts2 = remote.open()
        after = remote.read(0, 0, ts2.tile_len, "mean")
        np.testing.assert_array_equal(
            after, TileStore.open(work).read(0, 0, ts2.tile_len)
        )

    def test_remote_survives_outage_then_recovers(
        self, pyramid_folder, tmp_path
    ):
        store = FakeObjectStore()
        PyramidPublisher(store, "streams/a", pyramid_folder).publish()
        remote = _remote(store, tmp_path, "r3")
        ts = remote.open()
        warm = remote.read(0, 0, ts.tile_len, "mean")
        store.injector.set_offline(True)
        remote.refresh(force=True)
        assert remote.snapshot()["stale"] is True
        again = remote.read(0, 0, ts.tile_len, "mean")
        np.testing.assert_array_equal(again, warm)
        store.injector.set_offline(False)
        remote.refresh(force=True)
        assert remote.snapshot()["stale"] is False


# ---------------------------------------------------------------------------
# across the packages

import importlib  # noqa: E402

import jax  # noqa: E402,F401  (conftest pins JAX to the CPU)

PKGS = {"jax": "tpudas.store", "port": "tpudas_torch.store"}


def _pkg(name):
    return importlib.import_module(PKGS[name])


def _outcome(fn):
    """``("ok", value)`` or ``("raise", exception type name, message)``
    of one call — what both packages must agree on."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - the outcome IS the test
        return ("raise", type(exc).__name__, str(exc))


RULE_SEQUENCES = {
    "storms": [
        dict(kind="unavailable", at=2, times=3),
        dict(kind="lost", op="cas", at=1, times=1),
        dict(kind="torn", op="put", match="s/", at=2, times=1),
    ],
    "scoped": [
        dict(kind="unavailable", op="get", match="b", at=1, times=2),
        dict(kind="lost", op="put", match="a", at=3, times=2),
        dict(kind="unavailable", op="list", at=1, times=1),
        dict(kind="unavailable", op="delete", at=1, times=1),
    ],
    "latency": [
        dict(kind="latency", op="get", at=1, times=2, seconds=0.5),
        dict(kind="latency", op="head", at=2, times=1, seconds=0.25),
        dict(kind="torn", op="put", at=4, times=1),
    ],
}


def _fault_script(pkg):
    """One fixed op sequence through a fake store of ``pkg`` under each
    rule sequence; returns (outcomes, fired log, sleeps, final keys)."""
    mod = _pkg(pkg)
    out = {}
    for name, rules in RULE_SEQUENCES.items():
        slept = []
        store = mod.FakeObjectStore(mod.FaultInjector(
            *(mod.FaultRule(**r) for r in rules), sleep_fn=slept.append))
        ops = [
            lambda: store.put("a/k", b"one"),
            lambda: store.put("s/k", b"two"),
            lambda: store.get("a/k"),
            lambda: store.head("b/missing"),
            lambda: store.put_if("c/k", b"x", if_absent=True),
            lambda: store.put_if("c/k", b"y", if_absent=True),
            lambda: store.put("s/k2", b"three"),
            lambda: store.get("b/missing"),
            lambda: store.list("s"),
            lambda: store.list_uploads(),
            lambda: store.put_if("a/k", b"four",
                                 if_token=mod.token_of(b"one")),
            lambda: store.delete("s/k"),
            lambda: store.head("a/k"),
            lambda: store.get("a/k"),
            lambda: store.list(),
        ]
        outcomes = [_outcome(op) for op in ops]
        out[name] = (outcomes, [tuple(f) for f in store.injector.fired],
                     slept, store.list(), store.list_uploads())
    return out


def test_fault_rules_same_outcomes_across_packages():
    """The same ``FaultRule`` sequences give the same outcome at every
    call (value, or exception type and message), the same ``fired`` log,
    the same latency sleeps and the same final store in both packages'
    ``FakeObjectStore``."""
    got, want = _fault_script("port"), _fault_script("jax")
    assert got == want
    assert any(o[0] == "raise" for o in got["storms"][0])


class _S3Error(Exception):
    """A botocore ``ClientError``-shaped exception."""

    def __init__(self, code, msg="error"):
        super().__init__(f"An error occurred ({code}): {msg}")
        self.response = {"Error": {"Code": str(code), "Message": msg}}


class _Body:
    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data


class StubS3Client:
    """A dict-backed stand-in for a boto3 S3 client (the calls
    ``S3Store`` makes), with conditional puts, one-page-at-a-time
    listing and scripted failures: ``fail`` maps a method name to the
    error code its next call raises."""

    def __init__(self, page=2):
        self.objects = {}
        self.uploads = {}
        self.page = int(page)
        self.fail = {}
        self.calls = []

    def _maybe_fail(self, name):
        self.calls.append(name)
        code = self.fail.pop(name, None)
        if code is not None:
            raise _S3Error(code)

    @staticmethod
    def _etag(data):
        import hashlib

        return '"' + hashlib.md5(data).hexdigest() + '"'

    def put_object(self, Bucket, Key, Body, IfNoneMatch=None, IfMatch=None):
        self._maybe_fail("put_object")
        key = (Bucket, Key)
        if IfNoneMatch == "*" and key in self.objects:
            raise _S3Error("PreconditionFailed")
        if IfMatch is not None and (
                key not in self.objects
                or self._etag(self.objects[key]) != IfMatch):
            raise _S3Error("412")
        self.objects[key] = bytes(Body)
        return {"ETag": self._etag(bytes(Body))}

    def get_object(self, Bucket, Key):
        self._maybe_fail("get_object")
        if (Bucket, Key) not in self.objects:
            raise _S3Error("NoSuchKey")
        data = self.objects[(Bucket, Key)]
        return {"Body": _Body(data), "ETag": self._etag(data)}

    def head_object(self, Bucket, Key):
        self._maybe_fail("head_object")
        if (Bucket, Key) not in self.objects:
            raise _S3Error("404")
        return {"ETag": self._etag(self.objects[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):
        self._maybe_fail("delete_object")
        self.objects.pop((Bucket, Key), None)
        return {}

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        self._maybe_fail("list_objects_v2")
        keys = sorted(k for b, k in self.objects
                      if b == Bucket and k.startswith(Prefix))
        start = int(ContinuationToken or 0)
        chunk = keys[start:start + self.page]
        more = start + self.page < len(keys)
        resp = {"Contents": [{"Key": k} for k in chunk],
                "IsTruncated": more}
        if more:
            resp["NextContinuationToken"] = str(start + self.page)
        return resp

    def list_multipart_uploads(self, Bucket, Prefix):
        self._maybe_fail("list_multipart_uploads")
        return {"Uploads": [
            {"Key": k, "UploadId": uid}
            for (b, k), uid in sorted(self.uploads.items())
            if b == Bucket and k.startswith(Prefix)]}

    def abort_multipart_upload(self, Bucket, Key, UploadId):
        self._maybe_fail("abort_multipart_upload")
        self.uploads.pop((Bucket, Key), None)
        return {}


def _s3_script(pkg):
    from tpudas.store.s3 import S3Store as JaxS3
    from tpudas_torch.store.s3 import S3Store as PortS3

    client = StubS3Client()
    client.uploads[("bkt", "pre/job/half")] = "u1"
    store = (PortS3 if pkg == "port" else JaxS3)(
        "bkt", prefix="pre", client=client)
    mod = _pkg(pkg)
    ops = [
        lambda: store.put("job/a", b"alpha"),
        lambda: store.put("job/b/c", b"beta"),
        lambda: store.put("other/d", b"delta"),
        lambda: store.get("job/a"),
        lambda: store.get("job/missing"),
        lambda: store.head("job/missing"),
        lambda: store.put_if("job/a", b"x", if_absent=True),
        lambda: store.put_if("job/new", b"n", if_absent=True),
        lambda: store.put_if("job/a", b"a2", if_token="bogus"),
        lambda: store.put_if("job/a", b"a2",
                             if_token=store.head("job/a")),
        lambda: store.list("job"),
        lambda: store.list(""),
        lambda: store.list("job/a"),
        lambda: store.list_uploads("job"),
        lambda: store.abort_upload("job/half"),
        lambda: store.list_uploads("job"),
        lambda: store.delete("job/b/c"),
        lambda: store.delete("job/b/c"),
        lambda: client.fail.update(get_object="500"),
        lambda: store.get("job/a"),
        lambda: client.fail.update(head_object="SlowDown"),
        lambda: store.head("job/a"),
        lambda: client.fail.update(list_objects_v2="503"),
        lambda: store.list("job"),
        lambda: client.fail.update(put_object="PreconditionFailed"),
        lambda: store.put_if("job/z", b"z", if_absent=True),
        lambda: store.token_for(b"alpha"),
        lambda: isinstance(store, mod.ObjectStore),
    ]
    outcomes = [_outcome(op) for op in ops]
    return outcomes, sorted(client.objects.items()), client.calls


def test_s3store_same_keys_and_errors_across_packages():
    """``S3Store`` over one dict-backed stub client in both packages:
    the same keys land under the prefix, the same tokens come back, and
    404 / 412 / any other service error translate to the same
    exception type and message."""
    got, want = _s3_script("port"), _s3_script("jax")
    assert got == want
    outcomes = got[0]
    kinds = {o[1] for o in outcomes if o[0] == "raise"}
    assert {"ObjectNotFoundError", "CASConflictError",
            "StoreNetworkError"} <= kinds


def test_s3store_without_client_or_boto3_raises_store_error(monkeypatch):
    """Without an injected client ``S3Store`` imports boto3 lazily and
    raises ``StoreError`` when it is missing, as the JAX module does."""
    import builtins

    from tpudas_torch.store.s3 import S3Store

    real_import = builtins.__import__

    def no_boto3(name, *a, **k):
        if name == "boto3":
            raise ImportError("no boto3 here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_boto3)
    with pytest.raises(StoreError, match="boto3"):
        S3Store("bkt")


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_pyramid_publisher_tree_read_by_the_other(pyramid_folder, tmp_path,
                                                  publisher):
    """A ``PyramidPublisher`` tree written by one package into a
    ``file://`` store is read by the other package's ``RemotePyramid``:
    the mirrored ``.tiles/`` tree is byte-identical to the published
    folder's and reads the same windows, and the object keys are the
    same whichever package published."""
    import hashlib

    reader = "port" if publisher == "jax" else "jax"
    pub_mod, read_mod = _pkg(publisher), _pkg(reader)
    bucket = str(tmp_path / "bucket")
    pub = pub_mod.PyramidPublisher(
        pub_mod.PosixStore(bucket), "streams/a", pyramid_folder)
    assert pub.publish()["tiles"] > 0
    other = str(tmp_path / "bucket2")
    _pkg(reader).PyramidPublisher(
        _pkg(reader).PosixStore(other), "streams/a",
        pyramid_folder).publish()
    assert (pub_mod.PosixStore(bucket).list("streams")
            == read_mod.PosixStore(other).list("streams"))
    cache = read_mod.ReadThroughCache(str(tmp_path / "cache"))
    mirror = str(tmp_path / "mirror")
    remote = read_mod.RemotePyramid(
        read_mod.PosixStore(bucket), "streams/a", cache, mirror,
        min_refresh_s=0.0)
    remote.refresh(force=True)
    local = TileStore.open(pyramid_folder)
    for level in range(len(local.levels)):
        n = int(local.n(level))
        for agg in ("mean", "min", "max"):
            np.testing.assert_array_equal(
                remote.read(level, 0, n, agg), local.read(level, 0, n, agg))

    def tree(folder):
        base = os.path.join(folder, ".tiles")
        out = {}
        for d, _dirs, names in os.walk(base):
            for n in names:
                if ".prev" in n or ".tmp" in n:
                    continue
                p = os.path.join(d, n)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, base)] = hashlib.sha256(
                        fh.read()).hexdigest()
        return out

    got = tree(mirror)
    want = tree(pyramid_folder)
    assert "manifest.json" in got
    assert got == {k: v for k, v in want.items() if k in got}
    assert {k for k in want if k.endswith((".npy", ".tpt"))
            and k != "tails.npy"} <= set(got)
