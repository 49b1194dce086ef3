"""The port's serve worker pool (tpudas_torch.serve.pool).

``merge_prometheus`` is held to the JAX function on the same texts.  A
2-worker port ``ServePool`` over a port-written folder, fed through a
``LiveBridge`` by a hub in this process (as ``TPUDAS_LIVE_BRIDGE`` feeds
it from a producer), must answer every request on the shared port with
the same bytes, serve ``/live`` frames equal to the producer's ring,
and expose the merged ``/metrics`` (each sample tagged ``worker=``),
``/healthz`` and ``/pool/healthz``; both packages' ``pool_rollup`` read
it.  A 1-worker pool over an object store (``store_url``) answers with
the bytes of a store-mounted server.  ``TestServePoolRespawn`` of ``tests/test_serve.py`` is ported with
the JAX package's ``slow`` marks.  Every network read carries a
timeout; the pools have at most 2 workers.  Everything runs on the CPU.
"""

import base64
import json
import os
import signal
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.obs import collect as jcollect
from tpudas.serve import pool as jpool
from tpudas.testing import make_synthetic_spool
from tpudas_torch.codec import decode_tile
from tpudas_torch.live import hub as thub
from tpudas_torch.live import sse as tsse
from tpudas_torch.obs import collect as tcollect
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.serve import pool as tpool

T0 = "2023-03-22T00:00:00"
TIMEOUT = 30
needs_reuse_port = pytest.mark.skipif(
    not tpool.has_reuse_port(),
    reason="SO_REUSEPORT unavailable on this platform")

TEXTS = [
    {"0": "# TYPE m counter\nm 1\nn{a=\"b\"} 2\n",
     "1": "# TYPE m counter\nm 3\n"},
    {},
    {"pool": "# HELP g a gauge\n# TYPE g gauge\ng 0.5\n\n",
     "1": "# HELP g a gauge\n# TYPE g gauge\ng{x=\"1\",y=\"2\"} 7\n",
     "0": "bare_line_without_value\nh_bucket{le=\"+Inf\"} 4\n"},
]


@pytest.mark.parametrize("texts", TEXTS, ids=["counters", "empty", "mixed"])
def test_merge_prometheus_equals_jax(texts):
    got = tpool.merge_prometheus(texts)
    assert got == jpool.merge_prometheus(texts)
    if texts:
        assert 'worker="' in got


def test_merge_prometheus_labels():
    merged = tpool.merge_prometheus(TEXTS[0]).splitlines()
    assert merged.count("# TYPE m counter") == 1
    assert 'm{worker="0"} 1' in merged
    assert 'n{worker="0",a="b"} 2' in merged
    assert 'm{worker="1"} 3' in merged


def test_pool_refuses_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="folder or a store_url"):
        tpool.ServePool()
    if tpool.has_reuse_port():
        with pytest.raises(ValueError, match="worker"):
            tpool.ServePool(str(tmp_path), workers=0)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool-folder")
    src, out = str(tmp / "src"), str(tmp / "out")
    make_synthetic_spool(src, n_files=3, file_duration=20.0, fs=50.0,
                         n_ch=8, noise=0.01)
    assert run_lowpass_realtime(
        source=src, output_folder=out, start_time=T0,
        output_sample_interval=1.0, edge_buffer=5.0, process_patch_size=20,
        poll_interval=0.0, sleep_fn=lambda _s: None, device="cpu",
        pyramid=True, health=True) == 1
    return out


@pytest.fixture(scope="module")
def fed_pool(folder):
    """(pool, producer hub, bridge): 2 workers subscribed to this
    process's bridge."""
    if not tpool.has_reuse_port():
        pytest.skip("SO_REUSEPORT unavailable on this platform")
    hub = thub.register_hub("pool-stream", os.path.abspath(folder))
    bridge = tsse.LiveBridge().start()
    pool = tpool.ServePool(folder, port=0, workers=2,
                           live_bridge=bridge.address)
    try:
        with pool:
            deadline = time.time() + TIMEOUT
            while len(bridge._conns) < 2 and time.time() < deadline:
                time.sleep(0.05)
            assert len(bridge._conns) == 2, "workers never subscribed"
            yield pool, hub, bridge
    finally:
        bridge.stop()
        thub.reset_hubs()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.read(), r.headers


@needs_reuse_port
def test_shared_port_serves_one_body(fed_pool):
    pool, _, _ = fed_pool
    url = (f"{pool.base_url}/query?t0=2023-03-22T00:00:08"
           "&t1=2023-03-22T00:00:40")
    bodies = {_get(url)[1] for _ in range(8)}
    assert len(bodies) == 1
    assert sorted(pool.worker_info) == [0, 1]
    assert all(i["data_port"] == pool.port and i["start_s"] > 0
               for i in pool.worker_info.values())


@needs_reuse_port
def test_control_plane_health_and_metrics(fed_pool):
    pool, _, _ = fed_pool
    _get(f"{pool.base_url}/healthz")
    for path in ("/healthz", "/pool/healthz"):
        status, body, _ = _get(pool.control_url + path)
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert sorted(health["workers"]) == ["0", "1"]
        assert health["counts"] == {"ok": 2, "dead": 0, "unreachable": 0}
        assert health["port"] == pool.port
    # a worker accounts for a request after its response is read
    deadline = time.time() + TIMEOUT
    while True:
        text = _get(pool.control_url + "/metrics")[1].decode()
        if "tpudas_serve_requests_total" in text or time.time() > deadline:
            break
        time.sleep(0.05)
    for w in ("0", "1", "pool"):
        assert f'worker="{w}"' in text
    assert "tpudas_serve_requests_total" in text
    assert "tpudas_serve_pool_workers" in text
    samples = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")]
    assert samples and all('{worker="' in ln for ln in samples)
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(pool.control_url + "/nope")
    assert err.value.code == 404


@needs_reuse_port
def test_pool_rollup_reads_port_pool(fed_pool):
    pool, _, _ = fed_pool
    got = tcollect.pool_rollup(pool.control_url)
    assert got["status"] == "ok" and sorted(got["workers"]) == ["0", "1"]
    assert got["url"] == pool.control_url + "/pool/healthz"
    jgot = jcollect.pool_rollup(pool.control_url)
    assert jgot["status"] == "ok"
    assert sorted(jgot["workers"]) == sorted(got["workers"])
    snap = tcollect.cluster_snapshot(pool_url=pool.control_url)
    assert snap["pool"]["status"] == "ok" and snap["status"] == "ok"


@needs_reuse_port
def test_live_over_the_pool_equals_producer_ring(fed_pool):
    """Frames published in this process reach a ``/live`` subscriber on
    the pool's shared port through the bridge, equal to the producer's
    ring."""
    from test_torch_live import _read_sse, _round_rows

    pool, hub, _ = fed_pool
    seq0 = hub.seq
    for i in range(seq0 + 1, seq0 + 4):
        fr = thub.LiveFrame(i, i, *_round_rows(i), [], 10**9)
        with hub._lock:
            hub.seq = fr.seq
            hub._ring.append(fr)
        hub._fanout(fr)
    ring = {f.seq: f for f in list(hub._ring)}
    # each worker mirrors every frame; whichever answers replays them.
    # A worker the bridge has not reached yet has no hub: 503 with
    # Retry-After, so ask again
    for _ in range(2):
        deadline = time.time() + TIMEOUT
        while True:
            try:
                events = _read_sse(
                    f"{pool.base_url}/live?window=0&heartbeat=0.2"
                    f"&last_id={seq0}", want_events=4, timeout=10)
            except urllib.error.HTTPError as exc:
                assert exc.code == 503 and time.time() < deadline, exc
                exc.close()
                time.sleep(0.1)
                continue
            deltas = [d for ev, _i, d in events if ev == "delta"]
            if len(deltas) == 3 or time.time() > deadline:
                break
            time.sleep(0.1)
        assert [d["seq"] for d in deltas] == [seq0 + 1, seq0 + 2, seq0 + 3]
        for d in deltas:
            np.testing.assert_array_equal(
                decode_tile(base64.b64decode(d["blob"])),
                ring[d["seq"]].level_array(0))
            assert base64.b64decode(d["blob"]) == ring[d["seq"]].payload(0)


def test_serve_pool_cli_entry_point(monkeypatch, tmp_path):
    """``tpudas_torch/tools/serve_pool.py`` is the pool's ``main``; its
    ``--store-url`` (with ``--store-prefix``, ``--cache-dir``,
    ``--cache-bytes``) reaches ``ServePool`` as the JAX CLI's does, and
    ``--store-url`` with ``--fleet`` is a usage error."""
    from tpudas_torch.tools import serve_pool

    made = {}

    class _Stop(Exception):
        pass

    class _Recorder:
        def __init__(self, folder, **kw):
            made.update(kw, folder=folder)

        def __enter__(self):
            raise _Stop

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tpool, "ServePool", _Recorder)
    with pytest.raises(_Stop):
        tpool.main([str(tmp_path), "--store-url", "file:///n",
                    "--store-prefix", "streams/a", "--cache-dir",
                    str(tmp_path / "c"), "--cache-bytes", "1000"])
    assert made["store_url"] == "file:///n"
    assert made["store_prefix"] == "streams/a"
    assert made["cache_dir"] == str(tmp_path / "c")
    assert made["cache_bytes"] == 1000
    with pytest.raises(SystemExit):
        tpool.main([str(tmp_path), "--store-url", "file:///n", "--fleet"])
    seen = {}
    monkeypatch.setattr(tpool, "main",
                        lambda argv=None: seen.setdefault("argv", argv) and 0)
    assert serve_pool.main(["x", "--workers", "1"]) == 0
    assert seen["argv"] == ["x", "--workers", "1"]


@needs_reuse_port
def test_store_pool_answers_as_the_store_server(folder, tmp_path):
    """A 1-worker pool over an object store (``store_url``): the worker
    hydrates its own mirror and cache and answers ``/query`` and
    ``/tile`` with the bytes of an in-process ``DASServer`` over the
    same store (and of a server over the published folder)."""
    from tpudas_torch.serve.http import DASServer
    from tpudas_torch.store import PosixStore, PyramidPublisher

    bucket = str(tmp_path / "bucket")
    assert PyramidPublisher(PosixStore(bucket), "s/a", folder).publish()
    url = f"file://{bucket}"
    tails = ["/query?t0=2023-03-22T00:00:08&t1=2023-03-22T00:00:40"
             "&resolution=4", "/tile?level=0&idx=0"]
    with DASServer(store_url=url, store_prefix="s/a", port=0,
                   cache_dir=str(tmp_path / "c0")) as one, \
            DASServer(folder, port=0) as local:
        want = [_get(one.base_url + t)[1] for t in tails]
        assert want == [_get(local.base_url + t)[1] for t in tails]
    pool = tpool.ServePool(None, port=0, workers=1, store_url=url,
                           store_prefix="s/a",
                           cache_dir=str(tmp_path / "cache"))
    with pool:
        assert [_get(pool.base_url + t)[1] for t in tails] == want
        health = json.loads(_get(f"{pool.base_url}/healthz")[1])
        assert health["store"]["status"] == "ok"
    # each worker hydrated its own cache directory
    assert os.path.isdir(str(tmp_path / "cache" / "worker0"))


class TestServePoolRespawn:
    @pytest.mark.slow
    @needs_reuse_port
    def test_dead_worker_is_respawned(self, folder):
        pool = tpool.ServePool(folder, port=0, workers=2,
                               restart_backoff=0.05)
        with pool:
            assert pool.health()["status"] == "ok"
            victim = pool.worker_info[0]["pid"]
            os.kill(victim, signal.SIGKILL)
            deadline = time.time() + TIMEOUT
            while time.time() < deadline:
                h = pool.health()
                if h["status"] == "ok" and h["workers"]["0"]["pid"] != victim:
                    break
                time.sleep(0.1)
            else:
                pytest.fail(f"worker 0 never respawned: {pool.health()}")
            assert pool.restart_counts() == {0: 1}
            text = _get(pool.control_url + "/metrics")[1].decode()
            assert "tpudas_serve_pool_worker_restarts_total" in text

    @pytest.mark.slow
    @needs_reuse_port
    def test_restarts_are_bounded(self, tmp_path):
        out = str(tmp_path / "store")
        os.makedirs(out)
        pool = tpool.ServePool(out, port=0, workers=1,
                               restart_backoff=0.01, max_restarts=2)
        with pool:
            deadline = time.time() + TIMEOUT
            while time.time() < deadline:
                if pool.restart_counts().get(0, 0) >= 2:
                    break
                try:
                    os.kill(pool.worker_info[0]["pid"], signal.SIGKILL)
                except ProcessLookupError:
                    pass
                time.sleep(0.1)
            time.sleep(0.6)
            assert pool.restart_counts().get(0, 0) == 2
            assert pool.health()["status"] == "degraded"
