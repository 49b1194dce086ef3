"""The port's HTTP server (tpudas_torch.serve.http) against the JAX one.

Two output folders are written once, at 8 channels: one by the port's
``run_lowpass_realtime`` (a ``bitshuffle-deflate`` pyramid), one by the
JAX package's (a raw pyramid), each over two rounds with the pyramid
(8-row tiles), detection, health and the flight ring on.  A JAX
``DASServer`` and a port ``DASServer`` mount the same folders (the port
folder on the bare endpoints, both under ``/s/<id>/``), and a table of
requests goes to both: every endpoint, bare and mounted, 400s, 404s,
503s (no live producer; a ``FaultPlan`` at ``serve.queue_full`` in both
packages), 304s, ``deflate`` and ``x-tpt``.  Status, body bytes and
every header are equal, except ``Date``, the one field that reads the
wall clock.  The tolerance is exact: the same bytes on disk go through
the same host arithmetic.

The two packages count into their own registries, so ``/metrics`` is
compared by its ``tpudas_serve_*`` families after the same request
sequence (names, help, label sets, counter values, histogram counts).
``/devprof`` and ``/profile`` answer 501 in the port (the device
telemetry is ROADMAP A9).  A ``file://`` store holding the port folder's
published pyramid is mounted by both packages' ``store_url`` servers:
their pyramid answers, ``/tile`` and ``/healthz`` ``store`` block agree
with each other and with a server over the folder itself.

The rest ports the JAX server's own tests against the port: ``TestHTTP``
of ``tests/test_serve.py``, the ``/tile`` / ETag / deflate cases of
``tests/test_codec.py``, ``/events`` of ``tests/test_detect.py``, the
fleet routes of ``tests/test_fleet.py`` and ``/trace`` / ``/slo`` of
``tests/test_obs_flight.py``.  Everything runs on the CPU.
"""

import glob
import io
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.resilience import faults as jfaults
from tpudas.serve import http as jhttp
from tpudas.testing import make_synthetic_spool
from tpudas_torch.codec import decode_tile, verify_tile_blob
from tpudas_torch.detect.ledger import ScoreStore, load_events, write_events
from tpudas_torch.obs.health import read_health, write_health
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.resilience import FaultPlan, FaultSpec, install_fault_plan
from tpudas_torch.serve import http as thttp
from tpudas_torch.serve.query import QueryEngine
from tpudas_torch.serve.tiles import TileStore, sync_pyramid

T0 = "2023-03-22T00:00:00"
FS = 50.0
FILE_SEC = 20.0
NCH = 8
OPS = (
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5, "baseline": 20.0}),
)
PARAMS = dict(start_time=T0, output_sample_interval=1.0, edge_buffer=5.0,
              process_patch_size=20, poll_interval=0.0, file_duration=0.0)
TIMEOUT = 30
# the one response field that reads the wall clock
WALL_CLOCK_HEADERS = ("Date",)
W0 = "2023-03-22T00:00:10"
W1 = "2023-03-22T00:01:00"


def _link(pool, src, upto):
    os.makedirs(src, exist_ok=True)
    for name in sorted(n for n in os.listdir(pool) if n.endswith(".h5"))[
            :upto]:
        if not os.path.exists(os.path.join(src, name)):
            os.link(os.path.join(pool, name), os.path.join(src, name))


def _drive(driver, pool, src, out, first=3, then=(4,), **kw):
    """Link ``first`` files, run the driver; each sleep links up to the
    next count in ``then`` (one more round each)."""
    _link(pool, src, first)
    feeds = list(then)

    def sleep(_):
        if feeds:
            _link(pool, src, feeds.pop(0))

    if driver is run_lowpass_realtime:
        kw.setdefault("device", "cpu")
    return driver(source=src, output_folder=out, sleep_fn=sleep,
                  **PARAMS, **kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool-serve")
    make_synthetic_spool(d, n_files=4, file_duration=FILE_SEC, fs=FS,
                         n_ch=NCH, noise=0.01)
    return str(d)


@pytest.fixture(scope="module")
def folders(pool, tmp_path_factory):
    """{"pw": port-written folder, "jw": JAX-written folder}."""
    tmp = tmp_path_factory.mktemp("serve-folders")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
        mp.setenv("TPUDAS_DEVPROF", "0")
        common = dict(pyramid=True, detect=True, detect_operators=OPS,
                      health=True, flight=None)
        mp.setenv("TPUDAS_CODEC", "bitshuffle-deflate")
        out["pw"] = str(tmp / "root" / "pw")
        assert _drive(run_lowpass_realtime, pool, str(tmp / "src-pw"),
                      out["pw"], **common) == 2
        mp.delenv("TPUDAS_CODEC")
        out["jw"] = str(tmp / "root" / "jw")
        assert _drive(jax_realtime, pool, str(tmp / "src-jw"), out["jw"],
                      **common) == 2
    assert TileStore.open(out["pw"]).codec == "bitshuffle-deflate"
    assert TileStore.open(out["jw"]).codec is None
    return out


@pytest.fixture(scope="module")
def servers(folders):
    """(port server, JAX server), each with the port folder on the bare
    endpoints and both folders under /s/<id>/."""
    kw = dict(folder=folders["pw"], streams=dict(folders), port=0)
    with thttp.DASServer(**kw) as port, jhttp.DASServer(**kw) as jaxs:
        yield port, jaxs


def _get(url, headers=()):
    """(status, body, headers) of one GET; an error status is a result."""
    req = urllib.request.Request(url)
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read(), exc.headers


def _headers(h) -> dict:
    return {k: v for k, v in h.items() if k not in WALL_CLOCK_HEADERS}


def _both(servers, tail, headers=()):
    (p, j) = servers
    a = _get(p.base_url + tail, headers)
    b = _get(j.base_url + tail, headers)
    assert a[0] == b[0], (tail, a[0], b[0], a[1][:300], b[1][:300])
    assert a[1] == b[1], (tail, a[1][:300], b[1][:300])
    assert _headers(a[2]) == _headers(b[2]), tail
    return a


# (name, path, request headers, expected status); every row is sent to
# the bare endpoints (the port folder) and under /s/pw and /s/jw
_WIN = f"t0={W0}&t1={W1}"
_DEFLATE = (("Accept-Encoding", "deflate"),)
_TPT = (("Accept-Encoding", "x-tpt"),)
MOUNTED = [
    ("query-npy", f"/query?{_WIN}", (), 200),
    ("query-json", f"/query?{_WIN}&format=json", (), 200),
    ("query-deflate", f"/query?{_WIN}", _DEFLATE, 200),
    ("query-json-deflate", f"/query?{_WIN}&format=json", _DEFLATE, 200),
    ("query-deflate-q0", f"/query?{_WIN}",
     (("Accept-Encoding", "gzip, deflate;q=0"),), 200),
    ("query-ns", "/query?t0=1679443210000000000&t1=1679443240000000000",
     (), 200),
    ("query-distance", f"/query?{_WIN}&d0=2&d1=5", (), 200),
    ("query-resolution", f"/query?{_WIN}&resolution=4", (), 200),
    ("query-max-samples", f"/query?{_WIN}&max_samples=4&agg=max", (), 200),
    ("query-min", f"/query?{_WIN}&resolution=16&agg=min", (), 200),
    ("query-immutable", "/query?t0=2023-03-22T00:00:00"
     "&t1=2023-03-22T00:00:05", (), 200),
    ("query-beyond-head", "/query?t0=2023-03-22T01:00:00"
     "&t1=2023-03-22T01:00:10", (), 200),
    ("query-missing-t1", f"/query?t0={W0}", (), 400),
    ("query-bad-time", "/query?t0=yesterday&t1=today", (), 400),
    ("waterfall", f"/waterfall?{_WIN}&max_px=8", (), 200),
    ("waterfall-deflate", f"/waterfall?{_WIN}&max_px=4", _DEFLATE, 200),
    ("tile-l0", "/tile?level=0&idx=0", (), 200),
    ("tile-l0-tpt", "/tile?level=0&idx=1", _TPT, 200),
    ("tile-l1", "/tile?level=1&idx=0", (), 200),
    ("tile-head", "/tile?level=0&idx=5", (), 200),
    ("tile-beyond", "/tile?level=0&idx=10000", (), 404),
    ("tile-missing-idx", "/tile?level=0", (), 400),
    ("tile-negative", "/tile?level=0&idx=-1", (), 400),
    ("events", "/events", (), 200),
    ("events-scores", "/events?scores=1", (), 200),
    ("events-filtered", "/events?min_score=2.2&op=stalta", (), 200),
    ("events-channels-scores", "/events?scores=1&scores_limit=3&c0=1&c1=2",
     (), 200),
    ("events-window", f"/events?{_WIN}&limit=3&kind=on", (), 200),
    ("events-limit-0", "/events?limit=0", (), 400),
    ("events-scores-limit-0", "/events?scores=1&scores_limit=0", (), 400),
    ("healthz", "/healthz", (), 200),
    ("trace-round", "/trace?kind=round", (), 200),
    ("trace-span", "/trace?limit=5", (), 200),
    ("trace-named", "/trace?name=stream.round&limit=2", (), 200),
    ("trace-limit-0", "/trace?limit=0", (), 400),
    ("slo", "/slo", (), 200),
    ("slo-policy", "/slo?target=150&objective=0.9&window=5", (), 200),
    ("slo-window-0", "/slo?window=0", (), 400),
    ("slo-objective-2", "/slo?objective=2", (), 400),
    ("live-no-producer", "/live", (), 503),
    ("unknown-endpoint", "/nope", (), 404),
]
PREFIXES = {"bare": "", "s-pw": "/s/pw", "s-jw": "/s/jw"}
SERVER_WIDE = [
    ("fleet-healthz", "/fleet/healthz", (), 200),
    ("unknown-stream", f"/s/nope/query?{_WIN}", (), 404),
    ("unknown-stream-live", "/s/nope/live", (), 404),
    ("slo-fleet", "/slo?target=150", (), 200),
]


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
@pytest.mark.parametrize("row", MOUNTED, ids=[r[0] for r in MOUNTED])
def test_request_table(servers, prefix, row):
    """Each request to the port and the JAX server over one folder:
    equal status, body bytes and headers (``Date`` aside)."""
    _name, path, headers, status = row
    got = _both(servers, PREFIXES[prefix] + path, headers)
    assert got[0] == status, (path, got[1][:300])


@pytest.mark.parametrize("row", SERVER_WIDE, ids=[r[0] for r in SERVER_WIDE])
def test_server_wide_table(servers, row):
    _name, path, headers, status = row
    got = _both(servers, path, headers)
    assert got[0] == status, (path, got[1][:300])


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
@pytest.mark.parametrize("path,headers", [
    (f"/query?{_WIN}", ()),
    (f"/query?{_WIN}", _DEFLATE),
    ("/tile?level=0&idx=0", _TPT),
    ("/tile?level=0&idx=5", ()),
    ("/events", ()),
], ids=["query", "query-deflate", "tile-tpt", "tile-head", "events"])
def test_conditional_get_304(servers, prefix, path, headers):
    """``If-None-Match`` with the representation's ETag: an empty 304
    from both servers, with the same headers."""
    tail = PREFIXES[prefix] + path
    first = _both(servers, tail, headers)
    assert first[0] == 200
    etag = first[2]["ETag"]
    got = _both(servers, tail, headers + (("If-None-Match", etag),))
    assert got[0] == 304 and got[1] == b""
    assert got[2]["ETag"] == etag


def test_table_exercises_headers(servers, folders):
    """The table's headers are the ones the JAX server promises:
    immutable vs no-cache, deflate over 256 B, x-tpt on a compressed
    store only, provenance headers."""
    p, _ = servers
    imm = "public, max-age=31536000, immutable"
    _, _, h = _get(p.base_url + "/query?t0=2023-03-22T00:00:00"
                   "&t1=2023-03-22T00:00:05")
    assert h["Cache-Control"] == imm and h["X-Tpudas-Source"] == "tiles"
    _, _, h = _get(p.base_url + f"/query?{_WIN}", _DEFLATE)
    assert h["Content-Encoding"] == "deflate" and h["Vary"]
    _, body, h = _get(p.base_url + "/tile?level=0&idx=1", _TPT)
    assert h["Content-Encoding"] == "x-tpt" and verify_tile_blob(body) == "ok"
    _, _, h = _get(p.base_url + "/s/jw/tile?level=0&idx=1", _TPT)
    assert h.get("Content-Encoding") is None  # raw store: plain npy
    _, _, h = _get(p.base_url + "/tile?level=0&idx=5")
    assert h["Cache-Control"] == "no-cache"
    _, _, h = _get(p.base_url + "/live")
    assert h["Retry-After"] == "5"


@pytest.mark.parametrize("prefix", ["", "/s/jw"])
def test_queue_full_503_in_both(servers, prefix):
    """A ``FaultPlan`` at ``serve.queue_full`` in each package: one 503
    with ``Retry-After: 1`` from both, the control plane still
    answering, then the retried request succeeds in both."""
    tail = prefix + f"/query?{_WIN}"
    spec = dict(site="serve.queue_full", action="raise", at=1, times=1)
    with install_fault_plan(FaultPlan(FaultSpec(**spec))), \
            jfaults.install_fault_plan(jfaults.FaultPlan(
                jfaults.FaultSpec(**spec))):
        shed = _both(servers, tail)
        assert shed[0] == 503 and shed[2]["Retry-After"] == "1"
        assert _both(servers, prefix + "/healthz")[0] == 200
        assert _both(servers, tail)[0] == 200


def _families(text: str) -> dict:
    """{family: (help, type, {(sample name, labels without le): value
    or None})} of the ``tpudas_serve_*`` / ``tpudas_live_*`` families;
    histogram sums and buckets (timing) keep only their label sets."""
    fams: dict = {}
    meta: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_ = line[7:].partition(" ")
            meta.setdefault(name, {})["help"] = help_
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            meta.setdefault(name, {})["type"] = kind
        elif line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            sname, _, labels = head.partition("{")
            labels = ",".join(
                kv for kv in labels.rstrip("}").split(",")
                if kv and not kv.startswith("le="))
            fam = next((m for m in meta if sname == m
                        or sname.startswith(m + "_")), sname)
            timed = meta.get(fam, {}).get("type") == "histogram" and (
                not sname.endswith("_count"))
            fams.setdefault(fam, set()).add(
                (sname, labels, None if timed else float(value)))
    return {
        f: (meta[f].get("help"), meta[f].get("type"), samples)
        for f, samples in fams.items()
        if f.startswith(("tpudas_serve_", "tpudas_live_"))
    }


def test_metrics_families_equal(servers):
    """The same request sequence counted into a fresh registry of each
    package: the ``tpudas_serve_*`` families agree in names, help,
    label sets, counter values and histogram counts."""
    from tpudas.obs import registry as jreg

    seq = [
        (f"/query?{_WIN}", ()), (f"/query?{_WIN}", _DEFLATE),
        ("/tile?level=0&idx=0", _TPT), ("/events?scores=1", ()),
        ("/events?limit=0", ()), ("/s/jw/waterfall?" + _WIN, ()),
        ("/s/nope/query", ()), ("/healthz", ()), ("/slo", ()),
    ]
    with use_registry(MetricsRegistry()) as preg, \
            jreg.use_registry(jreg.MetricsRegistry()) as jr:
        etags = []
        for tail, headers in seq:
            etags.append(_both(servers, tail, headers)[2].get("ETag"))
        # a 304 counts in tpudas_serve_not_modified_total
        _both(servers, f"/query?{_WIN}", (("If-None-Match", etags[0]),))
        # a handler accounts for its request after the client has read
        # the response: wait for every request in both registries
        deadline = time.time() + TIMEOUT
        while True:
            ptext, jtext = preg.to_prometheus(), jr.to_prometheus()
            done = [sum(v for name, _l, v in _families(text).get(
                "tpudas_serve_requests_total", (0, 0, ()))[2]
                if name == "tpudas_serve_requests_total")
                for text in (ptext, jtext)]
            if done == [len(seq) + 1] * 2 or time.time() > deadline:
                break
            time.sleep(0.01)
    got, want = _families(ptext), _families(jtext)
    assert got == want
    assert {"tpudas_serve_requests_total", "tpudas_serve_request_seconds",
            "tpudas_serve_not_modified_total",
            "tpudas_serve_events_queries_total"} <= set(got)


def test_metrics_endpoint_is_the_live_registry(servers):
    p, _ = servers
    with use_registry(MetricsRegistry()):
        _get(p.base_url + "/query?t0=2023-03-22T00:00:10"
             "&t1=2023-03-22T00:00:20")
        # the handler accounts for a request after its response is read
        deadline = time.time() + TIMEOUT
        while True:
            status, body, h = _get(p.base_url + "/metrics")
            text = body.decode()
            if 'endpoint="/query"' in text or time.time() > deadline:
                break
            time.sleep(0.01)
    assert status == 200 and h["Content-Type"].startswith("text/plain")
    assert "# TYPE tpudas_serve_requests_total counter" in text
    assert 'endpoint="/query"' in text


@pytest.mark.parametrize("endpoint", ["/devprof", "/profile",
                                      "/profile?seconds=1"])
def test_devprof_and_profile_answer_501(servers, endpoint):
    """Documented difference (ROADMAP C): the device telemetry is not
    ported, so the port answers 501 naming A9 where the JAX server
    serves its devprof snapshot."""
    p, _ = servers
    status, body, _ = _get(p.base_url + endpoint)
    assert status == 501
    assert "ROADMAP A9" in json.loads(body)["error"]


def test_store_url_refused(folders, store_servers):
    """Object-store serving is ported: ``store_url`` mounts a remote
    pyramid in the server (a mirror folder, or a private one) and the
    pool takes it too; a server still needs a folder, streams or a
    store URL."""
    from tpudas_torch.serve import pool as tpool

    p, j, _local, _bucket = store_servers
    assert p.remote is not None and j.remote is not None
    assert p._httpd.mount.remote is p.remote
    assert os.path.isdir(p.folder)
    if tpool.has_reuse_port():
        pool = tpool.ServePool(folders["pw"], store_url="file:///nowhere")
        assert pool._cfg["store_url"] == "file:///nowhere"
    with pytest.raises(ValueError, match="folder, streams"):
        thttp.DASServer()


@pytest.fixture(scope="module")
def store_servers(folders, tmp_path_factory):
    """(port store server, JAX store server, port local server, bucket):
    the port folder's pyramid published by the port's
    ``PyramidPublisher`` into a ``file://`` store, mounted by both
    packages' ``DASServer(store_url=...)`` (each with its own cache
    directory), beside a port server over the folder itself."""
    from tpudas_torch.store import PosixStore, PyramidPublisher

    tmp = tmp_path_factory.mktemp("store-mount")
    bucket = str(tmp / "bucket")
    assert PyramidPublisher(
        PosixStore(bucket), "streams/pw", folders["pw"]).publish()["tiles"]
    kw = dict(store_url=f"file://{bucket}", store_prefix="streams/pw",
              port=0, store_refresh_s=0.0)
    with thttp.DASServer(cache_dir=str(tmp / "pc"), **kw) as port, \
            jhttp.DASServer(cache_dir=str(tmp / "jc"), **kw) as jaxs, \
            thttp.DASServer(folders["pw"], port=0) as local:
        yield port, jaxs, local, bucket


# requests whose answers come from the pyramid alone (a remote mount
# holds no output files): the store servers answer them as the JAX
# store server does, and as a server over the local folder does
STORE_ROWS = [
    ("query-resolution", f"/query?{_WIN}&resolution=4", ()),
    ("query-max-samples", f"/query?{_WIN}&max_samples=4&agg=max", ()),
    ("query-min", f"/query?{_WIN}&resolution=16&agg=min", ()),
    ("query-json", f"/query?{_WIN}&resolution=4&format=json", ()),
    ("query-deflate", f"/query?{_WIN}&resolution=4",
     (("Accept-Encoding", "deflate"),)),
    ("waterfall", f"/waterfall?{_WIN}&max_px=4", ()),
    ("tile-l0", "/tile?level=0&idx=0", ()),
    ("tile-l0-tpt", "/tile?level=0&idx=1", (("Accept-Encoding", "x-tpt"),)),
    ("tile-l1", "/tile?level=1&idx=0", ()),
    ("tile-head", "/tile?level=0&idx=5", ()),
    ("tile-beyond", "/tile?level=0&idx=10000", ()),
]


@pytest.mark.parametrize("name,tail,headers", STORE_ROWS,
                         ids=[r[0] for r in STORE_ROWS])
def test_store_mount_equals_jax_and_local(store_servers, name, tail,
                                          headers):
    p, j, local, _bucket = store_servers
    a = _get(p.base_url + tail, headers)
    b = _get(j.base_url + tail, headers)
    c = _get(local.base_url + tail, headers)
    assert a[0] == b[0] == c[0], (name, a[0], b[0], c[0], a[1][:300])
    assert a[1] == b[1], name
    assert _headers(a[2]) == _headers(b[2]), name
    assert a[1] == c[1], name


def test_store_healthz_block_equals_jax(store_servers):
    """A serving replica has no realtime health snapshot: ``/healthz``
    answers from its ``store`` block, with the JAX server's keys and
    status."""
    p, j, _local, _bucket = store_servers
    a, b = _get(p.base_url + "/healthz"), _get(j.base_url + "/healthz")
    assert a[0] == b[0] == 200
    pa, pb = json.loads(a[1]), json.loads(b[1])
    assert pa["status"] == pb["status"] == "ok"
    assert pa["detail"] == pb["detail"]
    assert sorted(pa["store"]) == sorted(pb["store"])
    assert pa["store"]["status"] == pb["store"]["status"] == "ok"
    assert sorted(pa["store"]["cache"]) == sorted(pb["store"]["cache"])


def test_store_mount_degrades_then_recovers(store_servers, tmp_path):
    """The cold tier goes away: the mirror keeps serving the same bytes
    and ``/healthz`` says ``degraded``, in both packages; back, ``ok``."""
    p, j, _local, bucket = store_servers
    tail = f"/query?{_WIN}&resolution=4"
    before = _get(p.base_url + tail)[1]
    os.rename(bucket, bucket + ".away")
    try:
        with open(bucket, "w") as fh:
            fh.write("not a directory\n")
        for srv in (p, j):
            status, body, _ = _get(srv.base_url + tail)
            assert status == 200 and body == before
            health = json.loads(_get(srv.base_url + "/healthz")[1])
            assert health["status"] == "degraded", health
    finally:
        os.remove(bucket)
        os.rename(bucket + ".away", bucket)
    for srv in (p, j):
        assert _get(srv.base_url + tail)[1] == before
        health = json.loads(_get(srv.base_url + "/healthz")[1])
        assert health["status"] == "ok", health


def test_mount_is_never_remote(servers):
    p, _ = servers
    assert p.remote is None
    assert p._httpd.mount.remote is None
    assert all(m.remote is None for m in p.mounts.values())


def test_serve_package_factories(folders):
    """``tpudas_torch.serve``'s lazy factories are the real ones now."""
    from tpudas_torch import serve

    srv = serve.start_server(folders["pw"], port=0)
    try:
        status, _, _ = _get(srv.base_url + "/healthz")
        assert status == 200
        assert isinstance(srv, thttp.DASServer)
    finally:
        srv.stop()


def test_serve_forever_stops_on_interrupt(folders, monkeypatch, capsys):
    """The blocking operator entry point prints its address, serves,
    and closes on Ctrl-C, as the JAX one does."""
    def interrupt(self, *a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(thttp._Server, "serve_forever", interrupt)
    thttp.serve_forever(folders["pw"], host="127.0.0.1", port=0)
    thttp.serve_forever(os.path.dirname(folders["pw"]), host="127.0.0.1",
                        port=0, fleet=True)
    out = capsys.readouterr().out
    assert "tpudas_torch.serve listening on http://127.0.0.1:" in out
    assert "streams: jw, pw" in out and out.count("shutting down") == 2


def test_reuse_port_and_backlog(folders):
    """``SO_REUSEPORT`` lets two servers bind one port (the pool's
    mechanism); the listen backlog is 128."""
    a = thttp.DASServer(folders["pw"], port=0, reuse_port=True)
    try:
        port = a.address[1]
        b = thttp.DASServer(folders["pw"], port=port, reuse_port=True)
        b._httpd.server_close()
        assert a._httpd.request_queue_size == 128
    finally:
        a._httpd.server_close()


# ---------------------------------------------------------------------------
# tests/test_serve.py TestHTTP, against the port


def test_end_to_end_demo(folders, tmp_path):
    """/query and /waterfall over the streamed folder are byte-identical
    to an offline recomputation from the raw output files."""
    out = folders["pw"]
    offline = str(tmp_path / "offline")
    os.makedirs(offline)
    for f in glob.glob(os.path.join(out, "*.h5")):
        shutil.copy(f, offline)
    sync_pyramid(offline)
    off_eng = QueryEngine(offline)
    store = TileStore.open(out)
    t0s = str(np.datetime64(store.t0_ns, "ns"))
    t1s = str(np.datetime64(store.head_ns - store.step_ns, "ns"))
    with thttp.start_server(out) as srv:
        status, served, h = _get(f"{srv.base_url}/query?t0={t0s}&t1={t1s}")
        assert status == 200 and h["X-Tpudas-Source"] == "tiles"
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(off_eng.query(t0s, t1s).data))
        assert served == buf.getvalue()
        status, served_wf, h = _get(
            f"{srv.base_url}/waterfall?t0={t0s}&t1={t1s}&max_px=8")
        assert int(h["X-Tpudas-Level"]) >= 1
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(
            off_eng.query(t0s, t1s, max_samples=8).data))
        assert served_wf == buf.getvalue()


def test_healthz_serves_live_health_json(tmp_path):
    out = str(tmp_path / "h")
    os.makedirs(out)
    with thttp.start_server(out) as srv:
        status, body, _ = _get(srv.base_url + "/healthz")
        assert status == 503 and json.loads(body)["status"] == "unknown"
        write_health(out, {
            "rounds": 2, "polls": 3, "mode": "stateful",
            "realtime_factor": 10.0, "round_realtime_factor": 9.0,
            "head_lag_seconds": 1.0, "redundant_ratio": 0.0,
            "carry_resume_count": 0, "last_round_wall_seconds": 0.1,
            "consecutive_failures": 0, "quarantined_files": 0,
            "degraded": False, "integrity_fallbacks": 0,
            "resource_degraded": False, "last_error": None,
        })
        status, body, _ = _get(srv.base_url + "/healthz")
        body = json.loads(body)
        assert status == 200 and body["status"] == "ok"
        assert body["rounds"] == 2 and read_health(out)["rounds"] == 2


def test_real_saturation_sheds(folders):
    """A genuinely full gate (max_inflight=1, leader parked inside a
    tile read) sheds the second concurrent data request."""
    release, entered = threading.Event(), threading.Event()

    def park(_):
        entered.set()
        release.wait(timeout=30)

    plan = FaultPlan(FaultSpec(site="serve.tile_read", action="delay",
                               at=1, times=1, seconds=0.0, sleep_fn=park))
    codes = []
    with install_fault_plan(plan), thttp.start_server(
            folders["pw"], max_inflight=1, cache_tiles=4) as srv:
        url = srv.base_url + f"/query?{_WIN}"
        t = threading.Thread(target=lambda: codes.append(_get(url)[0]))
        t.start()
        assert entered.wait(timeout=30)
        assert _get(url)[0] == 503
        release.set()
        t.join(timeout=30)
    assert codes == [200]


# ---------------------------------------------------------------------------
# tests/test_codec.py TestHTTPCaching, against the port


def test_compressed_store_http_byte_identity(folders, tmp_path):
    """The same outputs under a raw and a lossless compressed pyramid:
    /query, its JSON and /waterfall are byte-identical."""
    raw, comp = str(tmp_path / "raw"), str(tmp_path / "comp")
    os.makedirs(raw)
    for f in glob.glob(os.path.join(folders["pw"], "LFDAS_*.h5")):
        shutil.copy(f, raw)
    shutil.copytree(raw, comp)
    sync_pyramid(raw, tile_len=8)
    sync_pyramid(comp, tile_len=8, codec="bitshuffle-deflate")
    with thttp.start_server(raw) as a, thttp.start_server(comp) as b:
        for tail in (f"/query?{_WIN}", f"/query?{_WIN}&format=json",
                     f"/waterfall?{_WIN}&max_px=8"):
            ra, rb = _get(a.base_url + tail), _get(b.base_url + tail)
            assert ra[1] == rb[1], tail
            assert ra[2]["X-Tpudas-Source"] == rb[2]["X-Tpudas-Source"]


def test_tile_endpoint_and_torn_tile(folders, tmp_path):
    comp = str(tmp_path / "comp")
    shutil.copytree(folders["pw"], comp)
    store = TileStore.open(comp)
    with thttp.start_server(comp) as srv:
        status, body, h = _get(srv.base_url + "/tile?level=0&idx=0")
        assert h["X-Tpudas-Codec"] == "bitshuffle-deflate"
        arr = np.load(io.BytesIO(body))
        np.testing.assert_array_equal(arr, store.read(0, 0, store.tile_len))
        _, blob, h = _get(srv.base_url + "/tile?level=0&idx=0", _TPT)
        np.testing.assert_array_equal(decode_tile(blob), arr)
        # a tile that fails its crc is a 500, never an immutable body
        with open(store.tile_blob_path(0, 0), "r+b") as fh:
            fh.seek(-4, 2)
            fh.write(b"\x00\x00\x00\x00")
        for hdrs in ((), _TPT):
            assert _get(srv.base_url + "/tile?level=0&idx=0", hdrs)[0] == 500


def test_deflate_negotiation(servers):
    p, _ = servers
    _, body, h = _get(p.base_url + f"/query?{_WIN}")
    assert h.get("Content-Encoding") is None
    assert h["Vary"] == "Accept-Encoding"
    _, enc, h = _get(p.base_url + f"/query?{_WIN}", _DEFLATE)
    assert h["Content-Encoding"] == "deflate"
    assert zlib.decompress(enc) == body


# ---------------------------------------------------------------------------
# tests/test_detect.py TestEventsEndpoint, against the port


def _json(srv, tail):
    status, body, h = _get(srv.base_url + tail)
    return status, json.loads(body), h


def test_events_verified_and_filtered(servers, folders):
    p, _ = servers
    out = folders["pw"]
    evs = load_events(out)
    assert len(evs) >= 4
    status, body, h = _json(p, "/events")
    assert status == 200 and body["events"] == evs
    assert body["ledger_events"] == len(evs)
    assert h["X-Tpudas-Events-Total"] == str(len(evs))
    _, body, _ = _json(p, "/events?min_score=2.2&op=stalta")
    assert all(e["score"] >= 2.2 and e["op"] == "stalta"
               for e in body["events"])
    _, body, _ = _json(p, "/events?c0=1&c1=2")
    assert all(1 <= e["channel"] <= 2 for e in body["events"])
    _, body, _ = _json(p, "/events?limit=2")
    assert body["events"] == evs[-2:]  # newest kept
    t_mid = evs[len(evs) // 2]["t_ns"]
    _, body, _ = _json(p, f"/events?t0={t_mid}")
    assert all(e["t_ns"] >= t_mid for e in body["events"])


def test_events_scores_window_and_limit(servers, folders):
    p, _ = servers
    store = ScoreStore.open(folders["pw"])
    assert store.n_rows > 3
    _, body, _ = _json(p, "/events?scores=1&c0=1&c1=2")
    sc = body["scores"]
    assert sc["channel0"] == 1 and len(sc["times_ns"]) == store.n_rows
    assert len(sc["values"][0]) == 2
    _, body, _ = _json(p, "/events?scores=1&scores_limit=3")
    sc = body["scores"]
    t, _v = store.read()
    assert sc["truncated"] is True and sc["rows_total"] == store.n_rows
    assert sc["times_ns"] == [int(x) for x in t[-3:]]
    _, body, _ = _json(p, "/healthz")
    assert body["detect"]["ledger_events"] == len(load_events(folders["pw"]))


def test_ledger_cache_invalidates_and_scores_degrade(folders, tmp_path):
    """The stat-keyed ledger cache picks up a new commit; a torn score
    store degrades ``scores`` to null (200), not a 500."""
    out = str(tmp_path / "copy")
    shutil.copytree(folders["pw"], out)
    evs = load_events(out)
    with thttp.start_server(out) as srv:
        _, body, _ = _json(srv, "/events?limit=100000")
        assert body["ledger_events"] == len(evs)
        fake = dict(evs[-1])
        fake["seq"] = len(evs)
        write_events(out, evs + [fake])
        _, body, _ = _json(srv, "/events?limit=100000")
        assert body["ledger_events"] == len(evs) + 1
        tails = os.path.join(out, ".detect", "scores", "tails.npy")
        data = open(tails, "rb").read()
        with open(tails, "wb") as fh:
            fh.write(data[: len(data) // 2])
        status, body, _ = _json(srv, "/events?scores=1")
    assert status == 200 and body["scores"] is None


# ---------------------------------------------------------------------------
# tests/test_fleet.py / tests/test_obs_flight.py routes, against the port


def test_fleet_routes_and_healthz(servers, folders):
    p, _ = servers
    status, body, _ = _get(p.base_url + f"/s/jw/query?{_WIN}")
    ref = QueryEngine(folders["jw"]).query(W0, W1)
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), ref.data)
    _, fh, _ = _json(p, "/fleet/healthz")
    assert set(fh["streams"]) == {"jw", "pw"}
    assert fh["counts"]["ok"] + fh["counts"]["degraded"] == 2
    for entry in fh["streams"].values():
        assert entry["slo"]["status"] == "ok"
        assert "devprof" in entry and "head_lag_seconds" in entry
    status, body, _ = _json(p, f"/s/nope/query?{_WIN}")
    assert status == 404 and body["streams"] == ["jw", "pw"]


def test_fleet_only_server(folders):
    root = os.path.dirname(folders["pw"])
    with thttp.DASServer.for_fleet(root) as srv:
        assert sorted(srv.mounts) == ["jw", "pw"]
        status, body, _ = _json(srv, f"/query?{_WIN}")
        assert status == 404 and "use /s/<stream_id>/query" in body["error"]
        _, tr, _ = _json(srv, "/s/pw/trace?kind=round")
        assert tr["source"] == "flight" and tr["records"][-1]["phases"]
        _, agg, _ = _json(srv, "/slo?target=150")
        assert set(agg["streams"]) == {"jw", "pw"}
    with thttp.DASServer(folders["pw"]) as srv:
        assert _get(srv.base_url + "/fleet/healthz")[0] == 503
    with pytest.raises(ValueError, match="no stream folders"):
        thttp.DASServer.for_fleet(str(folders["pw"]) + "-none")


def test_trace_ring_fallback_without_flight(tmp_path):
    from tpudas_torch.obs.trace import clear_spans, span

    folder = str(tmp_path / "plain")
    os.makedirs(folder)
    clear_spans()
    with span("ring.only", tag=1):
        pass
    with thttp.DASServer(folder) as srv:
        _, tr, _ = _json(srv, "/trace?name=ring.only")
        assert tr["source"] == "ring" and tr["count"] == 1
        _, tr, _ = _json(srv, "/trace?kind=round")
        assert tr["count"] == 0
