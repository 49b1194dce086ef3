"""The port's startup audit / fsck (tpudas_torch.integrity.audit) against
the JAX package's.

A stream folder is written once per module (4 ch, 50 Hz, 20 s dasdae
files, as ``tests/test_detect.py``; the stateful carry and the detect
operators on, two driver calls so every ``.prev`` rung exists, and a
quarantine ledger with its ``.prev``).  Each case damages two copies of
it the same way; ``tpudas.integrity.audit.audit`` repairs one and the
port's ``audit`` the other.  The reports must agree — the same
``(artifact, relative path, status, action)`` tuples, ``clean`` and
``repaired`` — the repaired trees must be byte-equal, and a second
audit of each must be clean and empty.  The cases mirror
``tests/test_integrity.py``'s and ``tests/test_detect.py``'s audit
tests where they apply (the flight recorder's are in
``tests/test_torch_flight.py``).  The pyramid cases damage a folder whose port driver kept a tile
pyramid (``tile_len`` 8), raw and under ``bitshuffle-deflate``.  The
drivers run on the CPU.
"""

import importlib
import json
import os
import shutil

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest

from tpudas.obs import registry as jreg
from tpudas.proc.streaming import run_lowpass_realtime as jax_realtime
from tpudas.proc.streaming import run_rolling_realtime as jax_rolling
from tpudas.resilience.faults import RetryPolicy as JaxRetryPolicy
from tpudas.testing import make_synthetic_spool
from tpudas_torch.detect.ledger import ScoreStore, event_line, load_events
from tpudas_torch.integrity.checksum import SIDECAR_SUFFIX
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.proc.stream import CARRY_FILENAME
from tpudas_torch.proc.streaming import run_lowpass_realtime
from tpudas_torch.proc.streaming import run_rolling_realtime
from tpudas_torch.resilience.faults import RetryPolicy
from tpudas_torch.resilience.quarantine import (
    QUARANTINE_FILENAME,
    QuarantineLedger,
)

# the modules (tpudas.integrity re-exports the function under the name)
jaudit = importlib.import_module("tpudas.integrity.audit")
taudit = importlib.import_module("tpudas_torch.integrity.audit")
T0 = "2023-03-22T00:00:00"
OPS = [
    ("stalta", {"sta": 2.0, "lta": 10.0, "on": 2.0, "off": 1.2}),
    ("rms", {"window": 5.0, "step": 2.0, "thresh": 1.5, "baseline": 20.0}),
]
FAST = dict(base_delay=0.0, max_delay=0.0, jitter=0.0)
PACKAGES = {"jax": jaudit, "port": taudit}


def _drive(pkg, src, out, **kw):
    kw.setdefault("detect", True)
    kw.setdefault("detect_operators", OPS)
    if pkg == "port":
        driver, policy = run_lowpass_realtime, RetryPolicy(**FAST)
        kw.setdefault("device", "cpu")
    else:
        driver, policy = jax_realtime, JaxRetryPolicy(**FAST)
        kw.setdefault("pyramid", False)
    return driver(source=src, output_folder=out, start_time=T0,
                  output_sample_interval=1.0, edge_buffer=5.0,
                  process_patch_size=20, poll_interval=0.0,
                  sleep_fn=lambda _s: None, fault_policy=policy,
                  stateful=True, **kw)


def _write_folder(root, writer, **kw):
    """A stream folder written by ``writer``'s driver in two calls (3
    files, then a 4th), plus a quarantine ledger with its ``.prev``."""
    pool, src, out = (os.path.join(root, n) for n in ("pool", "src", "out"))
    make_synthetic_spool(pool, n_files=4, file_duration=20.0, fs=50.0,
                         n_ch=4, noise=0.01)
    names = sorted(n for n in os.listdir(pool) if n.endswith(".h5"))
    os.makedirs(src)
    for i, name in enumerate(names):
        os.link(os.path.join(pool, name), os.path.join(src, name))
        if i >= 2:
            assert _drive(writer, src, out, **kw) == 1
    led = QuarantineLedger(out)
    for _ in range(2):
        led.record_failure("/data/raw_7.h5", "ValueError: bad payload",
                           now=100.0, threshold=2, retry_interval=60.0)
    return src, out


@pytest.fixture(scope="module")
def port_folder(tmp_path_factory):
    src, out = _write_folder(str(tmp_path_factory.mktemp("audit-port")),
                             "port")
    for name in (CARRY_FILENAME + ".prev", QUARANTINE_FILENAME + ".prev",
                 os.path.join(".detect", "carry.npz.prev"),
                 os.path.join(".detect", "events.jsonl")):
        assert os.path.isfile(os.path.join(out, name)), name
    return src, out


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """Written by the JAX driver with its health snapshot and its
    flight recorder on."""
    src, out = _write_folder(str(tmp_path_factory.mktemp("audit-jax")),
                             "jax", health=True, flight=True)
    assert os.path.isfile(os.path.join(out, "health.json.prev"))
    assert os.path.isdir(os.path.join(out, ".flight"))
    return src, out


# ---------------------------------------------------------------------------
# damage, each applied the same way to every copy

def _flip_byte(path, offset=64):
    offset = min(offset, os.path.getsize(path) - 1)
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0xFF]))


def _write(path, data=b"junk"):
    with open(path, "wb") as fh:
        fh.write(data)


def _stale_tmp(out):
    for name in ("health.json.tmp", CARRY_FILENAME + ".tmp.999",
                 os.path.join(".detect", "scores", "tails.npy.tmp.4242"),
                 "LFDAS_2099-01-01T000000.0_2099-01-01T000100.0.h5.tmp.7"):
        _write(os.path.join(out, name))


def _unstamped(out):
    os.remove(os.path.join(out, CARRY_FILENAME + SIDECAR_SUFFIX))
    os.remove(os.path.join(out, ".detect", "carry.npz" + SIDECAR_SUFFIX))
    os.remove(os.path.join(out, ".detect", "scores",
                           "tails.npy" + SIDECAR_SUFFIX))
    path = os.path.join(out, QUARANTINE_FILENAME)
    with open(path) as fh:
        obj = json.load(fh)
    obj.pop("_crc32")
    _write(path, json.dumps(obj).encode())


def _corrupt_carry(out):
    _flip_byte(os.path.join(out, CARRY_FILENAME))


def _lone_prev_carry(out):
    path = os.path.join(out, CARRY_FILENAME)
    os.remove(path)
    os.remove(path + SIDECAR_SUFFIX)


def _torn_output(out):
    _write(os.path.join(out, "LFDAS_2099-01-01T000000.0_"
                             "2099-01-01T000100.0.h5"),
           b"\x89HDF\r\n\x1a\ngarbage")


def _quarantine_both_bad(out):
    path = os.path.join(out, QUARANTINE_FILENAME)
    _flip_byte(path, 40)
    _flip_byte(path + ".prev", 40)


def _corrupt_quarantine(out):
    _flip_byte(os.path.join(out, QUARANTINE_FILENAME), 40)


def _ledger_both_bad(out):
    ledger = os.path.join(out, ".detect", "events.jsonl")
    with open(ledger, "a") as fh:
        fh.write('{"torn": tru')
    _write(ledger + ".prev", b'{"seq": 0, "torn')


def _ledger_surplus(out):
    evs = load_events(out)
    fake = dict(evs[-1])
    fake["seq"] = len(evs)
    with open(os.path.join(out, ".detect", "events.jsonl"), "a") as fh:
        fh.write(event_line(fake) + "\n")


def _score_surplus(out):
    store = ScoreStore.open(out)
    store.append(np.array([store.epoch_ns + 10**12], np.int64),
                 np.full((1, store.n_ch), 0.5))


def _orphan_score_tile(out):
    _write(os.path.join(out, ".detect", "scores", "00009999.npy"),
           b"not a tile")


def _torn_detect_carry(out):
    _flip_byte(os.path.join(out, ".detect", "carry.npz"), 100)


def _unreadable_detect_carry(out):
    carry = os.path.join(out, ".detect", "carry.npz")
    _write(carry, b"not a zip")
    for p in (carry + ".prev", carry + ".prev" + SIDECAR_SUFFIX):
        os.remove(p)


DAMAGE = {
    "stale_tmp": _stale_tmp,
    "unstamped": _unstamped,
    "corrupt_carry": _corrupt_carry,
    "lone_prev_carry": _lone_prev_carry,
    "torn_output": _torn_output,
    "quarantine_both_bad": _quarantine_both_bad,
    "corrupt_quarantine": _corrupt_quarantine,
    "ledger_both_bad": _ledger_both_bad,
    "ledger_surplus": _ledger_surplus,
    "score_surplus": _score_surplus,
    "orphan_score_tile": _orphan_score_tile,
    "torn_detect_carry": _torn_detect_carry,
    "unreadable_detect_carry": _unreadable_detect_carry,
}
# the repair each case must show (beside whatever else it finds)
WANT = {
    "stale_tmp": ("tmp", "stale_tmp", "removed"),
    "unstamped": ("carry", "unstamped", "restamped"),
    "corrupt_carry": ("carry", "torn", "promoted_prev"),
    "lone_prev_carry": ("carry", "torn", "promoted_prev"),
    "torn_output": ("output", "torn", "removed"),
    "quarantine_both_bad": ("quarantine", "corrupt", "removed"),
    "corrupt_quarantine": ("quarantine", "corrupt", "promoted_prev"),
    "ledger_both_bad": ("detect", "torn", "reset_detect"),
    "ledger_surplus": ("events", "torn", "truncated"),
    "score_surplus": ("scores", "torn", "truncated"),
    "orphan_score_tile": ("scores", "orphan", "removed"),
    "torn_detect_carry": ("detect_carry", "torn", "promoted_prev"),
    "unreadable_detect_carry": ("detect", "torn", "reset_detect"),
}


def _tree(folder):
    """{relative path: bytes} of every file under ``folder``."""
    out = {}
    for dirpath, _dirs, files in os.walk(folder):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = fh.read()
    return out


def _key(report):
    root = report["folder"]
    return sorted((it["artifact"], os.path.relpath(it["path"], root),
                   it["status"], it["action"]) for it in report["issues"])


def _copies(folder, tmp_path, damage):
    """Two damaged copies of ``folder``: {package: path}."""
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = str(tmp_path / pkg)
        shutil.copytree(folder, outs[pkg])
        if damage is not None:
            damage(outs[pkg])
    return outs


def _audit_both(outs, **kw):
    reps = {pkg: PACKAGES[pkg].audit(outs[pkg], **kw) for pkg in PACKAGES}
    assert _key(reps["port"]) == _key(reps["jax"])
    for k in ("clean", "repaired", "counts", "repair"):
        assert reps["port"][k] == reps["jax"][k], k
    return reps


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DAMAGE))
def test_repairs_equal_jax(port_folder, tmp_path, case):
    """The same damage: the same report, the same repaired bytes, and a
    second audit clean and empty in both packages."""
    outs = _copies(port_folder[1], tmp_path, DAMAGE[case])
    reps = _audit_both(outs)
    assert reps["port"]["clean"]
    artifact, status, action = WANT[case]
    assert any(it["artifact"] == artifact and it["status"] == status
               and it["action"] == action
               for it in reps["port"]["issues"]), reps["port"]["issues"]
    assert _tree(outs["port"]) == _tree(outs["jax"])
    again = _audit_both(outs)
    assert again["port"]["clean"] and not again["port"]["issues"]


def test_clean_folder_reports_nothing(port_folder, tmp_path):
    outs = _copies(port_folder[1], tmp_path, None)
    reps = _audit_both(outs)
    assert reps["port"]["clean"] and not reps["port"]["issues"]
    assert _tree(outs["port"]) == _tree(port_folder[1])


@pytest.mark.parametrize("case", ["corrupt_carry", "ledger_surplus",
                                  "stale_tmp"])
def test_no_repair_only_reports(port_folder, tmp_path, case):
    outs = _copies(port_folder[1], tmp_path, DAMAGE[case])
    before = _tree(outs["port"])
    reps = _audit_both(outs, repair=False)
    assert not reps["port"]["clean"] and reps["port"]["issues"]
    assert all(it["action"] == "found" for it in reps["port"]["issues"])
    assert _tree(outs["port"]) == before == _tree(outs["jax"])


def _corrupt_health(out):
    _flip_byte(os.path.join(out, "health.json"), 40)


def _unstamped_health(out):
    path = os.path.join(out, "health.json")
    with open(path) as fh:
        obj = json.load(fh)
    obj.pop("_crc32")
    _write(path, json.dumps(obj).encode())


CROSS = {
    "clean": None,
    "corrupt_carry": _corrupt_carry,
    "ledger_surplus": _ledger_surplus,
    "stale_tmp": _stale_tmp,
    "corrupt_health": _corrupt_health,
    "unstamped_health": _unstamped_health,
}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_jax_written_folder_audits_the_same(jax_folder, tmp_path, case):
    """A folder the JAX driver wrote (health snapshot and flight recorder
    on) audits the same under either package."""
    outs = _copies(jax_folder[1], tmp_path, CROSS[case])
    reps = _audit_both(outs)
    assert reps["port"]["clean"]
    assert bool(reps["port"]["issues"]) == (case != "clean")
    assert _tree(outs["port"]) == _tree(outs["jax"])


def test_port_written_folder_resumes_under_jax_after_port_repair(
        port_folder, tmp_path):
    """The port repairs a folder its driver wrote; the JAX driver then
    resumes it (its own startup audit finds nothing left)."""
    src, folder = port_folder
    out = str(tmp_path / "out")
    shutil.copytree(folder, out)
    _corrupt_carry(out)
    _ledger_surplus(out)
    assert taudit.audit(out)["clean"]
    reg = jreg.MetricsRegistry()
    with jreg.use_registry(reg):
        _drive("jax", src, out, flight=False)
    assert reg.value("tpudas_integrity_audit_runs_total") == 1
    assert reg.value("tpudas_integrity_audit_repairs_total",
                     kind="promoted_prev") == 0


def _fleet_root(folder, root, damage):
    for sid in ("s00", "s01"):
        shutil.copytree(folder, os.path.join(root, sid))
    damage(os.path.join(root, "s01"))
    os.makedirs(os.path.join(root, ".cache"))  # fleet bookkeeping


def test_audit_fleet_equal_jax(port_folder, tmp_path):
    roots = {}
    for pkg in PACKAGES:
        roots[pkg] = str(tmp_path / pkg)
        _fleet_root(port_folder[1], roots[pkg], _corrupt_carry)
    reps = {pkg: PACKAGES[pkg].audit_fleet(roots[pkg]) for pkg in PACKAGES}
    for k in ("clean", "stream_count", "issues_total", "repaired_total",
              "repair"):
        assert reps["port"][k] == reps["jax"][k], k
    assert sorted(reps["port"]["streams"]) == ["s00", "s01"]
    for sid in ("s00", "s01"):
        assert (_key(reps["port"]["streams"][sid])
                == _key(reps["jax"]["streams"][sid]))
    assert not reps["port"]["streams"]["s00"]["issues"]
    assert reps["port"]["clean"] and reps["port"]["repaired_total"] >= 1
    assert _tree(roots["port"]) == _tree(roots["jax"])
    assert taudit.fleet_stream_dirs(roots["port"]) == [
        (sid, os.path.join(roots["port"], sid)) for sid in ("s00", "s01")]


def test_audit_fleet_empty_root_is_not_clean(tmp_path):
    for root in (str(tmp_path / "empty"), str(tmp_path / "missing")):
        if root.endswith("empty"):
            os.makedirs(root)
        rep = taudit.audit_fleet(root)
        want = jaudit.audit_fleet(root)
        assert rep == want
        assert not rep["clean"] and rep["stream_count"] == 0
        assert "no stream folders" in rep["error"]


# ---------------------------------------------------------------------------
# the tile pyramid's half (ROADMAP A8a)

def _pyramid_folder(tmp_path_factory, codec):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
        if codec:
            mp.setenv("TPUDAS_CODEC", codec)
        root = str(tmp_path_factory.mktemp(f"audit-pyr-{codec or 'raw'}"))
        src, out = _write_folder(root, "port", pyramid=True)
    tiles = os.path.join(out, ".tiles")
    assert os.path.isfile(os.path.join(tiles, "manifest.json.prev"))
    suffix = ".tpt" if codec else ".npy"
    assert os.path.isfile(os.path.join(tiles, "L1", "00000000" + suffix))
    return src, out


@pytest.fixture(scope="module")
def pyramid_folders(tmp_path_factory):
    return {"raw": _pyramid_folder(tmp_path_factory, None),
            "bitshuffle": _pyramid_folder(tmp_path_factory,
                                          "bitshuffle-deflate")}


def _tree_but_index(folder):
    """:func:`_tree` without the directory-index cache: a pyramid
    rebuild rescans the outputs, and the cache's records carry each
    copy's own absolute paths."""
    return {k: v for k, v in _tree(folder).items()
            if not k.startswith(".tpudas_index.json")}


def _tiles(out, *parts):
    return os.path.join(out, ".tiles", *parts)


def _tile_file(out, level=0, idx=0):
    d = _tiles(out, f"L{level}")
    name = [n for n in sorted(os.listdir(d))
            if n.startswith(f"{idx:08d}.") and not n.endswith(".crc")][0]
    return os.path.join(d, name)


def _torn_manifest(out):
    _flip_byte(_tiles(out, "manifest.json"), 20)


def _torn_manifest_and_prev(out):
    _flip_byte(_tiles(out, "manifest.json"), 20)
    _flip_byte(_tiles(out, "manifest.json.prev"), 20)


def _bad_stamps_manifest_and_prev(out):
    """Both rungs parse but fail their checksum: the rebuild keeps the
    geometry and codec it reads from them."""
    for name in ("manifest.json", "manifest.json.prev"):
        path = _tiles(out, name)
        with open(path) as fh:
            obj = json.load(fh)
        obj["_crc32"] = "00000000"
        _write(path, json.dumps(obj).encode())


def _torn_tails(out):
    with open(_tiles(out, "tails.npy"), "r+b") as fh:
        fh.truncate(60)


def _unstamped_tails(out):
    os.remove(_tiles(out, "tails.npy" + SIDECAR_SUFFIX))


def _bad_tile(out):
    _flip_byte(_tile_file(out, 0, 1), 200)


def _torn_tile(out):
    path = _tile_file(out, 1, 0)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 4)


def _orphan_tile(out):
    src = _tile_file(out, 0, 0)
    dst = os.path.join(os.path.dirname(src),
                       "00000099" + os.path.splitext(src)[1])
    with open(src, "rb") as fh:
        payload = fh.read()
    _write(dst, payload[:-8])  # torn, and past the manifest head


PYRAMID_DAMAGE = {
    "torn_manifest": (_torn_manifest, ("manifest", "corrupt",
                                       "promoted_prev")),
    "torn_manifest_and_prev": (_torn_manifest_and_prev,
                               ("manifest", "corrupt", "rebuilt_pyramid")),
    "bad_stamps_manifest_and_prev": (
        _bad_stamps_manifest_and_prev,
        ("manifest", "corrupt", "rebuilt_pyramid")),
    "torn_tails": (_torn_tails, ("tails", "torn", "rebuilt_pyramid")),
    "bad_tile": (_bad_tile, ("tile", None, "rebuilt_pyramid")),
    "torn_tile": (_torn_tile, ("tile", None, "rebuilt_pyramid")),
    "orphan_tile": (_orphan_tile, ("tile", "orphan", "removed")),
}


@pytest.mark.parametrize("store", ["raw", "bitshuffle"])
@pytest.mark.parametrize("case", sorted(PYRAMID_DAMAGE))
def test_pyramid_repairs_equal_jax(pyramid_folders, tmp_path, case, store):
    """Pyramid damage: the same report and repairs as the JAX audit, the
    repaired trees byte-equal (a rebuilt ``.tiles/`` included, with its
    geometry and codec kept), and a second audit clean and empty."""
    damage, (artifact, status, action) = PYRAMID_DAMAGE[case]
    clean_tiles = _tree(_tiles(pyramid_folders[store][1]))
    outs = _copies(pyramid_folders[store][1], tmp_path, damage)
    reps = _audit_both(outs)
    assert reps["port"]["clean"]
    assert any(it["artifact"] == artifact and it["action"] == action
               and status in (None, it["status"])
               for it in reps["port"]["issues"]), reps["port"]["issues"]
    assert _tree_but_index(outs["port"]) == _tree_but_index(outs["jax"])
    again = _audit_both(outs)
    assert again["port"]["clean"] and not again["port"]["issues"]
    from tpudas_torch.serve.tiles import TileStore

    st = TileStore.open(outs["port"])
    if case == "torn_manifest_and_prev":
        # no rung parses: the rebuild takes the defaults (4 / 256 / raw),
        # in the JAX audit too
        assert (st.factor, st.tile_len, st.codec) == (4, 256, None)
        return
    assert (st.factor, st.tile_len) == (4, 8)
    assert st.codec == ("bitshuffle-deflate" if store != "raw" else None)
    if action == "rebuilt_pyramid":
        assert st.generation == 1
        # the rebuilt tiles are the stream's own (derived data)
        got = _tree(_tiles(outs["port"]))
        assert {k: v for k, v in got.items() if "manifest" not in k} == {
            k: v for k, v in clean_tiles.items()
            if "manifest" not in k and ".prev" not in k}


@pytest.mark.parametrize("case", ["torn_tails", "bad_tile"])
def test_pyramid_no_rebuild_reports(pyramid_folders, tmp_path, case):
    """``rebuild=False`` (fsck ``--no-rebuild``): found, not rebuilt, in
    both packages alike."""
    outs = _copies(pyramid_folders["raw"][1], tmp_path,
                   PYRAMID_DAMAGE[case][0])
    before = _tree(outs["port"])
    reps = _audit_both(outs, rebuild=False)
    assert not reps["port"]["clean"]
    assert any(it["action"] == "found" for it in reps["port"]["issues"])
    assert _tree(outs["port"]) == before == _tree(outs["jax"])


def test_pyramid_resumes_after_repair_like_control(pyramid_folders,
                                                   tmp_path, monkeypatch):
    """After the port's audit rebuilds a torn pyramid, the next driver
    call appends to it; the tree equals the JAX sync over the outputs."""
    from tpudas.serve.tiles import sync_pyramid as jax_sync

    src, folder = pyramid_folders["raw"]
    out = str(tmp_path / "out")
    shutil.copytree(folder, out)
    _torn_tails(out)
    monkeypatch.setenv("TPUDAS_PYRAMID_TILE_LEN", "8")
    reg = MetricsRegistry()
    with use_registry(reg):
        _drive("port", src, out, pyramid=True)
    assert reg.value("tpudas_integrity_audit_repairs_total",
                     kind="rebuilt_pyramid") >= 1
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    for n in os.listdir(out):
        if n.startswith("LFDAS_"):
            os.link(os.path.join(out, n), os.path.join(ref, n))
    jax_sync(ref)
    got = {k: v for k, v in _tree(_tiles(out)).items()
           if "manifest" not in k}
    want = {k: v for k, v in _tree(_tiles(ref)).items()
            if "manifest" not in k}
    assert got == want


def test_fsck_cli_reports_pyramid_rebuild(pyramid_folders, tmp_path):
    """The port's fsck CLI repairs a torn in-use tile like the audit."""
    import subprocess
    import sys

    out = _copies(pyramid_folders["raw"][1], tmp_path, _bad_tile)["port"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tpudas_torch", "tools",
                                      "fsck.py"), out],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "rebuilt_pyramid" in r.stdout
    assert taudit.audit(out)["issues"] == []


@pytest.mark.parametrize("when", ["before_payload", "after_payload"])
@pytest.mark.parametrize("artifact", ["carry", "detect_carry"])
@pytest.mark.parametrize("unstamped", [False, True])
def test_rotate_killed_mid_rotation_keeps_the_carry(
        port_folder, tmp_path, monkeypatch, artifact, unstamped, when):
    """ROADMAP C5, the card half: a save's rotation killed just before,
    or right after, the payload's rename (on the card, inside the slow
    rename of an 800 MB FFT carry over its old ``.prev``: the kill ends
    the process as the rename returns).  The port moves the sidecar
    first, so the newest state survives as an unstamped primary or a
    consistent ``.prev``: the audit keeps a carry and the reader loads
    the state the save started from.  (With the payload moved first, a
    kill after its rename left a ``.prev`` beside the older rung's
    stamp: the audit removed it and the stream restarted in rewind
    mode, unlike its control.)"""
    from tpudas_torch.detect.runner import load_detect_carry
    from tpudas_torch.integrity import checksum
    from tpudas_torch.proc.stream import load_carry

    out = str(tmp_path / "out")
    shutil.copytree(port_folder[1], out)
    path = (os.path.join(out, CARRY_FILENAME) if artifact == "carry"
            else os.path.join(out, ".detect", "carry.npz"))
    if unstamped:
        os.remove(path + SIDECAR_SUFFIX)  # a primary no one stamped yet
    load = ((lambda: load_carry(out)._meta()) if artifact == "carry"
            else (lambda: load_detect_carry(out)["meta"]))
    want = load()
    with open(path, "rb") as fh:
        payload = fh.read()
    real = os.replace

    def killed(src, dst):
        if dst != path + ".prev":  # a sidecar's rename
            return real(src, dst)
        if when == "after_payload":
            real(src, dst)
        raise KeyboardInterrupt(f"killed {when}")

    monkeypatch.setattr(checksum.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        checksum.rotate_prev(path)
    monkeypatch.setattr(checksum.os, "replace", real)
    assert load() == want
    rep = taudit.audit(out)
    assert rep["clean"]
    assert not [it for it in rep["issues"] if it["action"] == "removed"
                and it["artifact"] == artifact]
    assert load() == want
    kept = path if os.path.isfile(path) else path + ".prev"
    with open(kept, "rb") as fh:
        assert fh.read() == payload


def test_audit_metrics_and_span(port_folder, tmp_path):
    """The report's metrics and span, by the JAX names."""
    from tpudas_torch.obs.trace import get_spans

    out = _copies(port_folder[1], tmp_path, _stale_tmp)["port"]
    reg = MetricsRegistry()
    with use_registry(reg):
        rep = taudit.audit(out)
    assert reg.value("tpudas_integrity_audit_runs_total") == 1
    assert reg.value("tpudas_integrity_audit_seconds") == 1
    assert reg.value("tpudas_integrity_audit_repairs_total",
                     kind="removed") == rep["repaired"] == 4
    spans = [s for s in get_spans("integrity.audit")
             if s["attrs"].get("folder") == out]
    assert len(spans) == 1


def test_fsck_cli_roundtrip(port_folder, tmp_path, capsys):
    from tpudas_torch.tools.fsck import main as fsck_main

    out = _copies(port_folder[1], tmp_path, _corrupt_carry)["port"]
    assert fsck_main([out, "--no-repair"]) == 1
    report_path = str(tmp_path / "fsck.json")
    assert fsck_main([out, "--out", report_path]) == 0  # repaired: clean
    rep = json.loads(open(report_path).read())
    assert rep["clean"] and rep["repaired"] >= 1
    assert '"clean": true' in capsys.readouterr().out
    assert fsck_main([out]) == 0  # a second run has nothing to do
    assert json.loads(capsys.readouterr().out)["issues"] == []
    root = str(tmp_path / "fleet")
    _fleet_root(port_folder[1], root, _stale_tmp)
    assert fsck_main([root, "--fleet", "--no-rebuild"]) == 0
    assert json.loads(capsys.readouterr().out)["stream_count"] == 2
    for flag in (["--backfill"], ["--store", "file:///x"]):
        with pytest.raises(NotImplementedError, match="A8e"):
            fsck_main([out, *flag])


# ---------------------------------------------------------------------------
# the runners' startup audit

def _damage_for_startup(out):
    _corrupt_carry(out)
    _write(os.path.join(out, CARRY_FILENAME + ".tmp.999"))


def _repairs(reg):
    return {k: reg.value("tpudas_integrity_audit_repairs_total", kind=k)
            for k in ("removed", "promoted_prev")}


def test_lowpass_runner_audits_before_round_one(port_folder, tmp_path):
    """Both packages' low-pass runners audit and repair the damaged
    folder before their first round, and count it alike."""
    src, folder = port_folder
    outs = _copies(folder, tmp_path, _damage_for_startup)
    regs = {"port": MetricsRegistry(), "jax": jreg.MetricsRegistry()}
    scopes = {"port": use_registry, "jax": jreg.use_registry}
    for pkg in PACKAGES:
        with scopes[pkg](regs[pkg]):
            assert _drive(pkg, src, outs[pkg], flight=False) == 1
    for pkg in PACKAGES:
        assert regs[pkg].value("tpudas_integrity_audit_runs_total") == 1
        assert regs[pkg].value(
            "tpudas_integrity_fallback_total", artifact="carry") == 0
    assert _repairs(regs["port"]) == _repairs(regs["jax"]) == {
        "removed": 1, "promoted_prev": 1}
    assert not os.path.exists(
        os.path.join(outs["port"], CARRY_FILENAME + ".tmp.999"))
    assert taudit.audit(outs["port"])["issues"] == []


def _rolling(pkg, src, out):
    if pkg == "port":
        return run_rolling_realtime(
            src, out, window=1.0, step=1.0, poll_interval=0.0,
            sleep_fn=lambda _s: None, device="cpu")
    return jax_rolling(src, out, window=1.0, step=1.0, poll_interval=0.0,
                       sleep_fn=lambda _s: None, flight=False)


def test_rolling_runner_audits_before_round_one(port_folder, tmp_path):
    src = port_folder[0]
    regs = {"port": MetricsRegistry(), "jax": jreg.MetricsRegistry()}
    scopes = {"port": use_registry, "jax": jreg.use_registry}
    for pkg in PACKAGES:
        out = str(tmp_path / pkg)
        os.makedirs(out)
        led = QuarantineLedger(out)
        for _ in range(2):
            led.record_failure("/data/raw_7.h5", "ValueError: bad",
                               now=100.0, threshold=2, retry_interval=60.0)
        _corrupt_quarantine(out)
        _write(os.path.join(out, "junk.tmp"))
        with scopes[pkg](regs[pkg]):
            assert _rolling(pkg, src, out) >= 1
        assert not os.path.exists(os.path.join(out, "junk.tmp"))
        assert regs[pkg].value("tpudas_integrity_audit_runs_total") == 1
    assert _repairs(regs["port"]) == _repairs(regs["jax"]) == {
        "removed": 1, "promoted_prev": 1}


@pytest.mark.parametrize("runner", ["lowpass", "rolling"])
def test_audit_off_by_environment(port_folder, tmp_path, monkeypatch,
                                  runner):
    src, folder = port_folder
    monkeypatch.setenv("TPUDAS_INTEGRITY_AUDIT", "0")
    out = _copies(folder, tmp_path, _damage_for_startup)["port"]
    reg = MetricsRegistry()
    with use_registry(reg):
        if runner == "lowpass":
            _drive("port", src, out)
        else:
            _rolling("port", src, out)
    assert reg.value("tpudas_integrity_audit_runs_total") == 0
    assert os.path.exists(os.path.join(out, CARRY_FILENAME + ".tmp.999"))


def test_raising_audit_is_swallowed_and_counted(port_folder, tmp_path,
                                                monkeypatch):
    from tpudas_torch.utils.logging import set_log_handler

    src, folder = port_folder
    out = _copies(folder, tmp_path, None)["port"]

    def boom(*_a, **_k):
        raise RuntimeError("audit exploded")

    monkeypatch.setattr(taudit, "audit", boom)
    reg, events = MetricsRegistry(), []
    set_log_handler(events.append)
    try:
        with use_registry(reg):
            assert _drive("port", src, out) == 1
    finally:
        set_log_handler(None)
    assert reg.value("tpudas_integrity_audit_errors_total") == 1
    failed = [e for e in events if e["event"] == "integrity_audit_failed"]
    assert len(failed) == 1 and "audit exploded" in failed[0]["error"]
