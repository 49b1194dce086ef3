"""The stream carry's one-pass commit (``proc/stream.py::save_carry``):
card leaves staged through page-locked host memory, then the ``.npz``
streamed into its tmp file under one crc pass
(``integrity/checksum.py::write_npz_checksummed``).

The oracle is the serialization the commit replaced, kept below:
``gather_leaves`` to pageable host arrays, then ``np.savez``.  On the
CPU the carry file must be its bytes exactly (an FFT carry with its
host seam and int16 residual, a cascade carry, the numpy leaves of a
loaded carry, pad-and-masked leaves sharded over a mesh), its ``.crc``
the crc32 of the whole file, both packages must load it, a failed
commit must leave the old pair and no tmp file, and concurrent saves
must each write their own file from their own staging buffer.  The card
half is ``tests/test_torch_carry_commit_gpu.py``.
"""

import errno
import io
import json
import os
import sys
import threading
import zlib

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from tpudas.proc.stream import load_carry as jax_load_carry
from tpudas_torch.integrity import checksum
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel import sharding
from tpudas_torch.parallel.mesh import make_mesh
from tpudas_torch.parallel.sharding import gather_leaves, place_carry_leaves
from tpudas_torch.proc.stream import (
    CARRY_FILENAME,
    StreamCarry,
    load_carry,
    save_carry,
)
from tpudas_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    install_fault_plan,
)
from tpudas_torch.testing import enospc_error

C = 37  # channels: a 4-shard mesh pads them to 40
STAGED = "tpudas_stream_carry_staged_bytes_total"


def _savez_bytes(carry) -> bytes:
    """The oracle: the carry serialized as the commit before the
    one-pass writer did it (pageable gather, ``np.savez`` in memory)."""
    arrays = {"meta": np.asarray(json.dumps(carry._meta()))}
    for i, b in enumerate(gather_leaves(carry.bufs, carry.n_ch)):
        arrays[f"buf_{i}"] = b
    if carry.residual is not None:
        res = np.asarray(carry.residual)
        if res.dtype != np.int16:
            res = res.astype(np.float32, copy=False)
        arrays["residual"] = res
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _carry(kind, seed=0, n_ch=C):
    """An FFT carry (overlap-save rows as a tensor, the one-row host
    seam, an int16 residual) or a cascade carry (the flagship plan's
    four stage leaves, a float64 residual the save writes as float32)."""
    rng = np.random.default_rng(seed)

    def rows(p):
        return rng.standard_normal((p, n_ch)).astype(np.float32)

    common = dict(start_ns=10**18, step_ns=10**9, dt_out=1.0, buff_out=10,
                  order=4, patch_out=60, d_ns=10**6, n_ch=n_ch,
                  skip_left=3, next_ingest_ns=10**18 + 7 * 10**9,
                  next_emit_ns=10**18 + 5 * 10**9, consumed=7000,
                  emitted=4)
    if kind == "fft":
        return StreamCarry(
            engine_req="fft", kind="fft", edge_in=20,
            bufs=(torch.from_numpy(rows(40)), rows(1)),
            residual=rng.integers(-3000, 3000, (7, n_ch)).astype(np.int16),
            residual_scale=1e-4, **common)
    return StreamCarry(
        engine_req="fused", kind="cascade", ratio=1000,
        bufs=tuple(torch.from_numpy(rows(p)) for p in (688, 24, 28, 120)),
        residual=rng.standard_normal((5, n_ch)), **common)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _leaves_variant(variant, tmp_path):
    """(carry to save, carry whose oracle bytes it must equal)."""
    if variant in ("fft", "cascade"):
        carry = _carry(variant)
        return carry, carry
    if variant == "loaded":  # numpy leaves, as on resume
        src = str(tmp_path / "src")
        os.makedirs(src)
        save_carry(_carry("cascade"), src)
        carry = load_carry(src)
        assert all(isinstance(b, np.ndarray) for b in carry.bufs)
        return carry, carry
    # pad-and-masked leaves on a 4-shard CPU mesh: the file is the
    # unsharded carry's
    plain = _carry("cascade")
    carry = _carry("cascade")
    carry.bufs = place_carry_leaves(carry.bufs, make_mesh(4, device="cpu"))
    assert all(isinstance(b, sharding.ShardedTensor) for b in carry.bufs)
    assert carry.bufs[0].shape[1] == 40
    return carry, plain


@pytest.mark.parametrize("variant", ["fft", "cascade", "loaded", "sharded"])
def test_the_carry_file_is_np_savez_byte_for_byte(tmp_path, variant):
    carry, oracle = _leaves_variant(variant, tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    reg = MetricsRegistry()
    with use_registry(reg):
        path = save_carry(carry, out)
    assert _read(path) == _savez_bytes(oracle)
    # host leaves are written as they are: every byte went direct
    leaf_bytes = sum(b.nbytes for b in gather_leaves(oracle.bufs, C))
    assert reg.value(STAGED, path="direct") == leaf_bytes
    assert reg.value(STAGED, path="pinned") == 0
    assert reg.value("tpudas_stream_carry_saves_total") == 1


@pytest.mark.parametrize("kind", ["fft", "cascade"])
def test_the_crc_sidecar_is_the_crc32_of_the_whole_file(tmp_path, kind):
    path = save_carry(_carry(kind), str(tmp_path))
    payload = _read(path)
    with open(path + checksum.SIDECAR_SUFFIX) as fh:
        assert fh.read() == (
            f"crc32 {zlib.crc32(payload):08x} {len(payload)}\n")
    assert checksum.verify_file_checksum(path) == "ok"


def test_the_writer_is_np_savez_for_every_layout(tmp_path, monkeypatch):
    """Fortran-ordered, strided, 0-d, empty and multi-chunk members
    (chunks of 1000 bytes, so each member's crc is joined from many)."""
    monkeypatch.setattr(checksum, "_CRC_CHUNK", 1000)
    rng = np.random.default_rng(3)
    arrays = {
        "meta": np.asarray(json.dumps({"kind": "fft", "n": 3})),
        "c": rng.standard_normal((300, 17)).astype(np.float32),
        "f": np.asfortranarray(rng.standard_normal((9, 31))),
        "strided": rng.standard_normal((40, 20)).astype(np.float32)[::3, 1::2],
        "empty": np.zeros((0, 17), np.float32),
        "int16": rng.integers(-3000, 3000, (11, 5)).astype(np.int16),
        "scalar": np.float64(2.5),
    }
    path = str(tmp_path / "x.npz")
    checksum.write_npz_checksummed(path, arrays)
    ref = io.BytesIO()
    np.savez(ref, **arrays)
    assert _read(path) == ref.getvalue()
    assert checksum.verify_file_checksum(path) == "ok"
    with np.load(path) as f:
        for name, a in arrays.items():
            assert np.array_equal(f[name], a)


def test_crc32_combine_joins_any_split():
    rng = np.random.default_rng(5)
    for n1, n2 in [(0, 0), (0, 9), (9, 0), (1, 1), (4095, 4097),
                   (10**5, 3), (3, 10**5)]:
        a, b = rng.bytes(n1), rng.bytes(n2)
        assert checksum.crc32_combine(
            zlib.crc32(a), zlib.crc32(b), n2) == zlib.crc32(a + b)


@pytest.mark.parametrize("kind", ["fft", "cascade"])
def test_both_packages_load_the_streamed_carry(tmp_path, kind):
    carry = _carry(kind)
    save_carry(carry, str(tmp_path))
    want = gather_leaves(carry.bufs, C)
    for load in (load_carry, jax_load_carry):
        got = load(str(tmp_path))
        assert got._meta() == carry._meta()
        assert len(got.bufs) == len(want)
        for a, b in zip(got.bufs, want):
            assert np.array_equal(np.asarray(a), b)
        res = np.asarray(got.residual)
        assert res.dtype == (np.int16 if kind == "fft" else np.float32)
        assert np.array_equal(res, np.asarray(carry.residual).astype(
            res.dtype))


def _fail_mid_write(monkeypatch):
    """A full disk after the archive's first member is on disk."""
    real, calls = checksum._npy_parts, []

    def parts(array):
        calls.append(1)
        if len(calls) == 2:
            raise enospc_error()
        return real(array)

    monkeypatch.setattr(checksum, "_npy_parts", parts)


@pytest.mark.parametrize("where", ["payload_stage", "mid_write",
                                   "sidecar_stage"])
def test_a_failed_commit_leaves_the_old_pair_and_no_tmp(tmp_path,
                                                         monkeypatch, where):
    """The new carry fails at its payload's ``fs.write_enospc`` site,
    in the middle of its payload, or at its ``.crc`` sidecar's site
    after the payload is staged: the save raises, no tmp file is left,
    and the old pair (rotated to ``.prev`` before the write, as ever)
    is whole and loads."""
    out = str(tmp_path)
    old = _carry("cascade", seed=1)
    path = save_carry(old, out)
    pair = (_read(path), _read(path + checksum.SIDECAR_SUFFIX))
    new = _carry("cascade", seed=2)
    new.consumed += 1000
    if where == "mid_write":
        _fail_mid_write(monkeypatch)
        plan = FaultPlan()
    else:
        plan = FaultPlan(FaultSpec(
            "fs.write_enospc", exc=enospc_error(),
            at=1 if where == "payload_stage" else 2, times=1))
    with install_fault_plan(plan), pytest.raises(OSError) as err:
        save_carry(new, out)
    assert err.value.errno == errno.ENOSPC
    assert not [n for n in os.listdir(out) if ".tmp" in n]
    assert not os.path.exists(path)
    assert (_read(path + ".prev"),
            _read(path + ".prev" + checksum.SIDECAR_SUFFIX)) == pair
    assert checksum.verify_file_checksum(path + ".prev") == "ok"
    assert load_carry(out)._meta() == old._meta()


def test_the_pool_hands_each_concurrent_save_its_own_buffer():
    """Five threads taking and giving back buffers at once never hold
    one buffer together, and each takes the smallest idle buffer that
    fits (host buffers stand in for page-locked ones here)."""
    pool = sharding._PinnedPool()
    for n in (64, 32, 128, 96, 80):
        pool.give(torch.empty(n, dtype=torch.uint8))
    assert pool.take(70).numel() == 80
    pool.give(torch.empty(80, dtype=torch.uint8))
    held, lock, clash = set(), threading.Lock(), []

    def worker(k):
        for _ in range(200):
            buf = pool.take(16 * (k + 1))
            with lock:
                if buf.data_ptr() in held:
                    clash.append(buf.data_ptr())
                held.add(buf.data_ptr())
            assert buf.numel() >= 16 * (k + 1)
            with lock:
                held.discard(buf.data_ptr())
            pool.give(buf)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert clash == []
    assert sorted(b.numel() for b in pool._idle) == [32, 64, 80, 96, 128]


def test_five_threads_saving_at_once_each_write_their_own_file(tmp_path):
    """A fleet's members save from their own threads at once: each
    folder holds its own carry, the oracle's bytes."""
    carries = [_carry("fft" if k % 2 else "cascade", seed=10 + k)
               for k in range(5)]
    errors = []

    def worker(k):
        try:
            for r in range(3):
                carries[k].consumed += 1
                save_carry(carries[k], str(tmp_path / f"m{k}"))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    for k in range(5):
        os.makedirs(tmp_path / f"m{k}")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    for k in range(5):
        path = str(tmp_path / f"m{k}" / CARRY_FILENAME)
        assert _read(path) == _savez_bytes(carries[k])
        assert checksum.verify_file_checksum(path) == "ok"
