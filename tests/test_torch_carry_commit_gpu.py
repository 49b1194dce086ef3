"""The stream carry's one-pass commit on the CUDA card: card leaves
copied into page-locked staging buffers write the same file as the
pageable gather they replaced.

Every test here carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the JAX package, so it runs on the card's host::

    python -m pytest --noconftest -q tests/test_torch_carry_commit_gpu.py

The CPU half (the writer against ``np.savez``, both packages' loads,
failed commits) is ``tests/test_torch_carry_commit.py``.
"""

import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tpudas_torch.integrity.checksum import verify_file_checksum
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel import sharding
from tpudas_torch.parallel.mesh import DeviceMesh
from tpudas_torch.parallel.sharding import gather_leaves, place_carry_leaves
from tpudas_torch.proc.stream import CARRY_FILENAME, StreamCarry, save_carry

pytestmark = pytest.mark.gpu

STAGED = "tpudas_stream_carry_staged_bytes_total"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _savez_bytes(carry) -> bytes:
    """The oracle: the pageable gather (``.to("cpu")``) and ``np.savez``
    in memory, as the commit serialized a carry before staging."""
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


def _carry(kind, dev, n_ch, seed=0):
    """An FFT carry (overlap-save rows on the card, the host seam, an
    int16 residual) or a cascade carry (four stage leaves on the card)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rows(p):
        return torch.randn((p, n_ch), generator=gen, device=dev)

    common = dict(start_ns=10**18, step_ns=10**9, dt_out=1.0, buff_out=10,
                  order=4, patch_out=60, d_ns=10**6, n_ch=n_ch,
                  consumed=60000, emitted=50)
    if kind == "fft":
        rng = np.random.default_rng(seed)
        return StreamCarry(
            engine_req="fft", kind="fft", edge_in=1000,
            bufs=(rows(2000), rows(1).cpu().numpy()),
            residual=rng.integers(-3000, 3000, (7, n_ch)).astype(np.int16),
            residual_scale=1e-4, **common)
    return StreamCarry(
        engine_req="fused", kind="cascade", ratio=1000,
        bufs=tuple(rows(p) for p in (688, 24, 28, 120)), **common)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("variant", ["fft", "cascade", "sharded",
                                     "strided"])
def test_staged_carry_equals_the_pageable_carry_on_card(cuda_device,
                                                        tmp_path, variant):
    """The staged file is the pageable one byte for byte, and every card
    leaf's bytes went through a staging buffer (``path="pinned"``): an
    FFT carry of 80 MB (several crc chunks) with its host seam, a
    cascade carry, pad-and-masked leaves over a 4-shard one-card mesh
    (6,001 channels, 1,501 a shard), and column slices of a wider
    tensor (a batched fleet's packed leaves)."""
    n_ch = 6001 if variant == "sharded" else 10000
    carry = _carry("fft" if variant == "fft" else "cascade", cuda_device,
                   n_ch)
    if variant == "sharded":
        mesh = DeviceMesh([[torch.device("cuda", 0)] * 4])
        carry.bufs = place_carry_leaves(carry.bufs, mesh)
    elif variant == "strided":
        carry.bufs = tuple(
            torch.cat([b, torch.ones_like(b)], dim=1)[:, :n_ch]
            for b in carry.bufs)
        assert not carry.bufs[0].is_contiguous()
    want = _savez_bytes(carry)
    host = gather_leaves(carry.bufs, n_ch)
    on_card = [a.nbytes for a, b in zip(host, carry.bufs)
               if not isinstance(b, np.ndarray)]
    reg = MetricsRegistry()
    with use_registry(reg):
        path = save_carry(carry, str(tmp_path))
    assert _read(path) == want
    assert verify_file_checksum(path) == "ok"
    assert reg.value(STAGED, path="pinned") == sum(on_card) > 0
    assert reg.value(STAGED, path="direct") == sum(
        a.nbytes for a in host) - sum(on_card)


def test_the_staging_pool_grows_and_reuses_on_card(cuda_device):
    """A buffer is page-locked the first time a size is needed, handed
    out again for any size it holds, and replaced by a larger one (never
    a smaller one) when a save needs more."""
    pool = sharding._PinnedPool()
    a = pool.take(1 << 20)
    assert a.is_pinned() and a.numel() == 1 << 20
    pool.give(a)
    b = pool.take(1 << 10)
    assert b.data_ptr() == a.data_ptr()
    pool.give(b)
    c = pool.take(1 << 22)
    assert c.is_pinned() and c.numel() == 1 << 22 and pool._idle == []
    pool.give(c)
    assert pool.take(1 << 20).data_ptr() == c.data_ptr()


def test_five_threads_save_at_once_on_card(cuda_device, tmp_path,
                                           monkeypatch):
    """Five members saving from their own threads at once, three times
    each: no staging buffer is held by two saves at once, and each
    folder holds its own carry, the pageable oracle's bytes."""
    real_take, real_give = sharding._PINNED.take, sharding._PINNED.give
    held, lock, clash = set(), threading.Lock(), []

    def take(nbytes):
        buf = real_take(nbytes)
        with lock:
            if buf.data_ptr() in held:
                clash.append(buf.data_ptr())
            held.add(buf.data_ptr())
        return buf

    def give(buf):
        with lock:
            held.discard(buf.data_ptr())
        real_give(buf)

    monkeypatch.setattr(sharding._PINNED, "take", take)
    monkeypatch.setattr(sharding._PINNED, "give", give)
    carries = [_carry("fft" if k % 2 else "cascade", cuda_device,
                      2000 + 1000 * k, seed=k) for k in range(5)]
    errors = []

    def worker(k):
        try:
            for _ in range(3):
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
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == [] and clash == []
    for k in range(5):
        path = str(tmp_path / f"m{k}" / CARRY_FILENAME)
        assert _read(path) == _savez_bytes(carries[k])
        assert verify_file_checksum(path) == "ok"
