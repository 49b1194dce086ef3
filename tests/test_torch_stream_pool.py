"""The stream feed's pool: the carried residual in front of each feed's
new rows, joined block by block on the device (``proc/stream.py``
``_Pool`` and ``_to_device``) instead of in a host array.

The oracle swaps the pool builder for a host join, the residual and the
new rows ``np.concatenate``-d into one array, and runs the same
increments.  Every output file and the saved carry must be byte for
byte the oracle's: an empty residual, the cascade's open-time prepad
(shorter and longer than the first block), the small residual of a
steady stream, and, in the FFT engine, a residual set longer than its
first block.  ``tpudas_stream_pool_joins_total`` counts each feed that
had a residual in front of it, by where the two were joined: on the
device, or on the host under a mesh or at a payload dtype/scale seam.
"""

import os

import numpy as np
import pytest
import torch

from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.io.tdas import write_tdas
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel.mesh import make_mesh
from tpudas_torch.proc import stream as tstream
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.testing import make_synthetic_spool

FS = 100.0
NCH = 6
T0 = np.datetime64("2023-03-22T00:00:00")
JOINS = "tpudas_stream_pool_joins_total"

# (engine, increment ends in s after T0, feed index to give an injected
# residual or None, the residual rows each feed finds in front of it).
# At 100 Hz into 1 Hz the cascade's prepad is 1,349 rows: 0.5 s of new
# rows make a 1,400-row pool whose first block is 800 rows, all prepad,
# and leave no residual; 3 s make a first block of 1,600 rows that
# crosses the seam and leave 50 rows.
CASES = {
    "cascade-prepad-longer-than-block-then-empty": (
        "auto", (0.5, 35, 61), None, [1349, 0, 50]),
    "cascade-prepad-then-small": ("auto", (3, 35, 61, 100), None,
                                  [1349, 50, 50, 50]),
    "fft-empty-then-small": ("fft", (3, 35, 61, 100), None,
                             [0, 45, 45, 85]),
    "fft-residual-longer-than-block": ("fft", (3, 35, 61), 1,
                                       [0, 300, 44]),
}
INJECTED_ROWS = 300
_POOL = tstream._pool


def _spool(directory, scale, n_files=4):
    make_synthetic_spool(directory, n_files=n_files, file_duration=30.0,
                         fs=FS, n_ch=NCH, noise=0.01, format="tdas",
                         write_kwargs={"dtype": "int16", "scale": scale})
    return str(directory)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return _spool(tmp_path_factory.mktemp("pool-src"), 1e-4)


@pytest.fixture(scope="module")
def seam_src(tmp_path_factory):
    """The same stream, its last two files quantized at another scale:
    the feed after the change finds an int16 residual of the old
    scale in front of rows of the new one."""
    a = _spool(tmp_path_factory.mktemp("seam-a"), 1e-4)
    b = _spool(tmp_path_factory.mktemp("seam-b"), 2e-4)
    out = tmp_path_factory.mktemp("seam-src")
    for i, name in enumerate(sorted(os.listdir(a))):
        os.link(os.path.join(a if i < 2 else b, name), os.path.join(out, name))
    return str(out)


class _TdasOutputs(LFProc):
    """Writes each output as tdas under its stem (the card's host has no
    h5py for the dasdae files)."""

    def _write_output(self, patch, path):
        write_tdas(patch, os.path.splitext(path)[0] + ".tdas")


def _host_join(carry, new, qs, mesh):
    """The oracle: the residual and the new rows joined into one host
    array, every block a slice of it."""
    res = carry.residual
    if res is None or res.size == 0 or not tstream._same_payload(
            carry, new, qs):
        return _POOL(carry, new, qs, mesh)
    joined = np.concatenate([res, new], axis=0)
    return tstream._Pool(joined[:0], joined, qs)


def _run(src, out, engine, ends, inject=None, device="cpu", mesh=None):
    """Feed the increments ``ends``; returns the residual rows each feed
    found in front of its new rows."""
    lfp = _TdasOutputs(tspool(src).sort("time").update(), device=device,
                       mesh=mesh)
    lfp.update_processing_parameter(output_sample_interval=1.0,
                                    process_patch_size=40, edge_buff_size=8,
                                    engine=engine)
    lfp.set_output_folder(out, delete_existing=True)
    carry = lfp.open_stream(T0)
    heads = []
    builder = tstream._pool

    def spy(carry, new, qs, mesh):
        heads.append(0 if carry.residual is None
                     else int(carry.residual.shape[0]))
        return builder(carry, new, qs, mesh)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tstream, "_pool", spy)
        for i, end in enumerate(ends):
            if i == inject:
                rows = np.arange(INJECTED_ROWS * NCH) % 997 - 498
                carry.residual = rows.reshape(INJECTED_ROWS, NCH).astype(
                    carry.residual.dtype)
            lfp.process_stream_increment(
                carry, T0 + np.timedelta64(int(end * 1000), "ms"))
    finally:
        mp.undo()
    tstream.save_carry(carry, out)
    return heads


def _assert_same_bytes(out, ref):
    names = sorted(n for n in os.listdir(ref) if n.startswith("LFDAS_"))
    assert names and names == sorted(
        n for n in os.listdir(out) if n.startswith("LFDAS_"))
    for name in (*names, tstream.CARRY_FILENAME):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def _compare(src, tmp_path, case, device):
    engine, ends, inject, heads = CASES[case]
    ref = str(tmp_path / "host")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstream, "_pool", _host_join)
        _run(src, ref, engine, ends, inject, device)
    reg = MetricsRegistry()
    out = str(tmp_path / "device")
    with use_registry(reg):
        got = _run(src, out, engine, ends, inject, device)
    assert got == heads
    _assert_same_bytes(out, ref)
    assert reg.value(JOINS, where="device") == sum(h > 0 for h in heads)
    assert reg.value(JOINS, where="host") == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_join_is_the_host_join(src, tmp_path, case):
    _compare(src, tmp_path, case, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_join_is_the_host_join_on_the_card(src, tmp_path, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _compare(src, tmp_path, case, "cuda")


def test_mesh_joins_on_the_host(src, tmp_path):
    """The sharded step takes host blocks: each residual is joined on
    the host, and the files are the single device's bytes."""
    engine, ends, _, heads = CASES["cascade-prepad-then-small"]
    ref = str(tmp_path / "single")
    _run(src, ref, engine, ends)
    reg = MetricsRegistry()
    out = str(tmp_path / "mesh")
    with use_registry(reg):
        got = _run(src, out, engine, ends, mesh=make_mesh(2, device="cpu"))
    assert got == heads
    _assert_same_bytes(out, ref)
    assert reg.value(JOINS, where="host") == len(heads)
    assert reg.value(JOINS, where="device") == 0


@pytest.mark.parametrize("engine", ["auto", "fft"])
def test_a_scale_seam_joins_on_the_host(seam_src, tmp_path, engine):
    """The feed whose int16 residual has another scale than its new rows
    is dequantized and joined on the host, and so is the next, whose
    residual is then float32; the others join on the device."""
    reg = MetricsRegistry()
    with use_registry(reg):
        heads = _run(seam_src, str(tmp_path / "o"), engine,
                     (3, 35, 61, 100))
    assert reg.value("tpudas_stream_ingest_host_dequant_total") == 2
    assert reg.value(JOINS, where="host") == 2
    assert reg.value(JOINS, where="device") == sum(h > 0 for h in heads) - 2
    assert reg.value(JOINS, where="device") >= 1


@pytest.mark.parametrize("head,body", [(0, 7), (5, 7), (13, 3)])
def test_pieces_and_tail_cover_the_joined_rows(head, body):
    """Every row range of the pool, and every tail, is the same range of
    the host join, in one piece or two across the seam."""
    rng = np.random.default_rng(head * 31 + body)
    h = rng.integers(-9, 9, (head, 3)).astype(np.int16)
    b = rng.integers(-9, 9, (body, 3)).astype(np.int16)
    pool = tstream._Pool(h, b, 1e-4)
    joined = np.concatenate([h, b], axis=0)
    assert pool.rows == joined.shape[0]
    for off in range(pool.rows):
        for n in range(1, pool.rows - off + 1):
            pieces = pool.pieces(off, n)
            assert 1 <= len(pieces) <= 2
            assert all(p.shape[0] for p in pieces)
            assert len(pieces) == 2 or off >= head or off + n <= head
            np.testing.assert_array_equal(np.concatenate(pieces),
                                          joined[off : off + n])
            x = tstream._to_device(pieces, "cpu")
            np.testing.assert_array_equal(x.numpy(), joined[off : off + n])
    for start in range(pool.rows + 1):
        tail = pool.tail(start)
        assert tail.dtype == np.int16
        np.testing.assert_array_equal(tail, joined[start:])
        if tail.size:
            assert not np.shares_memory(tail, h) and not np.shares_memory(
                tail, b)
