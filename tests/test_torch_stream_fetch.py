"""The FFT stream's flush fetches only the filtered rows its lerp reads
(``proc/stream.py`` ``_fft_flush``): the rows around each due output
and the block's last row, the next seam, gathered on the block's device
and copied to the host in one piece, instead of the whole block joined
to the seam in a host array.

The oracle is the whole-block flush kept below: the block copied to the
host, the seam ``np.concatenate``-d in front of it, the lerp over that
array.  Every emitted output and the saved carry must be byte for byte
the oracle's, over single flushes built to hit each branch of the index
plan (an empty seam, no output due, fewer than two rows, ``skip_left``,
outputs on a row, the last output clamped onto the block's last row, a
grid dense enough that every row is read) and over whole streams of 16
and 64 channels fed unevenly (int16 and float32), a resume from a saved
carry, a channel-sharded mesh and a batched fleet member.
``tpudas_stream_fetch_rows_total`` counts the distinct filtered rows
each flush needed.
"""

import hashlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpudas_torch.fleet import (
    FleetEngine,
    StreamConfig,
    StreamSpec,
    build_runner,
    drive,
)
from tpudas_torch.io.spool import spool as tspool
from tpudas_torch.io.tdas import write_tdas
from tpudas_torch.obs.registry import MetricsRegistry, use_registry
from tpudas_torch.parallel.mesh import make_mesh
from tpudas_torch.proc import stream as tstream
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.testing import make_synthetic_spool

FETCH = "tpudas_stream_fetch_rows_total"
FS = 100.0
T0 = np.datetime64("2023-03-22T00:00:00")
D = 10_000_000  # the input sample step at 100 Hz, ns
C = 5


def _whole_block_flush(lfp, carry, patch, filt_dev, blk_rows, t_blk0,
                       t_disp, clock, needed=None):
    """The oracle: the whole filtered block on the host, the seam joined
    in front of it, the lerp over the joined array.  ``needed`` collects
    the distinct filtered rows the block's lerp and seam read."""
    d = carry.d_ns
    filt = filt_dev.cpu().numpy()
    tstream._count_block(blk_rows, "fft", t_disp)
    tail = carry.bufs[1]
    rows = (np.concatenate([tail, filt], axis=0) if tail.size
            else filt)
    t_row0 = t_blk0 - tail.shape[0] * d
    t_last = t_row0 + (rows.shape[0] - 1) * d
    carry.bufs = (carry.bufs[0], rows[-1:].copy())
    carry.consumed += blk_rows
    read = {rows.shape[0] - 1}
    try:
        if t_last < carry.next_emit_ns or rows.shape[0] < 2:
            return
        n = int((t_last - carry.next_emit_ns) // carry.step_ns) + 1
        g = carry.next_emit_ns + carry.step_ns * np.arange(
            n, dtype=np.int64)
        offs = g - t_row0
        idx = offs // d
        w = (offs - idx * d) / float(d)
        sel = idx >= rows.shape[0] - 1
        idx[sel] = rows.shape[0] - 2
        w[sel] = 1.0
        read |= set(idx.tolist()) | set((idx + 1).tolist())
        out = rows[idx] * (1.0 - w[:, None]).astype(np.float32) + rows[
            idx + 1
        ] * w[:, None].astype(np.float32)
        s = min(carry.skip_left, out.shape[0])
        carry.skip_left -= s
        tstream._emit(lfp, carry, patch,
                      out[s:].astype(np.float32, copy=False),
                      rows=blk_rows, ran="fft")
    finally:
        if needed is not None:
            needed.append(sum(r >= tail.shape[0] for r in read))


# ---------------------------------------------------------------------------
# single flushes: each branch of the index plan


class _Sink:
    """The flush's view of an LFProc: timings and the output write, here
    kept in memory."""

    def __init__(self):
        self.timings = {"compute_s": 0.0, "device_s": 0.0}
        self.written = []

    def _emit_window_output(self, patch, times, dt, out, ran, rows):
        self.written.append((np.asarray(times).tobytes(), dt,
                             np.array(out).dtype.str, np.array(out).shape,
                             np.array(out).tobytes(), ran, rows))


_CLOCK = SimpleNamespace(seconds=lambda t: t)

# name: (seam rows, block rows, first due output after the seam row's
# time in ns, output step in ns, skip_left)
FLUSHES = {
    "first-block-empty-seam": (0, 256, 37 * D + 3_000_000,
                               50 * D + 1_000_000, 0),
    "output-between-seam-and-block": (1, 256, 4_000_000, 100 * D, 0),
    "no-output-in-block": (1, 256, 300 * D, 100 * D, 0),
    "fewer-than-two-rows": (0, 1, 0, 100 * D, 0),
    "skip-left-part": (1, 512, 5 * D + 2_000_000, 60 * D, 3),
    "skip-left-all": (1, 512, 5 * D + 2_000_000, 60 * D, 20),
    "outputs-on-rows": (1, 256, 5 * D, 7 * D, 0),
    "last-output-clamped": (1, 256, 136 * D, 40 * D, 0),
    "dense-every-row": (1, 256, 0, D, 0),
    "dense-upsampled": (0, 128, 0, D // 2, 0),
}


def _flush_carry(n_tail, first, step, skip, seam):
    t_row0 = 7 * 10**9
    carry = tstream.StreamCarry(
        start_ns=0, step_ns=step, dt_out=step / 1e9, buff_out=0, order=4,
        engine_req="fft", patch_out=40, kind="fft", d_ns=D, n_ch=C,
        edge_in=4, bufs=(np.zeros((8, C), np.float32), seam[:n_tail]),
        skip_left=skip, next_ingest_ns=t_row0 + 10**9,
        next_emit_ns=t_row0 + first)
    return carry, t_row0 + n_tail * D


def _flush_once(flush, case, device, tmp_path, name):
    n_tail, n_filt, first, step, skip = FLUSHES[case]
    rng = np.random.default_rng(n_filt * 7 + first % 1009)
    seam = rng.standard_normal((1, C)).astype(np.float32)
    filt = torch.from_numpy(
        rng.standard_normal((n_filt, C)).astype(np.float32)).to(device)
    carry, t_blk0 = _flush_carry(n_tail, first, step, skip, seam)
    sink = _Sink()
    flush(sink, carry, None, filt, n_filt, t_blk0, 0.0, _CLOCK)
    folder = str(tmp_path / name)
    os.makedirs(folder)
    tstream.save_carry(carry, folder)
    with open(os.path.join(folder, tstream.CARRY_FILENAME), "rb") as fh:
        saved = fh.read()
    seam_out = carry.bufs[1]
    assert isinstance(seam_out, np.ndarray)
    return sink.written, (seam_out.dtype.str, seam_out.shape,
                          seam_out.tobytes()), saved, carry


def _compare_flush(case, device, tmp_path):
    needed = []

    def oracle(*a):
        _whole_block_flush(*a, needed=needed)

    want = _flush_once(oracle, case, device, tmp_path, "oracle")
    reg = MetricsRegistry()
    with use_registry(reg):
        got = _flush_once(tstream._fft_flush, case, device, tmp_path, "got")
    assert got[:3] == want[:3]
    for key in ("skip_left", "next_emit_ns", "last_emit_ns", "emitted",
                "consumed"):
        assert getattr(got[3], key) == getattr(want[3], key), key
    assert reg.value(FETCH, engine="fft") == needed[0]
    return got[0], needed[0]


@pytest.mark.parametrize("case", sorted(FLUSHES))
def test_flush_is_the_whole_block_flush(case, tmp_path):
    written, fetched = _compare_flush(case, "cpu", tmp_path)
    n_tail, n_filt, _, step, skip = FLUSHES[case]
    emitted = sum(w[3][0] for w in written)
    if case in ("no-output-in-block", "fewer-than-two-rows"):
        assert emitted == 0 and fetched == 1
    elif case == "skip-left-all":
        # the skipped outputs are lerped and dropped, as ever
        assert emitted == 0 and fetched > 1
    else:
        assert emitted > 0
    if case.startswith("dense"):
        assert fetched == n_filt
    elif n_filt > 2:
        assert fetched < n_filt


def test_a_one_hertz_block_at_one_kilohertz_fetches_its_lerp_rows(tmp_path):
    """The catch-up block of the 10,000-ch deployment, at 2 ch: 59,904
    rows at 1 kHz into a 1 s grid read two rows an output and the last
    row, about 121 of 59,904."""
    d, step, n_filt = 1_000_000, 10**9, 59_904
    filt = torch.from_numpy(np.arange(n_filt * 2, dtype=np.float32)
                            .reshape(n_filt, 2))
    carry = tstream.StreamCarry(
        start_ns=0, step_ns=step, dt_out=1.0, buff_out=0, order=4,
        engine_req="fft", patch_out=60, kind="fft", d_ns=d, n_ch=2,
        edge_in=10_000, bufs=(np.zeros((2, 2), np.float32),
                              np.zeros((1, 2), np.float32)),
        next_emit_ns=5 * 10**9 + 250_500)
    reg = MetricsRegistry()
    sink = _Sink()
    with use_registry(reg):
        tstream._fft_flush(sink, carry, None, filt, n_filt,
                           5 * 10**9 - 3_000_000, 0.0, _CLOCK)
    (written,) = sink.written
    n_out = written[3][0]
    assert n_out == 60
    assert reg.value(FETCH, engine="fft") == 2 * n_out + 1 <= 121


# ---------------------------------------------------------------------------
# whole streams


class _TdasOutputs(LFProc):
    """Writes each output as tdas under its stem (the card's host has no
    h5py for the dasdae files)."""

    def _write_output(self, patch, path):
        write_tdas(patch, os.path.splitext(path)[0] + ".tdas")


@pytest.fixture(scope="module")
def spools(tmp_path_factory):
    """``spools(n_ch, dtype)``: a 120 s tdas spool at 100 Hz, made once
    a module for each width and payload dtype."""
    made = {}

    def get(n_ch, dtype):
        if (n_ch, dtype) not in made:
            d = tmp_path_factory.mktemp(f"fetch-src-{n_ch}-{dtype}")
            kw = ({"dtype": "int16", "scale": 1e-4} if dtype == "int16"
                  else {})
            make_synthetic_spool(d, n_files=4, file_duration=30.0, fs=FS,
                                 n_ch=n_ch, noise=0.01, format="tdas",
                                 write_kwargs=kw)
            made[n_ch, dtype] = str(d)
        return made[n_ch, dtype]

    return get


def _at(end):
    return T0 + np.timedelta64(int(round(end * 1000)), "ms")


def _lfp(src, out, dt=1.0, mesh=None, fresh=True):
    lfp = _TdasOutputs(tspool(src).sort("time").update(), device="cpu",
                       mesh=mesh)
    lfp.update_processing_parameter(output_sample_interval=dt,
                                    process_patch_size=40, edge_buff_size=8,
                                    engine="fft")
    lfp.set_output_folder(out, delete_existing=fresh)
    return lfp


def _stream(src, out, ends, dt=1.0, mesh=None, stop=None):
    """Feed the increments ``ends`` (seconds after T0) into a fresh
    stream and save its carry; with ``stop``, save after that many
    increments and feed the rest to a new LFProc resumed from the saved
    carry."""
    lfp = _lfp(src, out, dt, mesh)
    carry = lfp.open_stream(T0)
    for i, end in enumerate(ends):
        if i == stop:
            tstream.save_carry(carry, out)
            lfp = _lfp(src, out, dt, mesh, fresh=False)
            carry = tstream.load_carry(out)
            assert isinstance(carry.bufs[1], np.ndarray)
        lfp.process_stream_increment(carry, _at(end))
    tstream.save_carry(carry, out)
    return carry


def _oracle(run, *args, sizes=None, **kw):
    """``run`` with every FFT flush the whole-block oracle; returns its
    result and the filtered rows each block's flush needed.  ``sizes``
    collects each flush's (seam rows, block rows)."""
    needed = []

    def flush(lfp, carry, patch, filt_dev, blk_rows, *a):
        if sizes is not None:
            sizes.append((carry.bufs[1].shape[0], blk_rows))
        _whole_block_flush(lfp, carry, patch, filt_dev, blk_rows, *a,
                           needed=needed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstream, "_fft_flush", flush)
        return run(*args, **kw), needed


def _shas(folder) -> dict:
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith("LFDAS_") or name == tstream.CARRY_FILENAME:
            with open(os.path.join(folder, name), "rb") as fh:
                out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _assert_same_bytes(out, ref):
    got, want = _shas(out), _shas(ref)
    assert tstream.CARRY_FILENAME in want and len(want) > 1
    assert got == want


# name: (channels, payload dtype, increment ends in s, output interval)
STREAMS = {
    "16ch-int16": (16, "int16", (3, 35, 61, 100), 1.0),
    "16ch-f32": (16, "float32", (0.5, 17, 44.3, 100, 119.99), 1.0),
    "64ch-int16": (64, "int16", (11.1, 12, 59.7, 120), 1.0),
    "64ch-f32": (64, "float32", (3, 35, 61, 100), 1.0),
    "16ch-int16-every-other-row": (16, "int16", (3, 9.5), 0.02),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_is_the_whole_block_stream(spools, tmp_path, case):
    n_ch, dtype, ends, dt = STREAMS[case]
    src = spools(n_ch, dtype)
    ref = str(tmp_path / "oracle")
    _, needed = _oracle(_stream, src, ref, ends, dt)
    reg = MetricsRegistry()
    out = str(tmp_path / "gathered")
    with use_registry(reg):
        _stream(src, out, ends, dt)
    _assert_same_bytes(out, ref)
    blocks = reg.value("tpudas_stream_blocks_total", engine="fft")
    assert blocks == len(needed) >= 2
    assert reg.value(FETCH, engine="fft") == sum(needed)
    consumed = reg.value("tpudas_stream_samples_consumed_total",
                         engine="fft")
    if dt == 1.0:
        assert sum(needed) < consumed / 10
    else:
        assert max(needed) == 128


def test_one_row_blocks(spools, tmp_path, monkeypatch):
    """Feed quantum 1: the stream's first block is one row, fewer than
    the lerp's two, and later blocks take every odd size."""
    monkeypatch.setattr(tstream, "_FFT_QUANTUM", 1)
    src = spools(16, "float32")
    ends = (0, 0.011, 0.5, 13.37, 40)
    ref = str(tmp_path / "oracle")
    sizes = []
    _, needed = _oracle(_stream, src, ref, ends, sizes=sizes)
    assert sizes[0] == (0, 1)
    assert any(n % 2 for _, n in sizes[1:])
    reg = MetricsRegistry()
    out = str(tmp_path / "gathered")
    with use_registry(reg):
        _stream(src, out, ends)
    _assert_same_bytes(out, ref)
    assert reg.value(FETCH, engine="fft") == sum(needed)


def test_resume_is_the_uninterrupted_stream(spools, tmp_path):
    """A stream stopped after two increments and resumed from its saved
    carry (the seam and the overlap-save rows loaded as numpy) writes the
    bytes of the uninterrupted whole-block stream."""
    src = spools(16, "int16")
    ends = STREAMS["16ch-int16"][2]
    ref = str(tmp_path / "control")
    _oracle(_stream, src, ref, ends)
    out = str(tmp_path / "resumed")
    _stream(src, out, ends, stop=2)
    _assert_same_bytes(out, ref)


def test_mesh_is_the_single_device_stream(spools, tmp_path):
    """Under a 2-shard channel mesh the filtered block comes back
    gathered at the logical width on one device; its rows are fetched
    the same way, and the bytes are the single device's whole-block
    stream's."""
    src = spools(16, "int16")
    ends = STREAMS["16ch-int16"][2]
    ref = str(tmp_path / "single")
    _, needed = _oracle(_stream, src, ref, ends)
    reg = MetricsRegistry()
    out = str(tmp_path / "mesh")
    with use_registry(reg):
        _stream(src, out, ends, mesh=make_mesh(2, device="cpu"))
    _assert_same_bytes(out, ref)
    assert reg.value(FETCH, engine="fft") == sum(needed)


def test_batched_fleet_member_is_its_solo_stream(spools, tmp_path):
    """Two FFT streams through the batched fleet (each step at its
    member's width, through the executor's rendezvous): each member's
    files and carry are its solo run's under the whole-block flush."""
    widths = {"a": 16, "b": 64}
    srcs = {sid: spools(w, "int16")
            for sid, w in widths.items()}
    cfg = dict(kind="lowpass", start_time=str(T0),
               output_sample_interval=1.0, edge_buffer=8.0,
               process_patch_size=40, poll_interval=0.0, poll_jitter=0.0,
               engine="fft")
    specs = [StreamSpec(stream_id=sid, source=src,
                        config=StreamConfig(**cfg))
             for sid, src in srcs.items()]
    root = str(tmp_path / "fleet")
    reg = MetricsRegistry()
    with use_registry(reg):
        FleetEngine(root, specs, sleep_fn=lambda _s: None, batched=True,
                    device="cpu").run()
    assert reg.value("tpudas_fleet_batch_solo_launches_total") > 0
    assert reg.value(FETCH, engine="fft") > 0
    for spec in specs:
        ctrl = str(tmp_path / "solo")

        def solo(spec=spec, ctrl=ctrl):
            return drive(build_runner(spec, root=ctrl, device="cpu"),
                         sleep_fn=lambda _s: None)

        _oracle(solo)
        _assert_same_bytes(os.path.join(root, spec.stream_id),
                           os.path.join(ctrl, spec.stream_id))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLUSHES))
def test_flush_is_the_whole_block_flush_on_the_card(case, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _compare_flush(case, "cuda", tmp_path)
