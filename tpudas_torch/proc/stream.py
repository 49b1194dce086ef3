"""Stateful streaming for LFProc: carry the filter state across polling
rounds instead of rewinding the edge buffer.

The port's counterpart of :mod:`tpudas.proc.stream`.  The rewind resume
re-reads and re-filters ~2x the filter's edge support of full-rate data
every round only to rebuild transient state the previous round already
computed.  This module carries that state — the cascade's per-stage
trailing rows (:func:`tpudas_torch.ops.fir.cascade_decimate_stream`),
O(1) per channel — so each input sample is read and filtered once.

The carry's leaves stay on the device between blocks and rounds as
torch tensors; they cross to the host only in :func:`save_carry`.  Under
a channel-only mesh (``LFProc(mesh=...)`` with a ``time`` axis of size
1, see :mod:`tpudas_torch.parallel`) every leaf is a
:class:`~tpudas_torch.parallel.sharding.ShardedTensor` on the mesh's
devices between rounds, and :func:`save_carry` gathers and trims it to
the logical width on the save cadence only, so the ``.npz`` is byte for
byte the unsharded one.

Crash-only property: the carry serializes to ONE ``.npz`` beside the
output files (meta embedded as JSON, written tmp-then-rename with a
crc32 ``.crc`` sidecar and a ``.prev`` double buffer, plus a readable
checksummed ``.json`` sidecar), with the JAX package's keys, meta and
dtypes, so a carry written by either package resumes under the other.
The save happens AFTER the round's output writes, so the carry is never
ahead of the outputs; :func:`reconcile_outputs` deletes outputs newer
than the carry on resume (they are regenerated identically: file names
are deterministic).  A folder with outputs but no carry is a rewind-mode
folder; the driver continues it in rewind mode.

Ingest is pipelined: a bounded prefetch thread
(:mod:`tpudas_torch.proc.ingest`) reads and decodes the next slice while
the device filters the current one, raw int16 payloads go to the device
undecoded (dequantized on the device), and each block's host sync is
deferred by the prefetch depth.  Feed order and math equal the
synchronous loop (``TPUDAS_INGEST_PREFETCH=0``).

Emission alignment: the output grid is ``start + k * step`` (ms
quantized, the batch contract).  A cold stream anchors at the first grid
point covered by data and discards the first ``edge_buff_size`` outputs
— the stream-start edge the batch scheduler discards — plus the carry's
warm-up (:func:`tpudas_torch.ops.fir.stream_warmup_outputs`).  After
that every emitted output has its full filter support.

An output grid the cascade cannot serve (not sample-aligned, or a
decimation ratio with a prime factor above 8), or ``engine="fft"``,
opens the FFT stream engine instead: an overlap-save carry of the last
``2 * edge_in`` raw input rows on the device
(:func:`tpudas_torch.ops.filter.fft_pass_filter_stream`) plus a one-row
lerp seam on the host, emitted onto the output grid by a host lerp
over the few filtered rows it reads, gathered on the device — the JAX
package's ``_consume_fft``, with the same ``edge_in``,
``skip_left`` and emit schedule and the same ``.npz`` carry, so an FFT
carry also resumes across the packages.  A kernel fault raises; there
is no fallback engine.
"""

from __future__ import annotations

import functools
import json
import os
import time
from contextlib import ExitStack
from dataclasses import dataclass

import numpy as np
import torch

from tpudas_torch.core.timeutils import quantize_step, to_datetime64
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.logging import log_event
from tpudas_torch.utils.profiling import EventTimer

__all__ = [
    "StreamCarry",
    "CARRY_FILENAME",
    "save_carry",
    "load_carry",
    "discard_carry",
    "reconcile_outputs",
    "open_stream",
    "carry_matches",
    "process_increment",
]

CARRY_FILENAME = ".stream_carry.npz"
CARRY_SIDECAR = ".stream_carry.json"
_VERSION = 1


@dataclass
class StreamCarry:
    """The O(1) resume state of a stateful stream.

    Configuration fields are fixed at :func:`open_stream`; engine
    fields stay ``None`` until the first data arrives (``kind`` is the
    open marker).  ``bufs`` holds torch tensors on the device between
    blocks, or numpy arrays after a load (moved to the device at the
    next block).
    """

    # configuration (validated against the driver's parameters on resume)
    start_ns: int  # output-grid anchor (the run's start_time)
    step_ns: int  # ms-quantized output grid step
    dt_out: float  # output_sample_interval seconds
    buff_out: int  # edge_buff_size (output samples discarded cold)
    order: int
    engine_req: str  # "auto" | "fft" | "cascade" | "fused"
    patch_out: int  # process_patch_size (stream chunk sizing)
    # engine state (None/zero until the stream sees data)
    kind: str | None = None  # "cascade" | "fft"
    d_ns: int | None = None  # input sample step
    n_ch: int | None = None
    ratio: int | None = None
    edge_in: int | None = None  # fft only: input rows of filter support
    # cascade: one leaf per stage; fft: (overlap-save rows, lerp seam)
    bufs: tuple = ()
    residual: np.ndarray | None = None  # read-but-unconsumed rows
    # dequant scale of the rows held in ``residual`` (None = float32
    # rows): raw int16 payloads stay int16 from the host payload to the
    # first device read, so the residual must remember its scale
    residual_scale: float | None = None
    skip_left: int = 0  # outputs still to discard (warm-up + cold edge)
    next_ingest_ns: int | None = None  # next input sample to read
    next_emit_ns: int | None = None  # next output grid time to emit
    last_emit_ns: int | None = None  # newest output written (reconcile key)
    consumed: int = 0  # full-rate samples fed through the filter
    emitted: int = 0  # output samples written
    # the JAX package latches this False after a Pallas failure; the
    # port has no fallback engine and only carries the flag through the
    # file so both packages read each other's carry
    pallas_ok: bool = True

    def _meta(self) -> dict:
        return {
            "version": _VERSION,
            "start_ns": int(self.start_ns),
            "step_ns": int(self.step_ns),
            "dt_out": float(self.dt_out),
            "buff_out": int(self.buff_out),
            "order": int(self.order),
            "engine_req": self.engine_req,
            "patch_out": int(self.patch_out),
            "kind": self.kind,
            "d_ns": None if self.d_ns is None else int(self.d_ns),
            "n_ch": None if self.n_ch is None else int(self.n_ch),
            "ratio": None if self.ratio is None else int(self.ratio),
            "edge_in": None if self.edge_in is None else int(self.edge_in),
            "n_bufs": len(self.bufs),
            "residual_scale": (
                None if self.residual_scale is None
                else float(self.residual_scale)
            ),
            "skip_left": int(self.skip_left),
            "next_ingest_ns": _opt_int(self.next_ingest_ns),
            "next_emit_ns": _opt_int(self.next_emit_ns),
            "last_emit_ns": _opt_int(self.last_emit_ns),
            "consumed": int(self.consumed),
            "emitted": int(self.emitted),
            "pallas_ok": bool(self.pallas_ok),
        }


def _opt_int(v):
    return None if v is None else int(v)


def save_carry(carry: StreamCarry, folder: str) -> str:
    """Atomically persist the carry beside the output files: one
    crc32-stamped ``.npz`` (meta embedded, unique tmp + rename, ``.crc``
    sidecar) plus a readable checksummed ``.json`` sidecar.  The
    outgoing primary survives as ``.prev`` — the middle rung of
    :func:`load_carry`'s ladder.  The only point where the device
    leaves cross to the host (``stream.carry_gather``): card leaves are
    copied into a page-locked staging buffer, sharded (pad-and-masked)
    leaves joined and trimmed to the logical channel width first,
    counted as ``tpudas_parallel_transfer_bytes_total{direction=
    "gather"}`` (raise the save cadence to amortize it).  The ``.npz``
    (``np.savez``'s bytes) is then streamed from those arrays into its
    tmp file under one crc pass, and renamed with its sidecars
    (``stream.carry_write``).  Returns the npz path."""
    from tpudas_torch.integrity.checksum import (
        rotate_prev,
        write_json_checksummed,
        write_npz_checksummed,
    )
    from tpudas_torch.parallel.sharding import staged_leaves
    from tpudas_torch.resilience.faults import fault_point

    path = os.path.join(folder, CARRY_FILENAME)
    fault_point("carry.save", folder=folder)
    with span("stream.carry_save"), ExitStack() as stack:
        # parallel.gather stays a child of the save, as the JAX
        # package's gather is (the flight ring records two levels)
        with span("parallel.gather", leaves=len(carry.bufs)), \
                span("stream.carry_gather"):
            leaves = stack.enter_context(
                staged_leaves(carry.bufs, carry.n_ch))
        with span("stream.carry_write"):
            arrays = {"meta": np.asarray(json.dumps(carry._meta()))}
            for i, b in enumerate(leaves):
                arrays[f"buf_{i}"] = b
            if carry.residual is not None:
                res = np.asarray(carry.residual)
                if res.dtype != np.int16:  # raw quantized rows stay int16
                    res = res.astype(np.float32, copy=False)
                arrays["residual"] = res
            rotate_prev(path)
            write_npz_checksummed(path, arrays)
            write_json_checksummed(
                os.path.join(folder, CARRY_SIDECAR), carry._meta())
    get_registry().counter(
        "tpudas_stream_carry_saves_total", "stream carry persists"
    ).inc()
    return path


def discard_carry(folder: str) -> bool:
    """Remove a persisted carry (all its files).  Any non-stateful
    round that emits into the folder must call this: the carry is valid
    only while no output is newer than it.  Returns True when a carry
    was removed."""
    removed = False
    for name in (
        CARRY_FILENAME,
        CARRY_FILENAME + ".crc",
        CARRY_FILENAME + ".prev",
        CARRY_FILENAME + ".prev.crc",
        CARRY_SIDECAR,
    ):
        path = os.path.join(folder, name)
        if os.path.isfile(path):
            os.remove(path)
            if name in (CARRY_FILENAME, CARRY_FILENAME + ".prev"):
                removed = True
    if removed:
        log_event("stream_carry_discarded", folder=folder)
        get_registry().counter(
            "tpudas_stream_carry_discards_total",
            "persisted carries invalidated by a non-stateful write",
        ).inc()
    return removed


def _parse_carry(path: str) -> StreamCarry:
    """Parse one carry ``.npz`` into a :class:`StreamCarry`, raising on
    any defect (unreadable zip, bad meta JSON, version skew, missing
    keys).  Leaves come back as numpy arrays."""
    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        if meta.get("version") != _VERSION:
            raise ValueError(
                f"carry version skew: {meta.get('version')!r} != {_VERSION}"
            )
        bufs = tuple(f[f"buf_{i}"] for i in range(int(meta["n_bufs"])))
        residual = f["residual"] if "residual" in f else None
        return StreamCarry(
            start_ns=meta["start_ns"],
            step_ns=meta["step_ns"],
            dt_out=meta["dt_out"],
            buff_out=meta["buff_out"],
            order=meta["order"],
            engine_req=meta["engine_req"],
            patch_out=meta["patch_out"],
            kind=meta["kind"],
            d_ns=meta["d_ns"],
            n_ch=meta["n_ch"],
            ratio=meta["ratio"],
            edge_in=meta["edge_in"],
            bufs=bufs,
            residual=residual,
            residual_scale=meta.get("residual_scale"),
            skip_left=meta["skip_left"],
            next_ingest_ns=meta["next_ingest_ns"],
            next_emit_ns=meta["next_emit_ns"],
            last_emit_ns=meta["last_emit_ns"],
            consumed=meta["consumed"],
            emitted=meta["emitted"],
            pallas_ok=bool(meta.get("pallas_ok", True)),
        )


def load_carry(folder: str) -> StreamCarry | None:
    """Load a saved carry through the verified-read ladder: the
    checksum-verified primary, then the ``.prev`` double buffer (one
    round back — :func:`reconcile_outputs` regenerates that round), then
    None (the driver continues in rewind mode).  Every rejected rung is
    logged (``integrity_fallback``)."""
    from tpudas_torch.integrity.checksum import (
        count_fallback,
        verify_file_checksum,
    )

    path = os.path.join(folder, CARRY_FILENAME)
    prev = path + ".prev"
    if not os.path.isfile(path) and not os.path.isfile(prev):
        return None
    for cand in (path, prev):
        if not os.path.isfile(cand):
            if cand == path:
                # the crash window between the save's rotate and write
                count_fallback("carry", "primary missing", cand)
            continue
        try:
            if verify_file_checksum(cand, artifact="carry") == "mismatch":
                raise ValueError("carry checksum mismatch")
            carry = _parse_carry(cand)
        except Exception as exc:
            log_event(
                "stream_carry_unreadable", path=cand,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            get_registry().counter(
                "tpudas_stream_carry_unreadable_total",
                "corrupt/unreadable carries degraded to .prev or "
                "rewind mode",
            ).inc()
            count_fallback(
                "carry", f"{type(exc).__name__}: {str(exc)[:120]}", cand
            )
            continue
        get_registry().counter(
            "tpudas_stream_carry_loads_total", "stream carries loaded"
        ).inc()
        return carry
    return None


def reconcile_outputs(folder: str, carry: StreamCarry) -> int:
    """Delete output files newer than the carry (a crash between a
    round's output writes and its carry save leaves such files; they
    are regenerated identically on resume).  Returns the count."""
    from tpudas_torch.io.spool import spool as make_spool

    cutoff = (
        None if carry.last_emit_ns is None  # nothing emitted: all stale
        else np.datetime64(int(carry.last_emit_ns), "ns")
    )
    try:
        rows = make_spool(folder).update().contents()
    except FileNotFoundError:
        return 0
    removed = 0
    for row in rows:
        t_min = np.datetime64(row["time_min"], "ns")
        if cutoff is None or t_min > cutoff:
            path = row.get("path")
            if path and not os.path.isabs(path):
                path = os.path.join(folder, path)
            if path and os.path.isfile(path):
                os.remove(path)
                removed += 1
    if removed:
        log_event("stream_reconcile_removed", files=removed)
        get_registry().counter(
            "tpudas_stream_reconcile_removed_total",
            "crashed-round output files removed on carry resume",
        ).inc(removed)
    return removed


# ---------------------------------------------------------------------------
# the resumable engine


def _ns(t) -> int:
    return int(to_datetime64(t).astype("datetime64[ns]").astype(np.int64))


def _step_ns(dt: float) -> int:
    return int(quantize_step(dt).astype("timedelta64[ns]").astype(np.int64))


def open_stream(lfp, start_time) -> StreamCarry:
    """A fresh (unopened) carry for this LFProc's parameters, anchored
    at ``start_time``.  The engine is chosen and its buffers allocated
    at the first data (:func:`process_increment`)."""
    para = lfp.parameters
    dt = float(para["output_sample_interval"])
    step_ns = _step_ns(dt)
    if step_ns <= 0:
        raise ValueError(
            f"output_sample_interval {dt} quantizes to a non-positive "
            "ms grid step"
        )
    return StreamCarry(
        start_ns=_ns(start_time),
        step_ns=step_ns,
        dt_out=dt,
        buff_out=int(para["edge_buff_size"]),
        order=int(para["filter_order"]),
        engine_req=str(para["engine"]),
        patch_out=int(para["process_patch_size"]),
    )


# engine requests that share the cascade carry layout byte for byte: a
# stream may cross between them mid-run.  "fft" stays exclusive (its
# overlap-save carry is a different object).
_CASCADE_FAMILY = ("auto", "cascade", "fused")


def _engines_compatible(old: str, new: str, kind) -> bool:
    """Whether a carry produced under engine request ``old`` may resume
    under ``new``: any crossover within the cascade family, unless the
    carry already opened the FFT engine (only possible under
    ``old == "auto"``)."""
    if old == new:
        return True
    if old in _CASCADE_FAMILY and new in _CASCADE_FAMILY:
        return kind != "fft" or new == "auto"
    return False


def carry_matches(carry: StreamCarry, lfp, start_time=None) -> bool:
    """Resume guard: the loaded carry must come from the same output
    grid, filter and engine family — and, when ``start_time`` is given,
    the same stream anchor.  ``process_patch_size`` is not compared (it
    only shapes chunking), and a compatible engine change is honored by
    the caller (:func:`_engines_compatible`)."""
    para = lfp.parameters
    if start_time is not None and carry.start_ns != _ns(start_time):
        return False
    return (
        carry.step_ns == _step_ns(float(para["output_sample_interval"]))
        and carry.buff_out == int(para["edge_buff_size"])
        and carry.order == int(para["filter_order"])
        and _engines_compatible(
            carry.engine_req, str(para["engine"]), carry.kind
        )
    )


def _corner(dt: float) -> float:
    from tpudas_torch.proc.lfproc import output_corner

    return output_corner(dt)


class _EmitPipeline:
    """FIFO of dispatched-but-unsynced stream blocks: each entry is a
    closure that syncs the block's device output and emits it.  The
    device runs asynchronously, so deferring the host sync by ``depth``
    blocks lets block N+1's transfer and launch be queued while block N
    computes; ``depth`` 0 flushes every dispatch at once.  Flushes run
    in dispatch order, so every carry/emission update happens in the
    synchronous sequence; an exception abandons the unflushed suffix,
    which is the crash shape resume already reconciles."""

    __slots__ = ("depth", "_pending")

    def __init__(self, depth: int):
        self.depth = max(0, int(depth))
        self._pending: list = []

    def push(self, flush_fn) -> None:
        self._pending.append(flush_fn)
        while len(self._pending) > self.depth:
            self._pending.pop(0)()

    def flush(self) -> None:
        while self._pending:
            self._pending.pop(0)()


def process_increment(lfp, carry: StreamCarry, edtime) -> int:
    """Process all new data up to ``edtime`` through the carried filter
    state, write the outputs, and update ``carry`` in place.  Returns
    the number of output samples emitted.

    Data is loaded in bounded slices (one ``process_patch_size`` window
    of outputs each), so a backlog never materializes at once.  With
    ``TPUDAS_INGEST_PREFETCH`` > 0 (default 2) a producer thread loads
    the next slice while the device filters the current one
    (:class:`tpudas_torch.proc.ingest.SlicePrefetcher`); feed order,
    math and every written byte equal the synchronous loop."""
    from tpudas_torch.proc.ingest import (
        SlicePrefetcher,
        decode_payload,
        ingest_depth,
    )

    on_gap = lfp.parameters["on_gap"]
    t2_ns = _ns(edtime)
    emitted0 = carry.emitted
    slice_ns = max(carry.patch_out, 4) * carry.step_ns
    reg = get_registry()
    depth = ingest_depth()
    pipe = _EmitPipeline(depth)
    prefetcher = None
    try:
        with span("stream.increment", upto=str(edtime)):
            cursor0 = (
                carry.next_ingest_ns if carry.next_ingest_ns is not None
                else carry.start_ns
            )
            if depth > 0 and cursor0 <= t2_ns:
                prefetcher = SlicePrefetcher(
                    lfp, t2_ns, slice_ns, on_gap, depth, cursor0, carry.d_ns,
                )
            while True:
                t_lo_ns = (
                    carry.next_ingest_ns if carry.next_ingest_ns is not None
                    else carry.start_ns
                )
                if t_lo_ns > t2_ns:
                    break
                t_hi_ns = min(t2_ns, t_lo_ns + slice_ns)
                t_lo = np.datetime64(int(t_lo_ns), "ns")
                t_hi = np.datetime64(int(t_hi_ns), "ns")
                payload = None
                missed = False
                item = (
                    prefetcher.get(t_lo_ns, t_hi_ns) if prefetcher is not None
                    else None
                )
                if item is not None:
                    patch = item.patch
                    payload = item.payload
                else:
                    # synchronous load: prefetch off, or a miss (re-read
                    # here, resync the producer after the feed)
                    missed = prefetcher is not None
                    t0 = time.perf_counter()
                    with span("stream.load_slice"):
                        patch = lfp._load_window(t_lo, t_hi, on_gap)
                    lfp.timings["assemble_s"] += time.perf_counter() - t0
                    if patch is not None:
                        payload = decode_payload(lfp, patch)
                if patch is None:
                    # an unmergeable slice under a tolerant gap policy: skip
                    # it and cold-restart the engine at the next data.
                    # Pending blocks flush first: the reset re-anchors the
                    # emission grid.
                    pipe.flush()
                    log_event("stream_gap_skipped", t_lo=str(t_lo),
                              t_hi=str(t_hi))
                    reg.counter(
                        "tpudas_stream_gap_skips_total",
                        "stream slices skipped over unmergeable gaps",
                    ).inc()
                    _reset_engine(carry)
                    carry.next_ingest_ns = t_hi_ns + 1
                    if missed:
                        prefetcher.resync(carry.next_ingest_ns, carry.d_ns)
                    if t_hi_ns >= t2_ns:
                        break
                    continue
                _feed_patch(lfp, carry, patch, on_gap, pipe, payload)
                if (carry.next_ingest_ns is None
                        or carry.next_ingest_ns <= t_lo_ns):
                    # no ingest progress (only already-consumed samples):
                    # forcing the cursor forward beats spinning
                    log_event("stream_no_progress", t_lo=str(t_lo))
                    carry.next_ingest_ns = t_hi_ns + 1
                if missed:
                    prefetcher.resync(carry.next_ingest_ns, carry.d_ns)
                if t_hi_ns >= t2_ns:
                    break
            # every dispatched block is written before the caller saves the
            # carry (outputs-before-carry is the crash-only ordering)
            pipe.flush()
    finally:
        if prefetcher is not None:
            prefetcher.close()
    emitted = carry.emitted - emitted0
    reg.counter(
        "tpudas_stream_samples_emitted_total",
        "output samples emitted by the stateful stream",
    ).inc(emitted)
    return emitted


def _reset_engine(carry: StreamCarry) -> None:
    carry.kind = None
    carry.bufs = ()
    carry.residual = None
    carry.residual_scale = None
    carry.skip_left = 0
    carry.ratio = None
    carry.edge_in = None


def _feed_patch(lfp, carry: StreamCarry, patch, on_gap, pipe,
                payload=None) -> None:
    """Feed one loaded window into the carried engine, emitting output
    files for every grid point whose support is now complete.
    ``payload`` is the decoded ``(host, qscale)`` pair when the prefetch
    stage already decoded it (the same function the synchronous path
    uses).  Raw int16 payloads are fed raw."""
    if payload is None:
        from tpudas_torch.proc.ingest import decode_payload

        payload = decode_payload(lfp, patch)
    host, qs = payload
    t_ns = (
        np.asarray(patch.coords["time"]).astype("datetime64[ns]").astype(np.int64)
    )
    if t_ns.size == 0:
        return
    if carry.kind is None:
        d_sec = patch.get_sample_step("time")
        i0 = _open_engine(lfp, carry, host, t_ns, float(d_sec), qs)
    else:
        if host.shape[1] != carry.n_ch:
            raise ValueError(
                f"stream channel count changed: {host.shape[1]} vs "
                f"carry {carry.n_ch}"
            )
        d = carry.d_ns
        i0 = int(np.searchsorted(t_ns, carry.next_ingest_ns - d // 2))
        if i0 >= t_ns.size:
            return  # the slice held only already-consumed samples
        if t_ns[i0] - carry.next_ingest_ns > d // 2:
            # data missing between the carry position and this window:
            # a real gap at full rate
            log_event(
                "stream_gap_detected",
                expected=str(np.datetime64(int(carry.next_ingest_ns), "ns")),
                got=str(np.datetime64(int(t_ns[i0]), "ns")),
            )
            get_registry().counter(
                "tpudas_stream_gaps_detected_total",
                "full-rate gaps that cold-restarted the stream engine",
            ).inc()
            if on_gap == "raise":
                raise Exception("patch merge failed! Gap in data exists")
            # pending blocks carry the pre-gap emission grid
            pipe.flush()
            _reset_engine(carry)
            d_sec = patch.get_sample_step("time")
            i0 = _open_engine(
                lfp, carry, host[i0:], t_ns[i0:], float(d_sec), qs
            ) + i0
    new = host[i0:]
    new_t = t_ns[i0:]
    if new.shape[0] == 0:
        return
    carry.next_ingest_ns = int(new_t[-1]) + carry.d_ns
    if carry.kind == "cascade":
        _consume_cascade(lfp, carry, patch, new, qs, pipe)
    else:
        _consume_fft(lfp, carry, patch, new, int(new_t[0]), qs, pipe)


def _grid_ceil(carry: StreamCarry, t_ns: int) -> int:
    """First output-grid time >= both t_ns and the grid anchor."""
    k = max(0, -(-(int(t_ns) - carry.start_ns) // carry.step_ns))
    return carry.start_ns + k * carry.step_ns


def _open_engine(lfp, carry: StreamCarry, host, t_ns, d_sec, qs=None) -> int:
    """Choose and initialize the engine at the stream's first data.
    Returns the index of the first input row to feed.  ``qs`` is the
    payload's dequant scale: the cascade's warm-up prepad is made in the
    payload's own dtype, so a quantized stream's pool stays raw int16
    (int16 zeros dequantize to exact 0.0)."""
    from tpudas_torch.ops.fir import factor_ratio

    d_ns = int(round(d_sec * 1e9))
    if d_ns <= 0:
        raise ValueError(f"non-positive input sample step {d_sec}")
    t0 = int(t_ns[0])
    g_e = _grid_ceil(carry, t0)  # first emittable grid point
    step = carry.step_ns
    n_ch = int(host.shape[1])
    aligned = step % d_ns == 0 and (g_e - t0) % d_ns == 0
    ratio = step // d_ns if aligned else 0
    if aligned:
        try:
            factor_ratio(ratio)
        except ValueError:
            aligned = False
    if carry.engine_req == "fft":
        aligned = False
    if not aligned and carry.engine_req in ("cascade", "fused"):
        raise ValueError(
            f"engine={carry.engine_req!r} requires the output grid to "
            "land on input samples with an integer small-prime "
            "decimation ratio; use engine='auto' or 'fft'"
        )
    carry.d_ns = d_ns
    carry.n_ch = n_ch
    if aligned:
        i0 = _open_cascade(lfp, carry, host, t0, g_e, d_ns, int(ratio), qs)
    else:
        from tpudas_torch.ops.filter import fft_stream_init

        carry.kind = "fft"
        carry.edge_in = int(-(-carry.buff_out * step // d_ns))
        carry.next_emit_ns = g_e + carry.buff_out * step
        carry.bufs = (
            fft_stream_init(carry.edge_in, n_ch),
            np.zeros((0, n_ch), np.float32),  # last-row lerp seam
        )
        carry.residual = None
        i0 = 0
    log_event(
        "stream_open", kind=carry.kind, ratio=carry.ratio,
        edge_in=carry.edge_in, skip_left=carry.skip_left,
        first_emit=str(np.datetime64(int(carry.next_emit_ns), "ns")),
    )
    return i0


def _open_cascade(lfp, carry, host, t0, g_e, d_ns, ratio, qs) -> int:
    """Initialize the cascade engine; returns the first row to feed."""
    from tpudas_torch.ops.fir import (
        cascade_stream_init,
        design_cascade,
        edge_support_samples,
        stream_warmup_outputs,
    )

    step = carry.step_ns
    n_ch = int(host.shape[1])
    plan = design_cascade(1e9 / d_ns, ratio, _corner(carry.dt_out),
                          carry.order)
    supp = edge_support_samples(plan, 1e-3)
    if carry.buff_out * step < supp * d_ns:
        print(
            "Warning: edge_buff_size halo is smaller than the cascade "
            f"filter support ({supp} input samples); the stream's first "
            "emitted samples may carry start artifacts"
        )
        log_event("stream_halo_small", support=supp)
    carry.kind = "cascade"
    carry.ratio = ratio
    carry.skip_left = stream_warmup_outputs(plan) + carry.buff_out
    carry.next_emit_ns = g_e + carry.buff_out * step
    carry.bufs = cascade_stream_init(plan, n_ch, lfp.device)
    # feed origin so that stream output (warm-up + k) lands on grid
    # point g_e + k*step: the first fed sample is at g_e - delay*d
    t_feed0 = g_e - plan.delay * d_ns
    res_dtype = host.dtype if qs is not None else np.float32
    carry.residual_scale = qs
    if t_feed0 < t0:
        carry.residual = np.zeros(((t0 - t_feed0) // d_ns, n_ch), res_dtype)
        return 0
    carry.residual = np.zeros((0, n_ch), res_dtype)
    return int((t_feed0 - t0) // d_ns)


def _emit(lfp, carry: StreamCarry, patch, out, rows, ran) -> None:
    """Write ``out`` (n, C) at the carry's emission cursor."""
    n = int(out.shape[0])
    if n == 0:
        return
    times = (
        carry.next_emit_ns + carry.step_ns * np.arange(n, dtype=np.int64)
    ).astype("datetime64[ns]")
    carry.next_emit_ns = int(carry.next_emit_ns + n * carry.step_ns)
    carry.last_emit_ns = int(times[-1].astype(np.int64))
    carry.emitted += n
    lfp._emit_window_output(patch, times, carry.dt_out, out, ran, rows=rows)


def _count_block(rows: int, engine: str, t_dev: float) -> None:
    """Per-dispatched-block observability shared by both stream
    engines: block count and consumed full-rate rows by engine, and the
    synced device latency distribution."""
    reg = get_registry()
    reg.counter(
        "tpudas_stream_blocks_total",
        "stream filter blocks dispatched",
        labelnames=("engine",),
    ).inc(engine=engine)
    reg.counter(
        "tpudas_stream_samples_consumed_total",
        "full-rate samples fed through the carried filter state",
        labelnames=("engine",),
    ).inc(int(rows), engine=engine)
    reg.histogram(
        "tpudas_stream_block_seconds",
        "per-block device dispatch+sync latency",
        labelnames=("engine",),
    ).observe(t_dev, engine=engine)


def _pow2_blocks(n_units: int, cap: int) -> list:
    """Block sizes covering ``n_units``: whole ``cap``-sized blocks
    first, then a descending power-of-two split of the remainder, so a
    stream sees O(log) distinct block shapes per configuration."""
    out = [cap] * (n_units // cap)
    rem = n_units % cap
    b = 1 << max(rem.bit_length() - 1, 0)
    while rem:
        if b <= rem:
            out.append(b)
            rem -= b
        b >>= 1
    return out


class _Pool:
    """A stream feed's rows: the carried residual (``head``) in front of
    the new payload (``body``), never joined into a host array.  A block
    of rows ``[off, off + n)`` is one host piece, or two where it crosses
    the seam; :func:`_to_device` joins two in one device tensor.  ``qs``
    is the pool's dequant scale."""

    __slots__ = ("head", "body", "qs", "rows")

    def __init__(self, head, body, qs):
        self.head, self.body, self.qs = head, body, qs
        self.rows = int(head.shape[0] + body.shape[0])

    def pieces(self, off: int, n: int) -> list:
        """The host pieces covering rows ``[off, off + n)``, in order."""
        h = int(self.head.shape[0])
        end = off + n
        out = []
        if off < h:
            out.append(self.head[off : min(end, h)])
        if end > h:
            out.append(self.body[max(off - h, 0) : end - h])
        return [np.ascontiguousarray(p) for p in out]

    def tail(self, start: int):
        """A copy of rows ``[start:]``: the next feed's residual."""
        return np.concatenate(self.pieces(start, self.rows - start), axis=0)


def _count_join(where: str) -> None:
    get_registry().counter(
        "tpudas_stream_pool_joins_total",
        "stream feeds whose new rows had a carried residual in front of "
        "them, by where the two were joined",
        labelnames=("where",),
    ).inc(where=where)


def _same_payload(carry: StreamCarry, new, qs) -> bool:
    r_qs = carry.residual_scale
    return carry.residual.dtype == new.dtype and (
        (r_qs is None and qs is None)
        or (r_qs is not None and qs is not None and float(r_qs) == float(qs))
    )


def _dequant_pool(carry: StreamCarry, new, qs) -> _Pool:
    """A mid-stream dtype/scale change: that one seam is dequantized and
    joined on the host, so the pool stays uniform."""
    log_event("stream_ingest_host_dequant")
    get_registry().counter(
        "tpudas_stream_ingest_host_dequant_total",
        "stream slices dequantized on host because the payload "
        "dtype/scale changed mid-stream (the uniform-payload fast "
        "path dequantizes in-kernel)",
    ).inc()
    _count_join("host")
    residual, r_qs = carry.residual, carry.residual_scale
    r = (
        residual.astype(np.float32) * np.float32(r_qs) if r_qs is not None
        else np.asarray(residual, np.float32)
    )
    n = (
        new.astype(np.float32) * np.float32(qs) if qs is not None
        else np.asarray(new, np.float32)
    )
    joined = np.concatenate([r, n], axis=0)
    return _Pool(joined[:0], joined, None)


def _pool(carry: StreamCarry, new, qs, mesh) -> _Pool:
    """The feed's pool over the residual and the fresh payload.  Same
    dtype and scale stay two pieces, joined block by block on the device
    (a quantized pool goes to the device as int16); under a ``mesh`` the
    sharded step takes a host block and places its column shards itself,
    so the two are joined on the host and every block is one piece."""
    residual = carry.residual
    if residual is None or residual.size == 0:
        return _Pool(new[:0], new, qs)
    if not _same_payload(carry, new, qs):
        return _dequant_pool(carry, new, qs)
    if mesh is None:
        _count_join("device")
        return _Pool(residual, new, qs)
    _count_join("host")
    joined = np.concatenate([residual, new], axis=0)
    return _Pool(joined[:0], joined, qs)


def _to_device(pieces, dev):
    """One stream block on ``dev`` (``stream.h2d``,
    ``tpudas_stream_h2d_bytes_total``): one host piece is copied as it
    is; two (the residual and the new rows across the seam) are copied
    into the row slices of one device tensor."""
    with span("stream.h2d"):
        if len(pieces) == 1:
            x = torch.from_numpy(pieces[0]).to(dev)
        else:
            head, body = (torch.from_numpy(p) for p in pieces)
            h = head.shape[0]
            x = torch.empty((h + body.shape[0], *head.shape[1:]),
                            dtype=head.dtype, device=dev)
            x[:h].copy_(head)
            x[h:].copy_(body)
    get_registry().counter(
        "tpudas_stream_h2d_bytes_total",
        "stream block bytes copied from the host to the device",
    ).inc(sum(int(p.nbytes) for p in pieces))
    return x


def _stream_mesh(lfp):
    """The channel-sharding mesh the stream step runs under: the LFProc's
    mesh when it is pure channel sharding (a ``time`` axis of size 1 —
    time-sharded meshes stay on the window path, which owns the halo
    exchange), else None."""
    mesh = getattr(lfp, "_mesh", None)
    if mesh is None or int(mesh.shape.get("time", 1)) > 1:
        return None
    return mesh


def _feed(lfp, carry: StreamCarry, patch, new, qs, pipe, quantum, cap,
          block, flush) -> None:
    """The stream's one block feed, for both engines: the carried
    residual and ``new`` pooled (:func:`_pool`) and cut into
    :func:`_pow2_blocks` of ``quantum`` rows (at most ``cap`` quanta);
    each block dispatched now, and its ``flush(lfp, carry, patch, y_dev,
    rows, arg, t_disp, clock)`` pushed onto ``pipe`` to sync and emit it
    when it reaches the pipeline's head (same order, same math,
    overlapped wall clock); the rows short of a quantum kept as the next
    residual.  The engine's ``block(pool, off, rows)`` gives ``(ran, op,
    batched, arg)``: the engine run, its ``op(x, mesh)`` and its batched
    fleet step ``batched(bx, x)``, each returning the block's output on
    the device and the new ``carry.bufs``, and the flush's ``arg``."""
    dev = lfp.device
    mesh = _stream_mesh(lfp)
    with span("stream.pool"):
        pool = _pool(carry, new, qs, mesh)
    usable = pool.rows - pool.rows % quantum
    off = 0
    for n_units in _pow2_blocks(usable // quantum, cap):
        rows = n_units * quantum
        with span("stream.pool"):
            pieces = pool.pieces(off, rows)
        ran, op, batched, arg = block(pool, off, rows)
        t0 = time.perf_counter()
        bx = getattr(lfp, "_batch_executor", None)
        if mesh is not None:
            # the sharded step places the host block's column shards
            (x,) = pieces
        else:
            x = _to_device(pieces, dev)
        clock = EventTimer(dev).start()
        if mesh is None and bx is not None:
            # batched fleet service: rendezvous with the group's other
            # members so co-shaped blocks run as one stacked step
            y_dev, bufs = batched(bx, x)
        else:
            y_dev, bufs = op(x, mesh)
        clock.stop()
        t_disp = time.perf_counter() - t0
        carry.bufs = bufs
        lfp._count_block(ran)
        pipe.push(functools.partial(flush, lfp, carry, patch, y_dev, rows,
                                    arg, t_disp, clock))
        off += rows
    with span("stream.pool"):
        carry.residual = pool.tail(usable)
    carry.residual_scale = pool.qs


def _consume_cascade(lfp, carry: StreamCarry, patch, new, qs, pipe) -> None:
    from tpudas_torch.ops.fir import (
        cascade_decimate_stream,
        design_cascade,
        stream_stage_engines,
    )

    plan = design_cascade(
        1e9 / carry.d_ns, carry.ratio, _corner(carry.dt_out), carry.order
    )
    # "fused" resolves per block (the fused kernel on the card, the
    # per-stage chain below the size threshold); anything else runs
    # the per-stage chain
    eng_req = "fused" if carry.engine_req == "fused" else "auto"

    def block(pool, off, rows):
        # the engine is resolved at the stream's whole width: under a
        # mesh each shard runs the unsharded step's engine, and a batched
        # fleet's stacked step runs this stream's own, so stacking never
        # flips a threshold
        eng = stream_stage_engines(plan, rows, carry.n_ch, eng_req,
                                   lfp.device)[0]
        ran = eng if eng.startswith("fused") else f"cascade-{eng}"
        return (
            ran,
            lambda x, mesh: cascade_decimate_stream(
                x, carry.bufs, plan, eng_req, qscale=pool.qs, mesh=mesh),
            lambda bx, x: bx.cascade_step(x, carry.bufs, plan, eng,
                                          qscale=pool.qs),
            ran,
        )

    _feed(lfp, carry, patch, new, qs, pipe, carry.ratio, carry.patch_out,
          block, _cascade_flush)


def _cascade_flush(lfp, carry: StreamCarry, patch, y_dev, rows, ran, t_disp,
                   clock) -> None:
    """Sync one cascade block (``stream.fetch``) and emit its outputs
    past the carry's skip (``stream.emit``)."""
    t1 = time.perf_counter()
    with span("stream.fetch"):
        y = y_dev.cpu().numpy()
    t_dev = t_disp + time.perf_counter() - t1
    lfp.timings["compute_s"] += t_dev
    lfp.timings["device_s"] += clock.seconds(t_dev)
    with span("stream.emit"):
        _count_block(rows, ran, t_dev)
        carry.consumed += rows
        s = min(carry.skip_left, y.shape[0])
        carry.skip_left -= s
        _emit(lfp, carry, patch, y[s:], rows=rows, ran=ran)


# FFT stream feed quantum (input samples): block sizes are multiples of
# this, power-of-two decomposed, so the stream sees a bounded set of
# block shapes; up to QUANTUM-1 samples wait in the residual until the
# next feed
_FFT_QUANTUM = 128


def _consume_fft(lfp, carry: StreamCarry, patch, new, t_new0_ns, qs,
                 pipe) -> None:
    """Feed ``new`` rows through the overlap-save FFT filter and emit
    every output grid point the filtered rows now cover (a host lerp
    between the two rows around it, over only the rows it reads, fetched
    from the device by :func:`_fft_flush`; the last filtered row of each
    block is kept as the next block's left seam)."""
    from tpudas_torch.ops.filter import fft_pass_filter_stream

    d = carry.d_ns
    corner = _corner(carry.dt_out)
    q = _FFT_QUANTUM

    def keep_seam(step):
        # the overlap-save carry chains on the device (bufs[0]), so the
        # next block's dispatch never waits on this block's host sync;
        # the one-row lerp seam (bufs[1], host) is updated at flush,
        # before the next flush reads it (FIFO)
        filt_dev, fcarry = step
        return filt_dev, (fcarry, carry.bufs[1])

    def block(pool, off, rows):
        # row j of the flushed block is the filtered stream edge_in
        # samples behind its input; the stored tail row extends the seam
        # left
        t_pool0_ns = t_new0_ns - (pool.rows - new.shape[0]) * d
        t_blk0 = t_pool0_ns + off * d - carry.edge_in * d
        return (
            "fft",
            lambda x, mesh: keep_seam(fft_pass_filter_stream(
                x, carry.bufs[0], d / 1e9, high=corner, order=carry.order,
                qscale=pool.qs, mesh=mesh,
            )),
            # the batched fleet's step waits at the group's rendezvous
            # and runs at the member's own width (FFT steps are never
            # packed; see fft_pass_filter_stream_stacked)
            lambda bx, x: keep_seam(bx.fft_step(
                x, carry.bufs[0], d / 1e9, corner, carry.order,
                qscale=pool.qs,
            )),
            t_blk0,
        )

    cap_units = max(1, carry.patch_out * max(1, carry.step_ns // d) // q)
    _feed(lfp, carry, patch, new, qs, pipe, q, cap_units, block, _fft_flush)


def _fft_lerp_plan(carry: StreamCarry, n_tail: int, n_filt: int, t_blk0):
    """The FFT block's emission plan over ``rows = [seam; filtered]``
    (``n_tail`` seam rows, then the block's ``n_filt``), made before the
    block leaves the device.  Returns ``(need, idx, w)``: the sorted
    distinct rows the flush reads (the lerp's pairs and the last row,
    the next seam), and each due output's lower row and weight (None
    when no output is due)."""
    d = carry.d_ns
    n_rows = n_tail + n_filt
    t_row0 = t_blk0 - n_tail * d
    t_last = t_row0 + (n_rows - 1) * d
    last = np.asarray([n_rows - 1], np.int64)
    if t_last < carry.next_emit_ns or n_rows < 2:
        return last, None, None
    n = int((t_last - carry.next_emit_ns) // carry.step_ns) + 1
    g = carry.next_emit_ns + carry.step_ns * np.arange(n, dtype=np.int64)
    offs = g - t_row0
    idx = offs // d
    w = (offs - idx * d) / float(d)
    sel = idx >= n_rows - 1
    idx[sel] = n_rows - 2
    w[sel] = 1.0
    return np.unique(np.concatenate([idx, idx + 1, last])), idx, w


def _fetch_rows(filt_dev, tail, need):
    """Rows ``need`` (sorted, distinct) of ``[tail; filt_dev]`` on the
    host, in order: the seam's from ``tail``, the block's gathered on its
    device and copied in one D2H (the whole block when every row is
    needed), counted in ``tpudas_stream_fetch_rows_total``."""
    n_tail = int(tail.shape[0])
    fi = need[need >= n_tail] - n_tail
    if fi.size < filt_dev.shape[0]:
        filt_dev = filt_dev.index_select(
            0, torch.from_numpy(fi).to(filt_dev.device))
    got = filt_dev.cpu().numpy()
    get_registry().counter(
        "tpudas_stream_fetch_rows_total",
        "filtered stream rows copied from the device to the host",
        labelnames=("engine",),
    ).inc(int(fi.size), engine="fft")
    if not n_tail:
        return got
    return np.concatenate([tail[need[need < n_tail]], got], axis=0)


def _fft_flush(lfp, carry: StreamCarry, patch, filt_dev, blk_rows, t_blk0,
               t_disp, clock) -> None:
    """Sync one FFT block and emit its due outputs: only the filtered
    rows the lerp and the next seam read cross to the host
    (``stream.fetch``), and each output is the lerp between the two rows
    around it (``stream.emit``)."""
    tail = carry.bufs[1]
    t1 = time.perf_counter()
    with span("stream.fetch"):
        need, idx, w = _fft_lerp_plan(carry, tail.shape[0],
                                      int(filt_dev.shape[0]), t_blk0)
        rows = _fetch_rows(filt_dev, tail, need)
    t_dev = t_disp + time.perf_counter() - t1
    lfp.timings["compute_s"] += t_dev
    lfp.timings["device_s"] += clock.seconds(t_dev)
    with span("stream.emit"):
        _count_block(blk_rows, "fft", t_dev)
        carry.bufs = (carry.bufs[0], rows[-1:].copy())
        carry.consumed += blk_rows
        if idx is None:
            return
        # idx and idx + 1 are both in need, so idx + 1 sits at lo + 1
        lo = np.searchsorted(need, idx)
        out = rows[lo] * (1.0 - w[:, None]).astype(np.float32) + rows[
            lo + 1
        ] * w[:, None].astype(np.float32)
        s = min(carry.skip_left, out.shape[0])
        carry.skip_left -= s
        _emit(lfp, carry, patch, out[s:].astype(np.float32, copy=False),
              rows=blk_rows, ran="fft")
