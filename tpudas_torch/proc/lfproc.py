"""LFProc: the chunked overlap-save low-pass + decimate engine.

The port's counterpart of :mod:`tpudas.proc.lfproc` (a re-design of the
reference engine, lf_das.py:182-295).  The *contracts* are identical —
the ms-quantized time grid, the overlap-save window schedule and its
seam-freeness invariant (SURVEY.md §3.1), the ``LFDAS_*.h5`` naming,
parameters dict semantics, and crash-only resume from the output
folder (lf_das.py:214-217).  Per window the host assembles ``(T, C)``
data from the spool (raw int16 for a quantized tdas spool; the native
threaded assembler for tdas spools), moves it to the device as one
tensor, runs the polyphase FIR cascade
(:func:`tpudas_torch.ops.fir.cascade_decimate` — the hand-written CUDA
kernel on the card), and writes the decimated interior.

The ingest is a one-deep pipeline: a prefetch thread assembles window
N+1 while window N computes and writes.  On the card it assembles
straight into one of two page-locked host buffers and starts the
window's H2D on a side CUDA stream (``TPUDAS_H2D_STAGE=0`` turns the
staging off; windows over ``_STAGE_MAX_BYTES`` are not staged).

A window whose output grid is not sample-aligned, or whose halo is
smaller than the cascade's filter support, runs the FFT engine under
``engine="auto"`` (:func:`lowpass_resample`: rfft -> Butterworth^2 ->
irfft -> gather-lerp, plain ``torch.fft`` and tensor ops, as the JAX
package leaves it to XLA); ``engine="fft"`` runs every window there.
A kernel fault raises; there is no fallback chain.

Beside the window path, :meth:`LFProc.open_stream` and
:meth:`LFProc.process_stream_increment` run the stateful stream
(:mod:`tpudas_torch.proc.stream`): each input sample is filtered once
through a carried per-stage state.  ``engine="fused"`` runs that stream
through the fused cascade kernel; batch windows under ``"fused"`` run
the ordinary cascade.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpudas_torch.core.mapping import FrozenDict
from tpudas_torch.core.timeutils import (
    build_time_grid,
    quantize_step,
    to_datetime64,
)
from tpudas_torch.device import resolve_device
from tpudas_torch.io.spool import spool as make_spool
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.proc.naming import get_filename
from tpudas_torch.utils.logging import log_event

__all__ = ["LFProc", "check_merge", "lowpass_resample", "output_corner",
           "resolve_gap_tolerance", "schedule_windows"]


_GAP_ALIAS_WARNED = False  # the deprecated spelling warns once per process


def resolve_gap_tolerance(correct=None, legacy=None):
    """One value from the correctly spelled ``data_gap_tolerance`` and
    the reference's ``data_gap_tolorance`` (lf_das.py:202 — the
    misspelling IS the reference surface, kept as a deprecated alias).
    Passing both with different values is an error; using only the
    legacy spelling warns ``DeprecationWarning`` once per process.
    Returns None when neither is given."""
    global _GAP_ALIAS_WARNED
    if legacy is None:
        return correct
    if correct is not None:
        if float(correct) != float(legacy):
            raise ValueError(
                "data_gap_tolerance and its deprecated alias "
                f"data_gap_tolorance disagree ({correct!r} vs {legacy!r}); "
                "pass only data_gap_tolerance"
            )
        return correct
    if not _GAP_ALIAS_WARNED:
        _GAP_ALIAS_WARNED = True
        import warnings

        warnings.warn(
            "data_gap_tolorance is the reference's misspelling, kept as "
            "a deprecated alias; use data_gap_tolerance",
            DeprecationWarning,
            stacklevel=3,
        )
    return legacy


def check_merge(plist):
    """Gap detector: a merged window must be exactly one patch
    (reference lf_das.py:16-20, message preserved)."""
    if len(plist) > 1:
        raise Exception("patch merge failed! Gap in data exists")
    return plist[0]


def output_corner(dt_out: float) -> float:
    """The engine's per-window filter corner: 0.9x the post-decimation
    Nyquist (reference lf_das.py:223)."""
    return 1.0 / float(dt_out) / 2.0 * 0.9


def schedule_windows(n_grid: int, patch_size: int, buff_size: int):
    """The overlap-save schedule over a time grid of ``n_grid`` points.

    Returns (sel_lo, sel_hi, emit_lo, emit_hi) index tuples into the
    grid: the window reads ``[grid[sel_lo], grid[sel_hi]]`` and emits
    output samples ``grid[emit_lo:emit_hi]``. Invariants (SURVEY.md
    §3.1): consecutive windows overlap by ``2*buff_size`` grid steps and
    emit disjoint interiors that tile ``[buff_size, ...)`` contiguously;
    the stream-start edge (first ``buff_size`` samples) is discarded.
    """
    windows = []
    if n_grid < 2:
        return windows
    if patch_size >= n_grid:
        patch_size = n_grid - 1
    if patch_size <= 2 * buff_size:
        raise ValueError(
            f"process_patch_size ({patch_size}) must exceed twice the "
            f"edge_buff_size ({buff_size}); increase the chunk length or "
            "reduce the edge buffer"
        )
    windows.append((0, patch_size, buff_size, patch_size - buff_size))
    data_end = patch_size
    new_data_end = data_end + patch_size - 2 * buff_size
    while new_data_end < n_grid:
        windows.append(
            (
                data_end - 2 * buff_size,
                new_data_end,
                data_end - buff_size,
                new_data_end - buff_size,
            )
        )
        data_end = new_data_end
        new_data_end = data_end + patch_size - 2 * buff_size
    if (n_grid - data_end) > 1:  # tail shorter than a full window
        new_data_end = n_grid - 1
        windows.append(
            (
                data_end - 2 * buff_size,
                new_data_end,
                data_end - buff_size,
                new_data_end - buff_size,
            )
        )
    return windows


def lowpass_resample(data, d_sec, corner, idx, w, order=4, qscale=None,
                     device=None):
    """The FFT window engine: zero-phase low-pass + gather-lerp decimate
    (the JAX package's ``lowpass_resample``, tpudas/proc/lfproc.py:198-240).

    data: (T, C) float32, or raw int16 with ``qscale`` (crosses to the
    device as int16 and is dequantized there, ``float(x) * qscale``); a
    tensor (its device is used) or numpy (moved to ``device``, default
    the CUDA card).  idx/w: the (K,) gather plan into the filtered rows
    (:func:`tpudas_torch.ops.resample.interp_indices_weights`).  Returns
    a (K, C) float32 tensor: rfft over the JAX package's 5-smooth nfft,
    the float32 Butterworth^2 response, irfft, then the lerp.
    """
    from tpudas_torch.ops.filter import _as_tensor, _filter_rows
    from tpudas_torch.ops.fir import _check_quantized
    from tpudas_torch.ops.resample import gather_lerp

    x = _as_tensor(data, device)
    _check_quantized(x, qscale)
    x = x.to(torch.float32)
    if qscale is not None:
        x = x * torch.tensor(np.float32(qscale), device=x.device)
    return gather_lerp(_filter_rows(x, d_sec, None, corner, order), idx, w)


class _PinnedRing:
    """The prefetch thread's two page-locked host buffers and its copy
    stream, on the card.

    Window N is assembled into buffer N % 2 and its H2D starts on the
    side stream; the buffer is handed out again (for window N+2) only
    after that copy's event has completed.  The buffers are allocated
    once and grown only when a window is larger: page-locking a window's
    bytes anew for every window would cost more than the copy saves.
    Used from the prefetch thread only.
    """

    _TORCH_DTYPES = {np.dtype(np.int16): torch.int16,
                     np.dtype(np.float32): torch.float32}

    def __init__(self, device):
        self.device = device
        self._bufs = [None, None]
        self._events = [None, None]
        self._next = 0
        self._stream = None

    def array(self, shape, dtype):
        """A host array of ``shape``/``dtype`` in the next page-locked
        buffer, once that buffer's last copy has completed."""
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = None  # release the smaller buffer first
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        return self._bufs[i][:nbytes].numpy().view(dtype).reshape(shape)

    def to_device(self, host):
        """Start ``host``'s H2D on the side stream; returns (device
        tensor, the copy's event).  An array other than the one
        :meth:`array` handed out last is first copied into a buffer."""
        i = self._next ^ 1
        buf = self._bufs[i]
        if (
            buf is None
            or host.ctypes.data != buf.data_ptr()
            or not host.flags.c_contiguous
        ):
            dst = self.array(host.shape, host.dtype)
            dst[...] = host
            host, i = dst, self._next ^ 1
        src = (self._bufs[i][: host.nbytes]
               .view(self._TORCH_DTYPES[host.dtype]).view(host.shape))
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stream):
            x = src.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._events[i] = ready
        return x, ready


class LFProc:
    """Low-frequency processing engine over a source spool.

    Public surface matches the reference class: construction from a
    spool, ``set_output_folder``, ``update_processing_parameter``,
    ``get_last_processed_time``, ``process_time_range``,
    ``parameters``.  ``device`` (default: the CUDA card; raises when
    there is none) is where the windows are filtered.
    """

    _ENGINES = ("auto", "fft", "cascade", "fused")
    _GAP_MODES = ("raise", "skip", "split")

    def __init__(self, sp=None, device=None):
        self._spool = sp
        self.device = resolve_device(device)
        self._para = self._default_process_parameters()
        self._output_folder = None
        # per-emission count of the engine that ran: "cascade-cuda" when
        # the stages ran the CUDA kernel, "cascade-torch" for the plain
        # PyTorch stages (CPU), "fft" for the FFT engine; the stream adds
        # "fused-cuda" and "fused-torch" when the fused step ran
        self.engine_counts = {"cascade-cuda": 0, "cascade-torch": 0, "fft": 0}
        # stream blocks dispatched, by engine (a warm-up block emits
        # nothing, so this can exceed engine_counts)
        self.stream_blocks = {}
        # windows whose raw int16 payload went to the device undecoded
        self.quantized_windows = 0
        # windows read by the native tdas assembler, and windows whose
        # device payload the prefetch thread staged
        self.native_windows = 0
        self.staged_windows = 0
        # cumulative per-phase wall seconds: assemble = the consumer's
        # wait on the prefetch thread's window read, device = (the rest
        # of the) H2D + kernels + D2H, write = output file write
        self.timings = {"assemble_s": 0.0, "device_s": 0.0, "write_s": 0.0}
        self._ring = (_PinnedRing(self.device) if self.device.type == "cuda"
                      else None)
        # the run's anchor for joint products phased in input samples
        # (tpudas_torch.proc.joint), and whether the next window is the
        # run's first (whose rolling warm-up may clamp)
        self._run_origin_ns = None
        self._first_window_of_run = True
        # the batched fleet's rendezvous (tpudas_torch.fleet.batch),
        # installed by the round's runner; None is the solo step
        self._batch_executor = None
        # output-emission subscribers (the realtime runner's detect
        # capture), and the ids of those that raised this round
        self._emit_listeners: list = []
        self._failed_listeners: set = set()

    # configuration ----------------------------------------------------
    def _default_process_parameters(self):
        return {
            "output_sample_interval": 1.0,  # seconds
            "process_patch_size": 100,  # output samples per window
            "edge_buff_size": 10,  # output samples of trimmed halo
            # a hole between consecutive files of at most this many
            # seconds is NOT a gap: the window merge bridges it by
            # linear interpolation, and the split planner keeps the
            # schedule in one segment across it
            "data_gap_tolorance": 10.0,
            # "raise" (reference), "skip" windows touching a gap, or
            # "split" the grid at gaps and run overlap-save per segment
            "on_gap": "raise",
            "filter_order": 4,
            # "auto": the polyphase FIR cascade when the target grid is
            # sample-aligned and the ratio factors, the FFT engine
            # otherwise; "fft"/"cascade" force one path; "fused": the
            # cascade, with the stream run through the fused kernel
            "engine": "auto",
        }

    def update_processing_parameter(self, **kwargs):
        if "data_gap_tolerance" in kwargs or "data_gap_tolorance" in kwargs:
            v = resolve_gap_tolerance(
                kwargs.pop("data_gap_tolerance", None),
                kwargs.pop("data_gap_tolorance", None),
            )
            if v is not None:
                kwargs["data_gap_tolorance"] = v
        for key, value in kwargs.items():
            if key not in self._para:
                print(f"{key} is not default parameter key")
            elif key == "engine" and value not in self._ENGINES:
                raise ValueError(
                    f"engine must be one of {self._ENGINES}, got {value!r}"
                )
            elif key == "on_gap" and value not in self._GAP_MODES:
                raise ValueError(
                    f"on_gap must be one of {self._GAP_MODES}, got {value!r}"
                )
            else:
                self._para[key] = value
        return self.parameters

    @property
    def parameters(self):
        return FrozenDict(self._para)

    # output folder / resume ------------------------------------------
    @staticmethod
    def _setup_folder(folder, delete_existing):
        """Create (or wipe and recreate) an output folder — messages
        match the reference (lf_das.py:188-195)."""
        if delete_existing and os.path.isdir(folder):
            shutil.rmtree(folder)
            print(f"original {folder} deleted")
        if not os.path.isdir(folder):
            os.makedirs(folder)
            print(f"{folder} created")

    def set_output_folder(self, folder, delete_existing=False):
        self._output_folder = folder
        self._setup_folder(folder, delete_existing)

    def add_emit_listener(self, fn) -> None:
        """Subscribe ``fn(result_patch)`` to every output emission
        (called after the output write).  Several subscribers coexist;
        a failing one is counted and skipped at the emit site."""
        self._emit_listeners.append(fn)

    def clear_emit_failures(self) -> None:
        """Re-arm listeners skipped after raising (a consumer that
        failed on round N's emissions gets a fresh chance on round
        N+1)."""
        self._failed_listeners.clear()

    def get_last_processed_time(self):
        """Resume primitive: progress state lives entirely in the output
        files (crash-only design, lf_das.py:214-217)."""
        out_sp = make_spool(self._output_folder).sort("time").update()
        return out_sp[-1].attrs["time_max"]

    # stateful streaming ----------------------------------------------
    def open_stream(self, start_time):
        """A fresh :class:`tpudas_torch.proc.stream.StreamCarry` for this
        engine's parameters, anchored at ``start_time``: the resumable
        alternative to the window path, whose carry holds each filter
        stage's O(1) trailing state."""
        from tpudas_torch.proc.stream import open_stream

        return open_stream(self, start_time)

    def process_stream_increment(self, carry, edtime):
        """Process all NEW data up to ``edtime`` through the carried
        filter state, writing output files and advancing ``carry`` in
        place.  Returns the number of output samples emitted.  Matches
        :meth:`process_time_range` over the same span on the interior
        (the batch path is the oracle).  Ingest is pipelined
        (``TPUDAS_INGEST_PREFETCH``, default 2) and int16 payloads go to
        the device undecoded."""
        if self._output_folder is None:
            raise Exception("Please setup output folder first")
        from tpudas_torch.proc.stream import process_increment

        return process_increment(self, carry, edtime)

    def _count_block(self, ran: str) -> None:
        self.stream_blocks[ran] = self.stream_blocks.get(ran, 0) + 1

    # the engine -------------------------------------------------------
    def _load_window(self, t_lo, t_hi, on_gap, alloc=None):
        """Host side: read + merge one window from the source spool.

        tdas directory spools take the planned path: per-file row
        segments are planned from the index alone and the native
        threaded assembler reads them into ONE contiguous buffer (raw
        int16 + its scale for a quantized spool; numpy under
        ``TPUDAS_NO_NATIVE=1``) — ``alloc(shape, dtype)``, when given,
        supplies that buffer.  Other spools read per-file patches and
        merge them, bridging holes up to ``data_gap_tolorance`` seconds.
        """
        plan_fn = getattr(self._spool, "window_plan", None)
        if plan_fn is not None:
            plan = plan_fn(t_lo, t_hi)
            if plan is not None:
                from tpudas_torch.io.tdas import (
                    assemble_window_patch,
                    window_array_spec,
                )
                from tpudas_torch.native import native_enabled

                native = native_enabled()
                log_event(
                    "planned_window",
                    files=len(plan["segments"]),
                    rows=plan["total_rows"],
                    payload=plan["payload"],
                    native=native,
                )
                out = None if alloc is None else alloc(*window_array_spec(plan))
                patch = assemble_window_patch(plan, out=out)
                if native:
                    self.native_windows += 1
                return patch
        selected = self._spool.select(time=(t_lo, t_hi))
        plist = make_spool(selected).chunk(
            time=None,
            max_fill=float(self._para["data_gap_tolorance"]),
        )
        if len(plist) == 0:
            if on_gap == "raise":
                raise Exception("patch merge failed! Gap in data exists")
            return None
        try:
            return check_merge(plist)
        except Exception:
            if on_gap == "raise":
                raise
            return None

    def _split_grid_at_gaps(self, time_grid):
        """[(g_lo, g_hi), ...] index ranges of ``time_grid`` covered by
        contiguous data, split at gaps wider than data_gap_tolorance
        seconds (detected from the spool's records — no payload IO)."""
        if len(time_grid) == 0:
            return []
        tol_ns = float(self._para["data_gap_tolorance"]) * 1e9
        rows = self._spool.contents()
        if not rows:
            return []
        mins = np.array([r["time_min"] for r in rows], "datetime64[ns]")
        maxs = np.array([r["time_max"] for r in rows], "datetime64[ns]")
        order = np.argsort(mins, kind="stable")
        mins, maxs = mins[order].astype(np.int64), maxs[order].astype(
            np.int64
        )
        # merge file intervals into coverage runs; a separation wider
        # than the tolerance starts a new run
        runs = []
        run_lo, run_hi = mins[0], maxs[0]
        for lo, hi in zip(mins[1:], maxs[1:]):
            if lo - run_hi > tol_ns:
                runs.append((run_lo, run_hi))
                run_lo, run_hi = lo, hi
            else:
                run_hi = max(run_hi, hi)
        runs.append((run_lo, run_hi))
        grid_ns = time_grid.astype("datetime64[ns]").astype(np.int64)
        segments = []
        for lo, hi in runs:
            g_lo = int(np.searchsorted(grid_ns, lo, side="left"))
            g_hi = int(np.searchsorted(grid_ns, hi, side="right"))
            if g_hi - g_lo >= 2:
                segments.append((g_lo, g_hi))
        return segments

    def process_time_range(self, bgtime, edtime):
        """Chunked overlap-save low-pass + decimate over [bg, ed)."""
        if self._output_folder is None:
            raise Exception("Please setup output folder first")
        dt = self._para["output_sample_interval"]
        on_gap = self._para["on_gap"]
        bgtime = to_datetime64(bgtime)
        edtime = to_datetime64(edtime)
        self._run_origin_ns = int(
            bgtime.astype("datetime64[ns]").astype(np.int64)
        )
        self._first_window_of_run = True
        time_grid = build_time_grid(bgtime, edtime, dt)
        if on_gap == "split":
            # a globally invalid patch/buff relation must fail loudly
            # here — per-segment scheduling errors are otherwise
            # swallowed as "segment too short"
            patch_size = self._para["process_patch_size"]
            buff_size = self._para["edge_buff_size"]
            if patch_size <= 2 * buff_size:
                raise ValueError(
                    f"process_patch_size ({patch_size}) must exceed "
                    f"2*edge_buff_size ({2 * buff_size})"
                )
            segments = self._split_grid_at_gaps(time_grid)
            if not segments:
                print(
                    "Warning: no data coverage found in "
                    f"[{bgtime} .. {edtime}) — nothing was processed "
                    "(on_gap='split')"
                )
        else:
            segments = [(0, len(time_grid))]
        total_windows = 0
        try:
            with span("lfproc.process_time_range",
                      grid_points=len(time_grid), segments=len(segments)):
                for s_i, (g_lo, g_hi) in enumerate(segments):
                    if len(segments) > 1:
                        print(
                            f"Processing segment {s_i + 1}/{len(segments)} "
                            f"[{time_grid[g_lo]} .. {time_grid[g_hi - 1]}]"
                        )
                    total_windows += self._process_segment(
                        time_grid[g_lo:g_hi], on_gap
                    )
        finally:
            # the run anchor must not leak into later direct
            # _process_window use (whose fallback is a window-local
            # origin)
            self._run_origin_ns = None
            self._first_window_of_run = True
        log_event(
            "process_time_range_done",
            windows=total_windows,
            grid_points=len(time_grid),
            segments=len(segments),
            timings={k: round(v, 4) for k, v in self.timings.items()},
        )

    def _process_segment(self, time_grid, on_gap) -> int:
        """Overlap-save over one contiguous grid segment; returns the
        number of scheduled windows.  The prefetch thread reads (and
        stages) window N+1 while window N is filtered and written."""
        dt = self._para["output_sample_interval"]
        patch_size = self._para["process_patch_size"]
        buff_size = self._para["edge_buff_size"]
        order = self._para["filter_order"]
        if on_gap == "split" and len(time_grid) - 1 <= 2 * buff_size:
            log_event("segment_too_short", grid_points=len(time_grid))
            return 0
        windows = schedule_windows(len(time_grid), patch_size, buff_size)
        corner = output_corner(dt)
        for i, loaded, emit_times in self._iter_windows(
            time_grid, windows, on_gap, self._load_and_stage
        ):
            window_patch, staged = loaded
            if window_patch is None:
                log_event("window_skipped_gap", index=i + 1)
                continue
            self._process_window(
                window_patch, emit_times, dt, corner, order, staged=staged
            )
        return len(windows)

    def _iter_windows(self, time_grid, windows, on_gap, loader):
        """Prefetching window iterator: ``loader(bg, ed, on_gap)`` runs
        one window ahead on a worker thread; yields ``(i, loaded,
        emit_times)`` with the consumer's wait counted as assemble
        time.  Window N+2 is asked for only after window N has been
        processed, which is what lets two staging buffers suffice."""
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = None
            if windows:
                w0 = windows[0]
                future = pool.submit(
                    loader, time_grid[w0[0]], time_grid[w0[1]], on_gap
                )
            try:
                for i, (sel_lo, sel_hi, emit_lo, emit_hi) in enumerate(windows):
                    print("Processing patch ", str(i + 1))
                    t_wait = time.perf_counter()
                    loaded = future.result()
                    future = None
                    self.timings["assemble_s"] += time.perf_counter() - t_wait
                    if i + 1 < len(windows):
                        nxt = windows[i + 1]
                        future = pool.submit(
                            loader, time_grid[nxt[0]], time_grid[nxt[1]], on_gap
                        )
                    yield i, loaded, time_grid[emit_lo:emit_hi]
            finally:
                if future is not None and not future.cancel():
                    # the consumer stopped early: the read ahead is
                    # abandoned, and its own failure (if any) with it
                    future.exception()

    # windows larger than this are not staged: staging keeps two
    # windows resident (the computing one and the transferring one) in
    # page-locked host memory and on the device.  TPUDAS_H2D_STAGE=0
    # turns staging off.
    _STAGE_MAX_BYTES = 2 << 30

    def _stage_array(self, shape, dtype):
        """The prefetch thread's destination for a planned window: a
        page-locked buffer when the window fits the staging budget."""
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if nbytes > self._STAGE_MAX_BYTES:
            return np.empty(shape, dtype)
        return self._ring.array(shape, dtype)

    def _load_and_stage(self, bg, ed, on_gap):
        """Prefetch-thread body: assemble the window, then START its
        transfer so the H2D overlaps the previous window's compute and
        write.  Returns (patch, staged): ``staged`` is (time-major
        device tensor — raw int16 for quantized windows —, the copy's
        CUDA event or None) or None when staging does not apply.  On
        the CPU the "transfer" wraps the host array."""
        staging = os.environ.get("TPUDAS_H2D_STAGE", "1") != "0"
        cuda = self._ring is not None
        alloc = self._stage_array if staging and cuda else None
        window_patch = self._load_window(bg, ed, on_gap, alloc=alloc)
        if window_patch is None or not staging:
            return window_patch, None
        host, qscale = self._time_major_payload(window_patch)
        es = 2 if qscale is not None else 4
        if host.size * es > self._STAGE_MAX_BYTES:
            return window_patch, None
        host = np.ascontiguousarray(
            host, dtype=host.dtype if qscale is not None else np.float32
        )
        if not cuda:
            return window_patch, (torch.from_numpy(host), None)
        return window_patch, self._ring.to_device(host)

    @staticmethod
    def _time_major_payload(window_patch):
        """(time-major host array, qscale-or-None): the single source
        of the quantized-ingest predicate and axis normalization."""
        ax = window_patch.axis_of("time")
        host = window_patch.host_data()
        if ax != 0:
            host = np.moveaxis(host, ax, 0)
        qscale = window_patch.attrs.get("data_scale")
        if host.dtype == np.int16 and qscale is not None:
            return host, float(qscale)
        return host, None

    def _cascade_alignment(self, taxis, target_times, d_sec, dt):
        """If the (ms-quantized) target grid lands exactly on input
        samples and the decimation ratio is a small-prime integer,
        return (ratio, phase) for the cascade engine; else None.

        The ratio is derived from the actual target-grid spacing (the
        quantized step from build_time_grid), NOT the configured float
        interval.  A final tail window can emit a single grid point;
        with no second sample to difference, the step falls back to
        the run-level quantized grid step.
        """
        if target_times.size == 0:
            return None
        t_ns = target_times.astype("datetime64[ns]").astype(np.int64)
        if target_times.size >= 2:
            step_ns = t_ns[1] - t_ns[0]
        else:
            step_ns = int(
                quantize_step(dt).astype("timedelta64[ns]").astype(np.int64)
            )
        if step_ns <= 0 or np.any(np.diff(t_ns) != step_ns):
            return None
        dsec_ns = float(d_sec) * 1e9
        ratio_f = step_ns / dsec_ns
        ratio = int(round(ratio_f))
        if ratio < 1 or abs(ratio_f - ratio) > 1e-6 * max(ratio, 1):
            return None
        t0 = taxis[0].astype("datetime64[ns]").astype(np.int64)
        f0 = (t_ns[0] - t0) / dsec_ns
        phase = int(round(f0))
        if phase < 0 or abs(f0 - phase) > 1e-3:
            return None
        try:
            from tpudas_torch.ops.fir import factor_ratio

            factor_ratio(ratio)
        except ValueError:
            return None
        return ratio, phase

    def _process_window(self, window_patch, target_times, dt, corner, order,
                        staged=None):
        """Device side: filter + decimate (the cascade, or the FFT engine
        where the cascade cannot serve the window), then write the
        interior.  ``staged`` is the prefetch thread's (device tensor,
        copy event) of this window's payload: host-side decisions still
        read the host array, only the device payload is substituted."""
        if target_times.size == 0:
            return
        host, qs = self._time_major_payload(window_patch)
        taxis = window_patch.coords["time"]
        d_sec = window_patch.get_sample_step("time")
        # coverage invariant: every emitted grid point must lie inside
        # the loaded data (one input step of slack for the stream-tail
        # grid point that lands just past the final sample)
        slack = np.timedelta64(int(round(d_sec * 1e9)), "ns")
        cov_lo = taxis[0].astype("datetime64[ns]") - slack
        cov_hi = taxis[-1].astype("datetime64[ns]") + slack
        if (
            target_times[0].astype("datetime64[ns]") < cov_lo
            or target_times[-1].astype("datetime64[ns]") > cov_hi
        ):
            log_event(
                "window_coverage_gap",
                data=[str(taxis[0]), str(taxis[-1])],
                emit=[str(target_times[0]), str(target_times[-1])],
            )
            if self._para.get("on_gap", "raise") == "raise":
                raise Exception("patch merge failed! Gap in data exists")
            print(
                "Warning: window data does not cover its output range; "
                "skipping (on_gap)"
            )
            return
        engine = self._para.get("engine", "auto")
        align = None
        if engine in ("auto", "cascade", "fused"):
            align = self._cascade_alignment(taxis, target_times, d_sec, dt)
            if align is None and engine in ("cascade", "fused"):
                raise ValueError(
                    f"engine={engine!r} requires the output grid to land "
                    "on input samples with an integer small-prime "
                    "decimation ratio; use engine='auto' or 'fft'"
                )
        if align is not None:
            from tpudas_torch.ops.fir import design_cascade, edge_support_samples

            ratio, phase = align
            plan = design_cascade(1.0 / d_sec, ratio, corner, int(order))
            # the edge halo must cover the cascade's (tol-thresholded)
            # filter support on both sides, or the emitted interior
            # carries edge artifacts (lf_das.py:79-85)
            supp = edge_support_samples(plan, 1e-3)
            tail = host.shape[0] - (phase + (target_times.size - 1) * ratio)
            if supp > phase or supp >= tail:
                log_event(
                    "cascade_halo_too_small", support=supp, phase=phase,
                    tail=int(tail),
                )
                if engine in ("cascade", "fused"):
                    print(
                        "Warning: edge_buff_size halo is smaller than the "
                        f"cascade filter support ({supp} input samples); "
                        "emitted edges may carry artifacts"
                    )
                else:
                    align = None  # auto: the FFT engine takes the window
        n_out = int(target_times.size)
        t_dev0 = time.perf_counter()
        if staged is not None:
            x, ready = staged  # H2D started by the prefetch thread
            if ready is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ready)
                x.record_stream(compute)
            self.staged_windows += 1
        else:
            # quantized windows ship the raw int16 payload: half the
            # transfer bytes, dequantized on the device
            payload = (host if qs is not None
                       else host.astype(np.float32, copy=False))
            x = torch.from_numpy(np.ascontiguousarray(payload)).to(self.device)
        if align is not None:
            from tpudas_torch.ops.fir import cascade_decimate

            out = cascade_decimate(x, plan, phase, n_out, "auto", qscale=qs)
            ran = ("cascade-cuda" if self.device.type == "cuda"
                   else "cascade-torch")
        else:
            from tpudas_torch.ops.resample import interp_indices_weights

            idx, w = interp_indices_weights(taxis, target_times)
            out = lowpass_resample(x, d_sec, corner, idx, w, order=order,
                                   qscale=qs)
            ran = "fft"
        out = out.cpu().numpy()  # host sync
        t_dev = time.perf_counter() - t_dev0
        self.timings["device_s"] += t_dev
        if qs is not None:
            self.quantized_windows += 1
        # joint products (tpudas_torch.proc.joint.JointProc) read the
        # same device payload: one ingest pass, one H2D, several
        # products.  Emitted BEFORE the LF file: resume state is the LF
        # output folder, so a crash between the two writes leaves the
        # window to be redone (its extra file is rewritten under the
        # same name) rather than a hole in the extra product.
        self._emit_window_extras(
            window_patch, x, qs, taxis, target_times, dt, d_sec,
        )
        self._emit_window_output(
            window_patch, target_times, dt, out, ran,
            rows=int(host.shape[0]), t_dev=t_dev,
        )

    def _emit_window_extras(self, window_patch, payload, qs, taxis,
                            target_times, dt, d_sec):
        """Hook for subclasses emitting extra per-window products.
        ``payload`` is the time-major window already on the device (raw
        int16 with ``qs`` for a quantized window)."""

    def _emit_window_output(self, window_patch, target_times, dt, out, ran,
                            rows, t_dev=0.0):
        """Shared tail of window processing: observability, coords,
        attrs, and the output write."""
        ax = window_patch.axis_of("time")
        self.engine_counts[ran] = self.engine_counts.get(ran, 0) + 1
        log_event(
            "window_engine", engine=ran, rows=rows,
            emitted=int(target_times.size),
        )
        if ax != 0:
            out = np.moveaxis(out, 0, ax)
        coords = dict(window_patch.coords)
        coords["time"] = target_times
        attrs = window_patch.attrs.to_dict()
        # the output is decoded float32 — a quantization scale inherited
        # from an int16 ingest window would misdescribe it
        attrs.pop("data_scale", None)
        result = window_patch.new(data=out, coords=coords, attrs=attrs)
        result = result.update_attrs(d_time=dt)
        filename = get_filename(
            result.attrs["time_min"], result.attrs["time_max"]
        )
        t_w0 = time.perf_counter()
        self._write_output(result, os.path.join(self._output_folder, filename))
        t_write = time.perf_counter() - t_w0
        self.timings["write_s"] += t_write
        for listener in self._emit_listeners:
            if id(listener) in self._failed_listeners:
                continue  # raised earlier this round: skip, don't re-fail
            try:
                listener(result)
            except Exception as exc:
                self._failed_listeners.add(id(listener))
                get_registry().counter(
                    "tpudas_lfproc_listener_errors_total",
                    "output-emission listener callbacks that raised "
                    "(swallowed and skipped for the rest of the "
                    "round; the commit path is never poisoned)",
                ).inc()
                log_event(
                    "emit_listener_failed",
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
        log_event(
            "window_timing", device_s=round(t_dev, 5),
            write_s=round(t_write, 5), engine=ran,
        )

    def _write_output(self, patch, path):
        """Write one output patch — dasdae HDF5 at the ``LFDAS_*.h5``
        name, as the reference does (lf_das.py:232)."""
        patch.io.write(path, "dasdae")
