"""The real-time ("edge") low-pass driver.

The port's counterpart of :func:`tpudas.proc.streaming.run_lowpass_realtime`:
the library form of the edge notebook's polling loop (poll the source
directory, process what is new, sleep, repeat; stop when the spool stops
growing).  The driver is a thin shim: a
:class:`~tpudas_torch.fleet.config.StreamConfig`, a
:class:`~tpudas_torch.fleet.engine.LowpassStreamRunner` and
:func:`~tpudas_torch.fleet.engine.drive`.

Stateful by default: each round filters only the new full-rate samples
through the carried per-stage state and saves the O(1) carry beside the
outputs (``.stream_carry.npz``, the JAX package's format), so a crash
resumes without a rewind, and a carry written by either package resumes
under the other.  ``stateful=False`` (or ``TPUDAS_STREAM_STATEFUL=0``)
restores the reference's rewind.
"""

from __future__ import annotations

import re
import time as _time

from tpudas_torch.fleet.config import StreamConfig, StreamSpec
from tpudas_torch.fleet.engine import (
    build_runner,
    check_unported,
    clamp_poll_interval,
    drive,
)
from tpudas_torch.proc.lfproc import resolve_gap_tolerance

__all__ = ["clamp_poll_interval", "run_lowpass_realtime"]


def _shim_stream_id(output_folder) -> str:
    """A bookkeeping id for a single-stream run, derived from the output
    folder (the JAX package's rule, so both give a stream the same id
    and so the same poll jitter)."""
    import os
    import zlib

    path = os.path.normpath(str(output_folder))
    base = re.sub(r"[^A-Za-z0-9._-]", "-", os.path.basename(path))
    base = re.sub(r"^[^A-Za-z0-9]+", "", base)[:55] or "stream"
    return f"{base}-{zlib.crc32(path.encode()):08x}"


def run_lowpass_realtime(
    source,
    output_folder,
    start_time,
    output_sample_interval,
    edge_buffer,
    process_patch_size,
    distance=None,
    poll_interval=125.0,
    file_duration=0.0,
    max_rounds=None,
    sleep_fn=_time.sleep,
    on_round=None,
    engine=None,
    on_gap=None,
    filter_order=None,
    data_gap_tolorance=None,
    data_gap_tolerance=None,
    window_dp=None,
    counters=None,
    mesh=None,
    rolling_output_folder=None,
    rolling_window=None,
    rolling_step=None,
    stateful=None,
    carry_save_every=None,
    health=None,
    fault_policy=None,
    quarantine=True,
    pyramid=None,
    detect=None,
    detect_operators=None,
    poll_jitter=None,
    flight=None,
    live=None,
    device=None,
):
    """Poll ``source`` and keep the low-pass output in ``output_folder``
    current.  Returns the number of rounds that processed data.

    The signature is the JAX package's, plus ``device`` (default: the
    CUDA card; ``"cpu"`` runs the plain PyTorch versions of the
    kernels).  ``engine`` (``"auto"``, ``"fft"``, ``"cascade"`` or
    ``"fused"``), ``on_gap``, ``filter_order`` and
    ``data_gap_tolerance`` (its misspelled alias ``data_gap_tolorance``
    warns once) go to :class:`~tpudas_torch.proc.lfproc.LFProc`.  Under
    ``"fused"`` every stream block at least ``TPUDAS_FUSED_MIN_ELEMS``
    elements large (default 2**23) runs the fused cascade kernel;
    ``"auto"`` runs the per-stage chain, every stage on the strided-FIR
    kernel, and the FFT stream engine where the cascade cannot serve the
    output grid; ``"fft"`` always runs the FFT stream engine.

    ``stateful`` (default on; ``TPUDAS_STREAM_STATEFUL=0`` turns it
    off) carries the filter state across rounds and persists it beside
    the outputs; a folder with outputs but no carry continues in rewind
    mode.  ``carry_save_every`` (default 1, or
    ``TPUDAS_CARRY_SAVE_EVERY``) saves the carry every Nth round; a
    clean shutdown always saves.  ``poll_interval`` is clamped to
    ``max(125 s, file_duration, 3 * edge_buffer)``; tests pass
    ``sleep_fn`` and ``max_rounds``.  ``counters`` (a
    :class:`~tpudas_torch.utils.profiling.Counters`) accumulates
    throughput; ``on_round(round, lfp)`` is called after each round.

    Not ported yet, and raising ``NotImplementedError`` when set to
    anything but their off value (None or False): ``mesh``,
    ``window_dp``, ``rolling_output_folder`` / ``rolling_window`` /
    ``rolling_step``, ``health``, ``pyramid``, ``detect``,
    ``detect_operators``, ``live`` and ``flight``.  The JAX package
    keeps its flight recorder on by default; here it is off.
    ``fault_policy`` and ``quarantine`` are accepted and inert: a
    round's error propagates to the caller (no retry, no quarantine).
    """
    check_unported(dict(
        mesh=mesh, window_dp=window_dp,
        rolling_output_folder=rolling_output_folder,
        rolling_window=rolling_window, rolling_step=rolling_step,
        health=health, pyramid=pyramid, detect=detect,
        detect_operators=detect_operators, live=live, flight=flight,
    ))
    gap_tol = resolve_gap_tolerance(data_gap_tolerance, data_gap_tolorance)
    config = StreamConfig(
        kind="lowpass",
        start_time=start_time,
        output_sample_interval=output_sample_interval,
        edge_buffer=edge_buffer,
        process_patch_size=process_patch_size,
        distance=distance,
        poll_interval=poll_interval,
        file_duration=file_duration,
        engine=engine,
        on_gap=on_gap,
        filter_order=filter_order,
        data_gap_tolerance=gap_tol,
        window_dp=window_dp,
        mesh=mesh,
        rolling_output_folder=rolling_output_folder,
        rolling_window=rolling_window,
        rolling_step=rolling_step,
        stateful=stateful,
        carry_save_every=carry_save_every,
        health=health,
        fault_policy=fault_policy,
        quarantine=quarantine,
        pyramid=pyramid,
        detect=detect,
        detect_operators=detect_operators,
        poll_jitter=poll_jitter,
        flight=flight,
        live=live,
    )
    spec = StreamSpec(
        stream_id=_shim_stream_id(output_folder),
        source=source,
        config=config,
        output_folder=str(output_folder),
    )
    runner = build_runner(
        spec, counters=counters, on_round=on_round, device=device
    )
    return drive(runner, max_rounds=max_rounds, sleep_fn=sleep_fn)
