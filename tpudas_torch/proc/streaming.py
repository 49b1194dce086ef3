"""The real-time ("edge") drivers.

The port's counterpart of :mod:`tpudas.proc.streaming`: the library
form of the edge notebooks' polling loops (poll the source directory,
process what is new, sleep, repeat; stop when the spool stops
growing).  Each driver is a thin shim: a
:class:`~tpudas_torch.fleet.config.StreamConfig`, a runner
(:class:`~tpudas_torch.fleet.engine.LowpassStreamRunner` or
:class:`~tpudas_torch.fleet.engine.RollingStreamRunner`) and
:func:`~tpudas_torch.fleet.engine.drive`.

Stateful by default: each round filters only the new full-rate samples
through the carried per-stage state and saves the O(1) carry beside the
outputs (``.stream_carry.npz``, the JAX package's format), so a crash
resumes without a rewind, and a carry written by either package resumes
under the other.  A round that fails is retried, and a file that keeps
failing is quarantined, as in the JAX package.  ``stateful=False`` (or ``TPUDAS_STREAM_STATEFUL=0``)
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

__all__ = ["clamp_poll_interval", "run_lowpass_realtime",
           "run_rolling_realtime"]


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

    ``detect`` (default ``TPUDAS_DETECT=1``) runs the
    :mod:`tpudas_torch.detect` operators (``detect_operators``, default
    ``("stalta", "rms")``) over each round's emitted output on
    ``device``, committing the events ledger, score tiles and detect
    carry under ``<output_folder>/.detect/``; a detect failure is
    counted and swallowed, never the stream's.  ``rolling_output_folder``
    (with ``rolling_window`` / ``rolling_step`` seconds) writes the
    joint rolling-mean product from the same ingest pass
    (:class:`~tpudas_torch.proc.joint.JointProc`); that mode runs the
    rewind path (the rolling windows need the loaded halo), and the
    two ``rolling_*`` keywords without the folder raise ``ValueError``.

    Before its first round the driver audits and repairs the output
    folder (:mod:`tpudas_torch.integrity.audit`), as the JAX package's
    does; ``TPUDAS_INTEGRITY_AUDIT=0`` turns that off.

    ``pyramid`` (None reads ``TPUDAS_PYRAMID``, on at ``1``) keeps the
    multi-resolution tile pyramid under ``<output_folder>/.tiles/``
    (:mod:`tpudas_torch.serve.tiles`), appended after each round's
    output writes from the round's in-memory output patches, in the JAX
    package's format; ``TPUDAS_PYRAMID_FACTOR`` / ``_TILE_LEN`` and
    ``TPUDAS_CODEC`` shape a fresh pyramid (4 / 256 / raw).  Its
    failures are counted in ``tpudas_serve_pyramid_errors_total`` and
    swallowed (a corrupt store is rebuilt from the output files).

    ``health`` (None reads ``TPUDAS_HEALTH``, on at ``1``) writes
    ``health.json`` (crc32-stamped, ``.prev`` double buffer) and
    ``metrics.prom`` beside the carry every round
    (:mod:`tpudas_torch.obs.health`).  ``flight`` (None reads
    ``TPUDAS_FLIGHT``, on unless ``0``, as in the JAX package) keeps the
    crash-surviving flight ring under ``<output_folder>/.flight/``
    (:mod:`tpudas_torch.obs.flight`): each round's spans and one
    ``round`` record with its phase timeline
    (:mod:`tpudas_torch.obs.phases`), retries and the fatal error.
    ``live`` (None reads ``TPUDAS_LIVE``, on at ``1``) attaches the
    round loop to the push plane (:mod:`tpudas_torch.live`): each
    round's output rows and new detect events are published to the
    stream's :class:`~tpudas_torch.live.hub.LiveHub`, registered under
    the absolute output folder, for ``GET /live`` subscribers of a
    :class:`~tpudas_torch.serve.http.DASServer`.  The hub holds no
    durable state: its failures are counted and swallowed, and any
    number of subscribers leave the outputs as they would be without.

    Not ported yet, and raising ``NotImplementedError`` when set to
    anything but their off value (None or False), or left at None while
    ``TPUDAS_MESH`` (above 1) turns a mesh on: ``mesh`` and
    ``window_dp``.

    Every round runs inside the JAX package's fault boundary
    (:mod:`tpudas_torch.resilience`): ``fault_policy`` (a
    :class:`~tpudas_torch.resilience.faults.RetryPolicy`; default
    ``RetryPolicy()``) decides how often and after what backoff a
    failed round is retried (the wait goes through ``sleep_fn``), and
    ``quarantine`` (default on) keeps a ``.quarantine.json`` ledger in
    the output folder that excludes a file after
    ``quarantine_after`` failed reads or scans.  A fatal error, or one
    past the policy's ``max_consecutive``, propagates to the caller.
    """
    check_unported(dict(mesh=mesh, window_dp=window_dp), "lowpass")
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


def run_rolling_realtime(
    source,
    output_folder,
    window,
    step,
    scale=1.0,
    distance=None,
    poll_interval=None,
    file_duration=30.0,
    max_rounds=None,
    sleep_fn=_time.sleep,
    engine=None,
    mesh=None,
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
    """Poll ``source`` and rolling-mean each NEW patch (stateless per
    file — rolling_mean_dascore_edge.ipynb:209-221).  Returns the number
    of rounds that processed data.

    The signature is the JAX package's, plus ``device`` (default: the
    CUDA card; ``"cpu"`` on request).  Each new patch is rolled with
    ``patch.rolling(time=window, step=step, engine=engine).mean()``
    (the device engine unless ``engine`` is ``"numpy"``/``"host"``),
    scaled by ``scale`` and written under its ``LFDAS_*`` name.
    Patches are identified by their time span, so a file that arrives
    late with an earlier timestamp is still processed.  Rounds run
    inside the same fault boundary as :func:`run_lowpass_realtime`
    (``fault_policy`` / ``quarantine``); patches written before a
    failure are not redone.  ``detect`` (default ``TPUDAS_DETECT=1``,
    operators via ``detect_operators``) runs the detect operators over
    each round's outputs.  The rolling grid is anchored per file: for a
    globally uniform grid (what detection assumes) use a ``step`` that
    divides the file duration.

    ``pyramid`` (None reads ``TPUDAS_PYRAMID``) keeps the tile pyramid
    over the rolling outputs, ``flight`` (None reads ``TPUDAS_FLIGHT``,
    on unless ``0``) the flight ring and ``live`` (None reads
    ``TPUDAS_LIVE``) the live push hub, as in
    :func:`run_lowpass_realtime`; the rolling runner writes no health
    snapshot (the JAX one neither).

    Not ported yet, and raising ``NotImplementedError`` when set, or
    left at None while ``TPUDAS_MESH`` (above 1) turns it on: ``mesh``
    (the JAX package's batched rolling over a device mesh).  The output
    folder is audited before the first round, as in
    :func:`run_lowpass_realtime`.
    """
    check_unported(dict(mesh=mesh), "rolling")
    config = StreamConfig(
        kind="rolling",
        window=window,
        step=step,
        scale=scale,
        distance=distance,
        poll_interval=poll_interval,
        file_duration=file_duration,
        engine=engine,
        mesh=mesh,
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
    runner = build_runner(spec, device=device)
    return drive(runner, max_rounds=max_rounds, sleep_fn=sleep_fn)
