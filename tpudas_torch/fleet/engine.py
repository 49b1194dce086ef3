"""The round engine: one stream's polling loop as an object.

The port's counterpart of the low-pass half of :mod:`tpudas.fleet.engine`.
A runner's :meth:`StreamRunner.step` is one poll of the realtime loop —
index update, processing round, carry commit, all inside the fault
boundary — and returns a :class:`StepResult` saying what happened and
how long to wait before the next poll.  ``step`` never sleeps: the
caller waits (the single-stream :func:`drive` loop here, or the
multi-stream :class:`tpudas_torch.fleet.fleet.FleetEngine`).

The fault boundary is the JAX package's
(:mod:`tpudas_torch.resilience`): every round runs under a
:class:`~tpudas_torch.resilience.faults.FaultBoundary` built from the
configuration's ``fault_policy`` (default
:class:`~tpudas_torch.resilience.faults.RetryPolicy`) and, unless
``quarantine=False``, a
:class:`~tpudas_torch.resilience.quarantine.QuarantineLedger` in the
output folder.  A transient, corrupt, network or resource failure drops
the in-memory carry (the retry re-resolves it from disk, exactly as a
process restart would) and returns ``StepResult("retry", delay)``; a
file that keeps failing is quarantined and the rounds go on without
it; a fatal failure, or one past the policy's limit, propagates.

A runner holds no durable state of its own: kill the process anywhere
and a new runner over the same folders resumes where the persisted
stream carry says (:mod:`tpudas_torch.proc.stream`).

Detection (``detect=True``, :mod:`tpudas_torch.detect`) runs after each
round's output writes, over the round's emitted patches; its failures
are counted and swallowed, and the detect round is shed while the disk
is full (:mod:`tpudas_torch.integrity.resource`).  A low-pass stream
with a ``rolling_output_folder`` runs the joint product
(:class:`~tpudas_torch.proc.joint.JointProc`) in rewind mode;
:class:`RollingStreamRunner` is the stateless per-file rolling mean.

Before the first round each runner audits and repairs its output folder
(:func:`_startup_audit`, :mod:`tpudas_torch.integrity.audit`), as the
JAX runners do; ``TPUDAS_INTEGRITY_AUDIT=0`` turns that off.

The tile pyramid (``pyramid=True``, or ``TPUDAS_PYRAMID=1`` for a field
left at None; :mod:`tpudas_torch.serve.tiles`) is appended after each
round's output writes, before detection, from the same in-memory
capture of the round's output patches (:func:`_append_pyramid`); its
failures are counted and swallowed as in the JAX runners, and the
append is shed while the disk is full.

Observability, as in the JAX runners (:mod:`tpudas_torch.obs`):

- **Health** (``health=True``, or ``TPUDAS_HEALTH=1`` for a low-pass
  field left at None): ``health.json`` and ``metrics.prom`` beside the
  carry after every round, on a retry, at clean termination and at a
  fatal failure (:class:`_EdgeHealth`).
- **Flight** (``flight=None`` reads ``TPUDAS_FLIGHT``, on unless ``0``):
  the crash-surviving ring under ``.flight/``
  (:class:`tpudas_torch.obs.flight.FlightRecorder`), opened after the
  startup audit.  Each step runs under the recorder's span capture; a
  retry writes a ``fault`` record, a fatal failure a fatal one, and
  every processed round ends with ONE ``round`` record (its phases,
  head lag, realtime factor, device-telemetry fields) and ONE flush.
- **Phases**: every processed round times the ten phases of
  :data:`tpudas_torch.obs.phases.PHASES` with the JAX runners'
  attribution.  Until the device telemetry is ported the round does
  what the JAX runner does under ``TPUDAS_DEVPROF=0``:
  ``device_execute`` is 0.0 and ``host_wait`` carries the processing
  call's whole residual; ``place`` and ``live`` are 0.0 (no mesh, no
  live plane).

Not ported in this slice: the live plane, device telemetry, the mesh
and window data parallelism, and the backfill clamps (``time_range``,
``ingest_limit_sec``).  A runner raises ``NotImplementedError`` when
its configuration, or the environment variable the JAX runner reads
for a field left at None (:data:`UNPORTED_ENV`), turns on one of those
features (see :data:`UNPORTED_FIELDS`).
"""

from __future__ import annotations

import math
import os
import time as _time
import zlib
from dataclasses import dataclass

import numpy as np

from tpudas_torch.core import units as _units
from tpudas_torch.core.timeutils import to_datetime64, to_timedelta64
from tpudas_torch.device import resolve_device
from tpudas_torch.fleet.config import StreamSpec
from tpudas_torch.integrity import resource as _resource
from tpudas_torch.io.spool import spool as make_spool
from tpudas_torch.obs.flight import capture as flight_capture
from tpudas_torch.obs.health import write_health, write_prom
from tpudas_torch.obs.phases import RoundPhases
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.proc.joint import JointProc
from tpudas_torch.proc.lfproc import LFProc
from tpudas_torch.proc.naming import get_filename
from tpudas_torch.resilience.faults import (
    FaultBoundary,
    RetryPolicy,
    fault_point,
)
from tpudas_torch.resilience.quarantine import QuarantineLedger
from tpudas_torch.utils.logging import log_event
from tpudas_torch.utils.profiling import Counters

__all__ = [
    "POLL_FLOOR_SEC",
    "UNPORTED_ENV",
    "UNPORTED_FIELDS",
    "LowpassStreamRunner",
    "PollJitter",
    "RollingStreamRunner",
    "StepResult",
    "StreamRunner",
    "build_runner",
    "check_ported",
    "check_unported",
    "clamp_poll_interval",
    "drive",
]

# configuration fields whose features the port does not have yet; each
# must stay at its off value (None or False)
UNPORTED_FIELDS = (
    "mesh",
    "window_dp",
    "live",
)


# the environment variable the JAX runners read for an unported field
# left at None; window_dp has none
UNPORTED_ENV = {
    "mesh": "TPUDAS_MESH",
    "live": "TPUDAS_LIVE",
}


def _unported_from_env(name: str, kind: str):
    """The value the JAX runner of ``kind`` resolves for ``name`` left
    at None: ``TPUDAS_MESH=N`` is a mesh over N devices (0 and 1 mean
    none, as in ``tpudas.parallel.mesh.resolve_mesh``), ``TPUDAS_LIVE``
    is on at ``1``."""
    env = UNPORTED_ENV.get(name)
    if env is None:
        return None
    raw = os.environ.get(env, "").strip()
    if name == "mesh":
        if not raw:
            return None
        n = int(raw)
        if n < 0:
            raise ValueError(f"mesh device count must be >= 0, got {n}")
        return n if n > 1 else None
    return True if raw == "1" else None


def check_ported(spec: StreamSpec) -> None:
    """Raise ``NotImplementedError`` when ``spec`` asks for a feature
    (:data:`UNPORTED_FIELDS`) the port lacks, by its configuration or by
    the environment."""
    cfg = spec.config
    check_unported({n: getattr(cfg, n) for n in UNPORTED_FIELDS}, cfg.kind)


def check_unported(values: dict, kind: str = "lowpass") -> None:
    """Raise ``NotImplementedError`` for any :data:`UNPORTED_FIELDS`
    entry of ``values`` that is not at its off value (None or False),
    resolving a None from its environment variable
    (:data:`UNPORTED_ENV`) as the JAX runner of ``kind`` does."""
    for name in UNPORTED_FIELDS:
        v = values.get(name)
        what = f"{name}={v!r}"
        if v is None:
            v = _unported_from_env(name, kind)
            if v is not None:
                env = UNPORTED_ENV[name]
                what = f"{env}={os.environ[env]!r} ({name}={v!r})"
        if v is not None and v is not False:
            raise NotImplementedError(
                f"{what}: this feature of the realtime driver is not "
                "ported to tpudas_torch yet"
            )


@dataclass
class StepResult:
    """What one :meth:`StreamRunner.step` did.

    ``status`` is ``"processed"`` (a round completed), ``"empty"`` (the
    poll saw no files), ``"terminate"`` (the spool stopped growing:
    the stream is done — the caller then calls
    :meth:`StreamRunner.finish`) or ``"retry"`` (the round failed and
    the fault boundary scheduled a retry; ``kind`` is the failure's
    class and ``attempt`` the consecutive failures so far).  ``delay``
    is the advisory wait before the next ``step`` (the jittered poll
    interval, or the retry backoff)."""

    status: str
    delay: float = 0.0
    kind: str = ""
    attempt: int = 0


class PollJitter:
    """Deterministic per-stream poll jitter: a tiny LCG seeded by the
    stream id.  ``stretch()`` returns a factor in ``[1, 1 + fraction)``
    and advances the LCG once."""

    def __init__(self, stream_id, fraction: float):
        self.fraction = max(float(fraction or 0.0), 0.0)
        # crc32 folds any id into a stable 32-bit seed; "or 1" keeps the
        # LCG out of the zero fixed point
        self._state = zlib.crc32(str(stream_id).encode()) & 0x7FFFFFFF or 1

    def next_unit(self) -> float:
        self._state = (1103515245 * self._state + 12345) % (1 << 31)
        return self._state / float(1 << 31)

    def stretch(self) -> float:
        if not self.fraction:
            return 1.0
        return 1.0 + self.fraction * self.next_unit()


def resolve_poll_jitter(poll_jitter) -> float:
    """The explicit fraction, else ``TPUDAS_POLL_JITTER``, else 0."""
    if poll_jitter is None:
        raw = os.environ.get("TPUDAS_POLL_JITTER", "")
        poll_jitter = float(raw) if raw else 0.0
    return max(float(poll_jitter), 0.0)


def _head_lag_seconds(t2, lfp, carry) -> float | None:
    """Stream-seconds between the fiber head (newest indexed input,
    ``t2``) and the newest emitted output.  None before the first
    output."""
    if carry is not None and carry.last_emit_ns is not None:
        t_out_ns = int(carry.last_emit_ns)
    else:
        try:
            t_out_ns = int(
                to_datetime64(lfp.get_last_processed_time())
                .astype("datetime64[ns]").astype(np.int64)
            )
        except (FileNotFoundError, IndexError):
            return None
    return (int(np.datetime64(t2, "ns").astype(np.int64)) - t_out_ns) / 1e9


def _finite(value) -> float:
    """An index cell as a finite float (0.0 for None/NaN/junk)."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return 0.0
    return v if math.isfinite(v) else 0.0


def _covered_workload(rows, t1, t2):
    """(data_seconds, channel_samples) present in the index records
    ``rows`` (a spool's ``contents()``) within [t1, t2), accounted per
    file, so round metrics stay honest across gaps and rewinds."""
    lo = to_datetime64(t1).astype("datetime64[ns]")
    hi = to_datetime64(t2).astype("datetime64[ns]")
    data_ns = 0.0
    samples = 0.0
    for row in rows:
        f_lo = np.datetime64(row["time_min"], "ns")
        f_hi = np.datetime64(row["time_max"], "ns")
        span_ns = (f_hi - f_lo) / np.timedelta64(1, "ns")
        ov_ns = (min(hi, f_hi) - max(lo, f_lo)) / np.timedelta64(1, "ns")
        if ov_ns <= 0:
            continue
        data_ns += ov_ns
        n_time = _finite(row.get("ntime"))
        if span_ns > 0 and n_time > 1:
            fs = (n_time - 1) / (span_ns / 1e9)
            samples += ov_ns / 1e9 * fs * _finite(row.get("ndistance"))
    return data_ns / 1e9, samples


class _EdgeHealth:
    """Per-run health bookkeeping for the realtime runner: assembles the
    ``health.json`` payload (schema 3, :mod:`tpudas_torch.obs.health`)
    and drops it, with the Prometheus exposition, beside the stream
    carry.  On with ``health=True`` (or ``TPUDAS_HEALTH=1``); write
    failures are counted and swallowed.

    ``integrity_fallbacks`` is this run's count of verified reads that
    rejected a primary artifact and took a ladder step;
    ``resource_degraded`` mirrors the disk-full shedding flag.  Either
    marks the snapshot ``degraded``.  Under disk pressure
    ``metrics.prom`` is shed (counted) while ``health.json`` keeps
    being written: it is the operator's window into the degradation.
    ``detect`` (the detect round's summary) and ``extra`` (such as the
    fleet's park/unpark record) are merged into every snapshot as
    sub-objects outside the required schema."""

    def __init__(self, folder, enabled, boundary=None):
        from tpudas_torch.integrity.checksum import fallback_count

        self.folder = folder
        self.enabled = enabled
        self.boundary = boundary  # FaultBoundary (degradation fields)
        self.carry_resumes = 0
        self.last_error = None
        self.detect = None
        self.extra: dict = {}
        self._fb0 = fallback_count()  # run baseline for the delta

    def integrity_fallbacks(self) -> int:
        from tpudas_torch.integrity.checksum import fallback_count

        return fallback_count() - self._fb0

    def write(self, counters, rounds, polls, mode, round_rt, head_lag):
        if not self.enabled:
            return
        b = self.boundary
        fallbacks = self.integrity_fallbacks()
        res_degraded = _resource.is_degraded()
        degraded = (
            (False if b is None else b.degraded)
            or res_degraded
            or fallbacks > 0
        )
        payload_extra = dict(self.extra)
        if self.detect is not None:
            payload_extra["detect"] = self.detect
        write_health(
            self.folder,
            {
                **payload_extra,
                "rounds": rounds,
                "polls": polls,
                "mode": mode,
                "realtime_factor": round(counters.realtime_factor, 3),
                "round_realtime_factor": round(round_rt, 3),
                "head_lag_seconds": (
                    None if head_lag is None else round(head_lag, 3)
                ),
                "redundant_ratio": round(counters.redundant_ratio, 4),
                "carry_resume_count": self.carry_resumes,
                "last_round_wall_seconds": round(counters.last_wall, 4),
                "consecutive_failures": 0 if b is None else b.consecutive,
                "quarantined_files": (
                    0 if b is None else b.quarantined_count
                ),
                "degraded": degraded,
                "integrity_fallbacks": fallbacks,
                "resource_degraded": res_degraded,
                "last_error": self.last_error
                or (None if b is None else b.last_error),
            },
        )
        if not _resource.should_shed("prom"):
            write_prom(self.folder)


POLL_FLOOR_SEC = 125.0


def clamp_poll_interval(requested, file_duration, edge_buffer):
    """The reference's cadence guard (low_pass_dascore_edge.ipynb:165-173):
    ``max(125 s, file duration, 3 * edge buffer)``, never faster than
    requested.  Tests inject ``sleep_fn`` rather than lowering it."""
    return max(
        float(requested),
        POLL_FLOOR_SEC,
        float(file_duration),
        3.0 * float(edge_buffer),
    )


def _startup_audit(output_folder) -> None:
    """The runners' pre-first-round fsck
    (:mod:`tpudas_torch.integrity.audit`): sweep stale tmp files, verify
    every durable artifact, repair through the ``.prev`` ladder.
    ``TPUDAS_INTEGRITY_AUDIT=0`` turns it off.  Never raises, as in the
    JAX runners: an audit failure must not take down the stream it
    protects (counted in ``tpudas_integrity_audit_errors_total`` and
    logged)."""
    if os.environ.get("TPUDAS_INTEGRITY_AUDIT", "1") == "0":
        return
    try:
        from tpudas_torch.integrity.audit import audit

        report = audit(output_folder, repair=True)
        if report["issues"]:
            print(
                f"Integrity audit repaired {report['repaired']} "
                f"artifact(s) in {output_folder} "
                f"(clean={report['clean']})"
            )
    except Exception as exc:
        get_registry().counter(
            "tpudas_integrity_audit_errors_total",
            "startup integrity audits that raised (swallowed)",
        ).inc()
        log_event(
            "integrity_audit_failed",
            folder=str(output_folder),
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )


def _detect_config(cfg):
    """``(detect on?, operator specs)``: ``detect=None`` reads
    ``TPUDAS_DETECT``."""
    detect = cfg.detect
    if detect is None:
        detect = os.environ.get("TPUDAS_DETECT", "0") == "1"
    return bool(detect), cfg.detect_operators


def _pyramid_config(cfg) -> bool:
    """Whether the stream keeps a tile pyramid: ``pyramid=None`` reads
    ``TPUDAS_PYRAMID``, as the JAX runners do."""
    pyramid = cfg.pyramid
    if pyramid is None:
        pyramid = os.environ.get("TPUDAS_PYRAMID", "0") == "1"
    return bool(pyramid)


def _append_pyramid(output_folder, rnd, emitted, state) -> None:
    """Per-round serve-side hook: cascade this round's new output rows
    into the :mod:`tpudas_torch.serve.tiles` pyramid beside the carry.

    ``emitted`` holds the round's output patches captured in memory at
    their write site (the same capture detection reads), so the steady
    append costs tile IO only — no index rescan, no re-read of files
    this process just wrote.  ``state["store"]`` carries the open store
    across rounds (a stat-gated refresh per round, not a re-parse); it
    is dropped to None on any failure, and any discontinuity (fresh
    folder, crashed append) falls back to the file-backed sync, so a
    retried or crash-resumed round needs no pyramid bookkeeping: disk
    is the only durable state.  A pyramid failure is counted in
    ``tpudas_serve_pyramid_errors_total`` and swallowed, as in the JAX
    runners: the read side degrades (the query engine falls back to
    the output files), the write side must not.  A disk-full failure
    flips the shedding flag (``note_pressure("pyramid")``); a corrupt
    store is rebuilt from the output files."""
    from tpudas_torch.obs.trace import span
    from tpudas_torch.serve.tiles import (
        CorruptStoreError,
        append_patches,
        rebuild_pyramid,
    )

    reg = get_registry()
    t0 = _time.perf_counter()
    try:
        with span("serve.pyramid_append", round=rnd):
            appended, state["store"] = append_patches(
                output_folder, emitted, store=state.get("store")
            )
    except Exception as exc:
        state["store"] = None  # crash-equivalent: re-resolve from disk
        reg.counter(
            "tpudas_serve_pyramid_errors_total",
            "per-round pyramid appends that failed (swallowed; the "
            "query engine falls back to full-resolution files)",
        ).inc()
        log_event(
            "pyramid_append_failed",
            round=rnd,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        if _resource.is_resource_error(exc):
            # disk full: the next rounds skip the append until the
            # recovery probe succeeds, then backfill from the files
            _resource.note_pressure("pyramid", exc)
        elif isinstance(exc, CorruptStoreError):
            # torn tails, checksum-failed tile: the ladder's last rung,
            # delete + rebuild from the output files, mid-run
            try:
                rebuild_pyramid(output_folder)
            except Exception as exc2:
                log_event(
                    "pyramid_rebuild_failed",
                    round=rnd,
                    error=f"{type(exc2).__name__}: {str(exc2)[:200]}",
                )
        return
    reg.histogram(
        "tpudas_serve_pyramid_append_seconds",
        "per-round tile-pyramid append wall time",
    ).observe(_time.perf_counter() - t0)
    if appended:
        log_event("pyramid_append", round=rnd, rows=int(appended))


def _run_pyramid(runner, rnd, emitted, ph):
    """The round's pyramid hook: shed while the disk is full, else
    :func:`_append_pyramid`, timed into the round's ``pyramid`` phase.
    Returns its wall seconds, or None when the pyramid is off or
    shed."""
    if not runner.pyramid or _resource.should_shed("pyramid"):
        return None
    t0 = _time.perf_counter()
    with ph.measure("pyramid"):
        _append_pyramid(runner.output_folder, rnd, emitted, runner.pyr_state)
    return _time.perf_counter() - t0


def _run_detect(runner, rnd, emitted, step_sec, ph):
    """The round's detect hook over the captured output patches, timed
    into the round's ``detect`` phase: shed while the disk is full, else
    :func:`run_detect_round` (which counts and swallows its own
    failures).  Returns its wall seconds, or None when detection is
    off."""
    if not runner.detect:
        return None
    from tpudas_torch.detect.runner import mark_detect_shed, run_detect_round

    t0 = _time.perf_counter()
    with ph.measure("detect"):
        if _resource.should_shed("detect"):
            mark_detect_shed(runner.det_state)
        else:
            run_detect_round(
                runner.output_folder, rnd, emitted, runner.det_state,
                operators=runner.detect_operators, step_sec=step_sec,
                device=runner.device,
            )
    return _time.perf_counter() - t0


def _devprof_fields() -> dict:
    """The round record's ``devprof`` fields: what the JAX runner
    stamps under ``TPUDAS_DEVPROF=0`` until the device telemetry is
    ported (no launches counted, no device seconds, no bound, no
    utilization)."""
    return {
        "launches": 0.0,
        "device_execute_s": 0.0,
        "bound": None,
        "utilization": None,
    }


def write_rolling_output(patch, path) -> None:
    """Write one rolling-stream output patch: dasdae HDF5 at the
    ``LFDAS_*.h5`` name, as the JAX package does.  A module-level
    function, so a host without h5py can put another writer here."""
    patch.io.write(path, "dasdae")


class StreamRunner:
    """Base: identity, jitter and the step bookkeeping every kind
    shares.  Subclasses implement :meth:`step`."""

    kind = "?"

    def __init__(self, spec: StreamSpec, output_folder: str):
        self.spec = spec
        self.stream_id = str(spec.stream_id)
        self.source = spec.source
        self.output_folder = str(output_folder)
        self.rounds = 0
        self.polls = 0
        self.jitter = PollJitter(
            self.stream_id, resolve_poll_jitter(spec.config.poll_jitter)
        )
        self.interval = 0.0  # subclasses set the clamped poll cadence
        # batched fleet service: the fleet's group service installs its
        # BatchStepExecutor here for one step; _process_round hands it
        # to the round's LFProc so the stream's device steps rendezvous.
        # None (the default) is the solo step.
        self._batch_executor = None
        # observability: the crash-surviving flight recorder (subclasses
        # call _init_flight once the folder exists and is audited) and
        # the in-flight round's phase timeline
        self.flight = None
        self._round_phases = None

    def _init_flight(self, cfg) -> None:
        """Open the on-disk flight recorder beside the carry
        (``flight=`` / ``TPUDAS_FLIGHT``, on by default, as in the JAX
        package: the recorder exists for the SIGKILL the in-memory ring
        cannot survive).  Called after the startup audit, so a repaired
        ring is resumed, not raced."""
        flight = cfg.flight
        if flight is None:
            flight = os.environ.get("TPUDAS_FLIGHT", "1") == "1"
        if flight:
            from tpudas_torch.obs.flight import FlightRecorder

            self.flight = FlightRecorder(self.output_folder)

    def _flight_record(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, stream=self.stream_id, **fields)

    def _flight_flush(self) -> None:
        if self.flight is not None:
            self.flight.flush()

    def poll_delay(self) -> float:
        """The clamped interval stretched by this stream's jitter."""
        return self.interval * self.jitter.stretch()

    def step(self) -> StepResult:
        raise NotImplementedError

    def finish(self) -> None:
        """Clean-termination flush (never called on a crash path)."""

    def record_fatal(self, exc: BaseException) -> None:
        """Called just before a round's exception propagates."""


class LowpassStreamRunner(StreamRunner):
    """One low-pass stream: the ``run_lowpass_realtime`` round loop.
    See that driver's docstring for every knob's semantics."""

    kind = "lowpass"

    def __init__(
        self,
        spec: StreamSpec,
        output_folder: str,
        counters: Counters | None = None,
        on_round=None,
        device=None,
    ):
        super().__init__(spec, output_folder)
        cfg = spec.config
        if cfg.kind != "lowpass":
            raise ValueError(
                f"LowpassStreamRunner needs kind='lowpass', got {cfg.kind!r}"
            )
        check_ported(spec)
        self.device = resolve_device(device)
        self.on_round = on_round
        self.d_t = float(cfg.output_sample_interval)
        self.edge_buffer = float(cfg.edge_buffer)
        self.buff_out = int(np.ceil(self.edge_buffer / self.d_t))
        self.process_patch_size = int(cfg.process_patch_size)
        self.interval = clamp_poll_interval(
            125.0 if cfg.poll_interval is None else cfg.poll_interval,
            0.0 if cfg.file_duration is None else cfg.file_duration,
            self.edge_buffer,
        )
        self.start_time = to_datetime64(cfg.start_time)
        self.distance = cfg.distance
        self.rolling_output_folder = cfg.rolling_output_folder
        self.rolling_window = cfg.rolling_window
        self.rolling_step = cfg.rolling_step
        self.extra = {
            k: v
            for k, v in (
                ("engine", cfg.engine),
                ("on_gap", cfg.on_gap),
                ("filter_order", cfg.filter_order),
                ("data_gap_tolerance", cfg.data_gap_tolerance),
            )
            if v is not None
        }
        self.counters = counters if counters is not None else Counters()
        health = cfg.health
        if health is None:
            health = os.environ.get("TPUDAS_HEALTH", "0") == "1"
        policy = (
            cfg.fault_policy if cfg.fault_policy is not None
            else RetryPolicy()
        )
        # carry, ledger, health and outputs live in the output folder
        os.makedirs(self.output_folder, exist_ok=True)
        # startup fsck before any persisted state (ledger, carry) loads
        _startup_audit(self.output_folder)
        self._init_flight(cfg)
        if _resource.is_degraded():
            # stale in-process pressure from a previous run: re-probe
            _resource.probe_recovery(self.output_folder)
        ledger = (
            QuarantineLedger(self.output_folder) if cfg.quarantine else None
        )
        self.boundary = FaultBoundary(policy, ledger)
        self.edge_health = _EdgeHealth(
            self.output_folder, bool(health), self.boundary
        )
        self.detect, self.detect_operators = _detect_config(cfg)
        self.det_state = {"pipe": None}  # cross-round detect pipeline
        self.pyramid = _pyramid_config(cfg)
        self.pyr_state = {"store": None}  # cross-round open tile store
        stateful = cfg.stateful
        if stateful is None:
            stateful = os.environ.get("TPUDAS_STREAM_STATEFUL", "1") != "0"
        # the joint product runs the window (rewind) path: its rolling
        # windows need the loaded halo, which the carry does not keep
        self.stateful = bool(stateful) and self.rolling_output_folder is None
        carry_save_every = cfg.carry_save_every
        if carry_save_every is None:
            carry_save_every = int(
                os.environ.get("TPUDAS_CARRY_SAVE_EVERY", "") or 1
            )
        self.carry_save_every = max(1, int(carry_save_every))
        self.carry = None  # the cross-round filter state (stateful)
        self.carry_unsaved = 0  # rounds since the last carry save
        self.carry_checked = False  # disk/legacy resolution, once
        self.rewind_wrote = False  # the first rewind write drops any carry
        # the first processing round starts at start_time, however many
        # empty polls precede it
        self.processed_once = False
        self.prev_t2 = None  # previous round's head (redundancy metric)
        self.len_last = None  # spool size at the previous poll
        self.round_rt = 0.0  # last round's realtime factor
        self.head_lag = None

    # -- one poll -------------------------------------------------------
    def step(self) -> StepResult:
        reg = get_registry()
        self.polls += 1
        reg.counter(
            "tpudas_stream_polls_total", "source spool polls"
        ).inc()
        # the round's phase timeline: every processed round emits all
        # phases exactly once; spans emitted on this thread during the
        # step land in this stream's flight recorder
        ph = self._round_phases = RoundPhases()
        try:
            with flight_capture(self.flight):
                fault_point("round.body", poll=self.polls)
                # quarantine exclusion + index update + scan-failure
                # strikes + slow-schedule probe bookkeeping
                with ph.measure("poll"):
                    sp = self.boundary.begin_round(
                        make_spool(self.source), self.source)
                    sub = (
                        sp.select(distance=self.distance)
                        if self.distance is not None else sp
                    )
                    n_now = len(sub)
                if (
                    self.len_last is not None
                    and n_now == self.len_last
                    and self.boundary.consecutive == 0
                ):
                    log_event(
                        "stream_terminated", stream=self.stream_id,
                        rounds=self.rounds, polls=self.polls,
                    )
                    return StepResult("terminate")
                status = "empty"
                if n_now > 0:
                    status = "processed"
                    self._process_round(sub, reg)
                else:
                    self.boundary.on_success()
                if _resource.is_degraded():
                    # disk-full recovery probe: one tiny write; the
                    # moment it succeeds, the shed writers resume
                    _resource.probe_recovery(self.output_folder)
                # every poll sets the growth baseline: the next poll
                # without growth terminates (the reference's loop ends
                # when the spool stops growing,
                # low_pass_dascore_edge.ipynb:205-207)
                self.len_last = n_now
        except Exception as exc:
            decision = self.boundary.on_failure(exc)
            if decision.propagate:
                raise
            # the retry survives the crash the flight ring exists for:
            # record it durably before the backoff sleep
            self._flight_record(
                "fault", poll=self.polls, fault_kind=decision.kind,
                attempt=self.boundary.consecutive,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            self._flight_flush()
            # crash-equivalent retry: drop the in-memory carry and
            # re-resolve it from disk on the next attempt, so a retried
            # round and a process restart are the same code path (the
            # resume reconciles any partial outputs)
            if self.stateful:
                self.carry = None
                self.carry_checked = False
                self.carry_unsaved = 0
            self.det_state["pipe"] = None
            self.pyr_state["store"] = None
            self.edge_health.write(
                self.counters, self.rounds, self.polls,
                self._mode(), 0.0, None,
            )
            return StepResult(
                "retry", decision.delay, decision.kind,
                self.boundary.consecutive,
            )
        return StepResult(status, self.poll_delay())

    def _mode(self) -> str:
        return "stateful" if self.stateful else "rewind"

    def _process_round(self, sub, reg) -> None:
        ph = self._round_phases
        if ph is None:  # direct callers outside step() still time
            ph = self._round_phases = RoundPhases()
        t_body = _time.perf_counter()
        t_prep0 = t_body  # host prep until the processing call
        joint_extra = {}
        if self.rolling_output_folder is not None:
            lfp = JointProc(sub, device=self.device)
            joint_extra = {
                k: v
                for k, v in (
                    ("rolling_window", self.rolling_window),
                    ("rolling_step", self.rolling_step),
                )
                if v is not None
            }
        else:
            lfp = LFProc(sub, device=self.device)
        # the processor is rebuilt every round: re-install the handoff
        lfp._batch_executor = self._batch_executor
        lfp.update_processing_parameter(
            output_sample_interval=self.d_t,
            process_patch_size=self.process_patch_size,
            edge_buff_size=self.buff_out,
            **self.extra,
            **joint_extra,
        )
        lfp.set_output_folder(self.output_folder, delete_existing=False)
        emitted = []
        if self.pyramid or self.detect:
            # the round's output patches, captured at their write site
            # for the pyramid append and the detect operators
            lfp.add_emit_listener(emitted.append)
        if self.rolling_output_folder is not None:
            lfp.set_rolling_output_folder(
                self.rolling_output_folder, delete_existing=False
            )
        rnd = self.rounds + 1
        log_event("round_start", round=rnd, stream=self.stream_id)
        if self.stateful and not self.carry_checked:
            self._resolve_carry(lfp, reg)
        # the newest timestamp from the index — no file data is read
        rows = sub.contents()
        t2 = max(np.datetime64(r["time_max"], "ns") for r in rows)
        # host prep so far (LFProc build, carry resolution, index
        # metadata) charges the read_decode phase; the in-call read and
        # decode wait is mirrored out of lfp.timings below
        ph.add("read_decode", _time.perf_counter() - t_prep0)
        redundant = 0.0
        if self.stateful:
            # carried state: only NEW samples are read and filtered
            t1 = (
                np.datetime64(int(self.carry.next_ingest_ns), "ns")
                if self.carry.next_ingest_ns is not None
                else self.start_time
            )
            data_sec, ch_samples = _covered_workload(rows, t1, t2)
            t_proc0 = _time.perf_counter()
            with span(
                "stream.round", mode="stateful", round=rnd
            ), self.counters.measure(int(ch_samples), data_sec):
                lfp.process_stream_increment(self.carry, t2)
            proc_wall = _time.perf_counter() - t_proc0
            from tpudas_torch.proc.stream import save_carry

            # saved AFTER the outputs: the carry is never ahead of the
            # files (resume reconciles the rest)
            self.carry_unsaved += 1
            if self.carry_unsaved >= self.carry_save_every:
                with ph.measure("commit"):
                    save_carry(self.carry, self.output_folder)
                self.carry_unsaved = 0
        else:
            resumed_stateful = False
            if not self.rewind_wrote:
                # a persisted carry means the folder head came from the
                # stateful mode; this rewind write would break the
                # carry's no-newer-outputs invariant, so drop it and
                # continue from the folder head
                self.rewind_wrote = True
                from tpudas_torch.proc.stream import discard_carry

                if discard_carry(self.output_folder):
                    resumed_stateful = True
            if not self.processed_once and not resumed_stateful:
                t1 = self.start_time
            else:
                try:
                    t_last = lfp.get_last_processed_time()
                except IndexError:
                    # no output yet (the stream is still shorter than
                    # the edge trim): restart from the beginning
                    t_last = None
                if t_last is None:
                    t1 = self.start_time
                else:
                    # rewind (ceil(edge/dt) - 1) output steps, on the
                    # output grid: the resumed run's first emitted
                    # sample is t_last + d_t
                    rewind_sec = (
                        math.ceil(self.edge_buffer / self.d_t) - 1
                    ) * self.d_t
                    t1 = t_last - to_timedelta64(rewind_sec)
            data_sec, ch_samples = _covered_workload(rows, t1, t2)
            if self.prev_t2 is not None and t1 < self.prev_t2:
                # full-rate samples re-read only to rebuild the filter's
                # transient state (what the stateful mode removes)
                _, redundant = _covered_workload(
                    rows, t1, min(self.prev_t2, t2)
                )
                self.counters.add_redundant(int(redundant))
            t_proc0 = _time.perf_counter()
            with span(
                "stream.round", mode="rewind", round=rnd
            ), self.counters.measure(int(ch_samples), data_sec):
                lfp.process_time_range(t1, t2)
            proc_wall = _time.perf_counter() - t_proc0
        # phase attribution of the processing call: the round's fresh
        # LFProc timings ARE its read/decode wait and output writes; the
        # rest of the call is host_wait (kernel dispatch through host
        # sync, engine glue).  device_execute stays 0.0 and place 0.0
        # until the device telemetry and a mesh are ported (the JAX
        # runner's TPUDAS_DEVPROF=0 split, unsharded)
        assemble_s = float(lfp.timings.get("assemble_s", 0.0))
        write_s = float(lfp.timings.get("write_s", 0.0))
        ph.add("read_decode", assemble_s)
        ph.add("commit", write_s)
        ph.add("host_wait", max(proc_wall - assemble_s - write_s, 0.0))
        self.prev_t2 = t2
        self.rounds = rnd
        self.round_rt = (
            data_sec / self.counters.last_wall if self.counters.last_wall
            else 0.0
        )
        mode_str = self._mode()
        reg.counter(
            "tpudas_stream_rounds_total",
            "processing rounds completed",
            labelnames=("mode",),
        ).inc(mode=mode_str)
        reg.histogram(
            "tpudas_stream_round_seconds",
            "per-round measured processing wall time",
        ).observe(self.counters.last_wall)
        reg.gauge(
            "tpudas_stream_realtime_factor",
            "last round's data-seconds per wall-second",
        ).set(self.round_rt)
        reg.gauge(
            "tpudas_stream_redundant_ratio",
            "cumulative fraction of channel-samples re-read to "
            "rebuild filter state",
        ).set(self.counters.redundant_ratio)
        # stateful head lag is O(1) off the carry; the rewind fallback
        # rescans the output index, so only pay it when health is on
        self.head_lag = (
            _head_lag_seconds(
                t2, lfp, self.carry if self.stateful else None
            )
            if (self.stateful or self.edge_health.enabled)
            else None
        )
        if self.head_lag is not None:
            reg.gauge(
                "tpudas_stream_head_lag_seconds",
                "stream-seconds between the fiber head and the "
                "newest emitted output",
            ).set(self.head_lag)
        pyramid_s = _run_pyramid(self, rnd, emitted, ph)
        detect_s = _run_detect(self, rnd, emitted, self.d_t, ph)
        if self.detect:
            self.edge_health.detect = self.det_state.get("summary")
        log_event(
            "realtime_round",
            round=rnd,
            upto=str(t2),
            mode=mode_str,
            data_seconds=round(data_sec, 3),
            redundant_samples=int(redundant),
            wall_seconds=round(self.counters.last_wall, 4),
            realtime_factor=round(self.round_rt, 2),
            head_lag_seconds=self.head_lag,
            engine=lfp.parameters["engine"],
            engine_counts=dict(lfp.engine_counts),
            stream_blocks=dict(lfp.stream_blocks),
            pyramid_seconds=pyramid_s,
            detect_seconds=detect_s,
        )
        self.boundary.on_success()
        with ph.measure("health"):
            self.edge_health.write(
                self.counters, rnd, self.polls, mode_str, self.round_rt,
                self.head_lag,
            )
        reg.histogram(
            "tpudas_stream_round_body_seconds",
            "full processing-round wall time (index update "
            "through health write, pyramid append included)",
        ).observe(_time.perf_counter() - t_body)
        # the round's durable trace: the phase timeline record, then ONE
        # flush — a SIGKILL after this point leaves the whole round (its
        # spans, then this record) in the flight ring
        phases_rec = ph.finish(reg)
        self._round_phases = None  # finished: never re-accumulated
        self._flight_record(
            "round",
            round=rnd,
            mode=mode_str,
            data_seconds=round(data_sec, 3),
            realtime_factor=round(self.round_rt, 3),
            head_lag=(
                None if self.head_lag is None
                else round(self.head_lag, 3)
            ),
            phases=phases_rec,
            devprof=_devprof_fields(),
        )
        self._flight_flush()
        if self.on_round is not None:
            self.on_round(rnd, lfp)
        self.processed_once = True

    def _resolve_carry(self, lfp, reg) -> None:
        """One-time disk resolution: resume a persisted carry, or
        continue a folder that has outputs but no carry in rewind mode
        (its resume point is only expressible as a rewind)."""
        self.carry_checked = True
        from tpudas_torch.proc.stream import (
            carry_matches,
            load_carry,
            reconcile_outputs,
            save_carry,
        )

        carry = load_carry(self.output_folder)
        if carry is not None and not carry_matches(carry, lfp, self.start_time):
            raise ValueError(
                f"persisted stream carry in {self.output_folder} was "
                "produced under a different start_time or processing "
                "parameters; delete it (or the folder) to change "
                "configuration"
            )
        if carry is not None:
            # patch size only shapes chunking: honor the live setting
            carry.patch_out = self.process_patch_size
            # a compatible engine change (the cascade <-> fused
            # crossover shares the carry layout) is honored mid-stream
            live_engine = str(lfp.parameters["engine"])
            if carry.engine_req != live_engine:
                log_event(
                    "stream_engine_crossover",
                    was=carry.engine_req, now=live_engine,
                )
                carry.engine_req = live_engine
            reconcile_outputs(self.output_folder, carry)
            log_event("stream_resume", emitted=carry.emitted)
            self.edge_health.carry_resumes += 1
            reg.counter(
                "tpudas_stream_carry_resumes_total",
                "rounds resumed from a persisted stream carry",
            ).inc()
            self.carry = carry
            return
        try:
            lfp.get_last_processed_time()
            has_outputs = True
        except (FileNotFoundError, IndexError) as exc:
            # the two expected "no outputs yet" signals (new or empty
            # folder); any other error propagates
            has_outputs = False
            log_event(
                "stream_no_prior_outputs",
                reason=f"{type(exc).__name__}: {str(exc)[:120]}",
            )
        if has_outputs:
            self.stateful = False
            print(
                "Existing output folder has no stream carry; continuing "
                "in rewind mode"
            )
            log_event("stream_legacy_rewind")
        else:
            self.carry = lfp.open_stream(self.start_time)
            # persisted BEFORE the first outputs: a crash mid-round-1
            # still reads as a stateful folder (reconcile + resume)
            save_carry(self.carry, self.output_folder)

    # -- terminal paths -------------------------------------------------
    def finish(self) -> None:
        # clean termination: flush a deferred carry save (cadence > 1)
        # so the next process resumes from the true head
        if self.stateful and self.carry is not None and self.carry_unsaved:
            from tpudas_torch.proc.stream import save_carry

            save_carry(self.carry, self.output_folder)
            self.carry_unsaved = 0
        # the final snapshot: quarantine/degradation state from the LAST
        # poll (a file can be quarantined by the poll that terminates
        # the loop) must be visible
        self.edge_health.write(
            self.counters, self.rounds, self.polls,
            self._mode(), self.round_rt, self.head_lag,
        )
        self._flight_record(
            "event", name="finish", rounds=self.rounds, polls=self.polls,
        )
        self._flight_flush()
        log_event(
            "stream_finish", stream=self.stream_id, rounds=self.rounds,
            polls=self.polls,
        )

    def record_fatal(self, exc: BaseException) -> None:
        # terminal failure: the LAST health snapshot an operator sees
        # must say why the stream died
        self.edge_health.last_error = (
            f"{type(exc).__name__}: {str(exc)[:300]}"
        )
        get_registry().counter(
            "tpudas_stream_errors_total",
            "realtime driver crashes (recorded in health.json)",
        ).inc()
        self.edge_health.write(
            self.counters, self.rounds, self.polls,
            self._mode(), 0.0, None,
        )
        self._flight_record(
            "fault", fatal=True, poll=self.polls,
            error=f"{type(exc).__name__}: {str(exc)[:300]}",
        )
        self._flight_flush()
        log_event(
            "stream_fatal", stream=self.stream_id, polls=self.polls,
            error=f"{type(exc).__name__}: {str(exc)[:300]}",
        )


class RollingStreamRunner(StreamRunner):
    """One stateless rolling-mean stream: the ``run_rolling_realtime``
    round loop (see that driver's docstring).  Each new input patch is
    rolled on ``device`` (default the CUDA card) and written by
    :func:`write_rolling_output`; the JAX package's mesh-batched path is
    not ported."""

    kind = "rolling"

    def __init__(self, spec: StreamSpec, output_folder: str, device=None):
        super().__init__(spec, output_folder)
        cfg = spec.config
        if cfg.kind != "rolling":
            raise ValueError(
                f"RollingStreamRunner needs kind='rolling', got {cfg.kind!r}"
            )
        check_ported(spec)
        self.device = resolve_device(device)
        self.window = cfg.window
        self.step_param = cfg.step
        self.scale = float(cfg.scale)
        self.distance = cfg.distance
        self.engine = cfg.engine
        os.makedirs(self.output_folder, exist_ok=True)
        _startup_audit(self.output_folder)
        self._init_flight(cfg)
        file_duration = (
            30.0 if cfg.file_duration is None else float(cfg.file_duration)
        )
        self.interval = (
            float(cfg.poll_interval)
            if cfg.poll_interval is not None
            else file_duration
        )
        policy = (
            cfg.fault_policy if cfg.fault_policy is not None
            else RetryPolicy()
        )
        ledger = (
            QuarantineLedger(self.output_folder) if cfg.quarantine else None
        )
        self.boundary = FaultBoundary(policy, ledger)
        self.detect, self.detect_operators = _detect_config(cfg)
        self.step_sec = _units.get_seconds(cfg.step)
        self.det_state = {"pipe": None}  # cross-round detect pipeline
        self.pyramid = _pyramid_config(cfg)
        self.pyr_state = {"store": None}  # cross-round open tile store
        self.initial_run = True
        # patches are identified by their time span, so a late file with
        # an earlier timestamp is still processed (a positional
        # high-water mark into the time-sorted spool would skip it)
        self.processed: set = set()

    def step(self) -> StepResult:
        self.polls += 1
        ph = self._round_phases = RoundPhases()
        try:
            with flight_capture(self.flight):
                fault_point("round.body", poll=self.polls)
                with ph.measure("poll"):
                    sp = self.boundary.begin_round(
                        make_spool(self.source).sort("time"), self.source
                    )
                    sub = (
                        sp.select(distance=self.distance)
                        if self.distance is not None else sp
                    )
                    keys = [
                        (np.datetime64(r["time_min"], "ns"),
                         np.datetime64(r["time_max"], "ns"))
                        for r in sub.contents()
                    ]
                    fresh = [j for j, k in enumerate(keys)
                             if k not in self.processed]
                if (
                    not self.initial_run
                    and not fresh
                    and self.boundary.consecutive == 0
                ):
                    log_event(
                        "stream_terminated", stream=self.stream_id,
                        rounds=self.rounds, polls=self.polls,
                    )
                    return StepResult("terminate")
                status = "empty"
                if fresh:
                    status = "processed"
                    self._process_round(sub, keys, fresh)
                self.boundary.on_success()
                if _resource.is_degraded():
                    _resource.probe_recovery(self.output_folder)
                self.initial_run = False
        except Exception as exc:
            self.det_state["pipe"] = None
            self.pyr_state["store"] = None
            decision = self.boundary.on_failure(exc)
            if decision.propagate:
                raise
            self._flight_record(
                "fault", poll=self.polls, fault_kind=decision.kind,
                attempt=self.boundary.consecutive,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            self._flight_flush()
            return StepResult(
                "retry", decision.delay, decision.kind,
                self.boundary.consecutive,
            )
        return StepResult(status, self.poll_delay())

    def _process_round(self, sub, keys, fresh) -> None:
        ph = self._round_phases
        if ph is None:
            ph = self._round_phases = RoundPhases()
        rnd = self.rounds + 1
        log_event("round_start", round=rnd, stream=self.stream_id)
        emitted = []  # in-memory capture (pyramid/detect)
        t0 = _time.perf_counter()
        write_s = 0.0
        # one patch at a time: each output is written as soon as it is
        # computed, so a retry resumes at the first unwritten patch
        for j in fresh:
            log_event("rolling_patch", index=j, stream=self.stream_id)
            out = sub[j].rolling(
                time=self.window, step=self.step_param,
                engine=self.engine, device=self.device,
            ).mean()
            out = out.new(data=np.asarray(out.data) * self.scale)
            fname = get_filename(out.attrs["time_min"], out.attrs["time_max"])
            t_w0 = _time.perf_counter()
            write_rolling_output(out, os.path.join(self.output_folder, fname))
            write_s += _time.perf_counter() - t_w0
            self.processed.add(keys[j])
            if self.pyramid or self.detect:
                emitted.append(out)
        # phase attribution: the loop is read + compute + write
        # interleaved; writes are timed at their site, the remainder is
        # host_wait (device_execute 0.0 until the device telemetry is
        # ported, as in the JAX runner)
        loop_s = _time.perf_counter() - t0
        ph.add("commit", write_s)
        ph.add("host_wait", max(loop_s - write_s, 0.0))
        pyramid_s = _run_pyramid(self, rnd, emitted, ph)
        detect_s = _run_detect(self, rnd, emitted, self.step_sec, ph)
        self.rounds = rnd
        log_event(
            "rolling_round", round=rnd, stream=self.stream_id,
            patches=len(fresh), wall_seconds=round(loop_s, 4),
            write_seconds=round(write_s, 4), pyramid_seconds=pyramid_s,
            detect_seconds=detect_s,
        )
        phases_rec = ph.finish()
        self._round_phases = None  # finished: never re-accumulated
        self._flight_record(
            "round", round=rnd, mode="rolling",
            patches=len(fresh), phases=phases_rec,
            devprof=_devprof_fields(),
        )
        self._flight_flush()


def build_runner(
    spec: StreamSpec,
    root=None,
    counters: Counters | None = None,
    on_round=None,
    device=None,
) -> StreamRunner:
    """The runner for ``spec`` (output folder created; a low-pass
    stream's carry is resolved on its first round); ``device`` defaults
    to the CUDA card."""
    folder = spec.resolve_output_folder(root if root is not None else ".")
    check_ported(spec)
    if spec.config.kind == "lowpass":
        return LowpassStreamRunner(
            spec, folder, counters=counters, on_round=on_round,
            device=device,
        )
    return RollingStreamRunner(spec, folder, device=device)


def drive(runner: StreamRunner, max_rounds=None, sleep_fn=_time.sleep):
    """The single-stream driver loop: step, honor the ``max_rounds``
    poll cap, sleep the advisory delay (the poll interval, or a retry's
    backoff) through ``sleep_fn``, flush on clean termination.  Returns
    the number of rounds that processed data.  An error that the fault
    boundary lets through propagates (after
    :meth:`StreamRunner.record_fatal`)."""
    try:
        while True:
            res = runner.step()
            if res.status == "terminate":
                break
            if max_rounds is not None and runner.polls >= max_rounds:
                break
            if res.status == "retry":
                with span(
                    "stream.retry", kind=res.kind, attempt=res.attempt
                ):
                    sleep_fn(res.delay)
            else:
                sleep_fn(res.delay)
    except Exception as exc:
        runner.record_fatal(exc)
        raise
    runner.finish()
    return runner.rounds
