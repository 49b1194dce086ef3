"""The multi-array round engine: N concurrent streams, one process.

The port's counterpart of :mod:`tpudas.fleet.fleet`.  Real DAS sites
run several interrogators; :class:`FleetEngine` schedules N
:class:`tpudas_torch.fleet.config.StreamSpec` round loops
(:mod:`tpudas_torch.fleet.engine` runners) in one process, so they
share the card, the built kernel libraries and one metrics registry
instead of paying N cold processes.  Each stream keeps its OWN durable
state under ``root/<stream_id>/`` (carry, quarantine ledger, outputs),
written by exactly the runner code the single-stream driver uses, so a
fleet member's folder is byte-identical to the same stream run alone.

**Scheduling: deficit round-robin over due streams.**  The engine keeps
a virtual clock (seconds; ``sleep_fn`` is called with the wait and the
clock then advances by it).  A stream is *due* when its jittered poll
interval (or retry backoff) has elapsed.  Each scheduling pass grants
every due stream a ``quantum`` of deficit; the stream with the largest
deficit runs ONE :meth:`step`, and the wall seconds it took are charged
back against its deficit.  A slow spool therefore goes negative and the
other due streams are served first until it earns its turn back.
Deficit is capped at ``deficit_cap`` so an idle stream cannot hoard a
burst.

**Fault isolation.**  A stream's transient, corrupt and resource
failures are retried by its own fault boundary.  A FATAL failure
(configuration error, exhausted retries) **parks** that stream (error
in the run summary, ``tpudas_fleet_streams_parked`` raised) and the
fleet serves the others.  ``KeyboardInterrupt``/``SystemExit`` are not
faults: they kill the whole fleet, the process-crash model the
crash-only carry resumes from.

**Jitter.**  Streams default to ``default_poll_jitter`` (a fraction of
the poll interval, stretched by a per-stream LCG seeded by the stream
id) so co-located streams do not scan their spools in lockstep; a
spec's explicit ``poll_jitter`` (or ``TPUDAS_POLL_JITTER``) wins.

**Batched scheduling.**  With ``batched=True`` (or
``TPUDAS_FLEET_BATCHED=1``) due streams whose memoized batch signature
matches (:class:`tpudas_torch.fleet.batch.BatchGroupFormer`) are
serviced as ONE group: one thread per member runs its ordinary
``step()``, and the members' device steps rendezvous in a
:class:`tpudas_torch.fleet.batch.BatchStepExecutor` that runs co-shaped
blocks as one step on the channel-packed block (B3 or the B1 chain,
launched once; outputs and carries byte-identical to solo execution).
A member that faults mid-round drops out of its group, not the fleet,
and parks as in solo scheduling.

**Health and flight.**  A parked stream's terminal ``health.json``
carries a ``fleet`` sub-object (``event``, ``parked_at``,
``unparked_at``, ``unparks``, ``error``) and an unparked one's the
``unparked`` event, as in the JAX fleet.  Each member's step records its
spans into its own stream's flight ring: the capture is thread-local, so
in batched service every member thread writes only its own ring.

Not ported: the JAX package's persistent compile cache
(``utils/compile_cache``) has no counterpart, because the nvcc-built
kernel libraries are already shared by every stream of the process.
Rolling streams, joint low-pass streams and mesh-sharded streams are
always serviced solo.
"""

from __future__ import annotations

import collections as _collections
import os
import threading
import time as _time
from dataclasses import replace

from tpudas_torch.device import resolve_device
from tpudas_torch.fleet.batch import BatchGroupFormer, BatchStepExecutor
from tpudas_torch.fleet.config import StreamSpec
from tpudas_torch.fleet.engine import StreamRunner, build_runner
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.logging import log_event
from tpudas_torch.utils.profiling import Counters

__all__ = ["DEFAULT_POLL_JITTER", "FleetEngine", "run_fleet"]

# fleet default: up to +10% per-stream interval stretch, enough to
# spread N spool scans without distorting the cadence an operator set
DEFAULT_POLL_JITTER = 0.1

_QUANTUM_SEC = 0.25  # deficit granted per scheduling pass while due
_DEFICIT_CAP_SEC = 2.0  # max service burst an idle stream can bank
_SERVICE_LOG_MAX = 4096  # service_log entries kept (newest win)


class _FleetStream:
    """Per-stream scheduler state around one runner."""

    __slots__ = (
        "spec", "runner", "status", "error", "next_due", "deficit",
        "steps", "wall_seconds", "probe_due", "probe_interval",
        "probes", "unparks", "parked_at", "unparked_at",
    )

    def __init__(self, spec: StreamSpec, runner: StreamRunner | None):
        self.spec = spec
        self.runner = runner  # None when construction itself failed
        self.status = "active"  # active|terminated|max_rounds|parked
        self.error = None
        self.next_due = 0.0  # virtual seconds; 0 = poll immediately
        self.deficit = 0.0
        self.steps = 0
        self.wall_seconds = 0.0
        # unpark probe state: a parked stream may re-probe on a slow
        # doubling schedule (the quarantine probe's policy)
        self.probe_due = None  # virtual seconds; None = no probe
        self.probe_interval = None
        self.probes = 0
        self.unparks = 0
        self.parked_at = None  # wall-clock park/unpark times
        self.unparked_at = None

    @property
    def stream_id(self) -> str:
        return str(self.spec.stream_id)


class FleetEngine:
    """Schedule N stream round loops in one process.

    Parameters
    ----------
    root:
        The fleet root; stream ``s`` writes under ``root/s`` unless its
        spec names an explicit ``output_folder``.
    specs:
        The :class:`StreamSpec` members.  ``stream_id`` must be unique.
    max_rounds:
        Per-stream poll cap (a stream stops after that many polls,
        clean-flushed).
    sleep_fn:
        Called with the seconds until the next stream is due when none
        is due now; the virtual clock then advances by that wait.
    quantum / deficit_cap:
        Deficit round-robin tuning (seconds of service).
    default_poll_jitter:
        Jitter fraction applied to specs that do not set their own.
    on_round:
        Optional ``on_round(stream_id, round, lfp)`` callback.
    unpark_probe:
        Seconds until a PARKED stream's first re-probe (None, the
        default, keeps parking terminal).  When set, a parked stream
        is re-probed on a doubling-interval schedule: the probe
        rebuilds the runner from disk, so a stream parked on a
        transient-looking fatal rejoins where it left off; after
        ``unpark_max_probes`` failed probes the park is terminal.
        Unparks are counted (``tpudas_fleet_unparked_total``).
    batched:
        Group-by-plan batched scheduling: due streams with a matching
        batch signature are serviced together and their device steps
        stacked into one launch.  ``None`` (default) reads
        ``TPUDAS_FLEET_BATCHED`` (off unless ``1``).  Outputs and
        carries are byte-identical to unbatched scheduling; the service
        ORDER within a round differs (group members run concurrently).
    device:
        Where every stream filters (default the CUDA card; ``"cpu"``
        runs the plain PyTorch versions).
    """

    def __init__(
        self,
        root,
        specs,
        max_rounds=None,
        sleep_fn=_time.sleep,
        quantum: float = _QUANTUM_SEC,
        deficit_cap: float = _DEFICIT_CAP_SEC,
        default_poll_jitter: float = DEFAULT_POLL_JITTER,
        on_round=None,
        unpark_probe: float | None = None,
        unpark_max_probes: int = 6,
        batched: bool | None = None,
        device=None,
    ):
        specs = list(specs)
        if not specs:
            raise ValueError("FleetEngine needs at least one StreamSpec")
        ids = [str(s.stream_id) for s in specs]
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"duplicate stream_id(s): {dupes}")
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_rounds = max_rounds
        self.sleep_fn = sleep_fn
        self.quantum = float(quantum)
        self.deficit_cap = float(deficit_cap)
        self.unpark_probe = (
            None if unpark_probe is None else float(unpark_probe)
        )
        self.unpark_max_probes = int(unpark_max_probes)
        if batched is None:
            batched = os.environ.get("TPUDAS_FLEET_BATCHED", "0") == "1"
        self.batched = bool(batched)
        # one device for every stream; no card and no device raises here
        self.device = resolve_device(device)
        self._former = BatchGroupFormer()
        self._on_round = on_round
        self.now = 0.0  # virtual seconds since run start
        self.sched_seconds = 0.0  # wall spent in scheduler bookkeeping
        # (stream_id, status, wall) per step, bounded so a months-long
        # fleet run cannot grow it without limit
        self.service_log = _collections.deque(maxlen=_SERVICE_LOG_MAX)
        reg = get_registry()
        self.streams: dict = {}
        for spec in specs:
            # precedence: spec's explicit poll_jitter > TPUDAS_POLL_JITTER
            # (resolved inside the runner) > the fleet default
            if (
                spec.config.poll_jitter is None
                and not os.environ.get("TPUDAS_POLL_JITTER", "")
            ):
                spec = replace(
                    spec,
                    config=replace(
                        spec.config, poll_jitter=default_poll_jitter
                    ),
                )
            # runner construction (folder creation, config coercion)
            # gets the same per-stream fault boundary as step(): a
            # stream that cannot build is PARKED, the fleet still
            # serves the others
            try:
                runner = self._build_runner(spec)
            except Exception as exc:
                s = _FleetStream(spec, None)
                self.streams[s.stream_id] = s
                self._park(s, exc)
                continue
            self.streams[str(spec.stream_id)] = _FleetStream(spec, runner)
        reg.gauge(
            "tpudas_fleet_streams",
            "streams configured in the fleet engine",
        ).set(len(self.streams))
        self._state_gauges()

    def _build_runner(self, spec: StreamSpec) -> StreamRunner:
        on_round = self._on_round
        return build_runner(
            spec,
            root=self.root,
            counters=Counters(),
            on_round=(
                None if on_round is None else (
                    lambda rnd, lfp, _sid=str(spec.stream_id): (
                        on_round(_sid, rnd, lfp)
                    )
                )
            ),
            device=self.device,
        )

    # -- scheduling ------------------------------------------------------
    def _state_gauges(self) -> None:
        reg = get_registry()
        states = [s.status for s in self.streams.values()]
        reg.gauge(
            "tpudas_fleet_streams_active",
            "fleet streams still polling",
        ).set(sum(1 for s in states if s == "active"))
        reg.gauge(
            "tpudas_fleet_streams_parked",
            "fleet streams parked after a fatal per-stream failure",
        ).set(sum(1 for s in states if s == "parked"))

    def _active(self):
        return [s for s in self.streams.values() if s.status == "active"]

    def _pick(self, due):
        """Deficit round-robin: grant every due stream a quantum, then
        serve the one owed the most (ties: earliest due, then spec
        order; both deterministic)."""
        for s in due:
            s.deficit = min(s.deficit + self.quantum, self.deficit_cap)
        return max(due, key=lambda s: (s.deficit, -s.next_due))

    def _finish_stream(self, s: _FleetStream, status: str) -> None:
        s.runner.finish()
        s.status = status
        log_event(
            "fleet_stream_done",
            stream=s.stream_id,
            status=status,
            rounds=s.runner.rounds,
            polls=s.runner.polls,
        )
        self._state_gauges()

    def _park(self, s: _FleetStream, exc: BaseException) -> None:
        self._former.invalidate(s.stream_id)
        s.status = "parked"
        s.error = f"{type(exc).__name__}: {str(exc)[:300]}"
        s.parked_at = _time.time()
        # schedule the unpark re-probe (doubling interval, bounded
        # attempts)
        if self.unpark_probe is not None and (
            s.probes < self.unpark_max_probes
        ):
            s.probe_interval = (
                self.unpark_probe if s.probe_interval is None
                else s.probe_interval * 2.0
            )
            s.probe_due = self.now + s.probe_interval
        else:
            s.probe_due = None
        if s.runner is not None:
            health = getattr(s.runner, "edge_health", None)
            if health is not None:
                # the park event in the stream's terminal health.json
                health.extra["fleet"] = {
                    "event": "parked",
                    "parked_at": s.parked_at,
                    "unparked_at": s.unparked_at,
                    "unparks": s.unparks,
                    "error": s.error,
                }
            try:
                s.runner.record_fatal(exc)
            except Exception as exc2:
                log_event(
                    "fleet_record_fatal_failed",
                    stream=s.stream_id,
                    error=f"{type(exc2).__name__}: {str(exc2)[:200]}",
                )
        get_registry().counter(
            "tpudas_fleet_parked_total",
            "streams parked by a fatal per-stream failure (the fleet "
            "keeps serving the others)",
        ).inc()
        log_event(
            "fleet_stream_parked", stream=s.stream_id, error=s.error
        )
        self._state_gauges()

    def _try_unpark(self, s: _FleetStream) -> bool:
        """One unpark probe: rebuild the runner from disk (crash-only
        resume: the carry and ledger say where to continue).  A failed
        rebuild doubles the probe interval; success puts the stream
        back in the rotation at once."""
        s.probes += 1
        try:
            runner = self._build_runner(s.spec)
        except Exception as exc:
            s.error = f"{type(exc).__name__}: {str(exc)[:300]}"
            if s.probes >= self.unpark_max_probes:
                s.probe_due = None  # terminal: probes exhausted
            else:
                s.probe_interval *= 2.0
                s.probe_due = self.now + s.probe_interval
            log_event(
                "fleet_unpark_probe_failed",
                stream=s.stream_id,
                probe=s.probes,
                error=s.error,
            )
            return False
        s.runner = runner
        self._former.invalidate(s.stream_id)
        s.status = "active"
        s.error = None
        s.next_due = self.now
        s.deficit = 0.0
        s.probe_due = None
        s.unparks += 1
        s.unparked_at = _time.time()
        health = getattr(runner, "edge_health", None)
        if health is not None:
            health.extra["fleet"] = {
                "event": "unparked",
                "parked_at": s.parked_at,
                "unparked_at": s.unparked_at,
                "unparks": s.unparks,
                "probes": s.probes,
            }
        get_registry().counter(
            "tpudas_fleet_unparked_total",
            "parked streams that rejoined the fleet via the unpark "
            "re-probe",
        ).inc()
        log_event(
            "fleet_stream_unparked", stream=s.stream_id, probe=s.probes
        )
        self._state_gauges()
        return True

    def _account_step(self, s, res, wall: float, reg) -> None:
        """Post-step bookkeeping shared by solo and batched service:
        step counters, service log, terminate/max_rounds transitions,
        next-due scheduling.  The caller has already charged ``wall``
        against the stream's deficit."""
        s.steps += 1
        s.wall_seconds += wall
        self.service_log.append((s.stream_id, res.status, wall))
        reg.counter(
            "tpudas_fleet_steps_total",
            "runner steps executed by the fleet scheduler",
            labelnames=("stream", "status"),
        ).inc(stream=s.stream_id, status=res.status)
        reg.histogram(
            "tpudas_fleet_step_seconds",
            "wall seconds of one scheduled runner step",
            labelnames=("stream",),
        ).observe(wall, stream=s.stream_id)
        if res.status == "terminate":
            self._finish_stream(s, "terminated")
        elif (
            self.max_rounds is not None
            and s.runner.polls >= self.max_rounds
        ):
            self._finish_stream(s, "max_rounds")
        else:
            s.next_due = self.now + res.delay

    def _batch_group(self, s, due):
        """The batch group for the picked stream: every due stream whose
        memoized signature matches.  ``None`` when the stream must run
        solo (no signature, or no due peer shares it)."""
        sig = self._former.signature(s.stream_id, s.runner)
        if sig is None:
            return None
        group = [
            o for o in due
            if o is s
            or self._former.signature(o.stream_id, o.runner) == sig
        ]
        return group if len(group) >= 2 else None

    def _service_group(self, group, reg) -> None:
        """Service one batch group: one thread per member runs its
        ordinary ``step()`` with the shared
        :class:`~tpudas_torch.fleet.batch.BatchStepExecutor` installed,
        so co-shaped device steps stack into one launch.  Each member's
        wall (rendezvous waits included) is charged to its own deficit;
        park/terminate handling per member is that of solo service.
        ``KeyboardInterrupt``/``SystemExit`` from a member are re-raised
        after the group joins (the whole-fleet crash model; the other
        members' completed rounds are already durable)."""
        ex = BatchStepExecutor([s.stream_id for s in group])
        outcomes: dict = {}

        def _run(s):
            ex.bind(s.stream_id)
            s.runner._batch_executor = ex
            t0 = _time.perf_counter()
            try:
                with span("fleet.step", stream=s.stream_id):
                    res = s.runner.step()
                outcomes[s.stream_id] = (
                    "ok", res, _time.perf_counter() - t0
                )
            except BaseException as exc:
                outcomes[s.stream_id] = (
                    "raise", exc, _time.perf_counter() - t0
                )
            finally:
                s.runner._batch_executor = None
                ex.leave(s.stream_id)

        with span("fleet.batch", streams=len(group)):
            threads = [
                threading.Thread(
                    target=_run, args=(s,),
                    name=f"fleet-batch-{s.stream_id}", daemon=True,
                )
                for s in group
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        reg.counter(
            "tpudas_fleet_batch_groups_total",
            "batch groups serviced by the group-by-plan scheduler",
        ).inc()
        reg.counter(
            "tpudas_fleet_batch_members_total",
            "stream steps serviced inside a batch group",
        ).inc(len(group))
        fatal = None
        for s in group:
            kind, val, wall = outcomes[s.stream_id]
            s.deficit -= wall
            if kind == "raise":
                s.wall_seconds += wall
                self.service_log.append((s.stream_id, "fatal", wall))
                if isinstance(val, Exception):
                    # a faulted member drops out of its batch group, not
                    # the fleet; its carry was sliced back out by the
                    # last completed step
                    self._park(s, val)
                elif fatal is None:
                    fatal = val
                continue
            self._account_step(s, val, wall, reg)
        if fatal is not None:
            raise fatal

    def run(self) -> dict:
        """Serve every stream until it terminates (spool stopped
        growing), hits the ``max_rounds`` poll cap, or parks on a fatal
        failure.  Returns the run summary (per-stream status, rounds,
        polls, realtime factor, head lag, error)."""
        reg = get_registry()
        t_run0 = _time.perf_counter()
        with span("fleet.run", streams=len(self.streams)):
            while True:
                t_sched = _time.perf_counter()
                active = self._active()
                probing = (
                    [
                        s for s in self.streams.values()
                        if s.status == "parked" and s.probe_due is not None
                    ]
                    if self.unpark_probe is not None else []
                )
                if not active and not probing:
                    self.sched_seconds += _time.perf_counter() - t_sched
                    break
                probe_due = [s for s in probing if s.probe_due <= self.now]
                if probe_due:
                    # probes are cheap and rare: serve them before the
                    # deficit rotation (an unparked stream then joins
                    # the due set on this same pass)
                    self.sched_seconds += _time.perf_counter() - t_sched
                    for s in probe_due:
                        self._try_unpark(s)
                    continue
                due = [s for s in active if s.next_due <= self.now]
                if not due:
                    wait = min(
                        [s.next_due for s in active]
                        + [s.probe_due for s in probing]
                    ) - self.now
                    self.sched_seconds += _time.perf_counter() - t_sched
                    self.sleep_fn(max(wait, 0.0))
                    self.now += max(wait, 0.0)
                    continue
                s = self._pick(due)
                group = (
                    self._batch_group(s, due) if self.batched else None
                )
                self.sched_seconds += _time.perf_counter() - t_sched
                if group is not None:
                    self._service_group(group, reg)
                    continue
                t0 = _time.perf_counter()
                try:
                    with span("fleet.step", stream=s.stream_id):
                        res = s.runner.step()
                except Exception as exc:
                    wall = _time.perf_counter() - t0
                    s.deficit -= wall
                    s.wall_seconds += wall
                    self.service_log.append(
                        (s.stream_id, "fatal", wall)
                    )
                    self._park(s, exc)
                    continue
                wall = _time.perf_counter() - t0
                s.deficit -= wall
                self._account_step(s, res, wall, reg)
        wall_total = _time.perf_counter() - t_run0
        reg.counter(
            "tpudas_fleet_sched_seconds_total",
            "wall seconds spent in fleet scheduler bookkeeping "
            "(due-set scan, deficit round-robin pick)",
        ).inc(self.sched_seconds)
        return self.summary(wall_total)

    def summary(self, wall_seconds: float | None = None) -> dict:
        streams = {}
        for sid, s in self.streams.items():
            r = s.runner  # None when the stream parked at build time
            streams[sid] = {
                "status": s.status,
                "rounds": 0 if r is None else r.rounds,
                "polls": 0 if r is None else r.polls,
                "steps": s.steps,
                "wall_seconds": round(s.wall_seconds, 4),
                "realtime_factor": round(
                    getattr(
                        getattr(r, "counters", None),
                        "realtime_factor", 0.0,
                    ),
                    3,
                ),
                "head_lag_seconds": getattr(r, "head_lag", None),
                "unparks": s.unparks,
                "parked_at": s.parked_at,
                "unparked_at": s.unparked_at,
                "error": s.error,
            }
        return {
            "streams": streams,
            "rounds_total": sum(
                s.runner.rounds
                for s in self.streams.values()
                if s.runner is not None
            ),
            "parked": sorted(
                sid for sid, s in self.streams.items()
                if s.status == "parked"
            ),
            "unparked_total": sum(
                s.unparks for s in self.streams.values()
            ),
            "sched_seconds": round(self.sched_seconds, 4),
            "wall_seconds": (
                None if wall_seconds is None else round(wall_seconds, 4)
            ),
        }


def run_fleet(root, specs, **kwargs) -> dict:
    """Build a :class:`FleetEngine` over ``specs`` and run it to
    completion; returns the run summary."""
    return FleetEngine(root, specs, **kwargs).run()
