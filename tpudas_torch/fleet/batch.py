"""Batched fleet execution: group-by-plan scheduling plus the
stacked-step rendezvous.

The port's counterpart of :mod:`tpudas.fleet.batch`.  A fleet that
services each stream's round on its own pays one launch sequence per
stream for every wave of work.  Every kernel of the stream step is
channel-column independent, so N same-plan streams' ``(T, C_i)``
blocks packed along the channel axis are ONE step whose per-stream
slices are byte-identical to solo execution.  Two pieces make that a
fleet feature:

:class:`BatchGroupFormer`
    Decides which due streams MAY be serviced together: a memoized
    per-stream *batch signature* (kind, cadence, engine request, filter
    geometry once the carry is open).  The signature is a grouping
    heuristic only: exact stackability (plan, block length, resolved
    engine, payload dtype, quantization scale) is enforced per dispatch
    by the executor's wave key, so a wrong group costs a solo launch,
    never a wrong byte.  Signatures are memoized per stream and
    invalidated when the runner is rebuilt or its carry's engine
    fields change.

:class:`BatchStepExecutor`
    The rendezvous.  The fleet services a batch group by running one
    ``runner.step()`` per member on its own thread.  When a member's
    round reaches a device step (:mod:`tpudas_torch.proc.stream` routes
    the cascade and FFT stream steps here via ``lfp._batch_executor``),
    it submits the block and waits; once every member still in the
    round has either submitted or left, the submissions are partitioned
    into waves by exact stack key, and each cascade wave of two or more
    runs as one stacked step
    (:func:`tpudas_torch.ops.fir.cascade_decimate_stream_stacked`, which
    launches B3 or the B1 chain once on the packed block).  A member
    with no co-shaped peer, and every FFT step (an FFT over the packed
    width is not promised the member's bits, see
    :func:`tpudas_torch.ops.filter.fft_pass_filter_stream_stacked`),
    runs its solo step, byte-identical to the unbatched path.  A member
    that finishes (or faults out of) its round ``leave()``s, shrinking
    the rendezvous, so a parked stream
    drops out of its group, not the fleet, with its carry sliced back
    out intact (the stacked step returns fresh per-stream tensors).

Every step of a wave runs on the dispatching member's thread, on that
thread's current CUDA stream: the stream path makes its blocks with a
synchronous copy on the same (default) stream, so the packing copy is
ordered after them, and each member's flush copies its output to the
host, which waits for the stacked step.  Each stacked step runs under
the device telemetry's ``wave_scope`` of its members (a launch counted
1/N to each, labelled stacked), each solo step under its own member's,
since the dispatching thread runs the steps of other members.  Each
member's wait for its peers, from its submission until its wave starts
to run, is one ``fleet.rendezvous`` span on its own thread (attrs
``stream``, ``members``): the price of stacking, since every member
waits for the slowest member's read and copy.
"""

from __future__ import annotations

import threading

from tpudas_torch.obs.devprof import wave_scope
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span

__all__ = ["BatchGroupFormer", "BatchStepExecutor"]


def _memo_count(result: str) -> None:
    get_registry().counter(
        "tpudas_fleet_batch_sig_memo_total",
        "batch-group signature lookups by memo outcome (hit = the "
        "scheduler reused a cached plan key)",
        labelnames=("result",),
    ).inc(result=result)


class BatchGroupFormer:
    """Memoized per-stream batch-group signatures.

    ``signature(stream_id, runner)`` returns a hashable grouping key,
    or ``None`` for a stream that must be serviced solo (non-lowpass,
    non-stateful, or mesh-sharded).  The memo is keyed on a cheap
    validity token, the runner's identity plus the carry fields an
    engine crossover mutates, so configuration and engine changes
    invalidate it and steady-state rounds never recompute it."""

    def __init__(self):
        self._memo: dict = {}

    def _token(self, runner) -> tuple:
        carry = getattr(runner, "carry", None)
        if carry is None:
            return (id(runner), None)
        return (
            id(runner),
            carry.kind,
            carry.engine_req,
            carry.d_ns,
            carry.ratio,
            carry.edge_in,
        )

    def signature(self, stream_id: str, runner):
        if runner is None or getattr(runner, "kind", None) != "lowpass":
            return None
        if not getattr(runner, "stateful", False):
            return None
        if getattr(runner, "mesh", None) is not None:
            return None
        token = self._token(runner)
        cached = self._memo.get(str(stream_id))
        if cached is not None and cached[0] == token:
            _memo_count("hit")
            return cached[1]
        _memo_count("miss")
        cfg = runner.spec.config
        sig = (
            "lowpass",
            float(runner.d_t),
            int(runner.buff_out),
            int(runner.process_patch_size),
            cfg.engine or "auto",
            cfg.filter_order,
            cfg.on_gap,
        )
        carry = getattr(runner, "carry", None)
        if carry is not None:
            # refine with the opened filter geometry: streams whose
            # carries resolved to different plans / engines stop
            # grouping (they could only ever dispatch solo anyway)
            sig = sig + (
                carry.kind,
                carry.d_ns,
                carry.ratio,
                carry.edge_in,
                carry.order,
                carry.engine_req,
            )
        self._memo[str(stream_id)] = (token, sig)
        return sig

    def invalidate(self, stream_id: str) -> None:
        self._memo.pop(str(stream_id), None)

    def clear(self) -> None:
        self._memo.clear()


class _Pending:
    __slots__ = ("key", "payload", "result", "error", "started", "done")

    def __init__(self, key, payload):
        self.key = key
        self.payload = payload
        self.result = None
        self.error = None
        self.started = False
        self.done = False


class BatchStepExecutor:
    """One batch group's device-step rendezvous (one per scheduled group
    service; see the module docstring for the protocol).

    Thread contract: the fleet creates the executor with the member
    ids, each member thread calls :meth:`bind` once, then the stream
    step's device dispatches arrive via :meth:`cascade_step` /
    :meth:`fft_step`; the member's thread calls :meth:`leave` in a
    ``finally`` when its round ends (normally or not), which is what
    guarantees liveness: every member either submits or leaves, so no
    waiter blocks forever."""

    def __init__(self, members):
        self._cv = threading.Condition()
        self._active = {str(m) for m in members}
        self._pending: dict = {}
        self._dispatching = False
        self._tls = threading.local()

    # -- membership ------------------------------------------------------
    def bind(self, member: str) -> None:
        self._tls.member = str(member)

    def leave(self, member: str | None = None) -> None:
        m = str(member) if member is not None else self._tls.member
        with self._cv:
            self._active.discard(m)
            self._cv.notify_all()

    # -- dispatch entry points (called from tpudas_torch.proc.stream) ---
    def cascade_step(self, block, carry, plan, engine, qscale=None):
        """Submit one cascade stream step; returns ``(y, new_carry)``
        exactly as ``cascade_decimate_stream`` would.  ``block`` is a
        tensor; ``engine`` is the RESOLVED literal the solo path chose
        at the member's own width, so stacking never flips an engine
        decision."""
        key = (
            "cascade", plan, int(block.shape[0]), str(engine),
            str(block.dtype), str(block.device),
            None if qscale is None else float(qscale),
        )
        return self._submit(key, (block, carry))

    def fft_step(self, block, carry, d_sec, high, order, qscale=None):
        """Submit one FFT overlap-save stream step; returns
        ``(filtered, new_carry)`` exactly as ``fft_pass_filter_stream``
        would."""
        key = (
            "fft", int(block.shape[0]), int(carry.shape[0]),
            float(d_sec), None if high is None else float(high),
            int(order), str(block.dtype), str(block.device),
            None if qscale is None else float(qscale),
        )
        return self._submit(key, (block, carry))

    # -- rendezvous core -------------------------------------------------
    def _ready(self) -> bool:
        return bool(self._active) and all(
            m in self._pending for m in self._active
        )

    def _submit(self, key, payload):
        me = self._tls.member
        p = _Pending(key, payload)
        dispatch_batch = None
        # the member's wait for its peers: from its submission until its
        # wave starts to run (the dispatching member's until _dispatch)
        with span("fleet.rendezvous", stream=me, members=len(self._active)):
            with self._cv:
                self._pending[me] = p
                self._cv.notify_all()
                while not (p.started or p.done):
                    if not self._dispatching and self._ready():
                        self._dispatching = True
                        dispatch_batch = self._pending
                        self._pending = {}
                        break
                    # the timeout is a lost-wakeup safety net only;
                    # every state change notifies
                    self._cv.wait(0.1)
        if dispatch_batch is not None:
            try:
                self._dispatch(dispatch_batch)
            finally:
                with self._cv:
                    self._dispatching = False
                    self._cv.notify_all()
        else:
            with self._cv:
                while not p.done:
                    self._cv.wait(0.1)
        if p.error is not None:
            raise p.error
        return p.result

    def _start(self, pend) -> None:
        """Mark a wave's members as running, ending their rendezvous."""
        with self._cv:
            for p in pend:
                p.started = True
            self._cv.notify_all()

    def _dispatch(self, batch: dict) -> None:
        """Partition the snapshot into exact-key waves and run each: a
        cascade wave of two or more members as one stacked step, every
        other member step solo.  Members are packed in sorted
        stream-id order, so a fleet's packing is deterministic."""
        reg = get_registry()
        waves: dict = {}
        for m in sorted(batch):
            waves.setdefault(batch[m].key, []).append(m)
        for key, members in waves.items():
            pend = [batch[m] for m in members]
            if len(pend) >= 2 and key[0] == "cascade":
                reg.counter(
                    "tpudas_fleet_batch_stacked_launches_total",
                    "stacked device steps dispatched (>= 2 streams "
                    "in one launch)",
                ).inc()
                reg.counter(
                    "tpudas_fleet_batch_stacked_members_total",
                    "stream steps served by a stacked launch",
                ).inc(len(pend))
                self._start(pend)
                # the wave's launches run on this one thread: the
                # member list, not its stream scope, is the truth
                with wave_scope(members):
                    _settle(pend, lambda: self._run_stacked(key, pend))
                continue
            for m, p in zip(members, pend):
                reg.counter(
                    "tpudas_fleet_batch_solo_launches_total",
                    "stream steps the batch executor ran alone (no "
                    "co-shaped peer in the rendezvous, or an FFT step)",
                ).inc()
                self._start([p])
                with wave_scope([m]):
                    _settle([p], lambda p=p: [self._run_solo(key, p)])

    def _run_stacked(self, key, pend):
        from tpudas_torch.ops.fir import cascade_decimate_stream_stacked

        _kind, plan, t, engine, _dt, _dev, qscale = key
        with span("op.stacked", rows=t, streams=len(pend), engine=engine):
            return cascade_decimate_stream_stacked(
                [p.payload[0] for p in pend], [p.payload[1] for p in pend],
                plan, engine, qscale=qscale,
            )

    def _run_solo(self, key, p):
        block, carry = p.payload
        if key[0] == "cascade":
            from tpudas_torch.ops.fir import cascade_decimate_stream

            _kind, plan, _t, engine, _dt, _dev, qscale = key
            return cascade_decimate_stream(
                block, carry, plan, engine, qscale=qscale
            )
        from tpudas_torch.ops.filter import fft_pass_filter_stream

        _kind, _t, _rc, d_sec, high, order, _dt, _dev, qscale = key
        return fft_pass_filter_stream(
            block, carry, d_sec, high=high, order=order, qscale=qscale
        )


def _settle(pend, run) -> None:
    """Run one dispatch and hand its results (or its error) to the
    waiting members."""
    try:
        results = run()
    except BaseException as exc:
        for p in pend:
            p.error = exc
            p.done = True
        return
    for p, res in zip(pend, results):
        p.result = res
        p.done = True
