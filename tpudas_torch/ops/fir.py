"""Multistage polyphase FIR decimation — the fast path of the engine.

The port's counterpart of the batch half of :mod:`tpudas.ops.fir`.  The
reference's hot loop filters the FULL-rate stream with a zero-phase
IIR and then throws away ~99.9% of the samples at the interpolation
step (reference lf_das.py:223-225).  This module exploits the
decimating structure instead: a cascade of small linear-phase FIR
stages, each decimating by an integer factor, designed so the
*composite* magnitude response matches the reference's zero-phase
Butterworth-squared response ``1/(1+(f/fc)^(2*order))`` on the retained
band.

Design scheme (numpy/scipy, copied verbatim from the JAX package so the
taps are bit-equal)
-------------------------------------------------------------------------
- ``factor_ratio`` splits the decimation ratio into integer stages
  (large factors first, so the full-rate stage is the cheapest).
- every stage except the last is a plain anti-alias guard: a
  Kaiser-windowed low-pass whose stopband starts where energy would
  fold back into the final retained band.
- the last stage is *response-matched*: a zero-phase frequency-sampled
  FIR of the desired composite response divided by the measured
  response of the guard stages.
- all stages have odd length, so the composite group delay is an
  integer number of full-rate samples (``CascadePlan.delay``); the
  caller re-indexes outputs by that delay, which makes the cascade
  zero-phase exactly like the reference's forward-backward filter.

Application (PyTorch)
---------------------
:func:`cascade_decimate` runs the stages on a (T, C) tensor.  Engine
literals: ``"auto"`` (the hand-written CUDA kernel on a CUDA tensor,
the plain PyTorch stage on a CPU tensor), ``"cuda"`` (the kernel;
raises on a CPU tensor) and ``"torch"`` (the plain stage, only when
asked for explicitly).  On the card every stage runs the kernel: the
TPU-geometry routing of the JAX package (``_pallas_stage_ok`` and the
grid-quantum sizing of ``stage_input_rows``) has no counterpart here,
so each stage consumes ``(k + B) * R`` rows — the JAX layout's
``"xla"`` rows.

Streaming (:func:`cascade_decimate_stream`) carries each stage's
trailing input rows from block to block, so every full-rate sample is
read and filtered once.  Its engines mirror the JAX package's
``auto | pallas | xla | fused | fused-pallas | fused-xla`` as
``auto | cuda | torch | fused | fused-cuda | fused-torch``: the
per-stage chain (every stage on the strided-FIR kernel on the card),
or the whole cascade as one fused kernel (``csrc/fused_cascade.cu``).
Both share one carry layout, so a stream may switch engines at any
block.  :func:`cascade_decimate_stream_stacked` runs one resolved engine
once over several streams' blocks packed along channels (the batched
fleet's stacked launch), each member's bytes equal to its solo step.
Both stream steps report each step to the device telemetry
(:mod:`tpudas_torch.obs.devprof`), with the work a step must do counted
by :func:`stream_step_cost`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpudas_torch.device import resolve_device
from tpudas_torch.obs import devprof
from tpudas_torch.obs.trace import span

__all__ = [
    "CascadePlan",
    "factor_ratio",
    "design_cascade",
    "plan_from_arrays",
    "cascade_decimate",
    "cascade_input_need",
    "chain_layout",
    "stage_engines",
    "resolve_cascade_engine",
    "shift_to_phase",
    "impulse_response",
    "edge_support_samples",
    "butter2_mag",
    "BATCH_ENGINES",
    "STREAM_ENGINES",
    "stream_carry_sizes",
    "stream_warmup_outputs",
    "cascade_stream_init",
    "fused_min_elems",
    "fused_chunk_outputs",
    "fused_intermediate_bytes",
    "resolve_stream_engine",
    "stream_stage_engines",
    "cascade_decimate_stream",
    "STACKED_ENGINES",
    "cascade_decimate_stream_stacked",
    "stages_step_cost",
    "stream_step_cost",
]

# engine literals the batch entry point (cascade_decimate) accepts
BATCH_ENGINES = ("auto", "cuda", "torch")
# engine literals the stream entry point (cascade_decimate_stream)
# accepts: the per-stage chain, and the whole cascade as one fused
# step.  "fused" resolves by device and the block-size threshold
# (resolve_stream_engine); "fused-cuda"/"fused-torch" force a variant.
STREAM_ENGINES = ("auto", "cuda", "torch", "fused", "fused-cuda",
                  "fused-torch")
# engine literals the stacked multi-stream step
# (cascade_decimate_stream_stacked) accepts: resolved literals only, each
# decided at the member's own width before packing, so the packed width
# can never flip a block across fused_min_elems.  Unlike the JAX
# package, which keeps its Pallas rounds solo (its stacked program is
# XLA, another arithmetic path), the port stacks its CUDA engines: the
# same kernel runs solo and stacked, and B1 and B3 compute each channel
# on its own (a sum per tap phase, then per frame, whatever the stripe
# or the copy width), so a member's bytes do not depend on its packing.
STACKED_ENGINES = ("cuda", "fused-cuda", "torch", "fused-torch")


def butter2_mag(f, corner, order):
    """The reference's zero-phase magnitude: ``|H_butter|^2`` of an
    ``order``-pole Butterworth low-pass (sosfiltfilt applies the filter
    twice, squaring the magnitude — tpudas.ops.filter matches this)."""
    f = np.asarray(f, np.float64)
    return 1.0 / (1.0 + (f / float(corner)) ** (2 * int(order)))


def factor_ratio(ratio: int) -> list[int]:
    """Split an integer decimation ratio into stage factors in [2, 8],
    largest first. Raises if a prime factor > 8 remains."""
    ratio = int(ratio)
    if ratio < 1:
        raise ValueError(f"decimation ratio must be >= 1, got {ratio}")
    factors = []
    rem = ratio
    while rem > 1:
        for f in (8, 7, 6, 5, 4, 3, 2):
            if rem % f == 0:
                factors.append(f)
                rem //= f
                break
        else:
            raise ValueError(
                f"ratio {ratio} has a prime factor > 8; "
                "use the FFT engine for this ratio"
            )
    factors.sort(reverse=True)
    return factors


@dataclass(frozen=True, eq=False)
class CascadePlan:
    """A compiled multistage decimation filter.

    stages: tuple of (R, taps) — taps are float32, odd length.
    ratio:  product of all R.
    delay:  composite group delay in FULL-RATE samples (integer,
            because every stage is odd-length linear-phase);
            causal cascade output ``k`` is the zero-phase filtered
            input at full-rate index ``k*ratio + delay``.
    fs_in / corner / order: the design point.

    Hash/eq are by tap content so plans can key jit caches.
    """

    stages: tuple
    ratio: int
    delay: int
    fs_in: float
    corner: float
    order: int

    @property
    def receptive_field(self) -> int:
        """Total taps footprint in full-rate samples (= 2*delay + 1)."""
        return 2 * self.delay + 1

    def _fingerprint(self):
        return (
            self.ratio,
            self.delay,
            tuple(
                (int(R), np.asarray(h).tobytes()) for R, h in self.stages
            ),
        )

    def __hash__(self):
        return hash(self._fingerprint())

    def __eq__(self, other):
        return (
            isinstance(other, CascadePlan)
            and self._fingerprint() == other._fingerprint()
        )


def _guard_stage_taps(fs_in: float, R: int, f_keep: float) -> np.ndarray:
    """Anti-alias guard: keep [0, f_keep] intact, attenuate everything
    that decimation by R would fold back onto [0, f_keep]."""
    from scipy.signal import firwin, kaiserord

    fs_out = fs_in / R
    stop = fs_out - f_keep  # first fold-back edge
    pass_edge = f_keep
    width = max(stop - pass_edge, 0.05 * fs_in / R)
    numtaps, beta = kaiserord(80.0, width / (0.5 * fs_in))
    numtaps = max(numtaps, 9)
    if numtaps % 2 == 0:
        numtaps += 1
    cutoff = 0.5 * (pass_edge + stop)
    return firwin(
        numtaps, cutoff, window=("kaiser", beta), fs=fs_in
    ).astype(np.float32)


def _stage_response(taps: np.ndarray, fs: float, freqs: np.ndarray):
    """Real-valued magnitude response of a symmetric (linear-phase) FIR
    at ``freqs`` Hz (phase removed analytically)."""
    n = np.arange(len(taps), dtype=np.float64) - (len(taps) - 1) / 2.0
    ang = 2.0 * np.pi * np.asarray(freqs, np.float64)[:, None] * n[None, :] / fs
    return (np.cos(ang) @ np.asarray(taps, np.float64)).astype(np.float64)


def _matched_last_stage(
    fs_l: float,
    corner: float,
    order: int,
    guard_resp,
    taps: int | None,
) -> np.ndarray:
    """Frequency-sampled zero-phase FIR matching
    ``butter2_mag / guard_resp`` on [0, fs_l/2]."""
    nfft = 16384
    freqs = np.arange(nfft // 2 + 1, dtype=np.float64) * fs_l / nfft
    desired = butter2_mag(freqs, corner, order)
    g = np.clip(guard_resp(freqs), 1e-3, None)
    d = np.where(desired > 1e-8, desired / g, 0.0)
    h_full = np.fft.irfft(d, n=nfft)  # symmetric around index 0
    h_c = np.concatenate([h_full[nfft // 2 :], h_full[: nfft // 2]])
    center = nfft // 2
    if taps is None:
        mag = np.abs(h_c)
        thresh = mag.max() * 1e-6
        above = np.nonzero(mag > thresh)[0]
        half = int(
            max(center - above[0], above[-1] - center, 4)
        )
        taps = min(2 * half + 1, 4095)
    if taps % 2 == 0:
        taps += 1
    half = taps // 2
    h = h_c[center - half : center + half + 1].copy()
    # no taper: the target response is smooth, so the frequency-sampled
    # impulse response decays below 1e-6 before truncation and plain
    # truncation keeps the band error ~1e-6 (a Kaiser taper would bias
    # the passband by ~1e-2). Renormalize DC to the exact target gain.
    dc_target = d[0]
    s = h.sum()
    if s != 0:
        h *= dc_target / s
    return h.astype(np.float32)


@functools.lru_cache(maxsize=64)
def design_cascade(
    fs_in: float,
    ratio: int,
    corner: float,
    order: int = 4,
    last_taps: int | None = None,
) -> CascadePlan:
    """Design the multistage decimator for ``fs_in -> fs_in/ratio`` with
    composite response ``butter2_mag(f, corner, order)``.

    The retained band is [0, 0.5*fs_in/ratio] (the output Nyquist);
    guard stages protect it from aliasing at >= 80 dB, and the last
    stage shapes the composite response to the Butterworth-squared
    target of the reference engine (lf_das.py:223).
    """
    factors = factor_ratio(ratio)
    f_out = fs_in / ratio
    f_keep = 0.5 * f_out
    stages = []
    fs = fs_in
    guard_list = []
    if len(factors) > 1:
        for R in factors[:-1]:
            h = _guard_stage_taps(fs, R, f_keep)
            stages.append((R, h))
            guard_list.append((h, fs))
            fs /= R
    R_last = factors[-1] if factors else 1

    def guard_resp(freqs):
        resp = np.ones_like(np.asarray(freqs, np.float64))
        for taps, fs_i in guard_list:
            resp = resp * _stage_response(taps, fs_i, freqs)
        return resp

    h_last = _matched_last_stage(fs, corner, order, guard_resp, last_taps)
    stages.append((R_last, h_last))

    delay = 0
    prod = 1
    for R, h in stages:
        delay += (len(h) // 2) * prod
        prod *= R
    assert prod == ratio
    return CascadePlan(
        stages=tuple((int(R), h) for R, h in stages),
        ratio=int(ratio),
        delay=int(delay),
        fs_in=float(fs_in),
        corner=float(corner),
        order=int(order),
    )


# ---------------------------------------------------------------------------
# application


def _block_taps(h: np.ndarray, R: int) -> np.ndarray:
    L = len(h)
    B = -(-L // R)
    hp = np.zeros(B * R, np.float32)
    hp[:L] = h
    return hp.reshape(B, R)


def _stage_counts(plan: CascadePlan, n_out: int) -> list[int]:
    """Required output count per stage: a stage producing n outputs
    with B tap-frames consumes (n + B) * R input samples."""
    counts = [n_out]
    for R, h in reversed(plan.stages[1:]):
        counts.append((counts[-1] + (-(-len(h) // R))) * R)
    counts.reverse()
    return counts


def cascade_input_need(plan: CascadePlan, n_out: int) -> int:
    """Input rows the cascade minimally consumes to emit ``n_out``
    outputs (after the delay pre-shift): the first stage's
    ``(count + B) * R`` — :func:`chain_layout`'s ``rows``."""
    counts = _stage_counts(plan, int(n_out))
    R0, h0 = plan.stages[0]
    B0 = -(-len(h0) // int(R0))
    return (counts[0] + B0) * int(R0)


def plan_from_arrays(stages, ratio, delay, fs_in, corner, order) -> CascadePlan:
    """A :class:`CascadePlan` from plain arrays — how a plan designed
    elsewhere (the JAX package, a saved configuration) is carried into
    the port.  ``stages`` is a sequence of ``(R, taps)``; taps become
    float32 numpy arrays.  The structure is checked (odd tap lengths,
    ``prod(R) == ratio``, ``delay`` equal to the one the taps imply)."""
    out = []
    prod = 1
    want_delay = 0
    for R, h in stages:
        R = int(R)
        h = np.asarray(h, np.float32).reshape(-1).copy()
        if R < 1 or h.size % 2 == 0:
            raise ValueError(
                f"stage needs R >= 1 and an odd tap count, got R={R}, "
                f"{h.size} taps"
            )
        want_delay += (h.size // 2) * prod
        prod *= R
        out.append((R, h))
    if prod != int(ratio):
        raise ValueError(f"stage factors multiply to {prod}, not {ratio}")
    if want_delay != int(delay):
        raise ValueError(f"taps imply delay {want_delay}, not {delay}")
    return CascadePlan(
        stages=tuple(out),
        ratio=int(ratio),
        delay=int(delay),
        fs_in=float(fs_in),
        corner=float(corner),
        order=int(order),
    )


def resolve_cascade_engine(engine: str, device) -> str:
    """The engine a cascade on ``device`` runs: ``"auto"`` -> ``"cuda"``
    on a CUDA device, ``"torch"`` on the CPU; ``"cuda"`` on the CPU
    raises."""
    dev = torch.device(device)
    if engine not in BATCH_ENGINES:
        raise ValueError(
            f"engine must be one of {BATCH_ENGINES}, got {engine!r}"
        )
    if engine == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if engine == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"engine='cuda' needs a CUDA tensor, got device {dev}"
        )
    return engine


def chain_layout(plan: CascadePlan, n_out: int, engine: str = "auto",
                 device=None):
    """Per-stage execution layout: ``(((engine_i, k_i), ...), rows)``.

    ``k_i`` is the output count stage ``i`` emits and ``engine_i`` the
    stage it runs ('cuda' kernel or 'torch' plain); ``rows`` is the
    exact input length the first stage consumes.  Sized back to front
    so every stage's input is exactly what its predecessor emits:
    ``k_{i-1} = (k_i + B_i) * R_i``."""
    eng = resolve_cascade_engine(engine, resolve_device(device))
    counts = _stage_counts(plan, int(n_out))
    return (
        tuple((eng, k) for k in counts),
        cascade_input_need(plan, int(n_out)),
    )


def stage_engines(plan: CascadePlan, n_out: int, engine: str = "auto",
                  device=None) -> list[str]:
    """Which engine each stage runs under (the same decision
    :func:`cascade_decimate` makes)."""
    return [e for e, _ in chain_layout(plan, n_out, engine, device)[0]]


def _check_quantized(x, qscale):
    """``qscale`` must accompany exactly an int16 payload."""
    if qscale is not None and x.dtype != torch.int16:
        raise ValueError(f"qscale given but data dtype is {x.dtype}")


def shift_to_phase(x, phase: int, delay: int):
    """Align a (T, C) tensor so causal cascade output ``k`` lands on
    zero-phase full-rate index ``phase + k*ratio``: drop
    ``phase - delay`` leading rows, or left-pad with zeros when the
    requested phase precedes the filter delay.  The plain path's step;
    the kernel path passes ``phase - delay`` to stage 0 as its first
    row instead."""
    shift = int(phase) - int(delay)
    if shift >= 0:
        return x[shift:]
    return torch.nn.functional.pad(x, (0, 0, -shift, 0))


@functools.lru_cache(maxsize=64)
def _blocked_taps_host(plan: CascadePlan):
    return tuple((int(R), _block_taps(np.asarray(h), R)) for R, h in plan.stages)


_DEVICE_TAPS: dict = {}


def blocked_taps(plan: CascadePlan, device) -> list:
    """``[(R, hb), ...]``: each stage's frame-blocked (B, R) float32
    taps as a tensor on ``device``.  CUDA copies are kept per (plan,
    device): a copy from pageable host memory waits for the stream, so
    a copy per window would serialise host and card.  Callers only read
    them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [(R, torch.from_numpy(hb).to(dev))
                for R, hb in _blocked_taps_host(plan)]
    key = (plan, str(dev))
    taps = _DEVICE_TAPS.get(key)
    if taps is None:
        if len(_DEVICE_TAPS) >= 64:
            _DEVICE_TAPS.clear()
        taps = _DEVICE_TAPS[key] = [
            (R, torch.from_numpy(hb).to(dev))
            for R, hb in _blocked_taps_host(plan)
        ]
    return list(taps)


def cascade_decimate(
    x, plan: CascadePlan, phase: int, n_out: int, engine="auto",
    qscale=None, device=None, mesh=None, ch_axis="ch",
):
    """Zero-phase filtered + decimated samples of ``x`` (T, C).

    Output ``k`` equals the composite zero-phase filter of ``x``
    evaluated at full-rate index ``phase + k*plan.ratio`` — exactly the
    samples the reference's ``pass_filter → interpolate`` pipeline
    (lf_das.py:223-225) lands on when the target grid is sample-aligned.
    Edge regions (within ``plan.delay`` of either end) carry the usual
    truncation artifacts, which the overlap-save scheduler trims.

    ``x`` is a torch tensor (its device is used; ``device`` must then
    be None or match) or a numpy array (moved to ``device``, which
    defaults to the CUDA card).  Returns an (n_out, C) float32 tensor on
    that device.

    ``qscale`` accepts a raw int16 quantized window; the result equals
    ``cascade_decimate(x.float() * qscale, ...)``.  On the kernel path
    the first stage reads the int16 payload (half the bytes) and the
    scale multiplies its decimated output, as the TPU kernel's contract
    has it (tpudas/ops/fir.py:529-547); the plain path dequantizes
    first, as the JAX package's XLA path does.

    With ``mesh`` (a :class:`~tpudas_torch.parallel.mesh.DeviceMesh`),
    channels are split over the mesh's ``ch_axis`` (pad-and-mask: C is
    zero-padded to a multiple of the shard count and trimmed after);
    each shard runs this cascade on its device, and the (n_out, C)
    result is gathered on the first shard's device.
    """
    if mesh is not None:
        return _cascade_decimate_sharded(x, plan, phase, n_out, engine,
                                         qscale, mesh, ch_axis)
    if isinstance(x, torch.Tensor):
        dev = x.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"x is on {dev}, device={device!r}")
    else:
        dev = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    eng = resolve_cascade_engine(engine, dev)
    _check_quantized(x, qscale)
    with span("op.cascade", rows=int(x.shape[0]), engine=engine):
        return _cascade_chain(x, plan, phase, n_out, eng, qscale, dev)


def _cascade_chain(x, plan, phase, n_out, eng, qscale, dev):
    """The stages of :func:`cascade_decimate` on the tensor ``x`` with
    the resolved engine ``eng``."""
    from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain

    layout, _rows = chain_layout(plan, n_out, eng, dev)
    taps = blocked_taps(plan, dev)
    if eng != "cuda":
        if qscale is not None:
            qs = torch.tensor(np.float32(qscale), device=dev)
            x = x.to(torch.float32) * qs
        x = shift_to_phase(x.to(torch.float32), phase, plan.delay)
        for (R, hb), (_e, k) in zip(taps, layout):
            x = fir_decimate_plain(x.contiguous(), hb, R, k)
        return x
    # the kernel reads stage 0 from row phase - delay, rows below 0 as
    # zero: no shifted or padded copy of the window; the scale (a host
    # float32, no copy to the card) multiplies stage 0's output
    if qscale is None and x.dtype != torch.float32:
        x = x.to(torch.float32)
    x = x.contiguous()
    for i, ((R, hb), (_e, k)) in enumerate(zip(taps, layout)):
        x = fir_decimate(x, hb, R, k, int(phase) - plan.delay if i == 0 else 0)
        if i == 0 and qscale is not None:
            x = x * float(np.float32(qscale))
    return x


def _cascade_decimate_sharded(x, plan, phase, n_out, engine, qscale, mesh,
                              ch_axis):
    """:func:`cascade_decimate` over the column shards of ``mesh``'s
    ``ch_axis``: every shard's chain is launched before the outputs are
    gathered."""
    from tpudas_torch.parallel.sharding import column_shards, gather_columns

    parts = [cascade_decimate(xs, plan, phase, n_out, engine, qscale=qscale)
             for xs in column_shards(x, mesh, ch_axis)]
    return gather_columns(parts, int(x.shape[1]))


# ---------------------------------------------------------------------------
# streaming: the cascade as an O(1)-state filter over consecutive blocks
#
# Stage i keeps its last p_i input rows, with p_i >= len(taps_i) - R_i so
# each new block's outputs have their full look-back.  The composite
# full-rate lag D = sum_i p_i * prod_{j<i} R_j telescopes to
# receptive_field - ratio at the minimal sizes; stage 0's carry absorbs
# the padding that rounds D up to a multiple of the ratio, so the
# streamed grid stays on the decimated grid (W = D / ratio outputs of
# warm-up).  The layout is the JAX package's byte for byte, so a carry
# saved by either package resumes under the other.


@functools.lru_cache(maxsize=256)
def stream_carry_sizes(plan: CascadePlan) -> tuple:
    """Per-stage carried trailing samples (at each stage's own input
    rate).  Stage 0 includes the alignment pad that makes the composite
    lag a whole number of output samples."""
    sizes = [max(len(h) - int(R), 0) for R, h in plan.stages]
    d = 0
    prod = 1
    for p, (R, _h) in zip(sizes, plan.stages):
        d += p * prod
        prod *= int(R)
    sizes[0] += (-d) % plan.ratio
    return tuple(sizes)


def stream_warmup_outputs(plan: CascadePlan) -> int:
    """Outputs to discard after a zero-initialized carry (the composite
    stream lag in output samples)."""
    d = 0
    prod = 1
    for p, (R, _h) in zip(stream_carry_sizes(plan), plan.stages):
        d += p * prod
        prod *= int(R)
    if d % plan.ratio:
        raise ValueError(f"stream lag {d} is not a multiple of {plan.ratio}")
    return d // plan.ratio


def cascade_stream_init(plan: CascadePlan, n_ch: int, device=None) -> tuple:
    """Zero carry for :func:`cascade_decimate_stream`: one float32
    ``(p_i, n_ch)`` tensor per stage on ``device`` (default: the CUDA
    card)."""
    dev = resolve_device(device)
    return tuple(
        torch.zeros((p, int(n_ch)), dtype=torch.float32, device=dev)
        for p in stream_carry_sizes(plan)
    )


def stages_step_cost(stages, sizes, T: int, C: int, in_bytes: int) -> dict:
    """The least work of one stateful step of ``stages`` (``(R, taps)``
    pairs with carry rows ``sizes``) over ``T`` input rows of ``C``
    channels of ``in_bytes`` each: ``{"flops", "bytes"}``.  Bytes: the
    input read once, the output and the new carry written once, the old
    carry read once; flops: two per true tap and output of every stage.
    A property of the work, not of the engine that does it: the device
    telemetry's cost and the bound of ``chip_smoke.py`` both read it."""
    flops, rows = 0.0, int(T)
    for R, h in stages:
        rows //= int(R)
        flops += 2.0 * len(h) * rows * int(C)
    by = (int(T) * int(C) * int(in_bytes) + rows * int(C) * 4
          + 2 * sum(int(p) for p in sizes) * int(C) * 4)
    return {"flops": flops, "bytes": float(by)}


def stream_step_cost(plan: CascadePlan, T: int, C: int,
                     in_bytes: int) -> dict:
    """:func:`stages_step_cost` of the whole cascade: one stream step of
    ``plan`` over a ``(T, C)`` block."""
    return stages_step_cost(plan.stages, stream_carry_sizes(plan), T, C,
                            in_bytes)


def _plan_tag(plan: CascadePlan) -> str:
    """Compact stable tag of a plan for the device telemetry's kernel
    keys: distinct plans read as distinct shapes, and the key stays
    printable (the /devprof kernel log shows it)."""
    return (
        f"r{plan.ratio}s{len(plan.stages)}"
        f"h{hash(plan) & 0xFFFFFF:06x}"
    )


# the env knobs that change what a stream step runs
_KNOB_ENVS = ("TPUDAS_FUSED_MIN_ELEMS", "TPUDAS_FUSED_CHUNK")


def knob_fingerprint() -> tuple:
    """The current value of every knob of :data:`_KNOB_ENVS`, as one
    tuple: the device telemetry's ``knobs`` of a stream step."""
    import os

    return tuple(os.environ.get(n, "").strip() for n in _KNOB_ENVS)


def fused_min_elems() -> int:
    """Block elements (T*C) below which a ``fused`` request runs the
    per-stage chain instead (the JAX package's measured crossover,
    kept so both packages pick the same engine for the same block);
    ``TPUDAS_FUSED_MIN_ELEMS`` overrides it, read at call time."""
    import os

    raw = os.environ.get("TPUDAS_FUSED_MIN_ELEMS", "").strip()
    return int(raw) if raw else (1 << 23)


def _fused_chunk_for_ratio(ratio: int, n_out: int) -> int:
    """:func:`fused_chunk_outputs` for a cascade of total ``ratio``."""
    import os

    raw = os.environ.get("TPUDAS_FUSED_CHUNK", "").strip()
    target = int(raw) if raw else max(1, 8192 // int(ratio))
    n_out = int(n_out)
    target = max(1, min(target, n_out))
    best = 1
    for d in range(1, target + 1):
        if n_out % d == 0:
            best = d
    return best


def fused_chunk_outputs(plan: CascadePlan, n_out: int) -> int:
    """Output samples per chunk of the plain fused loop: the largest
    divisor of the block's output count not above the target
    (``TPUDAS_FUSED_CHUNK``, else sized so a full-rate chunk is ~8192
    rows); a divisor keeps every chunk one shape, as the JAX scan
    needs.  The CUDA kernel walks chunks of one output; this sizes only
    :func:`~tpudas_torch.ops.fused_kernel.fused_cascade_plain`."""
    return _fused_chunk_for_ratio(plan.ratio, n_out)


def fused_intermediate_bytes(plan: CascadePlan, T: int, n_ch: int) -> int:
    """Bytes of per-stage intermediates the per-stage chain writes to
    device memory for a ``(T, n_ch)`` block and the fused step never
    writes (each is also read back by the next stage, so the traffic
    the fused step saves is ~2x this)."""
    rows = int(T)
    total = 0
    for R, _h in plan.stages[:-1]:
        rows //= int(R)
        total += rows * int(n_ch) * 4
    return total


def _count_fused(plan: CascadePlan, T: int, n_ch: int,
                 variant: str) -> None:
    """Per-step fused-path observability: steps by variant, and the
    bytes of the per-stage intermediates the chain would have written
    for the block (:func:`fused_intermediate_bytes`)."""
    from tpudas_torch.obs.registry import get_registry

    reg = get_registry()
    reg.counter(
        "tpudas_fir_fused_rounds_total",
        "fused cascade stream steps dispatched",
        labelnames=("engine",),
    ).inc(engine=variant)
    reg.counter(
        "tpudas_fir_fused_intermediate_bytes_saved_total",
        "per-stage full-rate HBM intermediate bytes the fused kernel "
        "did not materialize",
    ).inc(fused_intermediate_bytes(plan, T, n_ch))


def resolve_stream_engine(engine: str, plan: CascadePlan = None,
                          T: int = 0, n_ch: int = 0, device=None) -> str:
    """The engine a stream block runs: ``auto``/``cuda``/``torch`` ->
    the per-stage chain (:func:`resolve_cascade_engine`); ``fused`` ->
    ``fused-cuda`` on a CUDA device, ``fused-torch`` on the CPU, unless
    the block is smaller than :func:`fused_min_elems` (then the chain);
    ``fused-cuda``/``fused-torch`` are forced.  On the card ``fused``
    does not look at the plan: a plan the kernel cannot take raises
    when the kernel is launched, rather than switching engine."""
    if engine not in STREAM_ENGINES:
        raise ValueError(
            f"stream engine must be one of {STREAM_ENGINES}, got {engine!r}"
        )
    dev = resolve_device(device)
    if engine in BATCH_ENGINES:
        return resolve_cascade_engine(engine, dev)
    if engine == "fused":
        if plan is not None and int(T) * int(n_ch) < fused_min_elems():
            return resolve_cascade_engine("auto", dev)
        return "fused-cuda" if dev.type == "cuda" else "fused-torch"
    if engine == "fused-cuda" and dev.type != "cuda":
        raise ValueError(
            f"engine='fused-cuda' needs a CUDA tensor, got device {dev}"
        )
    return engine


def stream_stage_engines(plan: CascadePlan, T: int, n_ch: int,
                         engine: str = "auto", device=None) -> list:
    """Which engine each stage of a stream block of ``T`` rows runs
    under (the decision :func:`cascade_decimate_stream` makes).  Under a
    fused variant every stage runs inside the one fused step."""
    eng = resolve_stream_engine(engine, plan, T, n_ch, device)
    return [eng for _ in plan.stages]


def _carry_leaf(b, dev):
    """A carry leaf as a float32 tensor on ``dev`` (a resumed carry
    arrives as numpy arrays from the ``.npz``)."""
    if isinstance(b, torch.Tensor):
        return b.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)


def cascade_decimate_stream(x, carry, plan: CascadePlan, engine="auto",
                            qscale=None, device=None, mesh=None, ch_axis="ch"):
    """One stateful streaming step of the cascade.

    ``x`` is a (T, C) block, T a multiple of ``plan.ratio`` (a tensor,
    whose device is used, or a numpy array moved to ``device``, default
    the CUDA card); ``carry`` comes from :func:`cascade_stream_init`, a
    previous step, or a loaded carry (numpy leaves are moved to the
    block's device).  Returns ``(y (T/ratio, C), new_carry)``, fresh
    float32 tensors on that device.

    ``engine`` is any :data:`STREAM_ENGINES` literal.  The per-stage
    chain concatenates each stage's carry before its input and runs the
    strided-FIR stage on ``len(input) // R`` outputs (the kernel on the
    card, the plain stage on the CPU); the fused variants run
    :func:`~tpudas_torch.ops.fused_kernel.fused_cascade`.  The carry
    layout is shared, so the engine may change between steps.

    ``qscale`` accepts a raw int16 block; the result equals feeding
    ``x.float() * qscale``.  The chain dequantizes the block first; the
    fused kernel dequantizes as it reads (bit-equal).  The carry stays
    float32 either way.

    With ``mesh``, channels are split over the mesh's ``ch_axis``
    (pad-and-mask for non-divisible counts): the block is placed with
    :func:`~tpudas_torch.parallel.sharding.place_block`, a host carry is
    placed once, and the returned carry leaves are
    :class:`~tpudas_torch.parallel.sharding.ShardedTensor` s at the
    padded width — feed them back as they are and they stay on the
    devices with no host round trip.  ``y`` is gathered on the first
    shard's device at the logical width.  Every shard runs the engine
    the unsharded step resolves for the whole block (the fused size
    threshold sees the logical width), so the sharded step is
    byte-identical to the unsharded one.
    """
    if mesh is not None:
        return _stream_sharded(x, carry, plan, engine, qscale, mesh, ch_axis)
    if isinstance(x, torch.Tensor):
        dev = x.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"x is on {dev}, device={device!r}")
    else:
        dev = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    _check_quantized(x, qscale)
    T, n_ch = int(x.shape[0]), int(x.shape[1])
    if T % plan.ratio:
        raise ValueError(
            f"stream block length {T} is not a multiple of the "
            f"decimation ratio {plan.ratio}"
        )
    _check_rows(carry, plan)
    if any(int(np.shape(b)[1]) != n_ch for b in carry):
        raise ValueError(
            f"carry channel widths {[np.shape(b)[1] for b in carry]} do not "
            f"match the block's {n_ch}"
        )
    eng = resolve_stream_engine(engine, plan, T, n_ch, dev)
    bufs = tuple(_carry_leaf(b, dev) for b in carry)
    x = x.contiguous()
    shape_key = (T, n_ch, eng, int(qscale is not None), _plan_tag(plan))
    devprof.note_kernel("cascade", shape_key, knob_fingerprint())
    cost = devprof.kernel_cost("cascade", shape_key, stream_step_cost,
                               (plan, T, n_ch, x.element_size()))
    fused = eng.startswith("fused")
    sp = (span("fir.fused", rows=T, engine=eng) if fused
          else span("op.cascade_stream", rows=T, engine=eng))
    t0 = devprof.launch_start(dev)
    with sp:
        out = _stream_step(x, bufs, plan, eng, qscale)
    devprof.note_launch(eng, t0, out, cost=cost)
    if fused:
        _count_fused(plan, T, n_ch, eng)
    return out


def _dtype_of(x):
    """``x``'s dtype as a torch dtype (numpy int16 -> torch.int16)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def _check_rows(carry, plan: CascadePlan) -> None:
    """Raise unless ``carry`` has the plan's carry sizes."""
    sizes = stream_carry_sizes(plan)
    if len(carry) != len(sizes) or any(
        int(np.shape(b)[0]) != p for b, p in zip(carry, sizes)
    ):
        raise ValueError(
            "carry does not match this plan's stream_carry_sizes "
            f"({[int(np.shape(b)[0]) for b in carry]} vs {list(sizes)})"
        )


def _stream_sharded(x, carry, plan, engine, qscale, mesh, ch_axis):
    """:func:`cascade_decimate_stream` over the column shards of
    ``mesh``'s ``ch_axis``: one step (one devprof launch, one span)
    whose shards are all launched before the output is gathered."""
    from tpudas_torch.parallel.sharding import (
        ShardedTensor,
        channel_pad,
        gather_columns,
        gather_leaves,
        place_block,
        place_carry_leaves,
    )

    quantized = qscale is not None
    if quantized and _dtype_of(x) != torch.int16:
        raise ValueError(f"qscale given but data dtype is {x.dtype}")
    T, C = int(np.shape(x)[0]), int(np.shape(x)[1])
    if T % plan.ratio:
        raise ValueError(
            f"stream block length {T} is not a multiple of the "
            f"decimation ratio {plan.ratio}"
        )
    _check_rows(carry, plan)
    devices = mesh.axis_devices(ch_axis)
    nc = len(devices)
    Cp = C + channel_pad(C, mesh, ch_axis)
    if any(int(np.shape(b)[1]) not in (C, Cp) for b in carry):
        raise ValueError(
            f"stream carry channel width {[tuple(np.shape(b)) for b in carry]} "
            f"matches neither the block ({C}) nor the padded shard "
            f"layout ({Cp})"
        )
    # the engine is the unsharded step's, resolved at the logical width:
    # B3 and the B1 chain differ in their last bits on the card, so a
    # shard must run what the single-device step runs on its block
    eng = resolve_stream_engine(engine, plan, T, C, devices[0])
    xs = place_block(x, mesh, ch_axis, keep_dtype=quantized)
    if not all(isinstance(b, ShardedTensor) and b.devices == devices
               and b.shape[1] == Cp for b in carry):
        # first step after open/resume (host leaves at the logical width),
        # or leaves of another layout: place them once; every later step
        # feeds back the sharded leaves this step returns
        carry = place_carry_leaves(
            tuple(gather_leaves((b,), C)[0] if isinstance(b, ShardedTensor)
                  else b for b in carry), mesh, ch_axis)
    shape_key = (T, Cp, eng, int(quantized), _plan_tag(plan), nc)
    devprof.note_kernel("cascade", shape_key, knob_fingerprint())
    cost = devprof.kernel_cost("cascade", shape_key, stream_step_cost,
                               (plan, T, Cp, xs[0].element_size()))
    fused = eng.startswith("fused")
    sp = (span("fir.fused", rows=T, engine=eng, shards=nc) if fused
          else span("op.cascade_stream", rows=T, engine=eng, shards=nc))
    t0 = devprof.launch_start(mesh.unique_devices())
    with sp:
        ys, bufs = _shard_steps(xs, carry, plan, eng, qscale)
        y = gather_columns(ys, C)
    devprof.note_launch(eng, t0, (y, bufs), cost=cost)
    if fused:
        _count_fused(plan, T, C, eng)
    return y, bufs


def _shard_steps(xs, carry, plan: CascadePlan, eng: str, qscale):
    """:func:`_stream_step` on every shard of the placed block ``xs``
    and the sharded carry leaves ``carry`` (each launched before any is
    waited on) -> (per-shard outputs, sharded new carry)."""
    from tpudas_torch.parallel.sharding import ShardedTensor

    outs = [_stream_step(x, tuple(leaf[i] for leaf in carry), plan, eng,
                         qscale)
            for i, x in enumerate(xs)]
    return ([o[0] for o in outs],
            tuple(ShardedTensor(o[1][k] for o in outs)
                  for k in range(len(carry))))


def _stream_step(x, bufs, plan: CascadePlan, eng: str, qscale):
    """One stream step of the resolved engine ``eng`` on a contiguous
    block and float32 carry leaves on its device -> ``(y, new_carry)``.
    The solo and the stacked step both run it."""
    dev = x.device
    sizes = stream_carry_sizes(plan)
    if eng.startswith("fused"):
        from tpudas_torch.ops.fused_kernel import (
            fused_cascade,
            fused_cascade_plain,
        )

        step = fused_cascade if eng == "fused-cuda" else fused_cascade_plain
        return step(x, bufs, plan.stages, sizes, qscale=qscale)
    from tpudas_torch.ops.fir_kernel import fir_decimate, fir_decimate_plain

    stage = fir_decimate if eng == "cuda" else fir_decimate_plain
    if qscale is not None:
        x = x.to(torch.float32) * torch.tensor(np.float32(qscale), device=dev)
    else:
        x = x.to(torch.float32)
    new_carry = []
    for (R, hb), p, buf in zip(blocked_taps(plan, dev), sizes, bufs):
        xc = torch.cat([buf, x], dim=0) if p else x
        k = x.shape[0] // R
        new_carry.append(xc[xc.shape[0] - p :].clone())
        x = stage(xc, hb, R, k)
    return x, tuple(new_carry)


def _block_tensor(b, device):
    """A stream block as a tensor (its own device), or numpy moved to
    ``device`` (default the CUDA card); int16 stays int16."""
    if isinstance(b, torch.Tensor):
        return b
    return torch.from_numpy(np.ascontiguousarray(b)).to(resolve_device(device))


def cascade_decimate_stream_stacked(blocks, carries, plan: CascadePlan,
                                    engine, qscale=None, device=None,
                                    mesh=None, ch_axis="ch"):
    """N same-plan streams' stateful steps as ONE step on the
    channel-packed block (the batched fleet's stacked launch).

    ``blocks`` are (T, C_i) blocks sharing T and dtype (mixed widths are
    the ragged case: each stream keeps its own width); ``carries`` the
    matching per-stream carries (from :func:`cascade_stream_init`, a
    previous solo or stacked step, or a loaded ``.npz``: one layout, so
    a stream moves freely between solo and stacked steps).  The blocks
    are packed along channels in the given order (the caller sorts the
    members), int16 as int16, and each carry leaf likewise; ``engine``
    (a resolved :data:`STACKED_ENGINES` literal, chosen at the member's
    own width) runs once on the packed block: ``fused-cuda`` is B3
    (kernels A then B) and ``cuda`` the chain of B1 launches, exactly
    as :func:`cascade_decimate_stream` runs them for one member.  Returns
    ``[(y_i, new_carry_i), ...]`` in member order, each a fresh
    contiguous tensor, byte-identical to the member's solo step.

    ``qscale`` is one scale shared by every member (the batch executor
    keys on it).  ``cascade_decimate_stream_stacked.launches`` counts
    the stacked steps that ran on the card, by ``(engine, packed
    width)``.

    With ``mesh`` the packed width is pad-and-masked to the shard
    multiple and split over the mesh's ``ch_axis`` (numpy blocks are
    packed on the mesh's first device); each member's outputs and carry
    leaves come back on that device, byte-identical to its solo step."""
    if mesh is not None and device is None:
        device = mesh.axis_devices(ch_axis)[0]
    if engine not in STACKED_ENGINES:
        raise ValueError(
            f"stacked engine must be one of {STACKED_ENGINES}, got "
            f"{engine!r}"
        )
    blocks = [_block_tensor(b, device) for b in blocks]
    carries = [tuple(c) for c in carries]
    if not blocks or len(blocks) != len(carries):
        raise ValueError(
            f"blocks/carries length mismatch: {len(blocks)} vs "
            f"{len(carries)}"
        )
    T = int(blocks[0].shape[0])
    if T % plan.ratio:
        raise ValueError(
            f"stream block length {T} is not a multiple of the "
            f"decimation ratio {plan.ratio}"
        )
    dev, dtype = blocks[0].device, blocks[0].dtype
    widths = [int(b.shape[1]) for b in blocks]
    sizes = stream_carry_sizes(plan)
    for i, (b, c, w) in enumerate(zip(blocks, carries, widths)):
        if int(b.shape[0]) != T:
            raise ValueError(
                f"member {i} block has {int(b.shape[0])} rows; the "
                f"stacked step needs a shared T={T} (partition waves "
                "by block length)"
            )
        if b.dtype != dtype or b.device != dev:
            raise ValueError(
                f"member {i} block is {b.dtype} on {b.device}; the "
                f"stacked step packs one dtype on one device ({dtype} on "
                f"{dev})"
            )
        if len(c) != len(sizes) or any(
            int(np.shape(leaf)[0]) != p for leaf, p in zip(c, sizes)
        ):
            raise ValueError(
                f"member {i} carry does not match this plan's "
                "stream_carry_sizes "
                f"({[int(np.shape(leaf)[0]) for leaf in c]} vs "
                f"{list(sizes)})"
            )
        if any(int(np.shape(leaf)[1]) != w for leaf in c):
            raise ValueError(
                f"member {i} carry width "
                f"{[tuple(np.shape(leaf)) for leaf in c]} does not match "
                f"its block width {w}"
            )
        _check_quantized(b, qscale)
    if engine.endswith("cuda") and dev.type != "cuda":
        raise ValueError(
            f"engine={engine!r} needs CUDA tensors, got device {dev}"
        )
    # one stacked launch: the packing, the step and the unpacking, as
    # the JAX package's stacked program holds all three
    shape_key = (T, tuple(widths), engine, int(qscale is not None),
                 _plan_tag(plan))
    devprof.note_kernel("cascade_stacked", shape_key, knob_fingerprint())
    cost = devprof.kernel_cost(
        "cascade_stacked", shape_key, stream_step_cost,
        (plan, T, sum(widths), blocks[0].element_size()))
    t0 = devprof.launch_start(dev if mesh is None else mesh.unique_devices())
    x = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
    bufs = tuple(
        torch.cat([_carry_leaf(c[i], dev) for c in carries], dim=1)
        for i in range(len(sizes))
    )
    if mesh is None:
        y, new = _stream_step(x.contiguous(), bufs, plan, engine, qscale)
    else:
        from tpudas_torch.parallel.sharding import (
            gather_columns,
            place_block,
            place_carry_leaves,
        )

        W = sum(widths)
        ys, new = _shard_steps(
            place_block(x, mesh, ch_axis, keep_dtype=qscale is not None),
            place_carry_leaves(bufs, mesh, ch_axis), plan, engine, qscale)
        y = gather_columns(ys, W, device=dev)
        new = tuple(gather_columns(leaf, W, device=dev) for leaf in new)
    if dev.type == "cuda":
        key = (engine, sum(widths))
        launches = cascade_decimate_stream_stacked.launches
        launches[key] = launches.get(key, 0) + 1
    out = []
    o = 0
    for w in widths:
        out.append((
            y[:, o : o + w].contiguous(),
            tuple(leaf[:, o : o + w].contiguous() for leaf in new),
        ))
        o += w
    devprof.note_launch(engine, t0, out, cost=cost, stacked=True)
    if engine.startswith("fused"):
        for w in widths:
            _count_fused(plan, T, w, engine)
    return out


cascade_decimate_stream_stacked.launches = {}


# ---------------------------------------------------------------------------
# probing (host-side, analytic)


def impulse_response(plan: CascadePlan, n: int | None = None) -> np.ndarray:
    """Composite full-rate impulse response of the cascade (numpy).

    Equivalent to pushing a unit impulse through all stages WITHOUT
    decimation (valid because decimation commutes with the linear
    filters for response-support analysis) — the analytic counterpart of
    the reference's synthetic-impulse probe (lf_das.py:47-87).
    """
    h = np.ones(1, np.float64)
    prod = 1
    for R, taps in plan.stages:
        up = np.zeros(prod * (len(taps) - 1) + 1, np.float64)
        up[::prod] = np.asarray(taps, np.float64)
        h = np.convolve(h, up)
        prod *= R
    if n is not None and len(h) < n:
        h = np.pad(h, (0, n - len(h)))
    return h


@functools.lru_cache(maxsize=256)
def edge_support_samples(plan: CascadePlan, tol: float = 1e-3) -> int:
    """One-sided support (full-rate samples) of the composite impulse
    response thresholded at ``max*tol`` — the cascade's equivalent of
    ``get_edge_effect_time`` (reference lf_das.py:67-77)."""
    h = impulse_response(plan)
    mag = np.abs(h)
    above = np.nonzero(mag > mag.max() * tol)[0]
    center = plan.delay
    return int(max(center - above[0], above[-1] - center, 0))
