"""Faults that a cell can have, planted in the program where its answer
is made, so a run with one shows ``correct`` false.

    with planted("half_left_out", "edge10k.catchup"):
        result, checks = run_cell("edge10k.catchup", ...)

``FAULTS`` lists, for each cell, the program's function each fault
wraps: the batch cascade (B1's caller), the FFT engine's window, the
stream's stateful step (B3's caller), or the FFT stream's overlap-save
step and its emit.
"""

from __future__ import annotations

import contextlib
import importlib


def half_left_out(fn):
    """The answer for half the channels left out where it is made."""
    def planted(*a, **k):
        out = fn(*a, **k)
        y = out[0] if isinstance(out, tuple) else out
        y[:, y.shape[1] // 2:] = 0
        return out
    return planted


def one_altered(fn):
    """One output sample moved by 1e-4 of its channel's peak where it
    is made."""
    def planted(*a, **k):
        out = fn(*a, **k)
        y = out[0] if isinstance(out, tuple) else out
        if y.shape[0]:
            y[y.shape[0] // 2, 3] += 1e-4 * float(y[:, 3].abs().max())
        return out
    return planted


def one_emitted_altered(fn):
    """One output sample moved by 1e-4 of its channel's peak as the
    stream hands its block's outputs to the writer (the FFT stream
    filters every full-rate row and emits one in a thousand, so a row
    altered in the filter's answer would mostly go unseen)."""
    def planted(lfp, carry, patch, out, *a, **k):
        if out.shape[0]:
            out = out.copy()
            out[out.shape[0] // 2, 3] += 1e-4 * float(abs(out[:, 3]).max())
        return fn(lfp, carry, patch, out, *a, **k)
    return planted


def state_unchanged(fn):
    """A stream step that hands back the state it was given."""
    def planted(x, bufs, *a, **k):
        y, _new = fn(x, bufs, *a, **k)
        return y, bufs
    return planted


_BATCH = ("tpudas_torch.ops.fir", "cascade_decimate")
_FFT = ("tpudas_torch.proc.lfproc", "lowpass_resample")
_STREAM = ("tpudas_torch.ops.fir", "cascade_decimate_stream")
_FFT_STREAM = ("tpudas_torch.ops.filter", "fft_pass_filter_stream")
_STREAM_EMIT = ("tpudas_torch.proc.stream", "_emit")

# (cell, fault, (module, function it wraps))
FAULTS = [
    ("edge10k.archive", half_left_out, _BATCH),
    ("edge10k.archive", one_altered, _BATCH),
    ("edge10k-fft.archive", half_left_out, _FFT),
    ("edge10k-fft.archive", one_altered, _FFT),
    ("edge10k.catchup", state_unchanged, _STREAM),
    ("edge10k.catchup", half_left_out, _STREAM),
    ("edge10k.catchup", one_altered, _STREAM),
    ("edge10k-fft.catchup", state_unchanged, _FFT_STREAM),
    ("edge10k-fft.catchup", half_left_out, _FFT_STREAM),
    ("edge10k-fft.catchup", one_emitted_altered, _STREAM_EMIT),
]


@contextlib.contextmanager
def planted(name: str, workload: str):
    """Plant the fault ``name`` of ``workload``'s cell for the block."""
    hits = [t for w, f, t in FAULTS if w == workload and f.__name__ == name]
    if not hits:
        raise KeyError(f"no fault {name!r} for {workload!r}")
    fault = {f.__name__: f for _, f, _ in FAULTS}[name]
    mod = importlib.import_module(hits[0][0])
    orig = getattr(mod, hits[0][1])
    setattr(mod, hits[0][1], fault(orig))
    try:
        yield
    finally:
        setattr(mod, hits[0][1], orig)
