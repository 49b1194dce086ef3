"""What the harness takes from the program: ``LFProc`` with two seams
of its own, timed from outside.

``LFProc._load_window`` is the host read of one window (or one stream
slice): the harness times it and counts the payload bytes it returns,
as ``chip_smoke.py``'s phase 4 does.  ``LFProc._write_output`` is the
output write: the harness writes each output patch with the program's
tdas writer under the program's ``LFDAS_`` stem, because the card's
host has no h5py for the default dasdae file, and so the reference
reads the same format on every host.  :func:`span_ms_per_round` reads
the program's own spans of a real-time round.
"""

from __future__ import annotations

import os
import threading
import time


class Probe:
    """The harness's own counts over the measured window, and, while
    tracing, its spans of the host read and the output write (on
    whichever thread runs them) on the profiler's clock."""

    def __init__(self):
        self.tracing = False
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.load_s = 0.0
            self.load_bytes = 0
            self.writes = 0
            self.spans = []

    def add_load(self, t0_ns, nbytes):
        t1_ns = time.time_ns()
        with self._lock:
            self.load_s += (t1_ns - t0_ns) / 1e9
            self.load_bytes += nbytes
            if self.tracing:
                self.spans.append(("pb.load_window", t0_ns, t1_ns))

    def add_write(self, t0_ns):
        t1_ns = time.time_ns()
        with self._lock:
            self.writes += 1
            if self.tracing:
                self.spans.append(("pb.write_output", t0_ns, t1_ns))

    def mark(self) -> tuple:
        """(bytes read, outputs written) so far, for :meth:`check`."""
        with self._lock:
            return self.load_bytes, self.writes

    def check(self, mark, folder):
        """Raise unless both seams fired in the job since ``mark``: the
        host read returned bytes, and every output in ``folder`` came
        through the harness's write.  A program that stops calling
        either seam fails the run instead of dropping its metric."""
        nbytes, writes = self.mark()
        nbytes, writes = nbytes - mark[0], writes - mark[1]
        files = sum(n.startswith("LFDAS_") for n in os.listdir(folder)) \
            if os.path.isdir(folder) else 0
        if nbytes <= 0 or writes < 1 or writes != files:
            raise RuntimeError(
                f"the program bypassed the harness's seams in {folder}: "
                f"LFProc._load_window returned {nbytes} bytes, "
                f"LFProc._write_output wrote {writes} of {files} outputs")


def lfproc_class(probe: Probe):
    """``LFProc`` with the harness's read timing and tdas output."""
    from tpudas_torch.io.tdas import write_tdas
    from tpudas_torch.proc.lfproc import LFProc

    class BenchLFProc(LFProc):
        def _load_window(self, t_lo, t_hi, on_gap, alloc=None):
            t0_ns = time.time_ns()
            patch = super()._load_window(t_lo, t_hi, on_gap, alloc=alloc)
            if patch is not None:
                probe.add_load(t0_ns, int(patch.data.nbytes))
            return patch

        def _write_output(self, patch, path):
            t0_ns = time.time_ns()
            write_tdas(patch, os.path.splitext(path)[0] + ".tdas")
            probe.add_write(t0_ns)

    return BenchLFProc


def span_ms_per_round(ctx, name: str):
    """Milliseconds of the program's ``name`` spans a real-time round:
    their sum over the window's rounds (the count of
    ``tpudas_stream_round_phase_seconds{phase="host_wait"}``); None
    where the program recorded neither."""
    reg = ctx["registry"]
    spans = reg.get("tpudas_span_seconds")
    phases = reg.get("tpudas_stream_round_phase_seconds")
    if spans is None or phases is None:
        return None
    rounds = phases.snapshot(phase="host_wait")["count"]
    snap = spans.snapshot(name=name)
    if not rounds or not snap["count"]:
        return None
    return 1000.0 * snap["sum"] / rounds
