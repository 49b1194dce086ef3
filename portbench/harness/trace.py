"""The traced window: ``torch.profiler`` over the measured window, and
its reduction to device busy time, kernel time by name and the host's
activity in the device's idle gaps.

The harness marks its own layers with spans named ``pb.*``: the window
and each pass or replay as ``record_function`` ranges on the driving
thread, each window read and output write timed on the thread that
runs it (:class:`portbench.harness.program.Probe`).  An idle gap of the
device is charged to the innermost span open at the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import re

WINDOW = "pb.window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def annotate(name: str, on: bool):
    """A ``record_function`` range named ``name`` when tracing is on."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def traced(on: bool, device_type: str, host: bool = True):
    """Profile the block when ``on``; yields a holder whose ``prof`` is
    the finished profiler (None when off).  ``host`` False records the
    card's work alone, with no host activity and no ``pb.*`` range: a
    run whose end-to-end metrics read the device's trace; on a host
    with no card there is then nothing to record."""
    holder = type("Holder", (), {"prof": None})()
    cuda = device_type == "cuda"
    if not on or not (host or cuda):
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with annotate(WINDOW, host):
            yield holder
    holder.prof = prof


def _events(prof, scratch):
    """[(name, kind, start_ns, end_ns)] of the window, from the
    profiler's Chrome trace (written to ``scratch`` and removed): its
    categories name device work (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``) on every PyTorch release the card has seen, and its
    times, in microseconds from ``baseTimeNanoseconds``, are on the host
    spans' clock."""
    path = os.path.join(scratch, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.unlink(path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        start = base + int(float(ev["ts"]) * 1000)
        out.append((ev.get("name", ""), ev.get("cat", ""), start,
                    start + int(float(ev.get("dur", 0)) * 1000)))
    return out


def short_name(name: str) -> str:
    """A kernel's function name without its template arguments and
    signature."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    n = n.split("(", 1)[0]
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:80]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, scratch, host_spans=()) -> dict:
    """:func:`summarize_events` of a finished profiler's window."""
    return summarize_events(_events(prof, scratch), host_spans)


def summarize_events(events, host_spans=()) -> dict:
    """{"window_s", "busy_s", "kernels": {short name: seconds},
    "copies": {name: seconds}, "device_ops": [[name, s]],
    "idle_gaps": [[label, s]]} of the window from ``(name, kind,
    start_ns, end_ns)`` events and the harness's ``(name, start_ns,
    end_ns)`` host spans.  Without a ``pb.window`` range the window
    runs from the first event to the last."""
    if not events:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {},
                "copies": {}, "device_ops": [], "idle_gaps": []}
    marks = [ev for ev in events if ev[0] == WINDOW]
    if marks:
        w0, w1 = marks[0][2], marks[0][3]
    else:
        w0 = min(ev[2] for ev in events)
        w1 = max(ev[3] for ev in events)
    dev = [ev for ev in events if ev[1] in _DEVICE_KINDS]
    clipped = [(max(s, w0), min(e, w1)) for _n, _k, s, e in dev
               if e > w0 and s < w1]
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)
    kernels, copies, ops = {}, {}, {}
    for name, kind, s, e in dev:
        key = short_name(name) if kind == "kernel" else name
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e9
        part = kernels if kind == "kernel" else copies
        part[key] = part.get(key, 0.0) + (e - s) / 1e9
    spans = [ev for ev in events
             if ev[0].startswith("pb.") and ev[0] != WINDOW]
    spans += [(name, "host", t0, t1) for name, t0, t1 in host_spans]
    gaps, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2
            inside = [sp for sp in spans if sp[2] <= mid <= sp[3]]
            label = (max(inside, key=lambda sp: sp[2])[0] if inside
                     else "pb.window")
            gaps[label] = gaps.get(label, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "copies": copies,
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(summary: dict, *needles) -> float:
    """Summed time of the kernels whose name holds any of ``needles``
    (every kernel when none is given)."""
    return sum(v for k, v in summary["kernels"].items()
               if not needles or any(n in k for n in needles))
