"""The card's idle seconds by the program span open at each gap.

    python -m tpudas_torch.tools.trace_gaps TRACE.pt.trace.json [--json]

Reads a Chrome trace written by ``device_trace`` (``TPUDAS_TRACE_DIR``)
or the ``/profile`` capture, which carry every thread's program spans
as ``tpudas_span`` events.  The device is busy in the union of its
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; each idle gap
between the first and the last event of the trace is charged to the
innermost program span open at the gap's middle on any thread (the
deepest, then the latest started), or to ``(no span)``.
"""

from __future__ import annotations

import argparse
import json
import sys

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "tpudas_span"
NO_SPAN = "(no span)"


def load(path) -> tuple:
    """([(start_us, end_us)] device events, [(name, depth, start_us,
    end_us)] program spans) of the trace at ``path``."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    dev, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        if ev.get("cat") in DEVICE_KINDS:
            dev.append((s, e))
        elif ev.get("cat") == SPAN_CAT:
            spans.append((ev["name"], int(ev["args"].get("depth", 0)), s, e))
    return dev, spans


def idle_by_span(dev, spans) -> dict:
    """{"window_s", "busy_s", "idle": {span name: seconds}} over the
    extent of every event."""
    ends = [(s, e) for s, e in dev] + [(s, e) for _n, _d, s, e in spans]
    if not ends:
        return {"window_s": 0.0, "busy_s": 0.0, "idle": {}}
    w0, w1 = min(s for s, _ in ends), max(e for _, e in ends)
    busy = []
    for s, e in sorted(dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2
            inside = [sp for sp in spans if sp[2] <= mid <= sp[3]]
            label = (max(inside, key=lambda sp: (sp[1], sp[2]))[0]
                     if inside else NO_SPAN)
            idle[label] = idle.get(label, 0.0) + (s - prev) / 1e6
        prev = max(prev, e)
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "idle": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = idle_by_span(*load(args.trace))
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"window {out['window_s']:.6f} s, device busy "
          f"{out['busy_s']:.6f} s")
    for name, sec in out["idle"].items():
        print(f"{sec:12.6f} s  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
