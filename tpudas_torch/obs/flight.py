"""Crash-surviving flight recorder: a bounded, segmented on-disk ring
of spans, round-phase records and faults beside the stream carry.

The port's counterpart of :mod:`tpudas.obs.flight`, with the same
on-disk format byte for byte, so either package reads, audits and
continues the other's ring.  The in-memory span ring
(:mod:`tpudas_torch.obs.trace`) dies with the process, and SIGKILL is
the expected failure mode of a crash-only design: exactly when an
operator most needs the last rounds' trace.  The recorder keeps a small
ring under ``<output_folder>/.flight/``:

- **Records** are JSONL lines, one object per line, each stamped with
  an embedded ``_crc32`` over its canonical dump (``json.dumps(rec,
  sort_keys=True, separators=(",", ":"), default=str)``).  A record
  carries ``kind`` (``span`` / ``round`` / ``fault`` / ``event``),
  ``ts`` (unix seconds) and the kind's fields.  ``default=str`` turns
  any value JSON cannot hold into a string, so callers hand the
  recorder plain Python numbers, never numpy or torch scalars.
- **Segments** are append-only files ``seg-NNNNNNNN.jsonl``; when the
  current segment exceeds ``max_segment_bytes``
  (``TPUDAS_FLIGHT_SEGMENT_BYTES``, default 256 KiB) the writer rotates
  to the next number and deletes the oldest beyond ``max_segments``
  (``TPUDAS_FLIGHT_SEGMENTS``, default 8): a months-long stream keeps a
  bounded window of recent history.
- **Writes are buffered and flushed once per committed round** (one
  ``write()`` per flush).  A SIGKILL mid-flush tears at most the tail
  of the newest segment; :func:`read_flight` verifies every line's crc
  and stops cleanly at the torn tail.  A round's spans are buffered
  before its ``round`` record, so a surviving ``round`` record implies
  its spans survived.
- **Sheddable** under disk pressure (:mod:`tpudas_torch.integrity.resource`):
  a flush drops its buffer (counted, never raised) and the stream goes
  on; a failed write notes pressure and sheds the same way.  Every
  flush passes the ``obs.flight_write`` fault site.
- **Audited**: :func:`tpudas_torch.integrity.audit.audit` truncates
  each segment to its verified prefix.

Span capture is scoped, not global: :func:`capture` installs a recorder
as the current thread's span sink, so in a fleet each runner's step
records only its own stream's spans, and spans of other threads (the
ingest prefetch thread) stay in the process ring.  Spans deeper than
``TPUDAS_FLIGHT_SPAN_DEPTH`` (default 2) below the capture scope stay in
the process ring only.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from contextlib import contextmanager

from tpudas_torch.obs.registry import get_registry

__all__ = [
    "FLIGHT_DIRNAME",
    "SEGMENT_RE",
    "FlightRecorder",
    "capture",
    "flight_dir",
    "read_flight",
    "scan_segment",
    "segment_paths",
]

FLIGHT_DIRNAME = ".flight"
SEGMENT_RE = re.compile(r"^seg-(\d{8})\.jsonl$")

_DEFAULT_SEGMENT_BYTES = 262144  # 256 KiB per segment
_DEFAULT_SEGMENTS = 8  # bounded ring: ~2 MiB of recent history
_BUFFER_FLUSH_RECORDS = 512  # mid-round safety flush threshold
# spans deeper than this stay in the in-memory ring only: the
# post-crash questions are round-shaped (stream.round, carry_save,
# pyramid/detect hooks — depth 0/1), and per-block op spans at depth
# 2+ would multiply the ring's write volume for no replay value
_DEFAULT_SPAN_DEPTH = 2


def flight_dir(folder) -> str:
    return os.path.join(str(folder), FLIGHT_DIRNAME)


def segment_paths(folder) -> list:
    """Existing segment paths under ``folder``'s flight dir, oldest
    first (numeric order)."""
    fdir = flight_dir(folder)
    try:
        names = os.listdir(fdir)
    except OSError:
        return []
    segs = sorted(n for n in names if SEGMENT_RE.match(n))
    return [os.path.join(fdir, n) for n in segs]


def _max_segment_bytes() -> int:
    try:
        v = int(os.environ.get(
            "TPUDAS_FLIGHT_SEGMENT_BYTES", _DEFAULT_SEGMENT_BYTES
        ))
    except ValueError:
        v = _DEFAULT_SEGMENT_BYTES
    return max(4096, v)


def _max_segments() -> int:
    try:
        v = int(os.environ.get("TPUDAS_FLIGHT_SEGMENTS", _DEFAULT_SEGMENTS))
    except ValueError:
        v = _DEFAULT_SEGMENTS
    return max(2, v)


# ---------------------------------------------------------------------------
# scoped span capture (thread-local: fleet steps are serialized per
# thread, so each runner's spans land in its own stream's recorder)

_tls = threading.local()
_sink_installed = False
_sink_lock = threading.Lock()


def _span_depth_cap() -> int:
    try:
        return int(os.environ.get(
            "TPUDAS_FLIGHT_SPAN_DEPTH", _DEFAULT_SPAN_DEPTH
        ))
    except ValueError:
        return _DEFAULT_SPAN_DEPTH


def _span_sink(rec: dict) -> None:
    r = getattr(_tls, "recorder", None)
    if r is None:
        return
    # depth RELATIVE to the capture scope: a fleet step's spans nest
    # under fleet.run/fleet.step, a bare driver's do not — the cap
    # (and the recorded depth) must mean the same thing in both
    depth = rec["depth"] - getattr(_tls, "base_depth", 0)
    if depth >= _span_depth_cap():
        return
    fields = dict(rec.get("attrs") or {})
    fields["name"] = rec["name"]
    fields["depth"] = depth
    fields["dur_s"] = round(rec.get("duration_s", 0.0), 6)
    if "error" in rec:
        fields["error"] = rec["error"]
    r.record("span", **fields)


def _ensure_sink() -> None:
    global _sink_installed
    if _sink_installed:
        return
    with _sink_lock:
        if not _sink_installed:
            from tpudas_torch.obs.trace import add_span_sink

            add_span_sink(_span_sink)
            _sink_installed = True


@contextmanager
def capture(recorder):
    """Route this thread's finished spans into ``recorder`` for the
    scope (``recorder=None`` is a no-op — callers need no branch)."""
    if recorder is None:
        yield
        return
    _ensure_sink()
    from tpudas_torch.obs.trace import _span_stack

    prev = getattr(_tls, "recorder", None)
    prev_base = getattr(_tls, "base_depth", 0)
    _tls.recorder = recorder
    _tls.base_depth = len(_span_stack())
    try:
        yield
    finally:
        _tls.recorder = prev
        _tls.base_depth = prev_base


# ---------------------------------------------------------------------------
# the writer


class FlightRecorder:
    """Buffered writer over one folder's segmented flight ring.

    ``record()`` buffers; ``flush()`` appends the buffer to the
    current segment in ONE write (rotating/pruning first when the
    segment is full).  Failures never raise — a trace must not take
    down the stream it describes."""

    def __init__(self, folder, max_segment_bytes=None, max_segments=None):
        self.folder = str(folder)
        self.dir = flight_dir(folder)
        self.max_segment_bytes = (
            _max_segment_bytes() if max_segment_bytes is None
            else max(4096, int(max_segment_bytes))
        )
        self.max_segments = (
            _max_segments() if max_segments is None
            else max(2, int(max_segments))
        )
        self._buf: list = []
        self._pending: dict = {}  # per-kind counts since last flush
        self._lock = threading.Lock()
        self._fh = None  # open append handle (reopened on rotation)
        # resume the ring where the last process left it: append to the
        # newest existing segment (crash-only — no open handles, no
        # in-memory state to lose)
        self._seg_index = 0
        self._seg_bytes = 0
        segs = segment_paths(self.folder)
        if segs:
            newest = segs[-1]
            self._seg_index = int(
                SEGMENT_RE.match(os.path.basename(newest)).group(1)
            )
            try:
                self._seg_bytes = os.path.getsize(newest)
                # a segment whose last byte is not a newline ends in a
                # torn line (crash mid-write, no audit yet): appending
                # onto it would merge the torn tail into OUR first
                # record and silently lose it — rotate instead (the
                # audit later truncates the torn segment in place)
                if self._seg_bytes:
                    with open(newest, "rb") as fh:
                        fh.seek(-1, os.SEEK_END)
                        if fh.read(1) != b"\n":
                            self._seg_bytes = self.max_segment_bytes
            except OSError:
                self._seg_bytes = self.max_segment_bytes

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.dir, f"seg-{index:08d}.jsonl")

    # -- recording -----------------------------------------------------
    def record(self, kind: str, /, **fields) -> None:
        """Buffer one record (written at the next :meth:`flush`).

        Hot path: ONE canonical ``json.dumps`` per record — the
        ``_crc32`` stamp is spliced onto the canonical dump (sorted
        keys, compact separators), which is byte-identical to what
        :func:`tpudas_torch.integrity.checksum.verify_json_obj` recomputes
        at read time, so the stamp verifies without a second
        serialization.  Per-kind counters are batched into the flush
        (one inc per kind per round, not per record)."""
        from tpudas_torch.integrity.checksum import crc32_hex

        # envelope keys win: a field named "kind"/"ts" cannot corrupt
        # the record's type or timestamp
        rec = {**fields, "kind": str(kind), "ts": round(time.time(), 3)}
        try:
            body = json.dumps(
                rec, sort_keys=True, separators=(",", ":"), default=str
            )
        except Exception:
            self._drop(1, "encode")
            return
        crc = crc32_hex(body.encode())
        line = f'{{"_crc32":"{crc}",{body[1:]}'
        with self._lock:
            self._buf.append(line)
            self._pending[kind] = self._pending.get(kind, 0) + 1
            n = len(self._buf)
        if n >= _BUFFER_FLUSH_RECORDS:
            self.flush()

    def _drop(self, n: int, reason: str) -> None:
        reg = get_registry()
        reg.counter(
            "tpudas_obs_flight_drops_total",
            "flight-recorder records dropped (shed under disk "
            "pressure, or a failed write)",
            labelnames=("reason",),
        ).inc(n, reason=reason)
        reg.counter(
            "tpudas_obs_events_dropped_total",
            "observability events lost before reaching their sink "
            "(log_event handler failures, flight-recorder drops)",
            labelnames=("reason",),
        ).inc(n, reason=f"flight_{reason}")

    def flush(self) -> int:
        """Append the buffer to the ring in one write.  Returns the
        number of records written (0 = empty buffer or shed/failed —
        counted, never raised)."""
        with self._lock:
            if not self._buf:
                return 0
            lines, self._buf = self._buf, []
            pending, self._pending = self._pending, {}
        from tpudas_torch.integrity import resource as _resource

        n = len(lines)
        if _resource.should_shed("flight"):
            self._drop(n, "shed")
            return 0
        payload = "\n".join(lines) + "\n"
        data = payload.encode()
        try:
            from tpudas_torch.resilience.faults import fault_point

            fault_point("obs.flight_write", path=self.dir)
            if self._seg_bytes >= self.max_segment_bytes:
                self._rotate()
            if self._fh is None:
                os.makedirs(self.dir, exist_ok=True)
                # one handle held across flushes (O_APPEND — the per-
                # flush open/close tripled the recorder's cost); every
                # flush still reaches the OS before returning
                self._fh = open(self._seg_path(self._seg_index), "ab")
            self._fh.write(data)
            self._fh.flush()
        except Exception as exc:
            if _resource.is_resource_error(exc):
                _resource.note_pressure("flight", exc)
            self._close_handle()
            # the failed write may have landed PARTIAL bytes (a torn
            # trailing line): force a rotation so the next flush opens
            # a fresh segment instead of appending onto the tear
            self._seg_bytes = self.max_segment_bytes
            self._drop(n, "error")
            return 0
        self._seg_bytes += len(data)
        reg = get_registry()
        records = reg.counter(
            "tpudas_obs_flight_records_total",
            "flight-recorder records written, by kind",
            labelnames=("kind",),
        )
        for kind, count in pending.items():
            records.inc(count, kind=kind)
        reg.counter(
            "tpudas_obs_flight_bytes_total",
            "bytes appended to flight-recorder segments",
        ).inc(len(data))
        return n

    def _close_handle(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _rotate(self) -> None:
        """Open the next segment and prune the ring to
        ``max_segments`` (oldest removed first)."""
        self._close_handle()
        self._seg_index += 1
        self._seg_bytes = 0
        get_registry().counter(
            "tpudas_obs_flight_rotations_total",
            "flight-recorder segment rotations",
        ).inc()
        segs = segment_paths(self.folder)
        # the segment about to be created counts against the bound
        excess = len(segs) + 1 - self.max_segments
        for path in segs[:max(excess, 0)]:
            try:
                os.remove(path)
            except OSError:
                pass
        get_registry().gauge(
            "tpudas_obs_flight_segments",
            "flight-recorder segments currently on disk",
        ).set(min(len(segs) + 1, self.max_segments))

    def close(self) -> None:
        self.flush()
        self._close_handle()


# ---------------------------------------------------------------------------
# readers


def scan_segment(path: str) -> tuple:
    """Parse one segment: ``(records, good_lines, bad_count)``.

    Verifies each line's embedded crc32; unparseable or mismatched
    lines (a SIGKILL-torn tail, bit rot) are counted and skipped —
    the verified prefix is returned in file order.  ``good_lines``
    are the raw verified lines, reusable verbatim by the audit's
    truncate repair.  Raises ``OSError`` when the file itself cannot
    be read."""
    from tpudas_torch.integrity.checksum import strip_stamp, verify_json_obj

    records, good_lines, bad = [], [], 0
    with open(path, "rb") as fh:
        raw = fh.read()
    for line in raw.decode(errors="replace").splitlines():
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            bad += 1
            continue
        if verify_json_obj(obj) != "ok":
            bad += 1
            continue
        records.append(strip_stamp(obj))
        good_lines.append(line)
    return records, good_lines, bad


def read_flight(folder, kind=None, name=None, limit=None) -> list:
    """Verified flight records for ``folder``, oldest first, optionally
    filtered by record ``kind`` (``span``/``round``/``fault``/...) and
    span ``name``.  ``limit`` keeps the NEWEST matching records and
    bounds IO: segments are scanned newest-first and the walk stops as
    soon as the limit is met.  Torn/corrupt lines are counted
    (``tpudas_obs_flight_torn_records_total``) and skipped — after a
    SIGKILL this returns exactly the flushed (committed-round)
    prefix."""
    if limit is not None:
        limit = max(int(limit), 0)
        if limit == 0:
            return []
    out: list = []
    torn = 0
    for path in reversed(segment_paths(folder)):
        try:
            records, _lines, bad = scan_segment(path)
        except OSError:
            torn += 1
            continue
        torn += bad
        if kind is not None:
            records = [r for r in records if r.get("kind") == kind]
        if name is not None:
            records = [r for r in records if r.get("name") == name]
        out = records + out
        if limit is not None and len(out) >= limit:
            break
    if torn:
        get_registry().counter(
            "tpudas_obs_flight_torn_records_total",
            "flight-recorder lines rejected by readers (torn tail "
            "after a crash, bit rot) and skipped",
        ).inc(torn)
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out
