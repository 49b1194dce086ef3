"""Startup audit / repair ("fsck") for one output folder's durable state.

The port's counterpart of :mod:`tpudas.integrity.audit`, with the same
report, repairs, metrics and span.  The realtime runners call
:func:`audit` once at startup — before the first round, before the
quarantine ledger loads — and ``tpudas_torch/tools/fsck.py`` exposes it
as an operator CLI.  It scans every durable artifact the port's
pipeline writes beside the stream, and the JSON artifacts the JAX
driver may have left in a folder:

==================  =====================================================
artifact            files
==================  =====================================================
``carry``           ``.stream_carry.npz`` (+ ``.crc``/``.prev``) and the
                    ``.stream_carry.json`` sidecar
``quarantine``      ``.quarantine.json`` (+ ``.prev``)
``health``          ``health.json`` (+ ``.prev``)
``index``           ``.tpudas_index.json`` (+ ``.prev``)
``output``          ``LFDAS_*.h5`` files newer than the carry's last
                    emitted sample
``detect_carry``    ``.detect/carry.npz`` (+ ``.crc``/``.prev``)
``events``          ``.detect/events.jsonl`` (+ ``.prev``) — per-line
                    crc32 stamps, contiguous ``seq``
``scores``          ``.detect/scores/manifest.json`` (+ ``.prev``),
                    ``.detect/scores/tails.npy``,
                    ``.detect/scores/NNNNNNNN.npy``
``tmp``             any ``*.tmp`` / ``*.tmp.<pid>`` leftover anywhere in
                    the tree (a crashed writer's half file)
==================  =====================================================

and classifies each as ``ok`` (not reported), ``unstamped`` (no
checksum yet), ``torn`` (crc32 mismatch — a torn or partial write, or
bit rot), ``corrupt`` (does not parse, or is inconsistent),
``stale_tmp`` or ``orphan`` (a score tile beyond the manifest that also
fails verification).  With ``repair=True`` (the default) it then fixes
what it can:

- stale tmp files are **removed** (regenerable by construction);
- unstamped but parseable artifacts are **restamped** in place;
- a bad primary with a good ``.prev`` is **promoted** (the readers'
  runtime fallback, made durable);
- a bad primary with no good ``.prev`` is **removed**: every reader
  treats absence safely (carry → rewind, ledger → empty, health →
  regenerated, index → rescan);
- a torn output beyond the carry is **removed** (the resume writes it
  again, byte for byte);
- detect artifacts follow the same ladder with their own last rung: a
  ledger or score surplus beyond the detect carry is **truncated** back
  to the carry's commit point, and anything unreconcilable — both
  ledger rungs bad, the carry unreadable, committed score rows missing
  — **resets** ``.detect/``: the detection history is derived data and
  recomputes from the output files.

Not ported yet: the tile pyramid's check and rebuild (``.tiles/``) and
the flight recorder's segment repair (``.flight/``) come with those
features; until then the audit leaves both trees alone, apart from the
tmp sweep.  The backfill queue's audits come with the backfill.

Run the CLI only while the driver is stopped (the tmp sweep cannot
tell a crashed writer's leftovers from a live writer's in-flight
file); the runner's own startup call cannot race anything because its
writers have not started.  A second audit right after a repairing one
reports ``clean`` with zero issues.

Fleets: a :class:`tpudas_torch.fleet.FleetEngine` root holds one output
folder per stream (``root/<stream_id>/``); :func:`audit_fleet` runs the
same audit over every stream root and aggregates the reports, each
stream classified and repaired on its own.
"""

from __future__ import annotations

import os
import re
import time

from tpudas_torch.integrity.checksum import (
    read_json_verified,
    sidecar_path,
    verify_file_checksum,
    write_json_checksummed,
    write_sidecar_for,
)
from tpudas_torch.obs.registry import get_registry
from tpudas_torch.obs.trace import span
from tpudas_torch.utils.atomicio import is_tmp_name
from tpudas_torch.utils.logging import log_event

__all__ = ["audit", "audit_fleet", "fleet_stream_dirs"]

_TILE_NAME_RE = re.compile(r"^(\d{8})\.npy$")


def _issue(issues, artifact, path, status, action, detail=""):
    issues.append(
        {
            "artifact": artifact,
            "path": str(path),
            "status": status,
            "action": action,
            "detail": str(detail)[:200],
        }
    )


def _repair_action(repair: bool, action: str) -> str:
    return action if repair else "found"


def _promote_prev(path: str) -> None:
    """Replace a bad primary with its good ``.prev`` (sidecar
    included)."""
    for p in (path, sidecar_path(path)):
        if os.path.isfile(p):
            os.remove(p)
    os.replace(path + ".prev", path)
    prev_side = sidecar_path(path + ".prev")
    if os.path.isfile(prev_side):
        os.replace(prev_side, sidecar_path(path))


def _remove_all(*paths) -> None:
    for p in paths:
        if os.path.isfile(p):
            os.remove(p)


# ---------------------------------------------------------------------------
# per-artifact checks

def _sweep_tmp(folder: str, issues: list, repair: bool) -> None:
    for dirpath, _dirnames, filenames in os.walk(folder):
        for name in sorted(filenames):
            if not is_tmp_name(name):
                continue
            path = os.path.join(dirpath, name)
            if repair:
                try:
                    os.remove(path)
                except OSError as exc:
                    _issue(issues, "tmp", path, "stale_tmp", "failed", exc)
                    continue
            _issue(
                issues, "tmp", path, "stale_tmp",
                _repair_action(repair, "removed"),
            )


def _json_status(path: str, artifact: str, validate=None) -> tuple:
    """(status, payload_or_None, detail): status in ok | unstamped |
    torn | corrupt | absent."""
    if not os.path.isfile(path):
        return "absent", None, ""
    try:
        payload, status = read_json_verified(path, artifact)
    except Exception as exc:
        return "corrupt", None, f"{type(exc).__name__}: {str(exc)[:120]}"
    if status == "mismatch":
        return "torn", payload, "crc32 mismatch"
    try:
        if validate is not None:
            validate(payload)
    except Exception as exc:
        return "corrupt", payload, f"{type(exc).__name__}: {str(exc)[:120]}"
    return ("unstamped" if status == "unstamped" else "ok"), payload, ""


def _check_json_artifact(
    path: str, artifact: str, issues: list, repair: bool, validate=None
) -> None:
    """The shared JSON ladder repair: restamp unstamped, promote a good
    ``.prev`` over a torn/corrupt primary, remove what nothing can
    save (absence is safe for every JSON artifact)."""
    prev = path + ".prev"
    status, payload, detail = _json_status(path, artifact, validate)
    if status == "ok":
        pass
    elif status == "absent":
        # a lone .prev is the crash window between the save's rotate
        # and write: promote a good one, remove a bad one — either
        # way the NEXT audit (and every runtime read) finds nothing
        # to fall back over
        if os.path.isfile(prev):
            p_status, p_payload, p_detail = _json_status(
                prev, artifact, validate
            )
            if p_status in ("ok", "unstamped"):
                if repair:
                    os.replace(prev, path)
                    if p_status == "unstamped":
                        write_json_checksummed(path, p_payload)
                _issue(
                    issues, artifact, prev, "torn",
                    _repair_action(repair, "promoted_prev"),
                    "orphaned .prev (primary missing)",
                )
            else:
                if repair:
                    _remove_all(prev)
                _issue(
                    issues, artifact, prev, p_status,
                    _repair_action(repair, "removed"), p_detail,
                )
        return
    elif status == "unstamped":
        if repair:
            write_json_checksummed(path, payload)
        _issue(
            issues, artifact, path, "unstamped",
            _repair_action(repair, "restamped"),
        )
    else:  # torn | corrupt
        p_status, p_payload, _ = _json_status(prev, artifact, validate)
        if p_status in ("ok", "unstamped"):
            if repair:
                os.remove(path)
                os.replace(prev, path)
                if p_status == "unstamped":
                    write_json_checksummed(path, p_payload)
            _issue(
                issues, artifact, path, status,
                _repair_action(repair, "promoted_prev"), detail,
            )
        else:
            # both rungs bad: BOTH must go, or the runtime ladder
            # keeps tripping (counted, degraded) over the corpse of
            # the .prev after a "clean" fsck
            if repair:
                _remove_all(path, prev)
            _issue(
                issues, artifact, path, status,
                _repair_action(repair, "removed"), detail,
            )
        return
    # a bad .prev behind a healthy primary is dead weight: sweep it
    if os.path.isfile(prev):
        p_status, _p, p_detail = _json_status(prev, artifact, validate)
        if p_status in ("torn", "corrupt"):
            if repair:
                _remove_all(prev)
            _issue(
                issues, artifact, prev, p_status,
                _repair_action(repair, "removed"), p_detail,
            )


def _carry_status(path: str) -> tuple:
    """(status, carry_or_None, detail) for one carry ``.npz`` rung."""
    from tpudas_torch.proc.stream import _parse_carry

    if not os.path.isfile(path):
        return "absent", None, ""
    try:
        crc = verify_file_checksum(path, artifact="carry")
    except FileNotFoundError:
        return "absent", None, ""
    try:
        carry = _parse_carry(path)
    except Exception as exc:
        status = "torn" if crc == "mismatch" else "corrupt"
        return status, None, f"{type(exc).__name__}: {str(exc)[:120]}"
    if crc == "mismatch":
        return "torn", None, "crc32 mismatch"
    return ("unstamped" if crc == "unstamped" else "ok"), carry, ""


def _check_carry(folder: str, issues: list, repair: bool) -> None:
    from tpudas_torch.proc.stream import CARRY_FILENAME, CARRY_SIDECAR

    path = os.path.join(folder, CARRY_FILENAME)
    side = os.path.join(folder, CARRY_SIDECAR)
    status, carry, detail = _carry_status(path)
    if status == "unstamped":
        if repair:
            write_sidecar_for(path)
        _issue(
            issues, "carry", path, "unstamped",
            _repair_action(repair, "restamped"),
        )
        status = "ok"
    if status in ("torn", "corrupt"):
        p_status, p_carry, _ = _carry_status(path + ".prev")
        if p_status in ("ok", "unstamped"):
            if repair:
                _promote_prev(path)
                if p_status == "unstamped":
                    write_sidecar_for(path)
                carry = p_carry
            _issue(
                issues, "carry", path, status,
                _repair_action(repair, "promoted_prev"), detail,
            )
        else:
            if repair:
                _remove_all(
                    path, sidecar_path(path), path + ".prev",
                    sidecar_path(path + ".prev"), side,
                )
            _issue(
                issues, "carry", path, status,
                _repair_action(repair, "removed"), detail,
            )
            return
    elif status == "absent":
        # a lone .prev is the crash window between the save's rotate
        # and write: promote a good one (the state load_carry would
        # resume from anyway), remove a bad one
        if os.path.isfile(path + ".prev"):
            p_status, p_carry, p_detail = _carry_status(path + ".prev")
            if p_status in ("ok", "unstamped"):
                if repair:
                    _promote_prev(path)
                    if p_status == "unstamped":
                        write_sidecar_for(path)
                    carry = p_carry
                _issue(
                    issues, "carry", path + ".prev", "torn",
                    _repair_action(repair, "promoted_prev"),
                    "orphaned .prev (primary missing)",
                )
                if carry is not None and repair:
                    write_json_checksummed(side, carry._meta())
                return
            if repair:
                _remove_all(
                    path + ".prev", sidecar_path(path + ".prev"), side
                )
            _issue(
                issues, "carry", path + ".prev", p_status,
                _repair_action(repair, "removed"), p_detail,
            )
            return
        # a sidecar with no carry is leftover state
        if os.path.isfile(side):
            if repair:
                _remove_all(side)
            _issue(
                issues, "carry", side, "corrupt",
                _repair_action(repair, "removed"), "sidecar without carry",
            )
        return
    # the human-readable sidecar: cosmetic, regenerable from the meta
    if carry is not None:
        s_status, _p, s_detail = _json_status(side, "carry")
        if s_status in ("torn", "corrupt", "absent", "unstamped"):
            if repair:
                write_json_checksummed(side, carry._meta())
            if s_status != "absent":
                _issue(
                    issues, "carry", side, s_status,
                    _repair_action(repair, "rewritten"), s_detail,
                )


def _parse_lfdas_t0(name: str):
    """ns int of the start time encoded in an ``LFDAS_<t0>_<t1>.h5``
    output name (tpudas_torch.proc.naming), or None."""
    import numpy as np

    try:
        stem = name.split("_")[1]
        date, tod = stem.split("T")
        iso = f"{date}T{tod[0:2]}:{tod[2:4]}:{tod[4:]}"
        return int(
            np.datetime64(iso).astype("datetime64[ns]").astype(np.int64)
        )
    except Exception:
        return None


def _check_outputs(folder: str, issues: list, repair: bool) -> None:
    """Sweep torn OUTPUT files a SIGKILL left mid-HDF5-write.  Scoped
    to files strictly newer than the carry's last emitted sample: those
    are exactly the ones the stateful resume regenerates byte-identically
    (the same rule :func:`tpudas_torch.proc.stream.reconcile_outputs` applies
    — but reconcile only sees files that SCAN, and a torn file does
    not, so it would linger as unreadable garbage forever).  Without a
    carry nothing is provably regenerable, so nothing is touched."""
    from tpudas_torch.io.registry import scan_file
    from tpudas_torch.proc.stream import CARRY_FILENAME

    status, carry, _ = _carry_status(os.path.join(folder, CARRY_FILENAME))
    if status != "ok" or carry is None:
        return
    cutoff = carry.last_emit_ns  # None = nothing emitted: all stale
    for name in sorted(os.listdir(folder)):
        if not (name.startswith("LFDAS_") and name.endswith(".h5")):
            continue
        t0 = _parse_lfdas_t0(name)
        if t0 is None or (cutoff is not None and t0 <= cutoff):
            continue
        path = os.path.join(folder, name)
        try:
            scan_file(path, format="dasdae")
            continue  # readable: reconcile_outputs owns it
        except Exception as exc:
            detail = f"{type(exc).__name__}: {str(exc)[:120]}"
        if repair:
            _remove_all(path)
        _issue(
            issues, "output", path, "torn",
            _repair_action(repair, "removed"), detail,
        )


# ---------------------------------------------------------------------------
# detect artifacts (tpudas_torch.detect: carry + events ledger + score tiles)

def _detect_carry_status(path: str) -> tuple:
    """(status, parsed_or_None, detail) for one detect-carry rung."""
    from tpudas_torch.detect.runner import _parse_detect_carry

    if not os.path.isfile(path):
        return "absent", None, ""
    try:
        crc = verify_file_checksum(path, artifact="detect_carry")
    except FileNotFoundError:
        return "absent", None, ""
    try:
        parsed = _parse_detect_carry(path)
    except Exception as exc:
        status = "torn" if crc == "mismatch" else "corrupt"
        return status, None, f"{type(exc).__name__}: {str(exc)[:120]}"
    if crc == "mismatch":
        return "torn", None, "crc32 mismatch"
    return ("unstamped" if crc == "unstamped" else "ok"), parsed, ""


def _ledger_file_status(path: str) -> tuple:
    """(status, events_or_None, detail) for one ledger rung: ok |
    unstamped | torn | corrupt | absent."""
    from tpudas_torch.detect.ledger import ledger_status_text

    if not os.path.isfile(path):
        return "absent", None, ""
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as exc:
        return "corrupt", None, f"{type(exc).__name__}: {str(exc)[:120]}"
    status, events = ledger_status_text(text)
    return ("torn" if status == "torn" else status), events, (
        "bad line / crc mismatch / seq gap" if status == "torn" else ""
    )


def _reset_detect_state(folder, issues, repair, path, status, detail):
    """The detect repair of last resort: remove ``.detect/`` — the
    history recomputes deterministically from the output files."""
    if repair:
        from tpudas_torch.detect.runner import reset_detect

        reset_detect(folder, f"audit: {detail or status}")
    _issue(
        issues, "detect", path, status,
        _repair_action(repair, "reset_detect"), detail,
    )


def _check_detect(folder: str, issues: list, repair: bool) -> None:
    from tpudas_torch.detect.ledger import (
        DETECT_DIRNAME,
        LEDGER_FILENAME,
        ScoreStore,
        write_events,
    )
    from tpudas_torch.detect.runner import DETECT_CARRY_FILENAME

    det = os.path.join(folder, DETECT_DIRNAME)
    if not os.path.isdir(det):
        return
    if not os.listdir(det):
        return  # an empty shell (partial creation) is not an issue
    # --- the carry (the subsystem's single commit point) -------------
    carry_path = os.path.join(det, DETECT_CARRY_FILENAME)
    status, parsed, detail = _detect_carry_status(carry_path)
    if status == "unstamped":
        if repair:
            write_sidecar_for(carry_path)
        _issue(
            issues, "detect_carry", carry_path, "unstamped",
            _repair_action(repair, "restamped"),
        )
        status = "ok"
    if status in ("torn", "corrupt", "absent"):
        p_status, p_parsed, p_detail = _detect_carry_status(
            carry_path + ".prev"
        )
        if p_status in ("ok", "unstamped"):
            if repair:
                _promote_prev(carry_path)
                if p_status == "unstamped":
                    write_sidecar_for(carry_path)
            parsed = p_parsed
            _issue(
                issues, "detect_carry", carry_path,
                "torn" if status == "absent" else status,
                _repair_action(repair, "promoted_prev"),
                detail or "orphaned .prev (primary missing)",
            )
        elif status == "absent" and p_status == "absent":
            # artifacts without any carry cannot be trusted (which
            # rows do they cover?)
            _reset_detect_state(
                folder, issues, repair, det, "corrupt",
                "detect artifacts without a carry",
            )
            return
        else:
            _reset_detect_state(
                folder, issues, repair, carry_path, status, detail
            )
            return
    committed_seq = int(parsed["meta"]["ledger_seq"])
    committed_rows = int(parsed["meta"]["score_rows"])
    # --- the events ledger -------------------------------------------
    ledger = os.path.join(det, LEDGER_FILENAME)
    l_status, events, l_detail = _ledger_file_status(ledger)
    if l_status in ("torn", "corrupt", "absent"):
        p_status, p_events, _pd = _ledger_file_status(ledger + ".prev")
        if p_status in ("ok", "unstamped"):
            if repair:
                _promote_prev(ledger)
            events = p_events
            _issue(
                issues, "events", ledger,
                "torn" if l_status == "absent" else l_status,
                _repair_action(repair, "promoted_prev"), l_detail,
            )
            l_status = p_status
        elif committed_seq == 0:
            # zero committed events is a HEALTHY state with no ledger
            # file at all (a commit that has never seen an event never
            # writes one) — absence is not a defect, and a bad rung is
            # repaired by truncating back to absence, never by
            # resetting the carry and score tiles
            if l_status != "absent":
                if repair:
                    _remove_all(ledger)
                _issue(
                    issues, "events", ledger, l_status,
                    _repair_action(repair, "removed"), l_detail,
                )
            events = []
            l_status = "ok"
        else:
            _reset_detect_state(
                folder, issues, repair, ledger, l_status or "corrupt",
                l_detail or "no loadable ledger rung",
            )
            return
    if l_status == "unstamped":
        if repair:
            write_events(folder, events)
        _issue(
            issues, "events", ledger, "unstamped",
            _repair_action(repair, "restamped"),
        )
    if len(events) < committed_seq:
        _reset_detect_state(
            folder, issues, repair, ledger, "corrupt",
            f"ledger holds {len(events)} events, carry committed "
            f"{committed_seq}",
        )
        return
    if len(events) > committed_seq:
        # a crashed commit's surplus — the runner's resume truncation,
        # made durable (the lines regenerate identically on replay)
        if repair:
            write_events(folder, events[:committed_seq])
        _issue(
            issues, "events", ledger, "torn",
            _repair_action(repair, "truncated"),
            f"{len(events) - committed_seq} uncommitted events",
        )
    # a bad .prev behind a healthy primary is dead weight: sweep it
    prev = ledger + ".prev"
    if os.path.isfile(prev):
        p_status, _pe, p_detail = _ledger_file_status(prev)
        if p_status in ("torn", "corrupt"):
            if repair:
                _remove_all(prev)
            _issue(
                issues, "events", prev, p_status,
                _repair_action(repair, "removed"), p_detail,
            )
    # --- the score tiles ---------------------------------------------
    scores_dir = ScoreStore.scores_dir(folder)
    if not os.path.isdir(scores_dir):
        if committed_rows > 0:
            _reset_detect_state(
                folder, issues, repair, scores_dir, "corrupt",
                f"carry committed {committed_rows} score rows but no "
                "score store exists",
            )
        return
    from tpudas_torch.detect.ledger import (
        SCORES_MANIFEST,
        validate_scores_manifest,
    )

    manifest = os.path.join(scores_dir, SCORES_MANIFEST)
    _check_json_artifact(
        manifest, "scores_manifest", issues, repair,
        validate=validate_scores_manifest,
    )
    try:
        store = ScoreStore.open(folder)
    except Exception as exc:
        # e.g. CorruptDetectError: committed tail rows unrecoverable
        # (torn tails with no completed head tile) — the audit must
        # classify and reset, never crash the fsck
        _reset_detect_state(
            folder, issues, repair, scores_dir, "torn",
            f"{type(exc).__name__}: {str(exc)[:120]}",
        )
        return
    if store is None or store.n_rows < committed_rows:
        _reset_detect_state(
            folder, issues, repair, scores_dir, "corrupt",
            "score store cannot supply the carry's committed rows",
        )
        return
    # tiles + tails: restamp legacy, classify bad ones; an IN-USE bad
    # artifact is unreconcilable (scores are not rebuildable without
    # replaying rows) -> reset; an orphan beyond the manifest is swept
    n_full = len(store.tile_t0_rel)
    for name in sorted(os.listdir(scores_dir)):
        m = _TILE_NAME_RE.match(name)
        is_tails = name == "tails.npy"
        if m is None and not is_tails:
            continue
        path = os.path.join(scores_dir, name)
        try:
            crc = verify_file_checksum(path, artifact="scores_tile")
        except FileNotFoundError:
            continue
        ok_parse = True
        if crc != "mismatch":
            try:
                import numpy as np

                np.load(path)
            except Exception:
                ok_parse = False
        if crc == "ok" and ok_parse:
            continue
        if crc == "unstamped" and ok_parse:
            if repair:
                write_sidecar_for(path)
            _issue(
                issues, "scores", path, "unstamped",
                _repair_action(repair, "restamped"),
            )
            continue
        bad_status = "torn" if crc == "mismatch" else "corrupt"
        in_use = is_tails or int(m.group(1)) < n_full
        if is_tails and (committed_rows % store.tile_len) == 0:
            in_use = False  # no committed partial rows ride the tails
        if in_use:
            _reset_detect_state(
                folder, issues, repair, path, bad_status,
                "in-use score artifact failed verification",
            )
            return
        if repair:
            _remove_all(path, sidecar_path(path))
        _issue(
            issues, "scores", path, "orphan",
            _repair_action(repair, "removed"),
        )
    if store.n_rows > committed_rows:
        # a crashed commit's surplus rows: truncate back to the carry
        surplus = store.n_rows - committed_rows
        try:
            if repair:
                store.truncate_to(committed_rows)
            _issue(
                issues, "scores", scores_dir, "torn",
                _repair_action(repair, "truncated"),
                f"{surplus} uncommitted rows",
            )
        except Exception as exc:
            _reset_detect_state(
                folder, issues, repair, scores_dir, "corrupt",
                f"truncate failed: {type(exc).__name__}: "
                f"{str(exc)[:120]}",
            )


# ---------------------------------------------------------------------------

# the JAX package's table, whole: the pyramid and backfill actions
# (rebuilt_pyramid, adopted_commit, aborted) stay so that a report
# counts the same either way
_REPAIRED_ACTIONS = (
    "removed",
    "promoted_prev",
    "restamped",
    "rewritten",
    "rebuilt_pyramid",
    "reset_detect",
    "truncated",
    "adopted_commit",
    "aborted",
)


def audit(folder, repair: bool = True, rebuild: bool = True) -> dict:
    """Scan (and with ``repair=True`` fix) every durable artifact in
    ``folder``.  Returns the report dict (see the module docstring);
    ``report["clean"]`` is True when nothing is left in a state a
    verified read would reject.  ``rebuild`` is the JAX signature's
    pyramid switch; the port has no pyramid to rebuild yet."""
    from tpudas_torch.obs.health import HEALTH_FILENAME, validate_health
    from tpudas_torch.io.index import INDEX_FILENAME
    from tpudas_torch.resilience.quarantine import QUARANTINE_FILENAME

    folder = str(folder)
    t0 = time.perf_counter()
    issues: list = []
    with span("integrity.audit", folder=folder):
        if os.path.isdir(folder):
            _sweep_tmp(folder, issues, repair)
            _check_carry(folder, issues, repair)
            _check_json_artifact(
                os.path.join(folder, QUARANTINE_FILENAME), "quarantine",
                issues, repair,
            )
            _check_json_artifact(
                os.path.join(folder, HEALTH_FILENAME), "health", issues,
                repair, validate=validate_health,
            )
            _check_json_artifact(
                os.path.join(folder, INDEX_FILENAME), "index", issues,
                repair,
            )
            _check_outputs(folder, issues, repair)
            _check_detect(folder, issues, repair)
    elapsed = time.perf_counter() - t0
    reg = get_registry()
    reg.counter(
        "tpudas_integrity_audit_runs_total",
        "integrity audits (startup fsck) executed",
    ).inc()
    reg.histogram(
        "tpudas_integrity_audit_seconds",
        "wall time of one integrity audit over an output folder",
    ).observe(elapsed)
    counts: dict = {}
    repaired = 0
    for it in issues:
        counts[it["status"]] = counts.get(it["status"], 0) + 1
        if it["action"] in _REPAIRED_ACTIONS:
            repaired += 1
            reg.counter(
                "tpudas_integrity_audit_repairs_total",
                "artifacts repaired by the integrity audit",
                labelnames=("kind",),
            ).inc(kind=it["action"])
    clean = all(it["action"] in _REPAIRED_ACTIONS for it in issues)
    report = {
        "folder": folder,
        "repair": bool(repair),
        "clean": bool(clean),
        "elapsed_s": round(elapsed, 4),
        "repaired": repaired,
        "counts": counts,
        "issues": issues,
    }
    if issues:
        log_event(
            "integrity_audit",
            folder=folder,
            clean=clean,
            repaired=repaired,
            counts=counts,
        )
    return report


def fleet_stream_dirs(root) -> list:
    """``[(stream_id, path), ...]`` for every stream root under a
    fleet root: the non-hidden subdirectories, sorted by name (the
    :class:`tpudas_torch.fleet.FleetEngine` layout — stream ids cannot start
    with a dot, so dot-dirs beside the streams are fleet bookkeeping,
    e.g. a shared compile cache)."""
    root = str(root)
    out = []
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            if name.startswith("."):
                continue
            path = os.path.join(root, name)
            if os.path.isdir(path):
                out.append((name, path))
    return out


def audit_fleet(root, repair: bool = True, rebuild: bool = True) -> dict:
    """Run :func:`audit` over every stream root under ``root`` and
    aggregate: ``report["clean"]`` is True only when EVERY stream is.
    Per-stream reports land under ``report["streams"][stream_id]`` —
    each stream is classified and repaired independently, so a
    wrecked stream cannot block its neighbors' repair.  Run only
    while the fleet is stopped (the same tmp-sweep caveat as the
    single-stream audit)."""
    streams = {}
    issues_total = 0
    repaired_total = 0
    for stream_id, path in fleet_stream_dirs(root):
        rep = audit(path, repair=repair, rebuild=rebuild)
        streams[stream_id] = rep
        issues_total += len(rep["issues"])
        repaired_total += rep["repaired"]
    # a fleet root with nothing to audit is NOT clean: a typo'd path
    # or an emptied root must not read as a passing fsck
    error = None
    if not streams:
        error = (
            "no stream folders found under fleet root "
            f"{str(root)!r} (nothing was audited)"
        )
    report = {
        "root": str(root),
        "repair": bool(repair),
        "clean": bool(streams)
        and all(r["clean"] for r in streams.values()),
        "streams": streams,
        "stream_count": len(streams),
        "issues_total": issues_total,
        "repaired_total": repaired_total,
    }
    if error is not None:
        report["error"] = error
    if issues_total:
        log_event(
            "integrity_audit_fleet",
            root=str(root),
            clean=report["clean"],
            streams=len(streams),
            repaired=repaired_total,
        )
    return report
