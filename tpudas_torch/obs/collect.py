"""Cluster-wide observability rollup: one snapshot over a fleet root
and a serve-pool control plane.

The port's counterpart of :mod:`tpudas.obs.collect`.  Every obs
artifact is per stream — ``health.json``, ``metrics.prom`` and the
flight ring beside each stream's carry — and this module is the read
side that folds them into ONE operator view:

- :func:`stream_snapshot` — one stream folder: verified health, the
  freshness SLO status, flight-ring freshness, park/unpark events;
- :func:`fleet_rollup` — every stream under a fleet root, with counts
  and an overall status that is ``ok`` only when every stream is;
- :func:`pool_rollup` — a live serve pool's ``/pool/healthz`` (a plain
  HTTP GET; ``unreachable`` is a status, not an exception);
- :func:`cluster_snapshot` — all of the above in one dict.

**Freshness SLO.**  Per stream, :func:`slo_status` evaluates
``head_lag_seconds`` against a target (:class:`SLOPolicy`, default
300 s / ``TPUDAS_SLO_HEAD_LAG``) two ways: the CURRENT lag from the
last health snapshot (``violating`` when over target), and the
**error-budget burn** over the recent flight-ring ``round`` records —
the fraction of recent rounds whose lag exceeded the target, divided by
the budget ``1 - objective`` (default objective 0.99).  Burn >= 1 means
the stream spends budget faster than the SLO allows (``at_risk``) even
if the current round is under target.

Everything here reads the crash-only on-disk formats, which both
packages write alike: over the same folder the port's snapshot equals
the JAX package's, dict for dict.  ``tpudas_torch.tools.obs_report`` is
the operator CLI.  Not ported yet: :func:`backfill_rollup` (and
``cluster_snapshot(backfill_root=...)``) raise ``NotImplementedError``
until the backfill queue is ported (ROADMAP A8e).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

from tpudas_torch.obs.flight import read_flight
from tpudas_torch.obs.health import read_health
from tpudas_torch.obs.trace import span

__all__ = [
    "DEFAULT_HEAD_LAG_TARGET_S",
    "SLOPolicy",
    "backfill_rollup",
    "cluster_snapshot",
    "devprof_entry",
    "fleet_rollup",
    "health_entry",
    "live_entry",
    "overall_status",
    "pool_rollup",
    "slo_status",
    "stream_snapshot",
    "worst_status",
]

DEFAULT_HEAD_LAG_TARGET_S = 300.0


def _default_target() -> float:
    raw = os.environ.get("TPUDAS_SLO_HEAD_LAG", "")
    try:
        return float(raw) if raw else DEFAULT_HEAD_LAG_TARGET_S
    except ValueError:
        return DEFAULT_HEAD_LAG_TARGET_S


@dataclass(frozen=True)
class SLOPolicy:
    """Per-stream freshness SLO: ``head_lag_seconds`` must stay under
    ``head_lag_target_s`` for at least ``objective`` of rounds,
    evaluated over the newest ``window`` flight ``round`` records."""

    head_lag_target_s: float | None = None  # None -> TPUDAS_SLO_HEAD_LAG/300
    objective: float = 0.99
    window: int = 200

    def target(self) -> float:
        return (
            _default_target() if self.head_lag_target_s is None
            else float(self.head_lag_target_s)
        )


def slo_status(folder, policy: SLOPolicy | None = None,
               health=None, rounds=None) -> dict:
    """One stream's freshness SLO evaluation (see the module
    docstring).  ``health`` may pass a pre-read snapshot and
    ``rounds`` pre-read flight ``round`` records (newest
    ``policy.window``) to avoid scanning the same artifacts twice."""
    policy = policy or SLOPolicy()
    target = policy.target()
    if health is None:
        health = read_health(str(folder))
    head_lag = None if health is None else health.get("head_lag_seconds")
    if rounds is None:
        rounds = read_flight(folder, kind="round", limit=policy.window)
    lags = [
        float(r["head_lag"]) for r in rounds
        if r.get("head_lag") is not None
    ]
    violations = sum(1 for lag in lags if lag > target)
    violation_frac = (violations / len(lags)) if lags else 0.0
    budget = max(1.0 - float(policy.objective), 1e-9)
    burn = violation_frac / budget
    if head_lag is None and not lags:
        status = "unknown"
    elif head_lag is not None and head_lag > target:
        status = "violating"
    elif burn >= 1.0:
        status = "at_risk"
    else:
        status = "ok"
    out = {
        "status": status,
        "head_lag_seconds": head_lag,
        "target_s": target,
        "objective": float(policy.objective),
        "window_rounds": len(lags),
        "violation_fraction": round(violation_frac, 4),
        "error_budget_burn": round(burn, 3),
    }
    # live push plane: surface the fan-out tail beside the
    # freshness SLO — a stream can be fresh on disk yet late to its
    # push subscribers, and /slo is where an operator looks first
    live = live_entry(rounds)
    if live is not None:
        out["live"] = {
            "subscribers": live["subscribers"],
            "fanout_p99_s": live["fanout_p99_s"],
            "dropped_subscribers": live["dropped_subscribers"],
        }
    return out


def health_entry(health) -> dict:
    """The per-stream rollup entry derived from one verified health
    snapshot — the ONE health→entry mapping of :func:`stream_snapshot`
    (so of ``tpudas_torch.tools.obs_report``), as in the JAX package.
    ``None`` (no snapshot yet) reads ``unknown``."""
    if health is None:
        return {"status": "unknown"}
    entry = {
        "status": "degraded" if health.get("degraded") else "ok",
        "rounds": health.get("rounds"),
        "mode": health.get("mode"),
        "realtime_factor": health.get("realtime_factor"),
        "head_lag_seconds": health.get("head_lag_seconds"),
        "quarantined_files": health.get("quarantined_files"),
        "last_error": health.get("last_error"),
        "written_at": health.get("written_at"),
    }
    if health.get("detect") is not None:
        entry["detect"] = health["detect"]
    # the fleet park/unpark event record (parked_at/unparked_at
    # wall-clock timestamps — FleetEngine stamps them)
    if health.get("fleet") is not None:
        entry["fleet"] = health["fleet"]
    return entry


def devprof_entry(rounds) -> dict | None:
    """Fold the flight ring's per-round ``devprof`` records (the device
    telemetry the runner stamps into every ``round`` record) into the
    rollup's device-telemetry column: mean launches per round, total
    device-execute seconds, the device-busy fraction of round wall
    time, and the newest ``bound`` classification / roofline
    utilization.  ``None`` when no round carries devprof — read-only
    over the crash-surviving ring like everything here, so it works
    post-mortem and cross-process."""
    recs = [
        r for r in rounds or []
        if isinstance(r.get("devprof"), dict)
    ]
    if not recs:
        return None
    launches = 0.0
    dev_s = 0.0
    wall = 0.0
    for r in recs:
        dp = r["devprof"]
        launches += float(dp.get("launches") or 0.0)
        dev_s += float(dp.get("device_execute_s") or 0.0)
        phases = r.get("phases") or {}
        wall += sum(
            float(v) for v in phases.values()
            if isinstance(v, (int, float))
        )
    # the newest round that actually classified (a zero-launch round
    # reads bound=None; don't let it mask the last real reading)
    bound = None
    utilization = None
    for r in reversed(recs):
        dp = r["devprof"]
        if bound is None and dp.get("bound") is not None:
            bound = dp["bound"]
        if utilization is None and dp.get("utilization") is not None:
            utilization = dp["utilization"]
        if bound is not None and utilization is not None:
            break
    return {
        "rounds": len(recs),
        "launches_per_round": round(launches / len(recs), 3),
        "device_execute_s": round(dev_s, 6),
        "device_busy_fraction": (
            round(dev_s / wall, 4) if wall > 0 else None
        ),
        "bound": bound,
        "utilization": utilization,
    }


def live_entry(rounds) -> dict | None:
    """Fold the flight ring's per-round ``live`` records (the live
    plane's round deltas a runner stamps into every ``round`` record
    while the push plane is on) into the
    rollup's fan-out column: current subscriber count, per-window
    published/dropped/degraded totals, and the newest rolling fan-out
    P99.  ``None`` when no round carries a live block (push plane
    off) — read-only over the crash-surviving ring, so it works
    post-mortem and cross-process like everything here."""
    recs = [
        r for r in rounds or []
        if isinstance(r.get("live"), dict)
    ]
    if not recs:
        return None
    published = dropped = degrades = subs_dropped = 0
    for r in recs:
        lv = r["live"]
        published += int(lv.get("published") or 0)
        dropped += int(lv.get("dropped_frames") or 0)
        degrades += int(lv.get("degrades") or 0)
        subs_dropped += int(lv.get("dropped_subscribers") or 0)
    newest = recs[-1]["live"]
    p99 = None
    for r in reversed(recs):
        if r["live"].get("fanout_p99_s") is not None:
            p99 = r["live"]["fanout_p99_s"]
            break
    return {
        "rounds": len(recs),
        "subscribers": newest.get("subscribers"),
        "published": published,
        "dropped_frames": dropped,
        "degrades": degrades,
        "dropped_subscribers": subs_dropped,
        "fanout_p99_s": p99,
    }


def stream_snapshot(folder, policy: SLOPolicy | None = None) -> dict:
    """One stream folder's rollup entry: verified health + SLO +
    flight freshness + the fleet park/unpark event (timestamps
    included — :class:`tpudas_torch.fleet.FleetEngine` stamps them)."""
    folder = str(folder)
    policy = policy or SLOPolicy()
    health = read_health(folder)
    entry = health_entry(health)
    # ONE ring scan serves both the SLO window and the freshness entry
    rounds = read_flight(folder, kind="round", limit=policy.window)
    entry["slo"] = slo_status(
        folder, policy, health=health, rounds=rounds
    )
    if rounds:
        entry["flight"] = {
            "last_round": rounds[-1].get("round"),
            "last_round_at": rounds[-1].get("ts"),
            "phases": rounds[-1].get("phases"),
        }
    # device telemetry: same ring scan, one more fold
    dev = devprof_entry(rounds)
    if dev is not None:
        entry["devprof"] = dev
    # live push plane: same ring scan again
    live = live_entry(rounds)
    if live is not None:
        entry["live"] = live
    return entry


_STATUS_RANK = {"ok": 0, "at_risk": 1, "unknown": 2, "degraded": 3,
                "violating": 3, "unreachable": 3}


def worst_status(statuses) -> str:
    """The worst of a set of rollup statuses (``ok`` < ``at_risk`` <
    ``unknown`` < ``degraded``/``violating``/``unreachable``) — the
    ONE ranking every aggregate view uses (``fleet_rollup``,
    ``cluster_snapshot``, ``tpudas_torch.tools.obs_report``), so they
    can never disagree about what "worst" means."""
    worst = "ok"
    for s in statuses:
        if _STATUS_RANK.get(s, 3) > _STATUS_RANK[worst]:
            worst = s if s in _STATUS_RANK else "degraded"
    return worst


_worst = worst_status


def overall_status(snap: dict) -> str:
    """Recompute a cluster snapshot's overall status from whichever
    planes are present — used by :func:`cluster_snapshot` itself and
    by callers that merge extra entries afterwards (e.g.
    ``tpudas_torch.tools.obs_report --stream``)."""
    statuses = []
    fleet = snap.get("fleet")
    if fleet is not None:
        statuses.append(fleet["status"])
    bf = snap.get("backfill")
    if bf is not None:
        statuses.append(
            "ok" if bf["status"] in ("done", "in_progress", "stitching")
            else "degraded"
        )
    pool = snap.get("pool")
    if pool is not None:
        statuses.append(
            "ok" if pool.get("status") == "ok" else "degraded"
        )
    return worst_status(statuses) if statuses else "unknown"


def fleet_rollup(root, policy: SLOPolicy | None = None) -> dict:
    """Aggregate :func:`stream_snapshot` over every stream under a
    fleet root (the ``FleetEngine`` layout).  Overall ``status`` is
    the worst member's; per-status counts match ``/fleet/healthz``
    plus the SLO dimension."""
    from tpudas_torch.integrity.audit import fleet_stream_dirs

    streams = {}
    counts: dict = {}
    slo_counts: dict = {}
    for sid, path in fleet_stream_dirs(root):
        entry = stream_snapshot(path, policy)
        streams[sid] = entry
        counts[entry["status"]] = counts.get(entry["status"], 0) + 1
        s = entry["slo"]["status"]
        slo_counts[s] = slo_counts.get(s, 0) + 1
    if not streams:
        return {"status": "unknown", "streams": {}, "counts": {},
                "slo_counts": {},
                "detail": f"no stream folders under {str(root)!r}"}
    statuses = [e["status"] for e in streams.values()]
    statuses += [e["slo"]["status"] for e in streams.values()]
    return {
        "status": _worst(statuses),
        "streams": streams,
        "counts": counts,
        "slo_counts": slo_counts,
    }


def backfill_rollup(root) -> dict:
    """One backfill queue root's progress.  Not ported yet: raises
    ``NotImplementedError`` until the backfill queue is."""
    raise NotImplementedError(
        f"backfill_rollup({str(root)!r}): the backfill queue is not "
        "ported to tpudas_torch yet (ROADMAP A8e)"
    )


def pool_rollup(url, timeout: float = 5.0) -> dict:
    """A live serve pool's ``/pool/healthz`` payload (``url`` is the
    control-plane base, e.g. ``http://host:9100``), by a plain HTTP
    GET.  Unreachable is a reported status — the rollup must describe
    a dead pool, not die with it."""
    target = str(url).rstrip("/") + "/pool/healthz"
    try:
        with urllib.request.urlopen(target, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        # a degraded pool answers 503 WITH a descriptive body — that
        # is a report, not unreachability
        try:
            payload = json.loads(exc.read().decode())
        except Exception:
            return {
                "status": "unreachable",
                "url": target,
                "error": f"HTTP {exc.code}",
            }
    except Exception as exc:
        return {
            "status": "unreachable",
            "url": target,
            "error": f"{type(exc).__name__}: {str(exc)[:200]}",
        }
    payload.setdefault("status", "unknown")
    payload["url"] = target
    return payload


def cluster_snapshot(fleet_root=None, backfill_root=None, pool_url=None,
                     policy: SLOPolicy | None = None) -> dict:
    """The one cluster view: fleet + backfill + serve pool, each
    optional, with an overall status that is ``ok`` only when every
    present plane is healthy.  ``backfill_root`` raises
    ``NotImplementedError`` until the backfill queue is ported."""
    if backfill_root is not None:
        backfill_rollup(backfill_root)
    with span("obs.rollup"):
        snap: dict = {"generated_at": time.time()}
        if fleet_root is not None:
            snap["fleet"] = fleet_rollup(fleet_root, policy)
        if backfill_root is not None:
            snap["backfill"] = backfill_rollup(backfill_root)
        if pool_url is not None:
            snap["pool"] = pool_rollup(pool_url)
        snap["status"] = overall_status(snap)
    return snap
