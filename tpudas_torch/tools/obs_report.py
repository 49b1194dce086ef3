"""Cluster observability report: one snapshot over a fleet root, a
backfill queue root, and a serve-pool control plane.

The operator CLI over :mod:`tpudas_torch.obs.collect`, the port's
counterpart of ``tools/obs_report.py`` with the same options and the
same output.  It reads the crash-only on-disk formats directly —
per-stream ``health.json``, flight-recorder rings, the backfill
queue's plan, lease and done markers — plus
(optionally) a live serve pool's ``/pool/healthz``.  No process
cooperation needed: point it at a live cluster or a post-mortem copy.

    python -m tpudas_torch.tools.obs_report --fleet /data/fleet \
        [--backfill /data/backfill] [--pool http://host:9100] \
        [--slo-head-lag 300] [--objective 0.99] [--json] [--strict]

Text mode prints a per-stream table (status, rounds, realtime factor,
head lag, SLO status + error-budget burn, last error) and the
backfill and pool summaries; ``--json`` dumps the full snapshot.
``--strict`` exits 1 unless the overall status is ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a script: put the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

__all__ = ["main", "print_text"]


def _fmt(value, width=9):
    if value is None:
        return "-".rjust(width)
    if isinstance(value, float):
        return f"{value:.2f}".rjust(width)
    return str(value).rjust(width)


def print_text(snap: dict) -> None:
    print(f"cluster status: {snap['status']}")
    fleet = snap.get("fleet")
    if fleet is not None:
        print(
            f"\nfleet: {fleet['status']}  "
            f"(streams: {len(fleet['streams'])}, "
            f"health {fleet.get('counts')}, slo {fleet.get('slo_counts')})"
        )
        header = (
            f"{'stream':<16}{'status':>10}{'rounds':>8}"
            f"{'rt_factor':>10}{'head_lag':>10}{'slo':>10}"
            f"{'burn':>7}{'dev_util':>9}{'bound':>14}  last_error"
        )
        print(header)
        print("-" * len(header))
        for sid, e in sorted(fleet["streams"].items()):
            slo = e.get("slo", {})
            dev = e.get("devprof") or {}
            err = e.get("last_error") or ""
            fleet_ev = e.get("fleet")
            if fleet_ev:
                ev_at = fleet_ev.get(f"{fleet_ev.get('event')}_at")
                err = err or f"[{fleet_ev.get('event')} at {ev_at}]"
            print(
                f"{sid:<16}{e['status']:>10}"
                f"{_fmt(e.get('rounds'), 8)}"
                f"{_fmt(e.get('realtime_factor'), 10)}"
                f"{_fmt(e.get('head_lag_seconds'), 10)}"
                f"{slo.get('status', '-'):>10}"
                f"{_fmt(slo.get('error_budget_burn'), 7)}"
                f"{_fmt(dev.get('utilization'), 9)}"
                f"{str(dev.get('bound') or '-'):>14}  "
                f"{str(err)[:48]}"
            )
    bf = snap.get("backfill")
    if bf is not None:
        print(f"\nbackfill: {bf['status']}")
        if "shards" in bf:
            print(
                f"  shards: {bf['shards']} of {bf['shards_total']} "
                f"({100.0 * bf['done_fraction']:.1f}% done)"
            )
            if bf["workers"]:
                print(f"  live workers: {', '.join(bf['workers'])}")
            if bf["parked"]:
                print(f"  PARKED: {', '.join(bf['parked'])} "
                      "(tools/fsck.py --backfill; see RESILIENCE.md)")
            print(f"  result committed: {bf['result_done']}")
        else:
            print(f"  {bf.get('error', '')}")
    pool = snap.get("pool")
    if pool is not None:
        print(f"\nserve pool: {pool.get('status')}  ({pool.get('url')})")
        if pool.get("status") == "unreachable":
            print(f"  {pool.get('error', '')}")
        else:
            body = {k: v for k, v in pool.items()
                    if k not in ("url", "status")}
            print(f"  {json.dumps(body)[:200]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", default=None,
                    help="fleet root (one stream folder per stream)")
    ap.add_argument("--stream", default=None,
                    help="one single-stream output folder (reported as "
                         "a fleet of one)")
    ap.add_argument("--backfill", default=None,
                    help="backfill queue root (tpudas_torch.backfill)")
    ap.add_argument("--pool", default=None,
                    help="serve pool control-plane base URL")
    ap.add_argument("--slo-head-lag", type=float, default=None,
                    help="freshness target in stream-seconds "
                         "(default TPUDAS_SLO_HEAD_LAG or 300)")
    ap.add_argument("--objective", type=float, default=0.99)
    ap.add_argument("--window", type=int, default=200,
                    help="flight rounds in the error-budget window")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 unless overall status is ok")
    args = ap.parse_args(argv)
    if not (args.fleet or args.stream or args.backfill or args.pool):
        ap.error("nothing to report: pass --fleet, --stream, "
                 "--backfill, and/or --pool")

    from tpudas_torch.obs.collect import (
        SLOPolicy,
        cluster_snapshot,
        overall_status,
        stream_snapshot,
        worst_status,
    )

    policy = SLOPolicy(
        head_lag_target_s=args.slo_head_lag,
        objective=args.objective,
        window=args.window,
    )
    snap = cluster_snapshot(
        fleet_root=args.fleet,
        backfill_root=args.backfill,
        pool_url=args.pool,
        policy=policy,
    )
    if args.stream:
        entry = stream_snapshot(args.stream, policy)
        fleet = snap.setdefault(
            "fleet", {"status": "ok", "streams": {}, "counts": {},
                      "slo_counts": {}},
        )
        sid = os.path.basename(os.path.normpath(args.stream))
        fleet["streams"][sid] = entry
        fleet["counts"][entry["status"]] = (
            fleet["counts"].get(entry["status"], 0) + 1
        )
        slo_s = entry["slo"]["status"]
        fleet["slo_counts"][slo_s] = (
            fleet["slo_counts"].get(slo_s, 0) + 1
        )
        fleet["status"] = worst_status(
            [e["status"] for e in fleet["streams"].values()]
            + [e["slo"]["status"] for e in fleet["streams"].values()]
        )
        snap["status"] = overall_status(snap)
    if args.as_json:
        print(json.dumps(snap, indent=1, default=str))
    else:
        print_text(snap)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(snap, fh, indent=1, default=str)
            fh.write("\n")
    if args.strict and snap["status"] != "ok":
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
