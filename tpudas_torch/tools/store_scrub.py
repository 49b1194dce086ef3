"""Operator CLI for the replicated store: scrub, drain, promote.

The port's counterpart of ``tools/store_scrub.py``: the anti-entropy
surface of :mod:`tpudas_torch.store.replica`, standalone
(``tpudas_torch/tools/fsck.py --store replica:...`` runs the same scrub as part of
a full backfill-job audit; this tool is the store-only view for
cron/runbook use):

    python -m tpudas_torch.tools.store_scrub replica:URL_A,URL_B[,...] [opts]

Default action is one full **scrub**: drain the hinted-handoff
journal, diff every replica against the primary by content token,
repair mirrors from the primary, restore primary-lost objects from
mirrors, sweep torn-upload debris everywhere.  Exit 0 when the trees
converged (report ``clean``), 1 otherwise.

Options:
    --prefix P      scrub only keys under prefix P (default: all)
    --no-repair     report divergence, change nothing
    --drain         drain the handoff journal only (no full diff) —
                    the cheap post-recovery fast path
    --promote K     disaster recovery: the old primary is LOST;
                    reconcile the other members onto member index K
                    (0-based position in the replica: spec, so 1 = the
                    first mirror) and report.  After promotion,
                    restart every component with the promoted member
                    FIRST in the replica: spec and run a normal scrub.
                    Conflicting keys keep the promotion target's copy
                    (counted in the report) — promote the most
                    caught-up mirror.
    --out PATH      also write the JSON report to PATH

The journal location must match the writers': point
``TPUDAS_REPLICA_JOURNAL`` at the same directory the serving/backfill
processes used, or their deferred writes are invisible to --drain
(a full scrub finds the divergence regardless — the journal is an
optimization, the token diff is the truth).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a script: put the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "url", help="replica:urlA,urlB,... store spec (primary first)"
    )
    ap.add_argument("--prefix", default="", help="scrub this key prefix only")
    ap.add_argument(
        "--no-repair", action="store_true",
        help="report divergence; change nothing",
    )
    ap.add_argument(
        "--drain", action="store_true",
        help="drain the handoff journal only (skip the full diff)",
    )
    ap.add_argument(
        "--promote", type=int, default=None, metavar="K",
        help="reconcile survivors onto member K (0-based; the old "
             "primary is lost)",
    )
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    from tpudas_torch.store import store_from_url
    from tpudas_torch.store.replica import find_replicated, promote

    store = store_from_url(args.url)
    repl = find_replicated(store)
    if repl is None:
        ap.error(f"not a replica: spec: {args.url!r}")

    if args.promote is not None:
        members = [repl.primary, *repl.mirrors]
        if not 0 <= args.promote < len(members):
            ap.error(
                f"--promote {args.promote} out of range "
                f"(members: {len(members)})"
            )
        target = members[args.promote]
        survivors = [
            m for i, m in enumerate(members) if i != args.promote
        ]
        report = promote(
            target, survivors, prefix=args.prefix,
            repair=not args.no_repair,
        )
        clean = not report["unreachable"]
    elif args.drain:
        report = {
            "drained": repl.drain_handoff(),
            "handoff_pending": repl.journal.pending_counts(),
        }
        clean = (
            report["drained"]["failed"] == 0
            and not any(report["handoff_pending"].values())
        )
        report["clean"] = clean
    else:
        report = repl.scrub(args.prefix, repair=not args.no_repair)
        clean = report["clean"]

    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
