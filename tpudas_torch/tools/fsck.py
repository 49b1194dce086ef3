"""fsck for an output folder: audit (and repair) durable state.

The operator CLI over :func:`tpudas_torch.integrity.audit.audit`, the
same scan the port's realtime runners make before their first round.
It checks every durable artifact beside the stream — carry, quarantine
ledger, health snapshot, directory-index cache, outputs beyond the
carry, tile pyramid, detection state, flight-recorder segments —
verifies checksums, classifies defects (unstamped / torn / corrupt /
stale tmp / orphan tile) and repairs through the ladder (restamp,
promote ``.prev``, remove, rebuild ``.tiles/``, truncate a segment or a
ledger, reset ``.detect/``).  The report lists each issue with its
artifact (``flight`` for a segment), as the JAX CLI's does.

    python3 tpudas_torch/tools/fsck.py OUTPUT_FOLDER [options]
    python -m tpudas_torch.tools.fsck OUTPUT_FOLDER [options]

Options:
    --no-repair     report only; change nothing on disk
    --no-rebuild    repair everything except pyramid rebuilds
    --fleet         treat the folder as a fleet root: audit every
                    <root>/<stream_id>/ on its own and aggregate
    --backfill      treat the folder as a backfill queue root: sweep
                    stale leases and orphan stagings, finish crashed
                    commits, audit committed shards and the stitched
                    result (tpudas_torch.integrity.audit.audit_backfill)
    --store URL     audit an object-store backfill job instead: the
                    positional argument is the job prefix inside the
                    store named by URL (file:///path, s3://bucket/...,
                    fake:tag, replica:urlA,urlB,...); a replica: URL
                    also runs the anti-entropy scrub and folds its
                    verdict into "clean"
                    (tpudas_torch.integrity.audit.audit_backfill_store;
                    tpudas_torch/tools/store_scrub.py scrubs alone)
    --out PATH      also write the JSON report to PATH

Run only while the driver is stopped: the stale-tmp sweep cannot tell
a crashed writer's leftovers from a live writer's in-flight file.

Exit code 0 when the folder is clean after the run (every issue
repaired, or no issues), 1 otherwise.
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
    ap.add_argument("folder", help="output folder to audit")
    ap.add_argument("--no-repair", action="store_true",
                    help="report only; change nothing on disk")
    ap.add_argument("--no-rebuild", action="store_true",
                    help="repair everything except pyramid rebuilds")
    ap.add_argument("--fleet", action="store_true",
                    help="audit every <folder>/<stream_id>/ as a fleet root")
    ap.add_argument("--backfill", action="store_true",
                    help="audit the folder as a backfill queue root")
    ap.add_argument("--store", default=None, metavar="URL",
                    help="audit an object-store backfill job: FOLDER is "
                         "the job prefix inside this store URL")
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)
    if args.fleet and args.backfill:
        ap.error("--fleet and --backfill are mutually exclusive")
    if args.store and args.fleet:
        ap.error("--store and --fleet are mutually exclusive")

    from tpudas_torch.integrity.audit import (
        audit,
        audit_backfill,
        audit_backfill_store,
        audit_fleet,
    )

    if args.store:
        from tpudas_torch.store import store_from_url

        report = audit_backfill_store(
            store_from_url(args.store), args.folder,
            repair=not args.no_repair,
        )
    elif args.backfill:
        report = audit_backfill(
            args.folder, repair=not args.no_repair,
            rebuild=not args.no_rebuild,
        )
    else:
        report = (audit_fleet if args.fleet else audit)(
            args.folder, repair=not args.no_repair,
            rebuild=not args.no_rebuild,
        )
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
