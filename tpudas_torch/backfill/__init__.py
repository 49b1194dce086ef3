"""tpudas_torch.backfill — crash-only cluster backfill (shared FS or object store).

The batch half of the paper's workload (reprocess months of archived
spool with a new filter plan, new detect operators, or a codec
re-encode) executed by N concurrent worker processes/hosts with
exactly-once shard commit:

- :mod:`tpudas_torch.backfill.queue` — the filesystem-backed work queue of
  time-shard jobs with crc-stamped manifests and lease-based claiming
  (stale leases are reclaimed by any worker; double execution resolves
  by the commit-wins atomic rename);
- :mod:`tpudas_torch.backfill.runner` — drain-mode shard execution reusing
  :class:`tpudas_torch.fleet.engine.LowpassStreamRunner` (poll loop replaced
  by drain-as-fast-as-possible over the slice) with the full fault
  ladder, ENOSPC shedding, and fatal-shard parking;
- :mod:`tpudas_torch.backfill.stitch` — deterministic stitching of the
  committed shard outputs into a result byte-identical to a single
  sequential run (pyramid synced, detect ledger/scores recomputed
  chunk-invariantly);
- :mod:`tpudas_torch.backfill.objqueue` — the same queue/worker/stitch over
  a :mod:`tpudas_torch.store` object store: N hosts with NO shared
  filesystem, conditional-put leases and upload-manifest commits in
  place of atomic renames.

``tpudas_torch/tools/backfill_drill.py`` is the chaos harness (N
workers, seeded SIGKILLs, injected claim/commit faults).  The plan,
leases, done markers, shard manifests and result markers are the JAX
package's formats, so either package drains, audits and stitches a
queue the other wrote.  Workers take a ``device`` (default the CUDA
card); it never enters the plan.
"""

from tpudas_torch.backfill.objqueue import (  # noqa: F401
    StoreBackfillQueue,
    plan_backfill_store,
    run_store_worker,
    stitch_store_backfill,
)
from tpudas_torch.backfill.queue import (  # noqa: F401
    BackfillQueue,
    Lease,
    LeaseLostError,
    build_plan,
    load_plan,
    plan_backfill,
)
from tpudas_torch.backfill.runner import run_worker  # noqa: F401
from tpudas_torch.backfill.stitch import stitch_backfill  # noqa: F401

__all__ = [
    "BackfillQueue",
    "Lease",
    "LeaseLostError",
    "StoreBackfillQueue",
    "build_plan",
    "load_plan",
    "plan_backfill",
    "plan_backfill_store",
    "run_store_worker",
    "run_worker",
    "stitch_backfill",
    "stitch_store_backfill",
]
