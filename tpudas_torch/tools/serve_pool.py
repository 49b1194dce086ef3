"""Operator launcher for the serve worker pool.

Thin CLI over :mod:`tpudas_torch.serve.pool`: N worker processes share
one ``SO_REUSEPORT`` data port over a read-only store (single folder or
``--fleet`` root); the parent serves the merged per-worker
``/metrics`` and the aggregate ``/healthz`` on the control port
(default ``port + 1``).  Workers serve from the host and never create
a CUDA context.

    python3 tpudas_torch/tools/serve_pool.py /data/out \\
        --port 8000 --workers 8
    python -m tpudas_torch.tools.serve_pool /data/out --workers 8

``--live-bridge host:port`` subscribes every data worker to a
producer's live bridge (``TPUDAS_LIVE_BRIDGE`` on the producer), so
``/live`` fans out across the pool.  ``--store-url URL`` (with
``--store-prefix``, ``--cache-dir``, ``--cache-bytes``) makes every
worker a stateless replica of an object-store pyramid.
"""

from __future__ import annotations

import os
import sys

if __package__ in (None, ""):  # run as a script: put the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

__all__ = ["main"]


def main(argv=None) -> int:
    from tpudas_torch.serve.pool import main as pool_main

    return pool_main(argv)


if __name__ == "__main__":
    sys.exit(main())
