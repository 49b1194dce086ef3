"""Atomic file-write primitives shared by every durable-state writer.

The port's copy of :mod:`tpudas.utils.atomicio`: one home for the
tmp-then-``os.replace`` discipline the stream carry, the quarantine
ledger, the directory-index cache and the detect artifacts
(:mod:`tpudas_torch.detect.ledger`) rely on, so readers never see a
partial file.

Tmp names are unique per process (``<path>.tmp.<pid>``): two writers
racing one destination cannot clobber each other's half-written tmp,
and the last ``os.replace`` wins whole.

Durability is opt-in: by default nothing fsyncs (these are snapshots
rewritten every round; every reader has a ``.prev``/rebuild ladder).
``durable=True`` (or ``TPUDAS_FSYNC=1``, see :func:`durable_default`)
fsyncs the payload before the rename and the directory after it.

Every write passes the ``fs.write_enospc`` fault-injection site
(:mod:`tpudas_torch.resilience.faults`), so disk-full behaviour is
drillable: an injected ``OSError(ENOSPC)`` here is indistinguishable
from the real thing to every caller.
"""

from __future__ import annotations

import os
import re

__all__ = [
    "atomic_write_bytes",
    "atomic_write_text",
    "durable_default",
    "is_tmp_name",
    "tmp_path_for",
]

# matches "<base>.tmp" (single-writer names) and "<base>.tmp.<pid>"
_TMP_NAME_RE = re.compile(r"\.tmp(\.\d+)?$")


def is_tmp_name(name: str) -> bool:
    """True for the basename of an in-flight (or crashed) tmp file
    written by this module."""
    return _TMP_NAME_RE.search(os.path.basename(str(name))) is not None


def tmp_path_for(path: str) -> str:
    """The per-process tmp name for ``path``."""
    return f"{path}.tmp.{os.getpid()}"


def durable_default() -> bool:
    """The default for ``durable=None`` writes: ``TPUDAS_FSYNC=1``
    turns fsync-before-rename on everywhere."""
    return os.environ.get("TPUDAS_FSYNC", "0") == "1"


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so the rename itself is
    durable (best effort: not every filesystem supports dir fds)."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fault_point(path: str) -> None:
    from tpudas_torch.resilience.faults import fault_point

    fault_point("fs.write_enospc", path=path)


def _write(path: str, payload, mode: str, durable) -> None:
    durable = durable_default() if durable is None else bool(durable)
    _fault_point(path)
    tmp = tmp_path_for(path)
    with open(tmp, mode) as fh:
        fh.write(payload)
        if durable:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)
    if durable:
        _fsync_dir(path)


def atomic_write_text(path: str, text: str, durable: bool | None = None) -> (
    None
):
    """Write ``text`` to ``path`` via a unique tmp + rename."""
    _write(path, text, "w", durable)


def atomic_write_bytes(path: str, payload: bytes,
                       durable: bool | None = None) -> None:
    """Write ``payload`` to ``path`` via a unique tmp + rename."""
    _write(path, payload, "wb", durable)
