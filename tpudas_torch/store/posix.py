"""The POSIX backend: keys are files under a root directory.

This is the existing storage plane expressed through the store
contract — semantics unchanged.  Writes are the same
tmp-then-``os.replace`` dance :mod:`tpudas_torch.utils.atomicio` has always
done (readers never see partial bytes, a crash leaves only an
``is_tmp_name`` file for fsck), and tokens are the canonical
content-derived ``crc32-len`` (:func:`tpudas_torch.store.base.token_of`).

Conditional puts need what a filesystem does not give us: an atomic
"compare current content, then replace".  A per-key ``fcntl`` lock
file makes the read-compare-replace sequence atomic ACROSS PROCESSES
on one host / one coherent NFS mount — exactly the deployment the
POSIX plane has always assumed (the multi-host story is the point of
the other backends).  ``fcntl`` locks are advisory, but every CAS
writer goes through this method, and plain readers never need the
lock (``os.replace`` keeps reads atomic).

A local filesystem either works or raises honest ``OSError``s that
the existing taxonomy already classifies, so nothing here raises
:class:`StoreNetworkError` — the ``network`` kind belongs to the
remote backends.
"""

from __future__ import annotations

import fcntl
import os

from tpudas_torch.store.base import (
    CASConflictError,
    ObjectNotFoundError,
    ObjectStore,
    token_of,
)
from tpudas_torch.utils.atomicio import is_tmp_name, tmp_path_for

__all__ = ["PosixStore"]

_LOCK_SUFFIX = ".lock"


class PosixStore(ObjectStore):
    """Objects as files under ``root``; key ``a/b/c`` is file
    ``root/a/b/c``."""

    backend = "posix"

    def __init__(self, root: str, durable: bool = False):
        self.root = os.path.abspath(str(root))
        self.durable = bool(durable)
        # Creating the root is best-effort: a replica member whose
        # filesystem is currently unavailable must still CONSTRUCT so
        # writes can be journaled for hinted handoff — the op-time
        # OSError is the honest failure signal, not __init__.
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError:
            pass

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    # -- write machinery ----------------------------------------------
    def _write_atomic(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = tmp_path_for(path)
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
                if self.durable:
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _put(self, key: str, data: bytes) -> str:
        self._write_atomic(self._path(key), data)
        return token_of(data)

    def _put_if(self, key, data, if_token, if_absent) -> str:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock_path = path + _LOCK_SUFFIX
        with open(lock_path, "a+b") as lock_fh:
            fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
            try:
                try:
                    with open(path, "rb") as fh:
                        current = token_of(fh.read())
                except FileNotFoundError:
                    current = None
                if if_absent:
                    if current is not None:
                        raise CASConflictError(key, None, current)
                elif current != if_token:
                    raise CASConflictError(key, if_token, current)
                self._write_atomic(path, data)
            finally:
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_UN)
        return token_of(data)

    # -- reads ---------------------------------------------------------
    def _get(self, key: str) -> tuple:
        try:
            with open(self._path(key), "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            raise ObjectNotFoundError(key) from None
        return data, token_of(data)

    def _head(self, key: str):
        try:
            with open(self._path(key), "rb") as fh:
                return token_of(fh.read())
        except FileNotFoundError:
            return None

    def _delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def _walk(self, prefix: str):
        base = self._path(prefix) if prefix else self.root
        if os.path.isfile(base):
            yield prefix, os.path.basename(base)
            return
        for dirpath, _dirnames, filenames in os.walk(base):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel.replace(os.sep, "/")
            for name in filenames:
                yield (f"{rel}/{name}" if rel else name), name

    def _list(self, prefix: str) -> list:
        return [
            key for key, name in self._walk(prefix)
            if not is_tmp_name(name) and not name.endswith(_LOCK_SUFFIX)
        ]

    def list_uploads(self, prefix: str = "") -> list:
        """Torn uploads on POSIX are exactly the crashed writers'
        ``is_tmp_name`` files fsck has always swept."""
        return sorted(
            key for key, name in self._walk(prefix) if is_tmp_name(name)
        )

    def abort_upload(self, key: str) -> bool:
        if not is_tmp_name(os.path.basename(str(key))):
            return False
        try:
            os.unlink(self._path(str(key)))
            return True
        except OSError:
            return False
