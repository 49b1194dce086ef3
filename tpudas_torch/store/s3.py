"""S3-compatible backend: conditional puts via If-Match/If-None-Match.

Maps the store contract onto the S3 API surface every compatible
object store (AWS, GCS-XML, MinIO, R2, Ceph RGW) exposes:

- ``put``    → ``PutObject``
- ``put_if`` → ``PutObject`` with ``IfMatch=<token>`` or
  ``IfNoneMatch="*"`` (conditional writes; a 412
  ``PreconditionFailed`` is :class:`CASConflictError`)
- ``get``/``head``/``delete``/``list`` → the obvious calls, with
  404 → :class:`ObjectNotFoundError`/None and every 5xx, throttle, or
  connection error → :class:`StoreNetworkError` (the ``network``
  fault kind — retried upstream by :class:`RetryingStore`).
- ``list_uploads`` → ``ListMultipartUploads``: abandoned multipart
  uploads ARE the torn-upload debris fsck classifies.

Tokens are the service's ETags with quotes stripped.  For
single-part, non-SSE-KMS puts that is the hex MD5 of the bytes —
content-derived, so :meth:`token_for` computes the same formula
locally and lost-response recovery (token re-read, see
:mod:`tpudas_torch.store.retry`) works exactly as on the other backends.
Keep coordination artifacts under the multipart threshold (they are
tiny JSON) — multipart ETags are not content-derived and would
silently weaken recovery to "retry and maybe concede".

boto3 is an OPTIONAL dependency: the module imports lazily and
:class:`S3Store` raises a clear error at construction when it is
missing, so the package (and every other backend) works on a machine
with no AWS SDK.  Tests exercise this backend through ``client=`` —
any object honouring the handful of botocore methods/exceptions used
here — which is also the hook for instrumented or caching clients.
"""

from __future__ import annotations

import hashlib

from tpudas_torch.store.base import (
    CASConflictError,
    ObjectNotFoundError,
    ObjectStore,
    StoreError,
    StoreNetworkError,
)

__all__ = ["S3Store"]

_NOT_FOUND_CODES = ("404", "NoSuchKey", "NotFound")
_CONFLICT_CODES = ("412", "PreconditionFailed")


def _error_code(exc) -> str:
    """The service error code from a botocore ClientError-shaped
    exception ('' when the shape is unfamiliar)."""
    resp = getattr(exc, "response", None)
    if isinstance(resp, dict):
        err = resp.get("Error") or {}
        code = err.get("Code") or resp.get(
            "ResponseMetadata", {}
        ).get("HTTPStatusCode")
        return str(code or "")
    return ""


def _strip_quotes(etag) -> str:
    return str(etag or "").strip().strip('"')


class S3Store(ObjectStore):
    """Objects under ``s3://bucket/prefix``.  ``client`` is any
    boto3-s3-shaped object; omitted, one is built from the default
    session (requires boto3 installed and credentials configured)."""

    backend = "s3"

    def __init__(self, bucket: str, prefix: str = "", client=None,
                 region: str | None = None,
                 endpoint_url: str | None = None):
        self.bucket = str(bucket)
        self.prefix = str(prefix).strip("/")
        if client is None:
            try:
                import boto3
            except ImportError as exc:
                raise StoreError(
                    "S3Store needs boto3 (not installed in this "
                    "environment) or an explicit client="
                ) from exc
            client = boto3.client(
                "s3", region_name=region, endpoint_url=endpoint_url
            )
        self.client = client

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _translate(self, exc, key: str):
        """One exception funnel: 404 → not-found, 412 → CAS conflict,
        everything else the service/wire produced → network."""
        code = _error_code(exc)
        if code in _NOT_FOUND_CODES:
            return ObjectNotFoundError(key)
        if code in _CONFLICT_CODES:
            return CASConflictError(key, None, None)
        return StoreNetworkError(
            f"s3 {self.bucket}: {type(exc).__name__}"
            f"{f' [{code}]' if code else ''}: {str(exc)[:200]}"
        )

    # -- backend hooks -------------------------------------------------
    def _put(self, key: str, data: bytes) -> str:
        try:
            resp = self.client.put_object(
                Bucket=self.bucket, Key=self._k(key), Body=data
            )
        except Exception as exc:
            raise self._translate(exc, key) from exc
        return _strip_quotes(resp.get("ETag")) or self.token_for(data)

    def _put_if(self, key, data, if_token, if_absent) -> str:
        kwargs = dict(Bucket=self.bucket, Key=self._k(key), Body=data)
        if if_absent:
            kwargs["IfNoneMatch"] = "*"
        else:
            kwargs["IfMatch"] = f'"{if_token}"'
        try:
            resp = self.client.put_object(**kwargs)
        except Exception as exc:
            translated = self._translate(exc, key)
            if isinstance(translated, CASConflictError):
                raise CASConflictError(
                    key, None if if_absent else if_token,
                    self._head_quiet(key),
                ) from exc
            raise translated from exc
        return _strip_quotes(resp.get("ETag")) or self.token_for(data)

    def _get(self, key: str) -> tuple:
        try:
            resp = self.client.get_object(
                Bucket=self.bucket, Key=self._k(key)
            )
            data = resp["Body"].read()
        except Exception as exc:
            raise self._translate(exc, key) from exc
        return data, (
            _strip_quotes(resp.get("ETag")) or self.token_for(data)
        )

    def _head_quiet(self, key: str):
        """Token or None, swallowing even network errors — only used
        to enrich a conflict report."""
        try:
            return self._head(key)
        except (ObjectNotFoundError, StoreNetworkError):
            return None

    def _head(self, key: str):
        try:
            resp = self.client.head_object(
                Bucket=self.bucket, Key=self._k(key)
            )
        except Exception as exc:
            translated = self._translate(exc, key)
            if isinstance(translated, ObjectNotFoundError):
                return None
            raise translated from exc
        return _strip_quotes(resp.get("ETag")) or None

    def _delete(self, key: str) -> bool:
        existed = self._head(key) is not None
        try:
            self.client.delete_object(
                Bucket=self.bucket, Key=self._k(key)
            )
        except Exception as exc:
            translated = self._translate(exc, key)
            if isinstance(translated, ObjectNotFoundError):
                return False
            raise translated from exc
        return existed

    def _list(self, prefix: str) -> list:
        full = self._k(prefix) + "/" if prefix else (
            f"{self.prefix}/" if self.prefix else ""
        )
        strip = len(f"{self.prefix}/") if self.prefix else 0
        keys, token = [], None
        while True:
            kwargs = dict(Bucket=self.bucket, Prefix=full)
            if token:
                kwargs["ContinuationToken"] = token
            try:
                resp = self.client.list_objects_v2(**kwargs)
            except Exception as exc:
                raise self._translate(exc, prefix) from exc
            for item in resp.get("Contents") or []:
                keys.append(str(item["Key"])[strip:])
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        # an exact-key prefix (a file, not a folder) needs one more look
        if prefix and not keys:
            tok = self._head(prefix)
            if tok is not None:
                keys.append(prefix)
        return keys

    def list_uploads(self, prefix: str = "") -> list:
        full = self._k(prefix) if prefix else self.prefix
        strip = len(f"{self.prefix}/") if self.prefix else 0
        try:
            resp = self.client.list_multipart_uploads(
                Bucket=self.bucket, Prefix=full
            )
        except Exception as exc:
            raise self._translate(exc, prefix) from exc
        return sorted(
            str(u["Key"])[strip:] for u in resp.get("Uploads") or []
        )

    def abort_upload(self, key: str) -> bool:
        full = self._k(str(key))
        try:
            resp = self.client.list_multipart_uploads(
                Bucket=self.bucket, Prefix=full
            )
            aborted = False
            for up in resp.get("Uploads") or []:
                if str(up.get("Key")) != full:
                    continue
                self.client.abort_multipart_upload(
                    Bucket=self.bucket, Key=full,
                    UploadId=up.get("UploadId"),
                )
                aborted = True
            return aborted
        except Exception as exc:
            raise self._translate(exc, key) from exc

    def token_for(self, data: bytes) -> str:
        """Single-part PutObject ETag = hex MD5 of the bytes (matches
        the service for non-multipart, non-KMS objects — the only
        kind this plane writes for coordination artifacts)."""
        return hashlib.md5(bytes(data)).hexdigest()
