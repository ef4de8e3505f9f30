"""Multi-store registry: named stores, revalidating handles, ETags, quotas.

Counterpart of ``repro/serve/service/registry.py``.  Each registered store
is opened lazily and REVALIDATED on every access against the backing file's
``(mtime_ns, size, inode)`` signature: replacing the file atomically swaps
in a fresh handle (and a fresh ETag, which also namespaces the
decoded-chunk cache -- stale entries die by key, not by flush), and a
vanished file raises :class:`StoreGone` so the service answers 410 instead
of serving stale startup metadata.

ETags are STRONG validators derived from the container index footer's
CRC32 (the trailer field that already authenticates the index) plus the
file size; a sharded store's ETag is the CRC32 of its manifest JSON.  Two
byte-identical stores get the same ETag -- whichever package wrote or
serves them -- and any content change flips it.

Handles decode on the registry's ``device`` by the route ``fused_range``
picks (``ArrayStore.open``'s two options).  Per-tenant quotas are
cumulative request/byte budgets checked before the work is done;
exceeding one raises :class:`QuotaExceeded` (served as 429).
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from contextlib import contextmanager

from repro_torch.core.codec import container
from repro_torch.store.array import ArrayStore


class StoreNotFound(KeyError):
    """No store registered under that name (-> 404)."""


class StoreGone(RuntimeError):
    """The store's backing file vanished after registration (-> 410)."""


class QuotaExceeded(RuntimeError):
    """The tenant's request or byte budget is spent (-> 429)."""


def compute_etag(path: str) -> str:
    """Strong ETag of a store file or manifest (no full-file read).

    Store files: the index trailer's CRC32 over the footer JSON -- one
    fixed-size read at the tail.  Manifests (or any file without a trailer):
    CRC32 of the file bytes (manifests are small).
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size >= container.INDEX_TRAILER.size:
            f.seek(size - container.INDEX_TRAILER.size)
            tail = f.read(container.INDEX_TRAILER.size)
            magic, _v, _flags, _res, _length, crc = container.INDEX_TRAILER.unpack(tail)
            if magic == container.INDEX_MAGIC:
                return f'"{crc:08x}-{size:x}"'
        f.seek(0)
        crc = zlib.crc32(f.read())
    return f'"{crc:08x}-{size:x}"'


def _sig(path: str):
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size, st.st_ino)


class _Entry:
    """One registered store: path + revalidated handle + ETag."""

    def __init__(self, name: str, path: str, *, device, fused_range: bool, cache):
        self.name = name
        self.path = os.fspath(path)
        self.device = device
        self.fused_range = fused_range
        self.cache = cache
        self.lock = threading.Lock()   # CompressedArray is not thread-safe
        self._handle = None
        self._sig = None
        self.etag = None

    def _gone(self) -> StoreGone:
        return StoreGone(f"store {self.name!r}: backing file {self.path} vanished")

    def _revalidate_locked(self) -> None:
        try:
            sig = _sig(self.path)
        except FileNotFoundError:
            if self._handle is not None:
                self._handle.close()
                self._handle = None
            raise self._gone() from None
        if self._handle is not None and sig == self._sig:
            return
        if self._handle is not None:
            self._handle.close()
            self._handle = None
        etag = compute_etag(self.path)
        self._handle = ArrayStore.open(
            self.path, device=self.device, fused_range=self.fused_range,
            cache=self.cache, cache_ns=f"{self.name}:{etag}",
        )
        self._sig = sig
        self.etag = etag

    @contextmanager
    def acquire(self):
        """Exclusive access to the CURRENT handle: ``(array, etag)``.

        Exclusive because a CompressedArray carries one seek cursor per
        file; the decoded-chunk cache in front of it is what concurrent
        readers actually share.
        """
        with self.lock:
            self._revalidate_locked()
            yield self._handle, self.etag

    def etag_only(self) -> str:
        """The current ETag WITHOUT opening a decode handle.

        Needed for raw-byte and shard routes on manifests that reference
        remote shards (``ArrayStore.open`` requires local files).
        """
        try:
            return compute_etag(self.path)
        except FileNotFoundError:
            raise self._gone() from None

    def manifest(self) -> dict | None:
        """The parsed shard manifest, or None for single-file stores."""
        if not self.path.endswith(".json"):
            return None
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise self._gone() from None

    def close(self) -> None:
        with self.lock:
            if self._handle is not None:
                self._handle.close()
                self._handle = None


class TenantQuota:
    """Cumulative per-tenant budgets (None = unlimited)."""

    def __init__(self, max_requests: int | None = None, max_bytes: int | None = None):
        self.max_requests = max_requests
        self.max_bytes = max_bytes
        self.requests = 0
        self.bytes = 0

    def charge(self, *, requests: int = 0, nbytes: int = 0) -> None:
        if (requests and self.max_requests is not None
                and self.requests + requests > self.max_requests):
            raise QuotaExceeded("request quota exhausted")
        if (nbytes and self.max_bytes is not None
                and self.bytes + nbytes > self.max_bytes):
            raise QuotaExceeded("byte quota exhausted")
        self.requests += requests
        self.bytes += nbytes


class StoreRegistry:
    """Named stores decoding on ``device`` (a resolved ``torch.device``) by
    the route ``fused_range`` picks, sharing ``cache``."""

    def __init__(self, *, device, fused_range: bool = False, cache=None,
                 quota_requests: int | None = None, quota_bytes: int | None = None):
        self.device = device
        self.fused_range = fused_range
        self.cache = cache
        self._stores: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self._quotas: dict[str, TenantQuota] = {}
        self._quota_defaults = (quota_requests, quota_bytes)

    def add(self, name: str, path) -> _Entry:
        if not name or "/" in name:
            raise ValueError(f"bad store name {name!r}")
        entry = _Entry(name, path, device=self.device, fused_range=self.fused_range,
                       cache=self.cache)
        with self._lock:
            self._stores[name] = entry
        return entry

    def remove(self, name: str) -> None:
        with self._lock:
            entry = self._stores.pop(name, None)
        if entry is not None:
            entry.close()

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._stores)

    def entry(self, name: str) -> _Entry:
        with self._lock:
            entry = self._stores.get(name)
        if entry is None:
            raise StoreNotFound(name)
        return entry

    def close(self) -> None:
        with self._lock:
            entries = list(self._stores.values())
            self._stores.clear()
        for e in entries:
            e.close()

    # ------------------------------------------------------------- quotas
    def set_quota(self, tenant: str, *, max_requests: int | None = None,
                  max_bytes: int | None = None) -> None:
        with self._lock:
            self._quotas[tenant] = TenantQuota(max_requests, max_bytes)

    def charge(self, tenant: str, *, requests: int = 0, nbytes: int = 0) -> None:
        with self._lock:
            q = self._quotas.get(tenant)
            if q is None:
                mr, mb = self._quota_defaults
                if mr is None and mb is None:
                    return
                q = self._quotas[tenant] = TenantQuota(mr, mb)
            q.charge(requests=requests, nbytes=nbytes)
