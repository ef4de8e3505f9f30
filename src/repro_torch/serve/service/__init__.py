"""Production store serving tier, on the card.

Counterpart of ``repro/serve/service``:

- :mod:`.app` -- the synchronous request core (:class:`~.app.StoreService`),
  the stdlib-asyncio HTTP frontend (:class:`~.app.HttpServer`) and the
  optional ASGI adapter (:func:`~.app.asgi_app`).
- :mod:`.cache` -- size-bounded decoded-chunk LRU shared by all stores
  (device memory).
- :mod:`.registry` -- named stores, revalidating handles, ETags, quotas.
- :mod:`.metrics` -- request counters and latency percentiles.
"""
from repro_torch.serve.service.app import HttpServer, StoreService, asgi_app
from repro_torch.serve.service.cache import LRUBytesCache
from repro_torch.serve.service.metrics import Metrics
from repro_torch.serve.service.registry import (
    QuotaExceeded,
    StoreGone,
    StoreNotFound,
    StoreRegistry,
    compute_etag,
)

__all__ = [
    "HttpServer",
    "LRUBytesCache",
    "Metrics",
    "QuotaExceeded",
    "StoreGone",
    "StoreNotFound",
    "StoreRegistry",
    "StoreService",
    "asgi_app",
    "compute_etag",
]
