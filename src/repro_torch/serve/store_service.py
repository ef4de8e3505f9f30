"""HTTP slice/query service over compressed array stores, on the card.

Counterpart of ``repro/serve/store_service.py``: the front door of the
serving tier in :mod:`repro_torch.serve.service`.  The legacy single-store
endpoints --

    /info                    store geometry (JSON)
    /stats[?header_only=1]   compressed-domain aggregate query (JSON)
    /read?roi=0:16,:,3       ROI slice; raw little-endian bytes
                             (C order, dtype/shape in X-Dtype/X-Shape headers)

-- and the full ``/v1`` API (multi-store registry, decoded-chunk LRU cache,
ETag/If-None-Match, Range over compressed bytes, shard redirects, metrics,
quotas) are served by the same process; see
:mod:`repro_torch.serve.service.app`.

Telemetry: every request -- legacy routes included -- flows through the
shared :class:`~repro_torch.serve.service.app.StoreService` core, which wraps
each handler in one ``serve.request`` span and mirrors counters/latency into
the shared :mod:`repro_torch.obs` registry when ``SZX_OBS=1``;
``GET /v1/metrics`` with ``Accept: text/plain`` serves the Prometheus
exposition.

Start it with ``python -m repro_torch.store serve FILE`` or
:func:`serve_store`; :func:`make_server` is the embeddable/testable hook --
it binds the socket synchronously (``server_address`` is valid before
``serve_forever`` runs) and keeps the ThreadingHTTPServer-style lifecycle
(``serve_forever``/``shutdown``/``server_close``).  ``device`` is where the
stores decode (``None``: the card, which must be there) and
``fused_range`` picks the decode route, as ``ArrayStore.open`` takes them.
"""
from __future__ import annotations

from repro_torch.serve.service.app import HttpServer, StoreService, asgi_app

__all__ = ["make_server", "serve_store", "make_service", "asgi_app"]

DEFAULT_CACHE_BYTES = 256 << 20


def make_service(path: str | None = None, *, device=None, fused_range: bool = False,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 quota_requests: int | None = None,
                 quota_bytes: int | None = None) -> StoreService:
    """Build the request core, optionally pre-registering one default store.

    ``path`` may be a single ``.szs`` store file or a shard-manifest
    ``.json``; more stores can be added later with ``service.add_store``.
    """
    service = StoreService(
        device=device, fused_range=fused_range, cache_bytes=cache_bytes,
        quota_requests=quota_requests, quota_bytes=quota_bytes,
    )
    if path is not None:
        service.add_store("default", path)
    return service


def make_server(path: str, host: str = "127.0.0.1", port: int = 0, *, device=None,
                fused_range: bool = False,
                cache_bytes: int = DEFAULT_CACHE_BYTES) -> HttpServer:
    """Build (but do not run) the HTTP server for one store file.

    The returned object binds its socket immediately and exposes
    ``server_address``, ``serve_forever()``, ``shutdown()`` and
    ``server_close()``.
    """
    service = make_service(path, device=device, fused_range=fused_range,
                           cache_bytes=cache_bytes)
    return HttpServer(service, host, port)


def serve_store(path: str, host: str = "127.0.0.1", port: int = 8117, *, device=None,
                fused_range: bool = False) -> None:
    """Run the service until interrupted (the ``python -m repro_torch.store
    serve`` entry point)."""
    srv = make_server(path, host, port, device=device, fused_range=fused_range)
    host, port = srv.server_address[:2]
    print(f"serving compressed array store {path} on http://{host}:{port} "
          "(/info /stats /read?roi=... + /v1/...)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
