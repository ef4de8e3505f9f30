"""Production store service: asyncio HTTP tier over the array store, on the card.

Counterpart of ``repro/serve/service/app.py``, with the same routes, status
codes, headers, JSON keys and error envelopes, so a client of either
package talks to a server of either package.  :class:`StoreService` is a
SYNCHRONOUS request core (route -> :class:`Response`), shared verbatim by
three frontends -- the stdlib ``asyncio.start_server`` HTTP/1.1 server
(:class:`HttpServer`, the default), a uvicorn-compatible ASGI adapter
(:func:`asgi_app`, optional, no hard dependency), and direct in-process
calls (tests).  Chunk decodes run on the event loop's default thread-pool
executor, so the accept/parse path never blocks behind a decode.

Endpoints (all GET/HEAD):

    /v1/                               service + store summary (JSON)
    /v1/metrics                        cache hit/miss/eviction counters,
                                       per-route latency, per-tenant usage
    /v1/stores                         registered store names
    /v1/stores/{name}/info             geometry of the CURRENT file (410 if
                                       the backing file vanished)
    /v1/stores/{name}/read?roi=...     decoded ROI; ETag + If-None-Match/304
    /v1/stores/{name}/stats[?header_only=1]   compressed-domain query
    /v1/stores/{name}/raw[?shard=i]    compressed file bytes; Range/206
    /v1/stores/{name}/chunk/{cid}      one chunk's compressed frame; 307
                                       redirect when a remote shard owns it
    /info /stats /read                 legacy single-store aliases (default
                                       store)

ROIs and queries decode on the service's ``device`` (the card unless the
caller asks for the CPU), through the host parse and the unpack kernels or,
with ``fused_range=True``, the fused range decode.  Every decoded ROI is
assembled on the card from the shared decoded-chunk LRU cache (:mod:`.cache`,
which holds device memory): hot chunks decode once and serve every reader.
A ``/read`` body is one blocking device-to-host copy of the assembled ROI
(``device.to_host``), so no byte is written before the card has produced
it.  ETags are strong (container footer CRC, :func:`.registry.compute_etag`),
so CDN and client caches revalidate with If-None-Match for free.  Errors are
JSON envelopes ``{"error": {"code", "message"}}`` (legacy routes keep their
flat ``{"error": msg}`` shape).

Tenancy: requests carry an optional ``X-Tenant`` header (default
``"anonymous"``); the registry enforces per-tenant request/byte quotas
(429 when spent).
"""
from __future__ import annotations

import asyncio
import json
import os
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

import torch

from repro_torch import obs
from repro_torch.core.codec.device import resolve_device, to_host
from repro_torch.core.codec.tree import dtype_name
from repro_torch.serve.service.cache import LRUBytesCache
from repro_torch.serve.service.metrics import Metrics
from repro_torch.serve.service.registry import (
    QuotaExceeded,
    StoreGone,
    StoreNotFound,
    StoreRegistry,
)
from repro_torch.store.grid import parse_roi

_REASONS = {
    200: "OK", 206: "Partial Content", 304: "Not Modified",
    307: "Temporary Redirect", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 410: "Gone", 416: "Range Not Satisfiable",
    429: "Too Many Requests", 500: "Internal Server Error",
}


@dataclass
class Response:
    status: int
    body: bytes = b""
    headers: list = field(default_factory=list)
    content_type: str = "application/octet-stream"


def _json_response(status: int, payload, headers: list | None = None) -> Response:
    return Response(
        status, json.dumps(payload).encode(), headers or [],
        "application/json",
    )


def _error(status: int, message: str, *, legacy: bool = False) -> Response:
    payload = {"error": message} if legacy else \
        {"error": {"code": status, "message": message}}
    return _json_response(status, payload)


class _HandledError(Exception):
    """Internal control flow: carries a finished error Response."""

    def __init__(self, resp: Response):
        self.resp = resp


class StoreService:
    """The synchronous request core shared by every frontend.

    ``device`` is where the stores decode (``None``: the card, which must be
    there); ``fused_range`` picks the decode route, as ``ArrayStore.open``
    takes it.  ``cache_bytes`` bounds the decoded chunks held on ``device``.
    """

    def __init__(self, *, device=None, fused_range: bool = False,
                 cache_bytes: int = 256 << 20,
                 quota_requests: int | None = None,
                 quota_bytes: int | None = None):
        self.device = resolve_device(device, "StoreService")
        self.cache = LRUBytesCache(cache_bytes)
        self.registry = StoreRegistry(
            device=self.device, fused_range=fused_range, cache=self.cache,
            quota_requests=quota_requests, quota_bytes=quota_bytes,
        )
        self.metrics = Metrics()
        self.default_store: str | None = None

    def add_store(self, name: str, path) -> None:
        self.registry.add(name, path)
        if self.default_store is None:
            self.default_store = name

    def close(self) -> None:
        self.registry.close()

    # ------------------------------------------------------------ dispatch
    def handle(self, method: str, target: str, headers: dict) -> Response:
        """One request -> one Response.  ``headers`` keys are lower-case."""
        t0 = time.perf_counter()
        url = urllib.parse.urlsplit(target)
        q = urllib.parse.parse_qs(url.query)
        tenant = headers.get("x-tenant", "anonymous")
        route = url.path
        try:
            if method not in ("GET", "HEAD"):
                resp = _error(405, f"method {method} not allowed")
            else:
                with obs.span("serve.request", route=route):
                    self.registry.charge(tenant, requests=1)
                    resp = self._route(url.path, q, headers)
                self.registry.charge(tenant, nbytes=len(resp.body))
        except _HandledError as err:
            resp = err.resp
        except QuotaExceeded as err:
            resp = _error(429, str(err))
        except StoreNotFound as err:
            resp = _error(404, f"unknown store {err.args[0]!r}")
        except StoreGone as err:
            resp = _error(410, str(err))
        except (ValueError, TypeError, IndexError, KeyError) as err:
            legacy = not url.path.startswith("/v1/")
            resp = _error(400, str(err), legacy=legacy)
        resp.headers = [("Content-Type", resp.content_type)] + resp.headers
        self.metrics.observe(
            route, resp.status, time.perf_counter() - t0, len(resp.body),
            tenant,
        )
        return resp

    def _route(self, path: str, q: dict, headers: dict) -> Response:
        if path in ("/v1", "/v1/"):
            return self._summary()
        if path == "/v1/metrics":
            return self._metrics(headers)
        if path == "/v1/stores":
            return _json_response(200, {"stores": self.registry.names()})
        if path.startswith("/v1/stores/"):
            rest = path[len("/v1/stores/"):]
            name, _, verb = rest.partition("/")
            if verb == "info":
                return self._info(name, headers)
            if verb == "read":
                return self._read(name, q, headers)
            if verb == "stats":
                return self._stats(name, q)
            if verb == "raw":
                return self._raw(name, q, headers)
            if verb.startswith("chunk/"):
                return self._chunk(name, verb[len("chunk/"):], headers)
            raise _HandledError(_error(404, f"unknown path {path}"))
        # ------------------------------------------- legacy single-store API
        if self.default_store is not None:
            if path == "/info":
                return self._info(self.default_store, headers, legacy=True)
            if path == "/stats":
                return self._stats(self.default_store, q)
            if path == "/read":
                return self._read(self.default_store, q, headers)
        raise _HandledError(
            _error(404, f"unknown path {path}",
                   legacy=not path.startswith("/v1/"))
        )

    # ------------------------------------------------------------ endpoints
    def _summary(self) -> Response:
        stores = {}
        for name in self.registry.names():
            entry = self.registry.entry(name)
            try:
                with entry.acquire() as (ca, etag):
                    stores[name] = {
                        "shape": list(ca.shape), "dtype": dtype_name(ca.dtype),
                        "etag": etag,
                        "sharded": entry.path.endswith(".json"),
                    }
            except StoreGone:
                stores[name] = {"gone": True}
        return _json_response(200, {
            "service": "repro-store", "api": "v1", "stores": stores,
            "endpoints": [
                "/v1/metrics", "/v1/stores",
                "/v1/stores/{name}/info", "/v1/stores/{name}/read?roi=...",
                "/v1/stores/{name}/stats", "/v1/stores/{name}/raw",
                "/v1/stores/{name}/chunk/{cid}",
            ],
        })

    def _metrics(self, headers: dict | None = None) -> Response:
        """JSON snapshot (default, schema unchanged) or -- with
        ``Accept: text/plain`` -- the shared registry's Prometheus text
        exposition, which includes codec/store/cache series when telemetry
        is enabled."""
        cache_stats = self.cache.stats()
        if obs.enabled():
            for k, v in cache_stats.items():
                if isinstance(v, (int, float)):
                    obs.gauge("serve.cache", stat=k).set(v)
        accept = (headers or {}).get("accept", "")
        if "text/plain" in accept:
            return Response(
                200, obs.prometheus_text().encode(), [],
                "text/plain; version=0.0.4; charset=utf-8",
            )
        snap = self.metrics.snapshot()
        snap["cache"] = cache_stats
        if obs.enabled():
            # additive key: shared-registry view (codec/store/ingest series)
            snap["obs"] = obs.REGISTRY.snapshot()
        return _json_response(200, snap)

    @staticmethod
    def _not_modified(headers: dict, etag: str) -> bool:
        inm = headers.get("if-none-match")
        if inm is None:
            return False
        return inm.strip() == "*" or etag in [
            t.strip() for t in inm.split(",")
        ]

    def _info(self, name: str, headers: dict, *, legacy: bool = False
              ) -> Response:
        entry = self.registry.entry(name)
        # served from the CURRENT handle (revalidated against the file), so
        # replacing the store file is reflected immediately and a vanished
        # file answers 410 -- not the stale startup snapshot
        with entry.acquire() as (ca, etag):
            if self._not_modified(headers, etag):
                return Response(304, b"", [("ETag", etag)])
            meta = {
                "shape": list(ca.shape),
                "chunk_shape": list(ca.chunk_shape),
                "dtype": dtype_name(ca.dtype),
                "e": ca.error_bound,
                "nchunks": ca.nchunks,
                "raw_bytes": ca.nbytes,
                "stored_bytes": ca.stored_bytes,
            }
            if not legacy:
                meta.update(
                    name=name, etag=etag, attrs=ca.attrs,
                    sharded=entry.path.endswith(".json"),
                )
            return _json_response(200, meta, [("ETag", etag)])

    def _read(self, name: str, q: dict, headers: dict) -> Response:
        roi = parse_roi(q.get("roi", [None])[0])
        entry = self.registry.entry(name)
        with entry.acquire() as (ca, etag):
            if self._not_modified(headers, etag):
                return Response(304, b"", [("ETag", etag)])
            out = ca[roi]
            # one blocking copy to the host: the decode is complete on the
            # card before its bytes are taken
            body = to_host(out.contiguous()).reshape(-1).view(torch.uint8).numpy().tobytes()
            return Response(200, body, [
                ("ETag", etag),
                ("X-Dtype", dtype_name(out.dtype)),
                ("X-Shape", ",".join(map(str, out.shape))),
            ])

    def _stats(self, name: str, q: dict) -> Response:
        header_only = q.get("header_only", ["0"])[0] not in ("0", "")
        entry = self.registry.entry(name)
        with entry.acquire() as (ca, _etag):
            return _json_response(200, ca.stats(header_only=header_only).to_dict())

    def _raw_target(self, entry, q: dict) -> str:
        """Resolve the raw byte target: the store file, or one shard."""
        man = entry.manifest()
        if man is None:
            if "shard" in q:
                raise ValueError("single-file store has no shards")
            return entry.path
        si = int(q.get("shard", ["0"])[0])
        shards = man["shards"]
        if not 0 <= si < len(shards):
            raise ValueError(f"shard {si} out of range [0, {len(shards)})")
        loc = str(shards[si]["file"])
        if "://" in loc:
            raise _HandledError(Response(
                307, b"", [("Location", loc)], "text/plain",
            ))
        return os.path.join(os.path.dirname(entry.path), loc)

    def _raw(self, name: str, q: dict, headers: dict) -> Response:
        """Compressed byte ranges -- the CDN-cacheable path.  ``Range:
        bytes=lo-hi`` serves 206 with ``Content-Range``; a syntactically
        valid but unsatisfiable range serves 416."""
        entry = self.registry.entry(name)
        # etag WITHOUT a decode handle: raw bytes must stay servable for
        # manifests whose other shards live behind URLs
        etag = entry.etag_only()
        target = self._raw_target(entry, q)
        if self._not_modified(headers, etag):
            return Response(304, b"", [("ETag", etag)])
        try:
            size = os.path.getsize(target)
        except FileNotFoundError:
            raise StoreGone(
                f"store {name!r}: shard file {target} vanished"
            ) from None
        rng = headers.get("range")
        base = [("ETag", etag), ("Accept-Ranges", "bytes")]
        if rng is None:
            with open(target, "rb") as f:
                return Response(200, f.read(), base)
        lo, hi = _parse_range(rng, size)
        if lo is None:
            return Response(416, b"", base + [
                ("Content-Range", f"bytes */{size}"),
            ])
        with open(target, "rb") as f:
            f.seek(lo)
            body = f.read(hi - lo + 1)
        return Response(206, body, base + [
            ("Content-Range", f"bytes {lo}-{hi}/{size}"),
        ])

    def _chunk(self, name: str, cid_text: str, headers: dict) -> Response:
        """One chunk's compressed frame bytes (random access by chunk id).
        When a REMOTE shard owns the chunk, answer 307 to the shard URL with
        the frame's byte range in ``X-Chunk-Offset``/``X-Chunk-Length`` so
        the client can Range-request it there."""
        cid = int(cid_text)
        entry = self.registry.entry(name)
        man = entry.manifest()
        if man is not None:
            for sh in man["shards"]:
                lo, hi = (int(v) for v in sh["chunks"])
                if lo <= cid < hi:
                    off, length, _elems = (
                        int(v) for v in sh["frames"][cid - lo]
                    )
                    loc = str(sh["file"])
                    if "://" in loc:
                        return Response(307, b"", [
                            ("Location", loc),
                            ("X-Chunk-Offset", str(off)),
                            ("X-Chunk-Length", str(length)),
                        ], "text/plain")
                    path = os.path.join(os.path.dirname(entry.path), loc)
                    etag = entry.etag_only()
                    if self._not_modified(headers, etag):
                        return Response(304, b"", [("ETag", etag)])
                    with open(path, "rb") as f:
                        f.seek(off)
                        body = f.read(length)
                    return Response(200, body, [("ETag", etag)])
            raise ValueError(f"chunk {cid} out of range")
        with entry.acquire() as (ca, etag):
            if self._not_modified(headers, etag):
                return Response(304, b"", [("ETag", etag)])
            if not 0 <= cid < ca.nchunks:
                raise ValueError(
                    f"chunk {cid} out of range [0, {ca.nchunks})"
                )
            off, length, _elems = (int(v) for v in ca._frames[cid])
            f = ca._src(cid)
            f.seek(off)
            body = f.read(length)
        return Response(200, body, [("ETag", etag)])


def _parse_range(text: str, size: int):
    """One ``bytes=lo-hi`` range -> inclusive (lo, hi), or (None, None) when
    unsatisfiable.  Malformed syntax raises ValueError (-> 400); suffix form
    ``bytes=-N`` and open end ``bytes=lo-`` follow RFC 9110."""
    unit, _, spec = text.partition("=")
    if unit.strip() != "bytes" or "," in spec:
        raise ValueError(f"unsupported Range {text!r}")
    lo_s, dash, hi_s = spec.strip().partition("-")
    if not dash:
        raise ValueError(f"malformed Range {text!r}")
    if not lo_s:                         # suffix: last N bytes
        n = int(hi_s)
        if n == 0:
            return None, None
        return max(size - n, 0), size - 1
    lo = int(lo_s)
    hi = int(hi_s) if hi_s else size - 1
    if lo >= size or hi < lo:
        return None, None
    return lo, min(hi, size - 1)


# ---------------------------------------------------------------- asyncio tier
class HttpServer:
    """stdlib-asyncio HTTP/1.1 frontend with the ThreadingHTTPServer-ish
    lifecycle the existing callers/tests expect: bind in the constructor
    (``server_address`` is known immediately), blocking ``serve_forever``
    on any thread, thread-safe ``shutdown()``, idempotent ``server_close``.
    """

    def __init__(self, service: StoreService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._sock = socket.create_server((host, port))
        self.server_address = self._sock.getsockname()[:2]
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._done = threading.Event()
        self._stop: asyncio.Event | None = None

    def serve_forever(self) -> None:
        try:
            asyncio.run(self._main())
        finally:
            self._done.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._client, sock=self._sock)
        self._started.set()
        try:
            await self._stop.wait()
        finally:
            server.close()
            await server.wait_closed()

    def shutdown(self) -> None:
        """Stop serve_forever from any thread; returns when it exited."""
        if not self._started.is_set():
            return
        self._loop.call_soon_threadsafe(self._stop.set)
        self._done.wait()

    def server_close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self.service.close()

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    method, target, version = line.decode("latin1").split()
                except ValueError:
                    break
                headers: dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                # GET/HEAD only: any request body is unread by design
                resp = await loop.run_in_executor(
                    None, self.service.handle, method, target, headers,
                )
                keep = (version == "HTTP/1.1"
                        and headers.get("connection", "").lower() != "close")
                body = b"" if method == "HEAD" else resp.body
                out = [f"HTTP/1.1 {resp.status} "
                       f"{_REASONS.get(resp.status, 'Unknown')}\r\n"]
                for k, v in resp.headers:
                    out.append(f"{k}: {v}\r\n")
                out.append(f"Content-Length: {len(resp.body)}\r\n")
                out.append(
                    f"Connection: {'keep-alive' if keep else 'close'}\r\n\r\n"
                )
                writer.write("".join(out).encode("latin1") + body)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


def asgi_app(service: StoreService):
    """Uvicorn-compatible ASGI 3 adapter over the same request core.

        uvicorn "my_module:app"   where   app = asgi_app(service)

    Optional: nothing imports this unless an ASGI server is in play, so the
    service keeps zero non-stdlib dependencies.
    """

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":          # accept startup/shutdown
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
            return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope {scope['type']!r}")
        while True:                              # drain any request body
            msg = await receive()
            if msg["type"] != "http.request" or not msg.get("more_body"):
                break
        target = scope["path"]
        if scope.get("query_string"):
            target += "?" + scope["query_string"].decode("latin1")
        headers = {
            k.decode("latin1").lower(): v.decode("latin1")
            for k, v in scope.get("headers", [])
        }
        loop = asyncio.get_running_loop()
        resp = await loop.run_in_executor(
            None, service.handle, scope["method"], target, headers,
        )
        await send({
            "type": "http.response.start",
            "status": resp.status,
            "headers": [
                (k.encode("latin1"), v.encode("latin1"))
                for k, v in resp.headers
            ] + [(b"content-length", str(len(resp.body)).encode())],
        })
        body = b"" if scope["method"] == "HEAD" else resp.body
        await send({"type": "http.response.body", "body": body})

    return app
