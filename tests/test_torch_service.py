"""repro_torch.serve (the HTTP store service and its client) against the JAX package's.

Runs the port on the CPU (``device="cpu"``: the plain versions) and holds it
to ``repro.serve`` (``backend="numpy"``) in one process.  Each package
writes its own store of the same walk (made from a numpy seed; f32, f64,
f16, bf16; one file and two shards), and the files must be byte-identical.
Then both ``StoreService.handle``s answer every route -- the ``/v1`` API,
the legacy ``/info``, ``/stats`` and ``/read``, ``Range`` over raw bytes,
chunk frames, ``If-None-Match``, 405, 410, 429, the 400 envelopes, the 307
of a URL shard -- with the same status, body bytes and headers (for
``/v1/metrics`` the same keys and counters; latencies differ).  Over
sockets, each package's ``RemoteStore`` reads the other's ``HttpServer``,
``StoreLoader`` over the port's server equals the reference loader over the
reference's and the port's local loader bit for bit, and ``python -m
repro_torch.store serve`` answers in a subprocess.  The reference's own
service tests (``tests/test_service.py``) are mirrored as parametrised
cases.  The tolerance is exact throughout.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import StoreLoader as RLoader
from repro.serve.client import RemoteStore as RRemote
from repro.serve.service.app import HttpServer as RHttpServer
from repro.serve.service.app import _parse_range as r_parse_range
from repro.serve.service.cache import LRUBytesCache as RCache
from repro.serve.store_service import make_service as rmake_service
from repro.store import ArrayStore as RStore
from repro_torch import obs
from repro_torch.api import RemoteStore
from repro_torch.data import StoreLoader
from repro_torch.serve.client import roi_text
from repro_torch.serve.service import HttpServer, LRUBytesCache, asgi_app, compute_etag
from repro_torch.serve.service.app import _parse_range
from repro_torch.serve.store_service import make_server, make_service
from repro_torch.store import ArrayStore
from repro_torch.store.grid import parse_roi

ROOT = Path(__file__).resolve().parent.parent
BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
LAYOUTS = ["single", "sharded"]
SHAPE, CHUNK = (40, 64), (8, 64)
ROIS = [None, "...", ":,:", "0:8,0:64", "7:25,3:61", "39:40,63:64", "5", "3,4", "-1",
        "...,2", "4:4", "20:,:7"]
BAD_ROIS = ["bogus", "99", "0:100,0,0", "1:2:3:4", "0:5:2"]
COMPARED = ("Content-Type", "ETag", "X-Dtype", "X-Shape", "Accept-Ranges", "Content-Range",
            "Location", "X-Chunk-Offset", "X-Chunk-Length")


def _walk(shape=SHAPE, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.cumsum(rng.standard_normal(n)) * 0.01).reshape(shape).astype(dtype)


def _bound(dtype) -> float:
    return 1e-3 if dtype.itemsize >= 4 else 1e-2


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _write_stores(tmp_path, dtype, layout, seed=0):
    """(reference store path, port store path) of the same walk, each
    package writing its own (a manifest + 2 shards, or one file)."""
    x = _walk(seed=seed, dtype=dtype)
    paths = []
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        if layout == "single":
            p = d / "s.szs"
            if pkg == "ref":
                RStore.save(str(p), x, _bound(dtype), chunk_shape=CHUNK, attrs={"units": "K"})
            else:
                ArrayStore.save(str(p), x, _bound(dtype), chunk_shape=CHUNK,
                                attrs={"units": "K"}, device="cpu")
        else:
            p = d / "s.json"
            if pkg == "ref":
                RStore.save_sharded(str(p), x, _bound(dtype), nshards=2, chunk_shape=CHUNK,
                                    attrs={"units": "K"})
            else:
                ArrayStore.save_sharded(str(p), x, _bound(dtype), nshards=2, chunk_shape=CHUNK,
                                        attrs={"units": "K"}, device="cpu")
        paths.append(p)
    return x, paths[0], paths[1]


def _services(ref_path, port_path, **kw):
    rs = rmake_service(**kw)
    ps = make_service(device="cpu", **kw)
    for svc, p in ((rs, ref_path), (ps, port_path)):
        svc.add_store("s", str(p))
    return rs, ps


def _hdrs(resp) -> dict:
    return {k: v for k, v in resp.headers if k in COMPARED}


def _exact_stats(target: str) -> bool:
    path, _, query = target.partition("?")
    return path.endswith("stats") and "header_only=1" not in query


def _same_exact_stats(a: bytes, b: bytes) -> None:
    """The exact tier's JSON: every key equal, but sum and mean within a
    relative 1e-12 -- the port adds the decoded float64 values on the
    device, in another order than numpy's pairwise sum (the tolerance
    test_torch_store.py holds the same numbers to)."""
    a, b = json.loads(a), json.loads(b)
    assert list(a) == list(b)
    for k in a:
        if k in ("sum", "mean") and a["exact"]:
            for x, y in zip(a[k], b[k]):
                assert abs(x - y) <= 1e-12 * max(abs(x), 1.0), (k, x, y)
        else:
            assert a[k] == b[k], k


def _same_response(rs, ps, target, headers=None, method="GET"):
    a = rs.handle(method, target, dict(headers or {}))
    b = ps.handle(method, target, dict(headers or {}))
    assert (a.status, a.content_type) == (b.status, b.content_type), target
    if a.status == 200 and _exact_stats(target):
        _same_exact_stats(a.body, b.body)
    else:
        assert a.body == b.body, (target, a.body[:200], b.body[:200])
    assert _hdrs(a) == _hdrs(b), target
    a.delta = len(b.body) - len(a.body)      # bytes_sent of the port minus the reference's
    return a


def _same_metrics(rs, ps, delta: int = 0):
    """/v1/metrics of both: the same keys and counters (the port's bytes
    sent ``delta`` more), latencies apart."""
    snaps = []
    for svc in (rs, ps):
        resp = svc.handle("GET", "/v1/metrics", {})
        assert resp.status == 200
        snaps.append(json.loads(resp.body))
    a, b = snaps
    assert set(a) == set(b)
    assert set(a["latency"]) == set(b["latency"])
    for route in a["latency"]:
        assert a["latency"][route]["count"] == b["latency"][route]["count"], route
    assert b["bytes_sent"] - a["bytes_sent"] == delta
    assert set(a["by_tenant"]) == set(b["by_tenant"])
    for t in a["by_tenant"]:            # the exact stats were asked anonymously
        got = b["by_tenant"][t].pop("bytes") - a["by_tenant"][t].pop("bytes")
        assert got == (delta if t == "anonymous" else 0), t
    for k in ("requests", "errors", "by_route", "by_status", "by_tenant", "cache"):
        assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# files, then every route in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_store_files_byte_identical(tmp_path, dtype, layout):
    _x, rp, pp = _write_stores(tmp_path, dtype, layout)
    names = sorted(p.name for p in rp.parent.iterdir())
    assert names == sorted(p.name for p in pp.parent.iterdir())
    assert len(names) == (3 if layout == "sharded" else 1)
    for name in names:
        assert (rp.parent / name).read_bytes() == (pp.parent / name).read_bytes(), name
    assert compute_etag(str(pp)) == compute_etag(str(rp))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_every_route_matches_the_reference(tmp_path, dtype, layout):
    """Status, body bytes and the listed headers of every route, equal to
    the reference service's on the same store."""
    x, rp, pp = _write_stores(tmp_path, dtype, layout)
    rs, ps = _services(rp, pp)
    try:
        targets = ["/v1", "/v1/", "/v1/stores", "/v1/stores/s/info", "/v1/stores/s/stats",
                   "/v1/stores/s/stats?header_only=1", "/v1/stores/s/stats?header_only=0",
                   "/info", "/stats", "/stats?header_only=1", "/read",
                   "/v1/stores/s/raw", "/v1/stores/s/raw?shard=0", "/v1/stores/s/raw?shard=9",
                   "/v1/stores/s/chunk/0", "/v1/stores/s/chunk/4", "/v1/stores/s/chunk/5",
                   "/v1/stores/s/chunk/-1", "/v1/stores/s/chunk/x",
                   "/v1/stores/nope/info", "/v1/stores/s/bogus", "/nope", "/v1/nope"]
        if layout == "sharded":
            targets.append("/v1/stores/s/raw?shard=1")
        for roi in ROIS + BAD_ROIS:
            q = "" if roi is None else f"?roi={roi}"
            targets += [f"/v1/stores/s/read{q}", f"/read{q}"]
        delta = sum(_same_response(rs, ps, t).delta for t in targets)
        etag = dict(_same_response(rs, ps, "/v1/stores/s/info").headers)["ETag"]
        for rng in ("bytes=10-29", "bytes=-16", "bytes=100-", "bytes=0-99999999",
                    "bytes=99999999-", "bytes=-0", "bytes=5-2", "bytes=5-2,9-", "lines=0-9",
                    "bytes=7"):
            resp = _same_response(rs, ps, "/v1/stores/s/raw", {"range": rng})
            assert resp.status in (206, 400, 416), rng
        for inm in (etag, "*", f'"nope", {etag}', '"x"'):
            for t in ("/v1/stores/s/info", "/v1/stores/s/read?roi=:,:", "/v1/stores/s/raw",
                      "/v1/stores/s/chunk/0", "/info", "/read?roi=1"):
                resp = _same_response(rs, ps, t, {"if-none-match": inm})
                assert (resp.status == 304) == (inm != '"x"'), (t, inm)
        for method in ("PUT", "POST", "DELETE"):
            assert _same_response(rs, ps, "/v1/", method=method).status == 405
        _same_response(rs, ps, "/info", method="HEAD")
        _same_response(rs, ps, "/v1/", {"x-tenant": "t1"})
        _same_metrics(rs, ps, delta)
        # the port's /read body is the decoded ROI's bytes
        with ArrayStore.open(str(pp), device="cpu") as ca:
            resp = ps.handle("GET", "/v1/stores/s/read?roi=7:25,3:61", {})
            assert resp.body == _bits(ca[7:25, 3:61]).tobytes()
            assert np.abs(ca[...].double().numpy() - x.astype(np.float64)).max() \
                <= _bound(dtype)
    finally:
        rs.close()
        ps.close()


def test_summary_and_info_json(tmp_path):
    """The JSON keys and values a client reads: dtype names (bfloat16
    included), e, byte counts, attrs, sharded, etag."""
    _x, rp, pp = _write_stores(tmp_path, BF16, "sharded")
    rs, ps = _services(rp, pp)
    info = json.loads(_same_response(rs, ps, "/v1/stores/s/info").body)
    assert info["dtype"] == "bfloat16" and info["sharded"] and info["attrs"] == {"units": "K"}
    assert list(info) == ["shape", "chunk_shape", "dtype", "e", "nchunks", "raw_bytes",
                          "stored_bytes", "name", "etag", "attrs", "sharded"]
    summary = json.loads(_same_response(rs, ps, "/v1/").body)
    assert summary["stores"]["s"]["dtype"] == "bfloat16"
    resp = ps.handle("GET", "/v1/stores/s/read?roi=1:3", {})
    assert dict(resp.headers)["X-Dtype"] == "bfloat16"
    assert dict(resp.headers)["X-Shape"] == "2,64"


def test_gone_quota_and_error_envelopes(tmp_path):
    """410 after the file is unlinked (v1 and legacy), 429 under request
    and byte quotas, the 400/404 envelopes of both generations."""
    _x, rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    rs, ps = _services(rp, pp)
    for svc in (rs, ps):
        svc.registry.set_quota("t1", max_requests=3)
        svc.registry.set_quota("t3", max_bytes=64)
    for _ in range(3):
        assert _same_response(rs, ps, "/v1/", {"x-tenant": "t1"}).status == 200
    resp = _same_response(rs, ps, "/v1/", {"x-tenant": "t1"})
    assert resp.status == 429 and json.loads(resp.body)["error"]["code"] == 429
    assert _same_response(rs, ps, "/v1/", {"x-tenant": "t2"}).status == 200
    _same_response(rs, ps, "/v1/stores/s/read?roi=:,:", {"x-tenant": "t3"})
    assert _same_response(rs, ps, "/v1/", {"x-tenant": "t3"}).status == 429
    resp = _same_response(rs, ps, "/v1/stores/s/read?roi=bogus")
    assert resp.status == 400 and json.loads(resp.body)["error"]["code"] == 400
    resp = _same_response(rs, ps, "/read?roi=bogus")
    assert resp.status == 400 and "code" not in json.loads(resp.body)
    resp = _same_response(rs, ps, "/nope")
    assert json.loads(resp.body) == {"error": "unknown path /nope"}
    _same_metrics(rs, ps)
    os.remove(rp)
    os.remove(pp)
    for t in ("/v1/stores/s/info", "/info", "/v1/stores/s/read", "/v1/stores/s/raw",
              "/v1/stores/s/chunk/0", "/stats"):
        resp = rs.handle("GET", t, {})
        got = ps.handle("GET", t, {})
        assert resp.status == got.status == 410, t
        assert json.loads(got.body)["error"]["code"] == 410
    summary = json.loads(ps.handle("GET", "/v1/", {}).body)
    assert summary["stores"]["s"] == {"gone": True}
    rs.close()
    ps.close()


def test_replaced_file_is_served_at_once(tmp_path):
    """Replacing the file flips the ETag and the answers; the new file's
    chunks do not come from the cache of the old one."""
    _x, rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    rs, ps = _services(rp, pp)
    first = _same_response(rs, ps, "/v1/stores/s/read?roi=:,:")
    x2 = _walk((16, 64), seed=9)
    RStore.save(str(rp) + ".tmp", x2, 1e-3, chunk_shape=CHUNK)
    ArrayStore.save(str(pp) + ".tmp", x2, 1e-3, chunk_shape=CHUNK, device="cpu")
    os.replace(str(rp) + ".tmp", rp)
    os.replace(str(pp) + ".tmp", pp)
    resp = _same_response(rs, ps, "/v1/stores/s/info")
    assert json.loads(resp.body)["shape"] == [16, 64]
    assert dict(resp.headers)["ETag"] != dict(first.headers)["ETag"]
    second = _same_response(rs, ps, "/v1/stores/s/read?roi=:,:")
    with ArrayStore.open(str(pp), device="cpu") as ca:
        assert second.body == _bits(ca[:, :]).tobytes()
    rs.close()
    ps.close()


@pytest.mark.parametrize("remote_shard", [0, 1])
def test_url_shard_redirects(tmp_path, remote_shard):
    """A chunk owned by a URL shard answers 307 with its frame's byte range
    in X-Chunk-Offset/X-Chunk-Length; raw of that shard redirects; local
    shards still serve their bytes."""
    _x, rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "sharded", seed=7)
    for p in (rp, pp):
        man = json.loads(p.read_text())
        man["shards"][remote_shard]["file"] = "http://127.0.0.1:9/s.shard-remote.szs"
        p.write_text(json.dumps(man))
    rs, ps = _services(rp, pp)
    man = json.loads(pp.read_text())
    for sh in man["shards"]:
        lo, hi = sh["chunks"]
        for cid in range(lo, hi):
            resp = _same_response(rs, ps, f"/v1/stores/s/chunk/{cid}")
            if "://" in sh["file"]:
                off, length, _n = sh["frames"][cid - lo]
                h = dict(resp.headers)
                assert resp.status == 307 and h["Location"] == sh["file"]
                assert (int(h["X-Chunk-Offset"]), int(h["X-Chunk-Length"])) == (off, length)
            else:
                assert resp.status == 200
    for si in range(2):
        resp = _same_response(rs, ps, f"/v1/stores/s/raw?shard={si}")
        assert resp.status == (307 if si == remote_shard else 200)
    # ArrayStore.open needs local shards: the decode routes answer 400
    assert _same_response(rs, ps, "/v1/stores/s/info").status == 400
    rs.close()
    ps.close()


# ---------------------------------------------------------------------------
# over sockets
# ---------------------------------------------------------------------------

class _Served:
    """A running HttpServer (either package's) on 127.0.0.1 in a thread."""

    def __init__(self, server):
        self.srv = server
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()
        host, port = server.server_address
        self.base = f"http://{host}:{port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **kw):
        return None


_OPENER = urllib.request.build_opener(_NoRedirect)


def _get(base, path, headers=None, method="GET"):
    req = urllib.request.Request(base + path, headers=headers or {}, method=method)
    try:
        with _OPENER.open(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


@pytest.fixture
def both_served(tmp_path):
    """The reference's and the port's HttpServer over their own byte-identical
    bf16 and f32 stores (names "b" and "f")."""
    made = {}
    for name, dtype in (("b", BF16), ("f", np.dtype(np.float32))):
        (tmp_path / name).mkdir()
        made[name] = _write_stores(tmp_path / name, dtype, "single", seed=3)
    rs, ps = rmake_service(), make_service(device="cpu")
    for name, (_x, rp, pp) in made.items():
        rs.add_store(name, str(rp))
        ps.add_store(name, str(pp))
    ref, port = _Served(RHttpServer(rs)), _Served(HttpServer(ps))
    try:
        yield ref, port, made
    finally:
        ref.close()
        port.close()


def test_http_frontends_answer_alike(both_served):
    """The two HttpServers over sockets: same status, body and headers
    (Content-Length and Connection included), HEAD with an empty body."""
    ref, port, _made = both_served
    for path, headers, method in [
            ("/v1/stores/b/read?roi=3:9,1:40", {}, "GET"), ("/read?roi=5", {}, "GET"),
            ("/info", {}, "HEAD"), ("/v1/stores/f/raw", {"Range": "bytes=3-40"}, "GET"),
            ("/v1/stores/f/raw", {"Range": "bytes=999999-"}, "GET"),
            ("/v1/stores/f/stats?header_only=1", {}, "GET"), ("/nope", {}, "GET"),
            ("/v1/", {}, "PUT"), ("/v1/stores/f/info", {"Connection": "close"}, "GET")]:
        a = _get(ref.base, path, headers, method)
        b = _get(port.base, path, headers, method)
        assert a[0] == b[0] and a[2] == b[2], path
        keep = ("Content-Type", "Content-Length", "Connection") + COMPARED
        assert {k: v for k, v in a[1].items() if k in keep} == \
            {k: v for k, v in b[1].items() if k in keep}, path
    status, headers, body = _get(port.base, "/info", method="HEAD")
    assert status == 200 and body == b"" and int(headers["Content-Length"]) > 0


@pytest.mark.parametrize("name", ["b", "f"])
def test_each_client_reads_the_other_server(both_served, name):
    """The port's RemoteStore against the reference's server and the
    reference's RemoteStore against the port's: the same values."""
    ref, port, made = both_served
    _x, rp, _pp = made[name]
    direct = RStore.open(str(rp))
    mine = RemoteStore(f"{ref.base}/v1/stores/{name}", device="cpu")
    theirs = RRemote(f"{port.base}/v1/stores/{name}")
    assert mine.shape == theirs.shape == direct.shape
    assert mine.dtype == {"b": torch.bfloat16, "f": torch.float32}[name]
    assert mine.info() == theirs.info()
    for key in [np.s_[...], np.s_[3:9, 1:40], np.s_[5], np.s_[39, 63], np.s_[:, -1],
                np.s_[4:4], np.s_[..., 2]]:
        want = direct[key]
        got = mine[key]
        assert got.device.type == "cpu" and tuple(got.shape) == want.shape
        assert _bits(got).tobytes() == _bits(want).tobytes(), key
        assert _bits(theirs[key]).tobytes() == _bits(want).tobytes(), key
    assert mine.stats(header_only=True) == theirs.stats(header_only=True)
    legacy = RemoteStore(port.base, device="cpu")       # the default store: "b"
    assert legacy.shape == made["b"][0].shape
    with pytest.raises(ValueError, match="returned 400"):
        mine.read_bytes("bogus")


def test_roi_text_matches_the_reference():
    from repro.serve.client import roi_text as rroi_text

    for key in [Ellipsis, None, 3, np.int64(4), np.s_[1:5], np.s_[:, 2], np.s_[..., 1:],
                np.s_[-3:, :7], (slice(None),)]:
        assert roi_text(key) == rroi_text(key)
        if key is not None:
            assert parse_roi(roi_text(key) or None) is not None
    for bad, exc in ((np.s_[::2], ValueError), ((1.5,), TypeError)):
        with pytest.raises(exc):
            roi_text(bad)


LOADER_CASES = {      # name: (dtype, window, batch, workers)
    "f32-serial": (np.dtype(np.float32), (4, 16), 3, 0),
    "f32-2-workers": (np.dtype(np.float32), (5, 64), 4, 2),
    "bf16-4-workers": (BF16, (8, 33), 2, 4),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_http_loader_matches_reference_and_local(tmp_path, case):
    """StoreLoader over the port's server == the reference loader over the
    reference's server == the port's local loader, bit for bit, serial and
    pipelined (with the window-granular path on both sides)."""
    dtype, window, batch, workers = LOADER_CASES[case]
    _x, rp, pp = _write_stores(tmp_path, dtype, "single", seed=5)
    rs, ps = rmake_service(), make_service(device="cpu")
    rs.add_store("c", str(rp))
    ps.add_store("c", str(pp))
    ref, port = _Served(RHttpServer(rs)), _Served(HttpServer(ps))
    try:
        kw = dict(seed=5, workers=workers)
        mine = StoreLoader(f"{port.base}/v1/stores/c", window, batch, device="cpu", **kw)
        theirs = RLoader(f"{ref.base}/v1/stores/c", window, batch, **kw)
        local = StoreLoader(str(pp), window, batch, device="cpu", **kw)
        assert mine.source.granularity == "window" and mine.device.type == "cpu"
        assert mine.dtype == local.dtype and mine.batch_shape == local.batch_shape
        steps = 4
        serial = [mine.batch_at(s).clone() for s in range(steps)]
        piped = [b.clone() for b in mine.batches(steps=steps)]
        for s in range(steps):
            want = theirs.batch_at(s)
            for got in (serial[s], piped[s], local.batch_at(s)):
                assert tuple(got.shape) == want.shape
                assert _bits(got).tobytes() == _bits(want).tobytes(), s
        for ld in (mine, theirs, local):
            ld.close()
    finally:
        ref.close()
        port.close()


def test_http_loader_worker_errors_reach_the_consumer(tmp_path):
    """A request that fails on a worker re-raises from __next__, which then
    stops; the server stays up."""
    _x, _rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    port = _Served(make_server(str(pp), device="cpu"))
    try:
        ld = StoreLoader(port.base, (4, 16), 2, device="cpu", workers=2)
        os.remove(pp)
        it = ld.batches(steps=3)
        with pytest.raises(ValueError, match="returned 410"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)
        assert _get(port.base, "/v1/stores")[0] == 200
    finally:
        port.close()


def test_store_lm_over_http(tmp_path):
    """StoreLM from a service URL gives the local store's tokens."""
    from repro_torch.data import DataConfig, StoreLM

    x = _walk((64, 256), seed=4)
    p = tmp_path / "corpus.szs"
    ArrayStore.save(str(p), x, 1e-3, chunk_shape=(16, 256), device="cpu")
    port = _Served(make_server(str(p), device="cpu"))
    try:
        cfg = DataConfig(256, 16, 2)
        remote, local = StoreLM(port.base, cfg, device="cpu"), StoreLM(str(p), cfg, device="cpu")
        for s in range(3):
            a, b = remote.batch_at(s), local.batch_at(s)
            assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
        got = [b["tokens"].clone() for _, b in zip(range(3), remote.batches())]
        assert all(torch.equal(g, local.batch_at(s)["tokens"]) for s, g in enumerate(got))
        remote.close()
        local.close()
    finally:
        port.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_answers_and_terminates(tmp_path):
    _x, _rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.store", "serve", str(pp), "--port", str(port),
         "--device", "cpu"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                status, _h, body = _get(base, "/info")
                break
            except urllib.error.URLError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "serve never answered"
                time.sleep(0.2)
        assert status == 200 and json.loads(body)["shape"] == list(SHAPE)
    finally:
        proc.terminate()
        out, _err = proc.communicate(timeout=30)
    assert f"on http://127.0.0.1:{port}" in out.decode()


# ---------------------------------------------------------------------------
# the reference's own service tests, mirrored
# ---------------------------------------------------------------------------

RANGES = [("bytes=0-9", 100), ("bytes=90-", 100), ("bytes=-10", 100), ("bytes=0-1000", 100),
          ("bytes=100-", 100), ("bytes=-0", 100), ("bytes=5-2", 100), ("bytes=-200", 100),
          ("lines=0-9", 100), ("bytes=1-2,4-5", 100), ("bytes=7", 100), ("bytes=a-3", 100)]


@pytest.mark.parametrize("text,size", RANGES)
def test_parse_range_matches_reference(text, size):
    try:
        want = r_parse_range(text, size)
    except ValueError:
        with pytest.raises(ValueError):
            _parse_range(text, size)
        return
    assert _parse_range(text, size) == want


@pytest.mark.parametrize("cls", [LRUBytesCache, RCache], ids=["port", "reference"])
def test_lru_cache_unit(cls):
    c = cls(max_bytes=100)
    c.put("a", b"x", 60)
    c.put("b", b"y", 60)             # evicts a
    assert c.get("a") is None and c.get("b") == b"y"
    assert c.evictions == 1
    c.put("huge", b"z", 1000)        # over budget: rejected, no thrash
    assert len(c) == 1 and c.get("b") == b"y"
    s = c.stats()
    assert s["hits"] == 2 and s["misses"] == 1
    with pytest.raises(ValueError):
        cls(max_bytes=-1)


def test_lru_cache_holds_tensors_by_their_bytes():
    c = LRUBytesCache(max_bytes=1024)
    t = torch.arange(128, dtype=torch.float32)         # 512 B
    for i in range(3):
        c.put(i, t, t.numel() * t.element_size())
    assert len(c) == 2 and c.nbytes == 1024 and c.evictions == 1 and c.get(2) is t


@pytest.mark.parametrize("budget", [2048, 256 << 20])
def test_cache_budget_evicts_but_stays_correct(tmp_path, budget):
    """A budget below one chunk must thrash (evictions) without corrupting a
    response; the default budget serves repeats from the cache."""
    _x, rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    rs, ps = _services(rp, pp, cache_bytes=budget)
    with ArrayStore.open(str(pp), device="cpu") as ca:
        want = _bits(ca[:, :]).tobytes()
    for _ in range(6):
        assert _same_response(rs, ps, "/v1/stores/s/read?roi=:,:").body == want
    stats, rstats = ps.cache.stats(), rs.cache.stats()
    assert stats == rstats and stats["bytes"] <= budget
    assert (stats["evictions"] > 0) == (budget == 2048)
    assert (stats["hits"] > 0) == (budget != 2048)
    rs.close()
    ps.close()


@pytest.mark.parametrize("fused", [False, True])
def test_concurrent_readers_byte_identical_and_cached(tmp_path, fused):
    """N threads x mixed ROIs over a socket: every response byte-identical to
    a direct read, and the shared decoded-chunk cache registers hits."""
    _x, _rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    srv = _Served(make_server(str(pp), device="cpu", fused_range=fused))
    rois = ["0:8,0:64", "4:20,8:40", "5:13,0:32", "32:40,0:16", ":,:"]
    with ArrayStore.open(str(pp), device="cpu") as ca:
        direct = {roi: _bits(ca[parse_roi(roi)]).tobytes() for roi in rois}

    def fetch(i):
        roi = rois[i % len(rois)]
        status, _h, body = _get(srv.base, f"/v1/stores/default/read?roi={roi}")
        assert status == 200
        return roi, body

    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            for roi, body in pool.map(fetch, range(40)):
                assert body == direct[roi]
        stats = srv.srv.service.cache.stats()
        assert stats["hits"] > 0 and stats["misses"] > 0, stats
    finally:
        srv.close()


def test_metrics_prometheus_text_carries_serve_series(tmp_path):
    """With telemetry on, Accept: text/plain on /v1/metrics serves the
    registry's exposition with the serve.* series, and the JSON snapshot
    gains the "obs" key; off again, neither."""
    _x, rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    _rs, ps = _services(rp, pp)
    obs.reset()
    obs.enable()
    try:
        ps.handle("GET", "/v1/stores/s/read?roi=0:2", {})
        ps.handle("GET", "/nope", {})
        text = ps.handle("GET", "/v1/metrics", {"accept": "text/plain"})
        snap = json.loads(ps.handle("GET", "/v1/metrics", {}).body)
    finally:
        obs.disable()
        obs.reset()
    body = text.body.decode()
    assert text.content_type.startswith("text/plain")
    for series in ("szx_serve_requests", "szx_serve_responses", "szx_serve_bytes_sent",
                   "szx_serve_errors", "szx_serve_request_seconds", "szx_serve_cache"):
        assert series in body, series
    assert "obs" in snap
    assert "obs" not in json.loads(ps.handle("GET", "/v1/metrics", {}).body)


def test_asgi_adapter_answers_like_handle(tmp_path):
    _x, _rp, pp = _write_stores(tmp_path, np.dtype(np.float32), "single")
    svc = make_service(str(pp), device="cpu")
    app = asgi_app(svc)

    async def call(method, path, query=b""):
        sent = []

        async def receive():
            return {"type": "http.request", "body": b"", "more_body": False}

        async def send(msg):
            sent.append(msg)

        await app({"type": "http", "method": method, "path": path, "query_string": query,
                   "headers": [(b"x-tenant", b"a")]}, receive, send)
        return sent

    sent = asyncio.run(call("GET", "/v1/stores/default/read", b"roi=1:3,0:5"))
    want = svc.handle("GET", "/v1/stores/default/read?roi=1:3,0:5", {})
    assert sent[0]["status"] == 200 and sent[1]["body"] == want.body
    sent = asyncio.run(call("HEAD", "/info"))
    assert sent[0]["status"] == 200 and sent[1]["body"] == b""
    svc.close()


def test_train_launcher_from_a_service_url(tmp_path):
    """``launch.train --data-store http://...`` trains on the served corpus:
    the same losses as from the local store file."""
    from repro_torch.launch import train

    x = _walk((64, 256), seed=12)
    store = str(tmp_path / "corpus.szs")
    ArrayStore.save(store, x, 1e-3, chunk_shape=(16, 256), device="cpu")
    port = _Served(make_server(store, device="cpu"))
    try:
        runs = [train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "2", "--seq", "16",
                            "--batch", "2", "--ckpt", str(tmp_path / f"ck{i}"), "--device",
                            "cpu", "--data-store", src, "--data-workers", "2"])
                for i, src in enumerate((f"{port.base}/v1/stores/default", store))]
    finally:
        port.close()
    losses = [[h["loss"] for h in tr.history] for tr in runs]
    assert len(losses[0]) == 2 and all(np.isfinite(v) for v in losses[0])
    assert losses[0] == losses[1]
