"""repro_torch.obs and its hooks against the JAX package's repro.obs.

The same calls in both packages, in one process, must give the same
telemetry: the registry and its exporters (Prometheus text, Chrome-trace
event names, phases and nesting; timestamps and durations excluded), the
per-frame stream stats of byte-identical streams, and the counter values of
the same save / ROI read / query / staged save / tree checkpoint /
``compressed_psum_mean`` / loader epoch -- apart from the counters that
differ by design, which ``BY_DESIGN`` names with the reason.  Telemetry
must not change a single output byte, and with it off no hook may touch
the registry.  The port runs on the CPU (``device="cpu"``: the plain
versions); the reference with ``backend="numpy"`` where it takes one.
"""
from __future__ import annotations

import io
import json
import re
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import obs as robs
from repro.checkpoint import CheckpointManager as RManager
from repro.core import grad_compress as rgc
from repro.core.codec import container as rcontainer
from repro.core.codec.__main__ import main as rcli
from repro.core.codec.plan import Bound as RBound
from repro.core.codec.szx_codec import SZxCodec as RCodec
from repro.data import StoreLoader as RLoader
from repro.data.store_loader import plan_batch
from repro.obs import stream_stats as rstats
from repro.store import ArrayStore as RStore
from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import grad_compress as gc
from repro_torch.core.codec import Bound, SZxCodec
from repro_torch.core.codec.__main__ import main as tcli
from repro_torch.data import StoreLoader
from repro_torch.obs import stream_stats
from repro_torch.obs.registry import Registry
from repro_torch.store import ArrayStore

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
STAGES = [None, "bitshuffle-rle", "deflate", "bitshuffle-zstd"]

# counters whose values differ between the packages by design, and why
BY_DESIGN = {
    # the port counts its own host<->card copies; the reference's numpy
    # route makes none, and where it does copy, its decode reads the values
    # back where the port's leave them on the device
    "device.put.calls", "device.put.bytes", "device.get.calls", "device.get.bytes",
}


@pytest.fixture
def both_on():
    """Telemetry on in both packages, on clean registries; off afterwards."""
    for o in (obs, robs):
        o.reset()
        o.enable()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


def _walk(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (np.cumsum(rng.standard_normal(n)) * 0.01).astype(np.float64)
    x[: n // 4] = x.flat[0]                       # some constant blocks
    return x.astype(dtype)


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes too) as a torch tensor."""
    torch_dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                   np.dtype(np.float16): torch.float16, BF16: torch.bfloat16}[x.dtype]
    return torch.from_numpy(x.view(f"i{x.itemsize}")).view(torch_dtype)


def _telegraph(n, seed=0):
    """Two-level values around 1 (bitshuffle + RLE shrinks their mid bytes)."""
    rng = np.random.default_rng(seed)
    return (1.0 + 1.2e-3 * np.sign(rng.standard_normal(n))).astype(np.float32)


# ---------------------------------------------------------------------------
# registry and exporters
# ---------------------------------------------------------------------------
def _drive(o) -> None:
    """One fixed sequence of metric and span calls through a package's obs."""
    o.counter("codec.compress.calls").inc()
    o.counter("codec.compress.calls").inc(4)
    o.counter("http.requests", route="/a", code=200).inc(2)
    o.counter("http.requests", route='/b"q\\', code=404).inc()
    o.gauge("ingest.lookahead").set(3)
    o.gauge("occupancy").add(2.5)
    o.gauge("occupancy").add(-1)
    h = o.histogram("codec.compress.seconds")
    for v in (5e-5, 1e-4, 3e-3, 0.7, 12.0):
        h.observe(v)
    hb = o.histogram("sizes", buckets=(1, 10, 100), kind="x")
    for v in (0, 1, 5, 50, 500):
        hb.observe(v)
    with o.span("outer", step=1):
        with o.span("mid", leaf="w"):
            with o.span("inner"):
                pass
        with o.span("mid", leaf="b"):
            pass

    @o.traced("decorated", k=1)
    def f():
        with o.span("under"):
            return 7

    assert f() == 7


_SECONDS = re.compile(r"^(szx_span_seconds_total\{[^}]*\}) .*$")


def _prom_without_durations(text: str) -> list[str]:
    return [_SECONDS.sub(r"\1 <t>", line) for line in text.splitlines()]


def _events(doc: dict) -> list[tuple]:
    return [(e["name"], e["ph"], e["cat"], json.dumps(e["args"], sort_keys=True))
            for e in doc["traceEvents"]]


def test_registry_and_exporters_match_the_reference(both_on):
    _drive(obs)
    _drive(robs)
    assert _prom_without_durations(obs.prometheus_text()) == \
        _prom_without_durations(robs.prometheus_text())
    got, want = obs.chrome_trace(), robs.chrome_trace()
    assert _events(got) == _events(want)
    assert [e["args"]["depth"] for e in got["traceEvents"]] == [1, 2, 3, 2, 1, 2]
    snap, rsnap = obs.REGISTRY.snapshot(), robs.REGISTRY.snapshot()
    assert snap["metrics"] == rsnap["metrics"]
    assert {k: v["count"] for k, v in snap["spans"].items()} == \
        {k: v["count"] for k, v in rsnap["spans"].items()}
    # every exposition line parses as Prometheus text 0.0.4
    line_re = re.compile(r'^(# TYPE [a-z_:][a-z0-9_:]* (counter|gauge|histogram)|'
                         r'[a-z_:][a-z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+|.*Inf.*)$', re.I)
    assert all(line_re.match(ln) for ln in obs.prometheus_text().splitlines())
    assert obs.summary().splitlines()[0] == robs.summary().splitlines()[0] == "spans"


def test_registry_concurrent_counters_and_spans_exact(both_on):
    """Threads hammering one counter, one histogram and the span log lose
    no update (a short switch interval forces interleaving)."""
    import sys

    reg = Registry(max_spans=100)
    n_threads, per = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                reg.counter("c", t="x").inc()
                reg.histogram("h").observe(1e-3)
                reg.record_span("s", i, 1, threading.get_ident(), 1, None)

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert reg.counter("c", t="x").value == n_threads * per
    assert reg.histogram("h").value[2] == n_threads * per
    assert reg.span_aggregates()["s"] == (n_threads * per, n_threads * per)
    assert len(reg.spans()) == 100                  # the log is bounded
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c", t="x")


# ---------------------------------------------------------------------------
# stream stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s or "off")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.name)
def test_stream_stats_match_the_reference(dtype, stage, both_on):
    if stage == "bitshuffle-zstd":
        pytest.importorskip("zstandard")
    x = _walk(9000, seed=3, dtype=dtype)
    x[6000:] = _telegraph(3000).astype(dtype)
    bio = io.BytesIO()
    SZxCodec(device="cpu", stage=stage).dump_chunked(
        _tensor(x), bio, Bound.abs(1e-3), chunk_bytes=4096 * dtype.itemsize, index=False)
    data = bio.getvalue()
    frames, off = [], 0
    while off < len(data):
        _m, _v, flags, _seq, ln = rcontainer.FRAME_HEADER.unpack_from(data, off)
        frames.append(data[off:off + rcontainer.FRAME_HEADER.size + ln])
        off += rcontainer.FRAME_HEADER.size + ln
    assert len(frames) == 3
    for frame in frames:
        assert stream_stats.frame_stats(frame) == rstats.frame_stats(frame)
        payload = frame[rcontainer.FRAME_HEADER.size:]
        assert stream_stats.payload_stats(payload) == rstats.payload_stats(payload)
        assert stream_stats.payload_stats(payload, l_hist=False) == \
            rstats.payload_stats(payload, l_hist=False)
    # the port's frame log, fed by container.build_frame, agrees with the
    # reference's log of the same frames built by the reference
    rbio = io.BytesIO()
    RCodec(backend="numpy", stage=stage).dump_chunked(
        x, rbio, RBound.abs(1e-3), chunk_bytes=4096 * dtype.itemsize, index=False)
    assert rbio.getvalue() == data
    assert obs.REGISTRY.frames() == robs.REGISTRY.frames()
    if stage is not None and dtype == np.float32:
        assert any(rec["stage"] for rec in obs.REGISTRY.frames())


def test_codec_cli_info_stats_matches_the_reference(tmp_path, capsys):
    x = _walk(20000, seed=4)
    x[12000:] = _telegraph(8000)
    raw = tmp_path / "x.bin"
    x.tofile(raw)
    for cli, name, extra in ((tcli, "t.szx", ["--device", "cpu"]),
                             (rcli, "r.szx", ["--backend", "numpy"])):
        assert cli(["compress", str(raw), str(tmp_path / name), "--bound", "1e-3",
                    "--chunk-bytes", "32768", "--stage", "bitshuffle-rle", *extra]) == 0
    assert (tmp_path / "t.szx").read_bytes() == (tmp_path / "r.szx").read_bytes()
    capsys.readouterr()
    assert tcli(["info", str(tmp_path / "t.szx"), "--json", "--stats", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)["frames_stats"]
    assert rcli(["info", str(tmp_path / "r.szx"), "--json", "--stats"]) == 0
    want = json.loads(capsys.readouterr().out)["frames_stats"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.pop("decode_ms") >= 0 and w.pop("decode_ms") >= 0
        assert g == w
    assert tcli(["info", str(tmp_path / "t.szx"), "--stats", "--device", "cpu"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[-4].split()[:2] == ["seq", "elements"] and len(table[-3:]) == 3


# ---------------------------------------------------------------------------
# telemetry only observes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", [None, "bitshuffle-rle", "deflate"], ids=lambda s: s or "off")
def test_telemetry_does_not_change_output(stage, tmp_path):
    x = _walk(64 * 128, seed=5)
    x[4096:] = _telegraph(4096)
    outs = []
    try:
        for on in (False, True):
            (obs.enable if on else obs.disable)()
            obs.reset()
            bio = io.BytesIO()
            SZxCodec(device="cpu", stage=stage).dump_chunked(x, bio, Bound.abs(1e-3),
                                                             chunk_bytes=8192)
            store = io.BytesIO()
            ArrayStore.save(store, x.reshape(64, 128), Bound.abs(1e-3), chunk_shape=(16, 128),
                            stage=stage, device="cpu")
            man = tmp_path / f"m{int(on)}.json"
            ArrayStore.save_sharded(str(man), x.reshape(64, 128), Bound.abs(1e-3), nshards=2,
                                    chunk_shape=(16, 128), stage=stage, device="cpu")
            shards = [(tmp_path / f"m{int(on)}.shard-{i:03d}.szs").read_bytes()
                      for i in range(2)]
            with ArrayStore.open(io.BytesIO(store.getvalue()), device="cpu") as ca:
                roi = ca[3:40, 5:100].numpy().tobytes()
            outs.append((bio.getvalue(), store.getvalue(), shards, roi))
            if on:
                assert obs.REGISTRY.metrics()           # it did record
    finally:
        obs.disable()
        obs.reset()
    assert outs[0] == outs[1]


def test_disabled_telemetry_touches_no_registry(monkeypatch, tmp_path):
    """With telemetry off no hook of the codec, store, loader, checkpoint or
    trainer path reaches the registry, and span() allocates nothing."""
    obs.disable()
    calls = []
    for name in ("_get", "record_span", "record_frame"):
        orig = getattr(Registry, name)

        def spy(self, *a, _orig=orig, _n=name, **kw):
            calls.append(_n)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(Registry, name, spy)
    x = _walk(4096)
    codec = SZxCodec(device="cpu", stage="deflate", workers=2)
    buf = codec.compress(x, Bound.abs(1e-3))
    codec.decompress(buf)
    codec.decompress_range(buf, 0, 4)
    bio = io.BytesIO()
    codec.dump_chunked(x, bio, Bound.abs(1e-3), chunk_bytes=4096)
    bio.seek(0)
    codec.load_chunked(bio)
    szs = tmp_path / "a.szs"
    ArrayStore.save(str(szs), x.reshape(64, 64), Bound.abs(1e-3), chunk_shape=(16, 64),
                    stage="bitshuffle-rle", device="cpu")
    with ArrayStore.open(str(szs), device="cpu") as ca:
        ca[0:20, 0:32]
        with StoreLoader(ca, (4, 16), 4, workers=2) as ld:
            ld.batch_at(0)
            with ld.batches(steps=2) as it:
                list(it)
    ck = CheckpointManager(str(tmp_path / "ck"), compress=True, device="cpu")
    ck.save(0, {"w": torch.from_numpy(x)})
    ck.restore({"w": None})
    assert calls == []
    assert obs.span("a") is obs.span("b")


# ---------------------------------------------------------------------------
# counter parity
# ---------------------------------------------------------------------------
class _Cache(dict):
    def put(self, key, value, nbytes):
        self[key] = value


def _counters(o) -> dict:
    """Every counter and histogram count by (name, labels)."""
    out = {}
    for m in o.REGISTRY.metrics():
        key = (m.name, tuple(sorted((k, str(v)) for k, v in m.labels.items())))
        if m.kind == "counter":
            out[key] = m.value
        elif m.kind == "histogram":
            out[key + ("count",)] = m.value[2]
    return out


def _spans(o) -> dict:
    return {k: v[0] for k, v in o.REGISTRY.span_aggregates().items()}


def _run_store_ops(port: bool, tmp_path, x):
    """Save stage-off and staged, ROI reads with a cache, queries, a loader
    epoch (serial) -- the same calls in either package."""
    save, open_, bound = (ArrayStore.save, ArrayStore.open, Bound.abs(1e-3)) if port \
        else (RStore.save, RStore.open, RBound.abs(1e-3))
    kw = {"device": "cpu"} if port else {}
    okw = {"device": "cpu"} if port else {"backend": "numpy"}
    tag = "t" if port else "r"
    for stage in (None, "bitshuffle-rle", "deflate"):
        path = tmp_path / f"{tag}-{stage}.szs"
        save(str(path), x, bound, chunk_shape=(16, 128), stage=stage, **kw)
        cache = _Cache()
        with open_(str(path), cache=cache, **okw) as ca:
            ca[3:40, 5:100]
            ca[3:40, 5:100]                         # cache hits
            ca[50, :]
            ca.stats()
            ca.stats(header_only=True)
    path = tmp_path / f"{tag}-None.szs"
    loader = StoreLoader if port else RLoader
    with loader(str(path), (4, 32), 4, seed=3, workers=2, **okw) as ld:
        for s in range(3):
            ld.batch_at(s)


def test_store_and_loader_counters_match_the_reference(tmp_path, both_on):
    x = _walk(64 * 128, seed=6).reshape(64, 128)
    x[40:] = _telegraph(24 * 128).reshape(24, 128)
    _run_store_ops(True, tmp_path, x)
    _run_store_ops(False, tmp_path, x)
    got, want = _counters(obs), _counters(robs)
    names = {k[0] for k in want}
    for family in ("codec.stage.try", "codec.stage.win", "codec.stage.roi_bytes_read",
                   "store.roi.reads", "store.roi.chunks", "store.roi.mid_bytes_read",
                   "store.roi.prefix_bytes_read", "store.cache.hits", "store.cache.misses",
                   "store.chunk.decodes", "codec.compress.calls", "codec.frames.built",
                   "ingest.batches"):
        assert family in names, family
    assert {k: v for k, v in got.items() if k[0] not in BY_DESIGN} == want
    # the port's loader adds a store.read span to each chunk-range read (the
    # reference spans only ROI reads): one a planned task of the 3 batches
    with RStore.open(str(tmp_path / "r-None.szs"), backend="numpy") as ca:
        ld = RLoader(ca, (4, 32), 4, seed=3)
        ranges = sum(len(plan_batch(ca._grid, ca._block_size, ld.sampler.origins_at(s),
                                    (4, 32))[0]) for s in range(3))
    spans, rspans = _spans(obs), _spans(robs)
    assert spans.pop("store.read") == rspans.pop("store.read") + ranges
    assert spans == rspans


def test_checkpoint_and_tree_counters_match_the_reference(tmp_path, both_on):
    w = _walk(50_000, seed=7).reshape(500, 100)
    tree = {"w": w, "b": w[0, :16].copy(), "step": np.int64(3)}
    for port in (True, False):
        if port:
            ck = CheckpointManager(str(tmp_path / "t"), compress=True, device="cpu",
                                   chunk_bytes=1 << 16, stage="deflate")
            ck.save(1, {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})
        else:
            ck = RManager(str(tmp_path / "r"), compress=True, chunk_bytes=1 << 16,
                          stage="deflate")
            ck.save(1, tree)
        ck.restore(tree)
    assert (tmp_path / "t/step_000000001/tree.szt").read_bytes() == \
        (tmp_path / "r/step_000000001/tree.szt").read_bytes()
    got, want = _counters(obs), _counters(robs)
    assert {k[0] for k in want} >= {"checkpoint.saves", "checkpoint.saved_raw_bytes",
                                    "checkpoint.saved_bytes", "checkpoint.restores",
                                    "codec.decompress.calls"}
    assert {k: v for k, v in got.items() if k[0] not in BY_DESIGN} == want
    assert _spans(obs) == _spans(robs)
    assert {"checkpoint.save", "checkpoint.restore", "tree.leaf_encode",
            "tree.leaf_decode", "codec.compress", "codec.decompress"} <= set(_spans(obs))


def test_collective_counters_match_the_reference(tmp_path, both_on):
    """compressed_psum_mean, ppermute and all_to_all on one gloo rank
    against the reference's under ``jax.vmap`` over a one-member axis: the
    same ``collective.*`` values (the reference counts once per traced call,
    the port once per call; one call each here)."""
    rng = np.random.default_rng(8)
    grads = {"a": rng.standard_normal((4, 256)).astype(np.float32),
             "b": rng.standard_normal(192).astype(np.float32)}
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        gc.compressed_psum_mean({k: torch.from_numpy(v) for k, v in grads.items()},
                                num_planes=2)
        gc.compressed_ppermute(torch.from_numpy(x), None, [(0, 0)])
        gc.compressed_all_to_all(torch.from_numpy(x), None, 0, 1)
    finally:
        dist.destroy_process_group()
    lead = {k: jnp.asarray(v)[None] for k, v in grads.items()}
    jax.vmap(lambda g: rgc.compressed_psum_mean(g, "i", num_planes=2), axis_name="i")(lead)
    jax.vmap(lambda a: rgc.compressed_ppermute(a, "i", [(0, 0)]), axis_name="i")(
        jnp.asarray(x)[None])
    jax.vmap(lambda a: rgc.compressed_all_to_all(a, "i", 0, 1), axis_name="i")(
        jnp.asarray(x)[None])
    got, want = _counters(obs), _counters(robs)
    assert {k[0] for k in want} == {"collective.calls", "collective.raw_bytes",
                                    "collective.wire_bytes"}
    assert got == want


def test_pipeline_counters_follow_the_reference(tmp_path, both_on):
    """pipeline_apply's per-call accounting: the reference's names and its
    byte formula (``repro/pipeline_par/gpipe.py:53-70``) for one stage of
    8 microbatches, raw and compressed."""
    from repro_torch.pipeline_par import pipeline_apply

    xs = torch.from_numpy(np.random.default_rng(9).standard_normal((8, 2, 128)).astype(np.float32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        for compress in (False, True):
            out = pipeline_apply(lambda w, x: torch.tanh(x * w), compress_activations=compress,
                                 num_planes=2)(torch.tensor(0.5), xs)
            assert out.shape == xs.shape
            raw = 2 * 128 * 4
            wire = int(2 * 128 * rgc.wire_bytes_per_value(2, 64)) if compress else raw
            assert obs.gauge("pipeline.ticks").value == 8
            assert obs.gauge("pipeline.tick_raw_bytes").value == raw
            assert obs.gauge("pipeline.tick_wire_bytes").value == wire
    finally:
        dist.destroy_process_group()
    assert obs.counter("pipeline.programs").value == 2
    assert obs.counter("collective.calls", op="ppermute").value == 8
