"""repro_torch.data.store_loader and scidata against the JAX package's.

Runs the port on the CPU (``device="cpu"``: the plain versions) and holds it
to ``repro.data.store_loader`` (``backend="numpy"``) in one process, with the
same inputs made from a numpy seed; the tolerance is exact throughout:
window plans (``WindowSampler`` with and without ``epochs=``, 1-4 ranks,
``window_for_values``, ``plan_batch``), batches of a port-saved store read
by both loaders (host parse and fused range decode, with and without a
cache, over a shard manifest, windows cut by chunk edges), pipelined ==
serial, ``StoreLM`` tokens and labels, and the reference's behaviours:
a worker's exception on ``__next__``, ``reuse_slots``/``copy=``,
``SteppedBatches`` reopening on a seek, the bytes-read gate through a
counting file (the same byte ranges as the reference's reads),
``CheckpointManager.save_store`` with the loader, and the train launcher
on a store with ``--profile-dir``.
"""
from __future__ import annotations

import io
import json
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import scidata as rscidata
from repro.data import DataConfig as RDataConfig
from repro.data import StoreLM as RStoreLM
from repro.data import StoreLoader as RLoader
from repro.data import WindowSampler as RSampler
from repro.data import window_for_values as rwindow_for_values
from repro.data.store_loader import plan_batch as rplan_batch
from repro.store import ArrayStore as RStore
from repro.store import grid as rgrid
from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.codec import Bound
from repro_torch.data import (
    DataConfig,
    SteppedBatches,
    StoreLM,
    StoreLoader,
    WindowSampler,
    scidata,
    window_for_values,
)
from repro_torch.data.store_loader import make_source, plan_batch
from repro_torch.store import ArrayStore, ChunkGrid
from repro_torch.store.array import box_of_segment

BF16 = np.dtype(ml_dtypes.bfloat16)


def _walk(n, seed=0, scale=0.01, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _tensor(x: np.ndarray) -> torch.Tensor:
    torch_dtype = {np.dtype(np.float32): torch.float32, BF16: torch.bfloat16}[x.dtype]
    return torch.from_numpy(x.view(f"i{x.itemsize}")).view(torch_dtype)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


def _same(got: torch.Tensor, want) -> None:
    assert got.device.type == "cpu" and tuple(got.shape) == np.shape(want)
    np.testing.assert_array_equal(_bits(got), _bits(want))


class SpyFile:
    """Byte-range-recording wrapper over a seekable binary file."""

    def __init__(self, raw):
        self.raw = raw
        self.reads: list[tuple[int, int]] = []

    def seek(self, *a):
        return self.raw.seek(*a)

    def tell(self):
        return self.raw.tell()

    def read(self, n=-1):
        off = self.raw.tell()
        data = self.raw.read(n)
        if data:
            self.reads.append((off, len(data)))
        return data

    def bytes_read(self) -> int:
        return sum(ln for _, ln in self.reads)


class _Cache(dict):
    def put(self, key, value, nbytes):
        self[key] = value


# ---------------------------------------------------------------- plans
PLANS = {      # name: (shape, window, global batch, ranks, epochs, chunk shape)
    "one-rank": ((512, 128), (8, 128), 8, 1, None, (32, 128)),
    "two-ranks": ((512, 128), (8, 40), 8, 2, None, (32, 64)),
    "four-ranks-3d": ((40, 64, 30), (5, 16, 7), 8, 4, None, (8, 16, 16)),
    "three-ranks-1d": ((1000,), (37,), 6, 3, None, (128,)),
    "epochs": ((64, 64), (8, 8), 8, 2, 3, (16, 64)),
    "epochs-uneven": ((9, 8), (3, 4), 3, 1, 3, (4, 8)),
    "epochs-four-ranks": ((64, 64), (8, 8), 16, 4, 1, (16, 16)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_window_plans_match_the_reference(name):
    shape, window, gb, ranks, epochs, chunk = PLANS[name]
    grid, rg = ChunkGrid(shape, chunk), rgrid.ChunkGrid(shape, chunk)
    for rank in range(ranks):
        kw = dict(seed=21, rank=rank, num_ranks=ranks, epochs=epochs)
        s, r = WindowSampler(shape, window, gb, **kw), RSampler(shape, window, gb, **kw)
        steps = range(s.num_steps) if epochs else (0, 1, 5, 17, 3, 0)
        if epochs:
            assert s.num_steps == r.num_steps
        for step in steps:
            org = s.origins_at(step)
            np.testing.assert_array_equal(org, r.origins_at(step))
            assert org.dtype == np.int64
            for bs in (1, 128):
                assert plan_batch(grid, bs, org, window) == rplan_batch(rg, bs, org, window)
        if epochs:
            for p in (s, r):
                with pytest.raises(ValueError, match="out of range"):
                    p.origins_at(s.num_steps)


def test_sampler_validation_matches_the_reference():
    bad = [((10, 10), (11, 1), 4, {}), ((10,), (2,), 5, {"num_ranks": 2}),
           ((10,), (2,), 4, {"rank": 2, "num_ranks": 2}), ((64, 64), (8, 8), 8, {"epochs": 0}),
           ((64, 64), (8, 8), 8, {"epochs": True}), ((64, 64), (32, 32), 8, {"epochs": 1}),
           ((10, 10), (2,), 4, {})]
    for shape, window, gb, kw in bad:
        for cls in (WindowSampler, RSampler):
            with pytest.raises(ValueError) as err:
                cls(shape, window, gb, **kw)
            msg = str(err.value)
        with pytest.raises(ValueError, match=re.escape(msg)):
            WindowSampler(shape, window, gb, **kw)
    with pytest.raises(ValueError, match="only defined"):
        _ = WindowSampler((64, 64), (8, 8), 8).num_steps


@pytest.mark.parametrize("shape", [(256, 512), (100,), (4, 8, 16), (3, 5, 7, 11), (512, 512, 512)])
def test_window_for_values_matches_the_reference(shape):
    for n in (1, 65, 100, 2049, 4097, 10 ** 9):
        assert window_for_values(shape, n) == rwindow_for_values(shape, n)


def test_box_of_segment_matches_the_index_gather():
    """The strided view gathers what the reference's ravel_multi_index
    gather does, for random boxes of random chunks."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        cdims = tuple(int(d) for d in rng.integers(1, 9, nd))
        local = []
        for d in cdims:
            lo = int(rng.integers(0, d))
            local.append((lo, int(rng.integers(lo + 1, d + 1))))
        bs = int(rng.integers(1, 40))
        lo_b, hi_b = rgrid.block_range_for_box(local, cdims, bs)
        n = int(np.prod(cdims))
        seg = np.arange(lo_b * bs, min(hi_b * bs, n), dtype=np.int64)
        idx = np.ravel_multi_index(np.ix_(*[np.arange(lo, hi) for lo, hi in local]),
                                   cdims) - lo_b * bs
        pad = np.full(5, -1, np.int64)
        base = torch.from_numpy(np.concatenate([pad, seg, pad]))[5:-5]  # a view, offset 5
        got = box_of_segment(base, local, cdims, lo_b * bs)
        np.testing.assert_array_equal(got.numpy(), seg[idx])


# ---------------------------------------------------------------- batches
def _corpus(dtype=np.float32, seed=1):
    """(64, 300) with a constant slab; chunks of (16, 128) leave a ragged
    column of chunks, so windows are cut by chunk edges both ways."""
    x = _walk(64 * 300, seed=seed).reshape(64, 300)
    x[20:28] = 0.25
    return x.astype(dtype)


def _save(tmp_path, x, layout: str) -> str:
    if layout == "manifest":
        man = str(tmp_path / "c.json")
        ArrayStore.save_sharded(man, _tensor(x), Bound.abs(1e-3), nshards=3,
                                chunk_shape=(16, 128), device="cpu")
        return man
    path = str(tmp_path / "c.szs")
    if layout == "3d":
        ArrayStore.save(path, _tensor(x.reshape(8, 8, 300)), Bound.abs(1e-3),
                        chunk_shape=(3, 5, 64), device="cpu", stage="bitshuffle-rle")
    else:
        ArrayStore.save(path, _tensor(x), Bound.abs(1e-3), chunk_shape=(16, 128), device="cpu")
    return path


@pytest.mark.parametrize("layout", ["2d", "3d", "manifest"])
@pytest.mark.parametrize("cached", [False, True], ids=["nocache", "cache"])
@pytest.mark.parametrize("fused", [False, True], ids=["hostparse", "fused"])
def test_batches_match_the_reference(tmp_path, layout, cached, fused):
    dtype = BF16 if layout == "2d" and fused else np.float32
    x = _corpus(dtype)
    path = _save(tmp_path, x, layout)
    window = (2, 3, 70) if layout == "3d" else (6, 70)
    kw = dict(seed=5, workers=2)
    cache, rcache = (_Cache(), _Cache()) if cached else (None, None)
    with StoreLoader(path, window, 6, device="cpu", fused_range=fused, cache=cache, **kw) as ld, \
            RLoader(path, window, 6, backend="jax" if fused else "numpy", device=fused,
                    cache=rcache, **kw) as rld:
        for step in (0, 1, 7, 1):
            got = ld.batch_at(step)
            assert got.dtype == ld.dtype and got.shape == ld.batch_shape
            _same(got, rld.batch_at(step))
        if cached:
            assert len(cache) == len(rcache) > 0
        # the values are the decoded store's, within the bound
        org = ld.sampler.origins_at(7)
        full = ArrayStore.open(path, device="cpu")[...]
        for wi, o in enumerate(org):
            box = tuple(slice(int(a), int(a) + w) for a, w in zip(o, window))
            assert torch.equal(ld.batch_at(7)[wi], full[box])


def test_pipelined_batches_equal_serial_and_store_lm_matches(tmp_path):
    x = _walk(128 * 300, seed=2).reshape(128, 300)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, Bound.abs(1e-4), chunk_shape=(16, 128), device="cpu")
    with ArrayStore.open(path, device="cpu") as ca:
        ld = StoreLoader(ca, (8, 40), 4, seed=11, workers=3, lookahead=2)
        with ld.batches(steps=5) as it:
            for step, batch in enumerate(it):
                assert torch.equal(batch, ld.batch_at(step))
        with ld.batches(start_step=3, steps=2) as it:
            assert [torch.equal(b, ld.batch_at(3 + i)) for i, b in enumerate(it)] == [True] * 2
    cfg = DataConfig(512, 32, 4, seed=21)
    lm = StoreLM(path, cfg, workers=2, device="cpu")
    rlm = RStoreLM(path, RDataConfig(512, 32, 4, seed=21), workers=2, backend="numpy")
    assert lm.window_shape == rlm.window_shape
    for step in (0, 3, 1):
        for rank, nr in ((0, 1), (1, 2)):
            got, want = lm.batch_at(step, rank, nr), rlm.batch_at(step, rank, nr)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    it, rit = lm.batches(start_step=2), rlm.batches(start_step=2)
    for _ in range(3):
        got, want = next(it), next(rit)
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    it.close()
    rit.close()
    lm.close()
    rlm.close()
    with pytest.raises(ValueError, match="needs"):
        StoreLM(path, cfg, window_shape=(1, 8), device="cpu")


def test_worker_exception_raises_on_next(tmp_path):
    x = _walk(64 * 64, seed=5).reshape(64, 64)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 64), device="cpu")
    with ArrayStore.open(path, device="cpu") as ca:
        ld = StoreLoader(ca, (4, 64), 4, seed=1, workers=2)
        it = ld.batches()
        next(it)

        def explode(cid, lo_b, hi_b):
            raise ValueError("injected decode failure")

        ca._decode_chunk_range = explode        # workers hit this on later steps
        with pytest.raises(ValueError, match="injected"):
            for _ in range(8):
                next(it)
        with pytest.raises(StopIteration):
            next(it)                            # closed after the error
        assert it._pool._shutdown


def test_reuse_slots_and_copy(tmp_path):
    x = _walk(64 * 64, seed=6).reshape(64, 64)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 64), device="cpu")
    with ArrayStore.open(path, device="cpu") as ca:
        ld = StoreLoader(ca, (4, 64), 2, seed=2, workers=1, reuse_slots=2)
        it = ld.batches(steps=4)
        b0 = next(it)
        b1 = next(it)
        b2 = next(it)                           # the slot of b0 is recycled here
        assert b2 is b0 and b1 is not b0
        assert torch.equal(b2, ld.batch_at(2))
        it.close()
        ldc = StoreLoader(ca, (4, 64), 2, seed=2, workers=1, copy=True)
        got = list(ldc.batches(steps=3))
        assert len({id(b) for b in got}) == 3
        assert all(torch.equal(b, ldc.batch_at(s)) for s, b in enumerate(got))
        assert StoreLoader(ca, (4, 64), 2, reuse_slots=0).reuse_slots == 2


def test_stepped_batches_reopens_on_seek(tmp_path):
    x = _walk(64 * 128, seed=7).reshape(64, 128)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 128), device="cpu")
    ld = StoreLoader(path, (4, 128), 4, seed=3, workers=2, device="cpu")
    opened = []

    def open_at(s):
        opened.append(s)
        return ld.batches(start_step=s)

    with SteppedBatches(open_at) as fn:
        b0, b1 = fn(0).clone(), fn(1).clone()
        assert torch.equal(fn(2), ld.batch_at(2))
        # Trainer restart: jump back to step 0 -> same values again
        assert torch.equal(fn(0), b0)
        assert torch.equal(fn(1), b1)
    assert opened == [0, 0]
    ld.close()


def test_bytes_read_gate_through_a_counting_file():
    """A small-window epoch reads ~the windows' bytes, far below the file,
    and exactly the byte ranges the reference's loader reads."""
    x = _walk(512 * 1024, seed=4).reshape(512, 1024)
    buf = io.BytesIO()
    ArrayStore.save(buf, x, 1e-3, chunk_shape=(32, 1024), device="cpu")
    data = buf.getvalue()
    reads = []
    for port in (True, False):
        spy = SpyFile(io.BytesIO(data))
        opened = ArrayStore.open(spy, device="cpu") if port else \
            RStore.open(spy, backend="numpy")
        with opened as ca:
            ld = StoreLoader(ca, (2, 1024), 2, seed=13) if port else \
                RLoader(ca, (2, 1024), 2, seed=13)
            spy.reads.clear()
            steps = 2
            for s in range(steps):
                ld.batch_at(s)
            reads.append(list(spy.reads))
    assert reads[0] == reads[1]
    touched = sum(ln for _, ln in reads[0])
    window_raw = steps * 2 * 2 * 1024 * 4
    assert touched < 0.15 * len(data)
    assert touched < 8 * window_raw
    # an epoch over ~8 % of a (32768, 64)-value store at chunk (32, 64)
    y = _walk(2048 * 64, seed=9).reshape(2048, 64)
    buf = io.BytesIO()
    ArrayStore.save(buf, y, 1e-3, chunk_shape=(32, 64), device="cpu")
    spy = SpyFile(io.BytesIO(buf.getvalue()))
    with ArrayStore.open(spy, device="cpu") as ca:
        ld = StoreLoader(ca, (16, 64), 8, seed=0)
        spy.reads.clear()
        for s in range(1):
            ld.batch_at(s)
    assert spy.bytes_read() / len(buf.getvalue()) < 0.2


def test_checkpoint_save_store_feeds_the_loader(tmp_path):
    ck = CheckpointManager(str(tmp_path), compress=True, bound=Bound.abs(1e-3), device="cpu")
    corpus = _walk(128 * 256, seed=10).reshape(128, 256)
    path = ck.save_store("corpus", corpus, chunk_shape=(16, 256))
    assert os.path.exists(path) and ck.stores() == ["corpus"]
    got = ck.restore_store("corpus")
    assert float((got - torch.from_numpy(corpus)).abs().max()) <= 1e-3
    with ck.open_store("corpus") as ca:
        with StoreLoader(ca, (4, 256), 4, seed=1, workers=2) as ld:
            for s, b in enumerate(ld.batches(steps=2)):
                assert torch.equal(b, ld.batch_at(s))
    with RLoader(path, (4, 256), 4, seed=1, backend="numpy") as rld, \
            StoreLoader(path, (4, 256), 4, seed=1, device="cpu") as ld:
        _same(ld.batch_at(1), rld.batch_at(1))


def test_loader_epochs_stop_at_num_steps_and_urls_wait(tmp_path):
    x = _walk(64 * 64, seed=30).reshape(64, 64)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 64), device="cpu")
    with StoreLoader(path, (8, 8), 4, seed=3, workers=2, epochs=1, device="cpu") as ld:
        assert ld.sampler.num_steps == 16
        with ld.batches() as it:
            assert sum(1 for _ in it) == 16
        with ld.batches(start_step=14, steps=100) as it:
            assert sum(1 for _ in it) == 2
    # a service URL is a window-granular source; a dead one raises
    import threading

    from repro_torch.data.store_loader import HttpStoreSource
    from repro_torch.serve.store_service import make_server

    srv = make_server(path, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        src = make_source(url, device="cpu")
        assert isinstance(src, HttpStoreSource) and src.granularity == "window"
        assert src.shape == (64, 64) and src.dtype == torch.float32
        with StoreLoader(url, (8, 8), 4, seed=3, workers=2, epochs=1, device="cpu") as ld, \
                StoreLoader(path, (8, 8), 4, seed=3, epochs=1, device="cpu") as local:
            assert ld.sampler.num_steps == 16
            with ld.batches(start_step=14, steps=100) as it:
                got = [b.clone() for b in it]
            assert len(got) == 2 and all(torch.equal(g, local.batch_at(14 + i))
                                         for i, g in enumerate(got))
    finally:
        srv.shutdown()
        srv.server_close()
    with pytest.raises(OSError):                 # nothing listens there
        make_source("http://127.0.0.1:1/store", device="cpu", timeout=5)


@pytest.mark.parametrize("app", ["CESM", "QMCPack"])
def test_scidata_fields_match_the_reference(app):
    """Within one process (one string-hash seed) the fields are the
    reference's bit for bit."""
    assert scidata.APPLICATIONS == rscidata.APPLICATIONS
    got, want = scidata.field(app, 1), rscidata.field(app, 1)
    assert got.dtype == np.float32 and got.shape == scidata.APPLICATIONS[app]["shape"]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(scidata.block_relative_range_cdf(got),
                                  rscidata.block_relative_range_cdf(want))
    assert [n for n, _ in scidata.fields(app)] == [n for n, _ in rscidata.fields(app)]


def test_train_launcher_trains_from_a_store_with_telemetry(tmp_path, capsys):
    from repro_torch.launch import train

    x = _walk(64 * 256, seed=12).reshape(64, 256)
    store = str(tmp_path / "corpus.szs")
    ArrayStore.save(store, x, 1e-3, chunk_shape=(16, 256), device="cpu")
    prof = tmp_path / "prof"
    try:
        tr = train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--seq", "16",
                         "--batch", "2", "--ckpt", str(tmp_path / "ck"), "--device", "cpu",
                         "--data-store", store, "--data-workers", "2",
                         "--profile-dir", str(prof)])
    finally:
        obs.disable()
    out = capsys.readouterr().out
    assert "telemetry written" in out and len(tr.history) == 3
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    names = {e["name"] for e in json.loads((prof / "trace.json").read_text())["traceEvents"]}
    assert {"train.step", "ingest.batch", "store.read", "checkpoint.save"} <= names
    prom = (prof / "metrics.prom").read_text().splitlines()
    line_re = re.compile(r'^(# TYPE szx_[a-z0-9_]+ (counter|gauge|histogram)|'
                         r'szx_[a-z0-9_]+(\{[^}]*\})? [-+0-9.eInf]+)$')
    assert prom and all(line_re.match(ln) for ln in prom), prom
    batches = [ln for ln in prom if ln.startswith('szx_ingest_batches{mode="pipelined"}')]
    assert batches and int(batches[0].split()[-1]) >= 3
    assert "szx_train_steps 3" in prom
    assert json.loads((prof / "torch_trace.json").read_text())["traceEvents"]
    # the same tokens as the reference's StoreLM on the same file
    lm = StoreLM(store, DataConfig(256, 16, 2), device="cpu")
    rlm = RStoreLM(store, RDataConfig(256, 16, 2), backend="numpy")
    np.testing.assert_array_equal(lm.batch_at(2)["tokens"].numpy(), rlm.batch_at(2)["tokens"])
    obs.reset()


def test_shared_handle_and_cache_under_many_workers(tmp_path):
    """More workers than cores over one shared (locked) handle and one
    cache, with a short switch interval: every pipelined batch equals the
    serial one, and the cache holds each range once."""
    import sys

    x = _walk(256 * 300, seed=14).reshape(256, 300)
    path = str(tmp_path / "c.szs")
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 128), device="cpu")
    cache = _Cache()
    workers = 2 * (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ArrayStore.open(path, device="cpu", cache=cache) as ca:
            ld = StoreLoader(ca, (5, 90), 6, seed=2, workers=workers, lookahead=4, copy=True)
            got = list(ld.batches(steps=12))
            assert all(torch.equal(b, ld.batch_at(s)) for s, b in enumerate(got))
    finally:
        sys.setswitchinterval(old)
    with RLoader(path, (5, 90), 6, seed=2, backend="numpy") as rld:
        for s in (0, 11):
            _same(got[s], rld.batch_at(s))
    grid = ChunkGrid((256, 300), (16, 128))
    ranges = {(cid, *r) for s in range(12)
              for cid, r in plan_batch(grid, 128, ld.sampler.origins_at(s), (5, 90))[0].items()}
    assert {k[1:] for k in cache} == ranges
