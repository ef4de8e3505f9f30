"""repro_torch.store against the JAX package's store (byte-identical files).

Runs the port on the CPU (``device="cpu"``: the plain versions) and holds it
to ``repro.store`` with ``backend="numpy"``: store files (single-file and
sharded) for 4 dtypes x {stage-off, 3 stages}, opened across both
packages; ROI reads through both routes (host parse + unpack, and the fused
range decode); the seek-spy gates of tests/test_store.py and
tests/test_stage.py (ROI reads stay byte-proportional and touch only the
needed segment records); both query tiers; the grid math; the store CLI.
"""
import io
import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.codec import container as rcontainer
from repro.core.codec.plan import Bound as RBound
from repro.store import ArrayStore as RStore, grid as rgrid
from repro.store.__main__ import main as rmain
from repro_torch.core.codec import container
from repro_torch.core.codec.plan import Bound
from repro_torch.store import ArrayStore, ChunkGrid, grid
from repro_torch.store.__main__ import main as tmain

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
STAGES = [None, "bitshuffle-rle", "bitshuffle-zstd", "deflate"]
KEYS = [np.s_[...], np.s_[7], np.s_[100:141, 3:201], np.s_[:, -1], np.s_[5:5], np.s_[255, 1]]


def _walk(n, seed=0, scale=0.01, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _field(dtype, seed=2):
    """(256, 256): a walk, a zeroed slab of rows (constant blocks, all L = 0)
    and a quiet slab (1 + noise below the bound: few stored bits)."""
    x = _walk(1 << 16, seed=seed, dtype=np.float64).reshape(256, 256)
    x[:48] = 0.0
    x[160:] = 1.0 + 1e-3 * np.random.default_rng(seed).standard_normal((96, 256))
    return x.astype(dtype)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


def _same(got: torch.Tensor, want) -> None:
    assert got.device.type == "cpu" and tuple(got.shape) == np.shape(want)
    if got.numel():
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


def _covered(reads, ranges):
    for off, ln in reads:
        if not any(lo <= off and off + ln <= hi for lo, hi in ranges):
            return (off, ln)
    return None


# ---------------------------------------------------------------------------
# grid math (the port's own copy)
# ---------------------------------------------------------------------------

def test_grid_math_matches_reference():
    for shape, itemsize, target in (((1024, 256, 256), 4, 2 << 20), ((100,), 4, 2 << 20),
                                    ((4, 1 << 22), 4, 1 << 20), ((7, 33, 5), 8, 512)):
        assert grid.default_chunk_shape(shape, itemsize, target) == \
            rgrid.default_chunk_shape(shape, itemsize, target)
    g = ChunkGrid((10, 7), (4, 3))
    assert g.chunks_per_dim == (3, 3) and g.nchunks == 9
    assert [g.chunk_coord(c) for c in range(9)] == \
        [rgrid.ChunkGrid((10, 7), (4, 3)).chunk_coord(c) for c in range(9)]
    assert g.chunk_box((2, 2)) == ((8, 10), (6, 7))
    shape = (10, 8, 6)
    x = np.arange(np.prod(shape)).reshape(shape)
    for key in [np.s_[...], np.s_[2], np.s_[-1], np.s_[1:4], np.s_[:, 3], np.s_[2:5, ..., 1],
                np.s_[..., -2], np.s_[1:4, 2:3, 5], np.s_[9, 7, 5], np.s_[5:5]]:
        roi, rroi = grid.normalize_roi(key, shape), rgrid.normalize_roi(key, shape)
        assert (roi.ranges, roi.squeeze) == (rroi.ranges, rroi.squeeze)
        assert roi.out_shape == x[key].shape
        cg = ChunkGrid(shape, (3, 8, 4))
        assert list(grid.intersecting_chunks(cg, roi)) == list(
            rgrid.intersecting_chunks(rgrid.ChunkGrid(shape, (3, 8, 4)), roi))
    for bad, exc in ((np.s_[::2], ValueError), ([0, 2], TypeError), (np.s_[True], TypeError),
                     (np.s_[10], IndexError), (np.s_[0, 0, 0, 0], ValueError)):
        with pytest.raises(exc):
            grid.normalize_roi(bad, shape)
    assert grid.block_range_for_box(((2, 4), (0, 256)), (8, 256), 128) == (4, 8)
    assert grid.block_range_for_box(((3, 4), (5, 6)), (8, 256), 128) == (6, 7)
    for text in (None, "...", "0:16,:,3", "5", "...,1", "-3:,2"):
        assert grid.parse_roi(text) == rgrid.parse_roi(text)
    with pytest.raises(ValueError):
        grid.parse_roi("1:2:3:4")


# ---------------------------------------------------------------------------
# store files: byte identity, cross-open, ROI reads by both routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s or "stage-off")
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_store_files_byte_identical_and_cross_opened(dtype, stage):
    x = _field(dtype)
    e = 1e-3 if dtype.itemsize >= 4 else 1e-2
    want = io.BytesIO()
    ridx = RStore.save(want, x, e, chunk_shape=(64, 256), stage=stage)
    got = io.BytesIO()
    tidx = ArrayStore.save(got, x, e, chunk_shape=(64, 256), stage=stage, device="cpu",
                           attrs={"units": "K"})
    ridx2 = RStore.save(io.BytesIO(), x, e, chunk_shape=(64, 256), stage=stage,
                        attrs={"units": "K"})
    assert tidx == ridx2 and ("stage" in ridx) == (stage is not None)
    got2 = io.BytesIO()
    ArrayStore.save(got2, x, e, chunk_shape=(64, 256), stage=stage, device="cpu")
    assert got2.getvalue() == want.getvalue()
    ref = RStore.open(io.BytesIO(got2.getvalue()))      # the reference reads the port's
    for fused in (False, True):
        ca = ArrayStore.open(io.BytesIO(want.getvalue()), device="cpu", fused_range=fused)
        assert ca.shape == x.shape and ca.stage == ref.stage and ca.nchunks == 4
        assert ca.error_bound == ref.error_bound and ca.stored_bytes == ref.stored_bytes
        for key in KEYS:
            _same(ca[key], ref[key])
    # the 16-bit formats keep too few bits of the quiet slab's noise for RLE
    if stage is not None and (stage != "bitshuffle-rle" or dtype.itemsize > 2):
        raw = want.getvalue()
        assert any(container.stage_of_flags(raw[off + 5]) for off, _l, _n in ridx["frames"])


@pytest.mark.parametrize("stage", [None, "deflate", "bitshuffle-rle"])
def test_sharded_store_byte_identical_and_cross_opened(tmp_path, stage):
    x = _field(np.dtype(np.float32), seed=7)
    rman = RStore.save_sharded(tmp_path / "r.json", x, 1e-3, nshards=3, chunk_shape=(32, 256),
                               stage=stage)
    tman = ArrayStore.save_sharded(tmp_path / "t.json", x, 1e-3, nshards=3,
                                   chunk_shape=(32, 256), stage=stage, device="cpu")
    for si in range(3):
        a = (tmp_path / f"r.shard-{si:03d}.szs").read_bytes()
        assert a == (tmp_path / f"t.shard-{si:03d}.szs").read_bytes()
        assert tman["shards"][si]["frames"] == rman["shards"][si]["frames"]
    with ArrayStore.open(str(tmp_path / "r.json"), device="cpu") as ca, \
            RStore.open(str(tmp_path / "t.json")) as cr:
        for key in KEYS:
            _same(ca[key], cr[key])
        assert ca.stats(header_only=True).to_dict() == cr.stats(header_only=True).to_dict()
    with pytest.raises(ValueError, match="nshards"):
        ArrayStore.save_sharded(tmp_path / "z.json", x, 1e-3, nshards=99, device="cpu")


def test_roi_reads_match_numpy_3d_and_workers():
    x = _walk(64 * 48 * 32, seed=1).reshape(64, 48, 32)
    buf = io.BytesIO()
    idx = ArrayStore.save(buf, torch.from_numpy(x), Bound.rel(1e-3), chunk_shape=(16, 48, 32),
                          device="cpu", workers=3)
    assert buf.getvalue() == _store_bytes(x, Bound.rel(1e-3), chunk_shape=(16, 48, 32))
    e = idx["e"]
    with ArrayStore.open(buf, device="cpu") as ca:
        assert ca.shape == x.shape and ca.dtype == torch.float32 and ca.ndim == 3
        assert ca.nchunks == 4 and ca.error_bound == e and "CR=" in repr(ca)
        for key in [np.s_[3:9, 10:20, 5], np.s_[0], np.s_[:, 7], np.s_[-1, ...],
                    np.s_[60:, :, 30:], np.s_[63, 47, 31], np.s_[10:40]]:
            got = ca[key]
            assert tuple(got.shape) == x[key].shape
            want = torch.from_numpy(np.asarray(x[key], np.float64))
            assert float((got.double() - want).abs().max()) <= e
        assert torch.equal(ca.read(np.s_[2:4]), ca[2:4])
    with pytest.raises(ValueError, match="closed"):
        ca[0]


def _store_bytes(x, bound, **kw) -> bytes:
    buf = io.BytesIO()
    RStore.save(buf, x, RBound(bound.value, bound.mode), **kw)
    return buf.getvalue()


def test_store_rejects_bad_inputs_and_caches(tmp_path):
    for arr, exc in ((np.arange(10), TypeError), (np.float32(1.0), ValueError),
                     (np.empty((0, 4), np.float32), ValueError)):
        with pytest.raises(exc):
            ArrayStore.save(io.BytesIO(), arr, 1e-3, device="cpu")
    with pytest.raises(ValueError, match="no container-v3 index footer"):
        ArrayStore.open(io.BytesIO(b""), device="cpu")
    chunked = io.BytesIO()
    from repro_torch.core.codec import SZxCodec

    SZxCodec(device="cpu").dump_chunked(_walk(1000), chunked, 1e-3)
    with pytest.raises(ValueError, match="kind"):
        ArrayStore.open(chunked, device="cpu")
    with pytest.raises(ValueError, match="unknown second stage"):
        ArrayStore.save(io.BytesIO(), _walk(100), 1e-3, stage="huffman", device="cpu")

    class Cache(dict):
        def put(self, key, value, nbytes):
            self[key] = value

    x = _walk(4096, seed=5).reshape(64, 64)
    p = tmp_path / "a.szs"
    ArrayStore.save(str(p), x, 1e-3, device="cpu")
    with open(p, "rb") as f:
        assert container.read_index_footer(f)["kind"] == "szx-store"
    cache = Cache()
    with ArrayStore.open(str(p), device="cpu", cache=cache) as ca:
        first = ca[3:9]
        assert len(cache) == 1 and next(iter(cache))[0] == str(p)
        assert torch.equal(ca[3:9], first) and len(cache) == 1


# ---------------------------------------------------------------------------
# seek-spy gates: ROI reads stay byte-proportional
# ---------------------------------------------------------------------------

def test_acceptance_roi_read_is_byte_proportional():
    """1% ROI of a >= 64 MB stored array reads < 5% of the file's bytes and
    never reads a non-intersecting chunk (store written by the reference,
    read by the port)."""
    n = 1 << 24
    rng = np.random.default_rng(6)
    base = np.cumsum(rng.standard_normal(n // 4096)).astype(np.float32)
    x = (np.repeat(base, 4096) + rng.standard_normal(n).astype(np.float32) * 0.01)
    x = x.reshape(256, 256, 256)
    buf = io.BytesIO()
    idx = RStore.save(buf, x, RBound.rel(1e-3), workers=2)
    end = buf.seek(0, 2)
    frames = idx["frames"]
    spy = SpyFile(buf)
    ca = ArrayStore.open(spy, device="cpu")
    spy.reads.clear()
    touched: list[int] = []
    orig = ca._decode_chunk_range

    def tracking(cid, lo_b, hi_b):
        touched.append(cid)
        return orig(cid, lo_b, hi_b)

    ca._decode_chunk_range = tracking
    roi = ca[100:103]
    assert tuple(roi.shape) == (3, 256, 256)
    assert float((roi - torch.from_numpy(x[100:103])).abs().max()) <= idx["e"]
    assert spy.bytes_read() < 0.05 * end, (spy.bytes_read(), end)
    g = ChunkGrid(tuple(idx["shape"]), tuple(idx["chunk_shape"]))
    expected = [cid for cid, _, _ in grid.intersecting_chunks(
        g, grid.normalize_roi(np.s_[100:103], ca.shape))]
    assert touched == expected and 0 < len(touched) < ca.nchunks
    allowed = [(frames[c][0], frames[c][0] + frames[c][1]) for c in expected]
    assert _covered(spy.reads, allowed) is None
    spy.reads.clear()
    touched.clear()
    v = ca[42, 17, 200]
    assert abs(float(v) - float(x[42, 17, 200])) <= idx["e"]
    assert len(touched) == 1
    assert spy.bytes_read() <= frames[touched[0]][1] and spy.bytes_read() < 0.05 * end


def _staged_store():
    x = _walk(1 << 20, seed=9).reshape(1024, 1024)
    buf = io.BytesIO()
    idx = ArrayStore.save(buf, x, Bound.rel(1e-3), stage="deflate", device="cpu")
    return x, buf, idx


def _frame_regions(buf, idx):
    """Per chunk: (frame_off, prefix_end, table_end, seg_starts)."""
    regions = []
    raw = buf.getvalue()
    for off, length, _n in idx["frames"]:
        hdr = container.FRAME_HEADER.size
        payload = raw[off + hdr: off + length]
        prefix_len = container.stream_prefix_length(payload)
        if not container.stage_of_flags(raw[off + 5]):
            regions.append((off, off + hdr + prefix_len, None, None))
            continue
        _seg_blocks, nseg = struct.unpack_from("<HI", payload, prefix_len)
        lens = np.frombuffer(payload, "<u4", nseg, prefix_len + 6).astype(np.int64)
        table_end = off + hdr + prefix_len + 6 + 4 * nseg
        regions.append((off, off + hdr + prefix_len, table_end,
                        table_end + np.concatenate(([0], np.cumsum(lens)))))
    return regions


def test_staged_store_reads_only_selected_segments():
    x, buf, idx = _staged_store()
    regions = _frame_regions(buf, idx)
    assert any(r[2] is not None for r in regions), "no chunk negotiated a stage"
    end = buf.seek(0, 2)
    spy = SpyFile(buf)
    ca = ArrayStore.open(spy, device="cpu")
    # header queries: every read inside some frame's metadata prefix
    spy.reads.clear()
    ca.stats(header_only=True)
    assert _covered(spy.reads, [(off, pend) for off, pend, _t, _s in regions]) is None
    spy.reads.clear()
    got = ca[100:110, :]                      # ~1% of the rows
    assert tuple(got.shape) == (10, 1024)
    assert spy.bytes_read() < 0.30 * end
    touched = {}
    for off, ln in spy.reads:
        for ci, (foff, _p, _t, _s) in enumerate(regions):
            if foff <= off < (regions[ci + 1][0] if ci + 1 < len(regions) else end):
                touched.setdefault(ci, []).append((off, ln))
    roi_chunks = [ci for ci, reads in touched.items() if any(o >= regions[ci][1] for o, _ in reads)]
    assert roi_chunks
    for ci in roi_chunks:
        _foff, _pend, tend, starts = regions[ci]
        rec_reads = [(o, ln) for o, ln in touched[ci] if tend is not None and o >= tend]
        if not rec_reads:
            continue
        lo = min(o for o, _ in rec_reads)
        hi = max(o + ln for o, ln in rec_reads)
        assert lo in starts and hi in starts          # whole records, one run
        assert hi - lo < 0.25 * int(starts[-1] - starts[0])
    ref = RStore.open(io.BytesIO(buf.getvalue()))
    _same(got, ref[100:110, :])


# ---------------------------------------------------------------------------
# query tiers
# ---------------------------------------------------------------------------

def _query_fields(dtype):
    rng = np.random.default_rng(10)
    n = 40_000
    allc = np.full(n, 2.5).astype(dtype)
    noc = (rng.standard_normal(n) * 10).astype(dtype)
    mixed = np.where((np.arange(n) // 4000) % 2 == 0, allc.astype(np.float64),
                     noc.astype(np.float64)).astype(dtype)
    return {"all_const": allc, "no_const": noc, "mixed": mixed}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_query_tiers_match_reference(dtype):
    """Header tier: the reference's intervals exactly.  Exact tier: count,
    min and max exactly, sum within a relative 1e-12 (float64 addition
    order), and within the bound of the decoded array's stats."""
    for name, x in _query_fields(dtype).items():
        e = 1e-2 * float(x.astype(np.float64).max() - x.astype(np.float64).min() or 1.0)
        x2 = x.reshape(200, -1)
        buf = io.BytesIO()
        ArrayStore.save(buf, x2, e, chunk_shape=(64, x.size // 200), device="cpu")
        ref = RStore.open(io.BytesIO(buf.getvalue()))
        with ArrayStore.open(buf, device="cpu") as ca:
            st, rst = ca.stats(), ref.stats()
            assert st.exact and st.count == x.size
            for k in ("count", "nblocks", "const_blocks", "verbatim_blocks", "min", "max"):
                assert getattr(st, k) == getattr(rst, k), (name, k)
            assert abs(st.sum[0] - rst.sum[0]) <= 1e-12 * max(abs(rst.sum[0]), 1.0), name
            dec = ca[...].double()
            assert abs(st.mean[0] - float(dec.mean())) <= e
            assert ca.mean() == st.mean[0] and ca.min() == st.min[0] and ca.max() == st.max[0]
            assert ca.sum() == st.sum[0]
            hs = ca.stats(header_only=True)
            assert hs.to_dict() == ref.stats(header_only=True).to_dict(), name
            assert hs.min[0] <= float(dec.min()) <= hs.min[1]
            assert hs.max[0] <= float(dec.max()) <= hs.max[1]
            if name == "all_const":
                assert hs.exact and hs.const_blocks == hs.nblocks


def test_query_header_tier_never_reads_plane_bytes_and_verbatim_intervals():
    x = _walk(100_000, seed=11).reshape(100, 1000)
    buf = io.BytesIO()
    idx = ArrayStore.save(buf, x, Bound.rel(1e-3), chunk_shape=(25, 1000), device="cpu")
    raw = buf.getvalue()
    allowed = []
    for off, _length, _n in idx["frames"]:
        p0 = off + container.FRAME_HEADER.size
        _m, _v, code, _bs, _n2, _e, nb, nnc, _nm = container.HEADER.unpack_from(raw, p0)
        itemsize = 4
        allowed.append((off, p0 + container.HEADER.size + (nb + 7) // 8 + itemsize * nb + nnc))
    spy = SpyFile(io.BytesIO(raw))
    ca = ArrayStore.open(spy, device="cpu")
    spy.reads.clear()
    assert not ca.stats(header_only=True).exact
    assert _covered(spy.reads, allowed) is None
    # verbatim blocks (bound below the ulp): infinite header intervals, exact tier exact
    xv = (_walk(4000, seed=12, scale=1.0) * 100).astype(np.float32)
    bufv = io.BytesIO()
    ArrayStore.save(bufv, xv.reshape(40, 100), float(np.finfo(np.float32).tiny),
                    chunk_shape=(40, 100), device="cpu")
    with ArrayStore.open(bufv, device="cpu") as cv:
        np.testing.assert_array_equal(cv[...].numpy().reshape(-1), xv)
        hs = cv.stats(header_only=True)
        assert hs.verbatim_blocks > 0 and hs.sum == (-np.inf, np.inf)
        st = cv.stats()
        assert st.exact and st.min[0] == float(xv.min()) and st.max[0] == float(xv.max())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_cli_matches_reference(tmp_path, capsys, dtype):
    x = _walk(1 << 14, seed=13, dtype=np.float32 if dtype == "float32" else BF16)
    raw = tmp_path / "in.bin"
    x.tofile(raw)
    args = ["--shape", "128,128", "--error-bound", "1e-3", "--mode", "rel",
            "--chunk-shape", "32,128", "--dtype", dtype, "--stage", "deflate"]
    assert tmain(["create", str(raw), str(tmp_path / "t.szs"), "--device", "cpu", *args]) == 0
    assert rmain(["create", str(raw), str(tmp_path / "r.szs"), *args]) == 0
    assert (tmp_path / "t.szs").read_bytes() == (tmp_path / "r.szs").read_bytes()
    assert tmain(["read", str(tmp_path / "r.szs"), str(tmp_path / "t.bin"), "--roi", "10:20,:",
                  "--device", "cpu"]) == 0
    assert rmain(["read", str(tmp_path / "t.szs"), str(tmp_path / "r.bin"), "--roi",
                  "10:20,:"]) == 0
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    capsys.readouterr()
    assert tmain(["query", str(tmp_path / "t.szs"), "--json", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["exact"] and stats["count"] == x.size
    assert tmain(["query", str(tmp_path / "t.szs"), "--header-only", "--json",
                  "--device", "cpu"]) == 0
    hs = json.loads(capsys.readouterr().out)
    assert rmain(["query", str(tmp_path / "t.szs"), "--header-only", "--json"]) == 0
    assert hs == json.loads(capsys.readouterr().out)
    assert tmain(["query", str(tmp_path / "t.szs"), "--roi", "0:4,0:4", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert tmain(["info", str(tmp_path / "t.szs"), "--json", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["shape"] == [128, 128] and info["dtype"] == dtype and info["stage"] == "deflate"
    assert tmain(["read", str(tmp_path / "t.szs"), str(tmp_path / "x.bin"), "--roi",
                  "0:4:2,:", "--device", "cpu"]) == 1
    assert tmain(["info", str(raw), "--device", "cpu"]) == 1
    assert rcontainer.read_index_footer(open(tmp_path / "t.szs", "rb"))["kind"] == "szx-store"
