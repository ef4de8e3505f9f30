"""repro_torch on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA card with the CUDA toolkit (the kernels
build from ``src/repro_torch/csrc`` at first use) and skips without one.
This file imports nothing of the JAX package, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The plain versions are themselves held to the JAX package by the other
``tests/test_torch_*.py`` files on the CPU; here the kernels must match
them bit for bit.
"""
import io

import pytest
import torch

from repro_torch.core.codec import SZxCodec, container, device, plan
from repro_torch.kernels import decode, encode, ops, ref, specs

pytestmark = pytest.mark.cuda
NAMES = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops.reset_launch_counts()
    return torch.device("cuda")


def _walk(n, dtype, seed=0, scale=0.01, dev="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.cumsum(torch.randn(n, dtype=torch.float64, generator=g), 0) * scale
    return x.to(dtype).to(dev)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _with_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """x with NaN (quiet, signalling, both signs) and inf values spread in."""
    x = x.clone()
    n = x.numel()
    x[n // 7] = float("inf")
    x[n // 5] = -float("inf")
    x[n // 3: n // 3 + 3] = float("nan")
    w = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
    quiet_or_not = {2: (0x7C01, -0x03CD), 4: (0x7F800001, -0x007FFEDD), 8: (0x7FF0000000000001, -1)}
    w[n // 2], w[n // 2 + 1] = quiet_or_not[x.element_size()]
    return x


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_encode_kernel_matches_plain(card, spec):
    shapes = ((4096, 128), (257, 1), (97, 100), (5, 4096))
    for nb, bs in shapes:
        x = _with_nonfinite(_walk(nb * bs, spec.dtype, seed=nb, dev=card)).reshape(nb, bs)
        for e in (1e-3, float(torch.finfo(spec.dtype).tiny)):
            p_e = specs.exact_exponent_of(e)
            k = encode.encode(x, e, p_e, spec=spec)
            p = encode.encode_plain(x, e, spec, p_e)
            for name, a, b in zip(NAMES, k, p):
                assert _same(a, b), f"{spec.name} {nb}x{bs} e={e}: {name}"
    assert ops.launch_counts()["encode"] == 2 * len(shapes)


def _block_starts(body, nnc, nbytes, rank, bs, itemsize):
    """Each block's first mid byte and the body's mid section offset, from
    the L codes as the plain version reads them."""
    nb = rank.numel()
    l_off = (nb + 7) // 8 + itemsize * nb + nnc
    pos = rank.long()[:, None] * bs + torch.arange(bs, device=body.device)
    code = (body[(l_off + pos // 4).clamp(0, body.numel() - 1)].long() >> ((pos % 4) * 2)) & 3
    counts = (nbytes.long()[:, None] - torch.where(rank[:, None] >= 0, code, 0)).clamp(min=0)
    counts = counts.sum(1)
    return torch.cumsum(counts, 0) - counts, l_off + (nnc * bs + 3) // 4


# (n, bs); the last four cross many tiles of the decode's scan (256 blocks of
# 128, 2048 of 1): the 64 MiB f32 frame's 131,072 blocks, bs 1 with ~300,000
# blocks, and nb just below and above a tile boundary
DECODE_SHAPES = ((100_003, 128), (3000, 1), (20_037, 100), (4096 * 9, 4096),
                 (131_072 * 128, 128), (300_007, 1), (767 * 128, 128), (769 * 128 - 5, 128))


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_decode_kernel_matches_plain(card, spec):
    for n, bs in DECODE_SHAPES:
        x = _with_nonfinite(_walk(n, spec.dtype, seed=n))
        codec = SZxCodec(bs) if n > 1_000_000 else SZxCodec(bs, "cpu")   # the same bytes
        buf = codec.compress(x.to(card) if n > 1_000_000 else x, 1e-3)
        nb = -(-n // bs)
        nnc = container.HEADER.unpack_from(buf, 0)[7]
        body = torch.frombuffer(bytearray(buf[container.HEADER.size:]), dtype=torch.uint8).to(card)
        meta = ref.parse_body_ref(body, nnc, spec, nb)[1:5]
        full = None
        for lo, rb in ((0, nb), (nb // 2, nb - nb // 2), (nb - 1, 1)):
            kv, kt = decode.decode_body(body, nnc, lo, *meta, spec=spec, bs=bs, rb=rb)
            pv, pt = decode.decode_body_plain(body, nnc, lo, *meta, spec, bs=bs, rb=rb)
            assert _same(kv, pv) and int(kt) == int(pt), (spec.name, n, bs, lo, rb)
            full = kv if full is None else full
        # a store ROI read: the body's mid section starts at block lo's first byte
        starts, mid_off = _block_starts(body, nnc, meta[2], meta[3], bs, spec.itemsize)
        lo, rb = nb // 3, max(1, nb // 8)
        a = int(starts[lo])
        b = int(starts[lo + rb]) if lo + rb < nb else body.numel() - mid_off
        rbody = torch.cat([body[:mid_off], body[mid_off + a: mid_off + b]])
        kv, kt = decode.decode_body(rbody, nnc, lo, *meta, spec=spec, bs=bs, rb=rb, rebase=True)
        pv, pt = decode.decode_body_plain(rbody, nnc, lo, *meta, spec, bs=bs, rb=rb, rebase=True)
        assert _same(kv, pv) and int(kt) == int(pt), (spec.name, n, bs, "rebase", lo, rb)
        assert _same(kv, full[lo:lo + rb]), (spec.name, n, bs, "rebase vs full", lo, rb)


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_decode_kernel_matches_plain_on_corrupt_bodies(card, spec):
    """Metadata and L codes that no encoder writes -- stored-byte counts past
    the dtype width, zeroed L codes that push the mid offsets past the body's
    end -- decode as the plain version decodes them (every read clamped to
    the body), and the measured total says so."""
    n, bs = 20_000, 128
    buf = SZxCodec(bs, "cpu").compress(_walk(n, spec.dtype, seed=7), 1e-3)
    nb = -(-n // bs)
    nnc = container.HEADER.unpack_from(buf, 0)[7]
    body = torch.frombuffer(bytearray(buf[container.HEADER.size:]), dtype=torch.uint8).to(card)
    mu, shift, nbytes, rank = ref.parse_body_ref(body, nnc, spec, nb)[1:5]
    wide = nbytes.clone()
    wide[3::7] = spec.itemsize + 3                  # more stored bytes than the width
    l_off = (nb + 7) // 8 + spec.itemsize * nb + nnc
    zeroed = body.clone()
    zeroed[l_off: l_off + (nnc * bs + 3) // 4] = 0   # every value stores every byte
    for bod, nbt in ((body, wide), (zeroed, nbytes), (zeroed, wide)):
        for lo, rb in ((0, nb), (nb // 3, 9)):
            kv, kt = decode.decode_body(bod, nnc, lo, mu, shift, nbt, rank, spec=spec, bs=bs, rb=rb)
            pv, pt = decode.decode_body_plain(bod, nnc, lo, mu, shift, nbt, rank, spec, bs=bs, rb=rb)
            assert _same(kv, pv) and int(kt) == int(pt), (spec.name, lo, rb)
    torch.cuda.synchronize()


@pytest.mark.parametrize("workers", [1, 2])
def test_codec_on_card_matches_cpu_route(card, workers):
    gpu, cpu = SZxCodec(workers=workers), SZxCodec(device="cpu")
    for spec in specs.SPECS:
        x = _walk(300_001, spec.dtype, seed=spec.code, scale=0.001)
        buf = gpu.compress(x.to(card), plan.Bound.rel(1e-3))
        assert buf == cpu.compress(x, plan.Bound.rel(1e-3)), spec.name
        y = gpu.decompress(buf)
        assert y.device.type == "cuda" and _same(y.cpu(), cpu.decompress(buf))
        frames = list(gpu.compress_chunked(x, 1e-3, chunk_bytes=1 << 18))
        assert frames == list(cpu.compress_chunked(x, 1e-3, chunk_bytes=1 << 18))
        yc = gpu.decompress_chunked(frames, n=x.numel())
        assert _same(yc.cpu(), cpu.decompress_chunked(frames))
        f = io.BytesIO()
        gpu.dump_chunked(x, f, 1e-3, chunk_bytes=1 << 18)
        sel = gpu.load_chunked(io.BytesIO(f.getvalue()), select=[1])
        assert _same(sel.cpu(), cpu.load_chunked(io.BytesIO(f.getvalue()), select=[1]))
        part = gpu.decompress_range(buf, 100, 300)
        assert _same(part.cpu(), cpu.decompress(buf)[100 * 128:300 * 128])
    counts = ops.launch_counts()
    assert counts["encode"] > 0 and counts["decode_body"] > 0


def test_corrupt_streams_raise_on_card(card):
    gpu = SZxCodec()
    buf = bytearray(gpu.compress(_walk(5000, torch.float32), 1e-3))
    nb = container.HEADER.unpack_from(buf, 0)[6]
    bad = bytearray(buf)
    bad[container.HEADER.size + (nb + 7) // 8 + 4 * nb] = 255      # reqlen byte
    with pytest.raises(ValueError, match="reqlen exceeds dtype width"):
        gpu.decompress(bytes(bad))
    bad = bytearray(buf)
    bad[container.HEADER.size] ^= 0x80                              # bitmap bit
    with pytest.raises(ValueError, match="n_nonconst mismatch"):
        gpu.decompress(bytes(bad))
    torch.cuda.synchronize()                  # no fault from clamped gathers


def test_one_body_copy_per_frame_on_card(card, monkeypatch):
    """Per frame: one small copy of (nnc, nmid), one copy of the body."""
    gets = []
    real = device.to_host
    monkeypatch.setattr(device, "to_host", lambda t: gets.append(t.numel()) or real(t))
    x = _walk(300_000, torch.float32, dev=card)
    frames = list(SZxCodec().compress_chunked(x, 1e-3, chunk_bytes=1 << 19))
    payloads = list(container.iter_frames(frames))
    assert gets == [n for p in payloads for n in (2, len(p) - container.HEADER.size)]


def _off_by_one(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one byte past an aligned address."""
    buf = torch.empty(t.numel() * t.element_size() + 1, dtype=torch.uint8, device=t.device)
    view = buf[1:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_bitshuffle_kernel_matches_plain(card, spec):
    """Both routes: the vector route for tiles on 16 bytes (nt 1, 3, 257 and
    a 64 MiB frame's worth), the scalar route for tiles one byte off; nt = 0
    launches nothing; launches counted by route."""
    from repro_torch.kernels import bitshuffle

    g = torch.Generator().manual_seed(spec.code)
    T = specs.tile_bytes(spec)
    cases = [torch.randint(0, 256, (nt, T), dtype=torch.uint8, generator=g).to(card)
             for nt in (0, 1, 3, 257, (64 << 20) // T)]
    cases.append(_off_by_one(cases[3]))
    assert bitshuffle.route(cases[-1].data_ptr()) == "scalar"
    assert {bitshuffle.route(t.data_ptr()) for t in cases[:-1]} == {"vector"}
    for tiles in cases:
        nt = tiles.shape[0]
        fwd = bitshuffle.bitshuffle(tiles, spec=spec)
        assert torch.equal(fwd, bitshuffle.bitshuffle_plain(tiles, False)), (spec.name, nt)
        inv = bitshuffle.bitshuffle(tiles, spec=spec, inverse=True)
        assert torch.equal(inv, bitshuffle.bitshuffle_plain(tiles, True)), (spec.name, nt)
        assert torch.equal(bitshuffle.bitshuffle(fwd, spec=spec, inverse=True), tiles)
    with pytest.raises(ValueError, match="tile width"):
        bitshuffle.bitshuffle(torch.zeros((1, T + 8), dtype=torch.uint8, device=card), spec=spec)
    counts = ops.launch_counts()
    assert counts["bitshuffle"] == 5 and counts["bitshuffle_inverse"] == 10
    routes = ops.store_route_counts()
    assert (routes["bitshuffle_vector"], routes["bitshuffle_scalar"]) == (4, 1)
    assert (routes["bitshuffle_inverse_vector"], routes["bitshuffle_inverse_scalar"]) == (9, 1)


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_unpack_kernels_match_plain(card, spec):
    """Both routes of both kernels: the vector route for bs 128, 100, 4096
    and a 64 MiB frame (bs 128), the scalar route for bs 1 and for planes
    and L one byte off their alignment; nb = 0 launches nothing; launches
    counted by route."""
    from repro_torch.kernels import unpack

    frame_nb = (64 << 20) // (spec.itemsize * 128)
    want = dict.fromkeys(("unpack_vector", "unpack_scalar", "unpack_dense_vector",
                          "unpack_dense_scalar"), 0)
    for nb, bs in ((4096, 128), (257, 1), (97, 100), (5, 4096), (frame_nb, 128)):
        x = _with_nonfinite(_walk(nb * bs, spec.dtype, seed=nb, dev=card)).reshape(nb, bs)
        x[1::3] = 0.0
        x[1::3, ::2] = -0.0                               # blocks of mixed-sign zeros
        for e in (1e-3, float(torch.finfo(spec.dtype).tiny)):
            mu, _c, _r, shift, nbytes, planes, L = encode.encode(
                x, e, specs.exact_exponent_of(e), spec=spec)
            cases = [(planes, L)]
            if bs == 100:                                 # the vector shape, one byte off
                cases.append((_off_by_one(planes), _off_by_one(L)))
            for pl, LL in cases:
                k = unpack.unpack(pl, mu, shift, nbytes, LL, spec=spec)
                assert _same(k, unpack.unpack_plain(pl, mu, shift, nbytes, LL, spec))
                kd = unpack.unpack_dense(pl, mu, shift, nbytes, spec=spec)
                assert _same(kd, unpack.unpack_dense_plain(pl, mu, shift, nbytes, spec))
                if not bool(LL.any()):
                    assert _same(k, kd)
                want[f"unpack_{unpack.tensor_route(pl, LL)}"] += 1
                want[f"unpack_dense_{unpack.tensor_route(pl)}"] += 1
    empty = torch.zeros((0, spec.itemsize, 128), dtype=torch.uint8, device=card)
    none = torch.zeros(0, dtype=torch.int32, device=card)
    got = unpack.unpack(empty, torch.zeros(0, dtype=spec.dtype, device=card), none, none,
                        torch.zeros((0, 128), dtype=torch.uint8, device=card), spec=spec)
    assert got.shape == (0, 128) and got.dtype == spec.dtype
    counts = ops.launch_counts()
    assert counts["unpack"] == 12 and counts["unpack_dense"] == 12
    routes = {k: v for k, v in ops.store_route_counts().items() if k.startswith("unpack")}
    assert routes == want and routes["unpack_vector"] == 8 and routes["unpack_scalar"] == 4


def test_store_path_takes_the_vector_route(card, tmp_path):
    """A staged store's save, ROI reads (host parse + unpack) and exact query
    launch unpack, unpack_dense and bitshuffle both ways, every launch on
    the vector route."""
    from repro_torch.store import ArrayStore

    x = _walk(1 << 18, torch.float32, seed=3).reshape(256, 1024)
    x[:32] = 0.0
    x[32:40] = torch.linspace(1.0, 2.0, 1024) * torch.tensor([1.0, -1.0]).repeat(512)
    x[-32:] = 1.0 + 1e-3 * torch.randn((32, 1024), generator=torch.Generator().manual_seed(1))
    ArrayStore.save(tmp_path / "c.szs", x.to(card), 1e-3, chunk_shape=(64, 1024),
                    stage="bitshuffle-rle")
    ca = ArrayStore.open(tmp_path / "c.szs")
    for key in ((Ellipsis,), (slice(33, 38),), (slice(100, 141), slice(3, 901)), (250, -1)):
        assert ca[key].device.type == "cuda"
    assert ca.stats().exact
    routes = ops.store_route_counts()
    assert all(routes[k] > 0 for k in ("unpack_vector", "unpack_dense_vector",
                                       "bitshuffle_vector", "bitshuffle_inverse_vector")), routes
    assert not any(v for k, v in routes.items() if k.endswith("scalar")), routes


@pytest.mark.parametrize("stage", [None, "bitshuffle-rle", "deflate"])
def test_staged_store_round_trip_on_card(card, stage, tmp_path):
    from repro_torch.store import ArrayStore

    x = _walk(1 << 18, torch.float32, seed=3).reshape(256, 1024)
    x[:32] = 0.0
    x[-32:] = 1.0 + 1e-3 * torch.randn((32, 1024), generator=torch.Generator().manual_seed(1))
    ArrayStore.save(tmp_path / "c.szs", x.to(card), 1e-3, chunk_shape=(64, 1024), stage=stage)
    ArrayStore.save(tmp_path / "h.szs", x, 1e-3, chunk_shape=(64, 1024), stage=stage,
                    device="cpu")
    assert (tmp_path / "c.szs").read_bytes() == (tmp_path / "h.szs").read_bytes()
    cpu = ArrayStore.open(tmp_path / "h.szs", device="cpu")
    for fused in (False, True):
        ca = ArrayStore.open(tmp_path / "c.szs", fused_range=fused)
        for key in ((Ellipsis,), (slice(0, 16),), (slice(100, 141), slice(3, 901)), (250, -1)):
            got = ca[key]
            assert got.device.type == "cuda" and _same(got.cpu(), cpu[key]), (stage, key)
        assert ca.stats().to_dict()["max"] == cpu.stats().to_dict()["max"]
        assert ca.stats(header_only=True).to_dict() == cpu.stats(header_only=True).to_dict()
    counts = ops.launch_counts()
    assert counts["unpack"] > 0 and counts["unpack_dense"] > 0 and counts["decode_body"] > 0
    if stage == "bitshuffle-rle":
        assert counts["bitshuffle"] > 0 and counts["bitshuffle_inverse"] > 0


@pytest.mark.parametrize("fused", [False, True], ids=["hostparse", "fused"])
def test_pipelined_ring_buffer_under_a_busy_consumer(card, fused, tmp_path):
    """Workers decode on streams of their own and each batch is assembled on
    the consumer's stream after waiting on their events.  Under a consumer
    that queues heavy work on each batch (a long spin, then a copy of the
    batch behind it) with the smallest ring, every pipelined batch equals
    the serial one bit for bit, and the CPU route's, also with a decoded
    range cache shared across the workers' streams; StoreLM's tokens on the
    card equal the CPU route's."""
    from repro_torch.data import DataConfig, StoreLM, StoreLoader
    from repro_torch.store import ArrayStore

    x = _walk(1 << 20, torch.float32, seed=4).reshape(512, 2048)
    path = tmp_path / "c.szs"
    ArrayStore.save(path, x.to(card), 1e-3, chunk_shape=(32, 2048))
    class Cache(dict):                               # shared by every worker's handle
        def put(self, key, value, nbytes):
            self[key] = value

    ld = StoreLoader(path, (16, 700), 8, seed=1, workers=4, lookahead=3, reuse_slots=2,
                     fused_range=fused, cache=Cache() if fused else None)
    seen = []
    with ld.batches(steps=12) as it:
        for batch in it:
            assert batch.device.type == "cuda"
            torch.cuda._sleep(20_000_000)          # ~10 ms of work queued on the batch
            seen.append(batch.clone())
    torch.cuda.synchronize()
    cpu = StoreLoader(path, (16, 700), 8, seed=1, device="cpu")
    for step, got in enumerate(seen):
        assert _same(got, ld.batch_at(step)), step
        assert _same(got.cpu(), cpu.batch_at(step)), step
    counts = ops.launch_counts()
    assert counts["decode_body" if fused else "unpack"] > 0, counts
    lm = StoreLM(path, DataConfig(128256, 2048, 4), fused_range=fused)
    want = StoreLM(path, DataConfig(128256, 2048, 4), device="cpu").batch_at(3)
    got = lm.batch_at(3)
    assert got["tokens"].device.type == "cuda"
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    assert torch.equal(got["labels"].cpu(), want["labels"])


@pytest.mark.parametrize("fused", [False, True], ids=["hostparse", "fused"])
def test_store_service_on_card_over_a_socket(card, fused, tmp_path):
    """The service decodes on the card: over a socket, every /read body is
    bit-identical to ``ca[roi]`` read on the card from a handle of its own,
    RemoteStore gives that tensor on the card, and a pipelined HTTP loader
    (windows copied to the card on the workers' streams) equals batch_at
    and the local loader."""
    import threading

    from repro_torch.data import StoreLoader
    from repro_torch.serve.client import RemoteStore
    from repro_torch.serve.service import HttpServer
    from repro_torch.serve.store_service import make_service
    from repro_torch.store import ArrayStore

    x = _walk(1 << 20, torch.float32, seed=6).reshape(512, 2048)
    path = tmp_path / "c.szs"
    ArrayStore.save(path, x.to(card), 1e-3, chunk_shape=(32, 2048))
    svc = make_service(str(path), fused_range=fused)
    assert svc.device.type == "cuda"
    srv = HttpServer(svc)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        ca = ArrayStore.open(path)
        remote = RemoteStore(base + "/v1/stores/default")
        for key in ((Ellipsis,), (slice(5, 70),), (slice(100, 141), slice(3, 901)), (250, -1),
                    (7,)):
            got = remote[key]
            assert got.device.type == "cuda" and _same(got, ca[key]), key
        ld = StoreLoader(base, (16, 700), 8, seed=1, workers=4, lookahead=3, reuse_slots=2)
        local = StoreLoader(path, (16, 700), 8, seed=1, workers=0)
        seen = []
        with ld.batches(steps=8) as it:
            for batch in it:
                assert batch.device.type == "cuda"
                torch.cuda._sleep(20_000_000)      # a consumer busy with each batch
                seen.append(batch.clone())
        for step, got in enumerate(seen):
            assert _same(got, ld.batch_at(step)) and _same(got, local.batch_at(step)), step
        counts = ops.launch_counts()
        assert counts["decode_body" if fused else "unpack"] > 0, counts
    finally:
        srv.shutdown()
        srv.server_close()


def _f32(bits) -> float:
    return torch.tensor(bits, dtype=torch.int32).view(torch.float32).item()


def _planes_edge_blocks(bs: int = 8) -> torch.Tensor:
    """Blocks the planes math must get right: constant blocks, signed zeros,
    subnormals, tiny radius (sexp >= 127), NaN with payloads, +-inf, and
    min + max that overflows."""
    nan, inf = float("nan"), float("inf")
    snan, neg_nan = _f32(0x7F812345), _f32(-0x003FFFFF)        # 0xFFC00001
    fill = [float(i) for i in range(1, bs)]
    rows = [[0.0] * bs, [-0.0] * bs, [0.0, -0.0] * (bs // 2), [3.5] * bs, [1e-40] * bs,
            [0.0] * 3 + [1e-40] + [0.0] * (bs - 4), [-1e-40, 1e-40] + [0.0] * (bs - 2),
            [1e-38, 1.2e-38] + [1.1e-38] * (bs - 2), [1.5e-38, -1.2e-38] + [1.3e-38] * (bs - 2),
            [1.0, 1.0 + 2 ** -23] + [1.0] * (bs - 2), [1e-30] * (bs - 1) + [1.0000001e-30],
            [nan] + fill, [1.0, nan, nan] + fill[2:], [snan] + fill, [neg_nan] * bs,
            [inf] + fill, [-inf] + fill, [inf, -inf] + [0.0] * (bs - 2), [inf] * bs,
            [3e38, 2e38] + [3.3e38] * (bs - 2), [-3e38, -2e38] + [-3.3e38] * (bs - 2),
            [3.4e38, -3.4e38] + fill[:-1]]
    return torch.tensor(rows, dtype=torch.float32)


def test_planes_kernels_match_plain(card):
    """Both routes of both kernels: the vector route for power-of-two blocks
    of 4 or more values on aligned storage, the scalar route for bs 1, 3, 6
    and for a view one float off its alignment (planes one byte off for the
    decode); the launches counted by route."""
    from repro_torch.kernels import planes

    g = torch.Generator().manual_seed(5)
    cases = []
    for bs in (1, 3, 4, 6, 8, 16, 32, 64, 128, 4096):
        nb = max(2, (1 << 16) // bs)
        scale = torch.exp2(torch.randint(-40, 40, (nb, 1), generator=g).float())
        cases.append(torch.randn((nb, bs), generator=g) * scale)
    cases += [torch.randn((3, 5, 2, 32), generator=g), torch.zeros((0, 64)),
              _planes_edge_blocks(), _planes_edge_blocks(64)]
    base = 1.0 + torch.rand((200, 1), generator=g)
    cases.append(base + torch.randint(0, 3, (200, 16), generator=g) * 2.0 ** -23 * base)
    routes = dict.fromkeys(("encode_vector", "encode_scalar", "decode_vector",
                            "decode_scalar"), 0)
    n_enc = n_dec = 0
    for x in cases:
        for P in (1, 2, 3):
            xc = x.to(card)
            if x.numel():
                which = planes.encode_route(xc)
                routes[f"encode_{which}"] += 1
                routes[f"decode_{which}"] += 1      # the encode's planes: aligned
            k = planes.planes_encode(xc, P)
            p = planes.planes_encode_plain(xc, P)
            for name, a, b in zip(("mu", "sexp", "planes"), k, p):
                assert _same(a, b), (tuple(x.shape), P, name)
            assert _same(planes.planes_decode(*k), planes.planes_decode_plain(*p)), (x.shape, P)
            n_enc += x.numel() > 0
            n_dec += x.numel() > 0
    # a view one float off 16 bytes, and planes one byte off: the scalar route
    flat = torch.randn(4096 * 64 + 1, generator=g).to(card)
    x = flat[1:].reshape(4096, 64)
    assert planes.encode_route(x) == "scalar"
    for P in (1, 2, 3):
        k = planes.planes_encode(x, P)
        for name, a, b in zip(("mu", "sexp", "planes"), k, planes.planes_encode_plain(x, P)):
            assert _same(a, b), ("view", P, name)
        off = torch.empty(k[2].numel() + 1, dtype=torch.uint8, device=card)
        pv = off[1:].view(k[2].shape)
        pv.copy_(k[2])
        assert planes.decode_route(pv) == "scalar"
        assert _same(planes.planes_decode(k[0], k[1], pv), planes.planes_decode_plain(*k)), P
        routes["encode_scalar"] += 1
        routes["decode_scalar"] += 1
        n_enc += 1
        n_dec += 1
    nb, bs = 4096, 16
    mu = torch.randn(nb, generator=g) * torch.exp2(torch.randint(-140, 127, (nb,), generator=g).float())
    mu[::97], mu[1::101], mu[2::103], mu[3::107] = float("nan"), float("inf"), 1e-40, -0.0
    sexp = torch.randint(-300, 300, (nb,), generator=g, dtype=torch.int32)
    sexp[::5] = torch.tensor([-128, -127, -126, -125, 125, 126, 127, 128, 0, 2 ** 31 - 1,
                              -2 ** 31], dtype=torch.int32).repeat(nb // 50 + 1)[: len(sexp[::5])]
    for P in (1, 2, 3):
        pl = torch.randint(0, 256, (P, nb, bs), generator=g, dtype=torch.uint8)
        args = (mu.to(card), sexp.to(card), pl.to(card))
        assert _same(planes.planes_decode(*args), planes.planes_decode_plain(*args)), P
        n_dec += 1
        routes["decode_vector"] += 1
    counts = ops.launch_counts()
    assert counts["planes_encode"] == n_enc and counts["planes_decode"] == n_dec
    assert ops.planes_route_counts() == {f"planes_{k}": v for k, v in routes.items()}
    assert min(routes.values()) > 0


def test_planes_decode_reads_every_sexp_width(card):
    """int8 (the KV cache), int16 (the gradient wire) and int32 sexp decode
    to the same bits on both routes, with no cast launched."""
    from repro_torch.kernels import planes

    g = torch.Generator().manual_seed(11)
    for bs in (64, 3):
        nb = 2000
        mu = (torch.randn(nb, generator=g) * 10).to(card)
        sexp = torch.randint(-127, 128, (nb,), generator=g, dtype=torch.int32).to(card)
        for P in (1, 2, 3):
            pl = torch.randint(0, 256, (P, nb, bs), generator=g, dtype=torch.uint8).to(card)
            want = planes.planes_decode_plain(mu, sexp, pl)
            for dt in (torch.int8, torch.int16, torch.int32):
                assert _same(planes.planes_decode(mu, sexp.to(dt), pl), want), (bs, P, dt)
                assert _same(ops.planes_decode(mu, sexp.to(dt), pl), want), (bs, P, dt)
    counts = ops.planes_route_counts()
    assert counts["planes_decode_vector"] == counts["planes_decode_scalar"] == 18


def test_planes_codec_on_card_matches_cpu_route(card):
    from repro_torch.core.codec import PlanesCodec

    x = torch.randn((6, 7, 300), generator=torch.Generator().manual_seed(9))
    for P in (1, 2, 3):
        codec = PlanesCodec(P)
        enc = codec.encode_last_axis_device(x.to(card), 64)
        ref_enc = codec.encode_last_axis_device(x, 64)
        for name in ("mu", "sexp", "planes"):
            assert enc[name].device.type == "cuda" and _same(enc[name].cpu(), ref_enc[name])
        y = codec.decode_last_axis_encoding(enc, x.shape, torch.float32)
        assert _same(y.cpu(), codec.decode_last_axis_encoding(ref_enc, x.shape, torch.float32))
        host = codec.encode_blocks(x.numpy().reshape(-1, 100))      # numpy goes to the card
        assert host[0].device.type == "cuda"
    counts = ops.launch_counts()
    assert counts["planes_encode"] == 6 and counts["planes_decode"] == 3


COLLECTIVES_WORKER = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import grad_compress as gc
from repro_torch.pipeline_par import pipeline_apply

rank, n, backend, store, inputs, dest = sys.argv[1:7]
rank, n = int(rank), int(n)
dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
if backend == "nccl":
    torch.cuda.set_device(dev)
dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
                        timeout=timedelta(seconds=120))
d = {k: torch.from_numpy(v).to(dev) for k, v in np.load(inputs).items()}
ring = [(i, (i + 1) % n) for i in range(n)]
out = {}
for P in (1, 3):
    g = {"w": d["gw"][rank], "b": {"bias": d["gb"][rank]}}
    mean, res = gc.compressed_psum_mean(g, None, num_planes=P)
    out[f"psum{P}/mean"], out[f"psum{P}/resid"] = mean["w"], res["b"]["bias"]
out["ring_p1"] = gc.compressed_ppermute(d["xp"][rank], None, ring, num_planes=1)
out["partial_p2"] = gc.compressed_ppermute(d["xp"][rank], None, [(0, n - 1)], num_planes=2)
out["a2a_p2"] = gc.compressed_all_to_all(d["xa"][rank], None, 0, 1, num_planes=2)
exact = lambda p, x: x * p[0] + p[1]
out["pipe_raw"] = pipeline_apply(exact)(d["wx"][rank], d["xx"])
for P in (1, 3):
    out[f"pipe_p{P}"] = pipeline_apply(exact, compress_activations=True,
                                       num_planes=P)(d["wx"][rank], d["xx"])
np.savez(dest, **{k: v.cpu().numpy() for k, v in out.items()})
dist.destroy_process_group()
print("WORKER-OK")
"""


def test_collectives_across_cards_match_gloo(card, tmp_path):
    """With two or more cards: the collectives and the pipeline on NCCL, one
    rank per card, give the bits the same code gives on gloo on the CPU
    (which tests/test_torch_grad_compress.py holds to the reference).  The
    pipeline's stages are exact in float32 (x * a + b, a a power of two), so
    the compressed shifts alone make its output differ from the raw run's."""
    import os
    import subprocess
    import sys

    import numpy as np

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "in.npz",
             gw=(rng.standard_normal((n, 3, 130)) * 0.01).astype(np.float32),
             gb=rng.standard_normal((n, 70)).astype(np.float32),
             xp=rng.standard_normal((n, 8, 64)).astype(np.float32),
             xa=rng.standard_normal((n, 2 * n, 12, 64)).astype(np.float32),
             wx=np.stack([np.exp2(rng.integers(-1, 2, (n, 64))),
                          rng.integers(-4096, 4097, (n, 64))], axis=1).astype(np.float32),
             xx=(rng.uniform(-1, 1, (8, 2, 64)) * 8192).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=str(__import__("pathlib").Path(__file__).parents[1] / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLLECTIVES_WORKER, str(r), str(n), backend,
         str(tmp_path / f"store-{backend}"), str(tmp_path / "in.npz"),
         str(tmp_path / f"{backend}{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for backend in ("nccl", "gloo") for r in range(n)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log in logs:
        assert "WORKER-OK" in log, log[-3000:]
    for r in range(n):
        got, want = np.load(tmp_path / f"nccl{r}.npz"), np.load(tmp_path / f"gloo{r}.npz")
        for k in want.files:
            assert np.array_equal(got[k].view(np.int32), want[k].view(np.int32)), (r, k)
        for P in (1, 3):
            assert np.abs(got[f"pipe_p{P}"] - got["pipe_raw"]).max() > 0, (r, P)


def test_wrappers_raise_when_a_launch_fails(card, monkeypatch):
    """No fallback: a CUDA tensor whose launch fails raises, and the plain
    version is not run in its place."""
    from repro_torch.kernels import _build, bitshuffle, planes, unpack

    monkeypatch.setattr(_build, "function", lambda *a, **k: (lambda *args: 1))
    monkeypatch.setattr(bitshuffle, "bitshuffle_plain", None)
    monkeypatch.setattr(unpack, "unpack_plain", None)
    monkeypatch.setattr(planes, "planes_encode_plain", None)
    monkeypatch.setattr(planes, "planes_decode_plain", None)
    with pytest.raises(RuntimeError, match="launch failed"):
        planes.planes_encode(torch.zeros((4, 8), device=card), 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        planes.planes_decode(torch.zeros(4, device=card),
                             torch.zeros(4, dtype=torch.int32, device=card),
                             torch.zeros((1, 4, 8), dtype=torch.uint8, device=card))
    with pytest.raises(RuntimeError, match="launch failed"):
        bitshuffle.bitshuffle(torch.zeros((1, 4096), dtype=torch.uint8, device=card))
    nb, bs = 4, 8
    args = (torch.zeros((nb, 4, bs), dtype=torch.uint8, device=card),
            torch.zeros(nb, device=card), torch.zeros(nb, dtype=torch.int32, device=card),
            torch.zeros(nb, dtype=torch.int32, device=card))
    with pytest.raises(RuntimeError, match="launch failed"):
        unpack.unpack(*args, torch.zeros((nb, bs), dtype=torch.uint8, device=card))
    with pytest.raises(RuntimeError, match="launch failed"):
        unpack.unpack_dense(*args)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# flash-attention forward (the model's attention) and the serving path
# ---------------------------------------------------------------------------

# (B, Sq, Hq, Hkv, hd, causal, window, Skv): the shapes of tests/test_torch_flash.py,
# unaligned S, GQA groups 1..6 and 32, the configs' head dims 64, 80, 128,
# llama3.2-1b's prefill length (causal and a window of 512), the prefills
# of hymba-1.5b (G = 5, a window equal to S) and deepseek-moe-16b (G = 1, hd 128),
# whisper-medium's encoder (non-causal, S = 1500, a ragged last key tile), its
# cross-attention (Sq 384 against Skv 1500) and decoder, internvl2-1b's
# prefill (G = 7, which does not divide the kernel's 64 rows), and a
# whisper-medium encoder rank of 4 under the long-context split (its 375
# frames against all 1500, non-causal)
FLASH_CASES = [(2, 64, 4, 2, 32, True, 0, 64), (2, 96, 2, 1, 16, True, 16, 96),
               (2, 128, 8, 8, 8, False, 0, 128), (1, 50, 4, 2, 16, True, 0, 50),
               (2, 48, 6, 1, 16, True, 8, 48), (1, 40, 4, 2, 32, False, 0, 77),
               (1, 300, 32, 8, 64, True, 0, 300), (2, 257, 32, 32, 80, True, 0, 257),
               (1, 333, 32, 4, 128, True, 100, 333), (1, 200, 32, 1, 64, False, 37, 200),
               (1, 2048, 32, 8, 64, True, 0, 2048), (1, 2048, 32, 8, 64, True, 512, 2048),
               (4, 2048, 25, 5, 64, True, 2048, 2048), (4, 2048, 16, 16, 128, True, 0, 2048),
               (4, 1500, 16, 16, 64, False, 0, 1500), (4, 384, 16, 16, 64, False, 0, 1500),
               (4, 384, 16, 16, 64, True, 0, 384), (4, 2048, 14, 2, 64, True, 0, 2048),
               (1, 375, 16, 16, 64, False, 0, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, sq, hq, hkv, hd, causal, window, skv = case
    g = torch.Generator(device=card).manual_seed(sq * hq + hd)
    q = torch.randn((b, sq, hq, hd), device=card, generator=g).to(dtype)
    k = torch.randn((b, skv, hkv, hd), device=card, generator=g).to(dtype)
    v = torch.randn((b, skv, hkv, hd), device=card, generator=g).to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    # float32: the sums run in another order; bf16: both round a float32
    # result once, so they are one bf16 ulp (2^-7 relative) apart at most
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert bool(((got.float() - want.float()).abs() <= rtol * want.float().abs() + 1e-6).all())
    assert ops.launch_counts()["flash_attention"] == 1


# (B, Sq, Hq, Hkv, hd, causal, window, Skv, q_offset): queries at key
# indices q_offset + i after a halo of earlier keys, the sequence-sharded
# prefill's launch -- offsets on and off the 64-key tiles, a window shorter
# and longer than a tile, h2o-danube-1.8b's hd 80 and G = 4, non-causal
FLASH_OFFSET_CASES = [(2, 70, 4, 1, 16, True, 8, 77, 7), (1, 130, 32, 8, 80, True, 64, 193, 63),
                      (1, 64, 4, 4, 64, True, 0, 128, 64), (1, 200, 4, 2, 32, False, 0, 250, 50),
                      (1, 300, 32, 8, 80, True, 100, 399, 99), (2, 33, 8, 2, 64, True, 0, 500, 467)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_OFFSET_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_kernel_with_q_offset_matches_plain(card, case, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, sq, hq, hkv, hd, causal, window, skv, off = case
    g = torch.Generator(device=card).manual_seed(sq * hq + hd + off)
    q = torch.randn((b, sq, hq, hd), device=card, generator=g).to(dtype)
    k = torch.randn((b, skv, hkv, hd), device=card, generator=g).to(dtype)
    v = torch.randn((b, skv, hkv, hd), device=card, generator=g).to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert bool(((got.float() - want.float()).abs() <= rtol * want.float().abs() + 1e-6).all())
    assert ops.launch_counts()["flash_attention"] == 1


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(card):
    from repro_torch.kernels import flash_attention as fa

    def qkv(hd=16, dtype=torch.bfloat16, hq=4, hkv=2):
        return (torch.zeros((1, 8, hq, hd), dtype=dtype, device=card),
                torch.zeros((1, 8, hkv, hd), dtype=dtype, device=card),
                torch.zeros((1, 8, hkv, hd), dtype=dtype, device=card))

    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(*qkv(dtype=torch.float16))
    for dtype, other in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        for hd in (12, 136):
            with pytest.raises(ValueError, match="head_dim"):
                fa.flash_attention(*qkv(hd=hd, dtype=dtype))
        q, k, v = qkv(dtype=dtype)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fa.flash_attention(q, k.to(other), v)
        with pytest.raises(ValueError, match="not contiguous"):
            fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
        with pytest.raises(ValueError, match="kv heads"):
            fa.flash_attention(*qkv(hq=6, hkv=4, dtype=dtype))
        with pytest.raises(ValueError, match="on cpu"):
            fa.flash_attention(q, k.cpu(), v)
    assert ops.launch_counts()["flash_attention"] == 0


def test_flash_attention_wrapper_raises_when_a_launch_fails(card, monkeypatch):
    from repro_torch.kernels import _build, flash_attention as fa

    asked = []
    monkeypatch.setattr(_build, "function",
                        lambda lib, name, argtypes: asked.append(name) or (lambda *args: 1))
    monkeypatch.setattr(fa, "flash_attention_plain", None)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 4, 16), dtype=dtype, device=card)
        with pytest.raises(RuntimeError, match="launch failed"):
            fa.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    assert asked == ["szx_flash_attention_fwd_f32", "szx_flash_attention_fwd_bf16"]
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("mode,planes", [("dense", 1), ("compressed", 2)])
def test_serving_launches_the_kernels(card, mode, planes):
    """Prefill launches the flash kernel once per layer; a compressed decode
    step encodes K and V once per layer and decodes each chunk of both.  The
    logits agree with the plain route on the CPU (same weights)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = configs.get("llama3.2-1b").reduced()
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = T.Transformer(cfg, device=card)
    model.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    cache, logits = E.prefill(model, cfg, toks.to(card), seq_len=44, kv_mode=mode,
                              num_planes=planes)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["planes_encode"] == (2 if mode == "compressed" else 0)
    ops.reset_launch_counts()
    logits, cache = E.decode_step(model, cfg, cache, toks[:, -1:].to(card), kv_mode=mode,
                                  num_planes=planes)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0
    if mode == "compressed":
        assert counts["planes_encode"] == counts["planes_decode"] == 2 * cfg.n_layers
    c_cache, _ = E.prefill(cpu, cfg, toks, seq_len=44, kv_mode=mode, num_planes=planes)
    want, _ = E.decode_step(cpu, cfg, c_cache, toks[:, -1:], kv_mode=mode, num_planes=planes)
    assert (logits.cpu() - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b",
                                  "whisper-medium", "internvl2-1b"])
def test_families_serve_on_the_card(card, name):
    """The MoE, SSM, hybrid, audio and VLM families (reduced): prefill
    launches the flash kernel once per attention layer (whisper: its
    encoder's, and each decoder layer's self- and cross-attention), a
    compressed decode step the planes kernels; the logits of the prefill
    and of two decode steps agree with the plain route on the CPU (same
    weights, frames and image embeddings), and so do the SSM state slabs
    and the cross cache."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = configs.get(name).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    mode = "compressed" if T.has_attention(cfg) else "dense"
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = T.Transformer(cfg, device=card)
    model.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 42), generator=g)
    extra = {}
    if cfg.encoder_decoder:
        extra["frames"] = torch.randn((2, cfg.encoder_len, cfg.d_model), generator=g)
    if cfg.prefix_embeds:
        extra["image_embeds"] = torch.randn((2, cfg.prefix_embeds, cfg.d_model), generator=g)
    runs = []
    for m, dev in ((model, card), (cpu, torch.device("cpu"))):
        ops.reset_launch_counts()
        cache, logits = E.prefill(m, cfg, toks[:, :40].to(dev), seq_len=44 + cfg.prefix_embeds,
                                  kv_mode=mode, num_planes=2,
                                  **{k: v.to(dev) for k, v in extra.items()})
        out = [logits, ops.launch_counts()["flash_attention"]]
        for i in range(2):
            logits, cache = E.decode_step(m, cfg, cache, toks[:, 40 + i:41 + i].to(dev),
                                          kv_mode=mode, num_planes=2)
            out.append(logits)
        out += [ops.launch_counts(), cache]
        runs.append(out)
    (p0, flash, d1, d2, counts, cache), (c0, _, e1, e2, _, c_cache) = runs
    per_prefill = cfg.n_layers * (2 if cfg.encoder_decoder else 1) + cfg.n_encoder_layers
    assert flash == (per_prefill if T.has_attention(cfg) else 0)
    assert counts["planes_encode"] == (2 * cfg.n_layers * 2 + 2 if mode == "compressed" else 0)
    for got, want in ((p0, c0), (d1, e1), (d2, e2)):
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    if "state" in cache["layers"]:
        want = c_cache["layers"]["state"]
        assert (cache["layers"]["state"].cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    for nm in ("k", "v") if cfg.encoder_decoder else ():
        want = c_cache["cross"][nm]
        assert (cache["cross"][nm].cpu() - want).abs().max() <= 1e-4 * want.abs().max()


# ---------------------------------------------------------------------------
# the two-call encode (block_stats + pack) and the training slice
# ---------------------------------------------------------------------------

STATS = ("mu", "radius", "const", "reqlen", "shift", "nbytes")


def _same_stats(a, b, where):
    for name, x, y in zip(STATS, a, b):
        if name == "radius":          # NaN bits are the card's; compare positions
            assert torch.equal(torch.isnan(x), torch.isnan(y)), f"{where}: radius NaN"
            keep = ~torch.isnan(x)
            x, y = x[keep], y[keep]
        assert _same(x, y), f"{where}: {name}"


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_two_call_kernels_match_plain_and_fused(card, spec):
    """block_stats and pack against their plain versions (bs 1, 3, 128,
    4096; NaN/inf, zeros of both signs, verbatim and constant blocks), the
    two calls against the fused encode kernel, pack with shift = 0."""
    from repro_torch.kernels import block_stats as bsk, pack as pk

    zeros = torch.zeros(8 * 128, dtype=spec.dtype)
    zeros[5::7] = -0.0
    zeros[-128:] = -0.0
    cases = [(_with_nonfinite(_walk(nb * bs, spec.dtype, seed=nb, dev=card)).reshape(nb, bs), e)
             for nb, bs in ((4096, 128), (257, 1), (301, 3), (5, 4096))
             for e in (1e-3, float(torch.finfo(spec.dtype).tiny))]
    cases += [(torch.full((9, 128), 2.5, dtype=spec.dtype, device=card), 1e-3),
              (zeros.reshape(8, 128).to(card), 1e-3),
              (torch.zeros((0, 128), dtype=spec.dtype, device=card), 1e-3)]
    for x, e in cases:
        where = f"{spec.name} {tuple(x.shape)} e={e}"
        p_e = specs.exact_exponent_of(e)
        k = ops.block_stats(x, e, spec=spec)
        _same_stats(k, bsk.block_stats_plain(x, e, spec, p_e), where)
        mu, _r, const, reqlen, shift, nbytes = k
        planes, L, mid = ops.pack(x, mu, shift, nbytes, spec=spec)
        for name, a, b in zip(("planes", "L", "mid"), (planes, L, mid),
                              pk.pack_plain(x, mu, shift, nbytes, spec)):
            assert _same(a, b), f"{where}: pack {name}"
        fused = encode.encode(x, e, p_e, spec=spec)
        for name, a, b in zip(NAMES, fused, (mu, const, reqlen, shift, nbytes, planes,
                                             L.to(torch.uint8))):
            assert _same(a, b), f"{where}: fused {name}"
        zero = torch.zeros_like(shift)
        for name, a, b in zip(("planes", "L", "mid"), ops.pack(x, mu, zero, nbytes, spec=spec),
                              pk.pack_plain(x, mu, zero, nbytes, spec)):
            assert _same(a, b), f"{where}: pack shift=0 {name}"
    counts = ops.launch_counts()
    launched = sum(1 for x, _ in cases if x.shape[0])
    assert counts["block_stats"] == launched and counts["pack"] == 2 * launched


def test_two_call_wrappers_raise_when_a_launch_fails(card, monkeypatch):
    from repro_torch.kernels import _build, block_stats as bsk, pack as pk

    monkeypatch.setattr(_build, "function", lambda *a, **k: (lambda *args: 1))
    monkeypatch.setattr(bsk, "block_stats_plain", None)
    monkeypatch.setattr(pk, "pack_plain", None)
    x = torch.zeros((4, 8), device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.block_stats(x, 1e-3)
    z = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.pack(x, torch.zeros(4, device=card), z, z)
    with pytest.raises(ValueError):
        pk.pack(x, torch.zeros(3, device=card), z, z)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_autograd_on_card_matches_cpu(card, dtype):
    """The forward kernel under autograd and the recomputing backward on the
    card against the same on the CPU (the plain forward)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 300, 8, 64), generator=g)
    k, v = (torch.randn((2, 300, 2, 64), generator=g) for _ in range(2))
    do = torch.randn((2, 300, 8, 64), generator=g)
    outs = {}
    for dev in ("cpu", card):
        ts = [t.to(dev, dtype).detach().requires_grad_() for t in (q, k, v)]
        out = fa.FlashAttention.apply(*ts, True, 64)
        out.backward(do.to(dev, dtype))
        outs[str(dev)] = [out.detach().float().cpu()] + [t.grad.float().cpu() for t in ts]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(outs["cpu"], outs[str(card)]):
        assert (a - b).abs().max() <= tol * a.abs().max()
    assert ops.launch_counts()["flash_attention"] == 1


def test_compressed_train_step_and_checkpoint_round_trip(card, tmp_path):
    """One compressed (P = 1) step of the reduced llama3.2-1b in a one-rank
    NCCL group, then an SZx checkpoint of the state saved and restored on the
    card: the kernels launch, the loss equals the CPU's, and every restored
    leaf is within the bound (integer leaves exact)."""
    import socket

    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.core.codec import Bound
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.train import step as step_mod

    cfg = configs.get("llama3.2-1b").reduced()
    opt = AdamW(lr=1e-3)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4)).batch_at(0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        losses = {}
        for dev, group in (("cpu", dist.new_group([0], backend="gloo")), (card, None)):
            state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0),
                                        ef_planes=1, device="cpu")
            state = pytree.tree_map(lambda t: t.to(dev), state)
            fn = step_mod.make_train_step(cfg, opt, group=group, compress_planes=1)
            ops.reset_launch_counts()
            state, m = fn(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            losses[str(dev)] = float(m["loss"])
        counts = ops.launch_counts()
        assert counts["flash_attention"] == cfg.n_layers          # reduced: no remat
        assert counts["planes_encode"] > 0 and counts["planes_decode"] > 0
        assert abs(losses["cpu"] - losses[str(card)]) <= 1e-4 * abs(losses["cpu"])
        bound = Bound.rel(1e-4)
        ckpt = CheckpointManager(str(tmp_path), compress=True, bound=bound, device=card)
        ops.reset_launch_counts()
        ckpt.save(1, state)
        back, step = ckpt.restore(state)
        counts = ops.launch_counts()
        assert step == 1 and counts["encode"] > 0 and counts["decode_body"] > 0
        for (name, a), b in zip(pytree.leaf_paths(state), pytree.leaves(back)):
            assert b.device == a.device and b.dtype == a.dtype and b.shape == a.shape, name
            if not a.is_floating_point() or a.numel() < 1024:
                assert torch.equal(a, b), name
            else:
                af = a.double()
                e = 1e-4 * float(af.max() - af.min())
                assert float((af - b.double()).abs().max()) <= e, name
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-1b"])
def test_encdec_vlm_gradients_on_card_match_cpu(card, name):
    """loss_fn and every gradient of the reduced whisper-medium (the
    encoder, the cross-attention's non-causal kernel launches and backward)
    and internvl2-1b (the image prefix) on the card against the CPU route,
    on the launcher's synthetic batch with its frames or image embeddings."""
    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.train import step as step_mod

    cfg = configs.get(name).reduced()
    batch = SyntheticLM(train.data_config(cfg, 40, 2)).batch_at(0)
    out = {}
    for dev in ("cpu", card):
        params = T.param_tree(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        params = pytree.tree_map(lambda t: t.to(dev), params)
        ops.reset_launch_counts()
        out[str(dev)] = step_mod.value_and_grad(
            cfg, params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    per_forward = cfg.n_layers * (2 if cfg.encoder_decoder else 1) + cfg.n_encoder_layers
    assert ops.launch_counts()["flash_attention"] == per_forward          # reduced: no remat
    (loss, grads), (kloss, kgrads) = out["cpu"], out[str(card)]
    assert abs(float(loss) - float(kloss)) <= 1e-5 * abs(float(loss))
    for (leaf, a), b in zip(pytree.leaf_paths(grads), pytree.leaves(kgrads)):
        assert b.device.type == "cuda", leaf
        assert (b.cpu() - a).abs().max() <= 1e-4 * a.abs().max(), leaf


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("name", ["hymba-1.5b", "deepseek-moe-16b"])
def test_families_gradients_on_card_match_cpu(card, name, remat):
    """loss_fn and every gradient of the reduced hymba-1.5b (the flash
    kernel at G = 4 under its window of 32 over 40 positions, beside the
    SSD chunk loop) and deepseek-moe-16b (the expert dispatch, whose
    index_add_ sums with atomics on the card) in float32 on the card, against
    the CPU route: the loss within 1e-5 relative, each gradient within 1e-4
    of the leaf's largest, the routes the same; the flash kernel once an
    attention layer a forward, twice with remat."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import pytree
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import step as step_mod

    cfg = dataclasses.replace(configs.get(name).reduced(), remat=remat)
    batch = SyntheticLM(train.data_config(cfg, 40, 2)).batch_at(0)
    out, routes, route = {}, {}, L.moe_route
    for dev in ("cpu", card):
        params = T.param_tree(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        params = pytree.tree_map(lambda t: t.to(dev), params)
        seen = routes[str(dev)] = []

        def recorded(x, router, c, seen=seen):
            res = route(x, router, c)
            seen.append(res[1].cpu())
            return res

        ops.reset_launch_counts()
        L.moe_route = recorded
        try:
            out[str(dev)] = step_mod.value_and_grad(
                cfg, params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        finally:
            L.moe_route = route
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers * (2 if remat else 1)
    assert len(routes["cpu"]) == len(routes[str(card)]) == (cfg.n_layers * (1 + remat)
                                                            if cfg.n_experts else 0)
    assert all(torch.equal(a, b) for a, b in zip(routes["cpu"], routes[str(card)]))
    (loss, grads), (kloss, kgrads) = out["cpu"], out[str(card)]
    assert abs(float(loss) - float(kloss)) <= 1e-5 * abs(float(loss))
    for (leaf, a), b in zip(pytree.leaf_paths(grads), pytree.leaves(kgrads)):
        assert b.device.type == "cuda", leaf
        assert (b.cpu() - a).abs().max() <= 1e-4 * a.abs().max(), leaf


SHARDED_WORKER = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamW
from repro_torch.train import step as S

rank, n, backend, store, dest = sys.argv[1:6]
rank, n = int(rank), int(n)
dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
if backend == "nccl":
    torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True)
dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
                        timeout=timedelta(seconds=120))
cfg = configs.get("llama3.2-1b").reduced()
opt = AdamW(lr=1e-3, weight_decay=0.0)
ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2 * n, seed=3))
batches = [{k: torch.as_tensor(v).to(dev) for k, v in ds.batch_at(i).items()} for i in range(3)]
out = {}
state = S.init_state(cfg, opt, torch.Generator(device=dev).manual_seed(7), device=dev)
fn = S.make_train_step(cfg, opt)
for i, b in enumerate(batches):
    state, m = fn(state, b)
    out[f"plain/loss{i}"] = m["loss"]
out["plain/params"] = torch.cat([p.reshape(-1) for p in pytree.leaves(state["params"])])
for shape in ((1, n), (n, 1)):
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
    state = S.init_sharded_state(cfg, opt, torch.Generator(device=dev).manual_seed(7), mesh,
                                 device=dev)
    fn = S.make_train_step(cfg, opt, mesh=mesh)
    tag = "x".join(map(str, shape))
    for i, b in enumerate(batches):
        state, m = fn(state, b)
        out[f"{tag}/loss{i}"] = m["loss"]
    out[f"{tag}/params"] = torch.cat([p.full_tensor().reshape(-1)
                                      for p in pytree.leaves(state["params"])])
np.savez(dest, **{k: v.detach().cpu().numpy() for k, v in out.items()})
dist.destroy_process_group()
print("WORKER-OK")
"""


def test_sharded_step_across_cards_matches_gloo(card, tmp_path):
    """With two or more cards: the sharded step on NCCL, one rank per card
    (deterministic algorithms on), keeps what the same code keeps on gloo
    on the CPU (tests/test_torch_sharded_step.py): on a 'model'-only mesh a
    rank computes tensor-parallel (its own heads, MLP columns and
    vocabulary columns, the row-parallel partial sums all-reduced in
    another order), within that file's TP_PARAM_ATOL of the plain step on
    the same card, and over 'data' it stays within its PARAM_ATOL.  The card's and the CPU's
    arithmetic differ in their last bits, so the gloo ranks' parameters are
    held to the card's as tests/test_torch_families_train.py holds the
    port's to the reference's (max 1e-3, 99 % within 1e-5)."""
    import os
    import subprocess
    import sys

    import numpy as np

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    env = dict(os.environ, PYTHONPATH=str(__import__("pathlib").Path(__file__).parents[1] / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_WORKER, str(r), str(n), backend,
         str(tmp_path / f"store-{backend}"), str(tmp_path / f"{backend}{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for backend in ("nccl", "gloo") for r in range(n)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log in logs:
        assert "WORKER-OK" in log, log[-3000:]
    atol = 1.1e-5                    # tests/test_torch_sharded_step.py's PARAM_ATOL
    tp_atol = 7e-5                   # and its TP_PARAM_ATOL, TP_LOSS_RTOL
    for r in range(n):
        for backend in ("nccl", "gloo"):
            got = np.load(tmp_path / f"{backend}{r}.npz")
            tag = f"1x{n}"
            np.testing.assert_allclose(got[f"{tag}/params"], got["plain/params"], rtol=0,
                                       atol=tp_atol)
            for i in range(3):
                np.testing.assert_allclose(got[f"{tag}/loss{i}"], got[f"plain/loss{i}"],
                                           rtol=3e-7, atol=0)
            np.testing.assert_allclose(got[f"{n}x1/params"], got["plain/params"], rtol=0, atol=atol)
        nccl, gloo = np.load(tmp_path / f"nccl{r}.npz"), np.load(tmp_path / f"gloo{r}.npz")
        d = np.abs(nccl[f"{n}x1/params"] - gloo[f"{n}x1/params"])
        assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())
