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


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_decode_kernel_matches_plain(card, spec):
    for n, bs in ((100_003, 128), (3000, 1), (20_037, 100), (4096 * 9, 4096)):
        buf = SZxCodec(bs, "cpu").compress(_with_nonfinite(_walk(n, spec.dtype, seed=n)), 1e-3)
        nb = -(-n // bs)
        nnc = container.HEADER.unpack_from(buf, 0)[7]
        body = torch.frombuffer(bytearray(buf[container.HEADER.size:]), dtype=torch.uint8)
        meta = ref.parse_body_ref(body.to(card), nnc, spec, nb)[1:5]
        for lo, rb in ((0, nb), (nb // 2, nb - nb // 2), (nb - 1, 1)):
            kv, kt = decode.decode_body(body.to(card), nnc, lo, *meta, spec=spec, bs=bs, rb=rb)
            pv, pt = decode.decode_body_plain(body.to(card), nnc, lo, *meta, spec, bs=bs, rb=rb)
            assert _same(kv, pv) and int(kt) == int(pt), (spec.name, n, bs, lo, rb)


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


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_bitshuffle_kernel_matches_plain(card, spec):
    from repro_torch.kernels import bitshuffle

    g = torch.Generator().manual_seed(spec.code)
    T = specs.tile_bytes(spec)
    for nt in (0, 1, 3, 257):
        tiles = torch.randint(0, 256, (nt, T), dtype=torch.uint8, generator=g).to(card)
        fwd = bitshuffle.bitshuffle(tiles, spec=spec)
        assert torch.equal(fwd, bitshuffle.bitshuffle_plain(tiles, False)), (spec.name, nt)
        inv = bitshuffle.bitshuffle(tiles, spec=spec, inverse=True)
        assert torch.equal(inv, bitshuffle.bitshuffle_plain(tiles, True)), (spec.name, nt)
        assert torch.equal(bitshuffle.bitshuffle(fwd, spec=spec, inverse=True), tiles)
    with pytest.raises(ValueError, match="tile width"):
        bitshuffle.bitshuffle(torch.zeros((1, T + 8), dtype=torch.uint8, device=card), spec=spec)
    counts = ops.launch_counts()
    assert counts["bitshuffle"] == 3 and counts["bitshuffle_inverse"] == 6


@pytest.mark.parametrize("spec", specs.SPECS, ids=lambda s: s.name)
def test_unpack_kernels_match_plain(card, spec):
    from repro_torch.kernels import unpack

    for nb, bs in ((4096, 128), (257, 1), (97, 100), (5, 4096)):
        x = _with_nonfinite(_walk(nb * bs, spec.dtype, seed=nb, dev=card)).reshape(nb, bs)
        x[1::3] = 0.0
        x[1::3, ::2] = -0.0                               # blocks of mixed-sign zeros
        for e in (1e-3, float(torch.finfo(spec.dtype).tiny)):
            mu, _c, _r, shift, nbytes, planes, L = encode.encode(
                x, e, specs.exact_exponent_of(e), spec=spec)
            k = unpack.unpack(planes, mu, shift, nbytes, L, spec=spec)
            assert _same(k, unpack.unpack_plain(planes, mu, shift, nbytes, L, spec))
            kd = unpack.unpack_dense(planes, mu, shift, nbytes, spec=spec)
            assert _same(kd, unpack.unpack_dense_plain(planes, mu, shift, nbytes, spec))
            if not bool(L.any()):
                assert _same(k, kd)
    counts = ops.launch_counts()
    assert counts["unpack"] == 8 and counts["unpack_dense"] == 8


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


def test_wrappers_raise_when_a_launch_fails(card, monkeypatch):
    """No fallback: a CUDA tensor whose launch fails raises, and the plain
    version is not run in its place."""
    from repro_torch.kernels import _build, bitshuffle, unpack

    monkeypatch.setattr(_build, "function", lambda *a, **k: (lambda *args: 1))
    monkeypatch.setattr(bitshuffle, "bitshuffle_plain", None)
    monkeypatch.setattr(unpack, "unpack_plain", None)
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
