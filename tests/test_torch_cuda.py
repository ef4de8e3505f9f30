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
