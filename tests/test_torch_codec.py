"""repro_torch byte-stream codec against the JAX package's (byte-identical).

Runs the port on the CPU (``device="cpu"``: the kernels' plain versions) and
holds it to ``repro`` with ``backend="numpy"``: the f32 golden digests of
tests/test_codec.py, streams and reconstructions for all four dtypes in both
directions (monolithic and chunked), chunk payloads, the v3 index footer and
its corrupt-footer fallback, block-range decode, the reference's corrupt-
stream messages, the CLI, and the one-copy-per-frame transfer contract.
"""
import hashlib
import io
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import szx as rszx
from repro.core.codec import SZxCodec as RCodec, container as rcontainer, plan as rplan
from repro.core.codec import transform as rtransform
from repro.core.codec.__main__ import main as rmain
from repro_torch import api
from repro_torch.core.codec import SZxCodec, container, device, plan, transform
from repro_torch.core.codec.__main__ import main as tmain
from repro_torch.kernels import ops as tops

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
CPU = SZxCodec(device="cpu")
REF = RCodec(backend="numpy")
GOLDEN_SHA256 = {   # tests/test_codec.py:42-48
    "sin_bs128_abs1e-3": "5a742780e9a5b13da14544a98e9c137e0d2ed0af99d54932497037e79fd2ec5e",
    "walk_bs64_rel1e-3": "8268a4b101cb0f0008d5e1f0279de3021c5ed93d5de50f92ad1dd0c61f9bb1c9",
    "const_bs128": "b1e68c21ff4f2c1a2e782f54a8c46a151610398ac78ae536d3460f0e8a0879fd",
    "spiky_bs32_abs1e-5": "f47e60993b1aa622798eb1d605d066665e6aac9c32ec672d3fe817b601f6bcfd",
}


def _walk(n, seed=0, dtype=np.float32, scale=0.01):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


# ---------------------------------------------------------------------------
# golden bytes and cross-decode
# ---------------------------------------------------------------------------

def _golden_cases():
    """The cases of tests/test_codec.py, built the same way (float32)."""
    t = np.linspace(0, 4 * np.pi, 10000).astype(np.float32)
    rng = np.random.default_rng(42)
    walk = np.cumsum(rng.standard_normal(7777)).astype(np.float32)
    spiky = rng.standard_normal(3001).astype(np.float32)
    spiky[::97] *= 1e4
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731  (what szx.compress does)
    yield "sin_bs128_abs1e-3", CPU.compress(f32(np.sin(t) * np.exp(-t / 20)), 1e-3)
    yield "walk_bs64_rel1e-3", SZxCodec(64, "cpu").compress(f32(walk), plan.Bound.rel(1e-3))
    yield "const_bs128", CPU.compress(np.full(1000, 7.5, np.float32), 1e-3)
    yield "spiky_bs32_abs1e-5", SZxCodec(32, "cpu").compress(f32(spiky), 1e-5)


@pytest.mark.parametrize("name", list(GOLDEN_SHA256))
def test_golden_digests(name):
    buf = dict(_golden_cases())[name]
    assert hashlib.sha256(buf).hexdigest() == GOLDEN_SHA256[name]


def test_matches_legacy_shim_bytes():
    x = _walk(12345, seed=3)
    assert CPU.compress(x, 1e-3) == rszx.compress(x, 1e-3, backend="numpy")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_cross_decode_monolithic(dtype):
    for n, bs, e in ((9999, 128, 1e-3), (257, 32, 1e-2), (1000, 100, 1.0)):
        x = _walk(n, seed=n, dtype=dtype)
        ref_buf = RCodec(block_size=bs, backend="numpy").compress(x, e)
        buf = SZxCodec(bs, "cpu").compress(x, e)
        assert buf == ref_buf, (dtype.name, n, bs)
        ref_y = RCodec(block_size=bs, backend="numpy").decompress(buf)   # port -> repro
        y = SZxCodec(bs, "cpu").decompress(ref_buf)                      # repro -> port
        assert y.dtype == plan.spec_for(dtype).dtype and y.device.type == "cpu"
        np.testing.assert_array_equal(_bits(y), _bits(ref_y))
        err = np.abs(_bits(y).view(dtype).astype(np.float64) - x.astype(np.float64)).max()
        assert err <= e


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_cross_decode_chunked(dtype):
    x = _walk(50_001, seed=5, dtype=dtype)
    chunk = 1 << 14
    ref_frames = list(REF.compress_chunked(x, rplan.Bound.rel(1e-3), chunk_bytes=chunk))
    frames = list(CPU.compress_chunked(x, plan.Bound.rel(1e-3), chunk_bytes=chunk))
    assert frames == ref_frames and len(frames) > 2
    np.testing.assert_array_equal(_bits(CPU.decompress_chunked(b"".join(ref_frames))),
                                  _bits(REF.decompress_chunked(frames)))
    np.testing.assert_array_equal(
        _bits(CPU.decompress_chunked(ref_frames, n=x.size)),
        _bits(REF.decompress_chunked(frames, n=x.size)))


NAN_BITS = {   # quiet and signalling NaNs of both signs, payloads kept
    "float32": [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800123, 0x7FFFFFFF],
    "float64": [0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001],
    "float16": [0x7E00, 0xFE00, 0x7C01, 0xFC33, 0x7FFF],
    "bfloat16": [0x7FC0, 0xFFC0, 0x7F81, 0xFF93, 0x7FFF],
}


@pytest.mark.filterwarnings("ignore:invalid value:RuntimeWarning")
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_nonfinite_inputs_match_reference(dtype):
    """NaN/inf blocks go verbatim; the stored and decoded NaN bits are the
    ones numpy (ml_dtypes for bf16) produces, for every block size."""
    x = _walk(3000, seed=12, dtype=np.float64)
    x[300], x[700], x[800:805], x[1000:1100] = np.inf, -np.inf, np.inf, np.nan
    x = x.astype(dtype)
    words = x.view(f"<u{dtype.itemsize}")
    for i, b in enumerate(NAN_BITS[dtype.name]):
        words[5 + 7 * i] = b
    for bs in (1, 32, 128):
        ref_buf = RCodec(block_size=bs, backend="numpy").compress(x, 1e-3)
        assert SZxCodec(bs, "cpu").compress(x, 1e-3) == ref_buf
        np.testing.assert_array_equal(
            _bits(SZxCodec(bs, "cpu").decompress(ref_buf)),
            _bits(RCodec(block_size=bs, backend="numpy").decompress(ref_buf)))


def test_tensor_inputs_and_functional_api():
    x = _walk(4097, seed=9)
    buf = REF.compress(x, 1e-3)
    assert CPU.compress(torch.from_numpy(x), 1e-3) == buf
    assert api.compress(x, 1e-3, device="cpu") == buf
    np.testing.assert_array_equal(_bits(api.decompress(buf, device="cpu")),
                                  _bits(REF.decompress(buf)))
    b2, stats = api.compress_with_stats(x, 1e-3, device="cpu")
    r2, rstats = REF.compress_with_stats(x, 1e-3)
    assert b2 == r2 and stats.__dict__ == rstats.__dict__


# ---------------------------------------------------------------------------
# chunked frames, the v3 footer, block ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_chunk_payloads_match_monolithic(workers):
    x = _walk(100_003, seed=1)
    codec = SZxCodec(device="cpu", workers=workers)
    chunk = 1 << 16
    frames = list(codec.compress_chunked(x, 1e-3, chunk_bytes=chunk))
    per = plan.chunk_elements(128, chunk, 4)
    for i, payload in enumerate(container.iter_frames(frames)):
        assert payload == CPU.compress(x[i * per:(i + 1) * per], 1e-3), i
    assert frames == list(CPU.compress_chunked(x, 1e-3, chunk_bytes=chunk))
    y = codec.decompress_chunked(frames, n=x.size)
    np.testing.assert_array_equal(_bits(y), _bits(CPU.decompress_chunked(frames)))


@pytest.mark.parametrize("n", [0, 1, 127])
def test_empty_and_subblock_inputs(n):
    x = _walk(n, seed=4)
    assert CPU.compress(x, 1e-3) == REF.compress(x, 1e-3)
    frames = list(CPU.compress_chunked(x, 1e-3))
    assert frames == list(REF.compress_chunked(x, 1e-3))
    y = CPU.decompress_chunked(frames)
    assert y.numel() == n
    np.testing.assert_array_equal(_bits(y), _bits(REF.decompress_chunked(frames)))
    assert CPU.decompress(CPU.compress(x, 1e-3)).numel() == n


def test_dump_load_footer_and_select():
    x = _walk(200_000, seed=4)
    kw = dict(chunk_bytes=1 << 18)
    f, rf = io.BytesIO(), io.BytesIO()
    written = CPU.dump_chunked(x, f, 1e-4, **kw)
    REF.dump_chunked(x, rf, 1e-4, **kw)
    assert f.getvalue() == rf.getvalue() and written == len(f.getvalue())
    full = CPU.load_chunked(io.BytesIO(f.getvalue()), n=x.size)
    np.testing.assert_array_equal(_bits(full), _bits(REF.load_chunked(io.BytesIO(f.getvalue()))))
    per = plan.chunk_elements(128, 1 << 18, 4)
    got = CPU.load_chunked(io.BytesIO(f.getvalue()), select=[0, 2])
    np.testing.assert_array_equal(_bits(got), np.concatenate(
        [_bits(full)[:per], _bits(full)[2 * per:3 * per]]))
    for bad in ([2, 1], [1, 1], [-1], [], [99], [True]):
        with pytest.raises(ValueError):
            CPU.load_chunked(io.BytesIO(f.getvalue()), select=bad)
    v2 = io.BytesIO()
    CPU.dump_chunked(x, v2, 1e-4, index=False, **kw)
    with pytest.raises(ValueError, match="index footer"):
        CPU.load_chunked(io.BytesIO(v2.getvalue()), select=[0])


def test_corrupt_footer_falls_back_to_sequential_decode():
    x = _walk(100_000, seed=6)
    f = io.BytesIO()
    CPU.dump_chunked(x, f, 1e-3, chunk_bytes=1 << 17)
    raw = bytearray(f.getvalue())
    raw[-30] ^= 0xFF                              # flip a byte of the JSON index
    assert container.read_index_footer_safe(io.BytesIO(f.getvalue()))["kind"] == "szx-chunked"
    with pytest.warns(RuntimeWarning, match="corrupt container-v3 index footer"):
        got = CPU.load_chunked(io.BytesIO(bytes(raw)), select=[1])
    with pytest.warns(RuntimeWarning):
        want = REF.load_chunked(io.BytesIO(bytes(raw)), select=[1])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="CRC mismatch"):
        container.read_index_footer(io.BytesIO(bytes(raw)))


def test_decompress_range_is_a_slice_of_decompress():
    x = _walk(9999, seed=7)
    buf = REF.compress(x, 1e-3)
    full = _bits(CPU.decompress(buf))
    for lo, hi in ((0, 1), (0, 3), (3, 11), (70, 79), (0, 79)):
        part = CPU.decompress_range(buf, lo, hi)
        np.testing.assert_array_equal(_bits(part), full[lo * 128: min(hi * 128, x.size)])
        np.testing.assert_array_equal(_bits(part), _bits(REF.decompress_range(buf, lo, hi)))
    for lo, hi in ((5, 200), (5, 5), (-1, 3)):
        with pytest.raises(ValueError, match=r"block range \[.*\) out of \[0, 79\)"):
            CPU.decompress_range(buf, lo, hi)


def test_decompress_out_param():
    for n in (9999, 1024):
        buf = REF.compress(_walk(n, seed=n), 1e-3)
        out = torch.empty(n, dtype=torch.float32)
        assert CPU.decompress(buf, out=out) is out
        np.testing.assert_array_equal(_bits(out), _bits(REF.decompress(buf)))


def test_chunked_length_checks():
    x = _walk(200_000, seed=11)
    frames = b"".join(REF.compress_chunked(x, 1e-3, chunk_bytes=1 << 18))
    with pytest.raises(ValueError, match="longer than expected"):
        CPU.decompress_chunked(frames, n=x.size - 1000)
    with pytest.raises(ValueError, match="expected"):
        CPU.decompress_chunked(frames, n=x.size + 1000)
    with pytest.raises(ValueError, match="empty SZx frame sequence"):
        CPU.decompress_chunked([])


# ---------------------------------------------------------------------------
# corrupt and truncated streams: the reference's messages, verbatim
# ---------------------------------------------------------------------------

def _corrupt(kind: str) -> bytes:
    buf = bytearray(REF.compress(_walk(5000, seed=9), 1e-3))
    hdr = rcontainer.HEADER
    fields = list(hdr.unpack_from(buf, 0))
    nb, nnc = fields[6], fields[7]
    if kind == "short":
        return bytes(buf[:10])
    if kind == "magic":
        buf[0] = 0
    elif kind == "version":
        buf[4] = 99
    elif kind == "dtype":
        buf[5] = 9
    elif kind == "truncated":
        return bytes(buf[:-5])
    elif kind == "prefix":
        return bytes(buf[:hdr.size + 3])
    elif kind == "nnc>nb":
        fields[7] = nb + 1
        hdr.pack_into(buf, 0, *fields)
    elif kind == "block count":
        fields[6] = nb + 1
        hdr.pack_into(buf, 0, *fields)
    elif kind == "nmid":
        fields[8] += 1
        hdr.pack_into(buf, 0, *fields)
        buf += b"\0"                    # long enough: the L-implied total differs
    elif kind == "bitmap":
        buf[hdr.size] ^= 0x80           # block 0 flips const <-> non-const
    elif kind == "reqlen":
        buf[hdr.size + (nb + 7) // 8 + 4 * nb] = 255
    assert nnc > 0
    return bytes(buf)


@pytest.mark.parametrize("kind", ["short", "magic", "version", "dtype", "truncated", "prefix",
                                  "nnc>nb", "block count", "nmid", "bitmap", "reqlen"])
def test_corrupt_streams_raise_reference_messages(kind):
    buf = _corrupt(kind)
    with pytest.raises(ValueError) as ref_err:
        REF.decompress(buf)
    with pytest.raises(ValueError) as err:
        CPU.decompress(buf)
    assert str(err.value) == str(ref_err.value)


def test_corrupt_frames_raise_reference_messages():
    frames = list(REF.compress_chunked(_walk(100_000, seed=2), 1e-3, chunk_bytes=1 << 17))
    cases = [
        frames[1:],                                   # out of order
        frames[:-1],                                  # no LAST frame
        [frames[0][:10]],                             # truncated header
        [b"XXXX" + frames[0][4:]],                    # bad magic
        frames + frames[:1],                          # frame after LAST
    ]
    for frs in cases:
        with pytest.raises(ValueError) as ref_err:
            REF.decompress_chunked(frs)
        with pytest.raises(ValueError) as err:
            CPU.decompress_chunked(frs)
        assert str(err.value) == str(ref_err.value)


def test_second_stage_frames_fail_loudly():
    payload = REF.compress(_walk(1000), 1e-3)
    for code in (1, 3, 7):
        frame = container.FRAME_HEADER.pack(
            container.FRAME_MAGIC, container.FRAME_VERSION,
            container.FLAG_LAST | (code << container.FLAG_STAGE_SHIFT), 0, len(payload),
        ) + payload
        with pytest.raises(ValueError, match="stream requires second stage"):
            CPU.decompress_chunked(frame)
    with pytest.raises(ValueError, match="second stage"):
        SZxCodec(device="cpu", stage="deflate")


# ---------------------------------------------------------------------------
# transfers: one device-to-host body copy per frame
# ---------------------------------------------------------------------------

def test_one_body_copy_per_frame(monkeypatch):
    x = _walk(300_000, seed=2)
    chunk = 1 << 19
    gets, puts = [], []
    real_get, real_put = device.to_host, device.to_device
    monkeypatch.setattr(device, "to_host", lambda t: gets.append(t.numel()) or real_get(t))
    monkeypatch.setattr(device, "to_device",
                        lambda a, d: puts.append(a.size) or real_put(a, d))
    frames = list(CPU.compress_chunked(x, 1e-3, chunk_bytes=chunk))
    nchunks = -(-x.size // plan.chunk_elements(128, chunk, 4))
    payloads = list(container.iter_frames(frames))
    assert len(payloads) == nchunks and not puts
    # per frame: the two section sizes (nnc, nmid), then exactly the body
    assert gets == [n for p in payloads for n in (2, len(p) - container.HEADER.size)]
    gets.clear()
    CPU.decompress_chunked(frames, n=x.size)
    assert puts == [len(p) - container.HEADER.size for p in payloads]
    assert gets == [3] * nchunks                # the three measured scalars


# ---------------------------------------------------------------------------
# layout rule, CLI, launch counters
# ---------------------------------------------------------------------------

def test_derive_layout_matches_reference():
    reqlen = np.arange(0, 65, dtype=np.int32)
    const = (reqlen % 5) == 0
    rs, rn = rtransform.derive_layout(reqlen, const, rplan.spec_for(np.float64))
    ts, tn = transform.derive_layout(torch.from_numpy(reqlen), torch.from_numpy(const))
    np.testing.assert_array_equal(ts.numpy(), rs)
    np.testing.assert_array_equal(tn.numpy(), rn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_matches_reference_cli(tmp_path, dtype, capsys):
    x = _walk(70_000, seed=8, dtype=np.float32 if dtype == "float32" else BF16)
    raw = tmp_path / "in.bin"
    x.tofile(raw)
    args = ["--bound", "rel:1e-3", "--dtype", dtype, "--chunk-bytes", str(1 << 16)]
    assert tmain(["compress", str(raw), str(tmp_path / "t.szx"), "--device", "cpu", *args]) == 0
    assert rmain(["compress", str(raw), str(tmp_path / "r.szx"), "--backend", "numpy",
                  *args]) == 0
    assert (tmp_path / "t.szx").read_bytes() == (tmp_path / "r.szx").read_bytes()
    assert tmain(["decompress", str(tmp_path / "r.szx"), str(tmp_path / "t.bin"),
                  "--device", "cpu"]) == 0
    assert rmain(["decompress", str(tmp_path / "t.szx"), str(tmp_path / "r.bin"),
                  "--backend", "numpy"]) == 0
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    capsys.readouterr()
    assert tmain(["info", str(tmp_path / "t.szx"), "--json"]) == 0
    info = __import__("json").loads(capsys.readouterr().out)
    assert info["n"] == x.size and info["dtype"] == dtype and info["index"] == "v1"
    assert tmain(["info", str(tmp_path / "missing.szx")]) == 1


def test_cpu_codec_launches_no_kernel():
    tops.reset_launch_counts()
    CPU.decompress(CPU.compress(_walk(5000), 1e-3))
    assert tops.launch_counts() == {"encode": 0, "decode_body": 0}


def test_frame_header_struct_matches_reference():
    assert container.HEADER.format == rcontainer.HEADER.format
    assert container.FRAME_HEADER.format == rcontainer.FRAME_HEADER.format
    assert container.INDEX_TRAILER.format == rcontainer.INDEX_TRAILER.format
    idx = {"v": 1, "kind": "szx-chunked", "n": 3, "dtype": 0, "frames": [[0, 1, 3]]}
    assert container.build_index_footer(idx) == rcontainer.build_index_footer(idx)
    assert container.build_frame(b"abc", 4, True) == rcontainer.build_frame(b"abc", 4, True)
    with pytest.raises(struct.error):
        container.FRAME_HEADER.unpack(b"short")
