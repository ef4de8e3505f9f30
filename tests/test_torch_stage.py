"""repro_torch second stage against the JAX package's (byte-identical).

Runs the port on the CPU (``device="cpu"``: the plain versions) and holds it
to ``repro.core.codec.stage`` (which stages on the host with numpy): staged
payloads for 4 dtypes x 3 stages, destaged across both packages, the
byteplane permutation, negotiation, the corrupt-payload messages and
fail-loudly cases of tests/test_stage.py, chunked streams with ``stage=``
and the codec CLI's ``--stage``.
"""
import io
import struct

import ml_dtypes
import numpy as np
import pytest

from repro.core.codec import SZxCodec as RCodec, container as rcontainer, stage as rstage
from repro.core.codec.__main__ import main as rmain
from repro.core.codec.plan import Bound as RBound
from repro_torch.core.codec import SZxCodec, container, stage
from repro_torch.core.codec.__main__ import main as tmain
from repro_torch.core.codec.plan import Bound

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
STAGES = ["bitshuffle-rle", "bitshuffle-zstd", "deflate"]
CPU = SZxCodec(device="cpu")


def _walk(n, seed=0, scale=0.01, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _field(dtype, n=120_000, seed=1):
    """A walk with a zeroed slab (constant blocks, empty segments) and a
    quiet slab (1 + noise at half the bound: few stored bits, which RLE
    takes)."""
    x = _walk(n, seed=seed, dtype=np.float64)
    x[: n // 12] = 0.0
    e = 1e-3 * (x.max() - min(x.min(), 0.0))
    x[n // 3:] = 1.0 + 0.5 * e * np.random.default_rng(seed).standard_normal(n - n // 3)
    return x.astype(dtype)


def _payload(x):
    return RCodec(backend="numpy").compress(x, RBound.rel(1e-3))


@pytest.mark.parametrize("name", STAGES)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_staged_payloads_byte_identical_and_cross_destaged(dtype, name):
    payload = _payload(_field(dtype))
    code = stage.resolve(name)
    assert code == rstage.resolve(name)
    staged = 0
    for seg_blocks in (stage.DEFAULT_SEG_BLOCKS, 7):
        want = rstage.stage_payload(payload, code, seg_blocks=seg_blocks)
        got = stage.stage_payload(payload, code, seg_blocks=seg_blocks, device="cpu")
        assert got == want
        if got is not None:
            staged += 1
            assert len(got) < len(payload)
            assert stage.destage_payload(want, code, device="cpu") == payload
            assert rstage.destage_payload(got, code) == payload
    # float16 keeps too few bits of the quiet slab's noise for RLE to win
    assert staged or (name == "bitshuffle-rle" and dtype == np.float16)


def test_negotiation_declines_like_the_reference():
    const = _payload(np.full(1000, 7.5, np.float32))           # no mid bytes
    noise = _payload(np.random.default_rng(0).standard_normal(60_000).astype(np.float32))
    for name in STAGES:
        code = stage.resolve(name)
        assert stage.stage_payload(const, code, device="cpu") is None
        assert stage.stage_payload(noise, code, device="cpu") == rstage.stage_payload(noise, code)
    assert stage.stage_payload(const, stage.NONE) is None
    with pytest.raises(ValueError, match="seg_blocks"):
        stage.stage_payload(const, stage.DEFLATE, seg_blocks=0, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_plane_perm_matches_reference(dtype):
    payload = _payload(_field(dtype, n=30_000))
    prefix_len = container.stream_prefix_length(payload)
    rsec = rcontainer.parse_stream_sections(payload[:prefix_len], backend="numpy")
    tsec = container.parse_stream_sections(payload[:prefix_len], device="cpu")
    nb, seg = tsec.plan.nblocks, 16
    perm = stage._plane_perm(tsec, 0, nb, seg).numpy()
    for lo in range(0, nb, seg):
        hi = min(lo + seg, nb)
        a, b = tsec.mid_range(lo, hi)
        want = rstage._plane_perm(rsec, lo, hi)
        if want is None:
            assert a == b
        else:
            np.testing.assert_array_equal(perm[a:b] - a, want)


# ---------------------------------------------------------------------------
# fail-loudly: unknown/unavailable stages, corrupt payloads (the reference's
# messages, word for word)
# ---------------------------------------------------------------------------

def _with_stage_bits(frame, code):
    f = bytearray(frame)
    f[5] = (f[5] & ~container.FLAG_STAGE_MASK) | (code << container.FLAG_STAGE_SHIFT)
    return bytes(f)


def _same_error(make_ref, make_port, exc=ValueError):
    with pytest.raises(exc) as ref_err:
        make_ref()
    with pytest.raises(exc) as err:
        make_port()
    assert str(err.value) == str(ref_err.value)
    return str(err.value)


def test_unknown_stage_code_fails_loudly():
    frame = _with_stage_bits(container.build_frame(_payload(_walk(5_000)), 0, True), 5)
    for src in (lambda: iter([frame]), lambda: io.BytesIO(frame)):
        msg = _same_error(lambda: list(rcontainer.iter_frames(src())),
                          lambda: list(container.iter_frames(src(), device="cpu")))
        assert "requires second stage" in msg
    with pytest.raises(ValueError, match="requires second stage"):
        CPU.load_chunked(io.BytesIO(frame))


def test_zstd_disabled_fails_loudly_in_both(monkeypatch):
    """SZX_STAGE_DISABLE_ZSTD switches zstd off in both packages: readers
    refuse zstd-staged frames, writers refuse the stage."""
    frame = container.build_frame(_payload(_field(np.float32)), 0, True,
                                  stage="bitshuffle-zstd", device="cpu")
    assert container.stage_of_flags(frame[5]) == stage.BITSHUFFLE_ZSTD
    monkeypatch.setenv("SZX_STAGE_DISABLE_ZSTD", "1")
    msg = _same_error(lambda: list(rcontainer.iter_frames(io.BytesIO(frame))),
                      lambda: list(container.iter_frames(io.BytesIO(frame), device="cpu")))
    assert "zstandard package is not installed" in msg
    _same_error(lambda: RCodec(stage="bitshuffle-zstd"),
                lambda: SZxCodec(device="cpu", stage="bitshuffle-zstd"))


def test_unknown_stage_names_rejected():
    _same_error(lambda: RCodec(stage="huffman"), lambda: SZxCodec(device="cpu", stage="huffman"))
    _same_error(lambda: rstage.resolve(7), lambda: stage.resolve(7))
    _same_error(lambda: rstage.resolve(2.5), lambda: stage.resolve(2.5), TypeError)


def test_corrupt_second_stage_payload_rejected():
    payload = _payload(_walk(80_000, seed=4))
    frame = container.build_frame(payload, 0, True, stage="deflate", device="cpu")
    assert container.stage_of_flags(frame[5]) == stage.DEFLATE
    hdr = container.FRAME_HEADER.size
    prefix_len = container.stream_prefix_length(payload)
    seg_blocks, nseg = struct.unpack_from("<HI", frame, hdr + prefix_len)
    cases = []
    bad = bytearray(frame)
    bad[-10] ^= 0xFF                                   # inside a record body
    cases.append(bad)
    bad = bytearray(frame)
    struct.pack_into("<HI", bad, hdr + prefix_len, seg_blocks, nseg + 3)
    cases.append(bad)
    bad = bytearray(frame)
    struct.pack_into("<HI", bad, hdr + prefix_len, 0, nseg)
    cases.append(bad)
    cases.append(_with_stage_bits(container.build_frame(payload, 0, True), stage.BITSHUFFLE_RLE))
    cases.append(frame[:-3])
    for bad in cases:
        b = bytes(bad)
        msg = _same_error(lambda: list(rcontainer.iter_frames(io.BytesIO(b))),
                          lambda: list(container.iter_frames(io.BytesIO(b), device="cpu")))
        assert "corrupt second-stage payload" in msg or "truncated" in msg


def test_raw_frames_and_stage_bits():
    bad = _with_stage_bits(container.build_frame(b"rawbytes", 0, True, raw=True), stage.DEFLATE)
    _same_error(lambda: list(rcontainer.iter_frames(iter([bad]))),
                lambda: list(container.iter_frames(iter([bad]), device="cpu")))
    frame = container.build_frame(b"rawbytes", 0, True, raw=True, stage="deflate")
    assert frame == rcontainer.build_frame(b"rawbytes", 0, True, raw=True, stage="deflate")
    assert container.stage_of_flags(frame[5]) == 0


def test_rle_decode_rejects_bad_pairs():
    for body, n in ((b"\x01\x02\x03", 3), (b"\x01\x00", 1), (b"\x01\x05", 3)):
        _same_error(lambda: rstage._rle_decode(body, n), lambda: stage._rle_decode(body, n))
    runs = np.repeat(np.arange(5, dtype=np.uint8), [1, 255, 256, 600, 3])
    assert stage._rle_encode(runs) == rstage._rle_encode(runs)


# ---------------------------------------------------------------------------
# chunked streams and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STAGES)
def test_chunked_staged_streams_match_reference(name):
    x = _field(np.float32, n=200_000, seed=5)
    want = io.BytesIO()
    RCodec(backend="numpy", stage=name).dump_chunked(x, want, RBound.rel(1e-3),
                                                     chunk_bytes=1 << 17)
    got = io.BytesIO()
    SZxCodec(device="cpu", stage=name, workers=2).dump_chunked(x, got, Bound.rel(1e-3),
                                                               chunk_bytes=1 << 17)
    assert got.getvalue() == want.getvalue()
    flags = [f for _p, f in rcontainer.iter_frames(io.BytesIO(want.getvalue()),
                                                   with_flags=True)]
    assert len(flags) > 1
    y = CPU.load_chunked(io.BytesIO(got.getvalue()), n=x.size)
    np.testing.assert_array_equal(y.numpy(), RCodec(backend="numpy").load_chunked(
        io.BytesIO(want.getvalue())))
    sel = CPU.load_chunked(io.BytesIO(got.getvalue()), select=[1, 2])
    per = (1 << 17) // 4
    np.testing.assert_array_equal(sel.numpy(), y.numpy()[per:3 * per])


def test_codec_cli_stage_matches_reference(tmp_path):
    x = _field(np.float32, n=70_000, seed=8)
    raw = tmp_path / "in.bin"
    x.tofile(raw)
    args = ["--bound", "rel:1e-3", "--chunk-bytes", str(1 << 16), "--stage", "bitshuffle-rle"]
    assert tmain(["compress", str(raw), str(tmp_path / "t.szx"), "--device", "cpu", *args]) == 0
    assert rmain(["compress", str(raw), str(tmp_path / "r.szx"), "--backend", "numpy",
                  *args]) == 0
    assert (tmp_path / "t.szx").read_bytes() == (tmp_path / "r.szx").read_bytes()
    assert tmain(["decompress", str(tmp_path / "r.szx"), str(tmp_path / "t.bin"),
                  "--device", "cpu"]) == 0
    assert rmain(["decompress", str(tmp_path / "t.szx"), str(tmp_path / "r.bin"),
                  "--backend", "numpy"]) == 0
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    assert tmain(["info", str(tmp_path / "t.szx"), "--device", "cpu"]) == 0


def test_stage_payload_accepts_tensor_free_inputs():
    """Payloads may be bytes, bytearray or memoryview, as in the reference."""
    payload = _payload(_field(np.float16, n=30_000))
    want = rstage.stage_payload(payload, stage.DEFLATE)
    for p in (bytearray(payload), memoryview(payload)):
        assert stage.stage_payload(p, stage.DEFLATE, device="cpu") == want
    assert stage.destage_payload(memoryview(want), stage.DEFLATE, device="cpu") == payload
