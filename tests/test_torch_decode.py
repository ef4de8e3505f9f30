"""repro_torch fused stream decode against the JAX package's (bit-identical).

The port's plain ``parse_body`` + ``decode_body`` (the CPU route of
``kernels.decode.decode_body``) are held against the Pallas kernel
``repro.kernels.decode.decode_body`` in interpret mode for f32/f16/bf16,
for the whole body and for a block range with and without ``rebase`` (the
store ROI body: metadata prefix + the range's mid bytes).  f64 is held
against ``SZxCodec(backend="numpy").decompress`` (the reference's x64 route
is broken under the installed jax).  The CUDA kernel is compared with the
plain version on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.codec import SZxCodec as RCodec, container as rcontainer
from repro.kernels import decode as rdecode, ref as rref, specs as rspecs
from repro_torch.kernels import decode as tdecode, ops as tops, ref as tref, specs as tspecs

BF16 = np.dtype(ml_dtypes.bfloat16)
BS = 64
NB = 40
CASES = [(0, NB, False), (5, 9, False), (5, 9, True), (NB - 1, 1, True)]


def _field(n, dtype, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


def _stream(dtype, e=1e-3, seed=11):
    x = _field(NB * BS - 17, dtype, seed=seed)
    return RCodec(block_size=BS, backend="numpy").compress(x, e)


def _body(buf: bytes, lo: int, rb: int, rebase: bool) -> np.ndarray:
    """The raw body (header stripped); with ``rebase`` the store ROI layout:
    metadata prefix + exactly blocks [lo, lo + rb)'s mid bytes."""
    body = np.frombuffer(buf, np.uint8, offset=rcontainer.HEADER.size)
    if not rebase:
        return body
    sec = rcontainer.parse_stream_sections(buf, backend="numpy")
    a, b = sec.mid_range(lo, lo + rb)
    off = sec.mid_offset - rcontainer.HEADER.size
    return np.concatenate([body[:off], body[off + a: off + b]])


def _port_decode(body: np.ndarray, nnc, lo, rb, rebase, spec):
    tb = torch.from_numpy(body.copy())
    _c, mu, shift, nbytes, rank, nnc_seen = tref.parse_body_ref(tb, nnc, spec, NB)
    vals, mid_total = tdecode.decode_body(tb, nnc, lo, mu, shift, nbytes, rank,
                                          spec=spec, bs=BS, rb=rb, rebase=rebase)
    return vals, int(mid_total), int(nnc_seen), (mu, shift, nbytes, rank)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"lo{c[0]}-rb{c[1]}-rebase{int(c[2])}")
@pytest.mark.parametrize("dtype", [np.float32, np.float16, BF16],
                         ids=["float32", "float16", "bfloat16"])
def test_plain_decode_matches_pallas_kernel(dtype, case):
    lo, rb, rebase = case
    buf = _stream(dtype)
    nnc = rcontainer.HEADER.unpack_from(buf, 0)[7]
    body = _body(buf, lo, rb, rebase)
    rspec = rspecs.spec_for(np.dtype(dtype))
    jb = jnp.asarray(body)
    _c, mu, shift, nbytes, rank, nnc_seen = rref.parse_body_ref(jb, nnc, rspec, NB)
    rvals, rtotal = rdecode.decode_body(jb, nnc, lo, mu, shift, nbytes, rank, spec=rspec,
                                        bs=BS, rb=rb, rebase=rebase, interpret=True)
    tvals, ttotal, tseen, tmeta = _port_decode(body, nnc, lo, rb, rebase,
                                               tspecs.spec_for(np.dtype(dtype)))
    np.testing.assert_array_equal(_bits(tvals), _bits(rvals))
    assert ttotal == int(rtotal) == rcontainer.HEADER.unpack_from(buf, 0)[8]
    assert tseen == int(nnc_seen) == nnc
    for a, b in zip(tmeta, (mu, shift, nbytes, rank)):       # parsed metadata
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_plain_decode_f64_matches_numpy_decompress():
    buf = _stream(np.float64, e=1e-6)
    ref = RCodec(block_size=BS, backend="numpy").decompress(buf)
    full = np.pad(ref, (0, NB * BS - ref.size), mode="edge").reshape(NB, BS)
    nnc = rcontainer.HEADER.unpack_from(buf, 0)[7]
    for lo, rb, rebase in CASES:
        vals, total, seen, _ = _port_decode(_body(buf, lo, rb, rebase), nnc, lo, rb,
                                            rebase, tspecs.F64)
        n_valid = min(rb * BS, ref.size - lo * BS)
        np.testing.assert_array_equal(_bits(vals).reshape(-1)[:n_valid],
                                      _bits(full[lo:lo + rb]).reshape(-1)[:n_valid])
        assert total == rcontainer.HEADER.unpack_from(buf, 0)[8] and seen == nnc


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, BF16],
                         ids=["float32", "float64", "float16", "bfloat16"])
def test_plain_decode_constant_verbatim_and_all_L0(dtype):
    """Constant blocks decode to mu, verbatim blocks (bound below the ulp)
    to the exact input, all-L==0 frames without any propagation."""
    rcodec = RCodec(block_size=BS, backend="numpy")
    alt = np.linspace(1.0, 2.0, NB * BS)
    alt[1::2] *= -1.0
    tiny = float(torch.finfo(tspecs.spec_for(np.dtype(dtype)).dtype).tiny)
    for x, e in ((np.full(NB * BS, 2.5), 1e-3), (_field(NB * BS, np.float64, scale=1.0), tiny),
                 (alt, 1e-3)):
        x = x.astype(dtype)
        buf = rcodec.compress(x, e)
        nnc = rcontainer.HEADER.unpack_from(buf, 0)[7]
        vals, _t, _s, _m = _port_decode(_body(buf, 0, NB, False), nnc, 0, NB, False,
                                        tspecs.spec_for(np.dtype(dtype)))
        np.testing.assert_array_equal(_bits(vals).reshape(-1), _bits(rcodec.decompress(buf)))


def test_decode_rejects_out_of_range_blocks():
    buf = _stream(np.float32)
    nnc = rcontainer.HEADER.unpack_from(buf, 0)[7]
    for lo, rb in ((-1, 2), (0, 0), (NB - 1, 2), (NB, 1)):
        with pytest.raises(ValueError, match="out of"):
            _port_decode(_body(buf, 0, NB, False), nnc, lo, rb, False, tspecs.F32)


def test_decode_staged_measures_header_fields():
    buf = _stream(np.float16, e=1e-2)
    hdr = rcontainer.HEADER.unpack_from(buf, 0)
    body = torch.from_numpy(_body(buf, 0, NB, False).copy())
    vals, meas = tops.decode_staged(body, hdr[7], 0, spec=tspecs.F16, nb=NB, bs=BS)
    nbytes = tref.parse_body_ref(body, hdr[7], tspecs.F16, NB)[3]
    assert meas.tolist() == [hdr[7], int(nbytes.max()), hdr[8]]
    assert tuple(vals.shape) == (NB, BS)

