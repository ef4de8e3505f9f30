"""repro_torch szx-planes (plain versions, PlanesCodec, core.planes) against
the JAX package's jax route, bit for bit.

The parity target is the reference's jax route: ``PlanesCodec``'s default
backend and what ``grad_compress`` runs.  On the CPU XLA flushes subnormals
and computes ``exp2(s)`` as ``exp(ln2 * s)``, a few ulps off 2**s; the port
reproduces both (``kernels/ref.py``), and the reference's numpy mirror,
which does neither, is pinned here as the reference's own gap.  Inputs are
made with numpy from a seed.  The CUDA kernels are held to the plain
versions on the card by tests/test_torch_cuda.py.
"""
import math
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planes as rplanes
from repro.core.codec import DeviceEncoding as RDeviceEncoding
from repro.core.codec import PlanesCodec as RPlanesCodec
from repro.kernels import ops as rops, ref as rref
from repro.kernels import planes as rkplanes
from repro_torch.core import planes as tplanes
from repro_torch.core.codec import DeviceEncoding, PlanesCodec
from repro_torch.kernels import ops as tops, planes as tkplanes, ref as tref

BLOCK_SIZES = [1, 3, 64, 128, 4096]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


def _edge_blocks(bs: int = 8) -> np.ndarray:
    """Constant blocks, signed zeros, subnormals, tiny radius (sexp >= 127),
    NaN with payloads, +-inf, and min + max that overflows."""
    nan, inf = float("nan"), float("inf")
    fill = [float(i) for i in range(1, bs)]
    rows = [[0.0] * bs, [-0.0] * bs, [0.0, -0.0] * (bs // 2), [3.5] * bs, [1e-40] * bs,
            [0.0] * 3 + [1e-40] + [0.0] * (bs - 4), [-1e-40, 1e-40] + [0.0] * (bs - 2),
            [1e-38, 1.2e-38] + [1.1e-38] * (bs - 2), [1.5e-38, -1.2e-38] + [1.3e-38] * (bs - 2),
            [1.0, 1.0 + 2 ** -23] + [1.0] * (bs - 2), [1e-30] * (bs - 1) + [1.0000001e-30],
            [nan] + fill, [1.0, nan, nan] + fill[2:], [_f32(0x7F812345)] + fill,
            [_f32(0xFFC00001)] * bs, [inf] + fill, [-inf] + fill,
            [inf, -inf] + [0.0] * (bs - 2), [inf] * bs, [3e38, 2e38] + [3.3e38] * (bs - 2),
            [-3e38, -2e38] + [-3.3e38] * (bs - 2), [3.4e38, -3.4e38] + fill[:-1]]
    return np.array(rows, np.float32)


def _random_blocks(nb: int, bs: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = np.exp2(rng.integers(-40, 40, (nb, 1)))
    return (rng.standard_normal((nb, bs)) * scale).astype(np.float32)


def _tiny_radius(seed: int) -> np.ndarray:
    """Blocks one or two ulps wide: the radius exponent gives sexp >= 127."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1, 2, (200, 1)).astype(np.float32)
    return (base + rng.integers(0, 3, (200, 16)) * np.spacing(base)).astype(np.float32)


def _encode_both(x: np.ndarray, P: int):
    r = [np.asarray(a) for a in rref.planes_encode_ref(jnp.asarray(x), P)]
    t = [a.numpy() for a in tref.planes_encode_ref(torch.from_numpy(x), P)]
    return r, t


def _check_encode_decode(x: np.ndarray, P: int) -> None:
    (rm, rs, rp), t = _encode_both(x, P)
    for name, a, b in zip(("mu", "sexp", "planes"), (rm, rs, rp), t):
        assert _same(a, b), (name, x.shape, P)
    rd = rref.planes_decode_ref(jnp.asarray(rm), jnp.asarray(rs), jnp.asarray(rp))
    td = tref.planes_decode_ref(*(torch.from_numpy(a) for a in (rm, rs, rp)))
    assert _same(rd, td), (x.shape, P)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def test_scale_table_is_the_jax_routes_exp2():
    """The port's scale table is the values ``jnp.exp2`` gave for integer s
    under jax/jaxlib 0.9.0 on an x86-64 host with AVX-512 and FMA (XLA's CPU
    exp; other instruction sets give other values for some s).  If this
    fails, the reference's exp2 changed on this host or build, and with it
    every bit-parity case of this file: compare the two tables before
    looking at the port."""
    s = np.arange(-300, 301, dtype=np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(s)))
    got = tref.planes_exp2(torch.from_numpy(s))
    assert _same(got, want), (
        "the reference's jnp.exp2 differs from ref.PLANES_SCALE_ULPS at s = "
        f"{s[got.numpy().view(np.int32) != want.view(np.int32)].astype(int).tolist()}")
    assert float(want[s == 130][0]) == math.inf and float(want[s == -126][0]) == 0.0
    # not a power of two for most s: the table is the reference's, not 2**s
    exact = np.array([math.ldexp(1.0, int(k)) for k in range(-125, 128)], np.float32)
    assert int((tref.planes_scale_table("cpu").numpy() != exact).sum()) > 150


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("P", [1, 2, 3])
def test_plain_versions_match_jax_route(P, bs):
    _check_encode_decode(_random_blocks(max(2, 16384 // bs), bs, seed=bs * 10 + P), P)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_plain_versions_match_jax_route_on_edge_blocks(P):
    for x in (_edge_blocks(), _edge_blocks(64), _tiny_radius(P)):
        _check_encode_decode(x, P)
    # values spread over the subnormal boundary
    rng = np.random.default_rng(P)
    x = (rng.standard_normal((300, 16)) * np.exp2(rng.integers(-149, -100, (300, 1))))
    _check_encode_decode(x.astype(np.float32), P)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_plain_decode_matches_jax_route_on_random_records(P):
    rng = np.random.default_rng(40 + P)
    nb, bs = 4000, 16
    mu = (rng.standard_normal(nb) * np.exp2(rng.integers(-140, 127, nb))).astype(np.float32)
    mu[::97], mu[1::101], mu[2::103], mu[3::107] = np.nan, np.inf, 1e-40, -0.0
    mu[4::109] = _f32(0x7FC12345)
    sexp = rng.integers(-300, 300, nb).astype(np.int32)
    edges = np.array([-128, -127, -126, -125, 125, 126, 127, 128, 0, 2 ** 31 - 1, -2 ** 31],
                     np.int32)
    sexp[::5] = np.resize(edges, len(sexp[::5]))
    planes = rng.integers(0, 256, (P, nb, bs)).astype(np.uint8)
    want = rref.planes_decode_ref(jnp.asarray(mu), jnp.asarray(sexp), jnp.asarray(planes))
    got = tref.planes_decode_ref(*(torch.from_numpy(a) for a in (mu, sexp, planes)))
    assert _same(got, want)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_leading_dims_and_empty_input(P):
    x = np.random.default_rng(8).standard_normal((3, 5, 2, 32)).astype(np.float32)
    r = [np.asarray(a) for a in rops.planes_encode(x, P, backend="jax")]
    t = tops.planes_encode(torch.from_numpy(x), P)
    assert t[0].shape == (3, 5, 2) and t[2].shape == (P, 3, 5, 2, 32)
    for a, b in zip(r, t):
        assert _same(a, b)
    assert _same(tops.planes_decode(*t), rops.planes_decode(*r, backend="jax"))
    e = tkplanes.planes_encode(torch.zeros((0, 64)), P)
    assert [tuple(a.shape) for a in e] == [(0,), (0,), (P, 0, 64)]
    assert tuple(tkplanes.planes_decode(*e).shape) == (0, 64)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_plain_versions_match_the_pallas_kernel(P):
    """The Pallas kernels in interpret mode: encode bit for bit; decode to
    one ulp at the data's magnitude, the reference's own tolerance between
    its kernel and its jax route (the staged kernel may fuse q*scale + mu)."""
    x = _random_blocks(64, 128, seed=P)
    k = [np.asarray(a) for a in rkplanes.planes_encode(jnp.asarray(x), P, interpret=True)]
    t = tref.planes_encode_ref(torch.from_numpy(x), P)
    for a, b in zip(k, t):
        assert _same(a, b)
    dk = np.asarray(rkplanes.planes_decode(*(jnp.asarray(a) for a in k), interpret=True))
    dt = tref.planes_decode_ref(*t).numpy()
    np.testing.assert_allclose(dt, dk, rtol=0, atol=float(np.abs(dk).max()) * 2e-7)


def test_numpy_mirror_gap_is_the_references():
    """The reference's numpy mirror neither flushes subnormals nor uses the
    jax route's exp2; the port follows the jax route."""
    x = np.zeros((1, 8), np.float32)
    x[0, 3] = 1e-40
    (rm, rs, rp), (tm, ts, tp) = _encode_both(x, 1)
    assert rp.tolist() == [[[0] * 8]] and _same(tp, rp) and _same(ts, rs)
    _nm, _ns, npl = rops._planes_encode_np(x, 1)
    assert npl.tolist() == [[[128, 128, 128, 127, 128, 128, 128, 128]]]
    # exp2 at a typical gradient exponent: numpy's is 2**26, the jax route's
    # is 8 ulps above it, so decoded values differ in their low bits
    mu, sexp = np.zeros(1, np.float32), np.array([-26], np.int32)
    planes = np.full((1, 1, 4), 77, np.uint8)
    np_dec = rops._planes_decode_np(mu, sexp, planes)
    jx_dec = np.asarray(rref.planes_decode_ref(jnp.asarray(mu), jnp.asarray(sexp),
                                               jnp.asarray(planes)))
    assert np_dec[0, 0] == 77 * 2.0 ** 26 and not _same(np_dec, jx_dec)
    assert _same(tref.planes_decode_ref(*(torch.from_numpy(a) for a in (mu, sexp, planes))),
                 jx_dec)


def test_plain_route_is_chosen_by_the_tensor_device():
    x = _random_blocks(4, 32, seed=1)
    assert tops.planes_encode(torch.from_numpy(x), 2)[0].device.type == "cpu"
    with pytest.raises(ValueError, match="1..3 byte planes"):
        tkplanes.planes_encode(torch.from_numpy(x), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tkplanes.planes_encode(torch.from_numpy(x).to("meta"), 1)


# ---------------------------------------------------------------------------
# PlanesCodec and core.planes
# ---------------------------------------------------------------------------

CPU = {"device": "cpu"}


@pytest.mark.parametrize("P", [1, 2, 3])
def test_planes_codec_matches_reference(P):
    rng = np.random.default_rng(17 + P)
    xb = rng.standard_normal((9, 64)).astype(np.float32)
    rc, tc = RPlanesCodec(P), PlanesCodec(P, **CPU)
    r = [np.asarray(a) for a in rc.encode_blocks(jnp.asarray(xb))]
    t = tc.encode_blocks(xb)                          # a host array: to `device`
    for a, b in zip(r, t):
        assert _same(a, b)
    assert _same(tc.decode_blocks(*t), rc.decode_blocks(*(jnp.asarray(a) for a in r)))
    # the encoding records, with the wire's int16 sexp
    renc, tenc = rc.encode_blocks_device(jnp.asarray(xb)), tc.encode_blocks_device(xb)
    assert tenc.kind == renc.kind == "szx-planes" and tenc.info == renc.info
    narrow = tenc.replace(sexp=tenc["sexp"].to(torch.int16))
    want = rc.decode_encoding(renc.replace(sexp=renc["sexp"].astype(jnp.int16)))
    assert _same(tc.decode_encoding(narrow), want)
    # last-axis blocking with a zero-padded tail, leading dims kept
    x = rng.standard_normal((3, 5, 70)).astype(np.float32)
    renc = rc.encode_last_axis_device(jnp.asarray(x), 32)
    tenc = tc.encode_last_axis_device(torch.from_numpy(x), 32)
    assert tenc.info == renc.info == {"num_planes": P, "block": 32}
    for k in ("mu", "sexp", "planes"):
        assert _same(tenc[k], renc[k])
    assert _same(tc.decode_last_axis_encoding(tenc, x.shape, torch.float32),
                 rc.decode_last_axis_encoding(renc, x.shape, jnp.float32))
    scalar = tc.encode_last_axis(torch.tensor(2.5), 8)
    assert tc.decode_last_axis(scalar, (), torch.float32).shape == ()
    # flat API with edge padding
    flat = rng.standard_normal(1000).astype(np.float32)
    for a, b in zip(rc.encode_flat(jnp.asarray(flat), 128), tc.encode_flat(flat, 128)):
        assert _same(a, b)
    assert tc.wire_bytes_per_value(64) == rc.wire_bytes_per_value(64) == P + 6 / 64


def test_planes_codec_messages_match_reference():
    for bad in (0, 4):
        with pytest.raises(ValueError, match=r"szx-planes supports 1\.\.3 byte planes"):
            PlanesCodec(bad)
    enc = PlanesCodec(2, **CPU).encode_blocks_device(np.ones((2, 8), np.float32))
    cases = [(PlanesCodec(3, **CPU), enc, RPlanesCodec(3),
              RPlanesCodec(2).encode_blocks_device(jnp.ones((2, 8)))),
             (PlanesCodec(1, **CPU), DeviceEncoding.make("szx-v2", {"mu": torch.zeros(1)}),
              RPlanesCodec(1), RDeviceEncoding.make("szx-v2", {"mu": jnp.zeros(1)}))]
    for tc, tenc, rc, renc in cases:
        with pytest.raises(ValueError) as want:
            rc.decode_encoding(renc)
        with pytest.raises(ValueError, match="^" + __import__("re").escape(str(want.value))):
            tc.decode_encoding(tenc)


def test_device_encoding_replace():
    enc = DeviceEncoding.make("szx-planes", {"mu": torch.ones(4)}, num_planes=1)
    swapped = enc.replace(mu=torch.zeros(4))
    assert swapped.kind == enc.kind and swapped.info == {"num_planes": 1}
    assert torch.equal(enc["mu"], torch.ones(4)) and torch.equal(swapped["mu"], torch.zeros(4))
    with pytest.raises(KeyError, match=r"unknown encoding arrays \['nope'\]"):
        enc.replace(nope=torch.zeros(1))


@pytest.mark.parametrize("P,bs", [(1, 128), (2, 64), (3, 100)])
def test_core_planes_matches_reference(P, bs):
    x = (np.random.default_rng(P).standard_normal((7, 143)) * 0.01).astype(np.float32)
    renc = rplanes.encode(jnp.asarray(x), num_planes=P, block_size=bs)
    tenc = tplanes.encode(torch.from_numpy(x), num_planes=P, block_size=bs)
    assert (tenc.n, tenc.block_size) == (renc.n, renc.block_size) == (x.size, bs)
    for k in ("mu", "sexp", "planes"):
        assert _same(getattr(tenc, k), getattr(renc, k))
    assert tplanes.wire_bytes(tenc) == rplanes.wire_bytes(renc)
    assert _same(tplanes.max_block_error_bound(tenc), rplanes.max_block_error_bound(renc))
    assert _same(tplanes.decode(tenc, shape=x.shape), rplanes.decode(renc, shape=x.shape))
    got = tplanes.roundtrip(torch.from_numpy(x), num_planes=P, block_size=bs)
    assert _same(got, rplanes.roundtrip(jnp.asarray(x), num_planes=P, block_size=bs))
    assert _same(tplanes.roundtrip(x, num_planes=P, block_size=bs, device="cpu"), got)
