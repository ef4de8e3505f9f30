"""The store path's kernels (unpack, unpack_dense, bitshuffle): their routes
and their vector designs, decided and emulated on the CPU.

``kernels/unpack.py::route`` and ``kernels/bitshuffle.py::route`` pick the
vector or the scalar kernel from the shape and the pointers' alignment
alone; these tests hold the rules and show that the store's ROI reads and
queries hand the kernels tensors that take the vector route.  The vector
kernels cannot run here, so their arithmetic is written out as the kernels
do it, lane by lane (``csrc/unpack.cu``: four values a lane, each plane's
elided bytes filled within the lane, then from the nearest lane below in the
block, then from the earlier windows' carry, the all-L-zero skip; ``csrc/bitshuffle.cu``: 8x8 bit transposes
of 64-bit words by delta swaps and an 8x8 byte transpose by byte permutes),
and held bit for bit to the plain versions and to the JAX package.  The
kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py.  Also here: the store's decode chooses between
``unpack`` and ``unpack_dense`` from the host's parse, with no reduction on
the device.
"""
import io

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops, specs as rspecs
from repro.kernels import bitshuffle as rbitshuffle
from repro_torch.core.codec import Bound, container, transform
from repro_torch.kernels import bitshuffle as tbitshuffle, ops as tops, ref as tref
from repro_torch.kernels import specs as tspecs, unpack as tunpack
from repro_torch.store import ArrayStore

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
KINDS = ["walk", "alternating", "nonfinite", "signed_zeros", "mixed"]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _blocks(dtype, kind: str, nb: int, bs: int, seed: int):
    """(x (nb, bs), e) made with numpy from a seed: a random walk (long runs
    of elided leading bytes), alternating signs (every L = 0), NaN and inf
    values, blocks of zeros of both signs, or walk blocks beside all-L-zero
    ones."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(nb * bs)) * 0.01
    e = 1e-3 if dtype.itemsize >= 4 else 1e-2
    if kind == "alternating":
        x = np.linspace(1.0, 2.0, nb * bs)
        x[1::2] *= -1.0
    elif kind == "nonfinite":
        x[::97], x[5::193], x[7::291] = np.nan, np.inf, -np.inf
    x = x.reshape(nb, bs)
    if kind == "signed_zeros":
        x[1::3] = np.where(rng.integers(0, 2, (len(x[1::3]), bs)) == 1, -0.0, 0.0)
    elif kind == "mixed":
        alt = np.linspace(1.0, 2.0, bs)
        alt[1::2] *= -1.0
        x[::2] = alt
    return x.astype(dtype), e


def _encode(dtype, kind, nb, bs, seed=7):
    x, e = _blocks(dtype, kind, nb, bs, seed)
    rspec = rspecs.spec_for(dtype)
    mu, _c, _r, shift, nbytes, planes, L = (np.asarray(a) for a in
                                            rops.encode(x, e, spec=rspec, backend="numpy"))
    return rspec, mu, shift.astype(np.int32), nbytes.astype(np.int32), planes, L.astype(np.uint8)


# ---------------------------------------------------------------------------
# unpack's vector route, lane by lane
# ---------------------------------------------------------------------------

def _fill_lane(M: np.ndarray, b: np.ndarray):
    """The kernel's in-lane fill of one plane word, on (lanes, 4) bytes:
    each byte not stored (M false) takes the nearest stored byte below it in
    the lane, by the two shift steps of csrc/unpack.cu; returns the filled
    bytes and where one was found."""
    b, have = np.where(M, b, 0), M.copy()
    for d in (1, 2):                                   # << 8, then << 16
        up = np.zeros_like(b)
        up[:, d:] = b[:, :-d]
        b = np.where(have, b, up)
        hv = np.zeros_like(have)
        hv[:, d:] = have[:, :-d]
        have = have | hv
    return b, have


def _unpack_vector_emulated(planes, nbytes, L, lead: int, nt: int = 2) -> np.ndarray:
    """The byte planes after propagation, (nb, W, bs), as csrc/unpack.cu's
    unpack_vector_kernel computes them (L None: unpack_dense): a warp walks
    a run of ``per_run`` whole blocks in windows of 128 values, lane l
    holding values 4l..4l+3 of the window, its four bytes of a plane one
    word, read only where one of the four stores the plane."""
    nb, W, bs = planes.shape
    assert bs % 4 == 0
    per_run = 1 if bs >= 128 * nt else 128 * nt // bs
    spans = 128 % bs != 0
    lanes = np.arange(32)
    out = np.zeros_like(planes)
    for b0 in range(0, nb, per_run):
        nv = min(per_run, nb - b0) * bs
        carry = [-1] * lead
        for v0 in range(0, nv, 128):
            vs = v0 + 4 * lanes
            valid = vs < nv
            vc = np.where(valid, vs, nv - 4)
            blk, ii = b0 + vc // bs, vc % bs
            nbt = np.where(valid, nbytes[blk], 0)
            lw = (np.zeros((32, 4), np.int64) if L is None else
                  np.where(valid[:, None], L[blk[:, None], ii[:, None] + np.arange(4)], 0))
            cont = ii // 4 > lanes
            seg_lo = np.where(cont, 0, lanes - ii // 4)
            scan = L is not None and bool(lw.any())          # one ballot
            for j in range(W):
                # a lane reads its word of plane j only where one of its
                # values stores that plane
                stored = (j >= lead) | (lw <= j).any(axis=1)
                b = planes[blk[:, None], j, ii[:, None] + np.arange(4)].astype(np.int64)
                b = np.where(((j < nbt) & stored)[:, None], b, 0)
                if j < lead and scan:
                    M = (j < nbt)[:, None] & (lw <= j)          # __vcmpleu4
                    b, have = _fill_lane(M, b)
                    held = M.any(axis=1)                         # the ballot
                    last = b[:, 3]
                    inn = np.full(32, -1)
                    for lane in range(32):
                        below = [m for m in range(seg_lo[lane], lane) if held[m]]
                        inn[lane] = (last[below[-1]] if below else
                                     carry[j] if cont[lane] else -1)
                    b = np.where(~have & (inn >= 0)[:, None], inn[:, None], b)
                    if spans:
                        carry[j] = int(last[31] if held[31] else inn[31])
                elif j < lead and L is not None and spans:
                    own = b[31, 3] if j < nbt[31] else -1
                    carry[j] = int(carry[j] if cont[31] and own < 0 else own)
                for lane in np.flatnonzero(valid):
                    out[blk[lane], j, ii[lane]:ii[lane] + 4] = b[lane]
    return out


def _compose(planes, mu, shift, nbytes, spec):
    nb, W, bs = planes.shape
    ws = torch.zeros((nb, bs), dtype=torch.int64)
    live = torch.arange(W)[None, :] < nbytes[:, None]
    for j in range(W):
        byte = torch.where(live[:, j, None], planes[:, j].to(torch.int64), 0)
        ws = ws | (byte << (8 * (W - 1 - j)))
    return tref._compose_word(ws, mu, shift, nbytes, spec)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bs", [4, 8, 128, 4096])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_unpack_vector_design_matches_plain_and_reference(dtype, bs, kind):
    nb = {4: 300, 8: 160, 128: 13, 4096: 2}[bs]
    rspec, mu, shift, nbytes, planes, L = _encode(dtype, kind, nb, bs, seed=bs)
    spec = tspecs.spec_for(dtype)
    args = (_tensor(mu), torch.from_numpy(shift), torch.from_numpy(nbytes))
    for elide in (True, False):
        got = _unpack_vector_emulated(planes, nbytes, L if elide else None, spec.lead_cap)
        vals = _compose(torch.from_numpy(got), *args, spec)
        if elide:
            plain = tref.unpack_ref(torch.from_numpy(planes), *args, torch.from_numpy(L), spec)
            want = rops.unpack(planes, mu, shift, nbytes, L, spec=rspec, backend="numpy")
        else:
            plain = tref.unpack_dense_ref(torch.from_numpy(planes), *args, spec)
            want = rops.unpack_dense(planes, mu, shift, nbytes, spec=rspec, backend="numpy")
        np.testing.assert_array_equal(_bits(vals), _bits(plain))
        np.testing.assert_array_equal(_bits(vals), _bits(want))
    if kind == "walk":
        assert L.any()


def test_unpack_vector_design_carries_across_windows_and_blocks():
    """bs 12 and 100 (blocks that straddle the 128-value windows of a run),
    132 (a block over two windows) and 512 (four windows, the first of some
    blocks with every L = 0, so its keys reach the next window through the
    skip's carry), L from random codes, against the plain version."""
    rng = np.random.default_rng(5)
    spec = tspecs.F32
    for bs in (12, 100, 132, 512):
        nb = 37
        planes = rng.integers(0, 256, (nb, 4, bs), dtype=np.uint8)
        L = rng.choice(np.array([0, 1, 2, 3], np.uint8), (nb, bs), p=[0.2, 0.2, 0.2, 0.4])
        L[::5] = 0
        L[1::3, :128] = 0
        L[1::3, 128:140] = 3
        nbytes = rng.integers(0, 5, nb).astype(np.int32)
        mu = rng.standard_normal(nb).astype(np.float32)
        shift = rng.integers(0, 8, nb).astype(np.int32)
        args = (torch.from_numpy(mu), torch.from_numpy(shift), torch.from_numpy(nbytes))
        got = _compose(torch.from_numpy(_unpack_vector_emulated(planes, nbytes, L, 3)),
                       *args, spec)
        want = tref.unpack_ref(torch.from_numpy(planes), *args, torch.from_numpy(L), spec)
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# bitshuffle's vector route: 64-bit words, as csrc/bitshuffle.cu writes them
# ---------------------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _transpose_bits(lo, hi):
    """transpose_bits on uint64 arrays holding 32-bit halves."""
    def step(x, s, m):
        t = (x ^ (x >> np.uint64(s))) & np.uint64(m)
        return (x ^ t ^ (t << np.uint64(s))) & M32
    lo, hi = step(lo, 7, 0x00AA00AA), step(hi, 7, 0x00AA00AA)
    lo, hi = step(lo, 14, 0x0000CCCC), step(hi, 14, 0x0000CCCC)
    t = ((lo >> np.uint64(4)) ^ hi) & np.uint64(0x0F0F0F0F)
    return (lo ^ (t << np.uint64(4))) & M32, hi ^ t


def _byte_perm(x, y, s: int):
    """CUDA's __byte_perm: result byte n is byte (s >> 4n) & 7 of {y:x}."""
    both = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for n in range(4):
        sel = np.uint64(((s >> (4 * n)) & 7) * 8)
        out |= ((both >> sel) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out


def _transpose_bytes4(a0, a1, a2, a3):
    p, q = _byte_perm(a0, a1, 0x5140), _byte_perm(a0, a1, 0x7362)
    r, s = _byte_perm(a2, a3, 0x5140), _byte_perm(a2, a3, 0x7362)
    return (_byte_perm(p, r, 0x5410), _byte_perm(p, r, 0x7632),
            _byte_perm(q, s, 0x5410), _byte_perm(q, s, 0x7632))


def _transpose_bytes(lo, hi):
    a = _transpose_bytes4(*lo[:4]) + _transpose_bytes4(*hi[:4])
    b = _transpose_bytes4(*lo[4:]) + _transpose_bytes4(*hi[4:])
    return list(a), list(b)


def _bitshuffle_vector_emulated(tiles: np.ndarray, inverse: bool) -> np.ndarray:
    """csrc/bitshuffle.cu's bitshuffle_vector_kernel: a thread per 64 bytes
    of a tile (every thread of the tensor at once, along axis 0)."""
    nt, T = tiles.shape
    words = tiles.reshape(nt, T // 64, 16, 4).view("<u4")[..., 0].astype(np.uint64)
    out = np.empty_like(tiles)
    if not inverse:
        lo, hi = [words[..., 2 * m] for m in range(8)], [words[..., 2 * m + 1] for m in range(8)]
        lo, hi = zip(*(_transpose_bits(lo[m], hi[m]) for m in range(8)))
        lo, hi = _transpose_bytes(list(lo), list(hi))
        rows = np.stack([lo[k] | (hi[k] << np.uint64(32)) for k in range(8)], axis=1)
        out.reshape(nt, 8, T // 64, 8).view("<u8")[..., 0][:] = rows
    else:
        rows = tiles.reshape(nt, 8, T // 64, 8).view("<u8")[..., 0]
        lo = [rows[:, k] & M32 for k in range(8)]
        hi = [rows[:, k] >> np.uint64(32) for k in range(8)]
        lo, hi = _transpose_bytes(lo, hi)
        lo, hi = zip(*(_transpose_bits(lo[m], hi[m]) for m in range(8)))
        chunk = np.stack([lo[m] | (hi[m] << np.uint64(32)) for m in range(8)], axis=-1)
        out.reshape(nt, T // 64, 8, 8).view("<u8")[..., 0][:] = chunk
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("T", [2048, 4096, 8192])
def test_bitshuffle_vector_design_matches_plain_and_reference(T, inverse):
    tiles = np.random.default_rng(T).integers(0, 256, size=(3, T), dtype=np.uint8)
    tiles[0, :64] = 0xFF                          # an all-ones word and bit patterns
    tiles[1, :8] = 1 << np.arange(8)
    got = _bitshuffle_vector_emulated(tiles, inverse)
    np.testing.assert_array_equal(got, tref.bitshuffle_ref(torch.from_numpy(tiles), inverse))
    want = np.asarray(rbitshuffle.shuffle_body(jnp.asarray(tiles), inverse=inverse))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_bitshuffle_vector_emulated(got, not inverse), tiles)


def test_delta_swaps_transpose_every_single_bit():
    """Each of the 64 bits of a word lands at its transposed place: byte r,
    bit c -> byte c, bit r."""
    x = np.uint64(1) << np.arange(64, dtype=np.uint64)
    lo, hi = _transpose_bits(x & M32, x >> np.uint64(32))
    got = lo | (hi << np.uint64(32))
    r, c = np.arange(64) // 8, np.arange(64) % 8
    np.testing.assert_array_equal(got, np.uint64(1) << (8 * c + r).astype(np.uint64))


# ---------------------------------------------------------------------------
# the route rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [4, 8, 12, 100, 128, 4096])
def test_unpack_blocks_of_a_multiple_of_4_take_the_vector_route(bs):
    planes = torch.zeros((5, 4, bs), dtype=torch.uint8)
    L = torch.zeros((5, bs), dtype=torch.uint8)
    assert tunpack.tensor_route(planes, L) == "vector"
    assert tunpack.tensor_route(planes) == "vector"
    assert tunpack.route(bs, 4096, 4096 + 4) == "vector"


@pytest.mark.parametrize("bs", [1, 2, 3, 6, 97])
def test_unpack_other_blocks_take_the_scalar_route(bs):
    assert tunpack.tensor_route(torch.zeros((5, 4, bs), dtype=torch.uint8)) == "scalar"
    assert tunpack.route(bs, 0, 0) == "scalar" and tunpack.route(bs, 0, None) == "scalar"


def test_unpack_views_off_their_alignment_take_the_scalar_route():
    pbase = torch.zeros(10 * 4 * 128 + 4, dtype=torch.uint8)
    Lbase = torch.zeros(10 * 128 + 4, dtype=torch.uint8)
    planes, L = pbase[4:].view(10, 4, 128), Lbase[4:].view(10, 128)
    assert tunpack.tensor_route(planes, L) == "vector"
    assert tunpack.tensor_route(pbase[1:1 + 5120].view(10, 4, 128), L) == "scalar"
    assert tunpack.tensor_route(planes, Lbase[2:2 + 1280].view(10, 128)) == "scalar"
    assert tunpack.tensor_route(pbase[1:1 + 5120].view(10, 4, 128)) == "scalar"
    assert tunpack.route(128, 2, None) == "scalar" and tunpack.route(128, 4, None) == "vector"
    assert tunpack.route(128, 4, 6) == "scalar"


def test_bitshuffle_route_follows_the_pointer():
    base = torch.zeros(2 * 4096 + 16, dtype=torch.uint8)
    assert tbitshuffle.route(base[16:].data_ptr()) == "vector"
    for off in (1, 4, 8):
        assert tbitshuffle.route(base[off:].data_ptr()) == "scalar"
    assert tbitshuffle.route(0) == "vector"


# ---------------------------------------------------------------------------
# the store's decode: the choice comes from the host's parse
# ---------------------------------------------------------------------------

@pytest.fixture
def spied(monkeypatch):
    """Records each ``Tensor.any()`` (a reduction on the device, then a wait)
    and each wrapper call of the store's kernels with the route the tensors
    it was given would take on the card."""
    seen = {"any": 0, "calls": []}
    real_any = torch.Tensor.any

    def any_spy(self, *a, **k):
        seen["any"] += 1
        return real_any(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "any", any_spy)
    for name in ("unpack", "unpack_dense"):
        real = getattr(tunpack, name)

        def spy(planes, *args, _name=name, _real=real, **kw):
            L = args[3] if _name == "unpack" else None
            seen["calls"].append((_name, tunpack.tensor_route(planes, L)))
            return _real(planes, *args, **kw)

        monkeypatch.setattr(tunpack, name, spy)
    return seen


def _store_array(seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (np.cumsum(rng.standard_normal(64 * 96)) * 0.01).reshape(64, 96).astype(np.float32)
    x[:16] = 0.0                                   # constant blocks
    alt = np.linspace(1.0, 2.0, 96, dtype=np.float32)
    alt[1::2] *= -1.0
    x[16:24] = alt                                 # non-constant blocks, every L = 0
    return x


@pytest.mark.parametrize("stage", [None, "bitshuffle-rle"])
def test_store_reads_and_queries_choose_unpack_on_the_host(spied, stage):
    """ROI reads and the exact query decode with no ``Tensor.any()`` on the
    device's tensors, take both kernels (on the vector route, for their
    tensors' shapes), and agree with the reference's values."""
    from repro.store import ArrayStore as RStore

    x = _store_array()
    buf = io.BytesIO()
    ArrayStore.save(buf, torch.from_numpy(x), Bound.abs(1e-3), chunk_shape=(16, 96),
                    block_size=32, stage=stage, device="cpu")
    ca = ArrayStore.open(io.BytesIO(buf.getvalue()), device="cpu")
    ref = RStore.open(io.BytesIO(buf.getvalue()))
    spied["any"] = 0
    keys = (np.s_[...], np.s_[3:20, 5:70], np.s_[17, 9], np.s_[40:64])
    for key in keys:
        np.testing.assert_array_equal(_bits(ca[key]), _bits(np.asarray(ref[key])))
    st = ca.stats()
    want = ref.stats()
    assert st.exact and (st.min, st.max, st.count) == (want.min, want.max, want.count)
    assert spied["any"] == 0
    kinds = {name for name, _ in spied["calls"]}
    assert kinds == {"unpack", "unpack_dense"}
    assert {r for _, r in spied["calls"]} == {"vector"}


def test_decode_blocks_without_host_flags_still_asks_the_device(spied):
    """An encoding made on the device has no host flags: the old check stays,
    and both choices give the plain version's values."""
    x, e = _blocks(np.dtype(np.float32), "mixed", 24, 64, 1)
    enc = transform.BlockEncoding(*tref.encode_ref(torch.from_numpy(x), e, tspecs.F32,
                                                   tspecs.exact_exponent_of(e)))
    assert enc.elided is None
    p = container.plan_mod.plan_for_stream(0, 64, x.size, e)
    spied["any"] = 0
    got = transform.decode_blocks(enc, p)
    assert spied["any"] == 1
    want = tref.unpack_ref(enc.planes, enc.mu, enc.shift, enc.nbytes, enc.L, tspecs.F32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    dense = transform.decode_block_range(enc, p, 0, 1)     # block 0: every L = 0
    np.testing.assert_array_equal(_bits(dense), _bits(want[:1]))
    assert spied["calls"][-1][0] == "unpack_dense"
    flags = enc.L.numpy().any(axis=1)
    spied["any"] = 0
    part = tops.unpack_range(enc.planes, enc.mu, enc.shift, enc.nbytes, enc.L, 2, 9,
                             elided=flags)
    assert spied["any"] == 0
    np.testing.assert_array_equal(_bits(part), _bits(want[2:9]))
