"""repro_torch unpack, unpack_dense, unpack_range and bitshuffle against the
JAX package's (bit-identical), plus blocks of zeros of both signs.

The port's plain versions (the CPU route of ``kernels.unpack`` and
``kernels.bitshuffle``) are held to ``repro.kernels.ops`` with
``backend="numpy"`` for all four dtypes, and to the Pallas kernels in
interpret mode where the installed jax runs them (f32/f16/bf16; the
reference's f64 kernel route is broken under this jax).  The CUDA kernels
are compared with the plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.codec import SZxCodec as RCodec
from repro.kernels import ops as rops, specs as rspecs
from repro.kernels import unpack as runpack
from repro.kernels.bitshuffle import tile_bytes as rtile_bytes
from repro_torch.core.codec import SZxCodec
from repro_torch.kernels import bitshuffle as tbitshuffle, ops as tops, ref as tref
from repro_torch.kernels import specs as tspecs, unpack as tunpack

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]
NB, BS = 48, 64


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view(f"<i{a.itemsize}")


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy array (bfloat16 included) -> CPU tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(dtype, kind: str):
    """(x (NB, BS), e) of one input kind, made with numpy from a seed."""
    rng = np.random.default_rng(7)
    walk = np.cumsum(rng.standard_normal(NB * BS)) * 0.01
    e = 1e-3 if dtype.itemsize >= 4 else 1e-2
    if kind == "alternating":                       # every L = 0
        walk = np.linspace(1.0, 2.0, NB * BS)
        walk[1::2] *= -1.0
    elif kind == "verbatim":
        walk, e = walk * 100, float(np.finfo(np.float32).tiny)
    elif kind == "nonfinite":
        walk[::97], walk[5::193], walk[7::291] = np.nan, np.inf, -np.inf
    elif kind == "signed_zeros":
        walk = walk.reshape(NB, BS)
        walk[1::3] = np.where(rng.integers(0, 2, (len(walk[1::3]), BS)) == 1, -0.0, 0.0)
    return walk.reshape(NB, BS).astype(dtype), e


KINDS = ["walk", "alternating", "verbatim", "nonfinite", "signed_zeros"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_unpack_matches_reference(dtype, kind):
    x, e = _inputs(dtype, kind)
    rspec = rspecs.spec_for(dtype)
    tspec = tspecs.spec_for(dtype)
    mu, _c, _r, shift, nbytes, planes, L = (np.asarray(a) for a in
                                            rops.encode(x, e, spec=rspec, backend="numpy"))
    want = rops.unpack(planes, mu, shift, nbytes, L, spec=rspec, backend="numpy")
    args = (torch.from_numpy(planes), _tensor(mu), torch.from_numpy(shift.astype(np.int32)),
            torch.from_numpy(nbytes.astype(np.int32)))
    got = tunpack.unpack(*args, torch.from_numpy(L.astype(np.uint8)), spec=tspec)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    dense = tunpack.unpack_dense(*args, spec=tspec)
    want_dense = rops.unpack_dense(planes, mu, shift, nbytes, spec=rspec, backend="numpy")
    np.testing.assert_array_equal(_bits(dense), _bits(want_dense))
    if kind == "alternating":
        assert not L.any()
        np.testing.assert_array_equal(_bits(dense), _bits(got))
    for lo, hi in ((0, NB), (3, 17), (NB - 1, NB)):
        part = tops.unpack_range(*args, torch.from_numpy(L.astype(np.int32)), lo, hi, spec=tspec)
        want_part = rops.unpack_range(planes, mu, shift, nbytes, L, lo, hi, spec=rspec,
                                      backend="numpy")
        np.testing.assert_array_equal(_bits(part), _bits(want_part))
    if dtype != np.float64:                          # the Pallas kernels, interpret mode
        jargs = (jnp.asarray(planes), jnp.asarray(mu), jnp.asarray(shift, jnp.int32),
                 jnp.asarray(nbytes, jnp.int32))
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(runpack.unpack(
            *jargs, jnp.asarray(L, jnp.int32), spec=rspec, interpret=True))))
        np.testing.assert_array_equal(_bits(dense), _bits(np.asarray(runpack.unpack_dense(
            *jargs, spec=rspec, interpret=True))))


def test_unpack_range_rejects_bad_ranges():
    x, e = _inputs(np.dtype(np.float32), "walk")
    enc = tref.encode_ref(torch.from_numpy(x), e, tspecs.F32, tspecs.exact_exponent_of(e))
    mu, _c, _r, shift, nbytes, planes, L = enc
    for lo, hi in ((5, 5), (-1, 3), (0, NB + 1)):
        with pytest.raises(ValueError, match="out of"):
            tops.unpack_range(planes, mu, shift, nbytes, L, lo, hi)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_bitshuffle_matches_reference(dtype):
    rspec = rspecs.spec_for(dtype)
    tspec = tspecs.spec_for(dtype)
    T = tspecs.tile_bytes(tspec)
    assert T == rtile_bytes(rspec) == tspecs.TILE_VALUES * dtype.itemsize
    tiles = np.random.default_rng(3).integers(0, 256, size=(5, T), dtype=np.uint8)
    for inverse in (False, True):
        got = tops.bitshuffle(torch.from_numpy(tiles), spec=tspec, inverse=inverse).numpy()
        for backend in ("numpy", "kernel"):
            want = np.asarray(rops.bitshuffle(tiles, spec=rspec, inverse=inverse,
                                              backend=backend))
            np.testing.assert_array_equal(got, want)
    back = tops.bitshuffle(tops.bitshuffle(torch.from_numpy(tiles), spec=tspec),
                           spec=tspec, inverse=True)
    np.testing.assert_array_equal(back.numpy(), tiles)
    assert tops.bitshuffle(torch.zeros((0, T), dtype=torch.uint8), spec=tspec).shape == (0, T)
    with pytest.raises(ValueError, match="tile width"):
        tops.bitshuffle(torch.zeros((1, T // 2), dtype=torch.uint8), spec=tspec)


def test_bitshuffle_groups_bitplanes():
    """A tile whose bytes all hold only bit 5 shuffles into one all-ones bit
    row (row 5) and zeros elsewhere."""
    T = tspecs.tile_bytes(tspecs.F32)
    out = tops.bitshuffle(torch.full((1, T), 1 << 5, dtype=torch.uint8), spec=tspecs.F32)
    rows = out.reshape(8, T // 8)
    assert bool((rows[5] == 0xFF).all()) and int(rows.sum()) == 0xFF * (T // 8)


def test_wrappers_take_the_plain_version_for_cpu_tensors_only():
    """The route follows the tensor's device: a CPU tensor runs the plain
    version (and launches nothing); any other device is refused."""
    tops.reset_launch_counts()
    x, e = _inputs(np.dtype(np.float32), "walk")
    mu, _c, _r, shift, nbytes, planes, L = tref.encode_ref(
        torch.from_numpy(x), e, tspecs.F32, tspecs.exact_exponent_of(e))
    tops.unpack(planes, mu, shift, nbytes, L)
    tops.unpack_dense(planes, mu, shift, nbytes)
    tops.bitshuffle(torch.zeros((2, 4096), dtype=torch.uint8))
    assert set(tops.launch_counts().values()) == {0}
    meta = torch.empty((2, 4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tunpack.unpack_dense(meta, mu[:2], shift[:2], nbytes[:2])
    with pytest.raises(ValueError, match="unsupported device"):
        tbitshuffle.bitshuffle(torch.empty((1, 4096), dtype=torch.uint8, device="meta"))


# ---------------------------------------------------------------------------
# blocks of zeros of both signs: the port's mu is the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [1, 2, 3, 8, 100, 128])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_signed_zero_blocks_match_reference(dtype, bs):
    """Blocks holding only +0.0 and -0.0, mixed with ordinary blocks: the
    stream bytes (each block's stored mu, sign included) equal the
    reference's, through the plain encode on the CPU."""
    rng = np.random.default_rng(bs)
    nb = 60
    x = np.where(rng.integers(0, 2, (nb, bs)) == 1, -0.0, 0.0)
    x[::4] = rng.standard_normal((len(x[::4]), bs))
    x[1::9] = -0.0
    x[2::9] = 0.0
    x = x.reshape(-1).astype(dtype)
    e = 1e-3 if dtype.itemsize >= 4 else 1e-2
    want = RCodec(block_size=bs, backend="numpy").compress(x, e)
    assert SZxCodec(bs, "cpu").compress(_tensor(x), e) == want
    assert SZxCodec(bs, "cpu").compress(x, e) == want
