"""repro_torch's two-call encode (``ops.block_stats`` + ``ops.pack``) against
the JAX package's (bit-identical).

The port's CPU route (the plain versions ``ref.block_stats_ref`` and
``ref.pack_ref``) is held against the reference's ``ops.block_stats`` /
``ops.pack`` with ``backend="numpy"`` for f32/f64/f16/bf16 and with
``backend="kernel"`` (the Pallas kernels in interpret mode) for
f32/f16/bf16; the reference's f64 kernel route imports the removed
``jax.experimental.enable_x64``.  Every output is compared bit for bit (a
NaN radius by position: NaN payloads of a subtraction are the host's).
The CUDA kernels are held to the plain versions by tests/test_torch_cuda.py
and chip_smoke.py on the card.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops, specs as rspecs
from repro_torch.kernels import ops as tops, specs as tspecs

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.float32, np.float64, np.float16, BF16]
IDS = ["float32", "float64", "float16", "bfloat16"]
STATS = ("mu", "radius", "const", "reqlen", "shift", "nbytes")
PACK = ("planes", "L", "mid")
FUSED = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")


def _field(n, dtype, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _np(t) -> np.ndarray:
    """Values of an output as numpy; floats as their bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        return t.numpy()
    a = np.asarray(t)
    return a.view(f"<i{a.itemsize}") if a.dtype.kind == "f" or a.dtype == BF16 else a


def _isnan(t) -> np.ndarray:
    a = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
    return np.isnan(a)


def _assert_equal(port, ref, names, where):
    assert len(port) == len(ref) == len(names)
    for name, a, b in zip(names, port, ref):
        if name == "radius":
            nan_a, nan_b = _isnan(a), _isnan(b)
            np.testing.assert_array_equal(nan_a, nan_b, err_msg=f"{where}: radius NaN")
            a, b = _np(a)[~nan_a], _np(b)[~nan_b]
        else:
            a, b = _np(a), _np(b)
        assert a.shape == b.shape, f"{where}: {name} shape {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{where}: {name}")


def _two_call(x: np.ndarray, e: float, backend: str):
    """Both packages' two-call encode of the same blocks."""
    rspec = rspecs.spec_for(np.dtype(x.dtype))
    tspec = tspecs.spec_for(_tensor(x).dtype)
    ref_stats = [np.asarray(a) for a in rops.block_stats(x, e, spec=rspec, backend=backend)]
    mu, _r, _c, _rq, shift, nbytes = ref_stats
    ref_pack = [np.asarray(a) for a in rops.pack(x, mu, shift, nbytes, spec=rspec,
                                                  backend=backend)]
    port_stats = tops.block_stats(_tensor(x), e, spec=tspec)
    pmu, _pr, _pc, _prq, pshift, pnbytes = port_stats
    port_pack = tops.pack(_tensor(x), pmu, pshift, pnbytes, spec=tspec)
    return port_stats, port_pack, ref_stats, ref_pack


def _check(x, e, backend, where):
    port_stats, port_pack, ref_stats, ref_pack = _two_call(x, e, backend)
    _assert_equal(port_stats, ref_stats, STATS, f"{where} block_stats")
    _assert_equal(port_pack, ref_pack, PACK, f"{where} pack")
    return port_stats, port_pack


@pytest.mark.parametrize("bs", [1, 3, 64, 128, 4096])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_two_call_matches_numpy_backend(dtype, bs):
    nb = max(8192 // bs, 3)
    x = _field(nb * bs, dtype, seed=bs, scale=0.05).reshape(nb, bs)
    for e in (1e-3, 0.5):
        stats, pk = _check(x, e, "numpy", f"{np.dtype(dtype).name} bs={bs} e={e}")
        assert stats[1].dtype == tspecs.spec_for(_tensor(x).dtype).compute_dtype
        assert stats[2].dtype == torch.bool
        assert pk[1].dtype == pk[2].dtype == torch.int32


@pytest.mark.parametrize("shape", [(17, 64, 1e-3), (9, 128, 1e-2), (5, 3, 1e-3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [np.float32, np.float16, BF16],
                         ids=["float32", "float16", "bfloat16"])
def test_two_call_matches_pallas_kernels(dtype, shape):
    nb, bs, e = shape
    x = _field(nb * bs, dtype, seed=nb, scale=0.01).reshape(nb, bs)
    _check(x, e, "kernel", f"{np.dtype(dtype).name} {nb}x{bs} interpret")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_two_call_equals_fused_encode(dtype):
    """The reference's invariant: (mu, const, reqlen, shift, nbytes, planes,
    L) of the two calls equal the fused encode's."""
    x = _field(9 * 128, dtype, seed=3).reshape(9, 128)
    t = _tensor(x)
    spec = tspecs.spec_for(t.dtype)
    for e in (1e-2, 1e-4):
        mu, _r, const, reqlen, shift, nbytes = tops.block_stats(t, e, spec=spec)
        planes, L, _mid = tops.pack(t, mu, shift, nbytes, spec=spec)
        fused = tops.encode_staged(t, e, tspecs.exact_exponent_of(e), spec=spec)
        _assert_equal((mu, const, reqlen, shift, nbytes, planes, L), fused, FUSED,
                      f"{np.dtype(dtype).name} e={e} fused")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_pack_with_zero_shift_matches_numpy_backend(dtype):
    """The paper's Fig. 6 analysis packs with the caller's shift = 0 (the
    unshifted words of Solution B); pack must not recompute it."""
    x = _field(33 * 128, dtype, seed=6, scale=0.05).reshape(33, 128)
    rspec = rspecs.spec_for(np.dtype(dtype))
    mu, _r, _c, _rq, shift, nbytes = [np.asarray(a) for a in
                                      rops.block_stats(x, 0.05, spec=rspec, backend="numpy")]
    assert shift.any()
    zero = np.zeros_like(shift)
    ref = rops.pack(x, mu, zero, nbytes, spec=rspec, backend="numpy")
    port = tops.pack(_tensor(x), _tensor(mu), torch.from_numpy(zero),
                     torch.from_numpy(nbytes), spec=tspecs.spec_for(_tensor(x).dtype))
    _assert_equal(port, ref, PACK, f"{np.dtype(dtype).name} shift=0")
    shifted = tops.pack(_tensor(x), _tensor(mu), torch.from_numpy(shift),
                        torch.from_numpy(nbytes), spec=tspecs.spec_for(_tensor(x).dtype))
    assert not torch.equal(port[0], shifted[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_two_call_special_blocks(dtype):
    """Constant blocks, verbatim blocks (req_m_raw > mant_bits zeroes mu),
    NaN/inf blocks and blocks of zeros of both signs (mu carries the last
    value's sign)."""
    t = _tensor(np.zeros(1, dtype))
    tiny = float(torch.finfo(t.dtype).tiny)
    walk = _field(6 * 64, dtype, seed=4, scale=1.0).reshape(6, 64)
    _check(np.full((4, 64), 2.5).astype(dtype), 1e-3, "numpy", "constant")
    stats, _ = _check(walk, tiny, "numpy", "verbatim")
    assert not _np(stats[0]).any()                   # mu zeroed for every block
    odd = walk.astype(np.float64)
    odd[0, 3] = np.nan
    odd[1, 5] = np.inf
    odd[2, 7] = -np.inf
    odd[3, :] = np.inf
    _check(odd.astype(dtype), 1e-3, "numpy", "NaN/inf")
    zeros = np.zeros((6, 8))
    zeros[0, -1] = -0.0
    zeros[1, ::2] = -0.0
    zeros[2, :-1] = -0.0
    zeros[3, :] = -0.0
    stats, _ = _check(zeros.astype(dtype), 1e-3, "numpy", "signed zeros")
    signs = np.signbit(_tensor(zeros.astype(dtype))[:, -1].float().numpy())
    np.testing.assert_array_equal(np.signbit(stats[0].float().numpy()), signs)


def test_f16_stats_rounding_guard():
    """e set exactly AT the f32-rounded radius of a 16-bit block must not
    make it constant (the next-up radius test)."""
    x = np.array([[-1.751e-03, 2554.0]], np.float16)
    mn, mx = (float(v) for v in x[0].astype(np.float64))
    mu = float(np.float16(np.float32(0.5) * (np.float32(mn) + np.float32(mx))))
    e = float(max(np.float32(mx) - np.float32(mu), np.float32(mu) - np.float32(mn)))
    stats, _ = _check(x, e, "numpy", "f16 guard")
    assert not bool(stats[2][0])


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_two_call_empty(dtype):
    x = np.zeros((0, 128), dtype)
    t = _tensor(x)
    spec = tspecs.spec_for(t.dtype)
    stats = tops.block_stats(t, 1e-3, spec=spec)
    assert [tuple(a.shape) for a in stats] == [(0,)] * 6
    planes, L, mid = tops.pack(t, stats[0], stats[4], stats[5], spec=spec)
    assert planes.shape == (0, spec.itemsize, 128) and planes.dtype == torch.uint8
    assert L.shape == mid.shape == (0, 128) and L.dtype == mid.dtype == torch.int32


def test_cpu_route_launches_no_kernel():
    tops.reset_launch_counts()
    x = _tensor(_field(4 * 32, np.float32).reshape(4, 32))
    mu, _r, _c, _rq, shift, nbytes = tops.block_stats(x, 1e-3)
    tops.pack(x, mu, shift, nbytes)
    counts = tops.launch_counts()
    assert counts["block_stats"] == counts["pack"] == 0
