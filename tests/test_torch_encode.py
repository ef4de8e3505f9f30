"""repro_torch fused encode against the JAX package's (bit-identical).

The port's plain encode (the CPU route of ``kernels.encode.encode``) is held
against the Pallas kernel ``repro.kernels.encode.encode`` in interpret mode
for f32/f16/bf16, and against the numpy mirror ``ops._encode_np`` for f64
(the reference's x64 route is broken under the installed jax).  All seven
outputs are compared, at the shapes of tests/test_width_generic.py and at
edge block sizes.  The CUDA kernel is compared with the plain version on the
card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import encode as rencode, ops as rops, specs as rspecs
from repro_torch.kernels import encode as tencode, ops as tops, ref as tref, specs as tspecs

BF16 = np.dtype(ml_dtypes.bfloat16)
NAMES = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")
# (nb, bs, e, seed, scale): the encode shapes of tests/test_width_generic.py
SHAPES = [(17, 64, 1e-3, 2, 0.01), (9, 128, 1e-2, 3, 0.1), (23, 64, 1e-2, 7, 0.01)]


def _field(n, dtype, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t) -> np.ndarray:
    """Values of a torch output, floats as their bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        return t.numpy()
    a = np.asarray(t)
    return a.view(f"<i{a.itemsize}") if a.dtype.kind == "f" or a.dtype == BF16 else a


def _assert_outputs_equal(port, ref, where):
    for name, a, b in zip(NAMES, port, ref):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, f"{where}: {name} shape {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{where}: {name}")


def _port_encode(x: np.ndarray, e: float):
    spec = tspecs.spec_for(x.dtype)
    return tencode.encode(_tensor(x), e, tspecs.exact_exponent_of(e), spec=spec)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [np.float32, np.float16, BF16],
                         ids=["float32", "float16", "bfloat16"])
def test_plain_encode_matches_pallas_kernel(dtype, shape):
    nb, bs, e, seed, scale = shape
    x = _field(nb * bs, dtype, seed=seed, scale=scale).reshape(nb, bs)
    rspec = rspecs.spec_for(np.dtype(dtype))
    ref = rencode.encode(
        jnp.asarray(x), jnp.asarray(e, rspec.compute_np_dtype),
        jnp.int32(rspecs.exact_exponent_of(e)), spec=rspec, interpret=True,
    )
    _assert_outputs_equal(_port_encode(x, e), ref, f"{np.dtype(dtype).name} {nb}x{bs}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_encode_f64_matches_numpy_mirror(shape):
    nb, bs, e, seed, scale = shape
    x = _field(nb * bs, np.float64, seed=seed, scale=scale).reshape(nb, bs)
    ref = rops._encode_np(x, e, rspecs.F64)
    _assert_outputs_equal(_port_encode(x, e), ref, f"float64 {nb}x{bs}")


@pytest.mark.parametrize("bs", [1, 100, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, BF16],
                         ids=["float32", "float64", "float16", "bfloat16"])
def test_plain_encode_edge_block_sizes(dtype, bs):
    nb = max(8192 // bs, 2)
    x = _field(nb * bs, dtype, seed=bs, scale=0.05).reshape(nb, bs)
    for e in (1e-3, 0.5):
        ref = rops._encode_np(x, e, rspecs.spec_for(np.dtype(dtype)))
        _assert_outputs_equal(_port_encode(x, e), ref, f"{np.dtype(dtype).name} bs={bs} e={e}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, BF16],
                         ids=["float32", "float64", "float16", "bfloat16"])
def test_plain_encode_constant_and_verbatim_blocks(dtype):
    rspec = rspecs.spec_for(np.dtype(dtype))
    const = np.full((4, 64), 2.5).astype(dtype)
    walk = _field(4 * 64, dtype, seed=4, scale=1.0).reshape(4, 64)
    alt = np.linspace(1.0, 2.0, 4 * 64)
    alt[1::2] *= -1.0                         # every L == 0
    for x, e in ((const, 1e-3), (walk, float(torch.finfo(_tensor(walk).dtype).tiny)),
                 (alt.astype(dtype).reshape(4, 64), 1e-3)):
        ref = rops._encode_np(x, e, rspec)
        _assert_outputs_equal(_port_encode(x, e), ref, np.dtype(dtype).name)


def test_f16_const_test_guards_subtraction_rounding():
    """The 16-bit next-up radius guard (tests/test_width_generic.py's
    fixture): e set exactly AT the f32-rounded radius must not make the
    block constant."""
    x = np.array([[-1.751e-03, 2554.0]], np.float16)
    mn, mx = (float(v) for v in x[0].astype(np.float64))
    mu = float(np.float16(np.float32(0.5) * (np.float32(mn) + np.float32(mx))))
    e = float(max(np.float32(mx) - np.float32(mu), np.float32(mu) - np.float32(mn)))
    port = _port_encode(x, e)
    assert not bool(port[1][0])
    _assert_outputs_equal(port, rops._encode_np(x, e, rspecs.F16), "f16 guard")


def test_cpu_route_takes_the_plain_version_without_counting():
    tops.reset_launch_counts()
    x = _field(4 * 32, np.float32).reshape(4, 32)
    a = _port_encode(x, 1e-3)
    b = tref.encode_ref(_tensor(x), 1e-3, tspecs.F32, tspecs.exact_exponent_of(1e-3))
    _assert_outputs_equal(a, b, "cpu route")
    assert tops.launch_counts()["encode"] == 0

