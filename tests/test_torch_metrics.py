"""``repro_torch.core.metrics`` against ``repro.core.metrics``.

Same numpy inputs (seeded) through both; the port computes in float64 with
torch's sums, numpy with its pairwise ones, so the results agree to 1e-12
relative, not bit for bit.  Covers numpy arrays and CPU tensors of several
dtypes, a constant field (ssim 1), an exact reconstruction (psnr inf) and a
length that leaves a partial ssim window.
"""
import numpy as np
import pytest
import torch

from repro.core import metrics as RM
from repro_torch.core import metrics as M

RTOL = 1e-12


def _fields(n, seed=0, noise=1e-3):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(n)).astype(np.float32)
    y = (x + rng.uniform(-noise, noise, n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("n", [4096, 1001])
@pytest.mark.parametrize("fn", ["psnr", "ssim", "max_abs_error"])
def test_matches_the_reference(fn, n, as_tensor):
    x, y = _fields(n, seed=n)
    want = getattr(RM, fn)(x, y)
    args = (torch.from_numpy(x), torch.from_numpy(y)) if as_tensor else (x, y)
    got = getattr(M, fn)(*args)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16])
def test_other_dtypes_compute_in_float64(dtype):
    x, y = _fields(2048, seed=3, noise=0.05)
    xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)
    xn, yn = xt.to(torch.float64).numpy(), yt.to(torch.float64).numpy()
    for fn in ("psnr", "ssim", "max_abs_error"):
        np.testing.assert_allclose(getattr(M, fn)(xt, yt), getattr(RM, fn)(xn, yn), rtol=RTOL)


def test_edge_cases():
    x, _ = _fields(700, seed=1)
    assert M.psnr(x, x) == RM.psnr(x, x) == float("inf")
    assert M.max_abs_error(torch.from_numpy(x), x) == RM.max_abs_error(x, x) == 0.0
    const = np.full((9, 9), 2.5, np.float32)
    assert M.ssim(const, const + 1) == RM.ssim(const, const + 1) == 1.0
    np.testing.assert_allclose(M.ssim(x.reshape(7, 100), x[::-1].copy(), window=5),
                               RM.ssim(x.reshape(7, 100), x[::-1].copy(), window=5), rtol=RTOL)
    assert M.compression_ratio(1000, 7) == RM.compression_ratio(1000, 7)
    assert M.compression_ratio(1000, 0) == RM.compression_ratio(1000, 0) == 1000.0
