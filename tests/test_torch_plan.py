"""repro_torch plan layer against the JAX package's plan (bit-identical).

The port's plans (dtype code, element count, block geometry and the
resolved absolute bound) and padded blocks must equal
``repro.core.codec.plan`` for every dtype, bound mode and block size,
including an all-constant input (the ``rel`` tiny fallback).
"""
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.codec import plan as rplan
from repro_torch.core.codec import plan as tplan
from repro_torch.kernels import specs as tspecs

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16]
IDS = [d.name for d in DTYPES]


def _field(n, dtype, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(n)) * scale).astype(dtype)


def _bits(a) -> np.ndarray:
    """Bits of a numpy array or torch tensor as same-width signed ints."""
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]).numpy()
    return np.asarray(a).view(f"<i{np.asarray(a).itemsize}")


def _assert_same_plan(tp, rp):
    assert (tp.dtype.code, tp.n, tp.block_size, tp.nblocks) == (
        rp.dtype.code, rp.n, rp.block_size, rp.nblocks)
    assert tp.error_bound == rp.error_bound
    assert tp.raw_bytes == rp.raw_bytes
    for f in ("name", "itemsize", "exp_bits", "mant_bits", "exp_bias", "lead_cap",
              "compute_mant_bits", "compute_exp_bits", "compute_exp_bias",
              "stats_rounding_guard"):
        assert getattr(tp.dtype, f) == getattr(rp.dtype, f), f


@pytest.mark.parametrize("bs", [1, 32, 100, 128, 4096])
@pytest.mark.parametrize("mode", ["abs", "rel"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_plan_matches_reference(dtype, mode, bs):
    x = _field(5003, dtype, seed=bs)
    rp, rx = rplan.make_plan(x, rplan.Bound(1e-3, mode), block_size=bs, backend="numpy")
    tp, tx = tplan.make_plan(x, tplan.Bound(1e-3, mode), block_size=bs, device="cpu")
    _assert_same_plan(tp, rp)
    np.testing.assert_array_equal(_bits(tplan.to_blocks(tx, tp)),
                                  _bits(rplan.to_blocks(rx, rp)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_plan_all_constant_input(dtype):
    x = np.full(1000, 7.5).astype(dtype)
    for mode in ("abs", "rel"):            # rel: zero range -> finfo.tiny
        rp, _ = rplan.make_plan(x, rplan.Bound(1e-3, mode), backend="numpy")
        tp, _ = tplan.make_plan(x, tplan.Bound(1e-3, mode), device="cpu")
        _assert_same_plan(tp, rp)
    assert tp.error_bound == float(rplan.finfo(dtype).tiny)


def test_plan_takes_tensors_and_forced_dtype():
    x = _field(999, np.float64, seed=3)
    rp, rx = rplan.make_plan(x, 1e-2, dtype=np.float32, backend="numpy")
    tp, tx = tplan.make_plan(torch.from_numpy(x), 1e-2, dtype=torch.float32, device="cpu")
    _assert_same_plan(tp, rp)
    np.testing.assert_array_equal(_bits(tx), _bits(rx))
    tp2, _ = tplan.make_plan(x, 1e-2, dtype="float32", device="cpu")
    assert tp2 == tp


def test_plan_empty_input_and_stream_plan():
    for n in (0, 1, 127, 128, 129):
        x = _field(n, np.float32)
        rp, _ = rplan.make_plan(x, 1e-3, backend="numpy")
        tp, tx = tplan.make_plan(x, 1e-3, device="cpu")
        _assert_same_plan(tp, rp)
        assert tuple(tplan.to_blocks(tx, tp).shape) == (tp.nblocks, 128)
        sp = tplan.plan_for_stream(0, 128, n, 1e-3)
        _assert_same_plan(sp, rplan.plan_for_stream(0, 128, n, 1e-3, "numpy"))


def test_plan_rejects_bad_inputs():
    with pytest.raises(TypeError, match="SZx compresses float arrays"):
        tplan.make_plan(np.arange(10), 1e-3, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        tplan.make_plan(np.zeros(10, np.float32), 1e-3, block_size=0, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        tplan.make_plan(np.zeros(10, np.float32), 1e-3, block_size=1 << 16, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tplan.Bound(0.0)
    with pytest.raises(ValueError, match="unknown bound mode"):
        tplan.Bound(1.0, "pct")
    with pytest.raises(ValueError, match="unknown dtype code"):
        tplan.spec_for_code(9)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tspecs.spec_for(torch.int32)


def test_bound_parse_and_legacy_kwargs():
    for text in ("1e-3", "abs:1e-3", "rel:1e-4", " rel : 2 "):
        r, t = rplan.Bound.parse(text), tplan.Bound.parse(text)
        assert (r.value, r.mode, str(r)) == (t.value, t.mode, str(t))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b = tplan.as_bound(error_bound=1e-3, mode="rel")
        assert b == tplan.Bound.rel(1e-3)
        assert tplan.as_bound(1e-3, "abs") == tplan.Bound.abs(1e-3)
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 2
    assert tplan.as_bound(2.0) == tplan.Bound.abs(2.0)
    with pytest.raises(TypeError):
        tplan.as_bound(None)
    with pytest.raises(TypeError):
        tplan.as_bound(tplan.Bound.abs(1.0), "rel")


def test_chunk_elements_and_exponent_match_reference():
    for bs, chunk, item in ((128, 1 << 20, 4), (100, 12345, 8), (4096, 100, 2), (1, 7, 2)):
        assert tplan.chunk_elements(bs, chunk, item) == rplan.chunk_elements(bs, chunk, item)
    for e in (1e-3, 0.5, 1.0, 3.0, 1e-300, float(np.finfo(np.float32).tiny)):
        assert tspecs.exact_exponent_of(e) == rplan.exact_exponent_of(e)


def test_specs_match_reference_table():
    from repro.kernels import specs as rspecs

    for ts in tspecs.SPECS:
        rs = rspecs.spec_for_code(ts.code)
        assert (ts.name, ts.itemsize, ts.exp_bits, ts.mant_bits, ts.exp_bias) == (
            rs.name, rs.itemsize, rs.exp_bits, rs.mant_bits, rs.exp_bias)
        assert tspecs.spec_for(rs.np_dtype) is ts      # numpy dtypes, bf16 by name
        assert tspecs.spec_for(ts.dtype) is ts
        assert torch.finfo(ts.dtype).tiny == float(rplan.finfo(rs.np_dtype).tiny)
