"""The szx-planes kernels' two routes, decided on the CPU.

``kernels/planes.py::route`` picks the vector or the scalar kernel from the
block width and the pointers' alignment alone; these tests hold the rule,
show that the main paths (the gradient collectives at block 64, the KV cache
at head_dim 64) hand the kernels tensors that take the vector route, and
emulate the vector encode's ordered integer keys (``csrc/planes.cu``,
``key_of``/``value_of``) in torch: their min and max must be the reference's
``jnp.min``/``jnp.max`` of the flushed values, and give the plain version's
mu.  On the CPU the wrappers run the plain versions, so the main-path tests
spy on those and ask the route of each tensor they are given.  The kernels
themselves are held to the plain versions on the card by
tests/test_torch_cuda.py::test_planes_kernels_match_plain.
"""
import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import grad_compress as tgc
from repro_torch.kernels import ops, planes as tkplanes, ref as tref
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

VECTOR_BS = [4, 8, 16, 32, 64, 128, 4096]
SCALAR_BS = [1, 3, 6]


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]


def _edge_blocks(bs: int) -> np.ndarray:
    """chip_smoke.py's planes_edge_blocks rows: constant blocks, signed zeros,
    subnormals, tiny radius, NaN with payloads, +-inf, +-3.4e38."""
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


def _special_values(seed: int) -> np.ndarray:
    """Random blocks of signed zeros, subnormals of both signs, +-FLT_MIN,
    +-inf, +-3.4e38 and normal values, in every order."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, 1.1754944e-38, -1.1754944e-38,
                     np.inf, -np.inf, 3.4e38, -3.4e38, 1.0, -1.0, 2.5e-3, -7.0], np.float32)
    return rng.choice(pool, (4000, 8))


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


# the vector encode's keys, as csrc/planes.cu writes them in 32-bit integers
def _key_of(f: torch.Tensor) -> torch.Tensor:
    b = f.view(torch.int32)
    return b ^ ((b >> 31) | torch.iinfo(torch.int32).min)


def _value_of(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((~k >> 31) | torch.iinfo(torch.int32).min)).view(torch.float32)


def _unsigned(k: torch.Tensor) -> torch.Tensor:       # the kernel compares keys unsigned
    return k.to(torch.int64) & 0xFFFFFFFF


def _key_min_max(xf: torch.Tensor):
    u = _unsigned(_key_of(xf))
    back = lambda v: _value_of((v - (v >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32))
    return back(u.amin(-1)), back(u.amax(-1))


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", VECTOR_BS)
def test_power_of_two_blocks_take_the_vector_route(bs):
    x = torch.zeros((3, 5, bs))
    assert tkplanes.encode_route(x) == "vector"
    assert tkplanes.decode_route(torch.zeros((2, 3, 5, bs), dtype=torch.uint8)) == "vector"
    assert tkplanes.route(bs, 0, 0) == "vector"
    assert tkplanes.route(bs, 4096, 4096 + min(bs, 16)) == "vector"


@pytest.mark.parametrize("bs", SCALAR_BS)
def test_other_blocks_take_the_scalar_route(bs):
    assert tkplanes.encode_route(torch.zeros((7, bs))) == "scalar"
    assert tkplanes.decode_route(torch.zeros((1, 7, bs), dtype=torch.uint8)) == "scalar"
    assert tkplanes.route(bs, 0, 0) == "scalar"


def test_views_off_their_alignment_take_the_scalar_route():
    base = torch.zeros(64 * 100 + 4)
    assert tkplanes.encode_route(base[1:1 + 6400].reshape(100, 64)) == "scalar"
    assert tkplanes.encode_route(base[4:].reshape(100, 64)) == "vector"      # 16 bytes in
    pbase = torch.zeros(2 * 100 * 64 + 16, dtype=torch.uint8)
    assert tkplanes.decode_route(pbase[1:1 + 12800].reshape(2, 100, 64)) == "scalar"
    assert tkplanes.decode_route(pbase[16:].reshape(2, 100, 64)) == "vector"
    # the planes need min(bs, 16) bytes: 4 for bs 4, 16 for bs 16 and up
    assert tkplanes.route(4, 0, 4) == "vector" and tkplanes.route(16, 0, 4) == "scalar"
    assert tkplanes.route(8, 0, 8) == "vector" and tkplanes.route(8, 0, 4) == "scalar"
    assert tkplanes.route(64, 8, 0) == "scalar"
    # a view the wrapper makes contiguous is a fresh, aligned copy
    strided = torch.zeros((100, 128))[:, 1:65]
    assert not strided.is_contiguous() and tkplanes.encode_route(strided) == "vector"


def test_route_counts_start_at_zero_and_the_cpu_counts_none():
    ops.reset_launch_counts()
    x = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    ops.planes_decode(*ops.planes_encode(x, 2))
    assert ops.planes_route_counts() == {"planes_encode_vector": 0, "planes_encode_scalar": 0,
                                         "planes_decode_vector": 0, "planes_decode_scalar": 0}


# ---------------------------------------------------------------------------
# the main paths hand the kernels vector-route tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """Records (kernel, route, sexp dtype) for every planes call the plain
    versions serve on the CPU."""
    seen = []
    enc, dec = tkplanes.planes_encode_plain, tkplanes.planes_decode_plain

    def encode(xb, num_planes):
        seen.append(("encode", tkplanes.encode_route(xb), None))
        return enc(xb, num_planes)

    def decode(mu, sexp, planes):
        seen.append(("decode", tkplanes.decode_route(planes), sexp.dtype))
        return dec(mu, sexp, planes)

    monkeypatch.setattr(tkplanes, "planes_encode_plain", encode)
    monkeypatch.setattr(tkplanes, "planes_decode_plain", decode)
    return seen


@pytest.mark.parametrize("P", [1, 2])
def test_gradient_path_takes_the_vector_route(P, spy, tmp_path):
    """compressed_psum_mean, ppermute and all_to_all on a one-member gloo
    group, block 64, on leaves shaped like llama3.2-1b's (narrowed), one with
    a ragged last axis that the codec pads."""
    rng = np.random.default_rng(P)
    tree = {"embed": rng.standard_normal((96, 128)), "wq": rng.standard_normal((2, 128, 256)),
            "ln": rng.standard_normal(128), "ragged": rng.standard_normal((3, 70))}
    tree = {k: torch.from_numpy(v.astype(np.float32) * 1e-3) for k, v in tree.items()}
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            world_size=1, rank=0)
    try:
        mean, resid = tgc.compressed_psum_mean(tree, None, num_planes=P, block=64)
        h = torch.from_numpy(rng.standard_normal((4, 8, 128)).astype(np.float32))
        tgc.compressed_ppermute(h, None, [(0, 0)], num_planes=P, block=64)
        tgc.compressed_all_to_all(h, None, 0, 1, num_planes=P, block=64)
    finally:
        dist.destroy_process_group()
    assert set(mean) == set(tree) and all(torch.isfinite(v).all() for v in resid.values())
    assert len(spy) == 2 * len(tree) + 4
    assert {r for _, r, _ in spy} == {"vector"}
    assert {d for k, _, d in spy if k == "decode"} == {torch.int16}   # the wire's width


@pytest.mark.parametrize("P", [1, 2])
def test_serving_path_takes_the_vector_route(P, spy):
    """Prefill and decode steps with an SZx-planes cache at head_dim 64 (the
    reduced llama3.2-1b widened to llama3.2-1b's head_dim): every encode and
    every chunk decode on the vector route, sexp read as the cache's int8."""
    cfg = dataclasses.replace(configs.get("llama3.2-1b").reduced(), head_dim=64)
    model = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
    cache, logits = E.prefill(model, cfg, tokens, seq_len=16, kv_mode="compressed",
                              num_planes=P)
    tok = torch.argmax(logits[:, -1:], -1)
    for _ in range(3):
        logits, cache = E.decode_step(model, cfg, cache, tok, kv_mode="compressed",
                                      num_planes=P)
        tok = torch.argmax(logits, -1)
    assert bool(torch.isfinite(logits).all())
    kinds = [k for k, _, _ in spy]
    assert kinds.count("encode") == 2 + 2 * cfg.n_layers * 3
    assert kinds.count("decode") == 2 * cfg.n_layers * 3
    assert {r for _, r, _ in spy} == {"vector"}
    assert {d for k, _, d in spy if k == "decode"} == {torch.int8}


@pytest.mark.parametrize("P", [1, 2, 3])
def test_decode_reads_sexp_at_its_width(P, spy):
    """ops.planes_decode hands int8, int16 and int32 sexp to the wrapper as
    they are (no cast launch on the card), other integer widths as int32;
    the CPU route's values do not depend on the width."""
    x = np.random.default_rng(20 + P).standard_normal((50, 64)).astype(np.float32)
    mu, sexp, planes = ops.planes_encode(torch.from_numpy(x), P)
    want = ops.planes_decode(mu, sexp, planes)
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64):
        assert np.array_equal(_bits(ops.planes_decode(mu, sexp.to(dt), planes)), _bits(want))
    widths = [d for k, _, d in spy if k == "decode"]
    assert widths == [torch.int32, torch.int8, torch.int16, torch.int32, torch.int32]


# ---------------------------------------------------------------------------
# the vector encode's ordered keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["edge8", "edge64", "special"])
def test_ordered_keys_give_the_references_min_and_max(case):
    x = {"edge8": lambda: _edge_blocks(8), "edge64": lambda: _edge_blocks(64),
         "special": lambda: _special_values(7)}[case]()
    x = x[~np.isnan(x).any(-1)]                  # a NaN block takes the first-NaN rule
    xf = tref.flush(torch.from_numpy(x))
    mn, mx = _key_min_max(xf)
    assert np.array_equal(_bits(mn), _bits(jnp.min(jnp.asarray(xf.numpy()), axis=-1)))
    assert np.array_equal(_bits(mx), _bits(jnp.max(jnp.asarray(xf.numpy()), axis=-1)))
    # the round trip is exact and the order is the value order, -0 below +0
    assert np.array_equal(_bits(_value_of(_key_of(xf))), _bits(xf))
    pool = torch.tensor([-np.inf, -3.4e38, -1.0, -1.1754944e-38, -0.0, 0.0, 1.1754944e-38,
                         1.0, 3.4e38, np.inf], dtype=torch.float32)
    assert bool((torch.diff(_unsigned(_key_of(pool))) > 0).all())
    # and the plain version's mu of each block (inf - inf is the default NaN)
    mu = tref.mul_flushed(torch.full_like(mn, 0.5), tref.flush(mn + mx))
    default_nan = torch.tensor(-4194304, dtype=torch.int32).view(torch.float32)   # 0xFFC00000
    mu = torch.where(torch.isnan(mu), default_nan, mu)
    want = tref.planes_encode_ref(torch.from_numpy(x), 1)[0]
    assert np.array_equal(_bits(mu), _bits(want))
