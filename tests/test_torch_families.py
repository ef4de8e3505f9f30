"""The MoE, SSM and hybrid families of the port against the JAX package.

``repro_torch`` (``models.layers.moe_ffn``/``mamba2``/``mamba2_decode``,
``models.transformer``, ``serve.engine``) against ``repro`` on the reduced
deepseek-moe-16b, arctic-480b (a dense FFN beside the experts), mamba2-1.3b
and hymba-1.5b (2 layers, d_model 64, float32), with the reference's weights
loaded through ``params_from_jax`` and inputs made with numpy from a seed.
The reduced hymba runs with a window equal to its prompt (16), as the full
one does (2048), so its ring evicts from the first decode step.

Tolerances: float32 throughout, the products and reductions summed in
another order than XLA's: 1e-5 relative / 1e-6 absolute per layer, 1e-4 /
1e-5 through the whole model, logits within ``LOGIT_TOL`` = 1e-4 of the
largest one (tests/test_torch_serve.py).  The routing is compared exactly:
the top-k experts of every token, and each expert's FIFO token ids where the
slot is valid (a slot past an expert's tokens holds 0 in both packages, but
the reference's top_k reads it from a tie).
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import configs
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E

# arch -> (window (0: the reduced config's), B, S, extra decode steps)
ARCHS = {"deepseek-moe-16b": (0, 2, 24, 3), "arctic-480b": (0, 2, 24, 3),
         "mamba2-1.3b": (0, 2, 24, 3), "hymba-1.5b": (16, 2, 16, 4)}
MOE = ["deepseek-moe-16b", "arctic-480b"]
SSM = ["mamba2-1.3b", "hymba-1.5b"]
MODES = [("dense", 1), ("compressed", 1), ("compressed", 2)]
RUNS = [(a, m, p) for a in ARCHS for m, p in MODES if a != "mamba2-1.3b" or m == "dense"]
LOGIT_TOL = 1e-4
LAYER = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
# mamba2's outputs and state: 1e-5 absolute where the other layers take
# 1e-6 (measured up to 6.0e-6, on outputs up to 3.8 and states up to 12).
# The within-chunk decay sums reach ~200 (A up to 16 times dt ~3 over 16
# steps), and XLA adds them in float32 one after another while torch's CPU
# cumsum carries a float64 sum: one float32 ulp of 200 (1.5e-5) moves
# exp(seg) by 1.5e-5 relative, and the norm after the scan passes it on.
SSM_LAYER = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, drop_free=False):
    window = ARCHS[arch][0]
    rcfg, cfg = rconfigs.get(arch).reduced(), configs.get(arch).reduced()
    kw = {}
    if window:
        kw["sliding_window"] = window
    if drop_free:       # cap = s: no token is dropped (tests/test_models.py:180-183)
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _setup(arch, drop_free=False):
    rcfg, cfg = _cfgs(arch, drop_free)
    rp = RT.init_params(rcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, rp)
    _window, b, s, extra = ARCHS[arch]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    return rcfg, cfg, rp, tree, T.params_from_jax(tree, cfg, "cpu"), toks


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _layer(rp, block, i=0):
    return jax.tree.map(lambda a: a[i], rp["layers"][block])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_keeps_every_weight(arch):
    _rcfg, cfg, _rp, tree, m, _toks = _setup(arch)
    assert sum(p.numel() for p in m.parameters()) == \
        sum(x.size for x in jax.tree.leaves(tree))
    lay = m["layers"][0]
    assert set(lay._parameters) | set(lay._modules) == set(tree["layers"])
    for i, lp in enumerate(m["layers"]):
        for block, mod in lp._modules.items():
            assert set(mod._parameters) == set(tree["layers"][block]), block
            for name, w in mod._parameters.items():
                assert np.array_equal(w.numpy(), tree["layers"][block][name][i]), (block, name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_draws_the_reference_scales(arch):
    """The reference's init shapes, and each tensor at its scale: normal *
    fan_in^-0.5 (moe.wo's fan-in is Fe, ssm.out's d_inner, ssm.conv's the
    conv width), zeros for dt_bias, log U[1, 16) for A_log, ones for D and
    the norms."""
    rcfg, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, d_model=128)          # more draws for the std estimates
    rcfg = dataclasses.replace(rcfg, d_model=128)
    m = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = jax.tree.map(lambda a: tuple(a.shape), RT.param_specs(rcfg))
    lay = m["layers"][0]
    for block, mod in lay._modules.items():
        for name, w in mod._parameters.items():
            assert (cfg.n_layers,) + tuple(w.shape) == specs["layers"][block][name], (block, name)
    assert sum(p.numel() for p in m.parameters()) == \
        sum(int(np.prod(s)) for s in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple)))
    di, f = cfg.ssm_d_inner, cfg.moe_d_ff
    scales = {("moe", "router"): cfg.d_model, ("moe", "wi"): cfg.d_model, ("moe", "wo"): f,
              ("moe", "shared_wi"): cfg.d_model,
              ("moe", "shared_wo"): cfg.n_shared_experts * f,
              ("mlp", "wo"): cfg.d_ff, ("ssm", "in"): cfg.d_model, ("ssm", "out"): di,
              ("ssm", "conv"): cfg.ssm_conv_width, ("attn", "wo"): cfg.n_heads * cfg.head_dim}
    seen = 0
    for (block, name), fan_in in scales.items():
        if block in lay and name in lay[block]:
            std = float(lay[block][name].std())
            assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, (block, name, std)
            seen += 1
    assert seen >= 3
    if "ssm" in lay:
        ssm = lay["ssm"]
        assert torch.equal(ssm["dt_bias"], torch.zeros_like(ssm["dt_bias"]))
        assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
        assert torch.equal(ssm["norm"], torch.ones(di))
        a = ssm["A_log"].exp()
        assert bool(((a >= 1) & (a < 16)).all()) and float(a.std()) > 1
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _reference_moe(p, x, cfg):
    """The reference's moe_ffn, with the two top_k results it computes on
    the way: (out, aux, idx, src, valid)."""
    calls = []
    top_k = jax.lax.top_k

    def record(a, k):
        out = top_k(a, k)
        calls.append(out)
        return out

    with mock.patch.object(jax.lax, "top_k", record):
        y, aux = RL.moe_ffn(p, jnp.asarray(x), cfg)
    (_gate, idx), (top_sc, src) = calls
    return y, aux, np.asarray(idx), np.asarray(src), np.asarray(top_sc) > -5e8


@pytest.mark.parametrize("case", ["drop_free", "default", "drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn(arch, case):
    rcfg, cfg, rp, _tree, m, _toks = _setup(arch, case == "drop_free")
    s = 48 if case == "drops" else 24
    if case == "drops":   # cap = max(8, int(48 * 2 / 8 * 0.5)) = 8 slots, ~12 tokens an expert
        rcfg = dataclasses.replace(rcfg, capacity_factor=0.5)
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    x = _x((2, s, 64), 3)
    want, aux_w, idx_w, src_w, valid_w = _reference_moe(_layer(rp, "moe", 1), x, rcfg)
    p = m["layers"][1]["moe"]
    _probs, idx, _gate, routed, src, valid = L.moe_route(_t(x), p["router"], cfg)
    assert np.array_equal(idx.numpy(), idx_w)
    assert np.array_equal(valid.numpy(), valid_w)
    assert np.array_equal(src.numpy(), np.where(valid_w, src_w, 0))
    kept, sent = int(valid.sum()), int(routed.sum())
    if case == "drops":
        assert kept < sent
    elif case == "drop_free":
        assert kept == sent == 2 * s * cfg.top_k and src.shape[-1] == s
    got, aux = L.moe_ffn(p, _t(x), cfg)
    _close(got, want, LAYER)
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-6)


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("s", [32, 21], ids=["chunked", "odd"])
@pytest.mark.parametrize("arch", SSM)
def test_mamba2(arch, s, init):
    """s = 32 runs two chunks of 16; s = 21 the largest divisor, 7."""
    rcfg, cfg, rp, _tree, m, _toks = _setup(arch)
    x = _x((2, s, 64), 4)
    di, h, n, hp = L._ssm_dims(cfg)
    st = _x((2, h, n, hp), 5) if init else None
    want, (state_w, tail_w) = RL.mamba2(_layer(rp, "ssm", 1), jnp.asarray(x), rcfg,
                                        init_state=None if st is None else jnp.asarray(st),
                                        return_state=True)
    got, (state, tail) = L.mamba2(m["layers"][1]["ssm"], _t(x), cfg,
                                  init_state=None if st is None else _t(st), return_state=True)
    assert state.dtype == torch.float32 and tail.shape == (2, cfg.ssm_conv_width - 1, di + 2 * n)
    _close(got, want, SSM_LAYER)
    _close(state, state_w, SSM_LAYER)
    _close(tail, tail_w, LAYER)           # the in-projection's last W-1 rows
    assert torch.equal(L.mamba2(m["layers"][1]["ssm"], _t(x), cfg,
                                init_state=None if st is None else _t(st)), got)


@pytest.mark.parametrize("arch", SSM)
def test_mamba2_decode(arch):
    rcfg, cfg, rp, _tree, m, _toks = _setup(arch)
    _di, h, n, hp = L._ssm_dims(cfg)
    x1, st = _x((3, 1, 64), 6), _x((3, h, n, hp), 7)
    cv = _x((3, cfg.ssm_conv_width - 1, L.ssm_conv_channels(cfg)), 8)
    want = RL.mamba2_decode(_layer(rp, "ssm"), jnp.asarray(x1), jnp.asarray(st),
                            jnp.asarray(cv), rcfg)
    got = L.mamba2_decode(m["layers"][0]["ssm"], _t(x1), _t(st), _t(cv), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, LAYER)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_logits(arch):
    rcfg, cfg, rp, _tree, m, toks = _setup(arch)
    hj, auxj = RT.forward(rp, rcfg, jnp.asarray(toks))
    h, aux = T.forward(m, cfg, _t(toks))
    _close(h, hj, MODEL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    lj = np.asarray(RT.logits_for(rp, rcfg, hj))
    lt = T.logits_for(m, cfg, h).numpy()
    assert np.abs(lt - lj).max() <= LOGIT_TOL * np.abs(lj).max()


def _np_cache(cache):
    return {"pos": int(cache["pos"]), "slot_pos": np.array(cache["slot_pos"]),
            "layers": {k: np.array(v) for k, v in cache["layers"].items()}}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, mode, planes, drop_free=False):
    rcfg, _cfg, rp, _tree, _m, toks = _setup(arch, drop_free)
    s, extra = ARCHS[arch][2:]
    cache, logits = RE.prefill(rp, rcfg, jnp.asarray(toks[:, :s]), seq_len=s + extra,
                               kv_mode=mode, num_planes=planes)
    out = [(np.asarray(logits), _np_cache(cache))]
    for i in range(extra):
        logits, cache = RE.decode_step(rp, rcfg, cache, jnp.asarray(toks[:, s + i:s + i + 1]),
                                       kv_mode=mode, num_planes=planes)
        out.append((np.asarray(logits), _np_cache(cache)))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(arch, mode, planes, drop_free=False):
    _rcfg, cfg, _rp, _tree, m, toks = _setup(arch, drop_free)
    s, extra = ARCHS[arch][2:]
    cache, logits = E.prefill(m, cfg, _t(toks[:, :s]), seq_len=s + extra, kv_mode=mode,
                              num_planes=planes)
    out = [(logits.numpy(), _np_cache(cache))]
    for i in range(extra):
        logits, cache = E.decode_step(m, cfg, cache, _t(toks[:, s + i:s + i + 1]), kv_mode=mode,
                                      num_planes=planes)
        out.append((logits.numpy(), _np_cache(cache)))
    return out


@pytest.mark.parametrize("arch,mode,planes", RUNS)
def test_logits_match_reference(arch, mode, planes):
    """The prefill's and every decode step's logits; the cache's pos,
    slot_pos and slab shapes after each call."""
    ref_out = _reference_run(arch, mode, planes)
    port_out = _port_run(arch, mode, planes)
    for step, ((lr, cr), (lp, cp)) in enumerate(zip(ref_out, port_out)):
        assert lp.shape == lr.shape and lp.dtype == np.float32
        assert np.abs(lp - lr).max() <= LOGIT_TOL * np.abs(lr).max(), (arch, mode, step)
        assert cp["pos"] == cr["pos"] and np.array_equal(cp["slot_pos"], cr["slot_pos"])
        assert {k: (v.shape, v.dtype) for k, v in cp["layers"].items()} == \
            {k: (v.shape, v.dtype) for k, v in cr["layers"].items()}


@pytest.mark.parametrize("arch", SSM)
def test_state_slabs_match_reference(arch):
    """The SSM state and conv slabs after the prefill (the layers' final
    state and conv tail) and after each decode step."""
    for (_l, cr), (_lp, cp) in zip(_reference_run(arch, "dense", 1),
                                   _port_run(arch, "dense", 1)):
        _close(cp["layers"]["state"], cr["layers"]["state"], MODEL)
        _close(cp["layers"]["conv"], cr["layers"]["conv"], MODEL)


@pytest.mark.parametrize("arch,mode,planes", RUNS)
def test_prefill_decode_matches_forward(arch, mode, planes):
    """tests/test_models.py's teacher-forcing criterion on the port, the
    MoE drop-free (capacity drops make the train and decode forms differ by
    design): decode after prefill equals forward over the same tokens within
    1e-3 (dense) and 0.06 (compressed) of the largest logit."""
    _rcfg, cfg, _rp, _tree, m, toks = _setup(arch, drop_free=arch in MOE)
    h, _ = T.forward(m, cfg, _t(toks))
    full = T.logits_for(m, cfg, h[:, -1:]).numpy()
    logits = _port_run(arch, mode, planes, drop_free=arch in MOE)[-1][0]
    rel = np.abs(full - logits).max() / np.abs(full).max()
    assert rel < (1e-3 if mode == "dense" else 0.06), (arch, mode, rel)
    if arch == "hymba-1.5b":
        slot_pos = _port_run(arch, mode, planes, drop_free=False)[-1][1]["slot_pos"]
        assert slot_pos.shape == (16,) and slot_pos.min() == ARCHS[arch][3]   # evicted


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mode,planes", [("dense", 1), ("compressed", 2)])
def test_cache_bytes_are_the_slab_shapes(arch, mode, planes):
    _rcfg, cfg = _cfgs(arch)
    b, seq = 3, 40
    cache = E.make_cache(cfg, b, seq, kv_mode=mode, num_planes=planes, dtype=torch.float32,
                         device="cpu")
    spec = jax.eval_shape(lambda: RE.make_cache(_cfgs(arch)[0], b, seq, kv_mode=mode,
                                                num_planes=planes, dtype=jnp.float32))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache["layers"].items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in spec["layers"].items()}
    assert tuple(cache["slot_pos"].shape) == spec["slot_pos"].shape
    w = E.cache_window(cfg, seq)
    kv = 0
    if T.has_attention(cfg):
        per = cfg.head_dim * 4 if mode == "dense" else 4 + 1 + planes * cfg.head_dim
        kv = 2 * b * w * cfg.n_kv_heads * per
    ssm = 0
    if T.has_ssm(cfg):
        ssm = b * (cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim
                   + (cfg.ssm_conv_width - 1) * L.ssm_conv_channels(cfg)) * 4
    assert E.cache_nbytes(cache) == cfg.n_layers * (kv + ssm) > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_cli_on_the_cpu(capsys, arch):
    mode = "dense" if arch == "mamba2-1.3b" else "compressed"
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt", "12", "--tokens", "5", "--kv-mode", mode])
    out = capsys.readouterr().out
    assert f"{arch} kv={mode} on cpu:" in out and "tok/s" in out and "sample row" in out
