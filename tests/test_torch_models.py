"""The port's model layers and forward pass against the JAX package.

``repro_torch.models.layers`` and ``repro_torch.models.transformer`` against
``repro.models.layers`` / ``repro.models.transformer`` on the reduced
llama3.2-1b (2 layers, d_model 64, 4 query and 1 kv heads of 16, float32),
with the reference's weights loaded through ``params_from_jax`` and inputs
made with numpy from a seed.

Tolerances: float32 throughout; the matmuls and reductions run in another
order (torch's CPU kernels vs XLA's), which moves the last bits: 1e-5
relative / 1e-6 absolute per layer, 1e-4 / 1e-5 through the whole model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "llama3.2-1b"


@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.get(ARCH).reduced()
    cfg = configs.get(ARCH).reduced()
    rp = RT.init_params(rcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, rp)
    return rcfg, cfg, rp, tree, T.params_from_jax(tree, cfg, "cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_configs_match_the_reference():
    for name in configs.ARCH_NAMES:
        a, b = configs.get(name), rconfigs.get(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced()), name
        assert (a.param_count(), a.active_param_count(), a.padded_vocab,
                a.resolved_head_dim) == (b.param_count(), b.active_param_count(),
                                         b.padded_vocab, b.resolved_head_dim), name


def test_params_from_jax_keeps_every_weight(model):
    _rcfg, cfg, _rp, tree, m = model
    n = sum(p.numel() for p in m.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert np.array_equal(m["layers"][1]["mlp"]["wi"].numpy(), tree["layers"]["mlp"]["wi"][1])
    assert np.array_equal(m["layers"][0]["attn"]["wk"].numpy(), tree["layers"]["attn"]["wk"][0])
    assert "ln2" in m["layers"][0] and "moe" not in m["layers"][0]
    with pytest.raises(KeyError):
        m["layers"][0]["moe"]


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm(shape):
    x = _rng(1).standard_normal(shape, dtype=np.float32) * 3
    s = _rng(2).standard_normal(shape[-1:], dtype=np.float32)
    np.testing.assert_allclose(L.rms_norm(_t(x), _t(s)).numpy(),
                               np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(s))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("batched", [False, True])
def test_rope(theta, batched):
    x = _rng(3).standard_normal((2, 12, 4, 16), dtype=np.float32)
    pos = np.arange(12, dtype=np.int32) + 7
    if batched:
        pos = np.stack([pos, pos * 3])
    np.testing.assert_allclose(L.rope(_t(x), _t(pos), theta).numpy(),
                               np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
                               rtol=1e-5, atol=1e-5)


def test_dense():
    x = _rng(4).standard_normal((2, 7, 64), dtype=np.float32)
    w = _rng(5).standard_normal((64, 48), dtype=np.float32)
    np.testing.assert_allclose(L.dense(_t(x), _t(w)).numpy(),
                               np.asarray(RL.dense(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


def test_swiglu_mlp(model):
    _rcfg, _cfg, rp, _tree, m = model
    x = _rng(6).standard_normal((2, 9, 64), dtype=np.float32)
    want = RL.swiglu_mlp(jax.tree.map(lambda a: a[0], rp["layers"]["mlp"]), jnp.asarray(x))
    np.testing.assert_allclose(L.swiglu_mlp(m["layers"][0]["mlp"], _t(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_attention(model, window):
    rcfg, cfg, rp, _tree, m = model
    rcfg = dataclasses.replace(rcfg, sliding_window=window)
    cfg = dataclasses.replace(cfg, sliding_window=window)
    x = _rng(7).standard_normal((2, 24, 64), dtype=np.float32)
    want, (wk, wv) = RL.attention(jax.tree.map(lambda a: a[1], rp["layers"]["attn"]),
                                  jnp.asarray(x), rcfg)
    got, (k, v) = L.attention(m["layers"][1]["attn"], _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)


def test_forward_and_logits(model):
    rcfg, cfg, rp, _tree, m = model
    toks = _rng(8).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    hj, _ = RT.forward(rp, rcfg, jnp.asarray(toks))
    h, aux = T.forward(m, cfg, _t(toks))
    assert aux == 0.0
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)
    lj = RT.logits_for(rp, rcfg, hj)
    lt = T.logits_for(m, cfg, h)
    assert lt.dtype == torch.float32 and lt.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-5)


def test_forward_in_bf16():
    """compute_dtype bfloat16: both packages round every activation to bf16,
    but not at the same places (XLA's CPU fusions), so the logits differ by
    up to 2 % of their largest magnitude (0.97 % measured on the CPU)."""
    rcfg = dataclasses.replace(rconfigs.get(ARCH).reduced(), compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), compute_dtype="bfloat16")
    rp = RT.init_params(rcfg, jax.random.key(0))
    m = T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu")
    toks = _rng(8).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    hj, _ = RT.forward(rp, rcfg, jnp.asarray(toks))
    h, _ = T.forward(m, cfg, _t(toks))
    assert h.dtype == torch.bfloat16
    want = np.asarray(RT.logits_for(rp, rcfg, hj))
    got = T.logits_for(m, cfg, h).numpy()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_logits_mask_the_padded_vocab():
    """A vocabulary that is not a multiple of 128 gets -1e9 in the padding
    columns, as the reference's does."""
    rcfg = dataclasses.replace(rconfigs.get(ARCH).reduced(), vocab_size=500)
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), vocab_size=500)
    rp = RT.init_params(rcfg, jax.random.key(1))
    m = T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu")
    h = _rng(9).standard_normal((1, 3, 64), dtype=np.float32)
    want = np.asarray(RT.logits_for(rp, rcfg, jnp.asarray(h)))
    got = T.logits_for(m, cfg, _t(h)).numpy()
    assert got.shape[-1] == 512 and (got[..., 500:] < -1e8).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_params_draws_the_reference_scales():
    cfg = configs.get(ARCH).reduced()
    m = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in m.parameters())
    assert torch.equal(m["final_ln"], torch.ones(64))
    std = float(m["layers"][0]["mlp"]["wo"].std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "arctic-480b", "mamba2-1.3b",
                                  "hymba-1.5b"])
def test_families_of_later_slices_raise(name, remat):
    """The MoE, SSM and hybrid families, whose training once raised here,
    now train: forward_train, with remat off and on, gives forward's hidden
    states and aux loss, with a graph (tests/test_torch_families_train.py
    holds their gradients to the reference's)."""
    cfg = dataclasses.replace(configs.get(name).reduced(), remat=remat)
    m = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_rng(11).integers(0, cfg.vocab_size, (1, 8)))
    h0, aux0 = T.forward(m, cfg, toks)
    w = m["final_ln"].detach().requires_grad_()
    params = dict(T.param_tree(m), final_ln=w)
    h, aux = T.forward_train(params, cfg, toks)
    assert h.requires_grad and torch.equal(h.detach(), h0)
    assert float(torch.as_tensor(aux).detach()) == float(aux0)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "stablelm-3b", "yi-6b"])
def test_other_attention_families_run(name):
    rcfg, cfg = rconfigs.get(name).reduced(), configs.get(name).reduced()
    rp = RT.init_params(rcfg, jax.random.key(2))
    m = T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu")
    toks = _rng(10).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    hj, _ = RT.forward(rp, rcfg, jnp.asarray(toks))
    h, _ = T.forward(m, cfg, _t(toks))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)
