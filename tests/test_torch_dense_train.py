"""Training of the dense configs beside llama3.2-1b in the port against the
JAX package, on the CPU.

``repro_torch.models.transformer.loss_fn`` (per-layer remat, the flash
attention's backward) and ``train.step`` with AdamW against ``repro``'s, on
the reduced stablelm-3b (4 query heads over 4 kv heads of 16: no grouping),
yi-6b (4 query heads over 1, rope theta 5e6) and h2o-danube-1.8b (its
window of 32 under 40 positions, so the window masks in the forward and
the backward) -- 2 layers, d_model 64, float32 -- with the reference's
weights loaded through ``params_from_jax`` and SyntheticLM batches (numpy,
from a seed).

Tolerances (float32; torch's CPU kernels and XLA's sum in other orders),
those of tests/test_torch_families_train.py and tests/test_torch_train.py:
  * the loss: 1e-5 relative; every gradient within 1e-4 of the leaf's
    largest;
  * three plain steps with AdamW (lr 1e-3, no weight decay) against the
    jitted reference step, as tests/test_torch_train.py holds
    llama3.2-1b's: the first loss 1e-6 relative, the next ones 1e-4, the
    gradient norms 1e-4; the parameters after three steps within lr of the
    reference, 99 % of them within 1e-5 (measured: max 1.1e-5).  Without
    weight decay, as tests/test_torch_families_train.py steps: the
    reference stacks the layers, so it decays the per-layer norms the
    port leaves alone (that file's
    ``test_weight_decay_skips_every_vector_unlike_the_stacked_reference``);
    they part by 3.0e-4 in three steps, and at these widths that turns
    the Adam update of two near-zero embedding gradients of yi-6b and
    h2o-danube-1.8b around (2.4e-3 and 1.2e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as RT
from repro.optim import AdamW as RAdamW
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.train import step as step_mod

ARCHS = ["stablelm-3b", "yi-6b", "h2o-danube-1.8b"]
B = 4
SEQ = {"stablelm-3b": 32, "yi-6b": 32, "h2o-danube-1.8b": 40}   # danube's above its window


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg, cfg = rconfigs.get(arch).reduced(), configs.get(arch).reduced()
    return rcfg, cfg, RT.init_params(rcfg, jax.random.key(0))


def _port_params(rp, cfg):
    return T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))


def _as_port(rtree, cfg):
    """The reference's tree (layers stacked on a leading axis) as the
    port's nested dict (a list of layers), numpy."""
    out = {k: np.asarray(v) for k, v in rtree.items() if k != "layers"}
    out["layers"] = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), rtree["layers"])
                     for i in range(cfg.n_layers)]
    return out


def _batches(arch, cfg, n):
    ds = SyntheticLM(DataConfig(cfg.vocab_size, SEQ[arch], B))
    return [ds.batch_at(i) for i in range(n)]


def test_the_reduced_configs_are_the_shapes_meant():
    """stablelm-3b without grouping, yi-6b with G = 4 and its rope theta,
    h2o-danube-1.8b's window under the sequence the tests train on."""
    shapes = {a: _setup(a)[1] for a in ARCHS}
    assert shapes["stablelm-3b"].n_heads == shapes["stablelm-3b"].n_kv_heads
    yi = shapes["yi-6b"]
    assert yi.n_heads // yi.n_kv_heads == 4 and yi.rope_theta == 5e6
    danube = shapes["h2o-danube-1.8b"]
    assert 0 < danube.sliding_window < SEQ["h2o-danube-1.8b"]
    for a, cfg in shapes.items():
        rcfg = _setup(a)[0]
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "rope_theta", "sliding_window", "remat"):
            assert getattr(cfg, f) == getattr(rcfg, f), (a, f)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, remat):
    """loss_fn over a SyntheticLM batch and every gradient against
    jax.value_and_grad of the reference's loss_fn, remat off and on."""
    rcfg, cfg, rp = _setup(arch)
    rcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (rcfg, cfg))
    batch = _batches(arch, cfg, 1)[0]
    rloss, rgrads = jax.value_and_grad(RT.loss_fn)(
        rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = step_mod.value_and_grad(cfg, _port_params(rp, cfg),
                                          {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = dict(pytree.leaf_paths(_as_port(rgrads, cfg)))
    got = dict(pytree.leaf_paths(grads))
    assert list(got) == list(want)
    for name, a in got.items():
        b = want[name]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_plain_steps_match_the_jitted_reference(arch):
    """Three AdamW steps against the jitted reference step from the same
    weights and batches, without weight decay (the module's docstring)."""
    rcfg, cfg, rp = _setup(arch)
    ropt, opt = RAdamW(lr=1e-3, weight_decay=0.0), AdamW(lr=1e-3, weight_decay=0.0)
    rstate = {"params": rp, "opt": ropt.init(rp)}
    rfn = jax.jit(rstep.make_train_step(rcfg, ropt))
    params = _port_params(rp, cfg)
    state = {"params": params, "opt": opt.init(params)}
    fn = step_mod.make_train_step(cfg, opt)
    for i, b in enumerate(_batches(arch, cfg, 3)):
        rstate, rm = rfn(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-6 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    want = dict(pytree.leaf_paths(_as_port(rstate["params"], cfg)))
    d = np.concatenate([np.abs(a.numpy() - want[n]).ravel()
                        for n, a in pytree.leaf_paths(state["params"])])
    assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())
    assert int(state["opt"].step) == 3
