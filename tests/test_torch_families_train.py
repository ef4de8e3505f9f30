"""Training of the MoE, SSM and hybrid families in the port against the JAX
package, on the CPU.

``repro_torch.models.transformer.loss_fn`` (the MoE's dispatch and balance
loss, the SSD chunk loop, the windowed attention, per-layer remat) and
``train.step`` against ``repro``'s, on the reduced deepseek-moe-16b,
arctic-480b (a dense FFN beside the experts), mamba2-1.3b and hymba-1.5b (2
layers, d_model 64, float32) with the reference's weights loaded through
``params_from_jax`` and SyntheticLM batches (numpy, from a seed).  The
reduced hymba runs with a window of 16 under its 24 positions, so the
window masks in the forward and the backward.  The MoE runs at its default
capacity, where tokens are dropped (asserted), and drop-free.

Tolerances (float32; torch's CPU kernels and XLA's sum in other orders):
  * the loss: 1e-5 relative; every gradient within 1e-4 of the leaf's
    largest (measured up to 4.7e-6, at ``ssm/conv``, ``A_log`` and ``D``);
  * three plain steps against the jitted reference step, as
    tests/test_torch_train.py holds llama3.2-1b: the first loss 1e-6
    relative, the next ones 1e-4; the parameters after three steps at
    lr = 1e-3 (no weight decay: see
    ``test_weight_decay_skips_every_vector_unlike_the_stacked_reference``)
    within 1e-3 of the reference, 99 % of them within 1e-5 (measured: max
    2.6e-5);
  * a restored SZx checkpoint: every float leaf of 1024+ values within the
    checkpoint's bound of the saved one, the rest bit for bit.
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pytree
from repro_torch.core.codec import plan
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.train import step as step_mod

ARCHS = ["deepseek-moe-16b", "arctic-480b", "mamba2-1.3b", "hymba-1.5b"]
MOE = ["deepseek-moe-16b", "arctic-480b"]
# (arch, capacity): the MoE at its default capacity factor and drop-free
CASES = [(a, c) for a in ARCHS for c in (("default", "drop_free") if a in MOE else ("default",))]
B, S = 2, 24
WINDOW = 16                         # hymba's window, under S


def _cfgs(arch, capacity="default"):
    kw = {"sliding_window": WINDOW} if arch == "hymba-1.5b" else {}
    cfg = configs.get(arch).reduced()
    if capacity == "drop_free":     # cap = s: no token is dropped (tests/test_models.py:180-183)
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(rconfigs.get(arch).reduced(), **kw), dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return RT.init_params(_cfgs(arch)[0], jax.random.key(0))


def _port_params(rp, cfg):
    return T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))


def _batch(cfg, step=0, s=S):
    return SyntheticLM(train_cli.data_config(cfg, s, B)).batch_at(step)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _p(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _unstack(tree):
    """The reference's tree (layers stacked on a leading axis) as the
    port's ``param_tree`` (a list of layers), numpy."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            n = jax.tree.leaves(v)[0].shape[0]
            out[k] = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), v) for i in range(n)]
        elif isinstance(v, dict):
            out[k] = _unstack(v)
        else:
            out[k] = np.asarray(v)
    return out


def _routing(fn):
    """``fn()`` with every call of ``layers.moe_route`` recorded: returns
    (fn's result, [(tokens routed, slots kept) per call])."""
    seen, route = [], L.moe_route

    def recorded(x, router, cfg):
        out = route(x, router, cfg)
        seen.append((int(out[3].sum()), int(out[5].sum())))
        return out

    L.moe_route = recorded
    try:
        return fn(), seen
    finally:
        L.moe_route = route


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch,capacity", CASES)
def test_loss_and_gradients_match_jax(arch, capacity, remat):
    """loss_fn over a SyntheticLM batch (the MoE's balance loss included)
    and every gradient against jax.value_and_grad, remat off and on."""
    rcfg, cfg = (dataclasses.replace(c, remat=remat) for c in _cfgs(arch, capacity))
    rp = _reference_params(arch)
    batch = _batch(cfg)
    rloss, rgrads = jax.value_and_grad(RT.loss_fn)(rp, rcfg, _j(batch))
    (loss, grads), routing = _routing(
        lambda: step_mod.value_and_grad(cfg, _port_params(rp, cfg), _p(batch)))
    if cfg.n_experts:
        # the forward, then with remat each layer's recompute (last layer
        # first) on the same routes
        n = cfg.n_layers
        assert len(routing) == n * (2 if remat else 1)
        assert routing[n:] == (routing[:n][::-1] if remat else [])
        dropped = sum(sent - kept for sent, kept in routing)
        assert (dropped > 0) == (capacity == "default"), routing
    else:
        assert not routing
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = dict(pytree.leaf_paths(_unstack(rgrads)))
    got = dict(pytree.leaf_paths(grads))
    assert list(got) == list(want)
    for name, a in got.items():
        b = want[name]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_weight_decay_skips_every_vector_unlike_the_stacked_reference():
    """Both packages mean to decay no vector ("no decay on norms/bias",
    repro/optim/adamw.py:52).  The port decays no 1-D leaf.  The reference
    stacks the layers, so its per-layer norms and the SSM's A_log, dt_bias
    and D are (n_layers, n) there and are decayed; its final_ln is not.
    With zero gradients one step moves exactly the decayed leaves."""
    rcfg, cfg = _cfgs("hymba-1.5b")
    rp = _reference_params("hymba-1.5b")
    ropt, opt = RAdamW(lr=1e-2), AdamW(lr=1e-2)
    rnew, _, _ = ropt.update(jax.tree.map(jnp.zeros_like, rp), ropt.init(rp), rp)
    params = _port_params(rp, cfg)
    before = {n: t.clone() for n, t in pytree.leaf_paths(params)}
    opt.update(pytree.tree_map(torch.zeros_like, params), opt.init(params), params)
    ref_before = dict(pytree.leaf_paths(_unstack(rp)))
    ref_after = dict(pytree.leaf_paths(_unstack(rnew)))
    vectors = 0
    for name, t in pytree.leaf_paths(params):
        nonzero = bool(before[name].any())
        assert (not torch.equal(t, before[name])) == (t.dim() >= 2 and nonzero), name
        stacked = name.startswith("layers/")
        moved = not np.array_equal(ref_after[name], ref_before[name])
        assert moved == ((t.dim() >= 2 or stacked) and nonzero), name
        vectors += t.dim() == 1 and stacked and nonzero
    assert vectors == 2 * cfg.n_layers + 3 * cfg.n_layers      # ln1, ln2; norm, A_log, D


@pytest.mark.parametrize("arch", ARCHS)
def test_three_plain_steps_match_the_jitted_reference(arch):
    """Without weight decay, whose reach differs on the per-layer vectors
    (the test above): with it the vectors part by lr * wd * |p| a step, and
    the gradients after them."""
    rcfg, cfg = _cfgs(arch)
    rp = _reference_params(arch)
    ropt, opt = RAdamW(lr=1e-3, weight_decay=0.0), AdamW(lr=1e-3, weight_decay=0.0)
    rstate = {"params": rp, "opt": ropt.init(rp)}
    rfn = jax.jit(rstep.make_train_step(rcfg, ropt))
    params = _port_params(rp, cfg)
    state = {"params": params, "opt": opt.init(params)}
    fn = step_mod.make_train_step(cfg, opt)
    for i in range(3):
        b = _batch(cfg, i)
        rstate, rm = rfn(rstate, _j(b))
        state, m = fn(state, _p(b))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-6 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    want = dict(pytree.leaf_paths(_unstack(rstate["params"])))
    d = np.concatenate([np.abs(a.numpy() - want[n]).ravel()
                        for n, a in pytree.leaf_paths(state["params"])])
    assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())
    assert int(state["opt"].step) == 3


def _launch(tmp_path, arch, *flags):
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--seq", "16", "--batch", "2",
            "--ckpt", str(tmp_path), "--device", "cpu", *flags]
    return train_cli.run(train_cli.build_parser().parse_args(argv), torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_cpu(tmp_path, arch):
    """Two plain steps through the launcher: finite losses, every block's
    weights moved (the SSM's 1-D leaves too), a raw final checkpoint."""
    tr, state = _launch(tmp_path, arch)
    assert len(tr.history) == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    cfg = configs.get(arch).reduced()
    init = dict(pytree.leaf_paths(T.param_tree(
        T.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu"))))
    moved = {n: float((a - init[n]).abs().max()) for n, a in pytree.leaf_paths(state["params"])}
    blocks = [n for n in moved if n.startswith("layers/0/")]
    assert blocks and all(moved[n] > 0 for n in blocks), moved
    if T.has_ssm(cfg):
        assert {f"layers/0/ssm/{w}" for w in ("A_log", "dt_bias", "D", "conv")} <= set(blocks)
    if cfg.n_experts:
        assert {"layers/0/moe/router", "layers/0/moe/wi", "layers/0/moe/wo"} <= set(blocks)
    assert CheckpointManager(str(tmp_path), device="cpu").latest_step() == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_launcher_and_restore(tmp_path, arch):
    """``--grad-compress 1 --ckpt-compress`` (a one-rank gloo group): finite
    losses, then the final SZx checkpoint restored and held to the final
    state within its bound."""
    tr, state = _launch(tmp_path, arch, "--grad-compress", "1", "--ckpt-compress")
    assert len(tr.history) == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    ckpt = CheckpointManager(str(tmp_path), compress=True, device="cpu")
    tree, step = ckpt.restore(state)
    assert step == 1
    names = [n for n, _ in pytree.leaf_paths(tree)]
    assert "ef/embed" in names and "opt/.step" in names
    compressed = 0
    for (name, got), want in zip(pytree.leaf_paths(tree), pytree.leaves(state)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if got.is_floating_point() and got.numel() >= 1024:
            e = plan.resolve_error_bound(want, ckpt.bound)
            assert float((got.double() - want.double()).abs().max()) <= e, name
            compressed += 1
        else:
            assert torch.equal(got, want), name
    assert compressed > 0
