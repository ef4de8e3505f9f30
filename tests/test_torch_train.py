"""The port's training slice against the JAX package, on the CPU.

``repro_torch.data``, ``optim``, the flash-attention gradient,
``models.transformer.loss_fn`` and ``train.step`` against ``repro``'s, on
the reduced llama3.2-1b (2 layers, d_model 64, 4 query and 1 kv heads of
16, float32) with the reference's weights loaded through
``params_from_jax`` and inputs made with numpy from a seed.

Tolerances (float32; torch's CPU kernels and XLA's sum in other orders):
  * the synthetic tokens: bit for bit (both are numpy);
  * AdamW on the same gradients: 2e-6 relative + 1e-9 absolute (the update
    is a handful of float32 steps; XLA's jit may contract a multiply-add);
  * the flash-attention gradients: 1e-5 of the largest gradient (measured
    up to 1.3e-6);
  * the loss: 1e-5 relative; every gradient 1e-4 of the leaf's largest;
  * three plain steps: the first loss 1e-6 relative, the next ones 1e-4
    (measured 1.6e-5); the parameters after three steps at lr = 1e-3
    within lr of the reference, and 99 % of them within 1e-5 (measured:
    max 3.0e-4, 99.7 % within 1e-5).  Adam's first updates are about
    sign(g) * lr, so a gradient entry near zero, whose last bits the other
    summation order moves, can turn its update around: the differences
    grow from the gradients' 1e-7 to a fraction of lr.
The compressed step cannot be held to the reference's own (its test fails
under the installed jax, ROADMAP.md queue 3); it is held to that test's
criterion instead: both modes train, final losses within 8 %.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import DataConfig as RDataConfig, SyntheticLM as RSyntheticLM
from repro.models import layers as RL, transformer as RT
from repro.optim import AdamW as RAdamW, warmup_cosine as rwarmup_cosine
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data import CompressedInMemoryCache, DataConfig, Prefetcher, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, global_norm, warmup_cosine
from repro_torch.train import step as step_mod

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-1b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _ref_tree_as_port(rtree, cfg):
    """The reference's parameter tree (layers stacked) as the port's nested
    dict (a list of layers), numpy."""
    lay = rtree["layers"]
    out = {k: np.asarray(v) for k, v in rtree.items() if k != "layers"}
    out["layers"] = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), lay)
                     for i in range(cfg.n_layers)]
    return out


@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.get(ARCH).reduced()
    cfg = configs.get(ARCH).reduced()
    rp = RT.init_params(rcfg, jax.random.key(0))
    return rcfg, cfg, rp


def _batch(cfg, seed=0, b=4, s=32):
    return {k: v for k, v in SyntheticLM(DataConfig(cfg.vocab_size, s, b, seed=seed))
            .batch_at(0).items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames,prefix", [(0, 0), (3, 2)])
def test_synthetic_tokens_equal_the_reference(frames, prefix):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=7, frames=frames,
              frame_dim=5 if frames else 0, prefix_embeds=prefix, prefix_dim=4 if prefix else 0)
    port, ref = SyntheticLM(DataConfig(**kw)), RSyntheticLM(RDataConfig(**kw))
    for step, rank, n in ((0, 0, 1), (3, 1, 2), (11, 3, 4)):
        a, b = port.batch_at(step, rank, n), ref.batch_at(step, rank, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    it = port.batches(start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], ref.batch_at(5)["tokens"])
    with pytest.raises(ValueError):
        port.batch_at(0, 0, 3)


def test_compressed_cache_is_bounded_and_evicts():
    rng = np.random.default_rng(0)
    cache = CompressedInMemoryCache(1e-3, max_bytes=6000, device="cpu")
    shards = [np.cumsum(rng.standard_normal((40, 50)), 1).astype(np.float32) for _ in range(4)]
    for i, x in enumerate(shards):
        cache.put(i, x)
    assert cache.evictions >= 1 and len(cache) < 4 and cache.stored_bytes <= 6000
    last = cache.get(3)
    assert last.shape == (40, 50)
    assert float((last - torch.from_numpy(shards[3])).abs().max()) <= 1e-3
    assert cache.compression_ratio > 1.0 and 3 in cache and 0 not in cache


def test_prefetcher_relays_items_and_errors():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    with Prefetcher(items()) as p:
        assert next(p) == 1 and next(p) == 2
        with pytest.raises(KeyError):
            next(p)
        with pytest.raises(StopIteration):
            next(p)
    with Prefetcher(iter(range(100)), depth=1) as p:
        assert next(p) == 0
    assert not p._thread.is_alive()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_and_schedule_match_the_reference():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "n": {"scale": np.ones(8, np.float32)}, "b": np.zeros(8, np.float32)}
    grads = [{"w": rng.standard_normal((16, 8)).astype(np.float32) * s,
              "n": {"scale": rng.standard_normal(8).astype(np.float32)},
              "b": rng.standard_normal(8).astype(np.float32) * s} for s in (5.0, 0.01, 1.0)]
    ropt = RAdamW(lr=rwarmup_cosine(1e-2, 2, 10), weight_decay=0.1, clip_norm=1.0)
    opt = AdamW(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1, clip_norm=1.0)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt.init(rp)
    tp = pytree.tree_map(_t, params)
    ts = opt.init(tp)
    for g in grads:
        rp, rs, rm = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts, tm = opt.update(pytree.tree_map(_t, g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=2e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=2e-6)
        for a, b in zip(pytree.leaves(tp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-9)
        for a, b in zip(pytree.leaves(ts.m) + pytree.leaves(ts.v),
                        jax.tree.leaves(rs.m) + jax.tree.leaves(rs.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-12)
    assert int(ts.step) == int(rs.step) == 3 and ts.step.dtype == torch.int32
    sched, rsched = warmup_cosine(3e-4, 20, 100), rwarmup_cosine(3e-4, 20, 100)
    for s in (0, 1, 19, 20, 21, 60, 100, 150):
        np.testing.assert_allclose(float(sched(torch.tensor(s, dtype=torch.int32))),
                                   float(rsched(jnp.int32(s))), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(pytree.tree_map(_t, grads[0]))),
                               float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                 for g in jax.tree.leaves(grads[0])))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the flash-attention gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
@pytest.mark.parametrize("s,hq,hkv,q_chunk", [(64, 8, 2, 512), (48, 8, 1, 16), (40, 4, 1, 16)])
def test_flash_gradients_match_jax_grad(causal, window, s, hq, hkv, q_chunk):
    """GQA groups 4 and 8; the backward's query chunk at 512 (one chunk) and
    16 (ragged chunks)."""
    rng = np.random.default_rng(s + hq)
    q = rng.standard_normal((2, s, hq, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, s, hkv, 16), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((2, s, hq, 16), dtype=np.float32)

    def f(q, k, v):
        return jnp.sum(RL.flash_attention(q, k, v, causal=causal, window=window,
                                          q_chunk=16, kv_chunk=16) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(do), causal=causal, window=window,
                                 q_chunk=q_chunk)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    fa.FlashAttention.apply(tq, tk, tv, causal, window).backward(_t(do))
    for name, a, b, c in zip("qkv", got, (tq.grad, tk.grad, tv.grad), want):
        c = np.asarray(c)
        tol = 1e-5 * np.abs(c).max()
        np.testing.assert_allclose(a.numpy(), c, rtol=0, atol=tol, err_msg=f"d{name}")
        np.testing.assert_allclose(b.numpy(), c, rtol=0, atol=tol, err_msg=f"autograd d{name}")
        if q_chunk == fa.BWD_Q_CHUNK:                # the autograd's own chunking
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flash_gradient_bf16_follows_float32():
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((1, 24, 4, 16), dtype=np.float32) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    f32 = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(do))
    b16 = fa.flash_attention_bwd(*(_t(x).to(torch.bfloat16) for x in (q, k, v, do)))
    for a, b in zip(f32, b16):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.float().numpy(), a.numpy(), rtol=0,
                                   atol=0.05 * float(a.abs().max()))


# ---------------------------------------------------------------------------
# loss and gradients through the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(model, remat):
    rcfg, cfg, rp = model
    rcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (rcfg, cfg))
    batch = _batch(cfg, s=40)
    rloss, rgrads = jax.value_and_grad(RT.loss_fn)(
        rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))
    loss, grads = step_mod.value_and_grad(cfg, params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = _ref_tree_as_port(rgrads, cfg)
    names = [n for n, _ in pytree.leaf_paths(want)]
    assert names == [n for n, _ in pytree.leaf_paths(grads)]
    for name, a, b in zip(names, pytree.leaves(grads), pytree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_chunked_loss_equals_one_chunk(model):
    _rcfg, cfg, rp = model
    params = T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))
    batch = {k: _t(v) for k, v in _batch(cfg, s=37).items()}
    h, _aux = T.forward_train(params, cfg, batch["tokens"])
    a = T.chunked_ce_loss(params, cfg, h, batch["labels"], chunk=8)
    b = T.chunked_ce_loss(params, cfg, h, batch["labels"], chunk=512)
    assert int(a[1]) == int(b[1]) == 4 * 36
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-6)


def test_three_plain_steps_match_the_jitted_reference(model):
    rcfg, cfg, rp = model
    ropt, opt = RAdamW(lr=1e-3), AdamW(lr=1e-3)
    rstate = {"params": rp, "opt": ropt.init(rp)}
    rfn = jax.jit(rstep.make_train_step(rcfg, ropt))
    params = T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))
    state = {"params": params, "opt": opt.init(params)}
    fn = step_mod.make_train_step(cfg, opt)
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    for i in range(3):
        b = ds.batch_at(i)
        rstate, rm = rfn(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = fn(state, {k: _t(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-6 if i == 0 else 1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
    want = dict(pytree.leaf_paths(_ref_tree_as_port(rstate["params"], cfg)))
    d = np.concatenate([np.abs(a.numpy() - want[n]).ravel()
                        for n, a in pytree.leaf_paths(state["params"])])
    assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())
    assert int(state["opt"].step) == 3


def test_init_state_shapes():
    cfg = configs.get(ARCH).reduced()
    opt = AdamW(lr=1e-3)
    state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0), ef_planes=1,
                                device="cpu")
    for p, m, e in zip(pytree.leaves(state["params"]), pytree.leaves(state["opt"].m),
                       pytree.leaves(state["ef"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert e.shape == (2,) + tuple(p.shape) and e.dtype == torch.bfloat16
        assert not e.any()
    names = [n for n, _ in pytree.leaf_paths(state)]
    assert "params/layers/1/attn/wq" in names and "opt/.step" in names
    assert "ef/embed" in names


# ---------------------------------------------------------------------------
# the compressed data-parallel step on two gloo ranks
# ---------------------------------------------------------------------------

COMPRESSED = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.optim import AdamW
from repro_torch.train import step as step_mod

rank, store, dest = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
cfg = dataclasses.replace(configs.get("llama3.2-1b").reduced(), n_layers=2)
opt = AdamW(lr=1e-2)
state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0), ef_planes=1,
                            device="cpu")
fn = step_mod.make_train_step(cfg, opt, compress_planes=1)
losses = []
for i in range(12):
    rng = np.random.default_rng(i)
    t = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    t, lab = t[2 * rank:2 * rank + 2], np.roll(t, -1, 1)[2 * rank:2 * rank + 2]
    state, m = fn(state, {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)})
    losses.append(float(m["loss"]))
ef = state["ef"]["embed"]
np.savez(dest, losses=np.array(losses), ef_own=ef[rank].float().abs().sum().numpy(),
         ef_other=ef[1 - rank].float().abs().sum().numpy(),
         embed=state["params"]["embed"].numpy())
dist.destroy_process_group()
print("WORKER-OK")
"""


def test_compressed_step_trains_like_the_plain_step(tmp_path):
    """tests/test_grad_compress.py's criterion on the same setup (reduced
    llama3.2-1b, AdamW lr 1e-2, 12 steps of 4 x 32 random tokens, the batch
    split over two members): both modes train and the final losses are
    within 8 %."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", COMPRESSED, str(r), str(tmp_path / "store"),
         str(tmp_path / f"r{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in (0, 1)]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0 and "WORKER-OK" in out, out[-3000:]
    cfg = configs.get(ARCH).reduced()
    opt = AdamW(lr=1e-2)
    state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    fn = step_mod.make_train_step(cfg, opt)
    plain = []
    for i in range(12):
        rng = np.random.default_rng(i)
        t = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        state, m = fn(state, {"tokens": _t(t), "labels": _t(np.roll(t, -1, 1))})
        plain.append(float(m["loss"]))
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in (0, 1))
    np.testing.assert_array_equal(r0["losses"], r1["losses"])   # the group's mean loss
    np.testing.assert_array_equal(r0["embed"], r1["embed"])     # members stay in step
    comp = list(r0["losses"])
    assert plain[-1] < plain[0], "plain did not train"
    assert comp[-1] < comp[0], "compressed did not train"
    assert abs(plain[-1] - comp[-1]) / abs(plain[-1]) < 0.08, (plain[-1], comp[-1])
    assert float(r0["ef_own"]) > 0 and float(r0["ef_other"]) == 0


def test_compressed_step_needs_a_row_per_member():
    cfg = configs.get(ARCH).reduced()
    opt = AdamW(lr=1e-3)
    state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0), ef_planes=1,
                                device="cpu")
    state["ef"] = pytree.tree_map(lambda e: e[:0], state["ef"])
    import torch.distributed as dist

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        fn = step_mod.make_train_step(cfg, opt, compress_planes=1)
        b = {k: _t(v) for k, v in _batch(cfg).items()}
        with pytest.raises(ValueError, match="rows"):
            fn(state, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("flags", [[], ["--grad-compress", "1", "--ckpt-compress"]],
                         ids=["plain", "compressed"])
def test_train_launcher_on_cpu(tmp_path, capsys, flags):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    tr = train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--seq", "16",
                     "--batch", "2", "--ckpt", str(tmp_path), "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b on cpu" in out and len(tr.history) == 3
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    ckpt = CheckpointManager(str(tmp_path), device="cpu")
    assert ckpt.latest_step() == 2
    names = [m["name"] for m in json_manifest(tmp_path)["leaves"]]
    assert ("ef/embed" in names) == bool(flags)
    codecs = {m["codec"] for m in json_manifest(tmp_path)["leaves"]}
    assert ("szx" in codecs) == bool(flags)
    ssm = train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "1",
                      "--ckpt", str(tmp_path / "m"), "--device", "cpu", *flags])
    assert len(ssm.history) == 1 and np.isfinite(ssm.history[0]["loss"])


def json_manifest(root):
    import json

    return json.loads((root / "step_000000002" / "MANIFEST.json").read_text())


def test_trainer_config_and_launcher_defaults_match_the_reference():
    from repro.train.trainer import TrainerConfig as RTrainerConfig
    from repro_torch.launch import train
    from repro_torch.train.trainer import TrainerConfig

    cfg = TrainerConfig(total_steps=2, log_every=20)
    assert cfg.log_every == 20 and TrainerConfig(total_steps=2).log_every == 10
    assert [(f.name, f.default) for f in dataclasses.fields(TrainerConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(RTrainerConfig)]
    args = train.build_parser().parse_args(["--arch", "llama3.2-1b"])
    assert args.ckpt == "/tmp/repro_launch_ckpt"        # the reference's default
