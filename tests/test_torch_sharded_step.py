"""The port's sharded training step, sharded tree compression and sharded
restore on four gloo ranks, against the unsharded step and the JAX package.

Four worker processes form a gloo group on a ``FileStore`` under the
test's temporary directory and build ``DeviceMesh``es over it.  On reduced
configs (B 4 x S 32 SyntheticLM tokens, AdamW at lr 1e-3 without weight
decay, 3 steps; whisper-medium's stub frames and internvl2-1b's image
embeddings drawn from a seed with numpy) each runs the plain step of
``train/step.py`` and the sharded one from the same seed.  Every family
computes tensor-parallel along ``model``: the row-parallel all-reduces,
the SSM's split norm and the vocab-parallel logsumexp sum partial products
in another order, so on a mesh with a ``model`` axis the step is held to a
measured tolerance of the plain step, as the reference's GSPMD step on
(1, 4) is not bit for bit either.  Over data-parallel axes alone the
gradient is a mean of per-shard gradients, summed in another order, and is
held to a measured tolerance.  The compressed step on a (2, 2, 1) pod x data x
model mesh must train.  One reference subprocess with 4 host devices, on
``jax.sharding.Mesh``es built directly (``jax.make_mesh`` makes Explicit
axes under jax 0.9), runs ``TreeCodec.compress_tree_sharded``, gives
``NamedSharding.devices_indices_map`` for the restore's specs, and jits the
reference's plain step (GSPMD) on each mesh with its state and batch
placed by its own specs, from the port's initial parameters: the port's
sharded step is held to it as tests/test_torch_train.py holds the plain
step to the reference -- the first loss within 1e-6 relative, the next
within 1e-4, the parameters within 1e-3 and 99 % of them within 1e-5
(measured on these inputs, torch 2.13 and jax 0.9, x86-64 CPU: losses
within 1.6e-7 relative, parameters within 5.1e-5 and 99.999 % of them
within 1e-5).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
# (name, arch, mesh shape over ("data", "model"), config overrides)
TRAIN = [
    ("dense_1x4", "llama3.2-1b", (1, 4), {}),
    ("moe_1x4", "deepseek-moe-16b", (1, 4), {}),
    ("hybrid_1x4_remat", "hymba-1.5b", (1, 4), {"remat": True}),
    ("dense_2x2_remat", "llama3.2-1b", (2, 2), {"remat": True}),
    ("ssm_2x2", "mamba2-1.3b", (2, 2), {}),
    ("moe_4x1_fsdp", "deepseek-moe-16b", (4, 1), {"fsdp": True}),
    ("moe_2x2_fsdp_remat", "deepseek-moe-16b", (2, 2), {"fsdp": True, "remat": True}),
    ("dense_4x1_fsdp", "llama3.2-1b", (4, 1), {"fsdp": True}),
    ("audio_1x4", "whisper-medium", (1, 4), {}),
    ("vlm_1x4", "internvl2-1b", (1, 4), {}),
    ("ssm_1x4_remat", "mamba2-1.3b", (1, 4), {"remat": True}),
]
# every mesh with a 'model' axis: tensor-parallel
TENSOR_PARALLEL = [t[0] for t in TRAIN if t[2][1] > 1]
DATA_PARALLEL = [t[0] for t in TRAIN if t[0] not in TENSOR_PARALLEL]
# the data-parallel meshes against the plain step after 3 steps: each
# rank's gradient is its shard's, averaged over the ranks, so the sums run
# in another order (the MoE's balance loss through all-reduced means); an
# AdamW update of a near-zero gradient then moves by up to ~lr.  Measured
# on these inputs (torch 2.13, x86-64 CPU): parameters within 2.2e-6 (moe
# 4x1) .. 3.9e-6 (dense 4x1), 4e-5 .. 9e-5 of them past 1e-7; losses within
# 1.46e-7 relative.  Each limit is about twice its measured maximum, inside
# the 2.6e-5 that the unsharded step meets against the reference
PARAM_ATOL = 1.1e-5
LOSS_RTOL = 3e-7
# the tensor-parallel meshes against the plain step after 3 steps: the
# row-parallel all-reduces, the SSM's split norm, the vocab-parallel
# logsumexp and the clip norm's ranks sum partial results in another
# order.  Measured on these inputs (torch 2.13, x86-64 CPU): parameters
# within 5.5e-6 (dense 1x4), 6.9e-6 (ssm 1x4), 1.0e-5 (ssm 2x2), 1.5e-5
# (dense 2x2), 2.0e-5 (vlm 1x4), 2.2e-5 (moe 1x4), 3.2e-5 (moe 2x2) and
# 3.7e-5 (hybrid 1x4), 1e-4 .. 9e-4 of them past 1e-7; losses within
# 1.51e-7 relative.  Each limit is about twice its measured maximum, far
# inside the reference criterion's 1e-3
TP_PARAM_ATOL = 7e-5
TP_LOSS_RTOL = 3e-7
# whisper-medium on (1, 4), its encoder's K/V feeding every decoder
# layer's cross-attention: parameters within 7.39e-5 of the plain step,
# 2.2e-3 of them past 1e-7, and within 2.72e-5 of the reference's GSPMD
# step; the limit is twice its measured maximum
TP_PARAM_ATOL_OF = {"audio_1x4": 1.5e-4}
# restore(shardings=) onto (2, 2): leaf -> spec over ("data", "model")
RESTORE_SPECS = {"w": ("data", "model"), "b": (None,), "e": (("data", "model"), None),
                 "r": (None, "model")}


# the stub frames and image embeddings of batch i, the same in every process
EXTRA = r"""
def extra(cfg, i):
    rng = np.random.default_rng(100 + i)
    out = {}
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal((4, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.prefix_embeds:
        out["image_embeds"] = rng.standard_normal(
            (4, cfg.prefix_embeds, cfg.d_model)).astype(np.float32)
    return out
"""


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(24)
    np.savez(
        path,
        # compress_tree_sharded's tree: leaves of 4 dtypes, raw and SZx
        t_w=rng.standard_normal((1000, 37)).astype(np.float32),
        t_b=(rng.standard_normal(513) * 10).astype(np.float32),
        t_h=rng.standard_normal(3001).astype(np.float16),
        t_d=np.cumsum(rng.standard_normal(5000)).astype(np.float64),
        t_i=rng.integers(0, 100, 10).astype(np.int32),
        t_bf=rng.standard_normal(4099).astype(np.float32),       # as bfloat16 below
        # restore's leaves
        r_w=rng.standard_normal((64, 40)).astype(np.float32),
        r_b=rng.standard_normal(40).astype(np.float32),
        r_e=rng.standard_normal((128, 16)).astype(np.float32),
        r_r=rng.standard_normal((3, 2048)).astype(np.float32),
    )


REFERENCE = r"""
import io, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.core.codec import SZxCodec, TreeCodec

d = dict(np.load(sys.argv[1]))
devs = np.array(jax.devices()[:4])
tree = {{"w": d["t_w"], "b": d["t_b"], "h": d["t_h"], "d": d["t_d"], "i": d["t_i"],
        "bf": np.asarray(jnp.asarray(d["t_bf"], jnp.bfloat16))}}
out = {{}}
for name, bound in (("rel", None), ("abs", 1e-3)):
    buf = io.BytesIO()
    mesh = Mesh(devs.reshape(4, 1), ("data", "model"))
    TreeCodec(codec=SZxCodec(backend="numpy"), bound=bound).compress_tree_sharded(tree, buf, mesh)
    out["tree_" + name] = np.frombuffer(buf.getvalue(), np.uint8)
try:
    TreeCodec().compress_tree_sharded(tree, io.BytesIO(), Mesh(devs.reshape(4, 1), ("pod", "model")))
except ValueError as e:
    out["no_axis"] = np.array(str(e))
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
for leaf, spec in {specs!r}.items():
    shape = d["r_" + leaf].shape
    idx = NamedSharding(mesh, PS(*spec)).devices_indices_map(shape)
    out[f"restore/{{leaf}}/whole"] = d["r_" + leaf]
    out[f"restore/{{leaf}}/index"] = np.array(
        [[s.indices(n)[:2] for s, n in zip(idx[dev], shape)] for dev in devs])

# the reference's plain step (GSPMD) jitted on each data-parallel mesh, its
# state and batch placed by its own specs, from the port's initial
# parameters (layers stacked) and on the same tokens
import dataclasses
import torch
from repro import configs as rconfigs
from repro.data import DataConfig, SyntheticLM
from repro.launch import mesh as rmesh
from repro.models import transformer as RT
from repro.optim import AdamW
from repro.train import step as rstep
from repro_torch import configs as pconfigs
from repro_torch.core import pytree
from repro_torch.optim import AdamW as PAdamW
from repro_torch.train import step as S

def stacked_path(name):
    # a port leaf path -> (the reference's path, layer index or None)
    parts = name.split("/")
    k = parts.index("layers") + 1 if "layers" in parts else 0
    if k:
        return "/".join(parts[:k] + parts[k + 1:]), int(parts[k])
    return name, None

def path_str(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

{extra}
ropt = AdamW(lr=1e-3, weight_decay=0.0)
for name, arch, shape, over in {train!r}:
    rcfg = dataclasses.replace(rconfigs.get(arch).reduced(), **over)
    pcfg = dataclasses.replace(pconfigs.get(arch).reduced(), **over)
    init = S.init_state(pcfg, PAdamW(lr=1e-3), torch.Generator().manual_seed(7),
                        device="cpu")["params"]
    named = [(n, t.numpy()) for n, t in pytree.leaf_paths(init)]
    layers = {{}}
    for n, a in named:
        rp, i = stacked_path(n)
        layers.setdefault(rp, []).append(a)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, leaf: np.stack(layers[path_str(kp)]) if "layers/" in path_str(kp)
        else layers[path_str(kp)][0],
        RT.init_params(rcfg, jax.random.key(0)))
    mesh = Mesh(devs.reshape(shape), ("data", "model"))
    state = {{"params": params, "opt": ropt.init(params)}}
    is_spec = lambda s: isinstance(s, PS)
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
    ssh = sh(rstep.state_specs(rcfg, state, mesh))
    ds = SyntheticLM(DataConfig(rcfg.vocab_size, 32, 4, seed=3))
    bs = [{{k: jnp.asarray(v) for k, v in {{**ds.batch_at(i), **extra(rcfg, i)}}.items()}}
          for i in range(3)]
    bsh = sh(rmesh.batch_specs_tree(rcfg, mesh, bs[0]))
    fn = jax.jit(rstep.make_train_step(rcfg, ropt), in_shardings=(ssh, bsh),
                 out_shardings=(ssh, None))
    state, losses = jax.device_put(state, ssh), []
    for b in bs:
        state, m = fn(state, jax.device_put(b, bsh))
        losses.append(float(m["loss"]))
    final = {{path_str(kp): np.asarray(v)
             for kp, v in jax.tree_util.tree_leaves_with_path(state["params"])}}
    out[name + "/gspmd_loss"] = np.array(losses)
    out[name + "/gspmd_params"] = np.concatenate([
        (final[rp] if i is None else final[rp][i]).ravel()
        for rp, i in (stacked_path(n) for n, _ in named)])
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""

WORKER = r"""
import dataclasses, io, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pytree
from repro_torch.core.codec import SZxCodec
from repro_torch.core.codec.tree import TreeCodec
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.optim import AdamW
from repro_torch.models import sharding
from repro_torch.roofline import hlo_cost
from repro_torch.train import step as S

TRAIN, SPECS = {train!r}, {specs!r}
rank, store, inputs, dest, ckdir = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                    sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
d = {{k: torch.from_numpy(v) for k, v in np.load(inputs).items()}}
out = {{}}

def mesh_of(shape, names=("data", "model")):
    return init_device_mesh("cpu", shape, mesh_dim_names=names)

{extra}

def batches(cfg):
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=3))
    return [{{k: torch.as_tensor(v) for k, v in {{**ds.batch_at(i), **extra(cfg, i)}}.items()}}
            for i in range(3)]

def plain_run(cfg, opt, bs):
    state = S.init_state(cfg, opt, torch.Generator().manual_seed(7), device="cpu")
    fn = S.make_train_step(cfg, opt)
    losses, norms = [], []
    for b in bs:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms

def sharded_run(cfg, opt, bs, mesh, P=0):
    state = S.init_sharded_state(cfg, opt, torch.Generator().manual_seed(7), mesh,
                                 ef_planes=P, device="cpu")
    fn = S.make_train_step(cfg, opt, mesh=mesh, compress_planes=P)
    losses, norms = [], []
    for b in bs:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms

opt = AdamW(lr=1e-3, weight_decay=0.0)
for name, arch, shape, over in TRAIN:
    cfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    bs = batches(cfg)
    ref_state, ref_losses, ref_norms = plain_run(cfg, opt, bs)
    state, losses, norms = sharded_run(cfg, opt, bs, mesh_of(shape))
    full = [p.full_tensor() for p in pytree.leaves(state["params"])]
    local = [p.to_local() for p in pytree.leaves(state["params"])]
    out[name + "/plain_loss"] = np.array(ref_losses)
    out[name + "/loss"] = np.array(losses)
    out[name + "/plain_grad_norm"] = np.array(ref_norms)
    out[name + "/grad_norm"] = np.array(norms)
    out[name + "/plain_params"] = torch.cat([p.reshape(-1) for p in pytree.leaves(ref_state["params"])]).numpy()
    out[name + "/params"] = torch.cat([p.reshape(-1) for p in full]).numpy()
    out[name + "/local_numel"] = np.array(sum(p.numel() for p in local))
    out[name + "/step"] = np.array(int(state["opt"].step.to_local()))
    moments = [m.to_local() for m in pytree.leaves(state["opt"].m)]
    out[name + "/m_local_numel"] = np.array(sum(m.numel() for m in moments))

# the compressed step on a (2, 2, 1) pod x data x model mesh
cfg = configs.get("llama3.2-1b").reduced()
bs = batches(cfg)
state, losses, _ = sharded_run(cfg, opt, bs, mesh_of((2, 2, 1), ("pod", "data", "model")), P=1)
out["compressed/loss"] = np.array(losses)
ef = pytree.leaves(state["ef"])
out["compressed/ef_rows"] = np.array([e.to_local().shape[0] for e in ef])
out["compressed/ef_nonzero"] = np.array(sum(int(e.to_local().float().abs().sum() > 0) for e in ef))

# a sharded matmul over two ranks: the (256, 256) weight gathered whole over
# 'model' through sharding.weight, its gradient averaged over 'data'
mesh = mesh_of((2, 2))
w = M.NamedSharding(mesh, M.P(None, "model")).shard(torch.ones(256, 256))
lay = sharding.layout_of(w)
x = w.to_local().detach().requires_grad_()
with hlo_cost.OpCounter(mesh) as c, sharding.use_rules(mesh), \
        sharding.split_batch([mesh.get_group(0)], 2, (0,)):
    y = torch.ones(8, 256) @ sharding.weight(sharding.Shard(x, lay, w.shape))[0]
    y.sum().backward()
    grad = sharding.batch_grad(x.grad, lay)
out["matmul/coll"] = np.array([c.coll[k] for k in hlo_cost.COLL_KINDS])
out["matmul/flops"] = np.array(c.flops)
out["matmul/grad"] = grad.numpy()

# compress_tree_sharded on a (4, 1) mesh, leaves as DTensors and as tensors
mesh = mesh_of((4, 1))
tree = {{"w": d["t_w"], "b": d["t_b"], "h": d["t_h"], "d": d["t_d"], "i": d["t_i"],
        "bf": d["t_bf"].to(torch.bfloat16)}}
tree["w"] = M.NamedSharding(mesh, M.P("data", None)).shard(tree["w"])
for name, bound in (("rel", None), ("abs", 1e-3)):
    buf = io.BytesIO()
    man = TreeCodec(codec=SZxCodec(device="cpu"), bound=bound).compress_tree_sharded(tree, buf, mesh)
    out["tree_" + name] = np.frombuffer(buf.getvalue(), np.uint8)
    out["tree_" + name + "/stored"] = np.array(man["stored_bytes"])
try:
    TreeCodec(codec=SZxCodec(device="cpu")).compress_tree_sharded(tree, io.BytesIO(), mesh, axis="pod")
except ValueError as e:
    out["no_axis"] = np.array(str(e))

# a checkpoint saved over the (4, 1) mesh's 'data' axis (the SZx leaves
# shard by shard), restored with shardings onto (2, 2)
tree = {{k: d["r_" + k] for k in SPECS}}
ck = CheckpointManager(ckdir, compress=True, device="cpu")
man = ck.save(5, tree, mesh=mesh)
out["save/frames"] = np.array([len(man["frames"])])
mesh = mesh_of((2, 2))
shardings = {{k: M.NamedSharding(mesh, M.P(*v)) for k, v in SPECS.items()}}
restored, step = ck.restore(tree, shardings=shardings)
out["restore/step"] = np.array(step)
for k, v in restored.items():
    out["restore/" + k] = v.to_local().numpy()
    out["restore/" + k + "/full"] = v.full_tensor().numpy()
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref, ranks)``: the reference's outputs and each rank's."""
    tmp = tmp_path_factory.mktemp("sharded")
    _inputs(tmp / "in.npz")
    # one thread a process: the five processes share the host with the
    # other test workers
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(specs=RESTORE_SPECS, train=TRAIN, extra=EXTRA),
         str(tmp / "in.npz"),
         str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER.format(train=TRAIN, specs=RESTORE_SPECS, extra=EXTRA), str(r),
             str(tmp / "store"), str(tmp / "in.npz"), str(tmp / f"rank{r}.npz"),
             str(tmp / "ckpt")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    logs = []
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log, tag in zip(logs, ["REFERENCE-OK"] + ["WORKER-OK"] * 4):
        assert tag in log, log[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(tmp / f"rank{r}.npz"))
                                             for r in range(4)]


@pytest.mark.parametrize("name", DATA_PARALLEL)
def test_data_parallel_mesh_matches_the_plain_step(runs, name):
    _, ranks = runs
    for rk in ranks:
        np.testing.assert_allclose(rk[name + "/loss"], rk[name + "/plain_loss"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(rk[name + "/params"], rk[name + "/plain_params"],
                                   rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("name", TENSOR_PARALLEL)
def test_tensor_parallel_mesh_matches_the_plain_step(runs, name):
    _, ranks = runs
    for rk in ranks:
        np.testing.assert_allclose(rk[name + "/loss"], rk[name + "/plain_loss"],
                                   rtol=TP_LOSS_RTOL, atol=0)
        np.testing.assert_allclose(rk[name + "/params"], rk[name + "/plain_params"],
                                   rtol=0, atol=TP_PARAM_ATOL_OF.get(name, TP_PARAM_ATOL))
        assert int(rk[name + "/step"]) == 3


# the clip norm of every step against the plain step's (its float32 sums of
# squares by mesh dims, then all-reduced): measured on these inputs (torch
# 2.13, x86-64 CPU) within 7.3e-7 relative (moe 2x2); twice that
NORM_RTOL = 1.5e-6


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_clip_norm_counts_each_leaf_once(runs, name):
    """AdamW's global norm of the sharded gradient -- each rank's shards'
    squares, a leaf replicated over a mesh dim (the norms, the SSM's
    per-head vectors) counted once -- is the plain step's at every step."""
    _, ranks = runs
    for rk in ranks:
        np.testing.assert_allclose(rk[name + "/grad_norm"], rk[name + "/plain_grad_norm"],
                                   rtol=NORM_RTOL, atol=0)


def _holds_to_gspmd(ref, ranks, name):
    want_loss, want = ref[name + "/gspmd_loss"], ref[name + "/gspmd_params"]
    for rk in ranks:
        loss = rk[name + "/loss"]
        np.testing.assert_allclose(loss[0], want_loss[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(loss[1:], want_loss[1:], rtol=1e-4, atol=0)
        d = np.abs(rk[name + "/params"] - want)
        assert d.shape == want.shape
        assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.99, (d.max(), (d <= 1e-5).mean())


@pytest.mark.parametrize("name", [t[0] for t in TRAIN if t[2][0] > 1])
def test_data_parallel_mesh_matches_the_reference_gspmd_step(runs, name):
    ref, ranks = runs
    _holds_to_gspmd(ref, ranks, name)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN if t[2][0] == 1])
def test_model_only_mesh_matches_the_reference_gspmd_step(runs, name):
    """The reference's GSPMD step on (1, 4) computes tensor-parallel, as
    the port's step does for every family."""
    ref, ranks = runs
    _holds_to_gspmd(ref, ranks, name)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_each_rank_holds_its_shards(runs, name):
    """The parameters and moments a rank holds are the spec's share: a
    quarter of every leaf sharded over the four ranks."""
    _, ranks = runs
    total = ranks[0][name + "/params"].size
    held = [int(rk[name + "/local_numel"]) for rk in ranks]
    assert len(set(held)) == 1 and held[0] < total
    assert all(int(rk[name + "/m_local_numel"]) == h for rk, h in zip(ranks, held))
    # every rank ends with the same whole parameters
    assert all(np.array_equal(rk[name + "/params"], ranks[0][name + "/params"]) for rk in ranks)


def test_compressed_sharded_step_trains(runs):
    """The reference test's criterion (tests/test_grad_compress.py): the
    compressed step's final loss within 8 % of the plain step's; the loss
    falls; the error feedback holds one pod row a rank and is used."""
    _, ranks = runs
    plain = ranks[0]["dense_2x2_remat/plain_loss"]
    for rk in ranks:
        loss = rk["compressed/loss"]
        assert np.isfinite(loss).all() and loss[-1] < loss[0]
        assert abs(loss[-1] - plain[-1]) <= 0.08 * abs(plain[-1]), (loss, plain)
        assert set(rk["compressed/ef_rows"].tolist()) == {1}
        assert int(rk["compressed/ef_nonzero"]) > 0


def test_sharded_matmul_collective_bytes(runs):
    """A (256, 256) float32 weight sharded over two 'model' ranks, read
    whole through ``sharding.weight``: the gather moves at least the whole
    weight; the gradient is sliced back to the shard and all-reduced over
    'data' (``sharding.batch_grad``)."""
    _, ranks = runs
    for rk in ranks:
        coll = dict(zip(("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                         "collective-permute"), rk["matmul/coll"].tolist()))
        assert coll["all-gather"] >= 256 * 256 * 4
        assert coll["all-reduce"] >= 256 * 128 * 4
        assert int(rk["matmul/flops"]) >= 2 * 8 * 256 * 256
        # d(sum(ones @ W))/dW = 8 everywhere, summed over the two data ranks / 2
        np.testing.assert_array_equal(rk["matmul/grad"], np.full((256, 128), 8.0, np.float32))


@pytest.mark.parametrize("bound", ["rel", "abs"])
def test_compress_tree_sharded_is_byte_identical_to_reference(runs, bound):
    ref, ranks = runs
    got = ranks[0]["tree_" + bound]
    assert got.size and np.array_equal(got, ref["tree_" + bound])
    assert all(int(rk["tree_" + bound + "/stored"]) == got.size - _footer(got) for rk in ranks)
    assert not any(rk["tree_" + bound].size for rk in ranks[1:])


def _footer(stream: np.ndarray) -> int:
    """Bytes of the stream past its manifest's ``stored_bytes`` (the index
    footer), read with the port's container parser."""
    import io

    from repro_torch.core.codec import SZxCodec
    from repro_torch.core.codec.tree import TreeCodec

    man = TreeCodec(codec=SZxCodec(device="cpu")).read_manifest(io.BytesIO(stream.tobytes()))
    return stream.size - man["stored_bytes"]


def test_compress_tree_sharded_refuses_a_missing_axis(runs):
    ref, ranks = runs
    assert "no axis 'pod'" in str(ranks[0]["no_axis"])
    assert "no axis 'data'" in str(ref["no_axis"])


@pytest.mark.parametrize("leaf", sorted(RESTORE_SPECS))
def test_restore_onto_a_mesh_gives_each_rank_the_reference_shard(runs, leaf):
    """The checkpoint's SZx leaves (rel 1e-6) come back within their bound;
    each rank's shard is the reference's ``devices_indices_map`` slice of
    the restored leaf, and the small leaf is raw, exact."""
    ref, ranks = runs
    orig = ref[f"restore/{leaf}/whole"]
    whole = ranks[0]["restore/" + leaf + "/full"]
    e = 1e-6 * float(orig.max() - orig.min())
    assert np.abs(whole - orig).max() <= e * (1 + 1e-6)
    if orig.size < 1024:
        assert np.array_equal(whole, orig)
    cut = ref[f"restore/{leaf}/index"]
    for r, rk in enumerate(ranks):
        assert int(rk["restore/step"]) == 5
        sl = tuple(slice(int(a), int(b)) for a, b in cut[r])
        assert np.array_equal(rk["restore/" + leaf], whole[sl]), (leaf, r)
        assert np.array_equal(rk["restore/" + leaf + "/full"], whole)
    # one frame a shard of each of the three SZx leaves, and the raw pack
    assert all(int(rk["save/frames"][0]) == 1 + 3 * 4 for rk in ranks)
