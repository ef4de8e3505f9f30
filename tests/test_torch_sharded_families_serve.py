"""The port's serving of the SSM, hybrid, audio and VLM families under a
device mesh on gloo ranks, against the unsharded port engine and the JAX
package's GSPMD-partitioned engine.

Four worker processes form a gloo group on a ``FileStore`` under the
test's temporary directory and build ``DeviceMesh``es over it; three more
form another group for a 3-way ``model`` axis.  Each case is a reduced
config -- mamba2-1.3b (8 SSM heads of 16, Z = 296, CC = 160), hymba-1.5b
(4 query heads over 1 kv head, window 32, the same SSM), whisper-medium (2
encoder and 2 decoder layers over 24 stub frames) and internvl2-1b (8 stub
image embeddings before the tokens) -- on a ``model``-only (1, 4), a
(2, 2) data x model or a (1, 3) mesh: the parameters drawn from a seed on
the CPU, placed as ``DTensor``s by ``param_specs_tree``, a prefill of 4
prompts of 16 tokens and three decode steps of given tokens inside
``use_rules``, with dense and P = 1 caches.  On (1, 3) the reduced SSM's
8 heads split 3, 3, 2 and hymba's 4 query heads 2, 2, 0; ``in``, ``conv``
and ``out`` stay whole there (Z, CC and d_inner do not divide 3), so the
rank runs its heads from whole weights.  One reference subprocess with 4
host devices builds each ``jax.sharding.Mesh`` directly (``jax.make_mesh``
makes Explicit axes under jax 0.9) and jits ``repro.serve.engine``'s
``prefill``/``decode_step`` inside ``repro.models.sharding.use_rules``
with ``NamedSharding`` in-shardings from its spec trees, from the port's
initial parameters.

Tolerances, as shares of the largest |value| (measured on these inputs,
torch 2.13 and jax 0.9, x86-64 CPU):
  - prefill logits within 1e-5 of the unsharded port's and of the
    reference's (measured up to 1.4e-6 and 1.9e-6: the row-parallel
    partial sums and the SSM's split norm are summed in another order);
  - decode logits within 3e-2 of both (measured up to 5.7e-3 and
    8.9e-5; the placed cache's first step up to 3.9e-3): the decode
    scores' float32 cross-shard sum, self- and cross-attention alike, is
    rounded to bf16 once, as the reference's compiled ``_reduce_scores``
    rounds it.  With the scores summed in float32 (``_reduce_scores`` patched
    in the worker) the sharded decode is held to 2e-5 of the unsharded
    port's (measured up to 1.2e-6; mamba2-1.3b has no scores, and its two
    runs are the same);
  - the prefill's SSM state and conv tail, the dense K/V, the compressed
    records' mu and the cross K/V within 1e-5 of the largest of them,
    against the unsharded port's and the reference's (measured up to
    1.6e-6 and 2.8e-6).

The 4-rank group also runs the four families' sharded training step on
(1, 4), and the 3-rank group hymba-1.5b's on (1, 3) (heads 3, 3, 2 and
query heads 2, 2, none), tensor-parallel along ``model``, against the
plain step over two steps: the row-parallel all-reduces, the SSM's split
norm and the vocab-parallel logsumexp sum in another order, so it is held
to a measured tolerance.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 4, 16, 3
ARCHS = {"mamba2": "mamba2-1.3b", "hymba": "hymba-1.5b", "whisper": "whisper-medium",
         "internvl2": "internvl2-1b"}
MODES = (("dense", 1), ("p1", 1))


def _cases(meshes):
    return [(f"{short}_{m[0]}x{m[1]}_{tag}", arch, m, "dense" if tag == "dense" else "compressed",
             planes) for short, arch in ARCHS.items() for m in meshes for tag, planes in MODES]


# (name, arch, mesh shape over ("data", "model"), kv_mode, planes)
CASES4 = _cases([(1, 4), (2, 2)])
CASES3 = _cases([(1, 3)])
CASES = CASES4 + CASES3
NAMES = [c[0] for c in CASES]
PREFILL_TOL = 1e-5
DECODE_TOL = 3e-2
DECODE_F32_TOL = 2e-5
RECORD_TOL = 1e-5
# the training step against the plain step over two steps, measured on
# these inputs (torch 2.13, x86-64 CPU): parameters within 3.5e-6
# (internvl2-1b), 6.9e-6 (mamba2-1.3b), 2.0e-5 (hymba-1.5b on (1, 3)),
# 3.7e-5 (hymba-1.5b) and 4.8e-5 (whisper-medium), losses within 1.44e-7
# relative, a rank's flops 0.250-0.254 of the plain step's on (1, 4); each
# limit about twice its maximum.  On (1, 3) no weight of the reduced
# hymba-1.5b splits (3 divides none of its split dims), only the heads: a
# rank's flops 0.90-0.94 of the plain step's
# the training cases by group size: (name, arch, mesh shape)
TRAIN = {4: [(short, arch, (1, 4)) for short, arch in ARCHS.items()],
         3: [("hymba_1x3", "hymba-1.5b", (1, 3))]}
TRAIN_LOSS_RTOL = 3e-7
TRAIN_PARAM_ATOL = 1e-4
TRAIN_FLOPS_SHARE = 0.5
TRAIN_FLOPS_SHARE_OF = {"hymba_1x3": 0.97}

COMMON = r"""
import numpy as np
import torch
from repro_torch import configs as pconfigs
from repro_torch.core import pytree
from repro_torch.models import transformer as T
B, S, STEPS = {B}, {S}, {STEPS}
CASES = {cases!r}

def port_model(arch):
    cfg = pconfigs.get(arch).reduced()
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")

def inputs(cfg):
    # tokens (B, S + STEPS); frames (B, T, D) or image embeddings (B, P, D)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    extra = {{}}
    if cfg.encoder_decoder:
        extra["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.prefix_embeds:
        extra["image_embeds"] = rng.standard_normal(
            (B, cfg.prefix_embeds, cfg.d_model)).astype(np.float32)
    return toks, extra

def seq_len(cfg):
    return cfg.prefix_embeds + S + STEPS
"""

REFERENCE = COMMON + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro import configs as rconfigs
from repro.launch import mesh as rmesh
from repro.models import sharding as rsharding, transformer as RT
from repro.serve import engine as RE

devs = np.array(jax.devices()[:4])

def path_str(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def ref_params(arch):
    # the port's initial parameters, layers stacked as the reference's
    rcfg = rconfigs.get(arch).reduced()
    _cfg, model = port_model(arch)
    stacked = {{}}
    for n, t in pytree.leaf_paths(T.param_tree(model)):
        parts = n.split("/")
        i = 1 if parts[0] == "layers" else 2 if parts[:2] == ["encoder", "layers"] else None
        key = n if i is None else "/".join(parts[:i] + parts[i + 1:])
        stacked.setdefault(key, []).append(t.numpy())
    def leaf(kp, _leaf):
        p = path_str(kp)
        return np.stack(stacked[p]) if "layers/" in p else stacked[p][0]
    return rcfg, jax.tree_util.tree_map_with_path(leaf, RT.param_specs(rcfg))

out = {{}}
for name, arch, shape, mode, P in CASES:
    rcfg, params = ref_params(arch)
    toks, extra = inputs(rcfg)
    mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"))
    pspecs = rmesh.param_specs_tree(rcfg, params, mesh)
    is_spec = lambda s: isinstance(s, PS)
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
    cspecs = rmesh.cache_specs_tree(rcfg, mesh, RE.cache_specs(rcfg, B, seq_len(rcfg),
                                                                kv_mode=mode, num_planes=P))
    csh = sh(cspecs)
    bsh = NamedSharding(mesh, PS("data", None))
    esh = {{k: NamedSharding(mesh, PS("data", None, None)) for k in extra}}
    with rsharding.use_rules(mesh):
        pre = jax.jit(lambda p, t, e: RE.prefill(p, rcfg, t, seq_len=seq_len(rcfg), kv_mode=mode,
                                                 num_planes=P, **e),
                      in_shardings=(sh(pspecs), bsh, esh))
        dec = jax.jit(lambda p, c, t: RE.decode_step(p, rcfg, c, t, kv_mode=mode, num_planes=P),
                      in_shardings=(sh(pspecs), csh, bsh))
        p_ = jax.device_put(params, sh(pspecs))
        cache, logits = pre(p_, jnp.asarray(toks[:, :S]), {{k: jnp.asarray(v) for k, v in extra.items()}})
        for part in ("layers", "cross"):
            for k, v in cache.get(part, {{}}).items():
                out[f"{{name}}/{{part}}/{{k}}"] = np.asarray(v)
        lg = [np.asarray(logits)]
        for t in range(STEPS):
            cache = jax.device_put(cache, csh)
            logits, cache = dec(p_, cache, jnp.asarray(toks[:, S + t:S + t + 1]))
            lg.append(np.asarray(logits))
    out[name + "/logits"] = np.stack(lg)
np.savez(sys.argv[1], **out)
print("REFERENCE-OK")
"""

WORKER = COMMON + r"""
import sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH
from repro_torch.optim import AdamW
from repro_torch.serve import engine as E
from repro_torch.train import step as TS

rank, world, store, dest = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
out = {{}}
bf16_reduce = E._reduce_scores

def f32_reduce(s, dims=()):
    return SH.all_reduce(s, dims)

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def records(cache):
    return {{f"{{part}}/{{k}}": v for part in ("layers", "cross") for k, v in cache.get(part, {{}}).items()}}

def run(params, cfg, toks, extra, mode, P, rules_mesh=None):
    ctx = SH.use_rules(rules_mesh) if rules_mesh is not None else torch.no_grad()
    with ctx:
        cache, logits = E.prefill(params, cfg, torch.from_numpy(toks[:, :S]), seq_len=seq_len(cfg),
                                  kv_mode=mode, num_planes=P,
                                  **{{k: torch.from_numpy(v) for k, v in extra.items()}})
        first = {{k: (v.to_local().clone() if hasattr(v, "to_local") else v.clone(), full(v).clone())
                 for k, v in records(cache).items()}}
        prefilled = {{"pos": cache["pos"], "slot_pos": full(cache["slot_pos"]).clone(),
                     **{{part: {{k: full(v).clone() for k, v in cache[part].items()}}
                        for part in ("layers", "cross") if part in cache}}}}
        lg = [full(logits)]
        for t in range(STEPS):
            logits, cache = E.decode_step(params, cfg, cache,
                                          torch.from_numpy(toks[:, S + t:S + t + 1]),
                                          kv_mode=mode, num_planes=P)
            lg.append(full(logits))
    return first, prefilled, torch.stack(lg)

for name, arch, shape, mode, P in CASES:
    cfg, model = port_model(arch)
    toks, extra = inputs(cfg)
    plain_first, prefilled, plain_logits = run(model, cfg, toks, extra, mode, P)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coords = mesh.get_coordinate()
    tree = T.param_tree(model)
    specs = M.param_specs_tree(cfg, tree, mesh)
    params = M.shard_tree(tree, specs, mesh)
    out[name + "/params_local_ok"] = np.array(all(
        torch.equal(p.to_local(), w[M.local_index(s, w.shape, mesh, coords)])
        for p, w, s in zip(pytree.leaves(params), pytree.leaves(tree), pytree.leaves(specs))))
    first, _, logits = run(params, cfg, toks, extra, mode, P, mesh)
    with SH.use_rules(mesh):
        cspecs = M.serve_cache_specs(mesh, E.cache_specs(cfg, B, seq_len(cfg), kv_mode=mode,
                                                         num_planes=P))
    cache_ok = True
    for k, (loc, whole) in first.items():
        part, leaf = k.split("/")
        idx = M.local_index(cspecs[part][leaf], whole.shape, mesh, coords)
        cache_ok &= torch.equal(loc, whole[idx])
        out[f"{{name}}/{{k}}"] = whole.numpy()
        out[f"{{name}}/plain/{{k}}"] = plain_first[k][1].numpy()
        out[f"{{name}}/local_shape/{{k}}"] = np.array(loc.shape)
    out[name + "/cache_local_ok"] = np.array(cache_ok)
    out[name + "/cache_specs"] = np.array(repr({{p: cspecs[p] for p in ("layers", "cross")
                                                 if p in cspecs}}))
    # the unsharded prefill's cache placed on the mesh, and a decode step from it
    with SH.use_rules(mesh):
        placed = M.shard_cache(prefilled, cspecs, mesh)
        out[name + "/placed_ok"] = np.array(all(
            torch.equal(placed[part][k].to_local(),
                        v[M.local_index(cspecs[part][k], v.shape, mesh, coords)])
            for part in ("layers", "cross") if part in prefilled
            for k, v in prefilled[part].items()))
        lg, _ = E.decode_step(params, cfg, placed, torch.from_numpy(toks[:, S:S + 1]),
                              kv_mode=mode, num_planes=P)
    out[name + "/placed_logits"] = full(lg).numpy()
    out[name + "/logits"] = logits.numpy()
    out[name + "/plain_logits"] = plain_logits.numpy()
    E._reduce_scores = f32_reduce
    try:
        out[name + "/logits_f32"] = run(params, cfg, toks, extra, mode, P, mesh)[2].numpy()
    finally:
        E._reduce_scores = bf16_reduce
    out[name + "/coords"] = np.array(coords)

if {train!r}:
    # the families' sharded training step, tensor-parallel, against the
    # plain step over two steps: each step's flops (OpCounter) and the
    # 'model'-split parameters sharding.weight gathers whole
    from repro_torch.roofline import hlo_cost

    weight = SH.weight
    whole = set()

    def spy(w, keep=()):
        t, lay = weight(w, keep)
        if any(1 in dims for dims in SH.layout_of(w)) and not any(1 in dims for dims in lay):
            whole.add(tuple(w.shape))
        return t, lay

    SH.weight = spy
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    for short, arch, shape in {train!r}:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cfg = pconfigs.get(arch).reduced()
        ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=3))
        gen = torch.Generator().manual_seed(5)
        bs = []
        for i in range(2):
            b = {{k: torch.as_tensor(v) for k, v in ds.batch_at(i).items()}}
            if cfg.encoder_decoder:
                b["frames"] = torch.randn(4, cfg.encoder_len, cfg.d_model, generator=gen)
            if cfg.prefix_embeds:
                b["image_embeds"] = torch.randn(4, cfg.prefix_embeds, cfg.d_model, generator=gen)
            bs.append(b)
        state = TS.init_state(cfg, opt, torch.Generator().manual_seed(7), device="cpu")
        fn = TS.make_train_step(cfg, opt)
        sstate = TS.init_sharded_state(cfg, opt, torch.Generator().manual_seed(7), mesh,
                                       device="cpu")
        sfn = TS.make_train_step(cfg, opt, mesh=mesh)
        losses, flops = [], []
        whole.clear()
        for b in bs:
            with hlo_cost.OpCounter() as c:
                state, m = fn(state, b)
            with hlo_cost.OpCounter(mesh) as sc:
                sstate, sm = sfn(sstate, b)
            losses.append((float(m["loss"]), float(sm["loss"])))
            flops.append((c.flops, sc.flops))
        out[f"train/{{short}}/losses"] = np.array(losses)
        out[f"train/{{short}}/flops"] = np.array(flops, dtype=np.float64)
        out[f"train/{{short}}/gathered_whole"] = np.array(sorted(whole) or np.empty((0, 2)))
        out[f"train/{{short}}/param_diff"] = np.array(max(
            float((p - q.full_tensor()).abs().max())
            for p, q in zip(pytree.leaves(state["params"]), pytree.leaves(sstate["params"]))))
    SH.weight = weight
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref, ranks)``: the reference's outputs and each rank's, the
    4-rank group's first, then the 3-rank group's."""
    tmp = tmp_path_factory.mktemp("sharded_families_serve")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    ref = REFERENCE.format(B=B, S=S, STEPS=STEPS, cases=CASES)
    procs = [subprocess.Popen([sys.executable, "-c", ref, str(tmp / "ref.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)]
    dests = []
    for world, cases in ((4, CASES4), (3, CASES3)):
        script = WORKER.format(B=B, S=S, STEPS=STEPS, cases=cases, train=TRAIN[world])
        for r in range(world):
            dests.append(tmp / f"w{world}_rank{r}.npz")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(world), str(tmp / f"store{world}"),
                 str(dests[-1])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    logs = []
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log, tag in zip(logs, ["REFERENCE-OK"] + ["WORKER-OK"] * 7):
        assert tag in log, log[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(d)) for d in dests]


def _ranks(ranks, name):
    return ranks[:4] if name in [c[0] for c in CASES4] else ranks[4:]


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _cfg(name):
    from repro_torch import configs

    return configs.get(_case(name)[1]).reduced()


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_shards(runs, name):
    """Each rank's parameter and cache shards are the slices ``local_index``
    names of the whole tensors; the cache is ``cache_specs_tree``'s layout
    except an SSM state whose heads the axis does not divide, which is
    split as the layers split the heads (on (1, 3): 3, 3, 2 of 8)."""
    _, ranks = runs
    cfg = _cfg(name)
    _, _, shape, _, _ = _case(name)
    rks = _ranks(ranks, name)
    coords = {tuple(rk[name + "/coords"].tolist()) for rk in rks}
    assert len(coords) == len(rks)
    for rk in rks:
        assert bool(rk[name + "/params_local_ok"]) and bool(rk[name + "/cache_local_ok"])
        m = int(rk[name + "/coords"][1])
        for k in rk:
            if not k.startswith(name + "/local_shape/"):
                continue
            leaf, local = k.split("/")[-1], tuple(rk[k].tolist())
            whole = rk[f"{name}/{k.split('/', 2)[2]}"].shape
            assert local[1 if leaf[1:] != "pl" else 2] == B // shape[0], k
            if leaf == "state":                         # (L, B, H, N, hp): the rank's heads
                step = -(-cfg.ssm_n_heads // shape[1])
                assert local[2] == min(step, cfg.ssm_n_heads - min(m * step, cfg.ssm_n_heads))
            elif leaf == "conv":                        # (L, B, W-1, CC): split where it divides
                n = shape[1] if whole[3] % shape[1] == 0 else 1
                assert local[3] == whole[3] // n
            elif leaf in ("k", "v") or leaf.endswith("pl"):   # head_dim where it divides
                n = shape[1] if whole[-1] % shape[1] == 0 else 1
                assert local[-1] == whole[-1] // n


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    v = _cfg(name).vocab_size
    rks = _ranks(ranks, name)
    for rk in rks:
        got = rk[name + "/logits"][0][..., :v]
        assert _rel(got, rk[name + "/plain_logits"][0][..., :v]) <= PREFILL_TOL
        assert _rel(got, ref[name + "/logits"][0][..., :v]) <= PREFILL_TOL
        assert np.array_equal(rk[name + "/logits"], rks[0][name + "/logits"])
    rk = rks[0]
    parts = sorted(k[len(name) + 1:] for k in rk
                   if k.startswith((name + "/layers/", name + "/cross/")))
    assert parts
    for k in parts:
        got = rk[f"{name}/{k}"]
        for want in (rk[f"{name}/plain/{k}"], ref[f"{name}/{k}"]):
            assert got.shape == want.shape and got.dtype == want.dtype, k
            leaf = k.split("/")[-1]
            if leaf in ("k", "v", "state", "conv") or leaf.endswith("mu"):
                assert _rel(got, want) <= RECORD_TOL, k
    leaves = {k.split("/")[-1] for k in parts}
    cfg = _cfg(name)
    assert ({"state", "conv"} <= leaves) == (cfg.family in ("ssm", "hybrid"))
    assert any(k.startswith("cross/") for k in parts) == cfg.encoder_decoder


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    v = _cfg(name).vocab_size
    for rk in _ranks(ranks, name):
        got = rk[name + "/logits"][1:, ..., :v]
        for want in (rk[name + "/plain_logits"][1:, ..., :v], ref[name + "/logits"][1:, ..., :v]):
            assert max(_rel(g, w) for g, w in zip(got, want)) <= DECODE_TOL
        # with the scores summed in float32 the decode is the unsharded one's
        f32 = rk[name + "/logits_f32"][1:, ..., :v]
        want = rk[name + "/plain_logits"][1:, ..., :v]
        assert max(_rel(g, w) for g, w in zip(f32, want)) <= DECODE_F32_TOL


@pytest.mark.parametrize("name", NAMES)
def test_decode_from_the_unsharded_cache_placed_on_the_mesh(runs, name):
    """``launch/mesh.shard_cache`` places the unsharded prefill's cache --
    the SSM state and conv tail and the cross K/V with the rest -- each
    rank's slabs the ``local_index`` slices, and the sharded decode step
    from it gives the unsharded first step's logits (the bf16 scores'
    tolerance)."""
    _, ranks = runs
    v = _cfg(name).vocab_size
    for rk in _ranks(ranks, name):
        assert bool(rk[name + "/placed_ok"])
        got = rk[name + "/placed_logits"][..., :v]
        assert _rel(got, rk[name + "/plain_logits"][1][..., :v]) <= DECODE_TOL


@pytest.mark.parametrize("short", [t[0] for ts in TRAIN.values() for t in ts])
def test_sharded_training_is_tensor_parallel_and_matches_the_plain_step(runs, short):
    """These families train tensor-parallel along ``model``: a rank's step
    counts under TRAIN_FLOPS_SHARE of the plain step's flops (on (1, 3)
    hymba-1.5b's ``in``, ``conv`` and ``out`` stay whole and its third rank
    holds no query head), ``sharding.weight`` gathers no ``model``-split
    parameter whole but the SSM's ``conv`` (W x CC), and over two steps the
    losses and parameters stay within TRAIN_LOSS_RTOL and TRAIN_PARAM_ATOL
    of the plain step's."""
    from repro_torch import configs

    world, arch, shape = next((w, a, sh) for w, ts in TRAIN.items() for s_, a, sh in ts
                              if s_ == short)
    cfg = configs.get(arch).reduced()
    cc = cfg.ssm_d_inner + 2 * cfg.ssm_state
    # conv is split over 'model' (and so gathered whole) where the axis divides CC
    conv = {(cfg.ssm_conv_width, cc)} if cfg.ssm_state and cc % shape[1] == 0 else set()
    _, ranks = runs
    for rk in (ranks[:4] if world == 4 else ranks[4:]):
        losses = rk[f"train/{short}/losses"]
        assert np.isfinite(losses).all()
        np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=TRAIN_LOSS_RTOL, atol=0)
        assert float(rk[f"train/{short}/param_diff"]) <= TRAIN_PARAM_ATOL
        plain, sharded = rk[f"train/{short}/flops"].T
        share = TRAIN_FLOPS_SHARE_OF.get(short, TRAIN_FLOPS_SHARE)
        assert (sharded < share * plain).all(), (sharded / plain)
        assert {tuple(int(v) for v in s) for s in rk[f"train/{short}/gathered_whole"]} == conv

