"""The port's serving under a device mesh on four gloo ranks, against the
unsharded port engine and the JAX package's GSPMD-partitioned engine.

Four worker processes form a gloo group on a ``FileStore`` under the
test's temporary directory and build ``DeviceMesh``es over it.  Each case
is a reduced config on a ``model``-only (1, 4) or a (2, 2) data x model
mesh: the parameters drawn from a seed on the CPU, placed as
``DTensor``s by the reference's spec trees (``param_specs_tree``,
``serve_param_specs_tree`` with ``SERVE_MOE_RULES``, replicated with
``PURE_DP_RULES``), a prefill of 4 prompts of 16 tokens and three decode
steps of given tokens inside ``use_rules``, dense and compressed caches.
The reduced llama3.2-1b has 4 query heads over 1 kv head of 16 (its kv
head is split over a 4-way ``model``), the reduced stablelm-3b 4 kv
heads, the reduced deepseek-moe-16b 8 experts.  One reference subprocess
with 4 host devices builds each ``jax.sharding.Mesh`` directly
(``jax.make_mesh`` makes Explicit axes under jax 0.9) and jits
``repro.serve.engine.prefill``/``decode_step`` inside
``repro.models.sharding.use_rules`` with ``NamedSharding`` in-shardings
from its spec trees, from the port's initial parameters.

Tolerances, as shares of the largest |logit| (measured on these inputs,
torch 2.13 and jax 0.9, x86-64 CPU):
  - prefill logits within 1e-5 of the unsharded port's and of the
    reference's (measured up to 7.5e-7 and 1.1e-6: the row-parallel
    partial sums are all-reduced in another order than one matmul sums
    them);
  - decode logits within 3e-2 of both (measured up to 6.7e-3 and 1.0e-4):
    under a rules context the decode scores' float32 cross-shard sum is
    rounded to bf16 once, as the reference's compiled ``_reduce_scores``
    rounds it, so a score moves by up to 2^-9 of itself, and the partial
    sums round at other places in the two packages.  With the scores summed in float32
    (``_reduce_scores`` patched in the worker) the sharded decode is held
    to 2e-5 of the unsharded port's (measured up to 7.3e-6);
  - the prefill's dense K/V records and the compressed records' mu within
    1e-5 of the largest of them, against the unsharded port's and the
    reference's (measured up to 8.2e-7 and 1.3e-6).  The compressed records' mu and
    sexp are bit for bit the unsharded encode (``engine._kv_encode``) of
    the same K/V, and each rank's planes are its head_dim columns of the
    whole planes.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 4, 16, 3
# (name, arch, mesh shape over ("data", "model"), rules, kv_mode, planes)
CASES = [
    ("llama_1x4_dense", "llama3.2-1b", (1, 4), "default", "dense", 1),
    ("llama_1x4_p1", "llama3.2-1b", (1, 4), "default", "compressed", 1),
    ("llama_2x2_dense", "llama3.2-1b", (2, 2), "default", "dense", 1),
    ("llama_2x2_p1", "llama3.2-1b", (2, 2), "default", "compressed", 1),
    ("llama_2x2_p2", "llama3.2-1b", (2, 2), "default", "compressed", 2),
    ("llama_2x2_pure_dp", "llama3.2-1b", (2, 2), "dp", "dense", 1),
    ("stablelm_1x4_dense", "stablelm-3b", (1, 4), "default", "dense", 1),
    ("stablelm_2x2_p1", "stablelm-3b", (2, 2), "default", "compressed", 1),
    ("deepseek_1x4_dense", "deepseek-moe-16b", (1, 4), "default", "dense", 1),
    ("deepseek_2x2_dense", "deepseek-moe-16b", (2, 2), "default", "dense", 1),
    ("deepseek_2x2_serve_dense", "deepseek-moe-16b", (2, 2), "serve", "dense", 1),
    ("deepseek_2x2_serve_p1", "deepseek-moe-16b", (2, 2), "serve", "compressed", 1),
]
NAMES = [c[0] for c in CASES]
COMPRESSED = [c[0] for c in CASES if c[4] == "compressed"]
PREFILL_TOL = 1e-5
DECODE_TOL = 3e-2
DECODE_F32_TOL = 2e-5
KV_TOL = 1e-5

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

def tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
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
        key = "/".join([parts[0]] + parts[2:]) if parts[0] == "layers" else n
        stacked.setdefault(key, []).append(t.numpy())
    return rcfg, jax.tree_util.tree_map_with_path(
        lambda kp, leaf: np.stack(stacked[path_str(kp)]) if path_str(kp).startswith("layers/")
        else stacked[path_str(kp)][0], RT.param_specs(rcfg))

out = {{}}
for name, arch, shape, how, mode, P in CASES:
    rcfg, params = ref_params(arch)
    toks = tokens(rcfg)
    mesh = Mesh(devs.reshape(shape), ("data", "model"))
    rules = {{"default": None, "dp": rsharding.PURE_DP_RULES, "serve": rsharding.SERVE_MOE_RULES}}[how]
    pspecs = (rmesh.replicated_specs_tree(params) if how == "dp" else
              rmesh.serve_param_specs_tree(rcfg, params, mesh) if how == "serve" else
              rmesh.param_specs_tree(rcfg, params, mesh))
    is_spec = lambda s: isinstance(s, PS)
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
    cspecs = rmesh.cache_specs_tree(rcfg, mesh, RE.cache_specs(rcfg, B, S + STEPS, kv_mode=mode,
                                                                num_planes=P))
    if how == "dp":    # the cache follows the rules' batch over every axis, hd whole
        cspecs = jax.tree.map(lambda s: PS(*[("data", "model") if e in ("data", ("data",)) else
                                             None if e == "model" else e for e in s]),
                              cspecs, is_leaf=is_spec)
    csh = sh(cspecs)
    bsh = NamedSharding(mesh, PS(("data", "model") if how == "dp" else "data", None))
    with rsharding.use_rules(mesh, rules):
        pre = jax.jit(lambda p, t: RE.prefill(p, rcfg, t, seq_len=S + STEPS, kv_mode=mode,
                                              num_planes=P), in_shardings=(sh(pspecs), bsh))
        dec = jax.jit(lambda p, c, t: RE.decode_step(p, rcfg, c, t, kv_mode=mode, num_planes=P),
                      in_shardings=(sh(pspecs), csh, bsh))
        p_ = jax.device_put(params, sh(pspecs))
        cache, logits = pre(p_, jnp.asarray(toks[:, :S]))
        for k, v in cache["layers"].items():
            out[f"{{name}}/cache/{{k}}"] = np.asarray(v)
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
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH
from repro_torch.roofline import hlo_cost
from repro_torch.serve import engine as E

rank, store, dest = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
out = {{}}
bf16_reduce = E._reduce_scores

def f32_reduce(s, dims=()):
    return SH.all_reduce(s, dims)

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def run_sharded(cfg, params, toks, mode, P, rules, mesh, count=False):
    counts = []
    with SH.use_rules(mesh, rules):
        with hlo_cost.OpCounter(mesh) as c:
            cache, logits = E.prefill(params, cfg, torch.from_numpy(toks[:, :S]),
                                      seq_len=S + STEPS, kv_mode=mode, num_planes=P)
        counts.append(c)
        first = {{k: (v.to_local().clone(), full(v).clone()) for k, v in cache["layers"].items()}}
        lg = [full(logits)]
        for t in range(STEPS):
            with hlo_cost.OpCounter(mesh) as c:
                logits, cache = E.decode_step(params, cfg, cache,
                                              torch.from_numpy(toks[:, S + t:S + t + 1]),
                                              kv_mode=mode, num_planes=P)
            counts.append(c)
            lg.append(full(logits))
    return first, torch.stack(lg), cache, counts

for name, arch, shape, how, mode, P in CASES:
    cfg, model = port_model(arch)
    toks = tokens(cfg)
    # the unsharded engine
    cache, logits = E.prefill(model, cfg, torch.from_numpy(toks[:, :S]), seq_len=S + STEPS,
                              kv_mode=mode, num_planes=P)
    plain_cache = {{k: v.clone() for k, v in cache["layers"].items()}}
    prefilled = {{"pos": cache["pos"], "slot_pos": cache["slot_pos"].clone(),
                 "layers": dict(plain_cache)}}
    lg = [logits]
    for t in range(STEPS):
        logits, cache = E.decode_step(model, cfg, cache, torch.from_numpy(toks[:, S + t:S + t + 1]),
                                      kv_mode=mode, num_planes=P)
        lg.append(logits)
    plain_logits = torch.stack(lg)
    # the sharded engine
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coords = mesh.get_coordinate()
    tree = T.param_tree(model)
    rules = {{"default": None, "dp": SH.PURE_DP_RULES, "serve": SH.SERVE_MOE_RULES}}[how]
    specs = (M.replicated_specs_tree(tree) if how == "dp" else
             M.serve_param_specs_tree(cfg, tree, mesh) if how == "serve" else
             M.param_specs_tree(cfg, tree, mesh))
    params = M.shard_tree(tree, specs, mesh)
    ok = all(torch.equal(p.to_local(), w[M.local_index(s, w.shape, mesh, coords)])
             for p, w, s in zip(pytree.leaves(params), pytree.leaves(tree), pytree.leaves(specs)))
    out[name + "/params_local_ok"] = np.array(ok)
    out[name + "/params_local_numel"] = np.array(sum(p.to_local().numel()
                                                    for p in pytree.leaves(params)))
    first, logits, cache, counts = run_sharded(cfg, params, toks, mode, P, rules, mesh)
    with SH.use_rules(mesh, rules):
        cspecs = M.serve_cache_specs(mesh, E.cache_specs(cfg, B, S + STEPS, kv_mode=mode,
                                                         num_planes=P))
    cache_ok = True
    for k, (loc, whole) in first.items():
        cache_ok &= torch.equal(loc, whole[M.local_index(cspecs["layers"][k], whole.shape, mesh,
                                                         coords)])
        out[f"{{name}}/cache/{{k}}"] = whole.numpy()
        out[f"{{name}}/plain_cache/{{k}}"] = plain_cache[k].numpy()
    out[name + "/cache_local_ok"] = np.array(cache_ok)
    # the unsharded prefill's cache placed on the mesh, and a decode step from it
    with SH.use_rules(mesh, rules):
        placed = M.shard_cache(prefilled, cspecs, mesh)
        out[name + "/placed_ok"] = np.array(all(
            torch.equal(placed["layers"][k].to_local(),
                        v[M.local_index(cspecs["layers"][k], v.shape, mesh, coords)])
            for k, v in prefilled["layers"].items()))
        lg, _ = E.decode_step(params, cfg, placed, torch.from_numpy(toks[:, S:S + 1]),
                              kv_mode=mode, num_planes=P)
    out[name + "/placed_logits"] = full(lg).numpy()
    out[name + "/cache_specs"] = np.array(repr(cspecs["layers"]))
    out[name + "/cache_default_specs"] = np.array(repr(M.cache_specs_tree(
        cfg, mesh, E.cache_specs(cfg, B, S + STEPS, kv_mode=mode, num_planes=P))["layers"]))
    out[name + "/logits"] = logits.numpy()
    out[name + "/plain_logits"] = plain_logits.numpy()
    for i, c in enumerate(counts):
        for axis, kinds in c.coll_by_axis.items():
            out[f"{{name}}/coll/{{i}}/{{axis}}"] = np.array([kinds[k] for k in hlo_cost.COLL_KINDS])
    # the decode with its scores summed in float32
    E._reduce_scores = f32_reduce
    try:
        out[name + "/logits_f32"] = run_sharded(cfg, params, toks, mode, P, rules, mesh)[1].numpy()
    finally:
        E._reduce_scores = bf16_reduce
    if mode == "compressed":
        # the same prefill with a dense cache: its K/V, encoded whole
        kv = run_sharded(cfg, params, toks, "dense", 1, rules, mesh)[0]
        for nm in "kv":
            mu, sexp, pl = E._kv_encode(kv[nm][1][:, :, :S], P)
            out[f"{{name}}/enc/{{nm}}mu"] = mu.numpy()
            out[f"{{name}}/enc/{{nm}}sexp"] = sexp.numpy()
            out[f"{{name}}/enc/{{nm}}pl"] = pl.movedim(0, 1).numpy()
    out[name + "/coords"] = np.array(coords)
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref, ranks)``: the reference's outputs and each rank's."""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    fmt = dict(B=B, S=S, STEPS=STEPS, cases=CASES)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE.format(**fmt),
                               str(tmp / "ref.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER.format(**fmt), str(r), str(tmp / "store"),
             str(tmp / f"rank{r}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    logs = []
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log, tag in zip(logs, ["REFERENCE-OK"] + ["WORKER-OK"] * 4):
        assert tag in log, log[-3000:]
    return dict(np.load(tmp / "ref.npz")), [dict(np.load(tmp / f"rank{r}.npz"))
                                             for r in range(4)]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _vocab(name) -> int:
    from repro_torch import configs

    return configs.get(dict((c[0], c[1]) for c in CASES)[name]).reduced().vocab_size


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_shards(runs, name):
    """Each rank's parameter and cache shards are the slices ``local_index``
    names of the whole tensors; a (1, 4) or (2, 2) mesh splits the
    parameters four or two ways; the cache is placed as ``cache_specs_tree``
    places it (batch and head_dim over every axis with pure data
    parallelism)."""
    _, ranks = runs
    whole = sum(np.prod(v.shape) for k, v in ranks[0].items()
                if k.startswith(name + "/plain_cache/"))
    assert whole > 0
    how = dict((c[0], c[3]) for c in CASES)[name]
    held = {int(rk[name + "/params_local_numel"]) for rk in ranks}
    assert len(held) == 1
    for rk in ranks:
        assert bool(rk[name + "/params_local_ok"]) and bool(rk[name + "/cache_local_ok"])
        if how == "default":
            assert str(rk[name + "/cache_specs"]) == str(rk[name + "/cache_default_specs"])
    coords = {tuple(rk[name + "/coords"].tolist()) for rk in ranks}
    assert len(coords) == 4


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    v = _vocab(name)
    for rk in ranks:
        got = rk[name + "/logits"][0][..., :v]
        assert _rel(got, rk[name + "/plain_logits"][0][..., :v]) <= PREFILL_TOL
        assert _rel(got, ref[name + "/logits"][0][..., :v]) <= PREFILL_TOL
        assert np.array_equal(rk[name + "/logits"], ranks[0][name + "/logits"])
    caches = {k.split("/")[-1] for k in ranks[0] if k.startswith(name + "/cache/")}
    for k in sorted(caches):
        got = ranks[0][f"{name}/cache/{k}"]
        for want in (ranks[0][f"{name}/plain_cache/{k}"], ref[f"{name}/cache/{k}"]):
            assert got.shape == want.shape and got.dtype == want.dtype, k
            if k in ("k", "v") or k.endswith("mu"):
                assert _rel(got[:, :, :S], want[:, :, :S]) <= KV_TOL, k
    if name not in COMPRESSED:
        assert caches == {"k", "v"}


@pytest.mark.parametrize("name", COMPRESSED)
def test_compressed_records_are_the_unsharded_encode(runs, name):
    """mu and sexp (whole over 'model') bit for bit the unsharded encode of
    the prefill's own K/V, the planes (each rank's head_dim columns,
    assembled) bit for bit its planes."""
    _, ranks = runs
    rk = ranks[0]
    for nm in "kv":
        for part in ("mu", "sexp", "pl"):
            got = rk[f"{name}/cache/{nm}{part}"]
            got = got[:, :, :, :S] if part == "pl" else got[:, :, :S]
            want = rk[f"{name}/enc/{nm}{part}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), (nm, part)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    v = _vocab(name)
    for rk in ranks:
        got = rk[name + "/logits"][1:, ..., :v]
        for want in (rk[name + "/plain_logits"][1:, ..., :v], ref[name + "/logits"][1:, ..., :v]):
            assert max(_rel(g, w) for g, w in zip(got, want)) <= DECODE_TOL
        # with the scores summed in float32 the decode is the unsharded one's
        f32 = rk[name + "/logits_f32"][1:, ..., :v]
        want = rk[name + "/plain_logits"][1:, ..., :v]
        assert max(_rel(g, w) for g, w in zip(f32, want)) <= DECODE_F32_TOL


@pytest.mark.parametrize("name", NAMES)
def test_decode_from_the_unsharded_cache_placed_on_the_mesh(runs, name):
    """``launch/mesh.shard_cache`` places the unsharded prefill's cache
    (each rank's slabs the ``local_index`` slices), and the sharded decode
    step from it gives the unsharded first step's logits (the bf16
    scores' tolerance)."""
    _, ranks = runs
    v = _vocab(name)
    for rk in ranks:
        assert bool(rk[name + "/placed_ok"])
        got = rk[name + "/placed_logits"][..., :v]
        assert _rel(got, rk[name + "/plain_logits"][1][..., :v]) <= DECODE_TOL


def test_pure_data_parallel_moves_nothing_over_model(runs):
    _, ranks = runs
    name = "llama_2x2_pure_dp"
    for rk in ranks:
        keys = [k for k in rk if k.startswith(name + "/coll/")]
        assert not any(k.endswith("/model") and rk[k].any() for k in keys), keys
        # the rows are split four ways, so nothing is gathered over 'data' either
        assert all(not rk[k].any() for k in keys)


def _decode_model_bytes(cfg, b: int, w: int, n: int) -> dict:
    """Collective bytes over an n-way 'model' of one sharded decode step, a
    device: each layer gathers q, k, v (whole, in the compute dtype) and
    the attention's head_dim columns, all-reduces the float32 scores (B x
    Hq x W x 4 bytes, rounded to bf16 after the sum) and the two
    row-parallel outputs, and exchanges the fused
    [gate | up] columns (2F / n a rank, one all-to-all); the embedding's
    rows are all-reduced and the logits' columns gathered."""
    item = 4                                    # the reduced configs compute in float32
    hd, hq, hkv, d = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    gather = cfg.n_layers * (2 * b * hq * hd + 2 * b * hkv * hd) * item \
        + b * cfg.padded_vocab * item
    reduce = cfg.n_layers * (b * hq * w * 4 + 2 * b * d * item) + b * d * item
    return {"all-gather": gather, "all-reduce": reduce,
            "all-to-all": cfg.n_layers * b * 2 * cfg.d_ff // n * item}


@pytest.mark.parametrize("name", ["llama_1x4_dense", "llama_1x4_p1", "stablelm_1x4_dense"])
def test_decode_step_collective_bytes_by_axis(runs, name):
    from repro_torch import configs
    from repro_torch.roofline import hlo_cost

    _, ranks = runs
    arch = dict((c[0], c[1]) for c in CASES)[name]
    want = _decode_model_bytes(configs.get(arch).reduced(), B, S + STEPS, 4)
    for rk in ranks:
        for step in range(1, STEPS + 1):
            got = dict(zip(hlo_cost.COLL_KINDS, rk[f"{name}/coll/{step}/model"].tolist()))
            assert got == {**dict.fromkeys(hlo_cost.COLL_KINDS, 0), **want}, (step, got, want)
            assert f"{name}/coll/{step}/data" not in rk


THREE_WAY = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH, transformer as T
from repro_torch.serve import engine as E

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 3), rank=rank, world_size=3)
B, S, STEPS = {B}, {S}, {STEPS}
# F = 96: the fused [gate | up] columns split three ways, resharded by the all-to-all
cfg = dataclasses.replace(configs.get("stablelm-3b").reduced(), d_ff=96)
model = T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
toks = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=torch.Generator().manual_seed(3))

def run(params, rules_mesh=None):
    ctx = SH.use_rules(rules_mesh) if rules_mesh is not None else torch.no_grad()
    with ctx:
        cache, logits = E.prefill(params, cfg, toks[:, :S], seq_len=S + STEPS)
        out = [logits]
        for t in range(STEPS):
            logits, cache = E.decode_step(params, cfg, cache, toks[:, S + t:S + t + 1])
            out.append(logits)
    return torch.stack([o.full_tensor() if hasattr(o, "full_tensor") else o for o in out])

plain = run(model)
mesh = init_device_mesh("cpu", (1, 3), mesh_dim_names=("data", "model"))
tree = T.param_tree(model)
specs = M.param_specs_tree(cfg, tree, mesh)
assert specs["layers"][0]["mlp"]["wi"] == M.P(None, "model"), specs["layers"][0]["mlp"]
E._reduce_scores = lambda s, dims=(): SH.all_reduce(s, dims)    # the scores summed in float32
got = run(M.shard_tree(tree, specs, mesh), mesh)
v = cfg.vocab_size
rel = float((got[..., :v] - plain[..., :v]).abs().max() / plain[..., :v].abs().max())
print(f"THREE-WAY-REL {{rel:.3e}}")
dist.destroy_process_group()
"""


def test_three_way_model_axis_matches_the_unsharded_engine(tmp_path):
    """On a 3-way ``model`` axis (three gloo ranks) the sharded prefill and
    three decode steps of the reduced stablelm-3b with F = 96 give the
    unsharded engine's logits within 2e-5 of the largest (the scores
    summed in float32; measured 4.4e-7, and 1.0 with rank 1's pieces sent
    unswapped).  n = 3 is odd, so rank 1's two [gate | up] pieces
    go to ranks 2 and 0, and its query heads (4 over 3 ranks) split
    unevenly."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    script = THREE_WAY.format(B=B, S=S, STEPS=STEPS)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(3)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log in logs:
        line = [ln for ln in log.splitlines() if ln.startswith("THREE-WAY-REL")]
        assert line, log[-3000:]
        assert float(line[0].split()[1]) <= DECODE_F32_TOL, line
