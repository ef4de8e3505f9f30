"""Long-context serving of the MoE, encoder-decoder and VLM families: the
sequence split over ``act_seq`` (``LONG_CONTEXT_RULES``) on gloo ranks,
against the unsharded port engine and the JAX package's GSPMD-partitioned
engine; the MoE's capacity across a rank boundary; float64 holds of the
MoE's output, the encoder's output and the VLM's hidden rows; the two
collectives of a split sequence (``sharding.gather`` over ``act_seq``,
``sharding.seq_prefix_sum``).

The harness is ``test_torch_long_context.py``'s: four worker processes form
a gloo group on a ``FileStore`` under the test's temporary directory and
build ``DeviceMesh``es over it, three more form another, and one reference
subprocess with 4 host devices builds each ``jax.sharding.Mesh`` directly
and jits ``repro.serve.engine``'s ``prefill``/``decode_step`` inside
``use_rules(mesh, LONG_CONTEXT_RULES)`` (in-shardings from
``cache_specs_tree(long_context=True)``, the tokens replicated, the stub
frames and image embeddings closed over), from the port's initial
parameters and the same numpy inputs.

Cases: the reduced deepseek-moe-16b (8 experts, top 2, 2 shared),
whisper-medium (2 + 2 layers over 24 stub frames) and internvl2-1b (8 stub
image embeddings before the tokens, 4 query heads over 1) on a data-only
(4, 1), a (2, 2) data x model and a (3, 1) mesh, with dense and P = 1
caches: 2 prompts of 13 tokens and 16 decode steps of given tokens, in a
cache that holds every position (29 or 37 rounded up to 32 or 40 slots:
split over 'data' on (4, 1) and (2, 2), whole on (3, 1)).  The ranks hold
4, 4, 4, 1 positions on (4, 1), 7, 6 on (2, 2) and 5, 5, 3 on (3, 1);
internvl2-1b's 8 + 13 = 21 positions split 6, 6, 6, 3 / 11, 10 / 7, 7, 7,
so its prefix ends inside rank 1 on (4, 1) and (3, 1) and rank 0 on (2, 2);
whisper's 24 frames split 6, 12 and 8 a rank, and its cross K/V's T over
'data' as the reference's long-context cache.  Besides: deepseek-moe-16b
at long_500k's batch of 1 on (4, 1) (prefill and decode, dense and P = 1),
and an MoE drop case: ``capacity_factor`` 0.5 over 61 tokens on (4, 1)
(ranks of 16, 16, 16, 13), so ``cap`` = 8 while each expert averages 15.25
routed tokens a row.

Tolerances, as shares of the largest |value| (measured on these inputs,
torch 2.13 and jax 0.9, x86-64 CPU):
  - prefill logits within 1e-5 of the unsharded port's and of the
    reference's (measured up to 6.3e-7 and 1.2e-6), and the gathered cache
    -- K/V, the compressed records' mu, the cross K/V -- within 1e-5 of the
    largest of each (measured up to 1.7e-6): the halo'd flash and the
    row-parallel sums add in another order;
  - decode logits within 3e-2 of the unsharded port's and of the
    reference's at every step (measured up to 1.1e-2 and 9.8e-4, the
    latter whisper-medium's P = 1 runs, where the two packages' unsharded
    engines already part; dense up to 2.2e-4): under any rules context the
    scores' float32 sum over 'model' is rounded to bf16 once, as the
    reference's compiled step rounds it; and at every step with the scores
    summed in float32 (``_reduce_scores`` patched in the worker and in the
    reference), within 2e-5 of the
    unsharded port's (measured up to 1.2e-6: the cross-rank softmax merge
    of the window and of the cross K/V's frames sums in another order) and
    of the reference's float32-score run with a dense cache (measured up
    to 1.5e-6), within 1e-3 of it with a P = 1 cache (measured up to
    2.5e-4, whisper-medium from step 10, the two packages' unsharded
    engines' own spread).

The float64 case (compute dtype float64 on (4, 1)) holds three things to
the unsharded engine within 1e-12 of the largest |value| (measured up to
1.1e-15; the flash plain version runs float64 inputs in float64): the
MoE's output at every layer in the drop case's prefill (its capacity
binding, so a wrong capacity moves rows by O(1)), whisper's encoder
output, and internvl2-1b's final hidden rows over the prefill and 16
decode steps (``logits_for`` patched to return the hidden row, the scores
summed unrounded).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 2, 13, 16
ARCHS = {"deepseek": "deepseek-moe-16b", "whisper": "whisper-medium", "internvl2": "internvl2-1b"}
MODES = (("dense", 1), ("p1", 1))
DROP_S, DROP_CAPACITY, DROP_CAP = 61, 0.5, 8


def _cases(meshes):
    return [(f"{short}_{m[0]}x{m[1]}_{tag}", arch, m, "dense" if tag == "dense" else "compressed",
             planes, B, S, {}) for short, arch in ARCHS.items() for m in meshes
            for tag, planes in MODES]


# (name, arch, mesh shape over ("data", "model"), kv_mode, planes, batch, prompt, config changes)
CASES4 = _cases([(4, 1), (2, 2)]) + [
    (f"deepseek_b1_4x1_{tag}", "deepseek-moe-16b", (4, 1), "dense" if tag == "dense" else
     "compressed", planes, 1, S, {}) for tag, planes in MODES] + [
    ("deepseek_drop_4x1_dense", "deepseek-moe-16b", (4, 1), "dense", 1, B, DROP_S,
     {"capacity_factor": DROP_CAPACITY})]
CASES3 = _cases([(3, 1)])
CASES = CASES4 + CASES3
NAMES = [c[0] for c in CASES]
PREFILL_TOL = 1e-5
RECORD_TOL = 1e-5
DECODE_TOL = 3e-2
DECODE_F32_TOL = 2e-5
# the float32-score decode against the reference's own with a P = 1 cache:
# the two packages' unsharded engines already part there (whisper-medium
# from step 10 on, up to 2.5e-4 on every mesh and unsharded alike: a value
# of a decode step's K/V coded a planes byte apart), far below a route
# flip's O(1)
DECODE_F32_PLANES_REF_TOL = 1e-3
# decode steps of a case whose MoE routes may differ from the unsharded
# run's with bf16 scores: none, the scores' sum over 'model' being rounded
# once, as the reference's compiled step rounds it
MAX_FLIPS = 0
F64_TOL = 1e-12

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch import configs as pconfigs
from repro_torch.core import pytree
from repro_torch.models import transformer as T
STEPS = {STEPS}
CASES = {cases!r}

def port_model(arch, **kw):
    cfg = dataclasses.replace(pconfigs.get(arch).reduced(), **kw)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")

def inputs(cfg, b, s):
    # tokens (b, s + STEPS); frames (b, T, D) or image embeddings (b, P, D)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (b, s + STEPS)).astype(np.int32)
    extra = {{}}
    if cfg.encoder_decoder:
        extra["frames"] = rng.standard_normal((b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.prefix_embeds:
        extra["image_embeds"] = rng.standard_normal(
            (b, cfg.prefix_embeds, cfg.d_model)).astype(np.float32)
    return toks, extra

def seq_len(cfg, s):
    # every position of the prefix, the prompt and the decode steps, in 8s
    return -(-(cfg.prefix_embeds + s + STEPS) // 8) * 8

def reduce_inputs():
    # integer q (B, Hkv, G, hd) and K (B, W, Hkv, hd), exact in bf16: their
    # products and head_dim partial sums (up to 11 bits) exact in float32
    rng = np.random.default_rng(11)
    return (rng.integers(-15, 16, (2, 2, 2, 16)).astype(np.float32),
            rng.integers(-15, 16, (2, 32, 2, 16)).astype(np.float32))
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
bf16_reduce = RE._reduce_scores

def f32_reduce(s):
    # the hd-partial scores summed over 'model' in float32, not via bf16
    return rsharding.shard_activation(s, ("act_batch", None, None, None))

def path_str(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def ref_params(arch, kw):
    # the port's initial parameters, layers stacked as the reference's
    rcfg = dataclasses.replace(rconfigs.get(arch).reduced(), **kw)
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
for name, arch, shape, mode, P, b, s, kw in CASES:
    rcfg, params = ref_params(arch, kw)
    toks, extra = inputs(rcfg, b, s)
    extra = {{k: jnp.asarray(v) for k, v in extra.items()}}
    seq = seq_len(rcfg, s)
    mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"))
    is_spec = lambda x: isinstance(x, PS)
    sh = lambda t: jax.tree.map(lambda x: NamedSharding(mesh, x), t, is_leaf=is_spec)
    psh = sh(rmesh.param_specs_tree(rcfg, params, mesh))
    csh = sh(rmesh.cache_specs_tree(rcfg, mesh, RE.cache_specs(rcfg, b, seq, kv_mode=mode,
                                                               num_planes=P),
                                    long_context=True))
    tsh = NamedSharding(mesh, PS(None, None))
    with rsharding.use_rules(mesh, rsharding.LONG_CONTEXT_RULES):
        pre = jax.jit(lambda p, t: RE.prefill(p, rcfg, t, seq_len=seq, kv_mode=mode,
                                              num_planes=P, **extra), in_shardings=(psh, tsh))
        p_ = jax.device_put(params, psh)
        cache, logits = pre(p_, jnp.asarray(toks[:, :s]))
        for part in ("layers", "cross"):
            for k, v in cache.get(part, {{}}).items():
                out[f"{{name}}/{{part}}/{{k}}"] = np.asarray(v)
        first = cache
        for tag, reduce in (("logits", bf16_reduce), ("logits_f32", f32_reduce)):
            # decode_step traced anew with the scores rounded to bf16 (the
            # reference's own) or summed in float32, from the same prefill
            RE._reduce_scores = reduce
            dec = jax.jit(lambda p, c, t: RE.decode_step(p, rcfg, c, t, kv_mode=mode,
                                                         num_planes=P),
                          in_shardings=(psh, csh, tsh))
            cache, lg = first, [np.asarray(logits)]
            for t in range(STEPS):
                cache = jax.device_put(cache, csh)
                step, cache = dec(p_, cache, jnp.asarray(toks[:, s + t:s + t + 1]))
                lg.append(np.asarray(step))
            out[f"{{name}}/{{tag}}"] = np.stack(lg)
        RE._reduce_scores = bf16_reduce

# the score all-reduce alone, compiled on (2, 2) under LONG_CONTEXT_RULES:
# _slab_attend's einsum of q and K split over head_dim, then _reduce_scores;
# the element types of the compiled step's all-reduces recorded
rq, rk = reduce_inputs()
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
hdsh = NamedSharding(mesh, PS(None, None, None, "model"))

def scores(q, k):
    q = rsharding.shard_activation(q, ("act_batch", None, None, "act_hd"))
    s = jnp.einsum("bhgd,bkhd->bhgk", q, k, preferred_element_type=jnp.float32)
    return RE._reduce_scores(s / np.sqrt(q.shape[-1]).astype(np.float32))

with rsharding.use_rules(mesh, rsharding.LONG_CONTEXT_RULES):
    f = jax.jit(scores, in_shardings=(hdsh, hdsh))
    args = (jnp.asarray(rq, jnp.bfloat16), jnp.asarray(rk, jnp.bfloat16))
    out["reduce/scores"] = np.asarray(f(*args))
    hlo = f.lower(*args).compile().as_text()
out["reduce/all_reduce_types"] = np.array([ln.split("=", 1)[1].split("[", 1)[0].strip()
                                           for ln in hlo.splitlines() if "all-reduce(" in ln])
np.savez(sys.argv[1], **out)
print("REFERENCE-OK")
"""

WORKER = COMMON + r"""
import contextlib
import math
import sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L, sharding as SH
from repro_torch.serve import engine as E

rank, world, store, dest = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
out = {{}}
bf16_reduce = E._reduce_scores
LONG = SH.LONG_CONTEXT_RULES

def f32_reduce(s, dims=()):
    return SH.all_reduce(s, dims)

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

# the MoE's routing as dispatch leaves it, recorded in a prefill: (lo, routed
# (B, s, E), kept (B, s, E)) a layer, over this rank's positions from lo; and
# in decode each layer's top-k experts (B, 1, K), sorted
dispatch, KEPT, ROUTES = L.dispatch, [], []
RECORD = [False]

def dispatch_spy(probs, idx, cfg):
    got = dispatch(probs, idx, cfg)
    if not RECORD[0]:
        ROUTES.append(idx.sort(-1).values.clone())
    else:
        routed, src, valid = got[3:]
        split = SH.seq_split()
        kept = torch.zeros_like(routed)
        bi = torch.arange(src.shape[0])[:, None, None].expand_as(src)
        ei = torch.arange(src.shape[1])[None, :, None].expand_as(src)
        kept[bi[valid], src[valid], ei[valid]] = True
        KEPT.append((0 if split is None else split[1], routed.clone(), kept))
    return got

L.dispatch = dispatch_spy

def decode(params, cfg, cache, toks, s, mode, P):
    lg = []
    for t in range(STEPS):
        tok = torch.from_numpy(toks[:, s + t:s + t + 1])
        logits, cache = E.decode_step(params, cfg, cache, tok, kv_mode=mode, num_planes=P)
        lg.append(full(logits))
    return lg

def run(params, cfg, toks, extra, s, mode, P, mesh=None, steps=True):
    ctx = SH.use_rules(mesh, LONG) if mesh is not None else contextlib.nullcontext()
    with torch.no_grad(), ctx:
        RECORD[0] = True
        try:
            cache, logits = E.prefill(params, cfg, torch.from_numpy(toks[:, :s]),
                                      seq_len=seq_len(cfg, s), kv_mode=mode, num_planes=P,
                                      **{{k: torch.from_numpy(v) for k, v in extra.items()}})
        finally:
            RECORD[0] = False
        first = {{f"{{part}}/{{k}}": (v.to_local().clone() if hasattr(v, "to_local") else v.clone(),
                                     full(v).clone())
                 for part in ("layers", "cross") for k, v in cache.get(part, {{}}).items()}}
        slot_pos = full(cache["slot_pos"]).clone()
        ROUTES.clear()
        lg = [full(logits)] + (decode(params, cfg, cache, toks, s, mode, P) if steps else [])
    return first, slot_pos, torch.stack(lg)

def routes():
    # the decode's top-k experts, (STEPS, layers, B, K); none without experts
    return torch.stack(ROUTES).reshape(STEPS, -1, *ROUTES[0].shape[::2]) if ROUTES else None

def flips(got, want):
    # each decode step: whether any layer's routes differ from want's
    return np.zeros(STEPS, bool) if want is None else (got != want).flatten(1).any(1).numpy()

def kept_sets(records):
    # (lo, routed, kept) a layer -> (L, B, s, E) each and the lo
    return (records[0][0], torch.stack([r[1] for r in records]),
            torch.stack([r[2] for r in records]))

for name, arch, shape, mode, P, b, s, kw in CASES:
    cfg, model = port_model(arch, **kw)
    toks, extra = inputs(cfg, b, s)
    KEPT.clear()
    plain_first, plain_slots, plain_logits = run(model, cfg, toks, extra, s, mode, P)
    plain_kept = kept_sets(KEPT) if KEPT else None
    plain_routes = routes()
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coords = mesh.get_coordinate()
    tree = T.param_tree(model)
    params = M.shard_tree(tree, M.param_specs_tree(cfg, tree, mesh), mesh)
    KEPT.clear()
    first, slots, logits = run(params, cfg, toks, extra, s, mode, P, mesh)
    out[name + "/flips"] = flips(routes(), plain_routes)
    if plain_kept is not None:
        lo, routed, kept = kept_sets(KEPT)
        out[name + "/kept/lo"] = np.array(lo)
        out[name + "/kept/routed"] = routed.numpy()
        out[name + "/kept/local"] = kept.numpy()
        out[name + "/kept/plain"] = plain_kept[2].numpy()
        out[name + "/kept/plain_routed"] = plain_kept[1].numpy()
    with SH.use_rules(mesh, LONG):
        cspecs = M.serve_cache_specs(mesh, E.cache_specs(cfg, b, seq_len(cfg, s), kv_mode=mode,
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
    out[name + "/slot_pos_ok"] = np.array(torch.equal(slots, plain_slots))
    out[name + "/logits"] = logits.numpy()
    out[name + "/plain_logits"] = plain_logits.numpy()
    E._reduce_scores = f32_reduce
    try:
        out[name + "/logits_f32"] = run(params, cfg, toks, extra, s, mode, P, mesh)[2].numpy()
        out[name + "/flips_f32"] = flips(routes(), plain_routes)
    finally:
        E._reduce_scores = bf16_reduce
    out[name + "/coords"] = np.array(coords)

# the two collectives of a split sequence, on uneven chunks: a sequence of
# 10 (4: 3, 3, 3, 1; 3: 4, 4, 2) gathered whole, and each rank's count
# summed over the ranks before it
mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
with SH.use_rules(mesh, LONG), SH.sequence(10):
    _i, lo, hi, total = SH.seq_split()
    whole = torch.arange(2 * total * 3, dtype=torch.float32).reshape(2, total, 3)
    got = SH.gather(whole[:, lo:hi], 1, (_i,), total)
    counts = torch.full((2, 5), rank + 1, dtype=torch.int64)
    before = SH.seq_prefix_sum(counts)
    out["collectives/gather_ok"] = np.array(torch.equal(got, whole))
    out["collectives/prefix_ok"] = np.array(
        torch.equal(before, torch.full((2, 5), rank * (rank + 1) // 2, dtype=torch.int64))
        and before.dtype == torch.int64)

if world == 4:
    # the score all-reduce alone on (2, 2): this rank's head_dim columns of
    # q and K scored, then _reduce_scores over 'model'; beside it the
    # partials rounded to bf16 before their sum, which rounds twice
    rq, rk = (torch.from_numpy(a) for a in reduce_inputs())
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with SH.use_rules(mesh, LONG):
        dims = SH.mesh_dims("act_hd")
        lo, hi = SH.chunk_range(rq.shape[-1], dims)
        s = torch.einsum("bhgd,bkhd->bhgk", rq[..., lo:hi], rk[..., lo:hi]) / math.sqrt(16)
        out["reduce/scores"] = E._reduce_scores(s.clone(), dims).numpy()
        out["reduce/twice"] = SH.all_reduce(s.to(torch.bfloat16), dims).float().numpy()

if {float64!r}:
    # float64 on (4, 1): the MoE's output at each layer (the drop case's
    # capacity binding), the encoder's output, the VLM's final hidden rows
    # (logits_for patched to return them, the scores summed unrounded)
    E._reduce_scores = f32_reduce
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))

    def sharded(model, cfg):
        tree = T.param_tree(model)
        return M.shard_tree(tree, M.param_specs_tree(cfg, tree, mesh), mesh)

    def spread(got, want):
        return np.array([float((got - want).abs().max()), float(want.abs().max())])

    moe, outs = L.moe_ffn, []
    def moe_spy(p, x, cfg):
        y, aux = moe(p, x, cfg)
        split = SH.seq_split()
        outs.append((0 if split is None else split[1], y.clone()))
        return y, aux
    L.moe_ffn = moe_spy
    cfg, model = port_model("deepseek-moe-16b", compute_dtype="float64",
                            capacity_factor={DROP_CAPACITY!r})
    toks, extra = inputs(cfg, 2, {DROP_S!r})
    run(model, cfg, toks, extra, {DROP_S!r}, "dense", 1, steps=False)
    want, outs = outs, []
    run(sharded(model, cfg), cfg, toks, extra, {DROP_S!r}, "dense", 1, mesh, steps=False)
    lo = outs[0][0]
    out["f64/moe"] = np.max([spread(g, w[:, lo:lo + g.shape[1]])
                             for (_lo, g), (_z, w) in zip(outs, want)], axis=0)
    out["f64/moe_dtype_ok"] = np.array(all(g.dtype == torch.float64 for _lo, g in outs))
    L.moe_ffn = moe

    encode, encs = T._encode, []
    def encode_spy(*a):
        h = encode(*a)
        encs.append(h.clone())
        return h
    T._encode = encode_spy
    cfg, model = port_model("whisper-medium", compute_dtype="float64")
    toks, extra = inputs(cfg, 2, {S!r})
    run(model, cfg, toks, extra, {S!r}, "dense", 1, steps=False)
    run(sharded(model, cfg), cfg, toks, extra, {S!r}, "dense", 1, mesh, steps=False)
    out["f64/encoder"] = spread(encs[1], encs[0])
    T._encode = encode

    logits_for = T.logits_for
    T.logits_for = lambda params, cfg, h: h
    cfg, model = port_model("internvl2-1b", compute_dtype="float64")
    toks, extra = inputs(cfg, 2, {S!r})
    want = run(model, cfg, toks, extra, {S!r}, "dense", 1)[2]
    got = run(sharded(model, cfg), cfg, toks, extra, {S!r}, "dense", 1, mesh)[2]
    out["f64/vlm"] = spread(got, want)
    out["f64/vlm_dtype_ok"] = np.array(got.dtype == torch.float64)
    T.logits_for = logits_for
    E._reduce_scores = bf16_reduce
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ref, ranks)``: the reference's outputs and each rank's, the
    4-rank group's first, then the 3-rank group's."""
    tmp = tmp_path_factory.mktemp("long_context_families")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    sizes = dict(STEPS=STEPS, S=S, DROP_S=DROP_S, DROP_CAPACITY=DROP_CAPACITY)
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE.format(cases=CASES, **sizes),
                               str(tmp / "ref.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)]
    dests = []
    for world, cases in ((4, CASES4), (3, CASES3)):
        script = WORKER.format(cases=cases, float64=world == 4, **sizes)
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
    import dataclasses

    from repro_torch import configs

    _, arch, _, _, _, _, _, kw = _case(name)
    return dataclasses.replace(configs.get(arch).reduced(), **kw)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _member_range(size: int, n: int, c: int) -> tuple[int, int]:
    step = -(-size // n)
    return min(c * step, size), min((c + 1) * step, size)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_cache_shards(runs, name):
    """Each rank's cache shards are the slices ``serve_cache_specs`` names
    under ``LONG_CONTEXT_RULES``: the batch whole, the W slots over 'data'
    where its members divide W (whole where not), the cross K/V's T over
    'data' where they divide it, head_dim over 'model'; ``slot_pos`` is the
    unsharded engine's on every rank."""
    _, ranks = runs
    _, _, shape, _, _, b, s, _ = _case(name)
    cfg = _cfg(name)
    rks = _ranks(ranks, name)
    assert len({tuple(rk[name + "/coords"].tolist()) for rk in rks}) == len(rks)
    w = -(-(cfg.prefix_embeds + s + STEPS) // 8) * 8
    seen = set()
    for rk in rks:
        assert bool(rk[name + "/cache_local_ok"]) and bool(rk[name + "/slot_pos_ok"])
        for k in rk:
            if not k.startswith(name + "/local_shape/"):
                continue
            part, leaf = k.split("/")[-2:]
            local = tuple(rk[k].tolist())
            seen.add(f"{part}/{leaf}")
            wi = 3 if leaf.endswith("pl") else 2
            assert local[wi - 1] == b, k
            size = cfg.encoder_len if part == "cross" else w
            assert local[wi] == (size // shape[0] if size % shape[0] == 0 else size), k
            if leaf in ("k", "v") or leaf.endswith("pl"):
                assert local[-1] == cfg.resolved_head_dim // shape[1], k
    assert ({"cross/k", "cross/v"} <= seen) == cfg.encoder_decoder


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
            if leaf in ("k", "v") or leaf.endswith("mu"):
                assert _rel(got, want) <= RECORD_TOL, k
    assert any(k.startswith("cross/") for k in parts) == _cfg(name).encoder_decoder


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_unsharded_engine_and_the_reference(runs, name):
    """Decode logits with bf16 scores within DECODE_TOL of the unsharded
    port's and the reference's, and with float32 scores within
    DECODE_F32_TOL at every step of the unsharded port's and of the
    reference's own float32-score run (its ``_reduce_scores`` patched the
    same way; with a P = 1 cache within DECODE_F32_PLANES_REF_TOL of the
    reference's), so every step is held against the JAX package.  No
    step's MoE routes differ from the unsharded run's (MAX_FLIPS), with
    bf16 scores or float32 ones: the scores' float32 sum over 'model' is
    rounded to bf16 once, as the reference's compiled step rounds it."""
    ref, ranks = runs
    v = _cfg(name).vocab_size
    ref_tol = DECODE_F32_TOL if _case(name)[3] == "dense" else DECODE_F32_PLANES_REF_TOL
    want = None
    for rk in _ranks(ranks, name):
        got = rk[name + "/logits"][1:, ..., :v]
        plain = rk[name + "/plain_logits"][1:, ..., :v]
        flips = rk[name + "/flips"]
        assert got.shape[0] == STEPS and flips.shape == (STEPS,)
        assert int(flips.sum()) <= MAX_FLIPS and not rk[name + "/flips_f32"].any()
        held = [i for i in range(STEPS) if not flips[i]]
        assert max(_rel(got[i], plain[i]) for i in held) <= DECODE_TOL
        assert max(_rel(got[i], ref[name + "/logits"][1 + i, ..., :v]) for i in held) \
            <= DECODE_TOL
        f32 = rk[name + "/logits_f32"][1:, ..., :v]
        assert max(_rel(g, w) for g, w in zip(f32, plain)) <= DECODE_F32_TOL
        ref_f32 = ref[name + "/logits_f32"][1:, ..., :v]
        assert ref_f32.shape == f32.shape
        assert max(_rel(g, w) for g, w in zip(f32, ref_f32)) <= ref_tol
        want = got if want is None else want
        assert np.array_equal(got, want)


def test_reduce_scores_rounds_the_float32_sum_once(runs):
    """Under LONG_CONTEXT_RULES on (2, 2) the reference's compiled score
    step all-reduces the float32 head_dim partials over 'model' (its HLO
    has no bf16 all-reduce) and rounds their sum to bf16 once; the port's
    ``_reduce_scores`` on the gloo ranks gives the same scores bit for bit
    (integer inputs, so the partial sums are exact), and rounding each
    rank's partial before the sum would not."""
    ref, ranks = runs
    assert set(ref["reduce/all_reduce_types"].tolist()) == {"f32"}
    want = ref["reduce/scores"]
    assert want.dtype == np.float32 and want.shape == (2, 2, 2, 32)
    for rk in ranks[:4]:
        assert np.array_equal(rk["reduce/scores"], want)
        assert not np.array_equal(rk["reduce/twice"], want)


def test_moe_capacity_fills_across_a_rank_boundary(runs):
    """The drop case (``capacity_factor`` 0.5, 61 tokens on (4, 1): ``cap``
    = 8 over the whole sequence): the (position, expert) pairs the ranks
    keep, put together, are the unsharded layer's at every layer and batch
    row, and at least one expert fills its capacity on earlier ranks and
    drops a later rank's routed token."""
    _, ranks = runs
    name = "deepseek_drop_4x1_dense"
    rks = _ranks(ranks, name)
    los = [int(rk[name + "/kept/lo"]) for rk in rks]
    assert los == [_member_range(DROP_S, 4, c)[0] for c in range(4)]
    kept = np.concatenate([rk[name + "/kept/local"] for rk in rks], axis=2)   # (L, B, S, E)
    routed = np.concatenate([rk[name + "/kept/routed"] for rk in rks], axis=2)
    plain = rks[0][name + "/kept/plain"]
    assert kept.shape == plain.shape and kept.shape[2] == DROP_S
    assert np.array_equal(routed, rks[0][name + "/kept/plain_routed"])
    assert np.array_equal(kept, plain)
    assert (kept.sum(2) <= DROP_CAP).all() and (kept.sum(2) == DROP_CAP).any()
    crossed = 0
    for r, lo in enumerate(los[1:], start=1):
        full_before = kept[:, :, :lo].sum(2) == DROP_CAP                       # (L, B, E)
        dropped_here = (routed[:, :, lo:] & ~kept[:, :, lo:]).any(2)
        crossed += int((full_before & dropped_here).sum())
    assert crossed > 0


@pytest.mark.parametrize("what", ["moe", "encoder", "vlm"])
def test_float64_matches_the_unsharded_engine(runs, what):
    """In float64 on (4, 1) the MoE's output at every layer (the drop
    case's capacity binding), whisper's encoder output and internvl2-1b's
    final hidden rows (prefill and 16 decode steps) are the unsharded
    engine's within 1e-12 of the largest |value|."""
    _, ranks = runs
    for rk in ranks[:4]:
        d, top = rk["f64/" + what]
        assert top > 0 and d <= F64_TOL * top, (what, d, top)
        assert bool(rk["f64/moe_dtype_ok"]) and bool(rk["f64/vlm_dtype_ok"])


@pytest.mark.parametrize("world", [4, 3])
def test_gather_and_prefix_sum_on_a_split_sequence(runs, world):
    """``sharding.gather`` over ``act_seq`` brings a sequence of 10 split
    in ``member_range``'s uneven chunks back whole on every rank, and
    ``sharding.seq_prefix_sum`` gives each rank the sum of the earlier
    ranks' counts, in their integer dtype."""
    _, ranks = runs
    rks = ranks[:4] if world == 4 else ranks[4:]
    assert len(rks) == world
    for rk in rks:
        assert bool(rk["collectives/gather_ok"]) and bool(rk["collectives/prefix_ok"])
