"""Long-context serving: the sequence split over ``act_seq``
(``LONG_CONTEXT_RULES``) on gloo ranks, against the unsharded port engine
and the JAX package's GSPMD-partitioned engine; the flash kernel's
``q_offset``; what a long prefill keeps (each layer's whole K/V freed,
the chunked FFN).  The MoE, encoder-decoder and VLM families under the
same split: ``test_torch_long_context_families.py``.

The harness is ``test_torch_sharded_families_serve.py``'s: four worker
processes form a gloo group on a ``FileStore`` under the test's temporary
directory and build ``DeviceMesh``es over it, three more form another, and
one reference subprocess with 4 host devices builds each
``jax.sharding.Mesh`` directly and jits ``repro.serve.engine``'s
``prefill``/``decode_step`` inside ``use_rules(mesh, LONG_CONTEXT_RULES)``
(in-shardings from ``cache_specs_tree(long_context=True)``, the tokens
replicated), from the port's initial parameters.

Cases: the reduced h2o-danube-1.8b (window 8), hymba-1.5b (window 8, the
reduced SSM: 8 heads of 16, chunk 16, conv width 4), mamba2-1.3b and
llama3.2-1b (full attention) on a data-only (4, 1), a (2, 2) data x model
and a (3, 1) mesh, with dense and P = 1 caches: 2 prompts of 13 tokens, so
the ranks hold 4, 4, 4, 1 positions on (4, 1), 7, 6 on (2, 2) and 5, 5, 3
on (3, 1) -- no rank a multiple of the SSM's chunk, and on (4, 1) and
(3, 1) the last rank's window halo of 7 positions spans two ranks -- then
16 decode steps of given tokens (twice the window: the ring wraps on every
rank) in a cache sized for 32 positions.  The window of 8 slots splits 2 a
rank on (4, 1) and 4 on (2, 2) and is whole on (3, 1); llama3.2-1b's 32
slots split 8 and 16, and are whole on (3, 1).

Tolerances, as shares of the largest |value| (measured on these inputs,
torch 2.13 and jax 0.9, x86-64 CPU):
  - prefill logits within 1e-5 of the unsharded port's and of the
    reference's (measured up to 6.8e-7 and 9.9e-7), and the gathered cache
    -- K/V, the compressed records' mu, the SSM state and conv tail --
    within 1e-5 of the largest of each (measured up to 1.9e-6): the halo'd
    flash sums its keys in another order and the SSM adds the carried
    state's term after the rank's scan;
  - decode logits within 3e-2 of the unsharded port's (measured up to
    9.5e-3 on the data-only meshes and on (2, 2)): under any rules
    context the scores' float32 sum over 'model' is rounded to bf16 once,
    as the reference's compiled step rounds it (a one-member 'model'
    included); and within 2e-5 with the scores summed in float32 (``_reduce_scores``
    patched in the worker; measured up to 1.7e-6 on the data-only meshes,
    where the cross-rank softmax merge sums in another order, and 2.0e-6 on
    (2, 2));
  - decode logits within 3e-2 of the reference's (measured up to 1.6e-4
    on the data-only meshes, 4.6e-5 on (2, 2)).

The float64 case (compute dtype float64 on (4, 1)) holds the SSM's state
hand-off -- mamba2-1.3b's last hidden row, its state (kept in float32 by
the cache) and conv tail -- and the decode's cross-rank softmax merge --
h2o-danube-1.8b's final hidden rows over 16 steps from the unsharded
prefill's cache placed on the mesh, the scores summed unrounded -- to the
unsharded engine within 1e-12 (measured up to 1.0e-15; the float32 logits
are left out).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS, SEQ_LEN, WINDOW = 2, 13, 16, 32, 8
ARCHS = {"danube": "h2o-danube-1.8b", "hymba": "hymba-1.5b", "mamba2": "mamba2-1.3b",
         "llama": "llama3.2-1b"}
MODES = (("dense", 1), ("p1", 1))


def _cases(meshes):
    return [(f"{short}_{m[0]}x{m[1]}_{tag}", arch, m, "dense" if tag == "dense" else "compressed",
             planes) for short, arch in ARCHS.items() for m in meshes for tag, planes in MODES]


# (name, arch, mesh shape over ("data", "model"), kv_mode, planes)
CASES4 = _cases([(4, 1), (2, 2)])
CASES3 = _cases([(3, 1)])
CASES = CASES4 + CASES3
NAMES = [c[0] for c in CASES]
PREFILL_TOL = 1e-5
RECORD_TOL = 1e-5
DECODE_TOL = 3e-2
DECODE_F32_TOL = 2e-5
F64_TOL = 1e-12

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch import configs as pconfigs
from repro_torch.core import pytree
from repro_torch.models import transformer as T
B, S, STEPS, SEQ_LEN, WINDOW = {B}, {S}, {STEPS}, {SEQ_LEN}, {WINDOW}
CASES = {cases!r}

def cut(cfg):
    # the reduced config, its window (where it has one) cut to WINDOW
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, sliding_window=WINDOW) if cfg.sliding_window else cfg

def port_model(arch, **kw):
    cfg = dataclasses.replace(cut(pconfigs.get(arch)), **kw)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")

def tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
"""

REFERENCE = COMMON + r"""
import sys
import os
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
    rcfg = cut(rconfigs.get(arch))
    _cfg, model = port_model(arch)
    stacked = {{}}
    for n, t in pytree.leaf_paths(T.param_tree(model)):
        parts = n.split("/")
        key = "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" else n
        stacked.setdefault(key, []).append(t.numpy())
    def leaf(kp, _leaf):
        p = path_str(kp)
        return np.stack(stacked[p]) if p.startswith("layers/") else stacked[p][0]
    return rcfg, jax.tree_util.tree_map_with_path(leaf, RT.param_specs(rcfg))

out = {{}}
for name, arch, shape, mode, P in CASES:
    rcfg, params = ref_params(arch)
    toks = tokens(rcfg)
    mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"))
    is_spec = lambda s: isinstance(s, PS)
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=is_spec)
    psh = sh(rmesh.param_specs_tree(rcfg, params, mesh))
    csh = sh(rmesh.cache_specs_tree(rcfg, mesh, RE.cache_specs(rcfg, B, SEQ_LEN, kv_mode=mode,
                                                               num_planes=P),
                                    long_context=True))
    tsh = NamedSharding(mesh, PS(None, None))
    with rsharding.use_rules(mesh, rsharding.LONG_CONTEXT_RULES):
        pre = jax.jit(lambda p, t: RE.prefill(p, rcfg, t, seq_len=SEQ_LEN, kv_mode=mode,
                                              num_planes=P), in_shardings=(psh, tsh))
        dec = jax.jit(lambda p, c, t: RE.decode_step(p, rcfg, c, t, kv_mode=mode, num_planes=P),
                      in_shardings=(psh, csh, tsh))
        p_ = jax.device_put(params, psh)
        cache, logits = pre(p_, jnp.asarray(toks[:, :S]))
        for k, v in cache["layers"].items():
            out[f"{{name}}/layers/{{k}}"] = np.asarray(v)
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

def decode(params, cfg, cache, toks, mode, P):
    lg = []
    for t in range(STEPS):
        tok = torch.from_numpy(toks[:, S + t:S + t + 1])
        logits, cache = E.decode_step(params, cfg, cache, tok, kv_mode=mode, num_planes=P)
        lg.append(full(logits))
    return lg

def run(params, cfg, toks, mode, P, mesh=None):
    ctx = SH.use_rules(mesh, LONG) if mesh is not None else torch.no_grad()
    with ctx:
        cache, logits = E.prefill(params, cfg, torch.from_numpy(toks[:, :S]), seq_len=SEQ_LEN,
                                  kv_mode=mode, num_planes=P)
        first = {{k: (v.to_local().clone() if hasattr(v, "to_local") else v.clone(),
                     full(v).clone()) for k, v in cache["layers"].items()}}
        slot_pos = full(cache["slot_pos"]).clone()
        lg = [full(logits)] + decode(params, cfg, cache, toks, mode, P)
    return first, slot_pos, torch.stack(lg)

for name, arch, shape, mode, P in CASES:
    cfg, model = port_model(arch)
    toks = tokens(cfg)
    plain_first, plain_slots, plain_logits = run(model, cfg, toks, mode, P)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coords = mesh.get_coordinate()
    tree = T.param_tree(model)
    params = M.shard_tree(tree, M.param_specs_tree(cfg, tree, mesh), mesh)
    first, slots, logits = run(params, cfg, toks, mode, P, mesh)
    with SH.use_rules(mesh, LONG):
        cspecs = M.serve_cache_specs(mesh, E.cache_specs(cfg, B, SEQ_LEN, kv_mode=mode,
                                                         num_planes=P))
    cache_ok = True
    for k, (loc, whole) in first.items():
        idx = M.local_index(cspecs["layers"][k], whole.shape, mesh, coords)
        cache_ok &= torch.equal(loc, whole[idx])
        out[f"{{name}}/layers/{{k}}"] = whole.numpy()
        out[f"{{name}}/plain/layers/{{k}}"] = plain_first[k][1].numpy()
        out[f"{{name}}/local_shape/{{k}}"] = np.array(loc.shape)
    out[name + "/cache_local_ok"] = np.array(cache_ok)
    out[name + "/slot_pos_ok"] = np.array(torch.equal(slots, plain_slots))
    out[name + "/logits"] = logits.numpy()
    out[name + "/plain_logits"] = plain_logits.numpy()
    E._reduce_scores = f32_reduce
    try:
        out[name + "/logits_f32"] = run(params, cfg, toks, mode, P, mesh)[2].numpy()
    finally:
        E._reduce_scores = bf16_reduce
    out[name + "/coords"] = np.array(coords)

if {float64!r}:
    # the SSM's state hand-off and the decode's cross-rank merge in float64;
    # logits_for (float32 logits) patched to hand back the final hidden row,
    # the scores summed unrounded
    logits_for = T.logits_for
    T.logits_for = lambda params, cfg, h: h
    E._reduce_scores = f32_reduce
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    cfg, model = port_model("mamba2-1.3b", compute_dtype="float64")
    toks = tokens(cfg)
    want, _, want_h = run(model, cfg, toks, "dense", 1)
    tree = T.param_tree(model)
    params = M.shard_tree(tree, M.param_specs_tree(cfg, tree, mesh), mesh)
    got, _, got_h = run(params, cfg, toks, "dense", 1, mesh)
    out["f64/mamba2/hidden"] = np.array([float((got_h[0] - want_h[0]).abs().max()),
                                         float(want_h[0].abs().max())])
    for k in ("state", "conv"):
        out[f"f64/mamba2/{{k}}"] = np.array([float((got[k][1] - want[k][1]).abs().max()),
                                            float(want[k][1].abs().max())])
    cfg, model = port_model("h2o-danube-1.8b", compute_dtype="float64")
    toks = tokens(cfg)
    with torch.no_grad():
        cache, _ = E.prefill(model, cfg, torch.from_numpy(toks[:, :S]), seq_len=SEQ_LEN)
        whole = {{"pos": cache["pos"], "slot_pos": cache["slot_pos"].clone(),
                 "layers": {{k: v.clone() for k, v in cache["layers"].items()}}}}
        want_h = torch.stack(decode(model, cfg, cache, toks, "dense", 1))
    tree = T.param_tree(model)
    params = M.shard_tree(tree, M.param_specs_tree(cfg, tree, mesh), mesh)
    with SH.use_rules(mesh, LONG):
        cspecs = M.serve_cache_specs(mesh, E.cache_specs(cfg, B, SEQ_LEN))
        placed = M.shard_cache(whole, cspecs, mesh)
        out["f64/danube/w_local"] = np.array(placed["layers"]["k"].to_local().shape[2])
        got_h = torch.stack(decode(params, cfg, placed, toks, "dense", 1))
    out["f64/danube/decode"] = np.array([float((got_h - want_h).abs().max()),
                                         float(want_h.abs().max())])
    out["f64/dtype_ok"] = np.array(got_h.dtype == torch.float64)
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
    tmp = tmp_path_factory.mktemp("long_context")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    sizes = dict(B=B, S=S, STEPS=STEPS, SEQ_LEN=SEQ_LEN, WINDOW=WINDOW)
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


def _cfg(arch):
    from repro_torch import configs

    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, sliding_window=WINDOW) if cfg.sliding_window else cfg


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_window_slots(runs, name):
    """Each rank's cache shards are the slices ``serve_cache_specs`` names
    under ``LONG_CONTEXT_RULES``: the batch whole, the window's W slots
    over 'data' where its members divide W (whole where not), head_dim over
    'model', the SSM state over its heads; ``slot_pos`` is the unsharded
    engine's on every rank."""
    _, ranks = runs
    _, arch, shape, _, _ = _case(name)
    rks = _ranks(ranks, name)
    assert len({tuple(rk[name + "/coords"].tolist()) for rk in rks}) == len(rks)
    w = min(SEQ_LEN, WINDOW) if _cfg(arch).sliding_window else SEQ_LEN
    for rk in rks:
        assert bool(rk[name + "/cache_local_ok"]) and bool(rk[name + "/slot_pos_ok"])
        for k in rk:
            if not k.startswith(name + "/local_shape/"):
                continue
            leaf, local = k.split("/")[-1], tuple(rk[k].tolist())
            wi = 3 if leaf.endswith("pl") else 2
            assert local[wi - 1] == B, k
            if leaf in ("k", "v") or leaf[1:] in ("mu", "sexp", "pl"):
                assert local[wi] == (w // shape[0] if w % shape[0] == 0 else w), k


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    v = _cfg(_case(name)[1]).vocab_size
    rks = _ranks(ranks, name)
    for rk in rks:
        got = rk[name + "/logits"][0][..., :v]
        assert _rel(got, rk[name + "/plain_logits"][0][..., :v]) <= PREFILL_TOL
        assert _rel(got, ref[name + "/logits"][0][..., :v]) <= PREFILL_TOL
        assert np.array_equal(rk[name + "/logits"], rks[0][name + "/logits"])
    rk = rks[0]
    parts = sorted(k[len(name) + 1:] for k in rk if k.startswith(name + "/layers/"))
    assert parts
    for k in parts:
        got = rk[f"{name}/{k}"]
        for want in (rk[f"{name}/plain/{k}"], ref[f"{name}/{k}"]):
            assert got.shape == want.shape and got.dtype == want.dtype, k
            leaf = k.split("/")[-1]
            if leaf in ("k", "v", "state", "conv") or leaf.endswith("mu"):
                assert _rel(got, want) <= RECORD_TOL, k
    leaves = {k.split("/")[-1] for k in parts}
    family = _cfg(_case(name)[1]).family
    assert ({"state", "conv"} <= leaves) == (family in ("ssm", "hybrid"))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_unsharded_engine_and_the_reference(runs, name):
    ref, ranks = runs
    _, arch, _, _, _ = _case(name)
    v = _cfg(arch).vocab_size
    want = None
    for rk in _ranks(ranks, name):
        got = rk[name + "/logits"][1:, ..., :v]
        plain = rk[name + "/plain_logits"][1:, ..., :v]
        assert got.shape[0] == STEPS
        assert max(_rel(g, w) for g, w in zip(got, plain)) <= DECODE_TOL
        assert max(_rel(g, w) for g, w in zip(got, ref[name + "/logits"][1:, ..., :v])) \
            <= DECODE_TOL
        f32 = rk[name + "/logits_f32"][1:, ..., :v]
        assert max(_rel(g, w) for g, w in zip(f32, plain)) <= DECODE_F32_TOL
        want = got if want is None else want
        assert np.array_equal(got, want)


@pytest.mark.parametrize("what", ["mamba2/hidden", "mamba2/state", "mamba2/conv",
                                  "danube/decode"])
def test_float64_state_hand_off_and_softmax_merge(runs, what):
    """In float64 the SSM's cross-rank state hand-off and the decode's
    cross-rank softmax merge are the unsharded engine's within 1e-12 (of
    the largest |value|): mamba2-1.3b's prefill -- the last position's
    final hidden row, the state and the conv tail -- and h2o-danube-1.8b's
    final hidden rows over 16 decode steps (the logits, float32, are left
    out)."""
    _, ranks = runs
    for rk in ranks[:4]:
        assert bool(rk["f64/dtype_ok"])
        d, top = rk["f64/" + what]
        assert top > 0 and d <= F64_TOL * top, (what, d, top)
        assert int(rk["f64/danube/w_local"]) == WINDOW // 4


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 5), (True, 4, 7), (False, 0, 3)])
def test_flash_q_offset_matches_the_reference(causal, window, q_offset):
    """``ref.flash_attention_ref(q_offset=...)`` against
    ``repro.models.layers.flash_attention(q_offset=...)``: queries at key
    indices q_offset + i over q_offset + Sq keys (a halo before the
    queries' own), causal, windowed and full; float32 sums in another
    order, within 1e-6 of the largest output."""
    import jax.numpy as jnp
    import torch

    from repro.models import layers as RL
    from repro_torch.kernels import ref

    rng = np.random.default_rng(q_offset)
    sq = 9
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, q_offset + sq, 2, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, window=window, q_offset=q_offset,
                                         q_chunk=4, kv_chunk=4))
    got = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                  window=window, q_offset=q_offset, q_chunk=4,
                                  kv_chunk=4).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the halo's keys matter: the same queries without them differ
    if causal:
        alone = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k[:, q_offset:],
                                                                          v[:, q_offset:])),
                                        causal=causal, window=window).numpy()
        assert np.abs(alone - want).max() > 1e-3


def test_prefill_frees_each_layers_whole_kv_before_the_next_layer(monkeypatch):
    """A prefill keeps only the cached positions of each layer's K/V
    (``transformer._run_layers(capture_from=)``), as copies: when a layer's
    attention runs, no earlier layer's whole-sequence K/V storage is still
    alive.  Reduced h2o-danube-1.8b (window 8), 13 tokens, unsharded."""
    import torch
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.models import layers as L, transformer as T
    from repro_torch.serve import engine as E

    cfg = _cfg("h2o-danube-1.8b")
    model = T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    attention, seen, alive = L.attention, [], []

    def spy(*args, **kwargs):
        alive.append(sum(not r.expired() for r in seen))
        out, (k, v) = attention(*args, **kwargs)
        seen.extend(StorageWeakRef(t.untyped_storage()) for t in (k, v))
        return out, (k, v)

    monkeypatch.setattr(L, "attention", spy)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    cache, _ = E.prefill(model, cfg, torch.from_numpy(toks), seq_len=SEQ_LEN)
    assert cfg.n_layers > 1 and alive == [0] * cfg.n_layers
    assert cache["layers"]["k"].shape[2] == WINDOW


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hymba-1.5b"])
def test_chunked_ffn_matches_the_whole(arch, monkeypatch):
    """Outside autograd ``transformer.ffn_part`` runs a dense FFN over more
    than ``FFN_CHUNK`` positions a chunk at a time.  With FFN_CHUNK 4 over
    13 positions (chunks of 4, 4, 4 and a ragged 1) a dense and a hybrid
    layer's FFN equal the unchunked one's (float32; measured bit for bit
    on x86-64 CPU, held within 1e-6 of the largest |value|)."""
    import torch

    from repro_torch.models import layers as L, transformer as T

    cfg = _cfg(arch)
    lp = T.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")["layers"][0]
    h = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    mlp, rows = L.swiglu_mlp, []

    def spy(p, x):
        rows.append(x.shape[1])
        return mlp(p, x)

    monkeypatch.setattr(L, "swiglu_mlp", spy)
    with torch.no_grad():
        want, _ = T.ffn_part(lp, h, cfg)
        monkeypatch.setattr(T, "FFN_CHUNK", 4)
        got, _ = T.ffn_part(lp, h, cfg)
    assert rows == [S, 4, 4, 4, 1]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
