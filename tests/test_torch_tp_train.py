"""Tensor-parallel training: the differentiable collectives of
``models/sharding.py``, the layers and the vocab-parallel loss under
autograd, on gloo ranks against the unsharded functions.

Two groups of worker processes (``python -c`` on a ``FileStore`` under the
test's temporary directory) run every case: four ranks, on (1, 4) and
(2, 2) ``data`` x ``model`` meshes, and three, on (1, 3) and (3, 1), where
the heads split unevenly, a rank may hold no query head, and ``gate_up``'s
all-to-all runs on an odd axis.  Each case draws its whole float64 inputs
and an output cotangent from a seed (the same on every rank), computes the
unsharded function and its ``torch.autograd`` gradients in the worker, then
the sharded function on this rank's shards inside ``sharding.use_rules``
and the gradients of this rank's share of the loss (its output shard
against its shard of the cotangent: Megatron's convention, a tensor held
whole carries the whole cotangent).  The outputs and every input's
gradient must equal the unsharded ones' shards within 1e-12.  Some layers
compute in float32 inside (the rotary embedding, the flash attention, the
MoE's router), the same on either side: the inputs lie on a grid of 1/64,
so the products before those casts are exact whatever order the sums run
in, and the attention cases keep each kv head's query heads on one rank,
so that no float32 sum of the flash backward runs in another order.  The
norms, the SwiGLU gate and the SSD scan compute their float32 parts in
float64 for float64 inputs (``layers.acc_dtype``), and the frontends take
``compute_dtype="float64"``.  The SSM cases cover ``mamba2`` with its
heads split (``in``'s activation and ``conv`` gathered whole and entered,
the per-head vectors replicated), with a rank that holds no SSM head, and
the gated norm where ``out``'s rows are the heads' and where they are not;
whisper's cross-attention through ``cross_kv``; ``frontend_proj`` through
``_encode`` and the VLM's ``_inputs``.

The backward runs on a thread of its own, as autograd runs a CUDA
tensor's on the card's device thread, which holds no rules context; the
loss with remat, differentiated there, must give the calling thread's
gradients bit for bit, for the dense family on (1, n) and the hybrid on
the data x model mesh.  A last case counts the tensor-parallel training
step's collectives on a (1, 4) mesh with ``roofline.hlo_cost.OpCounter``
for the reduced llama3.2-1b and mamba2-1.3b: its ``model``-axis
all-gathers carry less than one whole copy of the ``model``-split
parameters' bytes, and ``sharding.weight`` gathers none of them whole
over ``model`` but mamba2's ``conv``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-12
CASES = ["gather", "take", "all_reduce", "enter", "weight_over_data", "gate_up",
         "kv_for_heads", "attention", "attention_uneven_heads", "swiglu_mlp", "moe_ffn",
         "embed_tokens", "chunked_ce_loss", "mamba2", "mamba2_no_heads", "ssm_norm_split",
         "ssm_norm_gathered", "cross_kv", "frontend_proj", "vlm_inputs"]

WORKER = r"""
import dataclasses, sys, threading, types
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L, sharding as S, transformer as T

rank, n, store, dest = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
NAMES = ("data", "model")
tp = init_device_mesh("cpu", (1, n), mesh_dim_names=NAMES)
if n == 4:
    dp = init_device_mesh("cpu", (2, 2), mesh_dim_names=NAMES)
else:
    dp = init_device_mesh("cpu", (n, 1), mesh_dim_names=NAMES)
out = {}
seed = iter(range(1000))


def rnd(*shape):
    # on a grid of 1/64: the first products are exact in any order of sums
    x = np.random.default_rng(next(seed)).standard_normal(shape)
    return torch.from_numpy(np.round(x * 64) / 64)


def local_of(t, lay, mesh):
    # this rank's shard of a whole tensor in a layout, or a function of it
    if callable(lay):
        return lay(t)
    spec = M.layout_spec(lay, mesh)
    return t[M.local_index(spec, t.shape, mesh, mesh.get_coordinate())]


def on_another_thread(fn):
    # the card's autograd runs a CUDA tensor's backward (and a remat
    # recompute) on a device thread of its own, which holds no rules
    # context: run the backward so here too
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # raised again on the calling thread
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    if t.is_alive() or "err" in box:
        raise box.get("err", TimeoutError("the backward did not end"))
    return box["out"]


def check(name, mesh, ins, lays, sharded, whole, out_lays, rules=None, split=None):
    # ins: whole float64 tensors (None: not differentiated); sharded(*local
    # inputs) and whole(*inputs) return lists of outputs, the first ones
    # differentiable
    wins = [t.clone().requires_grad_() if t.is_floating_point() else t for t in ins]
    wout = whole(*wins)
    cots = [rnd(*o.shape) for o in wout]
    loss = sum((o * c).sum() for o, c in zip(wout, cots))
    diff = [t for t in wins if t.requires_grad]
    wgrad = torch.autograd.grad(loss, diff)
    with S.use_rules(mesh, rules):
        lins = [local_of(t, lay, mesh).clone() for t, lay in zip(ins, lays)]
        lins = [t.requires_grad_() if t.is_floating_point() else t for t in lins]
        if split is not None:
            with S.split_batch([mesh.get_group(i) for i in split], S.mesh_size(split), split):
                lout = sharded(*lins)
        else:
            lout = sharded(*lins)
        lcots = [local_of(c, lay, mesh) for c, lay in zip(cots, out_lays)]
        lloss = sum((o * c).sum() for o, c in zip(lout, lcots))
        ldiff = [t for t in lins if t.requires_grad]
        lgrad = on_another_thread(lambda: torch.autograd.grad(lloss, ldiff))
        want_out = [local_of(o.detach(), lay, mesh) for o, lay in zip(wout, out_lays)]
        want_grad = [local_of(g, lay, mesh)
                     for g, lay in zip(wgrad, [lay for t, lay in zip(ins, lays)
                                                if t.is_floating_point()])]
    fwd = max(float((a.detach().double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(lout, want_out))
    grad = max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in zip(lgrad, want_grad))
    out[name + "/fwd"] = np.array(fwd)
    out[name + "/grad"] = np.array(grad)
    out[name + "/scale"] = np.array(max(float(g.abs().max()) for g in wgrad))
    out[name + "/shapes"] = np.array([a.numel() for a in lgrad])


M0, M1 = (0,), (1,)
WHOLE3 = ((), (), ())

# gather / take: a (5, 13, 3) tensor split unevenly along dim 1 -- over
# data x model on (2, 2), over model on (1, 3)
mesh, dims = (dp, (0, 1)) if n == 4 else (tp, M1)
x = rnd(5, 13, 3)
check("gather", mesh, [x], [((), dims, ())],
      lambda a: [S.gather(a, 1, dims, 13) * 1.0], lambda a: [a * 1.0], [WHOLE3])
check("take", mesh, [x], [WHOLE3],
      lambda a: [S.take(a, 1, dims)], lambda a: [a * 1.0], [((), dims, ())])

# all_reduce: rank r's partial sum is row r of a (n, 5, 7) stack
p = rnd(n, 5, 7)
check("all_reduce", mesh, [p], [(dims, (), ())],
      lambda a: [S.all_reduce(a[0] * 1.0, dims)], lambda a: [a.sum(0)], [((), ())])

# enter: a whole x into work split over the ranks (an uneven last dim)
x, w = rnd(5, 7), rnd(5, 7, 2 * n + 1)
check("enter", mesh, [x, w], [((), ()), ((), (), dims)],
      lambda a, b: [S.enter(a, dims)[..., None] * b], lambda a, b: [a[..., None] * b],
      [((), (), dims)])

# weight over data: FSDP's gather at use under split_batch -- (2, 2): W
# (D, N) split over data (rows) and model (columns, kept), the batch's
# rows over data, x entering the column-split product; (3, 1): over data
x, w = rnd(6, 9), rnd(9, 8)
wlay = (M0, M1)
shape = tuple(w.shape)


def weighted(a, b):
    wl, lay = S.weight(S.Shard(b, wlay, shape), keep=(1,))
    return [L.dense(S.enter(a, lay[1]), wl)]


check("weight_over_data", dp, [x, w], [(M0, ()), wlay], weighted,
      lambda a, b: [a @ b], [(M0, M1)], split=M0)

# gate_up: the fused [gate | up] columns split over model -> gate and up
# each over model (the all-to-all; an odd axis on three ranks)
f = 2 * n
gu = rnd(2, 3, 2 * f)
check("gate_up", tp, [gu], [((), (), M1)],
      lambda a: list(L.gate_up(a, M1, f, M1)), lambda a: list(torch.chunk(a, 2, -1)),
      [((), (), M1), ((), (), M1)])

# kv_for_heads: 6 query heads over 2 kv heads (g 3) on the model axis --
# ranks straddle a group, and on four ranks the last holds no head
hq, hkv = 6, 2
g = hq // hkv
k = rnd(2, 3, hkv, 4)


def kv_sharded(a):
    h0, h1 = S.chunk_range(hq, S.mesh_dims("act_heads"))
    kh = L.kv_for_heads(a, h0, h1, g, S.mesh_dims("act_heads"))
    return [kh.repeat_interleave(g, 2) if h0 % g == 0 and h1 % g == 0 else kh]


check("kv_for_heads", tp, [k], [((), (), (), ())], kv_sharded,
      lambda a: [a.repeat_interleave(g, 2)], [((), (), M1, ())])


def attention_case(name, hq, hkv, hd, d=12):
    cfg = types.SimpleNamespace(resolved_head_dim=hd, n_heads=hq, n_kv_heads=hkv,
                                rope_theta=10000.0, sliding_window=0)
    x = rnd(2, 5, d)
    ws = [rnd(d, hq * hd), rnd(d, hkv * hd), rnd(d, hkv * hd), rnd(hq * hd, d)]
    lays = [((), M1), ((), M1), ((), M1), (M1, ())]
    names = ("wq", "wk", "wv", "wo")

    def sharded(a, *w):
        p = {nm: S.Shard(t, lay, t0.shape) for nm, t, lay, t0 in zip(names, w, lays, ws)}
        return [L.attention(p, a, cfg)[0]]

    def whole(a, *w):
        return [L.attention(dict(zip(names, w)), a, cfg)[0]]

    check(name, tp, [x] + ws, [((), (), ())] + lays, sharded, whole, [WHOLE3])


# each rank holds whole kv groups: 2n query heads over n kv heads
attention_case("attention", 2 * n, n, 4)
# uneven heads, one kv head a query head: 5 heads on four ranks (2, 2, 1,
# none: q and o resharded through gather/take, the last rank tied in), 7
# on three (3, 3, 1)
attention_case("attention_uneven_heads", 5, 5, 4) if n == 4 else \
    attention_case("attention_uneven_heads", 7, 7, 6)

# swiglu_mlp: wi column-parallel, the hidden through gate_up, wo row-parallel
d, f = 12, 2 * n
x, wi, wo = rnd(2, 5, d), rnd(d, 2 * f), rnd(f, d)
check("swiglu_mlp", tp, [x, wi, wo], [WHOLE3, ((), M1), (M1, ())],
      lambda a, b, c: [L.swiglu_mlp({"wi": S.Shard(b, ((), M1), wi.shape),
                                     "wo": S.Shard(c, (M1, ()), wo.shape)}, a)],
      lambda a, b, c: [L.swiglu_mlp({"wi": b, "wo": c}, a)], [WHOLE3])

# moe_ffn: 2n experts over the model axis (two a rank), top-2 at capacity
# factor 1 over 16 tokens (tokens dropped), the router column-parallel,
# two shared experts through swiglu_mlp; the output and the balance loss
e, fe = 2 * n, 4
cfg = types.SimpleNamespace(n_experts=e, top_k=2, capacity_factor=1.0)
x = rnd(2, 16, d)
ws = {"router": rnd(d, e), "wi": rnd(e, d, 2 * fe), "wo": rnd(e, fe, d),
      "shared_wi": rnd(d, 4 * fe), "shared_wo": rnd(2 * fe, d)}
lays = {"router": ((), M1), "wi": (M1, (), ()), "wo": (M1, (), ()),
        "shared_wi": ((), M1), "shared_wo": (M1, ())}
names = list(ws)


def moe_sharded(a, *w):
    p = {nm: S.Shard(t, lays[nm], ws[nm].shape) for nm, t in zip(names, w)}
    y, aux = L.moe_ffn(p, a, cfg)
    return [y, aux.reshape(1)]


def moe_whole(a, *w):
    y, aux = L.moe_ffn(dict(zip(names, w)), a, cfg)
    return [y, aux.reshape(1)]


check("moe_ffn", tp, [x] + list(ws.values()), [WHOLE3] + [lays[k] for k in names],
      moe_sharded, moe_whole, [WHOLE3, ((),)])

# embed_tokens: the vocabulary's rows over model, a masked local lookup
# all-reduced (its backward the identity)
ecfg = types.SimpleNamespace(padded_vocab=384, compute_dtype="float32")
tok = torch.from_numpy(np.random.default_rng(next(seed)).integers(0, 250, (2, 9)))
emb = rnd(384, d)
check("embed_tokens", tp, [tok, emb], [((), ()), (M1, ())],
      lambda t, w: [T.embed_tokens({"embed": S.Shard(w, (M1, ()), emb.shape)}, ecfg, t)],
      lambda t, w: [T.embed_tokens({"embed": w}, ecfg, t)], [WHOLE3])

# chunked_ce_loss, vocab-parallel: 250 real columns padded to 384 (a rank
# holds only padding), 20 positions in chunks of 8, ignored labels; the
# head untied on four ranks, tied to the embedding on three
tied = n == 3
ccfg = types.SimpleNamespace(vocab_size=250, padded_vocab=384, tie_embeddings=tied)
h = rnd(2, 20, d)
labels = torch.from_numpy(np.random.default_rng(next(seed)).integers(0, 250, (2, 20)))
labels[:, ::7] = -1
key, w, wlay = ("embed", rnd(384, d), (M1, ())) if tied else ("lm_head", rnd(d, 384), ((), M1))


def ce(params, hh, lab):
    loss, cnt = T.chunked_ce_loss(params, ccfg, hh, lab, chunk=8)
    out["chunked_ce_loss/count"] = np.array(int(cnt))
    return [loss.reshape(1)]


check("chunked_ce_loss", tp, [h, w, labels], [WHOLE3, wlay, ((), ())],
      lambda a, b, c: ce({key: S.Shard(b, wlay, w.shape)}, a, c),
      lambda a, b, c: ce({key: b}, a, c), [((),)])



def split_if(size, d):
    # a dim split over model where n divides it, else whole (launch/mesh._sanitize)
    return M1 if size % n == 0 else ()


def ssm_cfg(h, hp, nst=4, chunk=4):
    return types.SimpleNamespace(ssm_d_inner=h * hp, ssm_n_heads=h, ssm_state=nst,
                                 ssm_head_dim=hp, ssm_chunk=chunk, ssm_conv_width=4,
                                 norm_eps=1e-5)


def mamba2_case(name, cfg, d=12, s=12):
    # mamba2's heads over model: in (D, Z) and conv (W, CC) column-split and
    # out (di, D) row-split where n divides them, the per-head vectors and
    # the norm whole; 3 chunks of the scan
    z, cc, di = L.ssm_in_features(cfg), L.ssm_conv_channels(cfg), cfg.ssm_d_inner
    x = rnd(2, s, d)
    ws = {"in": rnd(d, z), "conv": rnd(cfg.ssm_conv_width, cc), "dt_bias": rnd(cfg.ssm_n_heads),
          "A_log": rnd(cfg.ssm_n_heads), "D": rnd(cfg.ssm_n_heads), "norm": rnd(di),
          "out": rnd(di, d)}
    lays = {"in": ((), split_if(z, 1)), "conv": ((), split_if(cc, 1)), "dt_bias": ((),),
            "A_log": ((),), "D": ((),), "norm": ((),), "out": (split_if(di, 0), ())}
    names = list(ws)

    def sharded(a, *w):
        return [L.mamba2({k: S.Shard(t, lays[k], ws[k].shape) for k, t in zip(names, w)},
                         a, cfg)]

    check(name, tp, [x] + list(ws.values()), [WHOLE3] + [lays[k] for k in names], sharded,
          lambda a, *w: [L.mamba2(dict(zip(names, w)), a, cfg)], [WHOLE3])


# 8 heads of 4: on four ranks every weight split, out's rows the heads'
# (the split norm); on three 3, 3, 2 heads and every weight whole
mamba2_case("mamba2", ssm_cfg(8, 4))
# 4 heads of 32 (ssm_head_dim=32): on three ranks 2, 2 and none
mamba2_case("mamba2_no_heads", ssm_cfg(4, 32))


def ssm_norm_case(name, h, hp, d=12):
    # the gated norm and out from the heads' columns of y: out's rows the
    # heads' (the split sum of squares) or not (y gathered and normed whole)
    cfg = ssm_cfg(h, hp)
    di = h * hp
    y, norm, wo = rnd(2, 5, di), rnd(di), rnd(di, d)
    olay = (split_if(di, 0), ())

    def cols(t):
        h0, h1 = S.chunk_range(h, S.mesh_dims("act_heads"))
        return t[..., h0 * hp:h1 * hp]

    def sharded(a, b, c):
        heads, h0, h1 = L._ssm_heads(cfg)
        return [L._ssm_norm_out({"norm": b, "out": S.Shard(c, olay, wo.shape)}, a, cfg,
                                heads, h0, h1)]

    def whole(a, b, c):
        return [L._ssm_norm_out({"norm": b, "out": c}, a, cfg, (), 0, h)]

    check(name, tp, [y, norm, wo], [cols, ((),), olay], sharded, whole, [WHOLE3])
    with S.use_rules(tp):
        lo = S.chunk_range(di, olay[0])
        out[name + "/split"] = np.array(lo == tuple(hp * c for c in L._ssm_heads(cfg)[1:]))


# 2n heads of 2 (4 on four ranks): out's rows are each rank's heads
ssm_norm_case("ssm_norm_split", 2 * n, 2 if n == 3 else 4)
# 5 heads of 4 on four ranks (rows of 5 against heads 2, 2, 1, none), 4 of
# 3 on three (rows of 4 against heads 2, 2, none)
ssm_norm_case("ssm_norm_gathered", 5, 4) if n == 4 else ssm_norm_case("ssm_norm_gathered", 4, 3)


# whisper's cross branch: K/V from the encoder output through cross_kv
# (column-parallel, gathered whole), the query heads over model, 5 decoder
# positions against 7 encoder positions, non-causal
hq, hkv, hd = 2 * n, n, 4
ccfg = types.SimpleNamespace(resolved_head_dim=hd, n_heads=hq, n_kv_heads=hkv,
                             rope_theta=10000.0, sliding_window=0)
x, enc = rnd(2, 5, d), rnd(2, 7, d)
ws = [rnd(d, hq * hd), rnd(d, hkv * hd), rnd(d, hkv * hd), rnd(hq * hd, d)]
lays = [((), M1), ((), M1), ((), M1), (M1, ())]
names = ("wq", "wk", "wv", "wo")


def cross(p, a, e):
    return [L.attention(p, a, ccfg, causal=False, kv_override=L.cross_kv(p, e, ccfg))[0]]


check("cross_kv", tp, [x, enc] + ws, [WHOLE3, WHOLE3] + lays,
      lambda a, e, *w: cross({k: S.Shard(t, lay, t0.shape)
                              for k, t, lay, t0 in zip(names, w, lays, ws)}, a, e),
      lambda a, e, *w: cross(dict(zip(names, w)), a, e), [WHOLE3])

# frontend_proj (D, D) column-parallel through _encode (no encoder layer:
# attention and MLP are the cases above), then the encoder's final norm
fcfg = types.SimpleNamespace(d_model=d, compute_dtype="float64", norm_eps=1e-5)
frames, fp, fln = rnd(2, 7, d), rnd(d, d), rnd(d)
flay = ((), split_if(d, 1))


def encode(p, f):
    return [T._encode(p, fcfg, f, T._run_layers_train)]


check("frontend_proj", tp, [frames, fp, fln], [WHOLE3, flay, ((),)],
      lambda f, w, g: encode({"frontend_proj": S.Shard(w, flay, fp.shape),
                              "encoder": {"layers": [], "final_ln": g}}, f),
      lambda f, w, g: encode({"frontend_proj": w, "encoder": {"layers": [], "final_ln": g}},
                             f), [WHOLE3])

# the VLM's _inputs: 3 image embeddings through frontend_proj before 6
# tokens' vocab-parallel embedding rows
vcfg = types.SimpleNamespace(d_model=d, padded_vocab=384, compute_dtype="float64",
                             prefix_embeds=3, encoder_decoder=False)
tok = torch.from_numpy(np.random.default_rng(next(seed)).integers(0, 250, (2, 6)))
img, emb = rnd(2, 3, d), rnd(384, d)
elay = (M1, ())


def vlm(p, t, i):
    return [T._inputs(p, vcfg, t, None, i, T._run_layers_train)[0]]


check("vlm_inputs", tp, [tok, img, emb, fp], [((), ()), WHOLE3, elay, flay],
      lambda t, i, e, w: vlm({"embed": S.Shard(e, elay, emb.shape),
                              "frontend_proj": S.Shard(w, flay, fp.shape)}, t, i),
      lambda t, i, e, w: vlm({"embed": e, "frontend_proj": w}, t, i), [WHOLE3])

from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamW
from repro_torch.roofline import hlo_cost
from repro_torch.train import step as TS

# loss_fn with remat differentiated on another thread (the card's device
# thread: the backward and the layers' recompute) against the same
# forward differentiated on this one, bit for bit: the dense family on
# (1, n), the hybrid on the data x model mesh, both tensor-parallel
opt = AdamW(lr=1e-3, weight_decay=0.0)
for arch, mesh in (("llama3.2-1b", tp), ("hymba-1.5b", dp)):
    cfg = dataclasses.replace(configs.get(arch).reduced(), remat=True)
    state = TS.init_sharded_state(cfg, opt, torch.Generator().manual_seed(7), mesh,
                                  device="cpu")
    ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=3))
    batch = {k: torch.as_tensor(v) for k, v in ds.batch_at(0).items()}
    if mesh is dp:                                 # this rank's rows of the batch
        b = 4 // mesh.size(0)
        batch = {k: v[mesh.get_coordinate()[0] * b:][:b] for k, v in batch.items()}
    split = tuple(i for i in range(2) if mesh is dp and i == 0)
    got = []
    for threaded in (False, True):
        plist = pytree.leaves(state["params"])
        xs = [p.to_local().detach().requires_grad_() for p in plist]
        tree = pytree.unflatten(state["params"], [S.Shard(x, S.layout_of(p), p.shape)
                                                  for x, p in zip(xs, plist)])
        with S.use_rules(mesh), S.split_batch([mesh.get_group(i) for i in split],
                                                     S.mesh_size(split), split):
            loss = T.loss_fn(tree, cfg, batch)
        grad = lambda: torch.autograd.grad(loss, xs)  # noqa: E731
        got.append(on_another_thread(grad) if threaded else grad())
    out["thread/" + arch] = np.array(max(float((a - b).abs().max())
                                         for a, b in zip(*got)))
    out["thread/" + arch + "/loss"] = np.array(float(loss))

if n == 4:
    # the tensor-parallel step's collectives on (1, 4), one step of B 4 x S
    # 32 of the reduced llama3.2-1b and mamba2-1.3b, and the shapes of the
    # 'model'-split parameters sharding.weight gathers whole over 'model'
    weight = S.weight
    whole = []

    def spy(w, keep=()):
        t, lay = weight(w, keep)
        if any(1 in dims for dims in S.layout_of(w)) and not any(1 in dims for dims in lay):
            whole.append(tuple(w.shape))
        return t, lay

    S.weight = spy
    for arch in ("llama3.2-1b", "mamba2-1.3b"):
        cfg = configs.get(arch).reduced()
        state = TS.init_sharded_state(cfg, opt, torch.Generator().manual_seed(7), tp,
                                      device="cpu")
        ds = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=3))
        batch = {k: torch.as_tensor(v) for k, v in ds.batch_at(0).items()}
        fn = TS.make_train_step(cfg, opt, mesh=tp)
        whole.clear()
        with hlo_cost.OpCounter(tp) as c:
            state, m = fn(state, batch)
        split = sum(p.numel() * p.element_size() for p in pytree.leaves(state["params"])
                    if any(1 in dims for dims in S.layout_of(p)))
        by = c.coll_by_axis.get("model", {})
        out[f"step/{arch}/model_gather"] = np.array(by.get("all-gather", 0))
        out[f"step/{arch}/model_coll"] = np.array(sum(by.values()))
        out[f"step/{arch}/split_param_bytes"] = np.array(split)
        out[f"step/{arch}/gathered_whole"] = np.array(sorted(set(whole)) or np.empty((0, 2)))
        out[f"step/{arch}/loss"] = np.array(float(m["loss"]))
    S.weight = weight
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{ranks: [each rank's outputs]} for the groups of four and three."""
    tmp = tmp_path_factory.mktemp("tp_train")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs, dests = [], {}
    for n in (4, 3):
        dests[n] = [tmp / f"n{n}_rank{r}.npz" for r in range(n)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(n), str(tmp / f"store{n}"),
             str(dests[n][r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(n)]
    logs = []
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log in logs:
        assert "WORKER-OK" in log, log[-3000:]
    return {n: [dict(np.load(f)) for f in files] for n, files in dests.items()}


@pytest.mark.parametrize("ranks", [4, 3])
@pytest.mark.parametrize("case", CASES)
def test_collective_and_layer_gradients_match_the_unsharded_ones(runs, case, ranks):
    """Every rank's output shard and input gradients equal the unsharded
    function's (``torch.autograd`` on one process) within 1e-12 in
    float64; the gradients are not all zero."""
    for r, rk in enumerate(runs[ranks]):
        assert float(rk[case + "/fwd"]) <= TOL, (case, r, float(rk[case + "/fwd"]))
        assert float(rk[case + "/grad"]) <= TOL, (case, r, float(rk[case + "/grad"]))
        assert float(rk[case + "/scale"]) > 0.1
    # the shards cover the whole: some rank holds a nonempty gradient
    assert any(rk[case + "/shapes"].sum() > 0 for rk in runs[ranks])


@pytest.mark.parametrize("ranks", [4, 3])
def test_ssm_norm_cases_take_both_branches(runs, ranks):
    """``ssm_norm_split`` sums the squares of each rank's heads' columns
    (``out``'s rows are the heads'); ``ssm_norm_gathered`` gathers y
    whole first (they are not)."""
    for rk in runs[ranks]:
        assert bool(rk["ssm_norm_split/split"])
        assert not bool(rk["ssm_norm_gathered/split"])


def test_vocab_parallel_loss_counts_every_label(runs):
    for ranks in (4, 3):
        counts = {int(rk["chunked_ce_loss/count"]) for rk in runs[ranks]}
        assert counts == {34}


@pytest.mark.parametrize("ranks", [4, 3])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_backward_on_another_thread_runs_under_the_forward_rules(runs, arch, ranks):
    """On the card autograd runs the backward and the remat recompute on a
    device thread, which holds no rules context: the gradients computed
    there are the calling thread's, bit for bit."""
    for rk in runs[ranks]:
        assert float(rk["thread/" + arch]) == 0.0
        assert np.isfinite(float(rk["thread/" + arch + "/loss"]))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_tensor_parallel_step_gathers_no_model_split_parameter_whole(runs, arch):
    """On (1, 4) the step's 'model'-axis all-gathers (K/V's whole heads;
    the SSM's ``in`` activation) carry less than one whole copy of the
    parameters split over 'model', and ``sharding.weight`` gathers none of
    them whole over 'model' but mamba2's ``conv`` (W x CC)."""
    from repro_torch import configs

    cfg = configs.get(arch).reduced()
    want = {(cfg.ssm_conv_width, cfg.ssm_d_inner + 2 * cfg.ssm_state)} if cfg.ssm_state else set()
    for rk in runs[4]:
        split = int(rk[f"step/{arch}/split_param_bytes"])
        assert split > 0 and np.isfinite(float(rk[f"step/{arch}/loss"]))
        gathered = int(rk[f"step/{arch}/model_gather"])
        assert gathered < split, (gathered, split)
        assert int(rk[f"step/{arch}/model_coll"]) > 0
        assert {tuple(int(v) for v in s) for s in rk[f"step/{arch}/gathered_whole"]} == want
