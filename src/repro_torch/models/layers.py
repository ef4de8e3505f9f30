"""Model layers, in PyTorch.

Counterpart of ``repro/models/layers.py``: the parameters are read as
``p["name"]`` like the JAX package's pytrees, in its layout (``x @ w``), and
each function computes what its namesake there computes.  The attention goes
through the flash-attention kernel (``kernels/flash_attention.py``) on a CUDA
tensor and through its plain version on a CPU tensor.  The MoE layer
(:func:`moe_ffn`) and the Mamba2 layers (:func:`mamba2`,
:func:`mamba2_decode`) are torch ops: the reference computes them with
``jnp`` outside any Pallas kernel (its SSD chunk is a ``lax.scan`` body,
here a Python loop over chunks).

Under a sharding-rules context (``models/sharding.use_rules``, the
parameters ``DTensor``s or the training step's ``sharding.Shard``s) the
attention, the SwiGLU MLP and the MoE layer compute tensor-parallel on each
rank's local shards, in serving and in training alike: a column-parallel
projection keeps its output split as the weight's columns are, a
row-parallel one all-reduces its partial sums, and the activations are
gathered or sliced at the points where the reference places its
``shard_activation`` hints (q over ``act_heads``, the MLP's hidden over
``act_ff``, the MoE's dispatch over ``act_expert`` and ``act_moe_batch``).
Each rank runs its own query heads, hidden columns and experts.  Every
split is read from the parameters' placements.  Under autograd the
collectives carry Megatron's convention (``models/sharding.py``): a whole
activation enters split work through ``sharding.enter``, whose backward
sums the ranks' partial cotangents, and a row-parallel exit passes the
cotangent through.  On plain tensors (outside a rules context) every one
of those helpers is the identity, so the same functions compute what they
always did.  The Mamba2 layers run head-parallel over ``act_heads``
(:func:`mamba2`), and whisper's cross-attention K/V come whole over
``wk``/``wv``'s split (:func:`cross_kv`), in serving and in training
alike.

Precision on the card: :func:`exact_matmuls` turns off TF32 and bf16
reduced-precision reductions for the ``dense`` products while a forward
pass, a prefill or a decode step runs, and restores the flags after.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import sharding as S


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in full float32 (no TF32), bf16 products reduced in
    float32 -- as XLA computes the reference's einsums -- inside the block
    (or the decorated function); the flags are restored after."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype a layer's float32 parts run in for inputs of ``dt``:
    float32, or float64 inputs' own (the gradient checks run in float64)."""
    return torch.promote_types(dt, torch.float32)


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    scale = S.to_local(scale)              # a replicated DTensor under a mesh
    x = x.to(acc_dtype(dt))
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(x.dtype)).to(dt)


def dense(x, w):
    """Matmul in the activation dtype with float32 accumulation."""
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs           # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Online-softmax attention, q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd)
    with Hq % Hkv == 0; window > 0 => sliding-window; q_offset: the key
    index of q[:, 0] (the reference's "absolute position of q[:, 0]").  The
    kernel on a CUDA tensor, the plain version (in the reference's 512 x
    1024 chunks) on a CPU tensor.  Returns (B, Sq, Hq, hd) in q.dtype."""
    return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def entry(x):
    """``sharding.enter`` of ``x`` for each set of mesh dims it is asked
    for, made once a set: branches split over the same dims (q, k and v)
    share one all-reduce of their cotangent."""
    made = {}

    def over(dims):
        key = S.members(dims)
        if key not in made:
            made[key] = S.enter(x, key)
        return made[key]

    return over


def column_whole(x, w, size: int):
    """x @ w for a column-parallel ``w``: the local columns, gathered whole
    (``size`` of them) over the mesh dims ``w``'s columns are split on.
    ``x`` is a tensor or an :func:`entry` of one."""
    wl, lay = S.weight(w, keep=(1,))
    xin = x(lay[1]) if callable(x) else S.enter(x, lay[1])
    return S.gather(dense(xin, wl), -1, lay[1], size)


def row_parallel(h, w):
    """h @ w for a row-parallel ``w`` (K, N), ``h`` whole along K: this
    rank's rows of ``h`` times its rows of ``w``, the partial sums
    all-reduced over the mesh dims the rows are split on."""
    wl, lay = S.weight(w, keep=(0,))
    return S.all_reduce(dense(S.take(h, -1, lay[0]), wl), lay[0])


def kv_for_heads(k, h0: int, h1: int, g: int, dims=()):
    """The kv heads query heads [h0, h1) read (head h reads kv head h // g):
    all of ``k`` for all the heads, a slice where the range holds whole
    groups, else one kv head a query head.  ``k`` is whole and the query
    heads split over mesh ``dims``: each rank reads only its heads' kv
    heads, so the cotangent of ``k`` is all-reduced over ``dims``."""
    k = S.enter(k, dims)
    if h0 == 0 and h1 == k.shape[2] * g:
        return k
    if h0 % g == 0 and h1 % g == 0:
        return k[:, :, h0 // g:h1 // g]
    idx = torch.arange(h0, h1, device=k.device) // g
    return k.index_select(2, idx)


def attention(p, x, cfg, *, positions=None, causal: bool = True, kv_override=None):
    """p: {'wq','wk','wv','wo'}; x: (B,S,D).

    kv_override: (k, v) already projected (whisper's cross-attention, from
    :func:`cross_kv`); they get no rotary embedding, and q gets one only
    where ``positions`` is given.  Returns (B,S,D) and the (k, v) tensors
    for cache construction.

    Under a mesh (module docstring) q goes over the query heads of
    ``act_heads``; K and V are gathered whole over the mesh dims ``wk``/``wv``
    split them on (the cache takes them whole), and the flash kernel runs on
    the local heads with their kv heads; ``wo`` is row-parallel, so the
    output is all-reduced.  With the sequence split over ``act_seq``
    (``sharding.seq_split``, the long-context prefill) ``x`` holds this
    rank's positions [lo, hi) and the rotary embedding takes them.  Causal:
    the K/V of the ``window - 1`` positions before lo (every earlier one
    under full attention) come from the preceding ranks (``sharding.halo``),
    and the kernel runs once on [halo | own] with ``q_offset`` = the halo's
    length.  Non-causal (whisper's encoder): every position's K/V, gathered
    whole over ``act_seq`` (``sharding.gather``), and the kernel runs once
    on them.  The K/V returned are the rank's own.  With
    ``kv_override`` (the cross-attention) the K/V are whole already."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    heads = S.mesh_dims("act_heads")
    xin = entry(x)
    wq, lq = S.weight(p["wq"], keep=(1,))
    q = dense(xin(lq[1]), wq)
    h0, h1 = S.chunk_range(hq, heads)
    if lq[1] == heads and hq % S.mesh_size(heads) == 0:
        q = q.reshape(b, s, h1 - h0, hd)          # the columns hold this rank's heads
    else:
        q = S.take(S.gather(q, -1, lq[1], hq * hd).reshape(b, s, hq, hd), 2, heads)
    split = S.seq_split() if kv_override is None else None
    window = cfg.sliding_window if causal else 0
    if kv_override is None:
        k = column_whole(xin, p["wk"], hkv * hd).reshape(b, s, hkv, hd)
        v = column_whole(xin, p["wv"], hkv * hd).reshape(b, s, hkv, hd)
        if positions is None:
            lo = 0 if split is None else split[1]
            positions = torch.arange(lo, lo + s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
    kx, vx, q_offset = k, v, 0
    if split is not None and causal:
        near = S.halo(torch.stack([k, v]), 2, window - 1 if window else None)
        q_offset = near.shape[2]
        kx, vx = torch.cat([near[0], k], dim=1), torch.cat([near[1], v], dim=1)
    elif split is not None:
        kx, vx = S.gather(torch.stack([k, v]), 2, split[:1], split[3]).unbind(0)
    g = hq // hkv
    kh, vh = kv_for_heads(kx, h0, h1, g, heads), kv_for_heads(vx, h0, h1, g, heads)
    if h1 > h0:
        o = flash_attention(q, kh, vh, causal=causal, window=window, q_offset=q_offset)
    else:
        o = S.tie(q, kh, vh)                       # no head on this rank
    wo, lo = S.weight(p["wo"], keep=(0,))
    o = o.reshape(b, s, (h1 - h0) * hd)
    if S.chunk_range(hq * hd, lo[0]) != (h0 * hd, h1 * hd):
        o = S.take(S.gather(o.reshape(b, s, h1 - h0, hd), 2, heads, hq).reshape(b, s, hq * hd),
                   -1, lo[0])
    return S.all_reduce(dense(o, wo), lo[0]), (k, v)


def cross_kv(p, enc_out, cfg):
    """Project the encoder output (B,T,D) to the (k, v) of cross-attention,
    each (B,T,Hkv,hd).  Under a mesh ``wk``/``wv`` are column-parallel and
    the K/V come whole over their split, as :func:`attention`'s do."""
    b, s, _ = enc_out.shape
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    xin = entry(enc_out)
    k = column_whole(xin, p["wk"], hkv * hd).reshape(b, s, hkv, hd)
    v = column_whole(xin, p["wv"], hkv * hd).reshape(b, s, hkv, hd)
    return k, v


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def swiglu_mlp(p, x):
    """p: {'wi': (D, 2F), 'wo': (F, D)} -- fused gate+up projection.  Under a
    mesh ``wi`` is column-parallel, the hidden goes over ``wo``'s row split
    (``act_ff``) and ``wo`` is row-parallel, with an all-reduce after it."""
    wi, li = S.weight(p["wi"], keep=(1,))
    wo, lo = S.weight(p["wo"], keep=(0,))
    gate, up = gate_up(dense(S.enter(x, li[1]), wi), li[1], p["wo"].shape[0], lo[0])
    return S.all_reduce(dense(_silu_gate(gate, up), wo), lo[0])


def gate_up(gu, src, f: int, dst):
    """The fused [gate | up] columns (..., 2F) split over mesh dims ``src``
    -> (gate, up), each F split over ``dst``.  A contiguous split of 2F
    gives a rank gate columns, up columns or parts of each, not matching
    halves, so the activations are resharded (the weights keep the
    reference's layout): over one mesh dim of n members with F % n == 0,
    rank r's two F/n-column pieces go to the ranks whose gate or up chunk
    they are (one all-to-all, 2F/n columns a rank, whose backward is the
    inverse exchange); otherwise the columns are gathered whole and each
    half sliced."""
    src, dst = S.members(src), S.members(dst)
    if not src and not dst:
        return torch.chunk(gu, 2, dim=-1)
    if src == dst and len(src) == 1 and f % S.mesh_size(src) == 0:
        n = S.mesh_size(src)
        c = f // n
        # my flat pieces are 2r and 2r + 1 (units of c); piece j is gate chunk
        # j (j < n) or up chunk j - n, and goes to that chunk's rank.  The
        # all-to-all sends in rank order, so where piece 2r + 1 goes to a
        # lower rank than piece 2r (2r + 1 = n, n odd) the two swap places.
        # Rank t receives its gate chunk from rank t // 2 before its up
        # chunk from the higher rank (n + t) // 2.
        r = S.coordinate(src[0])
        to = [0] * n
        for j in (2 * r, 2 * r + 1):
            to[j % n] += c
        frm = [c * ((t == r // 2) + (t == (n + r) // 2)) for t in range(n)]
        x = gu.movedim(-1, 0)
        if (2 * r + 1) % n < (2 * r) % n:
            x = torch.cat([x[c:], x[:c]])
        out = S.all_to_all(x, to, frm, src[0])
        return torch.chunk(out.movedim(0, -1), 2, dim=-1)
    gate, up = torch.chunk(S.gather(gu, -1, src, 2 * f), 2, dim=-1)
    return S.take(gate, -1, dst), S.take(up, -1, dst)


def _silu_gate(gate, up):
    """silu(gate) in float32 (float64 inputs in their own dtype), back in
    the activation dtype, times up."""
    return torch.nn.functional.silu(gate.to(acc_dtype(gate.dtype))).to(up.dtype) * up


def moe_route(x, router, cfg):
    """The router of :func:`moe_ffn`.  x: (B,S,D).  Returns (probs (B,S,E),
    idx (B,S,K) the top-k experts of each token, gate_full (B,S,E) its
    renormalized gates, routed (B,S,E), src (B,E,C) each expert's token ids
    in FIFO order, valid (B,E,C)); ``src`` is 0 where not ``valid``."""
    w, lay = S.weight(router, keep=(1,))
    logits = S.gather(dense(S.enter(x, lay[1]), w), -1, lay[1],
                      cfg.n_experts)                            # column-parallel over E
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    _gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return dispatch(probs, idx, cfg)


def dispatch(probs, idx, cfg):
    """:func:`moe_route` after the top-k: the gates of the experts ``idx``
    chooses (``probs`` at ``idx``, as top-k returns them), renormalized, and
    each expert's FIFO capacity (GShard drop).

    With the sequence split over ``act_seq`` (``sharding.seq_split``, the
    long-context prefill) ``probs`` holds this rank's positions [lo, hi) of
    the sequence, and the capacity is the whole sequence's, as the
    reference's (its priority the global position): ``cap`` counts the
    whole sequence, the tokens each expert took on the earlier ranks come
    from a prefix sum of the ranks' counts (``sharding.seq_prefix_sum``),
    and a routed token is kept while its order within its expert over the
    whole sequence is below ``cap``.  An expert filled on an earlier rank
    drops this rank's tokens.  ``src`` then holds min(cap, hi - lo) slots
    an expert, in this rank's positions."""
    s = probs.shape[1]
    split = S.seq_split()
    total = s if split is None else split[3]
    e_, k_ = cfg.n_experts, cfg.top_k
    cap = min(total, max(8, int(total * k_ / e_ * cfg.capacity_factor)))
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(idx, e_).to(torch.float32)    # (B,S,K,E)
    routed = onehot.sum(2) > 0
    gate_full = (onehot * gate[..., None]).sum(2)
    # FIFO top-C token ids per expert (earliest-token priority): valid slots
    # have distinct scores, so the order of equals never matters
    spos = torch.arange(s, dtype=torch.float32, device=probs.device)[None, :, None]
    score = torch.where(routed, -spos, -1e9)
    top_sc, src = torch.topk(score.transpose(1, 2), min(cap, s), dim=-1)   # (B,E,C)
    valid = top_sc > -5e8
    if split is not None:
        before = S.seq_prefix_sum(routed.sum(1))                       # (B,E)
        order = torch.arange(src.shape[-1], device=probs.device)
        valid &= order < (cap - before)[..., None]
    src = torch.where(valid, src, 0)
    return probs, idx, gate_full, routed, src, valid


def moe_ffn(p, x, cfg):
    """Top-k MoE with per-expert FIFO capacity, scatter-free as the
    reference's: per-expert top-C over token positions, a batched gather,
    the two expert products on copies of ``wi``/``wo`` in the activation
    dtype (made on every call, as the reference casts), the gated
    scatter-add, the shared experts, the Switch aux loss.

    Under a mesh the router's columns (E) are gathered, so each rank routes
    its tokens whole: the top-k and the FIFO capacity are the unsharded
    layer's, row by row.  A rank runs the experts its ``wi``/``wo`` shards
    hold (E over ``act_expert``'s dims, each expert's F over ``wo``'s
    split) on the tokens of ``act_moe_batch`` (less the experts' and F's
    mesh dims, over which each token must meet every expert); the partial
    ``y`` is all-reduced over the expert and F dims, and each rank keeps
    its ``act_batch`` rows.  The balance loss is then over the rank's
    tokens (serving drops it).  With the sequence split over ``act_seq``
    (the long-context prefill) a rank routes its positions against the
    whole sequence's capacity (:func:`dispatch`), ``act_moe_batch`` never
    splits the batch again over ``act_seq``'s mesh dims (the rank holds
    every row of its positions; a decode step's batch stays whole there
    too), and the balance loss is over the rank's positions (serving drops
    it).

    p: {'router': (D,E), 'wi': (E,D,2Fe), 'wo': (E,Fe,D) [, 'shared_wi',
    'shared_wo']}; x: (B,S,D).  Returns (out (B,S,D), aux_loss)."""
    bl, s, d = x.shape
    wi, lwi = S.weight(p["wi"], keep=(0, 2))
    wo, lwo = S.weight(p["wo"], keep=(0, 1))
    e_dims, f_in, f_out = lwi[0], lwi[2], lwo[1]
    if lwo[0] != e_dims:                          # the experts where wi holds them
        wo = S.reshard(wo, lwo, (e_dims, f_out, ()), p["wo"].shape)
    b_all = bl * S.mesh_size(S.mesh_dims("act_batch"))
    held = e_dims + f_in + f_out + S.mesh_dims("act_seq")
    t_dims = tuple(i for i in S.mesh_dims("act_moe_batch") if i not in held)
    xt = S.shard_activation(x, (t_dims, None, None), src=("act_batch", None, None),
                            shape=(b_all, s, d))
    b = xt.shape[0]
    probs, _idx, gate_full, routed, src, valid = moe_route(xt, p["router"], cfg)
    cap = src.shape[-1]
    e0, e1 = S.chunk_range(cfg.n_experts, e_dims)
    # expert-major (E, B*C, ...) so each expert's rows are one bmm operand
    src_e, valid_e = src.transpose(0, 1)[e0:e1], valid.transpose(0, 1)[e0:e1]   # (E,B,C)
    bidx = torch.arange(b, device=x.device)[None, :, None]
    # a rank's experts (and F columns) give partial cotangents of xt and of
    # the gates: they enter the split work through sharding.enter
    xe = S.enter(xt, tuple(sorted(set(e_dims + f_in))))
    xin = xe[bidx, src_e] * valid_e[..., None].to(x.dtype)          # (E,B,C,D) gather
    gu = torch.bmm(xin.reshape(e1 - e0, b * cap, d), wi.to(x.dtype))
    del xin
    h = _silu_gate(*gate_up(gu, f_in, p["wo"].shape[1], f_out))
    del gu
    xout = torch.bmm(h, wo.to(x.dtype))                             # (E,B*C,D)
    del h
    # per-slot gate weight: gate_full[b, src[b,e,c], e]
    gate_e = S.enter(gate_full, tuple(sorted(set(e_dims + f_out))))
    gate_slot = torch.gather(gate_e.transpose(1, 2), 2, src)         # (B,E,C)
    w_slot = (gate_slot * valid).to(x.dtype).transpose(0, 1)[e0:e1].reshape(e1 - e0, b * cap, 1)
    upd = xout * w_slot
    del xout
    flat = (src_e + bidx * s).reshape(-1)                            # rows of (B*S, D)
    y = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, flat, upd.reshape(-1, d))
    y = S.all_reduce(y.reshape(b, s, d), tuple(sorted(set(e_dims + f_out))))
    y = S.shard_activation(y, ("act_batch", None, None), src=(t_dims, None, None),
                           shape=(b_all, s, d))
    if "shared_wi" in p:
        y = y + swiglu_mlp({"wi": p["shared_wi"], "wo": p["shared_wo"]}, x)
    # Switch-style load-balance aux loss, over the whole batch where a
    # sharded step splits it
    me = S.batch_mean(probs, (0, 1))
    ce = S.batch_mean(routed.to(torch.float32), (0, 1))
    return y, cfg.n_experts * torch.sum(me * ce)


# ---------------------------------------------------------------------------
# Mamba2 (SSD -- state-space duality), chunked scan + O(1) decode
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _ssm_dims(cfg):
    return cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_conv(u, w, history=None):
    """Depthwise causal conv1d.  u: (B,S,C); w: (W,C).  The W taps are
    added in order, in u's dtype.  ``history`` (B, W-1, C): the inputs
    before u[:, 0] (zeros where None, the sequence's start)."""
    width, s = w.shape[0], u.shape[1]
    if history is None:
        u_pad = torch.nn.functional.pad(u, (0, 0, width - 1, 0))
    else:
        u_pad = torch.cat([history, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(width):
        out = out + u_pad[:, i:i + s, :] * w[i][None, None, :]
    return out


def _ssd_chunk(state, xk, bk, ck, dtk, cumk, out_dtype):
    """One chunk of the SSD scan (the reference's ``lax.scan`` body).
    state: (B,H,N,hp) float32 (float64 for float64 inputs, :func:`acc_dtype`);
    xk (B,Q,H,hp); bk, ck (B,Q,N); dtk, cumk (B,Q,H) in state's dtype.
    Returns (new_state, y (B,Q,H,hp) in out_dtype)."""
    f32 = state.dtype
    q = xk.shape[1]
    xk = xk.to(f32)
    # intra-chunk (quadratic within the chunk)
    seg = cumk[:, :, None, :] - cumk[:, None, :, :]                   # (B,Q,Q,H)
    iq = torch.arange(q, device=xk.device)
    causal = iq[:, None] >= iq[None, :]
    # mask BEFORE exp: the upper triangle of seg is positive (cum is
    # decreasing), and exp would overflow there
    l_ = torch.exp(torch.where(causal[None, :, :, None], seg, NEG_INF))
    cb = torch.einsum("bqn,bkn->bqk", ck.to(f32), bk.to(f32))
    w_ = cb[..., None] * l_ * dtk[:, None, :, :]                       # (B,Q,K,H)
    y_intra = torch.einsum("bqkh,bkhp->bqhp", w_, xk)
    # inter-chunk (contribution of the carried state)
    y_inter = torch.einsum("bqn,bhnp->bqhp", ck.to(f32), state) * torch.exp(cumk)[..., None]
    # state update
    total = cumk[:, -1, :]                                             # (B,H)
    decay_rest = torch.exp(total[:, None, :] - cumk)                   # (B,Q,H)
    upd = torch.einsum("bkn,bkhp->bhnp", bk.to(f32), (dtk * decay_rest)[..., None] * xk)
    new_state = torch.exp(total)[:, :, None, None] * state + upd
    return new_state, (y_intra + y_inter).to(out_dtype)


def _ssm_heads(cfg) -> tuple:
    """(mesh dims, h0, h1): the SSM heads [h0, h1) this rank runs, split
    over ``act_heads``'s mesh dims in chunks of ceil(H / n) as the
    attention's query heads are (a rank may hold fewer, or none); all of
    them outside a rules context."""
    heads = S.mesh_dims("act_heads")
    return (heads,) + S.chunk_range(cfg.ssm_n_heads, heads)


def _head_channels(t, cfg, h0: int, h1: int):
    """The channels of ``t`` (last dim, CC = di + 2N: x, then B and C) that
    heads [h0, h1) read: their x channels, then B and C, which every head
    reads (G = 1).  ``t`` itself for all the heads."""
    di, h, _, hp = _ssm_dims(cfg)
    if (h0, h1) == (0, h):
        return t
    return torch.cat([t[..., h0 * hp:h1 * hp], t[..., di:]], dim=-1)


def _head_vector(v, heads, h0: int, h1: int):
    """Heads [h0, h1) of a per-head vector held whole (``dt_bias``,
    ``A_log``, ``D``; a replicated ``DTensor`` under a mesh).  The heads
    are split work, so the whole vector enters it (``sharding.enter``)."""
    return S.enter(S.to_local(v), heads)[h0:h1]


def _ssm_norm_out(p, y, cfg, heads, h0: int, h1: int):
    """The gated norm over the whole d_inner, then ``out``.  ``y`` (..., (h1
    - h0) * hp) holds heads [h0, h1)'s columns.  Where ``out``'s row split
    is the heads' (mamba2-1.3b on a 16-way axis: 256 rows, 4 heads of 64; or
    both whole), the norm's float32 sum of squares is all-reduced over the
    heads' mesh dims and each rank multiplies its own rows; else (hymba-1.5b:
    200 rows a rank against 64-wide heads, 50 heads over 16 ranks; or
    ``out`` whole where di does not divide) ``y`` is gathered whole over the
    heads, normed, and each rank takes its rows.  ``out`` is row-parallel."""
    di, h, _, hp = _ssm_dims(cfg)
    wo, lo = S.weight(p["out"], keep=(0,))
    if S.chunk_range(di, lo[0]) == (h0 * hp, h1 * hp):
        y = _split_rms_norm(y, p["norm"], cfg.norm_eps, heads, h0 * hp, h1 * hp, di)
    else:
        lead = y.shape[:-1]
        y = S.gather(y.reshape(*lead, h1 - h0, hp), -2, heads, h).reshape(*lead, di)
        y = S.take(rms_norm(y, p["norm"], cfg.norm_eps), -1, lo[0])
    return S.all_reduce(dense(y, wo), lo[0])


def _split_rms_norm(x, scale, eps: float, dims, lo: int, hi: int, size: int):
    """:func:`rms_norm` over a last dim of ``size`` of which ``x`` holds
    columns [lo, hi), split over mesh ``dims``: each rank's float32 sum of
    squares all-reduced over them (so the sum runs in another order than
    one sum over the whole dim).  :func:`rms_norm` itself where ``dims``
    has no member."""
    if not S.members(dims):
        return rms_norm(x, scale, eps)
    dt = x.dtype
    x = x.to(acc_dtype(dt))
    ss = S.enter(S.all_reduce((x * x).sum(-1, keepdim=True), dims), dims)
    x = x * torch.rsqrt(ss / size + eps)
    return (x * S.enter(S.to_local(scale), dims)[lo:hi].to(x.dtype)).to(dt)


def mamba2(p, x, cfg, *, init_state=None, return_state: bool = False):
    """Chunked SSD forward.  x: (B,S,D) -> (B,S,D).

    p: {'in': (D,Z), 'conv': (W,CC), 'dt_bias': (H,), 'A_log': (H,),
        'D': (H,), 'norm': (di,), 'out': (di,D)}
    with Z = 2*di + 2*N + H and CC = di + 2*N (the x, B, C channels are
    conv'd).  With return_state=True also returns (final_state, conv_tail)
    for decode.

    Under a mesh the heads are split over ``act_heads`` (:func:`_ssm_heads`):
    ``in``'s column-parallel product comes whole over its split (its Z
    columns, cut contiguously, do not fall on the z | xBC | dt boundaries
    nor on heads), each rank convolves its heads' x channels and the shared
    B and C with ``conv`` gathered whole (W x CC, tiny), scans its heads and
    ends in :func:`_ssm_norm_out`.  The final state is this rank's heads';
    the conv tail is whole.  Under autograd each rank reads only its heads'
    share of the whole activation, of ``conv`` and of the per-head vectors,
    so each enters the split work through ``sharding.enter``: their
    cotangents are summed over the heads' ranks before ``in``'s gather and
    ``conv``'s ``weight`` take back this rank's columns (a rank with no
    head still joins those sums, through zero-sized tensors).

    With the sequence split over ``act_seq`` (``sharding.seq_split``, the
    long-context prefill; no ``init_state``) ``x`` holds this rank's
    positions: the conv takes the previous ranks' last W-1 pre-conv xBC
    rows (``sharding.halo``; zeros before the sequence's start), the rank
    scans its positions from a zero state, the ranks exchange their final
    states S_j and total decays D_j = exp(sum dt * A) over ``act_seq``, and
    each adds to its outputs, in float32 before their rounding, the carried
    state's term C_t . S_in exp(cum_t), S_in = sum_{j<r} S_j prod_{j<i<r}
    D_i (``_ssd_chunk``'s y_inter over the rank).  The final state (every
    rank forms it from the exchange) and the conv tail (the last rank's)
    are the whole sequence's on every rank."""
    b, s, _ = x.shape
    di, h, n, hp = _ssm_dims(cfg)
    heads, h0, h1 = _ssm_heads(cfg)
    hl = h1 - h0
    q = min(cfg.ssm_chunk, s)
    if s % q:
        # the largest divisor (only odd test lengths reach this)
        q = next(d for d in range(q, 0, -1) if s % d == 0)
    nc = s // q
    f32 = acc_dtype(x.dtype)

    split = S.seq_split()
    if split is not None and init_state is not None:
        raise ValueError("mamba2: a sequence split over act_seq starts from a zero state")
    zxbcdt = S.enter(column_whole(x, p["in"], ssm_in_features(cfg)), heads)
    z = zxbcdt[..., h0 * hp:h1 * hp]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n + h0:2 * di + 2 * n + h1]
    hist = None
    if split is None:
        conv_tail = xbc[:, s - (cfg.ssm_conv_width - 1):, :]           # pre-conv history
    else:
        near = S.halo(xbc, 1, cfg.ssm_conv_width - 1)
        hist = torch.nn.functional.pad(near, (0, 0, cfg.ssm_conv_width - 1 - near.shape[1], 0))
        conv_tail = torch.cat([hist, xbc], dim=1)[:, s:]
        hist = _head_channels(hist, cfg, h0, h1)
    wc = S.enter(S.weight(p["conv"])[0], heads)
    xbc = _ssm_conv(_head_channels(xbc, cfg, h0, h1),
                    _head_channels(wc.to(x.dtype), cfg, h0, h1), hist)
    xbc = torch.nn.functional.silu(xbc.to(f32)).to(x.dtype)
    xs = xbc[..., :hl * hp].reshape(b, s, hl, hp)
    bb = xbc[..., hl * hp:hl * hp + n]                                 # (B,S,N) (G=1)
    cc = xbc[..., hl * hp + n:]
    dt = _softplus(dt.to(f32) + _head_vector(p["dt_bias"], heads, h0, h1).to(f32))
    a = -torch.exp(_head_vector(p["A_log"], heads, h0, h1).to(f32))   # (H,)
    cum = torch.cumsum((dt * a).reshape(b, nc, q, hl), dim=2)          # within-chunk

    state = torch.zeros((b, hl, n, hp), dtype=f32, device=x.device) if init_state is None \
        else init_state
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        state, y = _ssd_chunk(state, xs[:, sl], bb[:, sl], cc[:, sl], dt[:, sl], cum[:, c],
                              x.dtype if split is None else f32)
        ys.append(y)
    y = torch.cat(ys, dim=1)                                           # (B,S,H,hp)
    if split is not None:
        y, state = _carry_state(y, state, cc, dt * a, split)
        conv_tail = S.broadcast(conv_tail.contiguous(), split[0],
                                S.mesh_size(split[:1]) - 1)
    y = y + xs * _head_vector(p["D"], heads, h0, h1).to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, hl * hp)
    y = y * torch.nn.functional.silu(z.to(f32)).to(x.dtype)
    out = _ssm_norm_out(p, y, cfg, heads, h0, h1)
    if return_state:
        return out, (state, conv_tail)
    return out


def _carry_state(y, state, cc, dta, split):
    """:func:`mamba2`'s hand-off along a sequence split over mesh dim
    ``split[0]``: y (B,S,H,hp) and state (B,H,N,hp) of this rank's scan from
    a zero state, in float32 (float64 for float64 inputs); cc (B,S,N);
    dta = dt * A (B,S,H).  Returns (y corrected by the state carried in
    from the earlier ranks and rounded to cc's dtype, the whole sequence's
    final state)."""
    i = split[0]
    n, r = S.mesh_size((i,)), S.coordinate(i)
    cum = torch.cumsum(dta, dim=1)                                     # (B,S,H) over the rank
    ends = S.gather(state[None], 0, (i,), n)                          # (n,B,H,N,hp)
    decays = S.gather(torch.exp(cum[:, -1])[None], 0, (i,), n)        # (n,B,H)
    carried = torch.zeros_like(state)
    for j in range(n):
        if j == r:
            s_in = carried
        carried = decays[j][:, :, None, None] * carried + ends[j]
    y = y + torch.einsum("bqn,bhnp->bqhp", cc.to(y.dtype), s_in) * torch.exp(cum)[..., None]
    return y.to(cc.dtype), carried


def mamba2_decode(p, x1, state, conv_state, cfg):
    """Single-token SSD step.  x1: (B,1,D); state: (B,H,N,hp) float32;
    conv_state: (B, W-1, CC).  Returns (out (B,1,D), state, conv_state), new
    tensors.

    Under a mesh (:func:`mamba2`) ``state`` holds this rank's heads and
    ``conv_state`` the channels of ``conv``'s column split (the serving
    cache's layout): each rank convolves those channels with its own
    columns of ``conv``, and the convolved channels are gathered whole, so
    neither the cache nor a weight moves."""
    b = x1.shape[0]
    di, h, n, hp = _ssm_dims(cfg)
    heads, h0, h1 = _ssm_heads(cfg)
    hl = h1 - h0
    f32 = torch.float32
    wc, lc = S.weight(p["conv"], keep=(1,))
    channels = ssm_conv_channels(cfg)
    c0, c1 = S.chunk_range(channels, lc[1])
    if state.shape[1] != hl or conv_state.shape[-1] != c1 - c0:
        raise ValueError(f"the SSM cache holds {state.shape[1]} heads and {conv_state.shape[-1]} "
                         f"conv channels; this rank runs heads [{h0}, {h1}) and conv channels "
                         f"[{c0}, {c1})")
    zxbcdt = S.enter(column_whole(x1, p["in"], ssm_in_features(cfg)), heads)[:, 0]   # (B,Z)
    z = zxbcdt[:, h0 * hp:h1 * hp]
    xbc = zxbcdt[:, di:2 * di + 2 * n]
    dt = zxbcdt[:, 2 * di + 2 * n + h0:2 * di + 2 * n + h1]
    # causal conv via the rolling state
    hist = torch.cat([conv_state, xbc[:, None, c0:c1]], dim=1)         # (B,W,CC)
    xbc = torch.einsum("bwc,wc->bc", hist, wc.to(x1.dtype))
    new_conv_state = hist[:, 1:]
    xbc = torch.nn.functional.silu(xbc.to(f32)).to(x1.dtype)
    xbc = _head_channels(S.enter(S.gather(xbc, -1, lc[1], channels), heads), cfg, h0, h1)
    xh = xbc[:, :hl * hp].reshape(b, hl, hp)
    bb = xbc[:, hl * hp:hl * hp + n]
    cc = xbc[:, hl * hp + n:]
    dt = _softplus(dt.to(f32) + _head_vector(p["dt_bias"], heads, h0, h1).to(f32))
    a = -torch.exp(_head_vector(p["A_log"], heads, h0, h1).to(f32))
    da = torch.exp(dt * a[None, :])                                    # (B,H)
    upd = bb.to(f32)[:, None, :, None] * (dt[:, :, None] * xh.to(f32))[:, :, None, :]
    state = da[:, :, None, None] * state + upd                         # (B,H,N,hp)
    y = torch.einsum("bn,bhnp->bhp", cc.to(f32), state)
    y = y.to(x1.dtype) + xh * _head_vector(p["D"], heads, h0, h1).to(x1.dtype)[None, :, None]
    y = y.reshape(b, hl * hp)
    y = y * torch.nn.functional.silu(z.to(f32)).to(x1.dtype)
    return _ssm_norm_out(p, y, cfg, heads, h0, h1)[:, None, :], state, new_conv_state


def ssm_conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_state


def ssm_in_features(cfg) -> int:
    return 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_n_heads
