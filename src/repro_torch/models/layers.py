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

Not carried here: ``shard_activation`` (``repro/models/sharding.py:66``) is
an exact no-op outside a sharding-rules context, as it is on one card, so
the calls to it are dropped (the mesh comes with the multi-card slice).

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


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


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

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Online-softmax attention, q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd)
    with Hq % Hkv == 0; window > 0 => sliding-window.  The kernel on a CUDA
    tensor, the plain version (in the reference's 512 x 1024 chunks) on a
    CPU tensor.  Returns (B, Sq, Hq, hd) in q.dtype."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def attention(p, x, cfg, *, positions=None, causal: bool = True, kv_override=None):
    """p: {'wq','wk','wv','wo'}; x: (B,S,D).

    kv_override: (k, v) already projected (whisper's cross-attention, from
    :func:`cross_kv`); they get no rotary embedding, and q gets one only
    where ``positions`` is given.  Returns (B,S,D) and the (k, v) tensors
    for cache construction."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    if kv_override is None:
        k = dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window if causal else 0)
    o = dense(o.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return o, (k, v)


def cross_kv(p, enc_out, cfg):
    """Project the encoder output (B,T,D) to the (k, v) of cross-attention,
    each (B,T,Hkv,hd)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = dense(enc_out, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(enc_out, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def swiglu_mlp(p, x):
    """p: {'wi': (D, 2F), 'wo': (F, D)} -- fused gate+up projection."""
    gate, up = torch.chunk(dense(x, p["wi"]), 2, dim=-1)
    return dense(_silu_gate(gate, up), p["wo"])


def _silu_gate(gate, up):
    """silu(gate) in float32, back in the activation dtype, times up."""
    return torch.nn.functional.silu(gate.to(torch.float32)).to(up.dtype) * up


def moe_route(x, router, cfg):
    """The router of :func:`moe_ffn`.  x: (B,S,D).  Returns (probs (B,S,E),
    idx (B,S,K) the top-k experts of each token, gate_full (B,S,E) its
    renormalized gates, routed (B,S,E), src (B,E,C) each expert's token ids
    in FIFO order, valid (B,E,C)); ``src`` is 0 where not ``valid``."""
    probs = torch.softmax(dense(x, router).to(torch.float32), dim=-1)
    _gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return dispatch(probs, idx, cfg)


def dispatch(probs, idx, cfg):
    """:func:`moe_route` after the top-k: the gates of the experts ``idx``
    chooses (``probs`` at ``idx``, as top-k returns them), renormalized, and
    each expert's FIFO capacity (GShard drop)."""
    s = probs.shape[1]
    e_, k_ = cfg.n_experts, cfg.top_k
    cap = min(s, max(8, int(s * k_ / e_ * cfg.capacity_factor)))
    gate = torch.gather(probs, -1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(idx, e_).to(torch.float32)    # (B,S,K,E)
    routed = onehot.sum(2) > 0
    gate_full = (onehot * gate[..., None]).sum(2)
    # FIFO top-C token ids per expert (earliest-token priority): valid slots
    # have distinct scores, so the order of equals never matters
    spos = torch.arange(s, dtype=torch.float32, device=probs.device)[None, :, None]
    score = torch.where(routed, -spos, -1e9)
    top_sc, src = torch.topk(score.transpose(1, 2), cap, dim=-1)      # (B,E,C)
    valid = top_sc > -5e8
    src = torch.where(valid, src, 0)
    return probs, idx, gate_full, routed, src, valid


def moe_ffn(p, x, cfg):
    """Top-k MoE with per-expert FIFO capacity, scatter-free as the
    reference's: per-expert top-C over token positions, a batched gather,
    the two expert products on copies of ``wi``/``wo`` in the activation
    dtype (made on every call, as the reference casts), the gated
    scatter-add, the shared experts, the Switch aux loss.

    p: {'router': (D,E), 'wi': (E,D,2Fe), 'wo': (E,Fe,D) [, 'shared_wi',
    'shared_wo']}; x: (B,S,D).  Returns (out (B,S,D), aux_loss)."""
    b, s, d = x.shape
    e_ = cfg.n_experts
    probs, _idx, gate_full, routed, src, valid = moe_route(x, p["router"], cfg)
    cap = src.shape[-1]
    # expert-major (E, B*C, ...) so each expert's rows are one bmm operand
    src_e, valid_e = src.transpose(0, 1), valid.transpose(0, 1)       # (E,B,C)
    bidx = torch.arange(b, device=x.device)[None, :, None]
    xin = x[bidx, src_e] * valid_e[..., None].to(x.dtype)            # (E,B,C,D) gather
    gu = torch.bmm(xin.reshape(e_, b * cap, d), p["wi"].to(x.dtype))
    del xin
    g_, u_ = torch.chunk(gu, 2, dim=-1)
    h = _silu_gate(g_, u_)
    del gu, g_, u_
    xout = torch.bmm(h, p["wo"].to(x.dtype))                         # (E,B*C,D)
    del h
    # per-slot gate weight: gate_full[b, src[b,e,c], e]
    gate_slot = torch.gather(gate_full.transpose(1, 2), 2, src)      # (B,E,C)
    w_slot = (gate_slot * valid).to(x.dtype).transpose(0, 1).reshape(e_, b * cap, 1)
    upd = xout * w_slot
    del xout
    flat = (src_e + bidx * s).reshape(-1)                            # rows of (B*S, D)
    y = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, flat, upd.reshape(-1, d))
    y = y.reshape(b, s, d)
    if "shared_wi" in p:
        y = y + swiglu_mlp({"wi": p["shared_wi"], "wo": p["shared_wo"]}, x)
    # Switch-style load-balance aux loss, over the whole batch where a
    # sharded step splits it
    me = S.batch_mean(probs, (0, 1))
    ce = S.batch_mean(routed.to(torch.float32), (0, 1))
    return y, e_ * torch.sum(me * ce)


# ---------------------------------------------------------------------------
# Mamba2 (SSD -- state-space duality), chunked scan + O(1) decode
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _ssm_dims(cfg):
    return cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_conv(u, w):
    """Depthwise causal conv1d.  u: (B,S,C); w: (W,C).  The W taps are
    added in order, in u's dtype."""
    width, s = w.shape[0], u.shape[1]
    u_pad = torch.nn.functional.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros_like(u)
    for i in range(width):
        out = out + u_pad[:, i:i + s, :] * w[i][None, None, :]
    return out


def _ssd_chunk(state, xk, bk, ck, dtk, cumk, out_dtype):
    """One chunk of the SSD scan (the reference's ``lax.scan`` body).
    state: (B,H,N,hp) float32; xk (B,Q,H,hp); bk, ck (B,Q,N); dtk, cumk
    (B,Q,H) float32.  Returns (new_state, y (B,Q,H,hp) in out_dtype)."""
    f32 = torch.float32
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


def mamba2(p, x, cfg, *, init_state=None, return_state: bool = False):
    """Chunked SSD forward.  x: (B,S,D) -> (B,S,D).

    p: {'in': (D,Z), 'conv': (W,CC), 'dt_bias': (H,), 'A_log': (H,),
        'D': (H,), 'norm': (di,), 'out': (di,D)}
    with Z = 2*di + 2*N + H and CC = di + 2*N (the x, B, C channels are
    conv'd).  With return_state=True also returns (final_state, conv_tail)
    for decode."""
    b, s, _ = x.shape
    di, h, n, hp = _ssm_dims(cfg)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        # the largest divisor (only odd test lengths reach this)
        q = next(d for d in range(q, 0, -1) if s % d == 0)
    nc = s // q
    f32 = torch.float32

    zxbcdt = dense(x, p["in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    conv_tail = xbc[:, s - (cfg.ssm_conv_width - 1):, :]               # pre-conv history
    xbc = _ssm_conv(xbc, p["conv"].to(x.dtype))
    xbc = torch.nn.functional.silu(xbc.to(f32)).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, h, hp)
    bb = xbc[..., di:di + n]                                           # (B,S,N) (G=1)
    cc = xbc[..., di + n:]
    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["A_log"].to(f32))                                 # (H,)
    cum = torch.cumsum((dt * a).reshape(b, nc, q, h), dim=2)           # within-chunk

    state = torch.zeros((b, h, n, hp), dtype=f32, device=x.device) if init_state is None \
        else init_state
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        state, y = _ssd_chunk(state, xs[:, sl], bb[:, sl], cc[:, sl], dt[:, sl], cum[:, c], x.dtype)
        ys.append(y)
    y = torch.cat(ys, dim=1)                                           # (B,S,H,hp)
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = y * torch.nn.functional.silu(z.to(f32)).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = dense(y, p["out"])
    if return_state:
        return out, (state, conv_tail)
    return out


def mamba2_decode(p, x1, state, conv_state, cfg):
    """Single-token SSD step.  x1: (B,1,D); state: (B,H,N,hp) float32;
    conv_state: (B, W-1, CC).  Returns (out (B,1,D), state, conv_state), new
    tensors."""
    b = x1.shape[0]
    di, h, n, hp = _ssm_dims(cfg)
    f32 = torch.float32
    zxbcdt = dense(x1, p["in"])[:, 0]                                 # (B,Z)
    z = zxbcdt[:, :di]
    xbc = zxbcdt[:, di:2 * di + 2 * n]
    dt = zxbcdt[:, 2 * di + 2 * n:]
    # causal conv via the rolling state
    hist = torch.cat([conv_state, xbc[:, None, :]], dim=1)             # (B,W,CC)
    xbc = torch.einsum("bwc,wc->bc", hist, p["conv"].to(x1.dtype))
    new_conv_state = hist[:, 1:]
    xbc = torch.nn.functional.silu(xbc.to(f32)).to(x1.dtype)
    xh = xbc[:, :di].reshape(b, h, hp)
    bb = xbc[:, di:di + n]
    cc = xbc[:, di + n:]
    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["A_log"].to(f32))
    da = torch.exp(dt * a[None, :])                                    # (B,H)
    upd = bb.to(f32)[:, None, :, None] * (dt[:, :, None] * xh.to(f32))[:, :, None, :]
    state = da[:, :, None, None] * state + upd                         # (B,H,N,hp)
    y = torch.einsum("bn,bhnp->bhp", cc.to(f32), state)
    y = y.to(x1.dtype) + xh * p["D"].to(x1.dtype)[None, :, None]
    y = y.reshape(b, di)
    y = y * torch.nn.functional.silu(z.to(f32)).to(x1.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return dense(y, p["out"])[:, None, :], state, new_conv_state


def ssm_conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_state


def ssm_in_features(cfg) -> int:
    return 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state + cfg.ssm_n_heads
