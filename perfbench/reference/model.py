"""A dense decoder-only transformer (Llama / Mistral layer equations) in plain
PyTorch, float32.

Per layer: x += wo(attn(rope(q), rope(k), v)) on rms_norm(x) * ln1, then
x += mlp.wo(silu(gate) * up) on rms_norm(x) * ln2, with [gate | up] =
h @ mlp.wi; grouped-query attention (query head h reads kv head h // (Hq /
Hkv)), causal, and limited to the last ``window`` keys where the
configuration has a sliding window; rotary embeddings on the two halves of
head_dim (the HF Llama layout) with theta ** (-2i / head_dim).  The output
head is ``final_ln`` then ``lm_head`` (or the embedding transposed where
tied).

Every product goes through ``mm`` (and the attention's operands through
``mm.operand``): :data:`FP32` computes in float32 with TF32 off; the
benchmark's control swaps in a lower precision (:class:`Fp8`).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class Arch:
    """The sizes the reference reads from a configuration file."""

    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    window: int           # 0: full causal attention
    eps: float
    tie_embeddings: bool

    @classmethod
    def from_config(cls, conf: dict) -> "Arch":
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        return cls(layers=conf["num_hidden_layers"], d_model=d, heads=h,
                   kv_heads=conf["num_key_value_heads"],
                   head_dim=conf.get("head_dim") or d // h,
                   d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
                   rope_theta=float(conf["rope_theta"]),
                   window=conf.get("sliding_window") or 0,
                   eps=float(conf["rms_norm_eps"]),
                   tie_embeddings=bool(conf.get("tie_word_embeddings", False)))


@contextlib.contextmanager
def full_fp32():
    """float32 products in full float32 inside the block (no TF32)."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


class Fp32:
    """Products in float32."""

    def operand(self, x):
        return x

    def __call__(self, x, w):
        return torch.matmul(x, w)


class Fp8(Fp32):
    """Products of float8 (e4m3) operands, each scaled by its own absolute
    maximum as an fp8 matmul scales it, accumulated in float32; the
    gradient passes the rounding straight through."""

    def operand(self, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return x + (q - x.detach())

    def __call__(self, x, w):
        return torch.matmul(self.operand(x), self.operand(w))


FP32 = Fp32()


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta: float):
    """x (B, S, H, hd), pos (S,) absolute positions."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * inv                  # (S, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int, mm):
    """Causal (windowed) grouped-query attention: q (B, S, Hq, hd), k, v
    (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qt, kt, vt = (mm.operand(t.transpose(1, 2)) for t in (q, k, v))   # (B, H, S, hd)
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    i = torch.arange(s, device=q.device)
    keep = i[None, :] <= i[:, None]
    if window:
        keep &= (i[:, None] - i[None, :]) < window
    scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(mm.operand(p), vt).transpose(1, 2)


def layer(w: dict, i: int, x, arch: Arch, mm, pos):
    """One block; returns (x, k, v) with k after its rotary embedding."""
    p = f"layers.{i}."
    b, s, _ = x.shape
    hd = arch.head_dim
    h = rms_norm(x, w[p + "ln1"], arch.eps)
    q = mm(h, w[p + "attn.wq"]).view(b, s, arch.heads, hd)
    k = mm(h, w[p + "attn.wk"]).view(b, s, arch.kv_heads, hd)
    v = mm(h, w[p + "attn.wv"]).view(b, s, arch.kv_heads, hd)
    q, k = rope(q, pos, arch.rope_theta), rope(k, pos, arch.rope_theta)
    o = attend(q, k, v, arch.window, mm).reshape(b, s, arch.heads * hd)
    x = x + mm(o, w[p + "attn.wo"])
    h = rms_norm(x, w[p + "ln2"], arch.eps)
    gate, up = mm(h, w[p + "mlp.wi"]).chunk(2, dim=-1)
    x = x + mm(F.silu(gate) * up, w[p + "mlp.wo"])
    return x, k, v


def head(w: dict, arch: Arch):
    return w["embed"].T if arch.tie_embeddings else w["lm_head"]


@torch.no_grad()
def prefill(w: dict, arch: Arch, tokens, mm=FP32, on_layer=None, every: bool = False):
    """Forward over one prompt ``tokens`` (S,): the last position's logits
    (V,) float32, or with ``every`` each position's (S, V); ``on_layer(i,
    k, v)`` sees each layer's K/V (S, Hkv, hd)."""
    with full_fp32():
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        x = w["embed"][tokens.long()][None]
        for i in range(arch.layers):
            x, k, v = layer(w, i, x, arch, mm, pos)
            if on_layer is not None:
                on_layer(i, k[0], v[0])
        h = rms_norm(x[0] if every else x[:, -1], w["final_ln"], arch.eps)
        out = mm(h, head(w, arch))
        return out if every else out[0]


def loss(w: dict, arch: Arch, tokens, labels, mm=FP32, remat: bool = True):
    """Mean next-token cross-entropy of (B, S) ``tokens`` against ``labels``,
    each layer recomputed in the backward where ``remat``."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = w["embed"][tokens.long()]

    def run(i, x):
        return layer(w, i, x, arch, mm, pos)[0]

    for i in range(arch.layers):
        x = checkpoint(run, i, x, use_reentrant=False) if remat else run(i, x)
    logits = mm(rms_norm(x, w["final_ln"], arch.eps), head(w, arch))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def loss_and_grads(w: dict, arch: Arch, tokens, labels, mm=FP32, remat: bool = True):
    """(loss, {name: gradient}) over the leaves of ``w``."""
    names = list(w)
    leaves = [w[n].detach().requires_grad_() for n in names]
    with full_fp32(), torch.enable_grad():
        out = loss(dict(zip(names, leaves)), arch, tokens, labels, mm, remat)
        grads = torch.autograd.grad(out, leaves)
    return out.detach(), dict(zip(names, grads))
