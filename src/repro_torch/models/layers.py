"""Model layers of the dense-attention families, in PyTorch.

Counterpart of ``repro/models/layers.py``: the parameters are read as
``p["name"]`` like the JAX package's pytrees, in its layout (``x @ w``), and
each function computes what its namesake there computes.  The attention goes
through the flash-attention kernel (``kernels/flash_attention.py``) on a CUDA
tensor and through its plain version on a CPU tensor.

Not carried here: ``shard_activation`` (``repro/models/sharding.py:66``) is
an exact no-op outside a sharding-rules context, as it is on one card, so
the calls to it are dropped (the mesh comes with the multi-card slice); the
cross-attention (``kv_override``, ``cross_kv``), ``moe_ffn`` and the Mamba2
layers wait for the slices of their families.

Precision on the card: :func:`exact_matmuls` turns off TF32 and bf16
reduced-precision reductions for the ``dense`` products while a forward
pass, a prefill or a decode step runs, and restores the flags after.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import ops


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


def attention(p, x, cfg, *, positions=None, causal: bool = True):
    """p: {'wq','wk','wv','wo'}; x: (B,S,D).  Returns (B,S,D) and the (k, v)
    tensors for cache construction."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window if causal else 0)
    o = dense(o.reshape(b, s, cfg.n_heads * hd), p["wo"])
    return o, (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(p, x):
    """p: {'wi': (D, 2F), 'wo': (F, D)} -- fused gate+up projection."""
    gu = dense(x, p["wi"])
    gate, up = torch.chunk(gu, 2, dim=-1)
    h = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype) * up
    return dense(h, p["wo"])
