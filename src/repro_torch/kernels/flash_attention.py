"""Flash-attention forward: the CUDA kernel and its plain version.

The kernel is ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``), which
replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``.  It has two
routes, chosen here by dtype: bf16 inputs (serving and training) run on the
tensor cores (``mma.sync`` bf16, p @ v as three bf16 terms of p), float32
inputs on the CUDA cores (float32 products, which their tolerance needs).
The plain version
is :func:`repro_torch.kernels.ref.flash_attention_ref`, the online softmax of
``repro/models/layers.py::flash_attention``.  The wrapper takes the plain
version for a CPU tensor only; a CUDA tensor launches the kernel or raises.
The kernel is held to the plain version to a tolerance (its sums run in
another order), not bit for bit.  The launch is the custom operator
``repro_torch::flash_attention_fwd``, which every CUDA tensor goes through:
its fake implementation gives the output's shape only, so a fake tensor
(the dry-run's) reaches no launch.  Its flops are registered with
``torch.utils.flop_counter``.

Training differentiates through :class:`FlashAttention`, whose forward is
:func:`flash_attention` and whose backward, :func:`flash_attention_bwd`,
recomputes the probabilities per chunk of 512 queries from q, k and v with
torch ops in float32.  The JAX package has no backward kernel either: its
training differentiates the checkpointed ``lax.scan`` of
``repro/models/layers.py::flash_attention``, and this backward computes the
same gradient (a hand-written backward kernel is later work).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

flash_attention_plain = ref.flash_attention_ref

LAUNCHES = 0          # flash_attention() kernel launches since the last reset
_COUNT_LOCK = threading.Lock()
MAX_HEAD_DIM = 128
MAX_GROUP = 64        # query heads per kv head: a block holds 64 (position, head) rows
# the kernel's entry point for each input type: tensor cores or CUDA cores
_ROUTES = {torch.bfloat16: "szx_flash_attention_fwd_bf16",
           torch.float32: "szx_flash_attention_fwd_f32"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype not in _ROUTES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the kernel takes "
                             "float32 or bfloat16, the same for q, k and v")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, hd), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    b, _sq, hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    hkv = k.shape[2]
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads (the group "
                         f"must divide evenly, at most {MAX_GROUP})")
    if b * hkv > 65535:
        raise ValueError(f"flash_attention: batch x kv heads {b * hkv} > 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """GQA attention forward: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) ->
    (B, Sq, Hq, hd) in q.dtype.  ``q_offset`` is the key index of query 0
    (the length of a halo of earlier keys before the queries' own)."""
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":             # the operator's fake would take a meta tensor
        raise ValueError(f"flash_attention: q on {q.device}; the kernel takes CUDA tensors")
    return _flash_op(q, k, v, bool(causal), int(window), int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int, q_offset: int) -> torch.Tensor:
    """The kernel's launch as an operator: a fake tensor (the dry-run's)
    takes :func:`_flash_shape` and launches nothing."""
    _check(q, k, v)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or sq == 0:                    # a grid of 0 is refused
        return out
    fn = _build.function("flash_attention", _ROUTES[q.dtype], _ARGTYPES)
    rc = _build.launch(fn, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      b, sq, skv, hq, hkv, hd, int(bool(causal)), int(window),
                                      int(q_offset), 1.0 / math.sqrt(hd)))
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed (CUDA error {rc})")
    _count_launch()
    return out


@_flash_op.register_fake
def _flash_shape(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


def visible_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave, for queries at key indices
    q_offset .. q_offset + sq - 1 over keys at 0 .. skv-1."""
    total = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(skv, i + 1) if causal else skv
        lo = max(0, i - window + 1) if window else 0
        total += max(hi - lo, 0)
    return total


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset=0, *args, out_shape=None,
                 **kwargs):
    """2 flops a multiply-add of q k^T and of p v, over the visible pairs."""
    b, sq, hq, hd = q_shape
    return 4 * b * hq * hd * visible_pairs(sq, k_shape[1], causal, window, q_offset)


NEG_INF = -1e30       # the reference's mask value; s <= NEG_INF / 2 gives p = 0
BWD_Q_CHUNK = 512     # queries per recompute of the probabilities


def flash_attention_bwd(q, k, v, do, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, q_chunk: int = BWD_Q_CHUNK):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the output
    cotangent ``do``, in the dtypes of q, k, v.

    Per chunk of ``q_chunk`` queries: s = (q k^T) * scale in float32
    (float64 for float64 inputs, as the plain forward) with
    the reference's masks (-1e30, then p = 0 where s <= -5e29), p the row
    softmax, o = p v; then dp = do v^T, ds = p (dp - rowsum(do * o)),
    dq = ds k * scale, and dk += ds^T q * scale, dv += p^T do summed over
    the query heads of each kv head (GQA).  Keys that no query of the chunk
    may see (past the causal diagonal, before the window) are skipped: their
    p is 0.  Query i sits at key index ``q_offset`` + i."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.promote_types(q.dtype, torch.float32)
    kt = k.to(f32).permute(0, 2, 1, 3)                      # (B, Hkv, Skv, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)
    dk = torch.zeros_like(kt)
    dv = torch.zeros_like(vt)
    dq = torch.empty((b, sq, hq, hd), dtype=f32, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    for q0 in range(0, sq, q_chunk):
        c = min(q_chunk, sq - q0)
        k_lo, k_hi = 0, skv
        if causal:
            k_hi = min(skv, q_offset + q0 + c)
        if window:
            k_lo = max(0, q_offset + q0 - window + 1)
        if k_hi <= k_lo:
            dq[:, q0:q0 + c] = 0
            continue

        def heads(x):      # (B, c, Hq, hd) -> (B, Hkv, g * c, hd), group-major
            return x.to(f32).reshape(b, c, hkv, g, hd).permute(0, 2, 3, 1, 4) \
                .reshape(b, hkv, g * c, hd)

        qc, doc = heads(q[:, q0:q0 + c]), heads(do[:, q0:q0 + c])
        kc, vc = kt[:, :, k_lo:k_hi], vt[:, :, k_lo:k_hi]
        qpos = (q_offset + q0 + torch.arange(c, device=q.device)).repeat(g)   # rows are (g, c)
        kp = kpos[k_lo:k_hi]
        valid = torch.ones((g * c, k_hi - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            valid &= kp[None, :] <= qpos[:, None]
        if window:
            valid &= qpos[:, None] - kp[None, :] < window
        s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
        del s
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = torch.matmul(p, vc)
        delta = (doc * o).sum(dim=-1, keepdim=True)
        dv[:, :, k_lo:k_hi] += torch.matmul(p.transpose(-1, -2), doc)
        ds = p * (torch.matmul(doc, vc.transpose(-1, -2)) - delta)
        del p
        dqc = torch.matmul(ds, kc) * scale                    # (B, Hkv, g * c, hd)
        dk[:, :, k_lo:k_hi] += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dq[:, q0:q0 + c] = dqc.reshape(b, hkv, g, c, hd).permute(0, 3, 1, 2, 4) \
            .reshape(b, c, hq, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    gradient; q, k and v are saved, the probabilities recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, causal=ctx.causal, window=ctx.window,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None
