"""Operations and bytes of the measured work, from shapes alone, and the
device's peaks (``peaks.json``).

Model FLOPs count each multiply-add of a product as 2 operations; no
recompute (remat) is counted, so a share of the peak stays a share of
useful work.  Attention counts the (query, key) pairs that the causal mask
and the sliding window keep: q.k and p.v, 2 products of 2 * head_dim
operations a pair and head, forward; the backward twice that again.
Kernel bytes count each input byte read once and each output byte written
once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The data-sheet peaks of the device named ``kind``, None where the
    table has no entry."""
    return json.loads(PEAKS.read_text()).get(kind)


def kept_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs of one causal sequence of ``s`` positions, each
    query seeing at most ``window`` keys (itself included; 0: all)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def layer_matmul_params(arch) -> int:
    d, hd = arch.d_model, arch.head_dim
    attn = d * arch.heads * hd + 2 * d * arch.kv_heads * hd + arch.heads * hd * d
    return attn + 3 * d * arch.d_ff


def head_params(arch) -> int:
    return arch.d_model * arch.vocab


def attention_flops(arch, b: int, s: int) -> int:
    """Forward attention operations of one layer over ``b`` sequences of ``s``."""
    return 4 * b * arch.heads * arch.head_dim * kept_pairs(s, arch.window)


def prefill_flops(arch, s: int) -> int:
    """One prompt of ``s`` tokens: every layer's products over all
    positions, the output head at the last position only (the one whose
    logits are computed), attention over the kept pairs."""
    return (2 * arch.layers * layer_matmul_params(arch) * s + 2 * head_params(arch)
            + arch.layers * attention_flops(arch, 1, s))


def train_flops(arch, b: int, s: int) -> int:
    """One training step on (b, s) tokens: forward and backward (3 times
    the forward's products), the output head at every position."""
    tokens = b * s
    return (6 * (arch.layers * layer_matmul_params(arch) + head_params(arch)) * tokens
            + 3 * arch.layers * attention_flops(arch, b, s))


def planes_bytes(n: int, block: int, planes: int, sexp_in: int, sexp_out: int) -> int:
    """Bytes of one planes encode (float32 in; mu, sexp of ``sexp_out``
    bytes and P planes out) plus one decode (the same back, sexp read at
    ``sexp_in`` bytes) of ``n`` values in blocks of ``block``; either side
    0 where ``sexp_*`` is 0."""
    nb = n // block
    enc = 4 * n + planes * n + nb * (4 + sexp_out) if sexp_out else 0
    dec = planes * n + nb * (4 + sexp_in) + 4 * n if sexp_in else 0
    return enc + dec


def grad_planes_bytes(shapes, block: int, planes: int) -> int:
    """Planes bytes of one compressed gradient exchange on one member: each
    leaf encoded once (sexp written as int32) and decoded once (sexp read
    as the wire's int16), blocked along its last axis, padded to whole
    blocks."""
    total = 0
    for shape in shapes:
        shape = tuple(shape) or (1,)
        rows = 1
        for x in shape[:-1]:
            rows *= x
        n = rows * -(-shape[-1] // block) * block
        total += planes_bytes(n, block, planes, sexp_in=2, sexp_out=4)
    return total


def kv_encode_bytes(arch, s: int, planes: int) -> int:
    """Planes bytes of a prefill's cache fill: K and V of every layer, one
    block a (position, kv head), encoded once each (sexp written as int32)."""
    n = arch.layers * s * arch.kv_heads * arch.head_dim
    return 2 * planes_bytes(n, arch.head_dim, planes, sexp_in=0, sexp_out=4)
