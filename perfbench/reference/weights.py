"""Weights of a dense decoder drawn from the seed, chunk by chunk.

A model's leaves fall into chunks: the embedding, one chunk a layer, and the
final norm with the output head.  Each chunk is drawn by its own
``torch.Generator`` on the device, seeded from (seed, chunk), in one
``normal_`` call over all its matrices; each matrix is then scaled by
fan_in ** -0.5 (the embedding by d_model ** -0.5) and every norm scale is
one.  So a chunk can be drawn again alone, with the same values, by the
program's set-up and by the reference.  Leaves are named by their path in
the program's parameter tree (``layers.3.attn.wq``), in its ``x @ w``
layout: a matrix is (in, out), the fused ``mlp.wi`` is (D, 2F) with the
gate's columns first.
"""
from __future__ import annotations

import numpy as np
import torch


WEIGHTS = 0x5E1D


def derived_seed(seed: int, tag: int, index: int) -> int:
    """A 63-bit generator seed for stream ``index`` of kind ``tag`` of ``seed``."""
    words = np.random.SeedSequence([int(seed), tag, int(index)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 ^ int(words[1])) & (2 ** 63 - 1)


def chunk_count(arch) -> int:
    return arch.layers + 2


def leaf_specs(arch, chunk: int) -> list[tuple[str, tuple, int | None]]:
    """(name, shape, fan_in) of each leaf of ``chunk``; fan_in None for a
    norm scale."""
    d, hd, f = arch.d_model, arch.head_dim, arch.d_ff
    if chunk == 0:
        return [("embed", (arch.vocab, d), d)]
    if chunk == arch.layers + 1:
        out = [("final_ln", (d,), None)]
        if not arch.tie_embeddings:
            out.append(("lm_head", (d, arch.vocab), d))
        return out
    i = chunk - 1
    p = f"layers.{i}."
    return [(p + "ln1", (d,), None),
            (p + "attn.wq", (d, arch.heads * hd), d),
            (p + "attn.wk", (d, arch.kv_heads * hd), d),
            (p + "attn.wv", (d, arch.kv_heads * hd), d),
            (p + "attn.wo", (arch.heads * hd, d), arch.heads * hd),
            (p + "ln2", (d,), None),
            (p + "mlp.wi", (d, 2 * f), d),
            (p + "mlp.wo", (f, d), f)]


def all_leaf_specs(arch) -> list[tuple[str, tuple, int | None]]:
    return [s for c in range(chunk_count(arch)) for s in leaf_specs(arch, c)]


@torch.no_grad()
def make_chunk(arch, seed: int, chunk: int, device) -> dict[str, torch.Tensor]:
    """The float32 leaves of ``chunk``, drawn on ``device``."""
    specs = leaf_specs(arch, chunk)
    total = sum(int(np.prod(s)) for _, s, fan in specs if fan is not None)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, WEIGHTS, chunk))
    flat = torch.empty(total, dtype=torch.float32, device=device).normal_(generator=gen)
    out, off = {}, 0
    for name, shape, fan in specs:
        if fan is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].view(shape).mul_(fan ** -0.5)
        off += n
    return out


def make_all(arch, seed: int, device) -> dict[str, torch.Tensor]:
    out = {}
    for c in range(chunk_count(arch)):
        out.update(make_chunk(arch, seed, c, device))
    return out
