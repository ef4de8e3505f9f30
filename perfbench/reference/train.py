"""Training steps of the reference: AdamW with a global-norm clip and
decoupled weight decay on matrices, a warm-up then cosine learning rate,
and optionally the szx-planes gradient round trip with error feedback, as
one data-parallel member computes it.

:func:`follow` runs the first steps from the weights of a seed and returns
the readings the benchmark compares: each step's loss, each leaf's norm of
the first gradient as the optimizer takes it (after the clip), of the first
step's compression residual, and of the change of the weights over all the
steps.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import model, planes, weights


def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine from the peak
    down to ``floor`` * peak at step ``total``."""
    peak, warm, total, floor = opt["peak_lr"], opt["warmup"], opt["total"], opt["floor"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(w: dict, grads: dict, m: dict, v: dict, step: int, opt: dict) -> dict:
    """One AdamW step on ``w`` in place; returns each leaf's norm of its
    gradient as the moments take it (clipped)."""
    gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(gn, min=1e-9), max=1.0)
    lr = learning_rate(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    taken = {}
    for name, g in grads.items():
        g = g * scale
        taken[name] = float(torch.linalg.vector_norm(g))
        if name not in m:
            m[name], v[name] = torch.zeros_like(g), torch.zeros_like(g)
        m[name].mul_(b1).add_((1 - b1) * g)
        v[name].mul_(b2).add_((1 - b2) * g * g)
        u = (m[name] / (1 - b1 ** step)) / (torch.sqrt(v[name] / (1 - b2 ** step)) + opt["eps"])
        if w[name].dim() >= 2:
            u = u + opt["weight_decay"] * w[name]
        w[name].sub_(lr * u)
    return taken


def leaf_norms(tree: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tree.items()}


def follow(arch, seed: int, batches, mix: dict, device, *, mm=model.FP32,
           half_batch: bool = False, exchange: bool = True) -> dict:
    """Run ``len(batches)`` steps from the weights of ``seed``.  With
    ``mix["compress_planes"]`` the gradient plus the error feedback goes
    through the planes round trip before the optimizer, and the residual,
    kept in bfloat16, is added to the next step's gradient.  The control
    and the planted faults: ``mm`` a lower precision, ``half_batch`` the
    loss over the first half of the rows alone, ``exchange`` False the
    round trip left out (the gradient goes through unchanged, no residual)."""
    opt, planes_n = mix["optimizer"], mix.get("compress_planes", 0)
    w = weights.make_all(arch, seed, device)
    m, v, ef = {}, {}, {}
    out = {"loss": [], "grad": None, "ef": None}
    for step, (tokens, labels) in enumerate(batches, start=1):
        if half_batch:
            tokens, labels = tokens[: len(tokens) // 2], labels[: len(labels) // 2]
        loss, grads = model.loss_and_grads(w, arch, tokens, labels, mm, mix["remat"])
        out["loss"].append(float(loss))
        if planes_n:
            for name in grads:
                g = grads[name] + ef[name].float() if name in ef else grads[name]
                if exchange:
                    dec = planes.roundtrip_last_axis(g, planes_n, planes.GRAD_BLOCK)
                    ef[name] = (g - dec).to(torch.bfloat16)
                    grads[name] = dec
                else:
                    ef[name] = torch.zeros_like(g, dtype=torch.bfloat16)
                    grads[name] = g
            if step == 1:
                out["ef"] = leaf_norms(ef)
        taken = adamw(w, grads, m, v, step, opt)
        if step == 1:
            out["grad"] = taken
        del grads
    out["delta"] = delta_norms(arch, seed, w, device)
    return out


@torch.no_grad()
def delta_norms(arch, seed: int, w: dict, device) -> dict:
    """Each leaf's norm of its change from the weights of ``seed``, the
    initial weights drawn again chunk by chunk."""
    out = {}
    for c in range(weights.chunk_count(arch)):
        for name, w0 in weights.make_chunk(arch, seed, c, device).items():
            out[name] = float(torch.linalg.vector_norm(w[name].float() - w0))
    return out
