"""Training step factory: the plain step, or the data-parallel step with SZx
gradient compression across the members of a process group.

Counterpart of ``repro/train/step.py``.  Plain: backward, then
``opt.update``.  Compressed (``compress_planes=P``): the reference's
``per_pod`` over a ``torch.distributed`` group standing for its ``pod``
axis -- the gradient plus this member's error feedback, szx-planes-encoded
and all-gathered (``core.grad_compress.compressed_psum_mean``), decoded and
averaged; the loss averaged over the group; the compression residual kept
as bf16 for the next step.  On one card the group is a one-rank NCCL group.

The state is ``{"params", "opt", "ef"}``: ``params`` the model's nested dict
(:func:`repro_torch.models.transformer.param_tree`), ``opt`` an
``AdamWState`` and, for the compressed step, ``ef`` bf16 ``(2,) + shape``
per parameter as in the reference, whose ``ef`` is split over a pod axis of
2: row r is member r's residual.  The step updates the state in place and
returns it.  ``state_specs`` (shardings) comes with the mesh slice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import grad_compress
from repro_torch.core.pytree import leaves, tree_map, unflatten
from repro_torch.models import layers as L, transformer as T
from repro_torch.optim.adamw import AdamW

EF_PODS = 2        # the reference's production mesh has 2 pods


def init_state(cfg: ArchConfig, opt: AdamW, generator: torch.Generator, *,
               ef_planes: int = 0, device=None) -> dict:
    """Parameters drawn from ``generator`` (on ``device``; ``None``: the
    card), zero AdamW moments and, with ``ef_planes``, zero error feedback."""
    params = T.param_tree(T.init_params(cfg, generator, device=device))
    state = {"params": params, "opt": opt.init(params)}
    if ef_planes:
        state["ef"] = tree_map(lambda p: torch.zeros(
            (EF_PODS,) + tuple(p.shape), dtype=torch.bfloat16, device=p.device), params)
    return state


def value_and_grad(cfg: ArchConfig, params, batch):
    """(loss, grads) of ``T.loss_fn`` at ``params``; grads have the tree's
    structure.  The matmuls run in full float32 (``exact_matmuls``) in the
    forward and the backward."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with L.exact_matmuls(), torch.enable_grad():
        loss = T.loss_fn(unflatten(params, flat), cfg, batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, opt: AdamW, *, group=None, compress_planes: int = 0):
    """-> ``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` tensors on the parameters' device.  With
    ``compress_planes`` the gradient is averaged over ``group`` (default:
    the whole world) through the compressed all-gather."""

    if not compress_planes:
        def train_step(state, batch):
            loss, grads = value_and_grad(cfg, state["params"], batch)
            params, opt_state, metrics = opt.update(grads, state["opt"], state["params"])
            return {"params": params, "opt": opt_state}, {"loss": loss, **metrics}

        return train_step

    def train_step(state, batch):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ef = state["ef"]
        if n > leaves(ef)[0].shape[0]:
            raise ValueError(f"error feedback has {leaves(ef)[0].shape[0]} rows for a "
                             f"group of {n}")
        loss, grads = value_and_grad(cfg, state["params"], batch)
        g_eff = tree_map(lambda g, e: g.to(torch.float32) + e[me].to(torch.float32),
                         grads, ef)
        del grads
        mean, resid = grad_compress.compressed_psum_mean(
            g_eff, group, num_planes=compress_planes)
        del g_eff
        dist.all_reduce(loss, group=group)
        loss = loss / n
        for e, r in zip(leaves(ef), leaves(resid)):
            e[me].copy_(r.to(torch.bfloat16))
        del resid
        params, opt_state, metrics = opt.update(mean, state["opt"], state["params"])
        return ({"params": params, "opt": opt_state, "ef": ef}, {"loss": loss, **metrics})

    return train_step
