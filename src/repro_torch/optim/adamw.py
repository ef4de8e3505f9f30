"""AdamW over trees of the port's parameter tensors (fp32 moments, global-norm
clip, no decay on vectors).

Counterpart of ``repro/optim/adamw.py``, step for step in float32: the
state is ``AdamWState(step, m, v)`` with an explicit int32 step tensor and
moments shaped like the parameters.  :meth:`AdamW.update` works in place:
it writes the new moments into ``state.m``/``state.v`` and the new values
into the parameter tensors (one parameter-sized temporary at a time, where
the reference builds new trees), and returns the same trees.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.pytree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    m: Any
    v: Any


class AdamW(NamedTuple):
    lr: Any                      # float or callable(step tensor) -> float tensor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        dev = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *, norm_fn=None):
        """One step: -> (params, state, {"grad_norm", "lr"}), the trees updated
        in place.  ``norm_fn`` (default :func:`global_norm`) takes the list
        of float32 gradients; a sharded step passes its own."""
        g32 = [g.to(torch.float32) for g in leaves(grads)]
        scale = None
        if self.clip_norm:
            gn = (norm_fn or global_norm)(g32)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        else:
            gn = torch.zeros((), dtype=torch.float32, device=state.step.device)
        state.step.add_(1)
        step = state.step
        lr = self.lr(step) if callable(self.lr) else self.lr
        sf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=sf.device), sf)
        b2c = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=sf.device), sf)

        for p, m, v, g in zip(leaves(params), leaves(state.m), leaves(state.v), g32):
            if scale is not None:
                g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay and p.dim() >= 2:      # no decay on norms/bias
                u = u + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        return params, state, {"grad_norm": gn, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (float32)."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine down to
    ``floor * peak_lr`` at ``total``; a function of the step tensor."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)

    return sched
