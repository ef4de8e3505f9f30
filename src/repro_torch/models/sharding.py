"""Logical-axis activation sharding hints, and the batch statistics of a
data-parallel step.

Counterpart of ``repro/models/sharding.py``, whose model code calls
``shard_activation(x, logical_axes)`` with *logical* names while its
launcher installs a rule table mapping logical -> mesh axes through
``use_rules``.  The port's sharded step holds each rank's batch shard as an
ordinary tensor, so ``shard_activation`` returns its input in and out of a
rule context, and the port's model calls it nowhere: the reference's
``with_sharding_constraint`` waits for serving under a mesh, where
activations are ``DTensor``s (ROADMAP.md).  The rule tables have one
reader here, ``serve/engine._reduce_scores``.

:func:`split_batch` is the port's own: the sharded training step
(``train.step.make_train_step(mesh=...)``) runs each rank on its shard of
the batch, and inside it :func:`batch_mean` averages over the whole batch
(an all-reduce over the mesh's data-parallel axes whose backward
all-reduces the cotangent), so a statistic of the batch -- the MoE's
balance loss -- is the unsharded step's and not a mean of per-shard ones.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist


_state = threading.local()


DEFAULT_RULES: dict[str, object] = {
    # activation batch over all data-parallel axes
    "act_batch": ("pod", "data"),
    "act_heads": "model",
    "act_hd": "model",        # decode: head_dim-sharded q/KV (kv-head agnostic)
    "act_ff": "model",
    "act_expert": "model",
    "act_moe_batch": ("pod", "data"),   # batch dim of MoE dispatch buffers
    "act_seq": None,
    "act_embed": None,
}

# long-context decode (batch=1): batch replicated, sequence sharded over data
LONG_CONTEXT_RULES = dict(DEFAULT_RULES, act_batch=None, act_seq="data")

# pure data parallelism: for small models on a big mesh, replicate the
# params and shard the batch over EVERY mesh axis instead
PURE_DP_RULES = dict(
    DEFAULT_RULES,
    act_batch=("pod", "data", "model"),
    act_heads=None, act_hd=None, act_ff=None, act_expert=None,
    act_moe_batch=("pod", "data", "model"),
)

# serve-layout MoE: experts live on 'data' x 'model'; dispatch buffers
# follow the weights' E-sharding (replicate the token dim, shard E over 'data')
SERVE_MOE_RULES = dict(act_expert="data", act_moe_batch=None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield
    finally:
        _state.ctx = prev


def rules_active() -> bool:
    return getattr(_state, "ctx", None) is not None


def shard_activation(x, logical_axes):
    """``x`` as it is (module docstring)."""
    return x


# ---------------------------------------------------------------------------
# the batch split of a data-parallel step
# ---------------------------------------------------------------------------

def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each process group of ``groups`` in turn."""
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``groups``; the cotangent is summed over them as well, so
    the gradient of a loss every rank computes from the sum is the whole
    batch's."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce_sum(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.groups), None


@contextlib.contextmanager
def split_batch(groups, members: int):
    """Inside: the batch is split over ``members`` ranks, one shard a rank,
    and ``groups`` are the process groups of the data-parallel mesh axes."""
    prev = getattr(_state, "split", None)
    _state.split = (tuple(groups), members)
    try:
        yield
    finally:
        _state.split = prev


def batch_mean(x: torch.Tensor, dims) -> torch.Tensor:
    """``x.mean(dims)`` over the whole batch: inside :func:`split_batch`
    with more than one member, the mean of the members' means (their
    shards are the same size)."""
    split = getattr(_state, "split", None)
    local = x.mean(dim=dims)
    if split is None or split[1] == 1:
        return local
    groups, members = split
    return _AllReduceSum.apply(local, groups) / members
