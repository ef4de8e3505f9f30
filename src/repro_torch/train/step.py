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
returns it.

Sharded (``make_train_step(cfg, opt, mesh=...)`` over a ``DeviceMesh``):
the state's leaves are ``DTensor``s placed by :func:`state_specs`
(:func:`init_sharded_state` draws the same values as :func:`init_state`
and keeps each rank's shards).  The batch is split over ``dp_axes``, and
the step hands the model each leaf's local shard as a
``models.sharding.Shard``, which the layers read through
``sharding.weight`` where they use it, so that a recomputed layer (remat)
gathers it again in the backward.  The step itself issues no collective of
its own: every one lives in ``models/sharding.py``.

Every family computes tensor-parallel along ``model``, as the reference's
GSPMD step does: the loss runs inside ``sharding.use_rules(mesh,
DEFAULT_RULES)`` (``PURE_DP_RULES`` where the batch is split over
``model`` too), so each ``model`` rank runs its own query heads (the
cross-attention's too), MLP columns, experts, SSM heads and vocabulary
columns, and keeps the gradients of its own shards.  ``weight``'s backward
reduce-scatters a leaf's gradient over the data-parallel axes it is split
on (FSDP), and ``sharding.batch_grad`` sums it over the others and divides
by their size.  AdamW updates the local shards; its clip norm sums each
rank's squares of its shards and all-reduces them once over the mesh dims
each group of leaves is split on.  With ``compress_planes`` the step is
the reference's ``per_pod``: a full-precision mean over ``data``, then
``compressed_psum_mean`` over the ``pod`` axis's group with ``ef``'s local
row as this pod's residual.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import grad_compress
from repro_torch.core.pytree import key_paths, leaves, tree_map, unflatten
from repro_torch.models import layers as L, sharding, transformer as T
from repro_torch.optim.adamw import AdamW, AdamWState

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


def make_train_step(cfg: ArchConfig, opt: AdamW, *, mesh=None, group=None,
                    compress_planes: int = 0, batch_axes=None):
    """-> ``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``tokens`` and ``labels`` tensors on the parameters' device.  With
    ``compress_planes`` the gradient is averaged over ``group`` (default:
    the whole world) through the compressed all-gather.  With ``mesh`` the
    step is the sharded one (module docstring): the state is sharded over
    ``mesh`` and ``batch`` is the global batch, whose rows each rank
    splits off for itself, over ``batch_axes`` (default ``dp_axes(mesh)``;
    every mesh axis for the pure data-parallel profile)."""
    if mesh is not None:
        return _make_sharded_step(cfg, opt, mesh, compress_planes, batch_axes)

    if not compress_planes:
        def train_step(state, batch):
            with obs.span("train.forward_backward"):
                loss, grads = value_and_grad(cfg, state["params"], batch)
            with obs.span("train.optimizer"):
                params, opt_state, metrics = opt.update(grads, state["opt"], state["params"])
            return {"params": params, "opt": opt_state}, {"loss": loss, **metrics}

        return train_step

    def train_step(state, batch):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ef = state["ef"]
        if n > leaves(ef)[0].shape[0]:
            raise ValueError(f"error feedback has {leaves(ef)[0].shape[0]} rows for a "
                             f"group of {n}")
        with obs.span("train.forward_backward"):
            loss, grads = value_and_grad(cfg, state["params"], batch)
        with obs.span("train.grad_exchange"):
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
        with obs.span("train.optimizer"):
            params, opt_state, metrics = opt.update(mean, state["opt"], state["params"])
        return ({"params": params, "opt": opt_state, "ef": ef}, {"loss": loss, **metrics})

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def state_specs(cfg: ArchConfig, state_tree, mesh):
    """Spec tree of a train state: ``opt.m``/``opt.v`` share the params'
    specs, ``step`` is replicated and ``ef`` is split over ``pod``."""
    from repro_torch.launch.mesh import P, param_specs_tree

    pspecs = param_specs_tree(cfg, state_tree["params"], mesh)
    out = {
        "params": pspecs,
        "opt": type(state_tree["opt"])(
            step=P(),
            m=param_specs_tree(cfg, state_tree["opt"].m, mesh),
            v=param_specs_tree(cfg, state_tree["opt"].v, mesh),
        ),
    }
    if "ef" in state_tree:
        out["ef"] = tree_map(lambda s: P("pod", *s), pspecs)
    return out


def state_template(cfg: ArchConfig, *, ef_planes: int = 0) -> dict:
    """The train state's tree on the ``meta`` device (nothing allocated)."""
    params = T.param_specs(cfg)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    zeros = lambda p: meta(p.shape, torch.float32)  # noqa: E731
    state = {"params": params, "opt": AdamWState(step=meta((), torch.int32),
                                                 m=tree_map(zeros, params),
                                                 v=tree_map(zeros, params))}
    if ef_planes:
        state["ef"] = tree_map(lambda p: meta((EF_PODS,) + tuple(p.shape), torch.bfloat16),
                               params)
    return state


def init_sharded_state(cfg: ArchConfig, opt: AdamW, generator: torch.Generator, mesh, *,
                       ef_planes: int = 0, device=None) -> dict:
    """:func:`init_state`'s values (the same draws from ``generator``) as
    ``DTensor``s placed by :func:`state_specs` on ``mesh``: each parameter
    is drawn whole, its shard kept and the rest dropped, so a rank holds
    one whole leaf at most beside its shards."""
    from repro_torch.launch.mesh import from_local, local_index, local_shape

    specs = state_specs(cfg, state_template(cfg, ef_planes=ef_planes), mesh)
    spec_at = dict(key_paths(specs["params"]))
    coords = mesh.get_coordinate()
    drawn = {}
    for path, full in T.init_leaves(cfg, generator, device=device):
        part = full[local_index(spec_at[path], full.shape, mesh, coords)]
        drawn[path] = from_local(part if part.numel() == full.numel() else part.clone(),
                                 spec_at[path], full.shape, mesh)
        del full
    template = T.param_specs(cfg)
    params = unflatten(template, [drawn[path] for path, _ in key_paths(template)])

    def zeros(p, spec, lead=(), dtype=torch.float32):
        shape = lead + tuple(p.shape)
        local = torch.zeros(local_shape(spec, shape, mesh, coords), dtype=dtype,
                            device=p.to_local().device)
        return from_local(local, spec, shape, mesh)

    dev = leaves(params)[0].to_local().device
    state = {"params": params,
             "opt": AdamWState(
                 step=from_local(torch.zeros((), dtype=torch.int32, device=dev),
                                 specs["opt"].step, (), mesh),
                 m=tree_map(zeros, params, specs["opt"].m),
                 v=tree_map(zeros, params, specs["opt"].v))}
    if ef_planes:
        state["ef"] = tree_map(lambda p, s: zeros(p, s, (EF_PODS,), torch.bfloat16),
                               params, specs["ef"])
    return state


def _dp_index(mesh, axes) -> tuple[int, int]:
    """(index of this rank's batch shard, number of shards) over ``axes``."""
    names = list(mesh.mesh_dim_names)
    coords = mesh.get_coordinate()
    idx, n = 0, 1
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coords[i]
        n *= mesh.size(i)
    return idx, n


def _split_rows(batch: dict, idx: int, n: int) -> dict:
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split over {n} ranks")
        rows = v.shape[0] // n
        out[k] = v.narrow(0, idx * rows, rows)
    return out


def _sharded_norm(grads, layouts, mesh) -> torch.Tensor:
    """AdamW's global norm of the local gradient shards: each leaf's sum of
    squares (``optim.adamw.global_norm``'s), summed by the set of mesh dims
    the leaves are split on and each set's sum all-reduced once over them,
    so a leaf replicated over a dim is counted once.  On a one-member mesh
    the sums run in ``global_norm``'s order."""
    by_dims = {}
    for g, lay in zip(grads, layouts):
        dims = tuple(sorted(i for d in lay for i in d if mesh.size(i) > 1))
        s = torch.sum(torch.square(g.to(torch.float32)))
        by_dims[dims] = s if dims not in by_dims else by_dims[dims] + s
    total = None
    for dims, s in by_dims.items():
        s = sharding.all_reduce_sum(s, [mesh.get_group(i) for i in dims])
        total = s if total is None else total + s
    return torch.sqrt(total)


def _make_sharded_step(cfg: ArchConfig, opt: AdamW, mesh, compress_planes: int,
                       batch_axes=None):
    from repro_torch.launch.mesh import dp_axes

    names = list(mesh.mesh_dim_names)
    dp = tuple(batch_axes) if batch_axes is not None else dp_axes(mesh)
    if compress_planes and "pod" not in names:
        raise ValueError(f"the compressed sharded step needs a 'pod' axis; the mesh has "
                         f"{tuple(names)}")
    if compress_planes and mesh.size(names.index("pod")) > EF_PODS:
        raise ValueError(f"error feedback has {EF_PODS} rows for a pod axis of "
                         f"{mesh.size(names.index('pod'))}")
    # the full-precision mean runs over these axes; with compression 'pod'
    # is left to compressed_psum_mean
    mean_axes = tuple(a for a in dp if not (compress_planes and a == "pod"))
    mean_dims = tuple(sorted(names.index(a) for a in mean_axes))
    rules = sharding.PURE_DP_RULES if "model" in dp else sharding.DEFAULT_RULES

    def train_step(state, batch):
        from torch.distributed.tensor import DTensor

        shard_idx, n_shards = _dp_index(mesh, dp)
        local = _split_rows({k: v.to_local() if isinstance(v, DTensor) else v
                             for k, v in batch.items()}, shard_idx, n_shards)
        plist = leaves(state["params"])
        layouts = [sharding.layout_of(p) for p in plist]
        xs = [p.to_local().detach().requires_grad_() for p in plist]
        tree = unflatten(state["params"], [sharding.Shard(x, lay, p.shape)
                                           for x, lay, p in zip(xs, layouts, plist)])
        groups = [mesh.get_group(names.index(a)) for a in mean_axes]
        n_mean = math.prod(mesh.size(names.index(a)) for a in mean_axes)
        with obs.span("train.forward_backward"), L.exact_matmuls(), \
                sharding.use_rules(mesh, rules), sharding.split_batch(groups, n_mean, mean_dims):
            with torch.enable_grad():
                loss = T.loss_fn(tree, cfg, local)
                grads = list(torch.autograd.grad(loss, xs))
            del tree, xs
            grads = [sharding.batch_grad(g, lay) for g, lay in zip(grads, layouts)]
        loss = loss.detach()
        if n_mean > 1:
            loss = sharding.all_reduce_sum(loss, groups) / n_mean
        out = {}
        if compress_planes:
            with obs.span("train.grad_exchange"):
                pod = mesh.get_group(names.index("pod"))
                n_pod = dist.get_world_size(pod)
                ef = [e.to_local() for e in leaves(state["ef"])]
                g_eff = [g.to(torch.float32) + e[0].to(torch.float32)
                         for g, e in zip(grads, ef)]
                del grads
                grads, resid = grad_compress.compressed_psum_mean(g_eff, pod,
                                                                  num_planes=compress_planes)
                del g_eff
                for e, r in zip(ef, resid):
                    e[0].copy_(r.to(torch.bfloat16))
                del resid
                if n_pod > 1:
                    loss = sharding.all_reduce_sum(loss, [pod]) / n_pod
            out["ef"] = state["ef"]
        params = [p.to_local() for p in plist]
        ost = state["opt"]
        opt_local = AdamWState(step=ost.step.to_local(),
                               m=[m.to_local() for m in leaves(ost.m)],
                               v=[v.to_local() for v in leaves(ost.v)])
        with obs.span("train.optimizer"):
            _, _, metrics = opt.update(grads, opt_local, params,
                                       norm_fn=lambda g32: _sharded_norm(g32, layouts, mesh))
        return ({"params": state["params"], "opt": ost, **out}, {"loss": loss, **metrics})

    return train_step
