"""Logical-axis activation sharding, the collectives of serving under a
mesh, and the batch statistics of a data-parallel step.

Counterpart of ``repro/models/sharding.py``, whose model code calls
``shard_activation(x, logical_axes)`` with *logical* names while its
launcher installs a rule table mapping logical -> mesh axes through
``use_rules``; GSPMD then inserts the collectives.  The port computes on
each rank's local shards and issues the collectives itself: inside
``use_rules(mesh, rules)`` (a ``DeviceMesh`` over a process group) the
serving path (``serve/engine.py``'s ``prefill``/``decode_step`` and the
dense and MoE layers under them) reads its parameters' and cache's
``DTensor`` placements (once a tensor, :func:`placed`), computes on the
local tensors and gathers, slices or all-reduces over the mesh dims that
:func:`mesh_dims` resolves for a logical axis.  Nothing runs through
``DTensor``'s sharding propagation.  On plain tensors outside a rules
context every function here is the identity, so the same model code
runs unchanged.

A local tensor's *layout* is a tuple, one entry a tensor dim, of the mesh
dim indices that dim is split over (major to minor, in mesh order; ``()``
for a whole dim), each split in ``DTensor``'s chunks of ceil(size / n)
(``launch/mesh.local_index``).  :func:`shard_activation` takes a local
tensor in the layout the previous op left it in and returns it in the
layout the rule names, gathering over the mesh dims it leaves and slicing
over those it enters.

:func:`split_batch` is the port's own: the sharded training step
(``train.step.make_train_step(mesh=...)``) runs each rank on its shard of
the batch, and inside it :func:`batch_mean` averages over the whole batch
(an all-reduce over the mesh's data-parallel axes whose backward
all-reduces the cotangent), so a statistic of the batch -- the MoE's
balance loss -- is the unsharded step's and not a mean of per-shard ones.
The training step enters no rules context.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref

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


class _Rules:
    """An active rules context: the mesh, its rule table, and what they
    resolve to, worked out once -- each logical axis's mesh dims, the mesh
    dims' sizes, this rank's coordinate (read on first use: a stand-in
    mesh with only ``mesh_dim_names`` and ``shape`` serves the rest)."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.sizes = tuple(mesh.shape)
        self.dims = {}
        self._coords = None

    @property
    def coords(self) -> tuple:
        if self._coords is None:
            self._coords = tuple(self.mesh.get_coordinate())
        return self._coords


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = _Rules(mesh, dict(DEFAULT_RULES, **(rules or {})))
    try:
        yield
    finally:
        _state.ctx = prev


def rules_active() -> bool:
    return getattr(_state, "ctx", None) is not None


def current_mesh():
    """The mesh of the active rules context (None outside one)."""
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else ctx.mesh


def mesh_dims(logical) -> tuple:
    """The mesh dim indices (mesh order) a logical axis maps to under the
    active rules; ``()`` for ``None``, for an axis the rules leave
    unmapped, and outside a rules context.  Mesh axes the mesh lacks are
    dropped, as the reference's ``shard_activation`` drops them."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or logical is None:
        return ()
    got = ctx.dims.get(logical)
    if got is None:
        axis = ctx.rules.get(logical)
        axes = () if axis is None else axis if isinstance(axis, tuple) else (axis,)
        names = list(ctx.mesh.mesh_dim_names)
        got = ctx.dims[logical] = tuple(sorted(names.index(a) for a in axes if a in names))
    return got


def coordinate(i: int) -> int:
    """This rank's index along mesh dim ``i`` of the active rules' mesh."""
    return _state.ctx.coords[i]


def mesh_size(dims) -> int:
    """The number of members over mesh ``dims`` (1 for none)."""
    return math.prod(_state.ctx.sizes[i] for i in dims) if dims else 1


_dtensor = None
_placed = {}            # id(DTensor) -> (weak reference, (local tensor, layout))


def placed(t) -> tuple:
    """``(local tensor, layout)`` of a ``DTensor`` -- read from its
    placements once and remembered for the object's life, as neither
    changes -- or ``(t, whole layout)`` of a plain tensor."""
    global _dtensor
    if type(t) is torch.Tensor:
        return t, ((),) * t.dim()
    if _dtensor is None:
        from torch.distributed.tensor import DTensor

        _dtensor = DTensor
    if not isinstance(t, _dtensor):
        return t, ((),) * t.dim()
    key = id(t)
    got = _placed.get(key)
    if got is not None and got[0]() is t:
        return got[1]
    lay = [()] * t.dim()
    for i, p in enumerate(t.placements):
        if p.is_shard():
            lay[p.dim] = lay[p.dim] + (i,)
    val = (t.to_local(), tuple(lay))
    _placed[key] = (weakref.ref(t, lambda _ref, key=key: _placed.pop(key, None)), val)
    return val


def layout_of(t) -> tuple:
    """The layout of a ``DTensor`` from its placements (one entry a tensor
    dim: the mesh dims it is split over); a plain tensor is whole."""
    return placed(t)[1]


def to_local(t) -> torch.Tensor:
    return placed(t)[0]


def placements(layout, mesh) -> tuple:
    """``DTensor`` placements of ``layout`` on ``mesh``, one a mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, dims in enumerate(layout):
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, layout, shape, mesh=None):
    """A ``DTensor`` of global ``shape`` whose shard on this rank is
    ``local`` (storage shared), placed by ``layout`` on ``mesh`` (default
    the active rules' mesh)."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh() if mesh is None else mesh
    return DTensor.from_local(local, mesh, placements(layout, mesh), run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def dividing(dims, size: int) -> tuple:
    """``dims`` where their members divide ``size``, else ``()``: a dim the
    mesh cannot split evenly stays whole, as ``launch/mesh._sanitize``
    keeps a spec's axis only where it divides the dim."""
    return tuple(dims) if size % mesh_size(dims) == 0 else ()


def members(dims) -> tuple:
    """The dims of ``dims`` whose mesh axis has more than one member."""
    return tuple(i for i in dims if _state.ctx.sizes[i] > 1) if dims else ()


def chunk_range(size: int, dims) -> tuple[int, int]:
    """[lo, hi) of a dim of ``size`` this rank holds when it is split over
    mesh ``dims`` (major to minor), as ``launch/mesh.local_index`` cuts it."""
    lo, hi = 0, size
    if not dims:
        return lo, hi
    ctx = _state.ctx
    for i in dims:
        step = -(-(hi - lo) // ctx.sizes[i])
        start = min(lo + ctx.coords[i] * step, hi)
        lo, hi = start, min(start + step, hi)
    return lo, hi


def _gather_dim(x: torch.Tensor, d: int, i: int, size: int) -> torch.Tensor:
    """``x``, this rank's chunk of a dim of ``size`` along mesh dim ``i``,
    gathered whole: each member's chunk padded to ceil(size / n), so the
    concatenation's first ``size`` entries are the whole dim."""
    mesh = current_mesh()
    n = _state.ctx.sizes[i]
    step = -(-size // n)
    if x.shape[d] < step:
        pad = list(x.shape)
        pad[d] = step - x.shape[d]
        x = torch.cat([x, x.new_zeros(pad)], dim=d)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(i))
    return torch.cat(parts, dim=d).narrow(d, 0, size)


def gather(x: torch.Tensor, d: int, dims, size: int) -> torch.Tensor:
    """``x`` split along tensor dim ``d`` over mesh ``dims`` (a dim of
    ``size`` whole) gathered whole along ``d``, minor mesh dims first."""
    if not dims:
        return x
    dims = tuple(dims)
    d = d % x.dim()
    for k in reversed(range(len(dims))):
        if _state.ctx.sizes[dims[k]] > 1:
            lo, hi = chunk_range(size, dims[:k])
            x = _gather_dim(x, d, dims[k], hi - lo)
    return x


def take(x: torch.Tensor, d: int, dims) -> torch.Tensor:
    """This rank's chunk along tensor dim ``d`` (whole in ``x``) when it is
    split over mesh ``dims``: a view, no communication."""
    if not dims:
        return x
    d = d % x.dim()
    lo, hi = chunk_range(x.shape[d], members(dims))
    return x if (lo, hi) == (0, x.shape[d]) else x.narrow(d, lo, hi - lo)


def reshard(x: torch.Tensor, src, dst, shape) -> torch.Tensor:
    """``x`` in layout ``src`` (a tensor of global ``shape``) -> layout
    ``dst``: along each dim, gathered over the mesh dims of ``src`` past
    the common prefix and sliced over those of ``dst``."""
    for d, (a, b) in enumerate(zip(src, dst)):
        a, b = members(a), members(b)
        if a == b:
            continue
        c = 0
        while c < min(len(a), len(b)) and a[c] == b[c]:
            c += 1
        if a[c:]:
            lo, hi = chunk_range(shape[d], a[:c])
            x = gather(x, d, a[c:], hi - lo)
        if b[c:]:
            x = take(x, d, b[c:])
    return x


def all_reduce(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` summed over mesh ``dims`` in place (each dim's group in mesh
    order); a one-member dim moves nothing."""
    if not dims:
        return x
    mesh = current_mesh()
    return all_reduce_sum(x, [mesh.get_group(i) for i in members(dims)])


def weight(w, keep=()) -> tuple[torch.Tensor, tuple]:
    """A parameter's local tensor and layout, gathered over every mesh dim
    it is split on along a tensor dim not in ``keep`` (FSDP's gather at
    use): the layer computes on the split it keeps.  A plain tensor comes
    back as it is, whole."""
    t, lay = placed(w)
    if not any(lay):
        return t, lay
    keep = {k % len(lay) for k in keep}
    for d, dims in enumerate(lay):
        if dims and d not in keep:
            t = gather(t, d, dims, w.shape[d])
    return t, tuple(dims if d in keep else () for d, dims in enumerate(lay))


def shard_activation(x, logical_axes, *, src=None, shape=None):
    """``x`` (the local tensor) in the layout ``logical_axes`` names under
    the active rules.  ``src`` is the layout ``x`` is in -- one entry a
    tensor dim: a logical name, a tuple of mesh dim indices, or ``None``
    for a whole dim -- and ``shape`` its global shape.  Without ``src``, or
    outside a rules context, ``x`` is taken as already there and returned
    as it is."""
    if src is None or not rules_active():
        return x

    def resolve(entries):
        return tuple(e if isinstance(e, tuple) else mesh_dims(e) for e in entries)

    return reshard(x, resolve(src), resolve(logical_axes), shape)


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
