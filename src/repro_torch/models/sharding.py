"""Logical-axis activation sharding and the collectives of tensor-parallel
serving and training under a mesh, differentiable.

Counterpart of ``repro/models/sharding.py``, whose model code calls
``shard_activation(x, logical_axes)`` with *logical* names while its
launcher installs a rule table mapping logical -> mesh axes through
``use_rules``; GSPMD then inserts the collectives.  The port computes on
each rank's local shards and issues the collectives itself: inside
``use_rules(mesh, rules)`` (a ``DeviceMesh`` over a process group) the
model code (``serve/engine.py``'s ``prefill``/``decode_step``, the
training step's ``loss_fn``, and every family's layers under them)
reads its parameters' placements (a ``DTensor``'s once, :func:`placed`;
the training step hands :class:`Shard`s), computes on the local tensors
and gathers, slices or all-reduces over the mesh dims that
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

Under autograd the collectives hold one invariant, Megatron's: a tensor
that a rank holds whole carries the *whole* cotangent on every rank in the
backward, and a rank's chunk of a split tensor carries its chunk's.  So
:func:`gather` (an all-gather) takes back this rank's chunk, :func:`take`
(a slice) all-gathers the chunks' cotangents (the padding of uneven chunks
as the forward's), :func:`all_reduce` at the exit of a row-parallel
product passes the cotangent through, and :func:`enter` -- the identity --
all-reduces it where a whole activation feeds work split over ranks (each
rank's cotangent there is a partial sum).  :func:`all_to_all`'s backward
is the inverse exchange.  On a dim of one member every op returns its
input unchanged both ways, so a one-member mesh computes the unsharded
model's bits.

The data-parallel axes keep the other convention: a rank's cotangent is
its batch shard's.  :func:`split_batch` (the sharded training step,
``train.step.make_train_step(mesh=...)``) names them; :func:`weight`
gathers a parameter over them at use (FSDP) and reduce-scatters its
gradient with a sum, :func:`batch_grad` sums the gradient of a leaf
replicated over them and divides by their size, and :func:`batch_mean`
averages a statistic over the whole batch (an all-reduce whose backward
all-reduces the cotangent), so the MoE's balance loss is the unsharded
step's and not a mean of per-shard ones.
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


def snapshot() -> tuple:
    """The calling thread's rules context and batch split."""
    return getattr(_state, "ctx", None), getattr(_state, "split", None)


@contextlib.contextmanager
def restored(snap):
    """Inside: the rules context and batch split of :func:`snapshot` in
    this thread.  Autograd runs a CUDA tensor's backward, and so a remat
    recompute, on a device thread of its own, which holds neither."""
    prev = snapshot()
    _state.ctx, _state.split = snap
    try:
        yield
    finally:
        _state.ctx, _state.split = prev


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs under
    the rules context and batch split its forward ran under."""
    return contextlib.nullcontext(), restored(snapshot())


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


class Shard:
    """A parameter as the sharded training step hands it to the model: this
    rank's local tensor (the leaf the step differentiates), its layout and
    the parameter's global shape.  :func:`placed` and :func:`weight` read it
    as they read a ``DTensor``; it lives for one step, so nothing of a
    step's graph outlives it."""

    __slots__ = ("local", "layout", "shape")

    def __init__(self, local: torch.Tensor, layout: tuple, shape):
        self.local, self.layout, self.shape = local, tuple(layout), torch.Size(shape)

    def dim(self) -> int:
        return len(self.shape)


def placed(t) -> tuple:
    """``(local tensor, layout)`` of a ``DTensor`` -- read from its
    placements once and remembered for the object's life, as neither
    changes -- or of a :class:`Shard`, or ``(t, whole layout)`` of a plain
    tensor."""
    global _dtensor
    if type(t) is torch.Tensor:
        return t, ((),) * t.dim()
    if type(t) is Shard:
        return t.local, t.layout
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
    from torch.distributed.tensor import Replicate, Shard as ShardPlacement

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, dims in enumerate(layout):
        for i in dims:
            out[i] = ShardPlacement(d)
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


def _groups(dims) -> list:
    """The process groups of the dims of ``dims`` with more than one member."""
    mesh = current_mesh()
    return [mesh.get_group(i) for i in members(dims)]


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``: only then does a collective
    go through its ``autograd.Function`` (serving runs the plain ops)."""
    return torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# the collectives, each with its backward (module docstring)
# ---------------------------------------------------------------------------

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


def _gather(x: torch.Tensor, d: int, dims, size: int) -> torch.Tensor:
    for k in reversed(range(len(dims))):
        if _state.ctx.sizes[dims[k]] > 1:
            lo, hi = chunk_range(size, dims[:k])
            x = _gather_dim(x, d, dims[k], hi - lo)
    return x


def _take(x: torch.Tensor, d: int, dims) -> torch.Tensor:
    lo, hi = chunk_range(x.shape[d], members(dims))
    return x if (lo, hi) == (0, x.shape[d]) else x.narrow(d, lo, hi - lo)


class _Gather(torch.autograd.Function):
    """All-gather; backward: this rank's chunk of the whole cotangent."""

    @staticmethod
    def forward(ctx, x, d, dims, size):
        ctx.d, ctx.dims, ctx.snap = d, dims, snapshot()
        return _gather(x, d, dims, size)

    @staticmethod
    def backward(ctx, g):
        with restored(ctx.snap):
            return _take(g, ctx.d, ctx.dims), None, None, None


class _Take(torch.autograd.Function):
    """This rank's chunk; backward: the chunks' cotangents gathered whole."""

    @staticmethod
    def forward(ctx, x, d, dims):
        ctx.d, ctx.dims, ctx.size, ctx.snap = d, dims, x.shape[d], snapshot()
        return _take(x, d, dims)

    @staticmethod
    def backward(ctx, g):
        with restored(ctx.snap):
            return _gather(g, ctx.d, ctx.dims, ctx.size), None, None


def gather(x: torch.Tensor, d: int, dims, size: int) -> torch.Tensor:
    """``x`` split along tensor dim ``d`` over mesh ``dims`` (a dim of
    ``size`` whole) gathered whole along ``d``, minor mesh dims first."""
    dims = members(dims)
    if not dims:
        return x
    d = d % x.dim()
    if _tracked(x):
        return _Gather.apply(x, d, dims, size)
    return _gather(x, d, dims, size)


def take(x: torch.Tensor, d: int, dims) -> torch.Tensor:
    """This rank's chunk along tensor dim ``d`` (whole in ``x``) when it is
    split over mesh ``dims``: a view, no communication (its backward
    all-gathers)."""
    dims = members(dims)
    if not dims:
        return x
    d = d % x.dim()
    if chunk_range(x.shape[d], dims) == (0, x.shape[d]):
        return x
    if _tracked(x):
        return _Take.apply(x, d, dims)
    return _take(x, d, dims)


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


def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each process group of ``groups`` in turn, in place."""
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _Exit(torch.autograd.Function):
    """Sum of partial products; backward: the whole cotangent passes to
    every rank's partial."""

    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce_sum(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity; backward: the partial cotangents summed."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.groups), None


def all_reduce(x: torch.Tensor, dims) -> torch.Tensor:
    """``x``, partial sums over mesh ``dims``, summed (each dim's group in
    mesh order; in place outside autograd); a one-member dim moves
    nothing.  Backward: the identity."""
    groups = _groups(dims)
    if not groups:
        return x
    if _tracked(x):
        return _Exit.apply(x, groups)
    return all_reduce_sum(x, groups)


def enter(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` (held whole) where it feeds work split over mesh ``dims``: the
    identity, whose backward all-reduces the cotangent over ``dims`` --
    each rank's share of the split work gives a partial sum of it."""
    if not dims or not _tracked(x):
        return x
    groups = _groups(dims)
    return _Enter.apply(x, groups) if groups else x


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=v) for s, t, v in ctx.others)


def tie(x: torch.Tensor, *others) -> torch.Tensor:
    """``x``, with ``others`` joined to the graph at a zero cotangent: a
    rank whose share of split work is empty (no query head) still runs the
    backward of what produced ``others``, and so joins its collectives."""
    if not _tracked(x) and not any(_tracked(o) for o in others):
        return x
    return _Tie.apply(x, *others)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` along dim 0; backward: the inverse exchange."""

    @staticmethod
    def forward(ctx, x, to, frm, group):
        ctx.to, ctx.frm, ctx.group = to, frm, group
        return _all_to_all(x, to, frm, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.frm, ctx.to, ctx.group), None, None, None


def _all_to_all(x, to, frm, group):
    x = x.contiguous()
    out = x.new_empty((sum(frm),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=list(frm), input_split_sizes=list(to),
                           group=group)
    return out


def all_to_all(x: torch.Tensor, to, frm, i: int) -> torch.Tensor:
    """Rows of ``x`` (dim 0) sent over mesh dim ``i``: ``to[t]`` of them,
    in order, to member t; ``frm[t]`` received from member t, in member
    order."""
    group = current_mesh().get_group(i)
    if _tracked(x):
        return _AllToAll.apply(x, tuple(to), tuple(frm), group)
    return _all_to_all(x, to, frm, group)


def _reduce_scatter_dim(g: torch.Tensor, d: int, i: int) -> torch.Tensor:
    """``g`` (whole along ``d``) summed over mesh dim ``i``'s members, each
    keeping its chunk of ceil(size / n) (``_gather_dim``'s padding)."""
    n, size = _state.ctx.sizes[i], g.shape[d]
    step = -(-size // n)
    if step * n > size:
        pad = list(g.shape)
        pad[d] = step * n - size
        g = torch.cat([g, g.new_zeros(pad)], dim=d)
    parts = [c.contiguous() for c in torch.split(g, step, dim=d)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=current_mesh().get_group(i))
    lo = min(_state.ctx.coords[i] * step, size)
    return out.narrow(d, 0, min(lo + step, size) - lo)


def _gather_dims(t, lay, dims_of, shape):
    for d in dims_of:
        t = _gather(t, d, members(lay[d]), shape[d])
    return t


class _Weight(torch.autograd.Function):
    """FSDP's gather at use; backward: over the data-parallel dims a
    reduce-scatter (a sum), over any other a take of this rank's chunk."""

    @staticmethod
    def forward(ctx, t, lay, dims_of, shape, dp):
        ctx.lay, ctx.dims_of, ctx.dp, ctx.snap = lay, dims_of, dp, snapshot()
        return _gather_dims(t, lay, dims_of, shape)

    @staticmethod
    def backward(ctx, g):
        with restored(ctx.snap):
            for d in reversed(ctx.dims_of):
                for i in members(ctx.lay[d]):              # major to minor
                    g = _reduce_scatter_dim(g, d, i) if i in ctx.dp else _take(g, d, (i,))
        return g, None, None, None, None


def _dp_dims() -> tuple:
    split = getattr(_state, "split", None)
    return split[2] if split is not None else ()


def weight(w, keep=()) -> tuple[torch.Tensor, tuple]:
    """A parameter's local tensor and layout, gathered over every mesh dim
    it is split on along a tensor dim not in ``keep`` (FSDP's gather at
    use): the layer computes on the split it keeps.  A split over a
    data-parallel dim of :func:`split_batch` is never kept (the ranks along
    it hold other batch rows).  A plain tensor comes back as it is, whole."""
    t, lay = placed(w)
    if not any(lay):
        return t, lay
    dp = _dp_dims()
    keep = {k % len(lay) for k in keep if not set(lay[k % len(lay)]) & set(dp)}
    dims_of = tuple(d for d, dims in enumerate(lay) if members(dims) and d not in keep)
    out = tuple(dims if d in keep else () for d, dims in enumerate(lay))
    if not dims_of:
        return t, out
    if _tracked(t):
        return _Weight.apply(t, lay, dims_of, tuple(w.shape), dp), out
    return _gather_dims(t, lay, dims_of, tuple(w.shape)), out


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


def all_reduce_max(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` (no gradient) maximized over mesh ``dims``, in place."""
    for g in _groups(dims):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


# ---------------------------------------------------------------------------
# a sequence split over act_seq (long-context serving; no gradient): the
# causal attention's halo, the MoE's prefix sum of expert counts, the last
# rank's broadcast (the non-causal attention's whole sequence is `gather`'s)
# ---------------------------------------------------------------------------

def seq_dim():
    """The mesh dim with more than one member that ``act_seq`` maps to
    under the active rules, or None (no rules, ``act_seq`` whole, or a
    one-member dim: then the sequence is not split and every op below is
    the identity)."""
    if not rules_active():
        return None
    dims = members(mesh_dims("act_seq"))
    if len(dims) > 1:
        raise NotImplementedError(f"act_seq over several mesh dims {dims}: the sequence is "
                                  f"split over one")
    return dims[0] if dims else None


def member_range(size: int, i: int, c: int) -> tuple[int, int]:
    """[lo, hi) of a dim of ``size`` that member ``c`` of mesh dim ``i``
    holds, in :func:`chunk_range`'s chunks of ceil(size / n)."""
    step = -(-size // _state.ctx.sizes[i])
    return min(c * step, size), min((c + 1) * step, size)


@contextlib.contextmanager
def sequence(total: int):
    """Inside: the layers run on this rank's chunk of a sequence of
    ``total`` positions split over :func:`seq_dim` (the sequence-sharded
    prefill); :func:`seq_split` reads it."""
    prev = getattr(_state, "seq", None)
    _state.seq = total
    try:
        yield
    finally:
        _state.seq = prev


def seq_split():
    """``(mesh dim, lo, hi, total)``: this rank's positions [lo, hi) of a
    sequence of ``total`` split over mesh dim ``i`` inside :func:`sequence`
    under rules that split ``act_seq``; else None."""
    total = getattr(_state, "seq", None)
    i = seq_dim() if total is not None else None
    if i is None:
        return None
    return (i,) + member_range(total, i, coordinate(i)) + (total,)


def halo(x: torch.Tensor, d: int, length: int | None) -> torch.Tensor:
    """The ``length`` positions before this rank's chunk (all of them for
    ``None``; fewer near the sequence's start) of a sequence split by
    :func:`seq_split` along tensor dim ``d`` of ``x``, this rank's chunk:
    a shift along the ring, one hop a member the halo spans -- member c - t
    sends member c what of its chunk falls in c's halo, all hops posted at
    once -- concatenated in position order.  An empty slice of ``x`` where
    the sequence is not split."""
    split = seq_split()
    if split is None:
        return x.narrow(d, 0, 0)
    i, lo, _hi, total = split
    n, c = _state.ctx.sizes[i], coordinate(i)
    group = current_mesh().get_group(i)

    def part(src: int, dst: int) -> tuple[int, int]:
        """The positions of member src's chunk in member dst's halo."""
        s0, s1 = member_range(total, i, src)
        h1 = member_range(total, i, dst)[0]
        h0 = 0 if length is None else max(h1 - length, 0)
        return max(s0, h0), min(s1, h1)

    ops, recvs = [], []
    for t in range(1, n):
        if c + t < n:
            a, b = part(c, c + t)
            if b > a:
                ops.append(dist.P2POp(dist.isend, x.narrow(d, a - lo, b - a).contiguous(),
                                      dist.get_global_rank(group, c + t), group))
        if c - t >= 0:
            a, b = part(c - t, c)
            if b > a:
                shape = list(x.shape)
                shape[d] = b - a
                buf = x.new_empty(shape)
                recvs.append((a, buf))
                ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, c - t),
                                      group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if not recvs:
        return x.narrow(d, 0, 0)
    return torch.cat([buf for _a, buf in sorted(recvs, key=lambda r: r[0])], dim=d)


def seq_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (a small tensor: the MoE's (B, E) counts) over the
    members of :func:`seq_dim` before this rank -- an exclusive prefix sum
    along the sequence, from one all-gather.  Zeros where :func:`seq_dim`
    is None."""
    i = seq_dim()
    if i is None:
        return torch.zeros_like(x)
    parts = _gather_dim(x[None], 0, i, _state.ctx.sizes[i])
    return parts[:coordinate(i)].sum(0)


def broadcast(x: torch.Tensor, i: int, member: int) -> torch.Tensor:
    """``x`` of member ``member`` of mesh dim ``i`` on every member of it,
    in place (the identity on one member)."""
    if _state.ctx.sizes[i] > 1:
        group = current_mesh().get_group(i)
        dist.broadcast(x, src=dist.get_global_rank(group, member), group=group)
    return x


# ---------------------------------------------------------------------------
# the batch split of a data-parallel step
# ---------------------------------------------------------------------------

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
def split_batch(groups, members: int, dims=()):
    """Inside: the batch is split over ``members`` ranks, one shard a rank;
    ``groups`` are the process groups of the data-parallel mesh axes and
    ``dims`` their mesh dims (:func:`weight` reduce-scatters over them)."""
    prev = getattr(_state, "split", None)
    _state.split = (tuple(groups), members, tuple(dims))
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
    groups, members = split[:2]
    return _AllReduceSum.apply(local, groups) / members


def batch_grad(g: torch.Tensor, layout) -> torch.Tensor:
    """A leaf's gradient over the whole batch of :func:`split_batch`: its
    sum over the data-parallel dims the leaf is split on was taken in
    :func:`weight`'s backward; here it is summed over the others and
    divided by the split's members (each shard's loss is its own mean)."""
    split = getattr(_state, "split", None)
    if split is None or split[1] == 1:
        return g
    held = {i for dims in layout for i in dims}
    groups = _groups(tuple(i for i in split[2] if i not in held))
    if groups:
        g = all_reduce_sum(g.contiguous(), groups)
    return g / split[1]
