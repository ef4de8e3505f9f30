"""Production mesh + partition-spec rules for parameters, batches and caches.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a
FUNCTION (importing this module touches no process group): single pod
(16, 16) = 256 cards ('data', 'model'); multi-pod (2, 16, 16) = 512 cards
('pod', 'data', 'model') -- 'pod' is the slow dimension, where the SZx
gradient compression applies.  The mesh is ``torch.distributed``'s
``DeviceMesh``; every function here reads only its ``mesh_dim_names`` and
``shape``, so a stand-in with those two attributes gives the same specs.

A spec is :class:`P`: one entry per tensor dim, each ``None``, a mesh axis
name, or a tuple of names (the dim split over those axes, major to minor),
as ``jax.sharding.PartitionSpec``.  The port's layers are a list (the
reference stacks them on a leading axis), so a layer leaf's spec has no
leading ``None``.  :class:`NamedSharding` turns a spec into ``DTensor``
placements: a name on tensor dim ``d`` is ``Shard(d)`` on that mesh dim,
every other mesh dim ``Replicate()``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import key_paths, tree_map
from repro_torch.models import sharding

MESH_SHAPES = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


class P:
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    Not a tuple, so that a tree of specs has specs for leaves.  Entries are
    normalized as ``PartitionSpec``'s: a tuple of one name is the name, an
    empty tuple ``None``."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        self.entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (P, tuple)):
            return self.entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return "P" + repr(self.entries)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, which
    must already hold 256 (512 with ``multi_pod``) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESH_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (or a stand-in with ``mesh_dim_names``
    and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# parameter partition specs (Megatron TP + optional FSDP over 'data')
# ---------------------------------------------------------------------------

def _param_rule(path: tuple[str, ...], ndim: int, cfg: ArchConfig) -> P:
    """The reference's rule for a parameter at ``path``, without its
    stacked-layer lead: the port's layers are a list."""
    name = path[-1]
    fsdp = "data" if cfg.fsdp else None

    if name in ("ln1", "ln2", "ln_cross", "final_ln", "norm", "dt_bias", "A_log", "D"):
        return P(*((None,) * ndim))
    if name == "embed":
        return P("model", fsdp)                           # vocab x d_model
    if name == "lm_head":
        return P(fsdp, "model")                           # d_model x vocab
    if name == "frontend_proj":
        return P(fsdp, "model")
    if name in ("wq", "wk", "wv", "wi", "in", "router", "shared_wi"):
        return P(fsdp, "model")                           # column parallel
    if name in ("wo", "out", "shared_wo"):
        return P("model", fsdp)                           # row parallel
    if name == "conv":
        return P(None, "model")                           # depthwise channels
    raise ValueError(f"no partition rule for param {'/'.join(path)}")


def _moe_rule(path, ndim, cfg: ArchConfig):
    name = path[-1]
    fsdp = "data" if cfg.fsdp else None
    if name == "wi":
        return P("model", fsdp, None)                     # (E, D, 2F): EP
    if name == "wo":
        return P("model", None, fsdp)                     # (E, F, D): EP
    return None


def _sanitize(spec: P, shape, mesh) -> P:
    """Drop mesh axes whose size doesn't divide the dim (e.g. hymba's SSM
    in-proj Z = 2*di + 2*N + H = 6482 on a 16-way 'model' axis): a shard
    is always even, so the bytes a device holds are the spec's."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = math.prod(sizes.get(a, 1) for a in axes)
        out.append(ax if dim % total == 0 else None)
    return P(*out)


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over a tree's leaves, in a tree of its structure."""
    paths = iter(key_paths(tree))
    return tree_map(lambda _leaf: fn(*next(paths)), tree)


def replicated_specs_tree(params_tree):
    """All-replicated specs (pure-DP profile for small models)."""
    return tree_map(lambda leaf: P(*((None,) * leaf.dim())), params_tree)


def serve_param_specs_tree(cfg: ArchConfig, params_tree, mesh=None):
    """Decode-oriented weight layout: no fsdp on the dense and attention
    weights, and MoE experts sharded over BOTH axes -- E over 'data', each
    expert's F over 'model' -- so no weight moves in a decode step."""
    cfg_noshard = dataclasses.replace(cfg, fsdp=False)

    def rule(path, leaf):
        if "moe" in path and path[-1] == "wi":
            return _sanitize(P("data", None, "model"), leaf.shape, mesh)
        if "moe" in path and path[-1] == "wo":
            return _sanitize(P("data", "model", None), leaf.shape, mesh)
        return _sanitize(_param_rule(path, leaf.dim(), cfg_noshard), leaf.shape, mesh)

    return _map_with_path(rule, params_tree)


def param_specs_tree(cfg: ArchConfig, params_tree, mesh=None):
    """Spec tree matching ``params_tree`` (parameters or their ``meta``
    stand-ins)."""

    def rule(path, leaf):
        if "moe" in path and path[-1] in ("wi", "wo"):
            spec = _moe_rule(path, leaf.dim(), cfg)
            if spec is not None:
                return _sanitize(spec, leaf.shape, mesh)
        return _sanitize(_param_rule(path, leaf.dim(), cfg), leaf.shape, mesh)

    return _map_with_path(rule, params_tree)


def param_shardings(cfg: ArchConfig, mesh, params_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), param_specs_tree(cfg, params_tree, mesh))


# ---------------------------------------------------------------------------
# batch / cache partition specs
# ---------------------------------------------------------------------------

def batch_specs_tree(cfg: ArchConfig, mesh, batch_tree, *, long_context: bool = False):
    """tokens/labels: (B, S); frames/image_embeds: (B, T, D)."""
    bspec = None if long_context else dp_axes(mesh)
    return tree_map(lambda leaf: _sanitize(P(bspec, *((None,) * (leaf.dim() - 1))),
                                           leaf.shape, mesh), batch_tree)


def cache_specs_tree(cfg: ArchConfig, mesh, cache_tree, *, long_context: bool = False):
    """Decode-cache sharding.  Dense KV slabs (L, B, W, Hkv, hd): batch over
    DP, head_dim over 'model'.  Long-context (B = 1): batch replicated, the
    window over 'data' (sequence parallelism).  The cache's slabs are
    stacked over the layers as the reference's are."""
    dp = dp_axes(mesh)
    b_ax = None if long_context else dp
    w_ax = "data" if long_context else None

    def rule(path, leaf):
        name = path[-1]
        if name in ("pos", "slot_pos"):
            return P(*((None,) * leaf.dim()))
        if name in ("k", "v"):                     # (L,B,W,Hkv,hd) [cross: no W ring]
            return P(None, b_ax, w_ax, None, "model")
        if name.endswith("mu") or name.endswith("sexp"):   # (L,B,W,Hkv)
            return P(None, b_ax, w_ax, None)
        if name.endswith("pl"):                    # (L,P,B,W,Hkv,hd)
            return P(None, None, b_ax, w_ax, None, "model")
        if name == "state":                        # (L,B,H,N,hp)
            return P(None, b_ax, "model", None, None)
        if name == "conv":                         # (L,B,W-1,CC)
            return P(None, b_ax, None, "model")
        raise ValueError(f"no cache rule for {'/'.join(path)}")

    return _map_with_path(lambda path, leaf: _sanitize(rule(path, leaf), leaf.shape, mesh),
                          cache_tree)


# ---------------------------------------------------------------------------
# specs as DTensor placements, and the local shard of a device
# ---------------------------------------------------------------------------

def spec_mesh_dims(spec: P, mesh) -> dict[int, int]:
    """{mesh dim index: tensor dim} for every mesh axis ``spec`` names."""
    names = list(mesh.mesh_dim_names)
    out = {}
    for d, ax in enumerate(spec):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must follow the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if i in out:
                raise ValueError(f"spec {spec} names mesh axis {names[i]!r} twice")
            out[i] = d
    return out


def spec_layout(spec: P, mesh) -> tuple:
    """``spec`` as a layout (``models/sharding.py``): one entry a tensor
    dim, the mesh dim indices it is split over in mesh order."""
    out = [()] * len(spec)
    for i, d in sorted(spec_mesh_dims(spec, mesh).items()):
        out[d] += (i,)
    return tuple(out)


def placements(spec: P, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``, one per mesh dim."""
    return sharding.placements(spec_layout(spec, mesh), mesh)


def layout_spec(layout, mesh) -> P:
    """A layout (``models/sharding.py``) as a spec: :func:`spec_layout`'s
    inverse."""
    names = mesh.mesh_dim_names
    return P(*(tuple(names[i] for i in dims) or None for dims in layout))


def local_index(spec: P, shape, mesh, coords) -> tuple:
    """The slices of a tensor of ``shape`` that the device at mesh
    ``coords`` holds under ``spec``: each sharded dim cut into chunks of
    ceil(size / n) over its axes, major to minor (``DTensor``'s ``Shard``
    of each mesh dim in turn)."""
    sizes = tuple(mesh.shape)
    lo, hi = [0] * len(shape), list(shape)
    for i, d in sorted(spec_mesh_dims(spec, mesh).items()):
        n = sizes[i]
        step = -(-(hi[d] - lo[d]) // n)
        start = min(lo[d] + coords[i] * step, hi[d])
        lo[d], hi[d] = start, min(start + step, hi[d])
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def local_shape(spec: P, shape, mesh, coords=None) -> tuple:
    idx = local_index(spec, shape, mesh, coords or (0,) * len(tuple(mesh.shape)))
    return tuple(s.stop - s.start for s in idx)


def from_local(local, spec: P, shape, mesh):
    """A ``DTensor`` of global ``shape`` whose shard on this rank is
    ``local``, placed by ``spec``."""
    return sharding.from_local(local, spec_layout(spec, mesh), shape, mesh)


def shard_tree(tree, spec_tree, mesh):
    """A tree of whole tensors (``param_tree`` of ``params_from_jax`` or
    ``init_params``) as ``DTensor``s of this rank's shards placed by
    ``spec_tree``: no communication.  A shard that is the whole leaf shares
    its storage; any other is a copy of its slice, so the rank keeps no
    whole leaf beyond the caller's."""
    import torch

    def leaf(full, spec):
        if not isinstance(full, torch.Tensor):
            return full
        part = full[local_index(spec, full.shape, mesh, mesh.get_coordinate())]
        part = part if part.numel() == full.numel() else part.clone()
        return from_local(part, spec, full.shape, mesh)

    return tree_map(leaf, tree, spec_tree)


def shard_cache(cache: dict, spec_tree, mesh) -> dict:
    """:func:`shard_tree` for a cache made by ``serve.engine.make_cache``
    (or a prefill's), placed by ``spec_tree`` (``cache_specs_tree``'s over
    ``engine.cache_specs``); ``pos`` stays the Python int it is."""
    out = shard_tree({k: v for k, v in cache.items() if k != "pos"},
                     {k: v for k, v in spec_tree.items() if k != "pos"}, mesh)
    return {"pos": cache["pos"], **out}


def serve_cache_specs(mesh, cache_tree):
    """The specs the serving engine keeps a cache (``engine.cache_specs``'
    tree) in under the active rules (``engine.cache_layout``):
    :func:`cache_specs_tree`'s under ``DEFAULT_RULES``, the batch over
    ``act_batch``'s axes and head_dim over ``act_hd``'s under another
    table -- but an SSM state is split over its heads' axes also where they
    do not divide its heads (hymba-1.5b's 50 on 16: chunks of 4, as the
    layers run them), where :func:`cache_specs_tree` keeps it whole."""
    from repro_torch.serve.engine import cache_layout

    return _map_with_path(lambda path, leaf: layout_spec(cache_layout(path[-1], leaf.shape),
                                                         mesh), cache_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``'s counterpart."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local_index(self, shape) -> tuple:
        """The slices this process's device holds of a tensor of ``shape``."""
        return local_index(self.spec, shape, self.mesh, self.mesh.get_coordinate())

    def shard(self, full):
        """A ``DTensor`` of ``full`` (the whole tensor, present on every
        rank) keeping only this rank's shard: no communication."""
        return from_local(full[self.local_index(full.shape)].contiguous(), self.spec,
                          full.shape, self.mesh)
