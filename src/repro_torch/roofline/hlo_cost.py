"""Op counter for one step: flops, bytes and collective bytes per device.

Counterpart of ``repro/roofline/hlo_cost.py``, which parses XLA's
per-device HLO text and multiplies each ``while`` body by its trip count.
The port's step runs eagerly, op by op, so :class:`OpCounter` is a
``TorchDispatchMode`` that sees every op that runs: a loop is counted by
nature, each of its iterations being ops that run.  Nothing of the XLA
text parsing is carried over.

Per op (the traffic model):
  flops        -- ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm,
                  baddbmm, convolution, the attention ops) and the one
                  ``kernels/flash_attention.py`` registers for the port's
                  flash op;
  bytes        -- the op's tensor inputs plus its outputs.  An upper bound
                  on the device traffic: eager ops do not fuse, so every
                  intermediate counts as written and read again
                  (``roofline/analysis.py`` keeps it as the ceiling beside
                  its memory floor).  Views and the collectives' own
                  buffers count nothing;
  collectives  -- per-device output bytes of each ``c10d`` collective op
                  (a ``ProcessGroup``'s: the reduced buffer, the gathered
                  whole, the scattered shard, what a send sends), by kind
                  and by the mesh axis
                  of its group; a group of one member moves nothing and
                  counts nothing;
  live bytes   -- the op outputs still referenced, and their peak (views
                  excluded): under ``FakeTensorMode`` the dry-run's
                  measure of the step's temporaries.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# the c10d ops of the port's collectives, by kind; each takes first its
# output (the all-reduce its buffer, a send what it sends).  Others
# (barrier, broadcast, gather, recv) count nothing
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter(mesh) as c:`` (see the
    module docstring): ``c.flops``, ``c.bytes``, ``c.coll``,
    ``c.coll_by_axis``, ``c.ops``, ``c.peak_live``.  A collective's axis is
    the ``mesh`` dim whose process group it ran on, ``"group"`` for a group
    of no dim of ``mesh`` (or with no mesh)."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        import repro_torch.kernels.flash_attention  # noqa: F401  (registers the flash op's flops)

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = dict.fromkeys(COLL_KINDS, 0)
        self.coll_by_axis: dict[str, dict[str, int]] = {}
        self.live = 0
        self.peak_live = 0
        self.axes = {}                 # process group name -> mesh axis
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                if mesh.size(i) > 1:
                    self.axes[mesh.get_group(i).group_name] = name

    def _collective(self, func, args) -> None:
        kind = _C10D_KINDS.get(func._schema.name.split("::")[-1])
        if kind is None:
            return
        from torch.distributed import ProcessGroup

        names = [a.name for a in func._schema.arguments]
        pg = ProcessGroup.unbox(args[names.index("process_group")])
        if pg.size() == 1:
            return
        n = sum(_nbytes(t) for t in tree_flatten(args[0])[0])
        axis = self.axes.get(pg.group_name, "group")
        self.coll[kind] += n
        self.coll_by_axis.setdefault(axis, dict.fromkeys(COLL_KINDS, 0))[kind] += n

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if func.namespace == "c10d":
                self._collective(func, args)
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if _is_view(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        fresh = [t for t in outs if not any(t is i for i in ins)]
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_live = max(self.peak_live, self.live)
        return out
