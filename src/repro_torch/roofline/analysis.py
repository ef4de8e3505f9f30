"""Roofline terms of one step from the dry-run's op counts, for the H100.

Counterpart of ``repro/roofline/analysis.py``, whose constants are a TPU's
and are not carried over.  The constants here are NVIDIA's data-sheet
values for the H100 SXM5 -- never measured by this repo:

    989 TFLOP/s dense bf16 (tensor cores) | 3.35 TB/s HBM3 |
    450 GB/s NVLink 4 a direction (900 GB/s both ways).

The terms come from :class:`repro_torch.roofline.hlo_cost.OpCounter` over
one step: flops as the ops that ran report them, collective bytes as the
step's ``c10d`` collectives move them.  Each term is a floor.  The memory
term's bytes are the step's arguments (state and batch a device, exact
from the specs) read once plus the peak of its temporaries written once:
a lower bound.  The counter's own byte count -- inputs plus outputs of
every eager op, nothing fused -- is an upper bound; it is kept beside as
``hbm_bytes_eager`` and decides neither ``bottleneck`` nor
``roofline_fraction``.  Ring-cost factors: an all-reduce moves ~2x its
buffer a device, the others ~1x.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.core.pytree import leaves

PEAK_FLOPS = 989e12          # bf16 dense, a card (data sheet)
HBM_BW = 3.35e12             # bytes/s, a card (data sheet)
LINK_BW = 450e9              # bytes/s NVLink, one direction (data sheet)


def wire_bytes(coll: dict[str, int]) -> float:
    """Effective per-device bytes on the wire (ring algorithm factors)."""
    return (
        2.0 * coll.get("all-reduce", 0)
        + 1.0 * coll.get("all-gather", 0)
        + 1.0 * coll.get("reduce-scatter", 0)
        + 1.0 * coll.get("all-to-all", 0)
        + 1.0 * coll.get("collective-permute", 0)
    )


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops of the ops that ran
    hbm_bytes: float             # per-device bytes the step must move (a floor)
    coll_bytes: float            # per-device effective wire bytes
    collectives: dict[str, int]
    model_flops: float           # analytic 6*N*D (global)
    chips: int
    collectives_by_axis: dict = dataclasses.field(default_factory=dict)
    hbm_bytes_eager: float = 0.0  # per-device bytes in and out of every op (a ceiling)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_memory_eager(self) -> float:
        return self.hbm_bytes_eager / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted flops -- catches remat and padding."""
        total = self.flops * self.chips
        return (self.model_flops / total) if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful compute time / max(terms): how close the *useful* work is
        to the dominating hardware limit."""
        t_useful = self.model_flops / self.chips / PEAK_FLOPS
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return (t_useful / bound) if bound else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "collectives": self.collectives,
            "collectives_by_axis": self.collectives_by_axis,
            "model_flops_global": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "hbm_bytes_eager_per_device": self.hbm_bytes_eager,
            "t_memory_eager_s": self.t_memory_eager,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(counter, *, model_flops: float, chips: int, argument_bytes: float) -> Roofline:
    """The roofline terms of the ops an ``OpCounter`` counted over a step
    whose arguments (state and batch) are ``argument_bytes`` a device."""
    return Roofline(
        flops=float(counter.flops),
        hbm_bytes=float(argument_bytes + counter.peak_live),
        coll_bytes=wire_bytes(counter.coll),
        collectives={k: int(v) for k, v in counter.coll.items()},
        model_flops=model_flops,
        chips=chips,
        collectives_by_axis={a: dict(v) for a, v in counter.coll_by_axis.items()},
        hbm_bytes_eager=float(counter.bytes),
    )


def train_model_flops(cfg, tokens: int) -> float:
    """6*N_active*D for one optimizer step over `tokens` tokens."""
    return 6.0 * cfg.active_param_count() * tokens


def decode_model_flops(cfg, batch: int) -> float:
    """2*N_active per generated token (fwd only); attention reads count in
    the memory term."""
    return 2.0 * cfg.active_param_count() * batch


def sharded_bytes_per_device(shape_tree, spec_tree, mesh) -> float:
    """Per-device bytes of a tree of tensors (``meta`` stand-ins or real)
    under a matching tree of specs: the shards of the device at mesh
    coordinate 0, which holds the largest chunk of a dim its axes do not
    divide (chunks of ceil(size / n), as the serving engine splits an SSM
    state's heads); where they divide, the reference's size / shards."""
    from repro_torch.launch.mesh import local_shape

    total = 0.0
    for leaf, spec in zip(leaves(shape_tree), leaves(spec_tree)):
        total += math.prod(local_shape(spec, leaf.shape, mesh)) * leaf.element_size()
    return total


def decode_floor_fraction(ideal_bytes_dev: float, rl: Roofline) -> float:
    """Decode is bandwidth-bound by construction: the floor is reading the
    sharded params + KV cache once per token.  Fraction = floor time over
    the dominating counted term."""
    t_floor = ideal_bytes_dev / HBM_BW
    bound = max(rl.t_compute, rl.t_memory, rl.t_collective)
    return (t_floor / bound) if bound else 0.0
