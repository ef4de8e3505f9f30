"""GPipe-style pipeline parallelism over a ``torch.distributed`` group.

Each rank of the group is one stage.  Microbatches stream through the stages
in the reference's schedule of (n_micro + n_stages - 1) ticks: every tick,
stage 0 takes microbatch t (zeros past the end), every stage applies its
``stage_fn``, the last stage emits microbatch (t - n_stages + 1), and each
stage's output shifts one rank along the ring -- raw, or szx-planes
compressed through ``grad_compress.compressed_ppermute``.  The outputs are
then summed over the group (zeros outside the last stage), so every rank
returns them, as the reference's ``psum`` does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import grad_compress


def pipeline_apply(
    stage_fn: Callable,        # (stage_params, x) -> y   (per-stage compute)
    group=None,
    *,
    compress_activations: bool = False,
    num_planes: int = 1,
    compress_block: int = 64,
):
    """Returns fn(stage_params, microbatches) -> outputs.

    stage_params: this rank's stage parameters (any object ``stage_fn`` takes).
    microbatches: (n_micro, mb, ...) input microbatches, the same on every
    rank (only stage 0 reads them).
    Output: (n_micro, mb, ...) as produced by the LAST stage, on every rank.

    ``compress_activations=True`` routes the per-tick shift through
    ``compressed_ppermute``: each stage encodes its output, sends the
    encoding (~4x fewer wire bytes at P=1) and the next stage decodes.
    Lossy (bounded by the planes budget); leave off for exact schedules.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def shift(y):
        if compress_activations:
            return grad_compress.compressed_ppermute(
                y, group, ring, num_planes=num_planes, block=compress_block)
        return grad_compress.ppermute(y.contiguous(), group, ring)

    def run(params, xs: torch.Tensor) -> torch.Tensor:
        n_micro = xs.shape[0]
        if obs.enabled():
            # bytes a stage shifts per tick, raw vs on the wire when compressed
            raw = xs[0].numel() * xs.element_size()
            wire = raw
            if compress_activations:
                wire = int(xs[0].numel() * grad_compress.wire_bytes_per_value(
                    num_planes, compress_block))
            obs.counter("pipeline.programs").inc()
            obs.gauge("pipeline.ticks").set(n_micro + n_stages - 1)
            obs.gauge("pipeline.tick_raw_bytes").set(raw)
            obs.gauge("pipeline.tick_wire_bytes").set(wire)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            if stage == 0:
                x = xs[t] if t < n_micro else torch.zeros_like(xs[0])
            else:
                x = buf
            y = stage_fn(params, x)
            emit = t - (n_stages - 1)
            if stage == n_stages - 1 and emit >= 0:
                outs[emit] = y
            buf = shift(y)
        dist.all_reduce(outs, group=group)
        return outs

    return run
