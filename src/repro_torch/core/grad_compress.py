"""SZx gradient and activation compression for collectives on slow links.

Compression pays off where links are slowest: the data-parallel reduction
across hosts and the point-to-point shifts of pipeline parallelism.  The
collectives here run on ``torch.distributed`` (NCCL on the card, gloo on
the CPU) over a process group, whose size is the number of members:

  - :func:`compressed_psum_mean`: per leaf, szx-planes-encode the gradient
    (per-block mu + sexp + P uint8 planes), all-gather the (~4x smaller at
    P=1) encoding, decode every member's and mean them; return the local
    compression residual for error feedback (the caller adds it to the next
    step's gradient, so the compression error is re-applied instead of lost);
  - :func:`compressed_ppermute`: a point-to-point shift of the encoding;
  - :func:`compressed_all_to_all`: a tiled all-to-all of the encoding.

Blocks run along the LAST axis of each leaf.  On the wire sexp is int16, as
in the reference; it travels as a ``uint8`` view of the same bytes, since
neither gloo nor NCCL moves int16.  Results are bit-identical to the
reference's jax route: float steps flush subnormals as it does
(``kernels.ref``), and the mean multiplies by ``1/n`` as XLA does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.codec import DeviceEncoding, PlanesCodec
from repro_torch.core.pytree import tree_map
from repro_torch.kernels import ref

DEFAULT_BLOCK = 64
_ARRAYS = ("mu", "sexp", "planes")


def _record_wire(op: str, x: torch.Tensor, enc: DeviceEncoding, members: int = 1) -> None:
    """Wire accounting of one collective call (telemetry on): the bytes of
    ``x`` and of its encoding, times the members that send one, as the
    reference counts one traced call."""
    if not obs.enabled():
        return
    raw = x.numel() * x.element_size()
    wire = sum(enc[k].numel() * enc[k].element_size() for k in _ARRAYS)
    obs.counter("collective.calls", op=op).inc()
    obs.counter("collective.raw_bytes", op=op).inc(raw * members)
    obs.counter("collective.wire_bytes", op=op).inc(wire * members)


def _encode_leaf(g: torch.Tensor, num_planes: int, block: int) -> DeviceEncoding:
    """The shared encoding record (kind 'szx-planes') of one leaf, blocked
    along its last axis, with sexp narrowed to int16 for the wire."""
    enc = PlanesCodec(num_planes).encode_last_axis_device(g, block)
    return enc.replace(sexp=enc["sexp"].to(torch.int16))


def _decode_leaf(enc: DeviceEncoding, shape, dtype) -> torch.Tensor:
    return PlanesCodec(enc["planes"].shape[0]).decode_last_axis_encoding(enc, shape, dtype)


def _wire(name: str, a: torch.Tensor) -> torch.Tensor:
    """An encoding array as the collectives move it (int16 sexp as bytes)."""
    return a.contiguous().view(torch.uint8) if name == "sexp" else a.contiguous()


def _unwire(name: str, a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int16) if name == "sexp" else a


def compressed_psum_mean(grads, group=None, *, num_planes: int = 1,
                         block: int = DEFAULT_BLOCK):
    """Compressed all-reduce-mean of a nested dict (or list/tuple) of
    gradient tensors over ``group`` (default: the whole world).

    Returns ``(mean, residual)`` with the structure of ``grads``: the mean of
    the decoded per-member gradients (summed in member order from zero, then
    times 1/n) and this member's compression residual, in float32."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    inv_n = torch.tensor(1.0, dtype=torch.float32) / n

    def leaf(g):
        # gradcomp.decode twice a leaf: the local decode runs before the
        # all-gather, right after the encode whose planes it reads
        with obs.span("gradcomp.encode"):
            enc = _encode_leaf(g, num_planes, block)
        _record_wire("psum_mean", g, enc, members=n)
        with obs.span("gradcomp.decode"):
            dec_local = _decode_leaf(enc, g.shape, torch.float32)
            residual = ref.flush(ref.flush(g.to(torch.float32)) - dec_local)
        gathered = {}
        with obs.span("gradcomp.all_gather"):
            for name in _ARRAYS:
                wire = _wire(name, enc[name])
                parts = [torch.empty_like(wire) for _ in range(n)]
                dist.all_gather(parts, wire, group=group)
                gathered[name] = [_unwire(name, p) for p in parts]
        with obs.span("gradcomp.decode"):
            total = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for i in range(n):
                if i == me:              # this member's own encoding: decoded above
                    dec = dec_local
                else:
                    member = enc.replace(**{k: gathered[k][i] for k in _ARRAYS})
                    dec = _decode_leaf(member, g.shape, torch.float32)
                total = ref.flush(total + dec)
            # times 1/n; 1/1 leaves the (already flushed) total's bits unchanged
            mean = total if n == 1 else ref.mul_flushed(total, inv_n.to(total.device))
        return mean.to(g.dtype), residual

    pairs = []
    mean = tree_map(lambda g: pairs.append(leaf(g)) or pairs[-1][0], grads)
    rest = iter(pairs)
    return mean, tree_map(lambda g: next(rest)[1], grads)


def _group_rank(group, r: int) -> int:
    """Global rank of member ``r`` of ``group``."""
    return r if group is None else dist.get_global_rank(group, r)


def ppermute(a: torch.Tensor, group, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` of one tensor: member ``src`` sends to ``dst`` for
    every pair of ``perm``; a member that receives nothing gets zeros.  A
    pair from a member to itself is a local copy (gloo refuses a send to
    self)."""
    me = dist.get_rank(group)
    out = torch.zeros_like(a)
    ops = []
    for src, dst in perm:
        if src == dst == me:
            out.copy_(a)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, a, _group_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _group_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def compressed_ppermute(x: torch.Tensor, group, perm, *, num_planes: int = 1,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """szx-planes-compressed ``ppermute`` over ``group``.

    Encodes ``x`` along its last axis, sends the encoding arrays along the
    (src, dst) member pairs of ``perm`` and decodes on the receiving member
    (zeros where a member receives nothing).  The activation shift of
    pipeline parallelism (``pipeline_par.gpipe``) is the intended caller: the
    wire moves ``wire_bytes_per_value`` bytes/value instead of 4.0.
    """
    enc = _encode_leaf(x, num_planes, block)
    _record_wire("ppermute", x, enc)
    moved = enc.replace(**{
        k: _unwire(k, ppermute(_wire(k, enc[k]), group, perm)) for k in _ARRAYS})
    return _decode_leaf(moved, x.shape, x.dtype)


def _all_to_all(a: torch.Tensor, group, n: int, split_axis: int, concat_axis: int):
    """Tiled ``jax.lax.all_to_all``: chunk j of ``split_axis`` goes to member
    j; the chunks received are concatenated along ``concat_axis`` in member
    order."""
    moved = a.movedim(split_axis, 0)
    inp = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:])).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat([out[i].movedim(0, split_axis) for i in range(n)], dim=concat_axis)


def compressed_all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
                          *, num_planes: int = 1, block: int = DEFAULT_BLOCK):
    """szx-planes-compressed tiled ``all_to_all`` over ``group``.

    Encodes along the LAST axis (which becomes the block grid and must not
    be the split/concat axis), moves each encoding array with a tiled
    all-to-all -- the ``planes`` array's leading plane axis shifts the
    operand axes by one -- and decodes to the post-exchange shape.
    """
    if x.dim() < 2:
        raise ValueError("compressed_all_to_all needs >= 2 dims (last = blocks)")
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    if x.dim() - 1 in (split_axis, concat_axis):
        raise ValueError(
            "compressed_all_to_all cannot split/concat the blocked last axis"
        )
    n = dist.get_world_size(group)
    enc = _encode_leaf(x, num_planes, block)
    _record_wire("all_to_all", x, enc)
    moved = {}
    for k in _ARRAYS:
        lead = 1 if k == "planes" else 0
        a = _all_to_all(_wire(k, enc[k]), group, n, split_axis + lead, concat_axis + lead)
        moved[k] = _unwire(k, a.contiguous())
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return _decode_leaf(enc.replace(**moved), tuple(shape), x.dtype)


def wire_bytes_per_value(num_planes: int, block: int = DEFAULT_BLOCK) -> float:
    """Bytes per gradient value moved by the collectives (vs 4.0 raw)."""
    return PlanesCodec(num_planes).wire_bytes_per_value(block)
