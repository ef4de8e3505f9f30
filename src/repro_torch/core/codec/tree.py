"""Tree front-end: TreeCodec (multi-leaf container-v3 streams).

Counterpart of ``repro/core/codec/tree.py``.  :meth:`TreeCodec.compress_tree`
writes a nested dict / list / tuple / NamedTuple of tensors (or numpy
arrays) as ONE container-v3 stream: small leaves (integers, step counters,
tiny floats) back to back in a shared raw frame 0, each large float leaf as
chunk frames through the port's :class:`SZxCodec` -- on the card, so a
leaf already there is encoded in place and only its stream bytes cross to
the host -- and the seekable index footer naming every leaf.  Leaf names
and walk order are the reference's (:mod:`repro_torch.core.pytree`), so for
the same tree of arrays the stream is byte-identical to the reference's,
and each package restores the other's.

:meth:`TreeCodec.decompress_tree` restores every leaf, the leaves of a
template, or -- with ``select=`` -- reads ONLY the named leaves' byte
ranges.  Leaves come back as tensors on the codec's device.

The error bound is resolved PER LEAF over the leaf's full value range.
:meth:`TreeCodec.compress_tree_sharded` splits each large float leaf into
the reference's block-aligned flat ranges, one per member of a mesh axis:
member i encodes its range on its own device, and the payloads are
gathered to the writer (the rank at mesh coordinate 0), which writes them
in shard order -- the file is byte-identical to the reference's.  Leaves
may be ``DTensor``s (the sharded training state), gathered leaf by leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import pytree
from repro_torch.core.codec import container, plan as plan_mod
from repro_torch.core.codec.plan import Bound
from repro_torch.core.codec.szx_codec import (
    DEFAULT_CHUNK_BYTES,
    SZxCodec,
    _imap_ordered,
    _on_worker_streams,
)
from repro_torch.kernels import specs

STREAM_KIND = "szx-tree"

# the manifest's dtype strings are numpy's names (ml_dtypes' for bfloat16)
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.uint16: "uint16",
    torch.uint32: "uint32", torch.uint64: "uint64", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_BY_NAME = {v: k for k, v in _DTYPE_NAMES.items()}


leaf_name = pytree.leaf_name        # '/'-joined key path, as the reference names leaves
leaf_paths = pytree.leaf_paths      # (name, leaf) pairs in the reference's walk order


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no stream dtype name for {dtype}") from None


def torch_dtype_for(name: str) -> torch.dtype:
    """torch dtype from its manifest string."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unknown dtype name {name!r}") from None


def as_leaf_tensor(leaf) -> torch.Tensor:
    """A leaf (tensor, numpy array or number) as a tensor; numpy bfloat16
    is taken by its bits, so no ``ml_dtypes`` import is needed."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    a = np.array(leaf, order="C")              # a copy; a 0-d leaf stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf as one tensor: a ``DTensor`` gathered from its shards (a
    collective: every rank of its mesh calls it)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


class _Discard:
    """A file object that keeps nothing: the stream of a rank that does not
    write it."""

    def write(self, data) -> int:
        return len(data)


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


@dataclass(frozen=True)
class TreeCodec:
    """Configured tree codec; instances are cheap and immutable.

    ``codec`` supplies the per-chunk byte codec (device, block size, worker
    pool, stage); ``bound`` (a :class:`Bound` or a bare float meaning
    ``Bound.abs``; default ``Bound.rel(1e-6)``) is resolved per leaf; leaves
    smaller than ``min_compress_elems`` or of a non-float dtype are stored
    raw in the shared pack frame."""

    codec: SZxCodec = field(default_factory=SZxCodec)
    bound: Bound | float | None = None
    chunk_bytes: int = DEFAULT_CHUNK_BYTES
    min_compress_elems: int = 1024

    def __post_init__(self):
        b = Bound.rel(1e-6) if self.bound is None else plan_mod.as_bound(
            self.bound, owner="TreeCodec")
        object.__setattr__(self, "bound", b)

    # ------------------------------------------------------------- compress
    def _compressible(self, t: torch.Tensor) -> bool:
        return t.dtype in specs.BY_DTYPE and t.numel() >= self.min_compress_elems

    def compress_tree(self, tree, fileobj, *, _leaf_payloads=None) -> dict:
        """Write ``tree`` as one container-v3 multi-leaf stream; returns the
        stream manifest (the dict stored in the index footer).

        Layout: frame 0 is the shared raw pack (every small/integer leaf
        back to back), then each large float leaf's chunk frames in leaf
        order; the index footer closes the stream.  ``_leaf_payloads(t)``
        yields a compressed leaf's (payload, last) pairs (default: its
        chunks through the codec)."""
        if _leaf_payloads is None:
            def _leaf_payloads(t):
                return self.codec.iter_chunk_payloads(t, self.bound, chunk_bytes=self.chunk_bytes)

        leaves = [(name, as_leaf_tensor(leaf)) for name, leaf in leaf_paths(tree)]
        raw_leaves = [(n, t) for n, t in leaves if not self._compressible(t)]
        big_leaves = [(n, t) for n, t in leaves if self._compressible(t)]

        manifest: dict = {
            "v": container.INDEX_VERSION,
            "kind": STREAM_KIND,
            "leaves": [],
            "frames": [],
        }
        # frame 0: the shared raw pack, written leaf by leaf; every stream
        # carries it (possibly empty), and it is the LAST frame when no
        # compressed leaf follows
        pack_size = sum(t.numel() * t.element_size() for _, t in raw_leaves)
        flags = container.FLAG_RAW | (0 if big_leaves else container.FLAG_LAST)
        header = container.FRAME_HEADER.pack(
            container.FRAME_MAGIC, container.FRAME_VERSION, flags, 0, pack_size)
        manifest["frames"].append([0, len(header) + pack_size])
        fileobj.write(header)
        written = len(header)
        inner = 0
        for name, t in raw_leaves:
            data = _raw_bytes(_whole(t))
            fileobj.write(data)
            manifest["leaves"].append({
                "name": name,
                "codec": "raw",
                "dtype": dtype_name(t.dtype),
                "shape": list(t.shape),
                "n": int(t.numel()),
                "raw_bytes": len(data),
                "stored_bytes": len(data),
                "frames": [0, 1],
                "pack": [inner, len(data)],
            })
            inner += len(data)
            written += len(data)
        seq = 1

        # large float leaves: one frame per chunk, encoded on the codec's
        # device; the LAST flag lands on the final leaf's final frame
        for li, (name, t) in enumerate(big_leaves):
            lo = seq
            stored = 0
            final_leaf = li == len(big_leaves) - 1
            with obs.span("tree.leaf_encode", leaf=name, elements=int(t.numel())):
                for payload, pl_last in _leaf_payloads(t):
                    frame = container.build_frame(payload, seq, last=final_leaf and pl_last,
                                                  stage=self.codec.stage,
                                                  device=self.codec.device)
                    manifest["frames"].append([written, len(frame)])
                    fileobj.write(frame)
                    written += len(frame)
                    stored += len(frame)
                    seq += 1
            manifest["leaves"].append({
                "name": name,
                "codec": "szx",
                "dtype": dtype_name(t.dtype),
                "shape": list(t.shape),
                "n": int(t.numel()),
                "raw_bytes": int(t.numel() * t.element_size()),
                "stored_bytes": stored,
                "frames": [lo, seq],
            })

        manifest["raw_bytes"] = int(sum(m["raw_bytes"] for m in manifest["leaves"]))
        manifest["stored_bytes"] = written
        fileobj.write(container.build_index_footer(manifest))
        return manifest

    def _sharded_leaf_payloads(self, t, group, writer: bool) -> Iterator[tuple[bytes, bool]]:
        """One block-aligned flat range of ``t`` per member of ``group``
        (``None``: this rank alone), each compressed by its member under
        the bound resolved over the WHOLE leaf -- a rel bound through a
        min/max all-reduce of the members' ranges -- so each payload is
        ``compress(range, e_abs)``, as the reference's.  The writer gets
        the payloads in range order; the other members yield nothing."""
        n = dist.get_world_size(group) if group is not None else 1
        me = dist.get_rank(group) if group is not None else 0
        flat = _whole(t).reshape(-1)
        bs = self.codec.block_size
        blocks_total = max((flat.numel() + bs - 1) // bs, 1)
        per = -(-blocks_total // n)                 # ceil: block-aligned ranges
        bounds = [min(i * per * bs, flat.numel()) for i in range(n + 1)]
        lo, hi = bounds[me], bounds[me + 1]
        e = self._whole_leaf_bound(flat[lo:hi], group, n)
        payload = self.codec.compress(flat[lo:hi], e) if hi > lo else None
        if n > 1:
            parts = [None] * n if writer else None
            dist.gather_object(payload, parts, dst=dist.get_global_rank(group, 0), group=group)
        else:
            parts = [payload]
        if not writer:
            return
        parts = [p for p in parts if p is not None] or [self.codec.compress(flat, e)]
        for i, pl in enumerate(parts):
            yield pl, i == len(parts) - 1

    def _whole_leaf_bound(self, part: torch.Tensor, group, n: int) -> float:
        """The absolute bound of the leaf whose range ``part`` this member
        holds: the rel range taken over every member's values."""
        if self.bound.mode != "rel" or n == 1:
            return plan_mod.resolve_error_bound(part, self.bound)
        ext = torch.tensor([-math.inf, -math.inf], dtype=torch.float64, device=part.device)
        if part.numel():
            ext = torch.stack([-part.min().to(torch.float64), part.max().to(torch.float64)])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
        lo_hi = torch.stack([-ext[0], ext[1]]).to(part.dtype)
        return plan_mod.resolve_error_bound(lo_hi, self.bound, spec=specs.spec_for(part.dtype))

    def compress_tree_sharded(self, tree, fileobj, mesh, *, axis: str = "data") -> dict:
        """Sharded :meth:`compress_tree`, run by every rank of ``mesh``: the
        members along mesh ``axis`` (at coordinate 0 of the other axes)
        each compress their block-aligned range of every large float leaf
        on their own device, and the writer -- the rank at coordinate 0 --
        writes the stream to ``fileobj`` (ignored elsewhere).  Shard
        payloads land in shard order, so :meth:`decompress_tree` restores
        them as chunks.  Returns the writer's manifest on every rank."""
        names = list(mesh.mesh_dim_names)
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {tuple(names)})")
        coords = mesh.get_coordinate()
        ai = names.index(axis)
        active = all(c == 0 for i, c in enumerate(coords) if i != ai)
        writer = active and coords[ai] == 0
        group = mesh.get_group(ai) if mesh.size(ai) > 1 else None

        def payloads(t):
            if not active:                  # gathers its DTensor leaves, encodes nothing
                _whole(t)
                return iter(())
            return self._sharded_leaf_payloads(t, group, writer)

        manifest = self.compress_tree(tree, fileobj if writer else _Discard(),
                                      _leaf_payloads=payloads)
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [manifest if writer else None]
            dist.broadcast_object_list(box, src=mesh.mesh.reshape(-1)[0].item())
            manifest = box[0]
        return manifest

    # ----------------------------------------------------------- decompress
    def read_manifest(self, fileobj) -> dict:
        idx = container.read_index_footer(fileobj)
        if idx is None:
            raise ValueError("not a TreeCodec stream (no container-v3 index footer)")
        if idx.get("kind") != STREAM_KIND:
            raise ValueError(f"not a TreeCodec stream (footer kind {idx.get('kind')!r})")
        return idx

    def _restore_leaf(self, fileobj, idx: dict, meta: dict) -> torch.Tensor:
        if not obs.enabled():
            return self._restore_leaf_impl(fileobj, idx, meta)
        with obs.span("tree.leaf_decode", leaf=meta.get("name", "")):
            return self._restore_leaf_impl(fileobj, idx, meta)

    def _restore_leaf_impl(self, fileobj, idx: dict, meta: dict) -> torch.Tensor:
        dtype = torch_dtype_for(meta["dtype"])
        shape = tuple(meta["shape"])
        dev = self.codec.device
        if meta["codec"] == "raw":
            frame_off, _len = idx["frames"][meta["frames"][0]]
            inner, size = meta["pack"]
            fileobj.seek(frame_off + container.FRAME_HEADER.size + inner)
            data = bytearray(container._read_exact(fileobj, size))
            t = torch.frombuffer(data, dtype=torch.uint8) if size else \
                torch.empty(0, dtype=torch.uint8)
            return t.view(dtype).reshape(shape).to(dev)
        lo, hi = meta["frames"]
        # each frame decodes straight into its slice of the leaf (out=)
        flat = torch.empty(meta["n"], dtype=dtype, device=dev)

        def jobs() -> Iterator[tuple[bytes, int, int]]:
            off = 0
            for i in range(lo, hi):
                foff, length = idx["frames"][i][:2]
                payload, _flags = container.read_frame_at(fileobj, foff, length, i, device=dev)
                _code, fn, _e = container.peek_stream_meta(payload)
                if off + fn > flat.numel():
                    raise ValueError(
                        f"leaf {meta['name']}: stream has more than the "
                        f"manifest's {meta['n']} elements")
                yield payload, off, int(fn)
                off += int(fn)

        def decode(job: tuple[bytes, int, int]) -> torch.Tensor:
            payload, off, fn = job
            return self.codec.decompress(payload, out=flat[off:off + fn])

        if self.codec.workers > 1 and hi - lo > 1:
            parts = _imap_ordered(_on_worker_streams(decode, dev), jobs(), self.codec.workers)
        else:
            parts = map(decode, jobs())
        filled = sum(part.numel() for part in parts)
        if filled != flat.numel():
            raise ValueError(f"leaf {meta['name']}: stream has {filled} elements, "
                             f"manifest says {meta['n']}")
        return flat.reshape(shape)

    def decompress_tree(self, fileobj, *, select: Iterable[str] | None = None,
                        template=None):
        """Restore leaves from a TreeCodec stream (seekable file object).

        ``select``: leaf names -- read ONLY those leaves' byte ranges (plus
        the index footer); returns ``{name: tensor}``.  ``template``: a tree
        -- restore every template leaf by name and return the filled tree.
        With neither, returns ``{name: tensor}`` for every leaf."""
        if select is not None and template is not None:
            raise ValueError("pass select= or template=, not both")
        idx = self.read_manifest(fileobj)
        by_name = {m["name"]: m for m in idx["leaves"]}

        def restore(name: str) -> torch.Tensor:
            meta = by_name.get(name)
            if meta is None:
                raise KeyError(f"leaf {name!r} not in stream")
            return self._restore_leaf(fileobj, idx, meta)

        if select is not None:
            select = list(select)
            if len(set(select)) != len(select):
                dupes = sorted({n for n in select if select.count(n) > 1})
                raise ValueError(f"duplicate leaf names in select=: {dupes}")
            return {name: restore(name) for name in select}
        if template is not None:
            return pytree.unflatten(template, [restore(n) for n, _ in leaf_paths(template)])
        return {m["name"]: self._restore_leaf(fileobj, idx, m) for m in idx["leaves"]}
