"""Block-addressable compressed array store: save/open + lazy ROI reads.

``ArrayStore.save`` writes an N-d array as a grid of independently
addressable SZx chunks (one container-v3 frame per chunk, footer =
block-grid index); ``ArrayStore.open`` returns a lazy :class:`CompressedArray`
whose ``__getitem__`` decodes ONLY the chunks -- and within each chunk only
the contiguous SZx block range -- intersecting the requested ROI.  Store
files are byte-identical to the JAX package's, and each package opens the
other's.

The read path is two-phase per intersecting chunk: (1) read the chunk's
metadata prefix (stream header, const bitmap, mu, reqlen, L codes -- a few
percent of the chunk) and (2) read exactly the mid-byte range of the
intersecting blocks (of a staged frame: only the segment records holding
them).  Bytes read therefore scale with the ROI, never the array, and
non-intersecting chunks are never even parsed.  The decode runs on the
store's device, by one of two routes that give bit-identical values:
the host parse (``container.extract_block_range`` + ``transform.decode_blocks``,
the unpack kernels) or, with ``fused_range=True``, the fused range decode
(``device.decode_range``, the decode kernel).

Arrays larger than one file shard across files: ``ArrayStore.save_sharded``
writes N shard files plus a JSON manifest (chunk-coord ranges -> shard
files); ``ArrayStore.open`` on the manifest path reads transparently across
the shards -- same chunk frames, same bytes per chunk, same API.
"""
from __future__ import annotations

import json
import math
import os
from typing import Iterator

import torch

from repro_torch import obs
from repro_torch.core.codec import container, device as device_mod, plan as plan_mod
from repro_torch.core.codec import stage as stage_mod, transform
from repro_torch.core.codec.szx_codec import SZxCodec, _imap_ordered, _on_worker_streams
from repro_torch.store import format as format_mod, grid as grid_mod, query as query_mod
from repro_torch.store.grid import ChunkGrid

DEFAULT_STORE_CHUNK_BYTES = grid_mod.DEFAULT_CHUNK_TARGET_BYTES


def _resolve_stage_name(stage) -> str | None:
    """Validate a ``stage=`` save option up front; returns the canonical
    stage name (or None).  Unknown stages and stages whose optional
    dependency is missing raise BEFORE any bytes are written."""
    if stage is None:
        return None
    code = stage_mod.resolve(stage)
    return stage_mod.name_of(code) if code else None


def _prepare(arr, bound, mode, error_bound, owner: str, device, chunk_shape,
             chunk_bytes, stage):
    """Shared front of save/save_sharded: (array on the device, grid, e,
    spec, stage name, device)."""
    b = plan_mod.as_bound(bound, mode, error_bound=error_bound, owner=owner, stacklevel=4)
    stage_name = _resolve_stage_name(stage)
    dev = device_mod.resolve_device(device, owner)
    x = plan_mod.as_tensor(arr, dev)
    if x.dim() == 0:
        raise ValueError("0-d arrays are not storable; reshape to (1,)")
    if x.numel() == 0:
        raise ValueError("empty arrays are not storable")
    spec = plan_mod.spec_for(x.dtype)
    grid = ChunkGrid.for_shape(
        tuple(x.shape), chunk_shape, itemsize=spec.itemsize, target_bytes=chunk_bytes,
    )
    e = plan_mod.resolve_error_bound(x, b, spec=spec)
    return x, grid, e, spec, stage_name, dev


class ArrayStore:
    """Namespace front-end: ``ArrayStore.save(...)`` / ``ArrayStore.open(...)``."""

    @staticmethod
    def save(
        path_or_file,
        arr,
        bound=None,
        *,
        mode: str | None = None,
        chunk_shape: tuple[int, ...] | None = None,
        chunk_bytes: int = DEFAULT_STORE_CHUNK_BYTES,
        block_size: int = plan_mod.DEFAULT_BLOCK_SIZE,
        device=None,
        workers: int = 1,
        attrs: dict | None = None,
        stage: str | int | None = None,
        error_bound: float | None = None,
    ) -> dict:
        """Write ``arr`` (a tensor or numpy array) as a chunk-grid store
        stream; returns the index dict.

        ``bound`` is a :class:`repro_torch.api.Bound` or a bare float
        (meaning ``Bound.abs``); it is resolved ONCE over the full array,
        then every chunk is compressed independently at that absolute
        bound -- each chunk payload is bit-identical to
        ``SZxCodec.compress`` of that chunk.  ``device`` is where the codec
        and the second stage run (``None``: the card, which must be there).
        ``workers > 1`` compresses chunk bodies on a thread pool, a CUDA
        stream each; the bytes on disk are identical for every worker count.
        """
        x, grid, e, spec, stage_name, dev = _prepare(
            arr, bound, mode, error_bound, "ArrayStore.save", device, chunk_shape,
            chunk_bytes, stage,
        )
        payloads = _chunk_payloads(x, grid, e, block_size=block_size, device=dev,
                                   workers=workers)
        f, own = _as_file(path_or_file, "wb")
        try:
            written = 0
            frames: list[list[int]] = []
            for cid, pl in enumerate(payloads):
                frame = container.build_frame(
                    pl, cid, last=cid == grid.nchunks - 1, stage=stage_name, device=dev,
                )
                frames.append([written, len(frame), grid.chunk_elements(grid.chunk_coord(cid))])
                f.write(frame)
                written += len(frame)
            idx = format_mod.build_store_index(
                grid, spec.code, block_size, e, frames, attrs, stage=stage_name,
            )
            f.write(container.build_index_footer(idx))
        finally:
            if own:
                f.close()
        return idx

    @staticmethod
    def save_sharded(
        manifest_path,
        arr,
        bound=None,
        *,
        nshards: int = 2,
        mode: str | None = None,
        chunk_shape: tuple[int, ...] | None = None,
        chunk_bytes: int = DEFAULT_STORE_CHUNK_BYTES,
        block_size: int = plan_mod.DEFAULT_BLOCK_SIZE,
        device=None,
        workers: int = 1,
        attrs: dict | None = None,
        stage: str | int | None = None,
        error_bound: float | None = None,
    ) -> dict:
        """Write ``arr`` as ``nshards`` shard files plus a JSON manifest at
        ``manifest_path``; returns the manifest dict.

        Chunk ids partition into contiguous balanced ranges, one per shard;
        every chunk frame carries its GLOBAL sequence number and is
        byte-identical to the frame :meth:`save` would write.  Shard files
        land next to the manifest as ``<stem>.shard-NNN.szs`` and each closes
        with its own ``szx-store-shard`` footer.
        """
        x, grid, e, spec, stage_name, dev = _prepare(
            arr, bound, mode, error_bound, "ArrayStore.save_sharded", device,
            chunk_shape, chunk_bytes, stage,
        )
        if not 1 <= nshards <= grid.nchunks:
            raise ValueError(
                f"nshards {nshards} out of range [1, {grid.nchunks}] "
                f"(one shard needs at least one chunk)"
            )
        payloads = _chunk_payloads(x, grid, e, block_size=block_size, device=dev,
                                   workers=workers)
        manifest_path = os.fspath(manifest_path)
        stem = manifest_path[:-5] if manifest_path.endswith(".json") else manifest_path
        base = os.path.dirname(manifest_path)
        bounds = [i * grid.nchunks // nshards for i in range(nshards + 1)]
        shards: list[dict] = []
        it = iter(payloads)
        for si, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            shard_path = f"{stem}.shard-{si:03d}.szs"
            frames: list[list[int]] = []
            with open(shard_path, "wb") as f:
                written = 0
                for cid in range(lo, hi):
                    # global seq; LAST closes each shard's frame sequence
                    frame = container.build_frame(
                        next(it), cid, last=cid == hi - 1, stage=stage_name, device=dev,
                    )
                    frames.append([written, len(frame),
                                   grid.chunk_elements(grid.chunk_coord(cid))])
                    f.write(frame)
                    written += len(frame)
                f.write(container.build_index_footer(
                    format_mod.build_shard_index(
                        grid, spec.code, block_size, e, (lo, hi), frames, attrs
                    )
                ))
            shards.append({
                "file": os.path.relpath(shard_path, base) if base
                else os.path.basename(shard_path),
                "chunks": [lo, hi],
                "frames": frames,
            })
        man = format_mod.build_store_manifest(
            grid, spec.code, block_size, e, shards, attrs, stage=stage_name,
        )
        with open(manifest_path, "w") as f:
            json.dump(man, f)
        return man

    @staticmethod
    def open(
        path_or_file, *, device=None, fused_range: bool = False,
        cache=None, cache_ns: str | None = None,
    ) -> "CompressedArray":
        """Open a store stream lazily: reads ONLY the index footer.

        A ``*.json`` path (or a parsed manifest dict) opens a SHARDED store:
        the manifest alone carries every frame byte range, so no shard file
        is read until a chunk is actually decoded.  ``device`` is where ROI
        reads and queries decode (``None``: the card, which must be there).
        ``fused_range`` is the JAX package's ``device=`` flag: ``False``
        decodes a ROI through the host parse and the unpack kernels
        (``extract_block_range`` + ``decode_blocks``), ``True`` through the
        fused range decode (``device.decode_range``, one copy of prefix +
        mid bytes per touched chunk); both give bit-identical values.
        ``cache`` (a mapping-like object with ``get(key)``/``put(key, value,
        nbytes)``) memoizes decoded chunk ranges under namespace
        ``cache_ns``.
        """
        dev = device_mod.resolve_device(device, "ArrayStore.open")
        kw = dict(device=dev, fused_range=fused_range, cache=cache)
        if isinstance(path_or_file, dict):
            return ArrayStore._open_manifest(path_or_file, base=".",
                                             cache_ns=cache_ns or "<manifest>", **kw)
        if isinstance(path_or_file, (str, os.PathLike)) \
                and os.fspath(path_or_file).endswith(".json"):
            path = os.fspath(path_or_file)
            with open(path) as f:
                man = json.load(f)
            return ArrayStore._open_manifest(man, base=os.path.dirname(path) or ".",
                                             cache_ns=cache_ns or path, **kw)
        f, own = _as_file(path_or_file, "rb")
        try:
            idx = container.read_index_footer(f)
            if idx is None:
                raise ValueError("not an array-store stream (no container-v3 index footer)")
            return CompressedArray(
                f, idx, own_file=own,
                cache_ns=cache_ns if cache_ns is not None else str(path_or_file), **kw,
            )
        except Exception:
            if own:
                f.close()
            raise

    @staticmethod
    def _open_manifest(man: dict, *, base: str, device, fused_range: bool, cache,
                       cache_ns: str) -> "CompressedArray":
        grid, spec, block_size, e, shards = format_mod.validate_store_manifest(man)
        files: list = []
        frame_src: list[int] = []
        frames: list[list[int]] = []
        try:
            for si, sh in enumerate(shards):
                loc = sh["file"]
                if "://" in str(loc):
                    raise ValueError(
                        f"shard {si} lives at {loc!r}: remote shards are served by the "
                        "store service (which proxies or redirects); ArrayStore.open "
                        "needs local files"
                    )
                files.append(open(os.path.join(base, str(loc)), "rb"))
                frames.extend(sh["frames"])
                frame_src.extend([si] * len(sh["frames"]))
            idx = format_mod.build_store_index(
                grid, spec.code, block_size, e, frames, man.get("attrs"),
                stage=man.get("stage"),
            )
            return CompressedArray(
                files[0], idx, own_file=True, device=device, fused_range=fused_range,
                shard_files=files, frame_src=frame_src, cache=cache, cache_ns=cache_ns,
            )
        except Exception:
            for f in files:
                f.close()
            raise


def _as_file(path_or_file, fallback_mode):
    if isinstance(path_or_file, (str, os.PathLike)):
        return open(path_or_file, fallback_mode), True
    return path_or_file, False


def _chunk_payloads(x: torch.Tensor, grid: ChunkGrid, e: float, *, block_size: int,
                    device, workers: int) -> Iterator[bytes]:
    """Compressed payload per chunk id, in id order (shared by save and
    save_sharded, so both write bit-identical per-chunk payloads)."""
    codec = SZxCodec(block_size=block_size, device=device, workers=workers)

    def payload(cid: int) -> bytes:
        box = tuple(slice(lo, hi) for lo, hi in grid.chunk_box(grid.chunk_coord(cid)))
        return codec.compress(x[box].reshape(-1), e)

    cids = range(grid.nchunks)
    if workers > 1 and grid.nchunks > 1:
        return _imap_ordered(_on_worker_streams(payload, codec.device), cids, workers)
    return map(payload, cids)


def box_of_segment(seg: torch.Tensor, local, cdims, base: int) -> torch.Tensor:
    """The chunk-local box ``local`` of a decoded segment, as a view.

    ``seg`` holds a chunk's C-order values from flat index ``base`` on (the
    first value of its first decoded block).  An axis-aligned box inside the
    chunk is a strided window of that flattening: one ``as_strided`` view
    with the chunk's C strides gathers it, with no index tensor and no copy
    to the device."""
    if all(hi - lo == d for (lo, hi), d in zip(local, cdims)):
        return seg.reshape(cdims)             # the whole chunk, C order
    seg = seg.contiguous()
    strides = [1] * len(cdims)
    for i in range(len(cdims) - 2, -1, -1):
        strides[i] = strides[i + 1] * cdims[i + 1]
    offset = sum(lo * st for (lo, _hi), st in zip(local, strides)) - base
    return seg.as_strided(tuple(hi - lo for lo, hi in local), strides,
                          seg.storage_offset() + offset)


class CompressedArray:
    """Lazy view of a stored array: ROI reads + compressed-domain queries,
    decoding only what each request touches, on the array's device.

    Supports ints, step-1 slices, and Ellipsis in ``__getitem__`` (every ROI
    is a hyperrectangle; ``ca[...]`` materializes the whole array) and
    returns a tensor on the device.  Queries (:meth:`mean`/:meth:`min`/
    :meth:`max`/:meth:`sum`) run straight on the compressed stream -- see
    :mod:`repro_torch.store.query`.  Instances are not thread-safe (one
    shared seek cursor); concurrent readers each ``open`` their own.
    """

    def __init__(self, fileobj, idx: dict, *, device, fused_range: bool = False,
                 own_file: bool = False, shard_files: list | None = None,
                 frame_src: list[int] | None = None, cache=None, cache_ns: str = "",
                 seq_base: int = 0):
        grid, spec, block_size, e = format_mod.validate_store_index(idx)
        self._f = fileobj
        self._files = list(shard_files) if shard_files is not None else [fileobj]
        self._frame_src = frame_src    # None -> every frame lives in _files[0]
        self._grid = grid
        self._spec = spec
        self._block_size = block_size
        self._e = e
        self._frames = idx["frames"]
        self._device = torch.device(device)
        self._fused_range = fused_range
        self._own = own_file
        self._closed = False
        self._cache = cache
        self._cache_ns = cache_ns
        # frame seq numbers are validated as seq_base + chunk_id: a view over
        # a SLICE of a larger container's frame sequence (a checkpoint leaf's
        # chunk frames inside tree.szt, which carry global seqs --
        # CheckpointManager.leaf_store) sets it to the first frame's seq
        self._seq_base = int(seq_base)
        self.attrs = dict(idx.get("attrs") or {})
        # advisory writer-side stage name (per-chunk truth is in frame flags)
        self.stage = idx.get("stage")

    def _src(self, cid: int):
        """File object holding chunk ``cid``'s frame (sharded stores map
        chunk ranges to shard files; frame offsets are file-local)."""
        return self._files[self._frame_src[cid]] if self._frame_src else self._files[0]

    # ------------------------------------------------------------- metadata
    @property
    def shape(self) -> tuple[int, ...]:
        return self._grid.shape

    @property
    def chunk_shape(self) -> tuple[int, ...]:
        return self._grid.chunk_shape

    @property
    def dtype(self) -> torch.dtype:
        return self._spec.dtype

    @property
    def ndim(self) -> int:
        return len(self._grid.shape)

    @property
    def size(self) -> int:
        return math.prod(self._grid.shape)

    @property
    def nbytes(self) -> int:
        return self.size * self._spec.itemsize

    @property
    def error_bound(self) -> float:
        return self._e

    @property
    def nchunks(self) -> int:
        return self._grid.nchunks

    @property
    def stored_bytes(self) -> int:
        return sum(fr[1] for fr in self._frames)

    def __repr__(self) -> str:
        return (
            f"CompressedArray(shape={self.shape}, dtype={self._spec.name}, "
            f"chunks={self.chunk_shape}, e={self._e:g}, "
            f"CR={self.nbytes / max(self.stored_bytes, 1):.2f})"
        )

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._own:
                for f in self._files:
                    f.close()

    def __enter__(self) -> "CompressedArray":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("I/O operation on a closed CompressedArray")

    # ------------------------------------------------------------ ROI reads
    def __getitem__(self, key) -> torch.Tensor:
        self._check_open()
        roi = grid_mod.normalize_roi(key, self.shape)
        if not obs.enabled():
            return self._read_roi(roi)
        with obs.span("store.read"):
            out = self._read_roi(roi)
        obs.counter("store.roi.reads").inc()
        obs.counter("store.roi.bytes_out").inc(int(out.nbytes))
        return out

    def _read_roi(self, roi) -> torch.Tensor:
        out = torch.empty(roi.box_shape, dtype=self.dtype, device=self._device)
        bs = self._block_size
        track = obs.enabled()
        for cid, local, outr in grid_mod.intersecting_chunks(self._grid, roi):
            if track:
                obs.counter("store.roi.chunks").inc()
            cdims = self._grid.chunk_dims(self._grid.chunk_coord(cid))
            lo_b, hi_b = grid_mod.block_range_for_box(local, cdims, bs)
            seg = self._decode_chunk_range(cid, lo_b, hi_b)
            out[tuple(slice(lo, hi) for lo, hi in outr)] = box_of_segment(
                seg, local, cdims, lo_b * bs)
        return out.reshape(roi.out_shape)

    def read(self, key=Ellipsis) -> torch.Tensor:
        return self[key]

    def _decode_chunk_range(self, cid: int, lo_b: int, hi_b: int) -> torch.Tensor:
        """Decode blocks [lo_b, hi_b) of chunk ``cid`` -> flat values on the
        device (the final block's padding clipped).  An attached ``cache``
        memoizes the decoded range, keyed by namespace + chunk + range;
        readers must not write into what it returns."""
        if self._cache is None:
            return self._decode_chunk_range_uncached(cid, lo_b, hi_b)
        key = (self._cache_ns, cid, lo_b, hi_b)
        hit = self._cache.get(key)
        if hit is not None:
            if obs.enabled():
                obs.counter("store.cache.hits").inc()
            return hit
        if obs.enabled():
            obs.counter("store.cache.misses").inc()
        seg = self._decode_chunk_range_uncached(cid, lo_b, hi_b)
        if seg.device.type == "cuda":
            # a cached range is shared with readers on other streams: its
            # values are complete before anyone can find it
            torch.cuda.current_stream(seg.device).synchronize()
        self._cache.put(key, seg, seg.numel() * seg.element_size())
        return seg

    def _decode_chunk_range_uncached(self, cid: int, lo_b: int, hi_b: int) -> torch.Tensor:
        """Reads (1) the frame header + stream metadata prefix and (2)
        exactly the mid-byte range of the requested blocks, then decodes on
        the device by the store's route."""
        off, length, elements = (int(v) for v in self._frames[cid])
        f = self._src(cid)
        flags, plen, sheader = container.read_frame_stream_header_at(
            f, off, cid + self._seq_base
        )
        if container.FRAME_HEADER.size + plen != length:
            raise ValueError("corrupt store index (frame length mismatch)")
        prefix_len = container.stream_prefix_length(sheader)
        if prefix_len > plen:
            raise ValueError("truncated SZx stream (metadata exceeds payload)")
        prefix = sheader + container._read_exact(f, prefix_len - container.HEADER.size)
        sec = container.parse_stream_sections(prefix, device=self._device)
        if sec.plan.n != elements:
            raise ValueError(
                f"corrupt store index (chunk {cid}: stream has {sec.plan.n} "
                f"elements, index says {elements})"
            )
        hi_b = min(hi_b, sec.plan.nblocks)
        mlo, mhi = sec.mid_range(lo_b, hi_b)
        mid = b""
        if mhi > mlo:
            code = container.stage_of_flags(flags)
            if code:
                # staged frame: the stage table + only the segment records
                # covering [lo_b, hi_b), destaged on the device
                mid = stage_mod.read_mid_range(
                    f, off + container.FRAME_HEADER.size + prefix_len,
                    sec, code, lo_b, hi_b, device=self._device,
                )
            else:
                f.seek(off + container.FRAME_HEADER.size + prefix_len + mlo)
                mid = container._read_exact(f, mhi - mlo)
                if obs.enabled():
                    obs.counter("store.roi.mid_bytes_read").inc(mhi - mlo)
        if obs.enabled():
            # staged mid reads are counted (at their size on disk) by
            # stage.read_mid_range as codec.stage.roi_bytes_read
            obs.counter("store.roi.prefix_bytes_read").inc(
                container.FRAME_HEADER.size + prefix_len)
            obs.counter("store.chunk.decodes").inc()
        if self._fused_range:
            flat = device_mod.decode_range(prefix, mid, lo_b, hi_b, device=self._device)
        else:
            enc = container.extract_block_range(sec, mid, lo_b, hi_b)
            flat = transform.decode_blocks(enc, sec.plan).reshape(-1)
        bs = sec.plan.block_size
        return flat[: min(hi_b * bs, elements) - lo_b * bs]

    # ----------------------------------------------------- compressed queries
    def stats(self, *, header_only: bool = False) -> "query_mod.QueryStats":
        """Aggregate stats straight from the compressed stream.

        Default: exact stats of the decompressed array (constant blocks are
        answered from their headers alone; only non-constant blocks decode,
        on the device).  ``header_only=True`` never reads plane/mid bytes at
        all and returns guaranteed ``[lo, hi]`` intervals instead.
        """
        self._check_open()
        locs = None
        if self._frame_src is not None or self._seq_base:
            locs = [
                (self._src(seq), seq + self._seq_base, int(fr[0]), int(fr[1]), int(fr[2]))
                for seq, fr in enumerate(self._frames)
            ]
        return query_mod.scan_frames(
            self._f, self._frames, device=self._device, header_only=header_only,
            locs=locs,
        )

    def mean(self) -> float:
        return self.stats().mean[0]

    def sum(self) -> float:
        return self.stats().sum[0]

    def min(self) -> float:
        return self.stats().min[0]

    def max(self) -> float:
        return self.stats().max[0]
