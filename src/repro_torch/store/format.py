"""On-disk format of the array store: container v3 with a block-grid index.

The JAX package's format, unchanged: stores written by either package open
in the other.

A store file IS a container-v3 stream (`docs/FORMAT.md`): a sequence of
self-delimiting frames -- one frame per N-d chunk, each payload an
independent v2 SZx stream of the chunk's C-order flattening -- followed by
the seekable index footer.  The footer's ``kind`` is ``"szx-store"`` and its
index extends the chunked schema with the chunk-grid geometry:

    {
      "v": 1, "kind": "szx-store", "store_v": 1,
      "shape": [...], "chunk_shape": [...],
      "dtype": <dtype code>, "block_size": <int>, "e": <absolute bound>,
      "frames": [[offset, length, elements], ...],   # one per chunk, C order
      "attrs": {...},                                 # user metadata
    }

``frames[grid.chunk_id(coord)]`` is the byte range of the chunk at N-d
coordinate ``coord`` -- the block-grid index mapping chunk coordinates to
byte ranges.  Any container-v3 reader can still walk the frames
sequentially; ``SZxCodec.load_chunked``-style readers see a normal chunked
stream whose chunk order happens to be the grid's C order.
"""
from __future__ import annotations

import math

from repro_torch.core.codec import container, plan as plan_mod
from repro_torch.store.grid import ChunkGrid

STORE_KIND = "szx-store"
STORE_SHARD_KIND = "szx-store-shard"
MANIFEST_KIND = "szx-store-manifest"
STORE_VERSION = 1
MANIFEST_VERSION = 1


def build_store_index(
    grid: ChunkGrid,
    dtype_code: int,
    block_size: int,
    e: float,
    frames: list[list[int]],
    attrs: dict | None = None,
    *,
    stage: str | None = None,
) -> dict:
    if len(frames) != grid.nchunks:
        raise ValueError(
            f"store index needs one frame per chunk ({grid.nchunks}), got "
            f"{len(frames)}"
        )
    idx = {
        "v": container.INDEX_VERSION,
        "kind": STORE_KIND,
        "store_v": STORE_VERSION,
        "shape": list(grid.shape),
        "chunk_shape": list(grid.chunk_shape),
        "dtype": int(dtype_code),
        "block_size": int(block_size),
        "e": float(e),
        "frames": frames,
        "attrs": dict(attrs or {}),
    }
    # advisory only (the frame flags are the source of truth per chunk);
    # omitted when stage-off so stage-less footers stay byte-identical
    if stage is not None:
        idx["stage"] = stage
    return idx


def validate_store_index(idx: dict) -> tuple[ChunkGrid, object, int, float]:
    """Check a footer dict is a readable store index; returns
    ``(grid, dtype_spec, block_size, e)``."""
    if idx.get("kind") != STORE_KIND:
        raise ValueError(
            f"not an array-store stream (footer kind {idx.get('kind')!r}); "
            "chunked streams load via SZxCodec.load_chunked"
        )
    if idx.get("store_v", 0) > STORE_VERSION:
        raise ValueError(
            f"unsupported array-store version {idx.get('store_v')}"
        )
    spec = plan_mod.spec_for_code(int(idx["dtype"]))
    shape = tuple(int(d) for d in idx["shape"])
    chunk_shape = tuple(int(c) for c in idx["chunk_shape"])
    grid = ChunkGrid(shape, chunk_shape)
    frames = idx["frames"]
    if len(frames) != grid.nchunks:
        raise ValueError(
            f"corrupt store index ({len(frames)} frames for {grid.nchunks} "
            "chunks)"
        )
    total = sum(int(f[2]) for f in frames)
    if total != math.prod(shape):
        raise ValueError(
            f"corrupt store index (frames cover {total} elements, shape "
            f"needs {math.prod(shape)})"
        )
    return grid, spec, int(idx["block_size"]), float(idx["e"])


# --------------------------------------------------------------- sharded stores
#
# A sharded store is a JSON MANIFEST plus N ordinary shard files.  Each shard
# file holds a CONTIGUOUS range of the grid's chunk frames, written with their
# GLOBAL sequence numbers (so the per-frame seq==chunk-id validation of
# ``container.read_frame_at`` holds unchanged), closed by a footer of kind
# ``"szx-store-shard"``.  The manifest schema (docs/FORMAT.md):
#
#     {
#       "kind": "szx-store-manifest", "manifest_v": 1, "store_v": 1,
#       "shape": [...], "chunk_shape": [...],
#       "dtype": <dtype code>, "block_size": <int>, "e": <absolute bound>,
#       "shards": [
#         {"file": <relative path or URL>,
#          "chunks": [lo, hi),                  # global chunk-id range
#          "frames": [[offset, length, elements], ...]},  # SHARD-local offsets
#         ...
#       ],
#       "attrs": {...},
#     }
#
# Shard ranges partition [0, nchunks) in order; concatenating the shards'
# ``frames`` lists yields exactly the single-file footer's frames list (up to
# the offset rebasing), so a manifest open needs NO reads from the shard
# files themselves.

def build_store_manifest(
    grid: ChunkGrid,
    dtype_code: int,
    block_size: int,
    e: float,
    shards: list[dict],
    attrs: dict | None = None,
    *,
    stage: str | None = None,
) -> dict:
    man = {
        "kind": MANIFEST_KIND,
        "manifest_v": MANIFEST_VERSION,
        "store_v": STORE_VERSION,
        "shape": list(grid.shape),
        "chunk_shape": list(grid.chunk_shape),
        "dtype": int(dtype_code),
        "block_size": int(block_size),
        "e": float(e),
        "shards": shards,
        "attrs": dict(attrs or {}),
    }
    if stage is not None:
        man["stage"] = stage
    return man


def build_shard_index(
    grid: ChunkGrid,
    dtype_code: int,
    block_size: int,
    e: float,
    chunk_range: tuple[int, int],
    frames: list[list[int]],
    attrs: dict | None = None,
) -> dict:
    """Footer of ONE shard file: the store schema plus its chunk range."""
    lo, hi = chunk_range
    if len(frames) != hi - lo:
        raise ValueError(
            f"shard index needs one frame per owned chunk ({hi - lo}), got "
            f"{len(frames)}"
        )
    return {
        "v": container.INDEX_VERSION,
        "kind": STORE_SHARD_KIND,
        "store_v": STORE_VERSION,
        "shape": list(grid.shape),
        "chunk_shape": list(grid.chunk_shape),
        "dtype": int(dtype_code),
        "block_size": int(block_size),
        "e": float(e),
        "chunks": [int(lo), int(hi)],
        "frames": frames,
        "attrs": dict(attrs or {}),
    }


def validate_store_manifest(
    man: dict,
) -> tuple[ChunkGrid, object, int, float, list[dict]]:
    """Check a parsed manifest dict; returns
    ``(grid, dtype_spec, block_size, e, shards)``."""
    if man.get("kind") != MANIFEST_KIND:
        raise ValueError(
            f"not a store manifest (kind {man.get('kind')!r})"
        )
    if man.get("manifest_v", 0) > MANIFEST_VERSION:
        raise ValueError(
            f"unsupported store-manifest version {man.get('manifest_v')}"
        )
    spec = plan_mod.spec_for_code(int(man["dtype"]))
    grid = ChunkGrid(
        tuple(int(d) for d in man["shape"]),
        tuple(int(c) for c in man["chunk_shape"]),
    )
    shards = man["shards"]
    nxt = 0
    total = 0
    for sh in shards:
        lo, hi = (int(v) for v in sh["chunks"])
        if lo != nxt or hi <= lo:
            raise ValueError(
                f"corrupt manifest (shard ranges must partition "
                f"[0, {grid.nchunks}) in order; got [{lo}, {hi}) after {nxt})"
            )
        if len(sh["frames"]) != hi - lo:
            raise ValueError(
                f"corrupt manifest (shard [{lo}, {hi}) lists "
                f"{len(sh['frames'])} frames for {hi - lo} chunks)"
            )
        total += sum(int(f[2]) for f in sh["frames"])
        nxt = hi
    if nxt != grid.nchunks:
        raise ValueError(
            f"corrupt manifest (shards cover {nxt} of {grid.nchunks} chunks)"
        )
    if total != math.prod(grid.shape):
        raise ValueError(
            f"corrupt manifest (frames cover {total} elements, shape needs "
            f"{math.prod(grid.shape)})"
        )
    return grid, spec, int(man["block_size"]), float(man["e"]), shards
