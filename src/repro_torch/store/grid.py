"""N-d chunk-grid geometry for the block-addressable array store.

Pure index math, no I/O: how an N-d array is tiled into chunk
hyperrectangles, how a region-of-interest (ROI) maps onto the chunks it
intersects, and how a chunk-local ROI box maps onto the contiguous range of
SZx blocks that covers it in the chunk's C-order flattening.  Everything the
lazy read path needs to guarantee "bytes read scale with the ROI, not the
array" lives here.  Pure Python, the JAX package's geometry unchanged.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Iterator

# ~2 MB of raw input per chunk: small enough that a boxy ROI of a large
# array touches only a few percent of the file, large enough that per-chunk
# header overhead stays negligible and per-chunk encode stays fast.
DEFAULT_CHUNK_TARGET_BYTES = 2 << 20


def parse_roi(text: str | None):
    """'0:16,:,3' -> an N-d index tuple (step-1 slices and ints only):
    the one textual ROI parser."""
    if text is None or text.strip() in ("", "..."):
        return Ellipsis
    out = []
    for part in text.split(","):
        part = part.strip()
        if part == "...":
            out.append(Ellipsis)
        elif ":" in part:
            fields = part.split(":")
            if len(fields) > 3:
                raise ValueError(f"bad ROI slice {part!r}")
            vals = [int(v) if v else None for v in fields]
            out.append(slice(*vals))
        else:
            out.append(int(part))
    return tuple(out)


def default_chunk_shape(
    shape: tuple[int, ...], itemsize: int,
    target_bytes: int = DEFAULT_CHUNK_TARGET_BYTES,
) -> tuple[int, ...]:
    """zarr-style default chunking: keep trailing dimensions whole and split
    leading ones until a chunk holds at most ``target_bytes`` of raw input."""
    rem = max(target_bytes // itemsize, 1)
    out: list[int] = []
    for dim in reversed(shape):
        take = min(dim, rem)
        out.append(take)
        rem = max(rem // dim, 1) if take == dim else 1
    return tuple(reversed(out))


@dataclass(frozen=True)
class ChunkGrid:
    """C-order grid of chunk hyperrectangles over an N-d array shape.

    Chunk ids are the C-order enumeration of N-d chunk coordinates; edge
    chunks are clipped to the array bounds.  This id order is also the frame
    order of a store stream, which makes the footer's ``frames`` list the
    block-grid index: ``frames[grid.chunk_id(coord)]`` is the byte range of
    the chunk at ``coord``.
    """

    shape: tuple[int, ...]
    chunk_shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.chunk_shape):
            raise ValueError(
                f"chunk shape {self.chunk_shape} rank does not match array "
                f"shape {self.shape}"
            )
        if not self.shape:
            raise ValueError("0-d arrays are not chunkable; reshape to (1,)")
        for d, c in zip(self.shape, self.chunk_shape):
            if d <= 0:
                raise ValueError(f"array shape {self.shape} has an empty dim")
            if not 1 <= c <= d:
                raise ValueError(
                    f"chunk dim {c} out of range [1, {d}] for shape {self.shape}"
                )

    @staticmethod
    def for_shape(shape, chunk_shape=None, *, itemsize: int = 4,
                  target_bytes: int = DEFAULT_CHUNK_TARGET_BYTES) -> "ChunkGrid":
        shape = tuple(int(d) for d in shape)
        if chunk_shape is None:
            chunk_shape = default_chunk_shape(shape, itemsize, target_bytes)
        else:
            chunk_shape = tuple(
                min(max(int(c), 1), d) for c, d in zip(chunk_shape, shape)
            )
        return ChunkGrid(shape, chunk_shape)

    @property
    def chunks_per_dim(self) -> tuple[int, ...]:
        return tuple(
            (d + c - 1) // c for d, c in zip(self.shape, self.chunk_shape)
        )

    @property
    def nchunks(self) -> int:
        return math.prod(self.chunks_per_dim)

    def chunk_coord(self, cid: int) -> tuple[int, ...]:
        per = self.chunks_per_dim
        if not 0 <= cid < self.nchunks:
            raise ValueError(f"chunk id {cid} out of range [0, {self.nchunks})")
        coord = []
        for n in reversed(per):
            coord.append(cid % n)
            cid //= n
        return tuple(reversed(coord))

    def chunk_id(self, coord: tuple[int, ...]) -> int:
        cid = 0
        for c, n in zip(coord, self.chunks_per_dim):
            if not 0 <= c < n:
                raise ValueError(f"chunk coord {coord} out of grid {self.chunks_per_dim}")
            cid = cid * n + c
        return cid

    def chunk_box(self, coord: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
        """Per-dim [lo, hi) extents of the chunk at ``coord`` (edge-clipped)."""
        return tuple(
            (c * cs, min((c + 1) * cs, d))
            for c, cs, d in zip(coord, self.chunk_shape, self.shape)
        )

    def chunk_dims(self, coord: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.chunk_box(coord))

    def chunk_elements(self, coord: tuple[int, ...]) -> int:
        return math.prod(self.chunk_dims(coord))


@dataclass(frozen=True)
class ROI:
    """A normalized region of interest: per-dim [start, stop) plus which
    dims came from integer indices (and are squeezed out of the result)."""

    ranges: tuple[tuple[int, int], ...]
    squeeze: tuple[bool, ...]

    @property
    def box_shape(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.ranges)

    @property
    def out_shape(self) -> tuple[int, ...]:
        return tuple(
            hi - lo for (lo, hi), sq in zip(self.ranges, self.squeeze) if not sq
        )

    @property
    def size(self) -> int:
        return math.prod(self.box_shape)


def normalize_roi(key, shape: tuple[int, ...]) -> ROI:
    """Normalize a ``__getitem__`` key into per-dim [start, stop) ranges.

    Supports integers (negative ok, dim squeezed), step-1 slices, Ellipsis,
    and full-dim fill for unspecified trailing dims.  Fancy/boolean indexing
    and non-unit steps raise TypeError/ValueError -- ROI reads are
    hyperrectangles by design (each maps to a contiguous block range per
    chunk).
    """
    if not isinstance(key, tuple):
        key = (key,)
    n_ell = sum(1 for k in key if k is Ellipsis)
    if n_ell > 1:
        raise ValueError("an index can only have a single Ellipsis")
    explicit = len(key) - n_ell
    if explicit > len(shape):
        raise ValueError(
            f"too many indices ({explicit}) for a rank-{len(shape)} array"
        )
    expanded: list = []
    for k in key:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (len(shape) - explicit))
        else:
            expanded.append(k)
    expanded.extend([slice(None)] * (len(shape) - len(expanded)))

    ranges: list[tuple[int, int]] = []
    squeeze: list[bool] = []
    for k, d in zip(expanded, shape):
        if isinstance(k, bool):
            raise TypeError("boolean indices are not supported by ROI reads")
        if isinstance(k, slice):
            if k.step not in (None, 1):
                raise ValueError(
                    f"ROI reads support step-1 slices only, got step {k.step}"
                )
            lo, hi, _ = k.indices(d)
            ranges.append((lo, max(hi, lo)))
            squeeze.append(False)
        elif isinstance(k, (int,)) or hasattr(k, "__index__"):
            i = k.__index__()
            if i < 0:
                i += d
            if not 0 <= i < d:
                raise IndexError(f"index {k} out of bounds for dim of size {d}")
            ranges.append((i, i + 1))
            squeeze.append(True)
        else:
            raise TypeError(
                f"ROI reads support ints, step-1 slices, and Ellipsis; "
                f"got {type(k).__name__}"
            )
    return ROI(tuple(ranges), tuple(squeeze))


def intersecting_chunks(
    grid: ChunkGrid, roi: ROI
) -> Iterator[tuple[int, tuple[tuple[int, int], ...], tuple[tuple[int, int], ...]]]:
    """Yield ``(chunk_id, local_ranges, out_ranges)`` for every chunk the ROI
    intersects, in chunk-id order.

    ``local_ranges`` are [lo, hi) within the chunk's own (clipped) dims;
    ``out_ranges`` are [lo, hi) within the ROI's box shape.  Chunks outside
    the ROI are never yielded -- the "never parses non-intersecting chunks"
    guarantee starts here.
    """
    if roi.size == 0:
        return
    per_dim = []
    for (lo, hi), cs in zip(roi.ranges, grid.chunk_shape):
        per_dim.append(range(lo // cs, (hi - 1) // cs + 1))
    for coord in itertools.product(*per_dim):
        box = grid.chunk_box(coord)
        local, out = [], []
        for (rlo, rhi), (blo, bhi) in zip(roi.ranges, box):
            ilo, ihi = max(rlo, blo), min(rhi, bhi)
            local.append((ilo - blo, ihi - blo))
            out.append((ilo - rlo, ihi - rlo))
        yield grid.chunk_id(coord), tuple(local), tuple(out)


def block_range_for_box(
    local_ranges: tuple[tuple[int, int], ...],
    chunk_dims: tuple[int, ...],
    block_size: int,
) -> tuple[int, int]:
    """Contiguous SZx block range [lo, hi) covering a local ROI box in the
    chunk's C-order flattening.

    The first and last elements of the box bound every element's flat index,
    so the block span of the box is the span of those two corners -- tight
    for leading-axis slabs, and never larger than the chunk.
    """
    first = last = 0
    for (lo, hi), d in zip(local_ranges, chunk_dims):
        first = first * d + lo
        last = last * d + (hi - 1)
    return first // block_size, last // block_size + 1
