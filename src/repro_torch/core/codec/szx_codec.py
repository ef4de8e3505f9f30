"""Byte-stream front-end: SZxCodec (monolithic + chunked streaming) on torch.

The host-facing API over the plan -> device -> container pipeline, with the
JAX package's stream format and method names.  ``compress`` takes a CUDA
tensor (no copy), a CPU tensor or a numpy array (copied to the card once);
``decompress`` returns a tensor on the codec's device.  Chunk payloads are
bit-identical to compressing the same slice monolithically, so the chunked
path inherits every error-bound guarantee of the monolithic one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.codec import container, device as device_mod, plan as plan_mod
from repro_torch.core.codec.plan import DEFAULT_BLOCK_SIZE, Bound

DEFAULT_CHUNK_BYTES = 64 << 20     # 64 MB of input per frame


def _imap_ordered(fn: Callable, items: Iterable, workers: int) -> Iterator:
    """Ordered, bounded-lookahead parallel map over a thread pool.

    Results are yielded strictly in input order; at most ``2 * workers`` items
    are in flight, so peak memory stays O(workers * item).
    """
    lookahead = 2 * workers
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: deque = deque()
        try:
            for item in items:
                pending.append(pool.submit(fn, item))
                if obs.enabled():
                    obs.gauge("codec.pipeline.queue_depth").set(len(pending))
                if len(pending) >= lookahead:
                    yield pending.popleft().result()
            while pending:
                if obs.enabled():
                    obs.gauge("codec.pipeline.queue_depth").set(len(pending))
                yield pending.popleft().result()
        finally:
            while pending:
                pending.popleft().cancel()


def _on_worker_streams(fn: Callable, dev: torch.device) -> Callable:
    """Run ``fn`` on a CUDA stream of the calling worker thread's own.

    Each worker's stream first waits for the caller's stream (which made the
    inputs), and is synchronized before the result is handed back; tensor
    results are marked as used by the caller's stream so their memory is not
    reused under it.
    """
    if dev.type != "cuda":
        return fn
    caller = torch.cuda.current_stream(dev)
    local = threading.local()

    def run(item):
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(dev)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            res = fn(item)
        stream.synchronize()
        if isinstance(res, torch.Tensor):
            res.record_stream(caller)
        return res

    return run


def _validate_select(select) -> list[int]:
    """Normalize a frame selection: integers, strictly increasing, non-empty."""
    out = []
    for i in select:
        if isinstance(i, bool) or not isinstance(i, (int, np.integer)):
            raise ValueError(
                f"select= expects integer frame indices, got {i!r}"
            )
        i = int(i)
        if i < 0:
            raise ValueError(f"frame index {i} out of range (negative)")
        if out and i <= out[-1]:
            raise ValueError(
                f"select= must be strictly increasing (got {i} after "
                f"{out[-1]}: duplicates/unsorted selections are ambiguous)"
            )
        out.append(i)
    if not out:
        raise ValueError("empty SZx frame selection")
    return out


def _concat(parts: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat(parts) if len(parts) > 1 else parts[0]


@dataclass(frozen=True)
class CompressionStats:
    n: int
    raw_bytes: int
    compressed_bytes: int
    ratio: float
    constant_block_fraction: float
    mean_bytes_per_value: float
    error_bound: float


@dataclass(frozen=True)
class SZxCodec:
    """Configured byte-stream codec; instances are cheap and immutable.

    ``device`` is where the codec runs: ``None`` means ``"cuda"``, and a
    codec for the card raises at construction when there is none.  The
    kernels run for CUDA tensors; ``device="cpu"`` runs their plain PyTorch
    versions.  ``workers > 1`` runs the chunked paths' frame bodies on an
    ordered thread pool, each worker on its own CUDA stream; the bytes are
    identical for any worker count.  ``stage`` (None, ``'bitshuffle-rle'``,
    ``'bitshuffle-zstd'`` or ``'deflate'``) is the negotiated second stage
    of the chunked frames, run on the codec's device (see ``stage.py``).
    """

    block_size: int = DEFAULT_BLOCK_SIZE
    device: str | torch.device | None = None
    workers: int = 1
    stage: str | int | None = None

    def __post_init__(self):
        dev = device_mod.resolve_device(self.device, "SZxCodec")
        if self.stage is not None:
            from repro_torch.core.codec import stage as stage_mod

            stage_mod.resolve(self.stage)   # unknown/unavailable -> raises now
        object.__setattr__(self, "device", dev)

    # ------------------------------------------------------------- monolithic
    def compress(self, x, bound: Bound | float | None = None, *,
                 mode: str | None = None, dtype=None,
                 error_bound: float | None = None) -> bytes:
        """Compress an array (f32/f64/f16/bf16) into one v2 stream.

        bound: a :class:`Bound` (``Bound.abs(1e-3)`` / ``Bound.rel(1e-4)``)
               or a bare float meaning ``Bound.abs``.
        dtype: optionally force the codec dtype (input is cast first).
        """
        b = plan_mod.as_bound(bound, mode, error_bound=error_bound,
                              owner="SZxCodec.compress")
        p, xt = plan_mod.make_plan(
            x, b, block_size=self.block_size, dtype=dtype, device=self.device,
        )
        if not obs.enabled():
            return device_mod.encode_to_stream(plan_mod.to_blocks(xt, p), p)
        t0 = time.perf_counter()
        with obs.span("codec.compress", n=int(p.n), dtype=p.dtype.name):
            buf = device_mod.encode_to_stream(plan_mod.to_blocks(xt, p), p)
        obs.stream_stats.record_compress(buf, time.perf_counter() - t0)
        return buf

    def decompress(self, buf: bytes, *, out: torch.Tensor | None = None) -> torch.Tensor:
        """Decompress one v2 stream -> flat tensor (stream dtype) on the
        codec's device.  With ``out`` (a flat (n,) tensor of the stream
        dtype there) the result is written in place and ``out`` returned."""
        if not obs.enabled():
            return device_mod.decode_stream(buf, device=self.device, out=out)
        t0 = time.perf_counter()
        with obs.span("codec.decompress"):
            res = device_mod.decode_stream(buf, device=self.device, out=out)
        obs.stream_stats.record_decompress(res.nbytes, time.perf_counter() - t0)
        return res

    def decompress_range(self, buf: bytes, lo_block: int, hi_block: int) -> torch.Tensor:
        """Partial decode of one v2 stream: blocks [lo_block, hi_block) only,
        i.e. elements ``[lo_block * bs, min(hi_block * bs, n))`` of
        ``decompress(buf)``."""
        if not obs.enabled():
            return device_mod.decode_stream(
                buf, device=self.device, block_range=(lo_block, hi_block)
            )
        t0 = time.perf_counter()
        with obs.span("codec.decompress_range", lo=lo_block, hi=hi_block):
            res = device_mod.decode_stream(
                buf, device=self.device, block_range=(lo_block, hi_block)
            )
        obs.stream_stats.record_decompress(res.nbytes, time.perf_counter() - t0, kind="range")
        return res

    def compress_with_stats(self, x, bound: Bound | float | None = None,
                            **kw) -> tuple[bytes, CompressionStats]:
        buf = self.compress(x, bound, **kw)
        _, _, _, _, n, e, nb, nnc, _ = container.HEADER.unpack_from(buf, 0)
        itemsize = plan_mod.spec_for_code(buf[5]).itemsize
        return buf, CompressionStats(
            n=int(n),
            raw_bytes=itemsize * int(n),
            compressed_bytes=len(buf),
            ratio=itemsize * int(n) / len(buf),
            constant_block_fraction=1.0 - nnc / max(nb, 1),
            mean_bytes_per_value=len(buf) / max(int(n), 1),
            error_bound=float(e),
        )

    # ---------------------------------------------------------------- chunked
    def iter_chunk_payloads(
        self,
        x,
        bound: Bound | float | None = None,
        *,
        mode: str | None = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        dtype=None,
        error_bound: float | None = None,
    ) -> Iterator[tuple[bytes, bool]]:
        """Yield ``(payload, is_last)`` covering ``x`` in chunk order.

        The bound is resolved over the FULL array first (so ``Bound.rel``
        matches the monolithic stream -- every chunk carries the same
        absolute ``e``), then each block-aligned chunk is compressed
        independently; each payload is bit-identical to ``compress(chunk,
        e_abs)``.  ``x`` is copied to the device once, up front.
        """
        b = plan_mod.as_bound(bound, mode, error_bound=error_bound,
                              owner="SZxCodec.iter_chunk_payloads")
        xt = plan_mod.as_tensor(x, self.device, dtype)
        spec = plan_mod.spec_for(xt.dtype)
        e = plan_mod.resolve_error_bound(xt, b, spec=spec)
        flat = xt.reshape(-1)
        per_chunk = plan_mod.chunk_elements(self.block_size, chunk_bytes, spec.itemsize)
        nchunks = max((flat.numel() + per_chunk - 1) // per_chunk, 1)

        def payload(i: int) -> bytes:
            return self.compress(flat[i * per_chunk : (i + 1) * per_chunk], e)

        if self.workers > 1 and nchunks > 1:
            payloads = _imap_ordered(
                _on_worker_streams(payload, self.device), range(nchunks), self.workers
            )
        else:
            payloads = map(payload, range(nchunks))
        for i, pl in enumerate(payloads):
            yield pl, i == nchunks - 1

    def compress_chunked(
        self,
        x,
        bound: Bound | float | None = None,
        *,
        mode: str | None = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        dtype=None,
        error_bound: float | None = None,
    ) -> Iterator[bytes]:
        """Yield self-delimiting frames covering ``x`` in order."""
        b = plan_mod.as_bound(bound, mode, error_bound=error_bound,
                              owner="SZxCodec.compress_chunked")
        for i, (payload, last) in enumerate(
            self.iter_chunk_payloads(x, b, chunk_bytes=chunk_bytes, dtype=dtype)
        ):
            yield container.build_frame(payload, i, last=last, stage=self.stage,
                                        device=self.device)

    def decompress_chunked(self, frames, *, n: int | None = None) -> torch.Tensor:
        """Decompress a frame sequence -> flat tensor on the codec's device.

        ``frames`` may be concatenated bytes, a binary file object, or an
        iterable of frame byte strings.  Pass ``n`` (the total element count)
        to preallocate the output: each frame decodes straight into its
        slice.  Without ``n`` the decoded chunks are concatenated.
        """
        out = None

        def jobs() -> Iterator[tuple[bytes, int, int]]:
            nonlocal out
            spec_code = None
            off = 0
            for payload in container.iter_frames(frames, device=self.device):
                if len(payload) <= 5:
                    raise ValueError("truncated SZx stream (shorter than header)")
                if spec_code is None:
                    spec_code = payload[5]
                    if n is not None:
                        out = torch.empty(
                            n, dtype=plan_mod.spec_for_code(spec_code).dtype,
                            device=self.device,
                        )
                elif payload[5] != spec_code:
                    raise ValueError("SZx frame sequence mixes dtypes")
                _code, fn, _e = container.peek_stream_meta(payload)
                if out is not None and off + fn > n:
                    raise ValueError(
                        f"SZx frame sequence longer than expected ({n} elements)"
                    )
                yield payload, off, int(fn)
                off += int(fn)

        def decode(job: tuple[bytes, int, int]) -> torch.Tensor:
            payload, off, fn = job
            if out is not None:
                return self.decompress(payload, out=out[off : off + fn])
            return self.decompress(payload)

        if self.workers > 1:
            decoded = _imap_ordered(
                _on_worker_streams(decode, self.device), jobs(), self.workers
            )
        else:
            decoded = map(decode, jobs())

        parts: list[torch.Tensor] = []
        filled = 0
        seen = False
        for part in decoded:
            seen = True
            if out is None:
                parts.append(part)
            filled += part.numel()
        if not seen:
            raise ValueError("empty SZx frame sequence")
        if out is not None:
            if filled != n:
                raise ValueError(
                    f"SZx frame sequence has {filled} elements, expected {n}"
                )
            return out
        return _concat(parts)

    def dump_chunked(self, x, fileobj, bound: Bound | float | None = None, *,
                     index: bool = True, **kw) -> int:
        """Stream ``compress_chunked`` frames straight to a file; returns
        bytes written.  With ``index=True`` (the default) a container-v3
        footer is appended after the LAST frame: per-frame ``[offset,
        length, elements]`` plus the stream totals, enabling random access
        (``load_chunked`` with ``select=``)."""
        written = 0
        frames_idx: list[list[int]] = []
        dtype_code = None
        total_n = 0
        for frame in self.compress_chunked(x, bound, **kw):
            if index:
                dtype_code, payload_n, _e = container.peek_stream_meta(
                    memoryview(frame)[container.FRAME_HEADER.size:]
                )
                frames_idx.append([written, len(frame), int(payload_n)])
                total_n += int(payload_n)
            fileobj.write(frame)
            written += len(frame)
        if index:
            footer = container.build_index_footer(
                {
                    "v": container.INDEX_VERSION,
                    "kind": "szx-chunked",
                    "n": total_n,
                    "dtype": dtype_code,
                    "frames": frames_idx,
                }
            )
            fileobj.write(footer)
            written += len(footer)
        return written

    def load_chunked(self, fileobj, *, n: int | None = None,
                     select=None) -> torch.Tensor:
        """Read + decompress a frame sequence from a file object.  Pass ``n``
        (total element count) to preallocate.

        ``select``: a strictly increasing iterable of in-range frame indices
        -- decode ONLY those frames (concatenated), reading only their byte
        ranges via the container-v3 index footer (raises ValueError on
        streams without one).  A present-but-corrupt footer falls back to a
        sequential decode of the whole stream (with a RuntimeWarning), still
        returning only the selected frames' elements.
        """
        if select is None:
            return self.decompress_chunked(fileobj, n=n)
        select = _validate_select(select)
        idx = container.read_index_footer_safe(fileobj)
        if idx is not None and idx.get("kind") != "szx-chunked":
            raise ValueError(
                f"not a single-array chunked stream (footer kind "
                f"{idx.get('kind')!r}); tree streams restore via "
                "TreeCodec.decompress_tree"
            )
        if idx is None:
            # "no footer was ever written" (select= is a caller error) vs
            # "footer present but unreadable" (fall back to the sequential
            # decode): a corrupt-but-present footer usually still carries
            # the SZXI magic in its last 20 bytes
            end = fileobj.seek(0, 2)
            fileobj.seek(max(end - container.INDEX_TRAILER.size, 0))
            trailer = fileobj.read(container.INDEX_TRAILER.size)
            fileobj.seek(0)
            if container.INDEX_MAGIC not in trailer:
                raise ValueError(
                    "select= needs a container-v3 index footer; this stream "
                    "has none (rewrite it with dump_chunked(..., index=True))"
                )
            wanted = set(select)
            parts = []
            for i, payload in enumerate(container.iter_frames(fileobj, device=self.device)):
                if i in wanted:
                    parts.append(self.decompress(payload))
            if select[-1] >= i + 1:
                raise ValueError(
                    f"frame index {select[-1]} out of range [0, {i + 1})"
                )
            return _concat(parts)
        frames = idx["frames"]
        parts = []
        for i in select:
            if i >= len(frames):
                raise ValueError(f"frame index {i} out of range [0, {len(frames)})")
            off, length, _elems = frames[i]
            payload, _flags = container.read_frame_at(fileobj, off, length, i,
                                                      device=self.device)
            parts.append(self.decompress(payload))
        return _concat(parts)


# functional API
def compress(x, bound: Bound | float | None = None, *, mode: str | None = None,
             block_size: int = DEFAULT_BLOCK_SIZE, device=None,
             dtype=None, error_bound: float | None = None) -> bytes:
    b = plan_mod.as_bound(bound, mode, error_bound=error_bound,
                          owner="szx_codec.compress")
    return SZxCodec(block_size, device).compress(x, b, dtype=dtype)


def decompress(buf: bytes, *, device=None) -> torch.Tensor:
    return SZxCodec(device=device).decompress(buf)


def compress_with_stats(x, bound: Bound | float | None = None, *,
                        mode: str | None = None,
                        block_size: int = DEFAULT_BLOCK_SIZE, device=None,
                        dtype=None, error_bound: float | None = None,
                        ) -> tuple[bytes, CompressionStats]:
    b = plan_mod.as_bound(bound, mode, error_bound=error_bound,
                          owner="szx_codec.compress_with_stats")
    return SZxCodec(block_size, device).compress_with_stats(x, b, dtype=dtype)
