"""Streaming training ingest from compressed array stores, on the card.

Counterpart of ``repro/data/store_loader.py``.  The paper's headline
use-cases keep data compressed and materialize values only at the moment of
use; this module makes the TRAINING INGEST path do the same.  A
:class:`StoreLoader` samples shuffled N-d ROI windows from an
:class:`repro_torch.store.ArrayStore` (local file or shard manifest) and
yields batches on the store's device, reading and decoding ONLY the SZx
block ranges the batch touches -- bytes read scale with the batch, never the
corpus.  The files are byte-identical to the reference's, and so are the
bytes read.

Determinism contract (shared with ``SyntheticLM``): the window plan is a
pure function of ``(seed, step, rank)``, host numpy equal to the
reference's, so restoring a checkpoint at step N and calling
``batches(start_step=N)`` replays the exact window stream, per rank, and the
batches are bit-identical to the reference loader's on the same file.

Hot path: per batch the planner COALESCES windows landing in the same chunk
into one merged block-range task (a chunk is fetched and decoded once per
batch, not once per window); a worker pool runs the two-phase partial reads
and range decodes concurrently with bounded batch lookahead, each worker on
a CUDA stream of its own; batches are assembled on the consumer's stream
into a small ring of preallocated reuse buffers on the device, each window
piece gathered as one strided view of its decoded segment.  Worker
exceptions propagate to the consumer on ``__next__`` and ``close()``
reclaims the pool -- the same contract as ``data.pipeline.Prefetcher``.

A store-service URL (``http(s)://``, a server of either package) becomes
an :class:`HttpStoreSource`: reads are window-granular ``/read?roi=``
requests, coalesced and cached server-side; each worker copies its window
to the card on its own stream, and the batch is assembled on the
consumer's stream after those copies, as for range reads.

``StoreLM`` adapts a loader into the LM batch interface (quantized window
values as token streams, computed on the device) so ``launch/train.py
--data-store`` trains straight from a compressed corpus, local or served.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.pipeline import DataConfig
from repro_torch.store import grid as grid_mod
from repro_torch.store.array import ArrayStore, CompressedArray, box_of_segment


# ------------------------------------------------------------------ sampling
class WindowSampler:
    """Deterministic, restart-reproducible, rank-sharded window plan.

    ``origins_at(step)`` returns the ``(batch, ndim)`` window origins for
    one step, seeded by ``SeedSequence([seed, step, rank])`` -- a pure
    function of its inputs, independent of iteration history, so any rank
    can seek to any step.  ``global_batch`` splits evenly across ranks
    (each rank draws its own ``batch = global_batch // num_ranks`` windows
    from a rank-disjoint stream, mirroring ``SyntheticLM``).

    ``epochs=N`` switches to multi-epoch WITHOUT-REPLACEMENT sampling: the
    candidate set is the non-overlapping window tiling of the array
    (``prod(d_i // w_i)`` windows), each epoch visits every candidate
    exactly once in a fresh ``SeedSequence([seed, _EPOCH_TAG, epoch])``
    permutation, and the permutation is consumed in global-draw order
    (``step * global_batch + rank * batch + i``), so ranks stay disjoint
    and any rank can still seek to any step without history.  Iteration is
    bounded: ``origins_at`` raises past :attr:`num_steps` (the last step
    whose full global batch fits in ``epochs`` passes).
    """

    _EPOCH_TAG = 0x5A17EB   # domain-separates epoch perms from step draws

    def __init__(self, shape, window_shape, global_batch: int, *,
                 seed: int = 0, rank: int = 0, num_ranks: int = 1,
                 epochs: int | None = None):
        self.shape = tuple(int(d) for d in shape)
        self.window_shape = tuple(int(w) for w in window_shape)
        if len(self.window_shape) != len(self.shape):
            raise ValueError(
                f"window shape {self.window_shape} rank does not match "
                f"array shape {self.shape}"
            )
        for w, d in zip(self.window_shape, self.shape):
            if not 1 <= w <= d:
                raise ValueError(
                    f"window dim {w} out of range [1, {d}] for shape "
                    f"{self.shape}"
                )
        if num_ranks < 1 or not 0 <= rank < num_ranks:
            raise ValueError(f"rank {rank} out of range [0, {num_ranks})")
        if global_batch < 1 or global_batch % num_ranks:
            raise ValueError(
                f"global batch {global_batch} does not split over "
                f"{num_ranks} ranks"
            )
        self.seed = int(seed)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.batch = global_batch // num_ranks
        if epochs is None:
            self.epochs = None
        else:
            if isinstance(epochs, bool) or int(epochs) < 1:
                raise ValueError(f"epochs must be a positive int, got {epochs!r}")
            self.epochs = int(epochs)
            self._tiles = tuple(
                d // w for d, w in zip(self.shape, self.window_shape)
            )
            self._nwin = int(np.prod(self._tiles, dtype=np.int64))
            if self._nwin < global_batch:
                raise ValueError(
                    f"epochs= mode needs at least one global batch of "
                    f"candidate windows per epoch ({self._nwin} non-"
                    f"overlapping windows < global batch {global_batch})"
                )
            self._perm_cache: tuple[int | None, np.ndarray | None] = (None, None)

    @property
    def num_steps(self) -> int:
        """Steps available under ``epochs=`` (full global batches only)."""
        if self.epochs is None:
            raise ValueError("num_steps is only defined with epochs= set")
        return (self.epochs * self._nwin) // (self.batch * self.num_ranks)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        cached_epoch, cached = self._perm_cache
        if cached_epoch == epoch:
            return cached
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._EPOCH_TAG, epoch])
        )
        perm = rng.permutation(self._nwin)
        self._perm_cache = (epoch, perm)
        return perm

    def origins_at(self, step: int) -> np.ndarray:
        if self.epochs is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, int(step), self.rank])
            )
            cols = [
                rng.integers(0, d - w + 1, size=self.batch, dtype=np.int64)
                for d, w in zip(self.shape, self.window_shape)
            ]
            return np.stack(cols, axis=1)
        step = int(step)
        gb = self.batch * self.num_ranks
        g = step * gb + self.rank * self.batch \
            + np.arange(self.batch, dtype=np.int64)
        if step < 0 or int(g[-1]) >= self.epochs * self._nwin:
            raise ValueError(
                f"step {step} out of range [0, {self.num_steps}) for "
                f"epochs={self.epochs} over {self._nwin} candidate windows"
            )
        epoch = g // self._nwin
        pos = g % self._nwin
        flat = np.empty(self.batch, np.int64)
        for e in np.unique(epoch):       # a batch spans at most 2 epochs
            m = epoch == e
            flat[m] = self._epoch_perm(int(e))[pos[m]]
        coords = np.stack(np.unravel_index(flat, self._tiles), axis=1)
        return coords * np.asarray(self.window_shape, dtype=np.int64)


def window_for_values(shape, nvalues: int) -> tuple[int, ...]:
    """Smallest trailing-dims-whole window holding >= ``nvalues`` values.

    Mirrors ``grid.default_chunk_shape``: windows that keep trailing dims
    whole map to leading-axis slabs of each chunk, where the block range
    covering the window is tight -- decoded bytes ~ window bytes.
    """
    shape = tuple(int(d) for d in shape)
    rem = max(int(nvalues), 1)
    out: list[int] = []
    for dim in reversed(shape):
        take = min(dim, rem)
        out.append(take)
        rem = -(-rem // dim) if take == dim else 1
    return tuple(reversed(out))


# ------------------------------------------------------------------ planning
def plan_batch(grid, block_size: int, origins: np.ndarray, window_shape):
    """Coalesced read plan for one batch of windows.

    Returns ``(tasks, placements)``: ``tasks`` maps each touched chunk id to
    the MERGED SZx block range ``[lo_b, hi_b)`` covering every window piece
    that lands in it (one fetch + one range decode per chunk per batch);
    ``placements`` are ``(window_index, chunk_id, local_ranges, out_ranges)``
    records describing how decoded segments scatter into the batch array.
    """
    tasks: dict[int, tuple[int, int]] = {}
    placements: list[tuple] = []
    window_shape = tuple(window_shape)
    dims_cache: dict[int, tuple[int, ...]] = {}
    for wi, origin in enumerate(origins):
        roi = grid_mod.ROI(
            tuple((int(o), int(o) + w) for o, w in zip(origin, window_shape)),
            (False,) * len(window_shape),
        )
        for cid, local, outr in grid_mod.intersecting_chunks(grid, roi):
            cdims = dims_cache.get(cid)
            if cdims is None:
                cdims = dims_cache[cid] = grid.chunk_dims(grid.chunk_coord(cid))
            lo_b, hi_b = grid_mod.block_range_for_box(local, cdims, block_size)
            cur = tasks.get(cid)
            tasks[cid] = (lo_b, hi_b) if cur is None else (
                min(cur[0], lo_b), max(cur[1], hi_b)
            )
            placements.append((wi, cid, local, outr))
    return tasks, placements


def _assemble(out: torch.Tensor, placements, segs, grid, block_size: int) -> None:
    """Scatter decoded chunk segments into the batch tensor, on the current
    stream of ``out``'s device.

    ``segs`` maps chunk id -> ``(flat_values, lo_b)`` where ``flat_values``
    covers the chunk's blocks ``[lo_b, hi_b)`` in C order (exactly what
    ``CompressedArray._decode_chunk_range`` returns); each window piece is a
    strided view of its segment (``store.array.box_of_segment``).
    """
    dims_cache: dict[int, tuple[int, ...]] = {}
    for wi, cid, local, outr in placements:
        seg, lo_b = segs[cid]
        cdims = dims_cache.get(cid)
        if cdims is None:
            cdims = dims_cache[cid] = grid.chunk_dims(grid.chunk_coord(cid))
        out_sl = (wi,) + tuple(slice(lo, hi) for lo, hi in outr)
        out[out_sl] = box_of_segment(seg, local, cdims, lo_b * block_size)


# ------------------------------------------------------------------- sources
class StoreSource:
    """Thread-safe chunk-range reader over a local ``ArrayStore``.

    ``CompressedArray`` instances are NOT thread-safe (one shared seek
    cursor), so path/manifest targets get one lazily opened handle PER
    WORKER THREAD (footer parsed once per thread, then reused for every
    batch); an already-open ``CompressedArray`` is shared behind a lock
    instead, held over the whole range read: the file reads, the host parse
    and the decode's launch (reads serialize -- handy for spy-file tests and
    tiny stores).  An attached ``cache`` memoizes decoded chunk ranges
    across all handles.

    ``device`` is where the ranges decode (``None``: the card, which must be
    there) and ``fused_range`` picks the decode route, as
    ``ArrayStore.open`` takes them; an open array keeps its own.
    """

    granularity = "chunk"

    def __init__(self, target, *, device=None, fused_range: bool = False,
                 cache=None, cache_ns: str | None = None):
        self._lock = threading.Lock()
        self._handles: list = []
        self._tl = threading.local()
        if isinstance(target, CompressedArray):
            self._shared = target
            self._open_kw = None
            head = target
        else:
            self._shared = None
            self._target = target if isinstance(target, dict) else os.fspath(target)
            self._open_kw = dict(device=device, fused_range=fused_range, cache=cache,
                                 cache_ns=cache_ns)
            head = self._handle()
        self.grid = head._grid
        self.block_size = head._block_size
        self.shape = head.shape
        self.dtype = head.dtype
        self.device = head._device
        self.error_bound = head.error_bound
        self.stored_bytes = head.stored_bytes

    def _handle(self) -> CompressedArray:
        ca = getattr(self._tl, "ca", None)
        if ca is None:
            ca = ArrayStore.open(self._target, **self._open_kw)
            self._tl.ca = ca
            with self._lock:
                self._handles.append(ca)
        return ca

    def read_range(self, cid: int, lo_b: int, hi_b: int) -> torch.Tensor:
        """Flat decoded values of blocks ``[lo_b, hi_b)`` of chunk ``cid``,
        queued on the calling thread's current stream.  With telemetry on,
        each range read is a ``store.read`` span (the reference spans only
        ROI reads), so a trace shows where a batch's time goes."""
        if not obs.enabled():
            return self._read_range(cid, lo_b, hi_b)
        with obs.span("store.read", chunk=cid, lo=lo_b, hi=hi_b):
            return self._read_range(cid, lo_b, hi_b)

    def _read_range(self, cid: int, lo_b: int, hi_b: int) -> torch.Tensor:
        if self._shared is not None:
            with self._lock:
                return self._shared._decode_chunk_range(cid, lo_b, hi_b)
        return self._handle()._decode_chunk_range(cid, lo_b, hi_b)

    def close(self) -> None:
        with self._lock:
            handles, self._handles = self._handles, []
        for ca in handles:
            ca.close()


class HttpStoreSource:
    """Window reader over a running store service (either package's).

    Reads are window-granular (``/read?roi=``): coalescing and the decoded
    chunk cache live SERVER-side, so the wire carries exactly the decoded
    window bytes and repeated-chunk decode cost is amortized by the
    service's LRU.  One client serves all worker threads (each request is
    an independent connection).  Each window comes back as a tensor on
    ``device`` (``None``: the card, which must be there), copied there on
    the calling thread's current stream.
    """

    granularity = "window"

    def __init__(self, url: str, *, timeout: float = 60.0, device=None):
        from repro_torch.serve.client import RemoteStore

        self.remote = RemoteStore(url, timeout=timeout, device=device)
        self.device = self.remote.device
        self.shape = self.remote.shape
        self.dtype = self.remote.dtype

    def read_window(self, origin, window_shape) -> torch.Tensor:
        from repro_torch.serve.client import body_tensor

        roi = ",".join(f"{int(o)}:{int(o) + int(w)}" for o, w in zip(origin, window_shape))
        _headers, body = self.remote.read_bytes(roi)
        return body_tensor(body, self.dtype, tuple(int(w) for w in window_shape),
                           self.device)

    def close(self) -> None:
        pass


def make_source(store, *, device=None, fused_range: bool = False, cache=None,
                timeout: float = 60.0):
    """Normalize a loader target into a source: an existing source passes
    through, ``http(s)://`` URLs become :class:`HttpStoreSource`, everything
    else (path, shard-manifest path, manifest dict, open
    ``CompressedArray``) becomes a :class:`StoreSource`."""
    if hasattr(store, "granularity"):
        return store
    if isinstance(store, str) and store.startswith(("http://", "https://")):
        return HttpStoreSource(store, timeout=timeout, device=device)
    return StoreSource(store, device=device, fused_range=fused_range, cache=cache)


# -------------------------------------------------------------------- loader
class StoreLoader:
    """Streaming window-batch loader over a compressed array store.

    ``batch_at(step)`` is the serial reference: the exact ``(batch,
    *window_shape)`` tensor the pipelined iterator yields for that step, on
    the store's device.  ``batches(start_step)`` returns the pipelined
    iterator (worker pool + bounded lookahead); both read only the
    coalesced block ranges the batch's windows touch.

    Yielded batches live in a ring of ``reuse_slots`` preallocated buffers
    on the device: a batch is valid until ``reuse_slots`` further batches
    have been drawn (pass ``copy=True`` to own every batch).  A batch is
    written on the stream that is current when it is drawn, so work queued
    there on an earlier batch is done before its slot is written again.
    ``workers=0`` keeps planning on the consumer thread (the reads still
    run on one pool thread, as in the reference).
    """

    def __init__(self, store, window_shape, batch_size: int, *,
                 seed: int = 0, rank: int = 0, num_ranks: int = 1,
                 epochs: int | None = None,
                 workers: int = 2, lookahead: int = 2,
                 device=None, fused_range: bool = False, cache=None,
                 copy: bool = False, reuse_slots: int = 3):
        self.source = make_source(store, device=device, fused_range=fused_range,
                                  cache=cache)
        self._owns_source = self.source is not store
        self.window_shape = tuple(int(w) for w in window_shape)
        self.sampler = WindowSampler(
            self.source.shape, self.window_shape, batch_size,
            seed=seed, rank=rank, num_ranks=num_ranks, epochs=epochs,
        )
        self.workers = max(int(workers), 0)
        self.lookahead = max(int(lookahead), 1)
        self.copy = bool(copy)
        self.reuse_slots = max(int(reuse_slots), 2)

    # ------------------------------------------------------------- metadata
    @property
    def batch_shape(self) -> tuple[int, ...]:
        return (self.sampler.batch,) + self.window_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.source.dtype

    @property
    def device(self) -> torch.device:
        return self.source.device

    @property
    def window_bytes(self) -> int:
        return math.prod(self.window_shape) * self.dtype.itemsize

    def _empty(self) -> torch.Tensor:
        return torch.empty(self.batch_shape, dtype=self.dtype, device=self.device)

    # ---------------------------------------------------------- serial path
    def batch_at(self, step: int, *, out: torch.Tensor | None = None) -> torch.Tensor:
        if not obs.enabled():
            return self._batch_at_impl(step, out=out)
        with obs.span("ingest.batch", step=step):
            res = self._batch_at_impl(step, out=out)
        obs.counter("ingest.batches", mode="serial").inc()
        return res

    def _batch_at_impl(self, step: int, *, out: torch.Tensor | None = None) -> torch.Tensor:
        if out is None:
            out = self._empty()
        origins = self.sampler.origins_at(step)
        if self.source.granularity == "window":
            for wi, org in enumerate(origins):
                out[wi] = self.source.read_window(org, self.window_shape)
            return out
        tasks, placements = plan_batch(
            self.source.grid, self.source.block_size, origins, self.window_shape,
        )
        segs = {
            cid: (self.source.read_range(cid, lo_b, hi_b), lo_b)
            for cid, (lo_b, hi_b) in tasks.items()
        }
        _assemble(out, placements, segs, self.source.grid, self.source.block_size)
        return out

    # ------------------------------------------------------- pipelined path
    def batches(self, start_step: int = 0, steps: int | None = None
                ) -> "PipelinedBatches":
        return PipelinedBatches(self, start_step, steps)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if self._owns_source:
            self.source.close()

    def __enter__(self) -> "StoreLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PipelinedBatches:
    """Ordered pipelined batch iterator (the loader's hot path).

    Chunk tasks (or, from a service, window reads) for up to ``lookahead +
    1`` upcoming batches are in flight on the pool at once; batches yield
    strictly in step order.  On the card each worker thread decodes (or
    copies its window to the card) on a CUDA stream of its own and records
    an event after that work; ``__next__`` makes the consumer's current
    stream wait on those events (no device-wide synchronize) and assembles
    the batch there.  Consumer contract matches ``Prefetcher``: a
    worker exception re-raises from ``__next__`` (after which the iterator
    is closed), ``close()`` cancels pending work and reclaims the pool, and
    the iterator is a context manager.  With telemetry on, each batch drawn
    is an ``ingest.batch`` span on the consumer's thread (the reference
    spans only serial batches) beside the reference's counters.
    """

    def __init__(self, loader: StoreLoader, start_step: int,
                 steps: int | None):
        self._ld = loader
        self._next_step = int(start_step)
        self._end = None if steps is None else int(start_step) + int(steps)
        if loader.sampler.epochs is not None:
            # without-replacement sampling is bounded: stop at the last full
            # global batch instead of letting origins_at raise mid-iteration
            bound = loader.sampler.num_steps
            self._end = bound if self._end is None else min(self._end, bound)
        self._pending: deque = deque()
        self._pool = ThreadPoolExecutor(
            max_workers=max(loader.workers, 1),
            thread_name_prefix="store-loader",
        )
        self._tl = threading.local()
        self._slots = None if loader.copy else [
            loader._empty() for _ in range(loader.reuse_slots)
        ]
        self._closed = False

    def _on_stream(self, read, *args):
        """Worker: ``(read(*args), event recorded after its work or None)``;
        on the card ``read`` runs on this thread's own stream."""
        dev = self._ld.device
        if dev.type != "cuda":
            return read(*args), None
        stream = getattr(self._tl, "stream", None)
        if stream is None:
            stream = self._tl.stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            res = read(*args)
        done = torch.cuda.Event()
        done.record(stream)
        return res, done

    def _submit_one(self) -> bool:
        step = self._next_step
        if self._end is not None and step >= self._end:
            return False
        ld = self._ld
        track = obs.enabled()
        t0 = time.perf_counter() if track else 0.0
        origins = ld.sampler.origins_at(step)
        if ld.source.granularity == "window":
            futs = {
                wi: self._pool.submit(self._on_stream, ld.source.read_window, org, ld.window_shape)
                for wi, org in enumerate(origins)
            }
            self._pending.append((step, futs, None))
        else:
            tasks, placements = plan_batch(
                ld.source.grid, ld.source.block_size, origins, ld.window_shape,
            )
            futs = {
                cid: self._pool.submit(self._on_stream, ld.source.read_range, cid, lo_b, hi_b)
                for cid, (lo_b, hi_b) in tasks.items()
            }
            self._pending.append((step, futs, (tasks, placements)))
        if track:
            obs.histogram("ingest.plan_seconds").observe(time.perf_counter() - t0)
            obs.gauge("ingest.lookahead").set(len(self._pending))
        self._next_step = step + 1
        return True

    def __iter__(self) -> "PipelinedBatches":
        return self

    def __next__(self) -> torch.Tensor:
        if self._closed:
            raise StopIteration
        while len(self._pending) <= self._ld.lookahead and self._submit_one():
            pass
        if not self._pending:
            self.close()
            raise StopIteration
        step, futs, plan = self._pending.popleft()
        track = obs.enabled()
        if track:
            obs.gauge("ingest.lookahead").set(len(self._pending))
        out = self._ld._empty() if self._slots is None \
            else self._slots[step % len(self._slots)]
        t0 = time.perf_counter() if track else 0.0
        try:
            if not track:
                self._gather(out, futs, plan)
            else:
                with obs.span("ingest.batch", step=step):
                    self._gather(out, futs, plan)
        except BaseException:
            self.close()
            raise
        if track:
            obs.histogram("ingest.wait_seconds").observe(time.perf_counter() - t0)
            obs.counter("ingest.batches", mode="pipelined").inc()
            obs.counter("ingest.bytes_out").inc(int(out.nbytes))
        return out

    @staticmethod
    def _ready(t: torch.Tensor, done) -> torch.Tensor:
        """A worker's result, usable on the consumer's current stream once
        the worker's event has passed."""
        if done is not None:
            consumer = torch.cuda.current_stream(t.device)
            consumer.wait_event(done)
            t.record_stream(consumer)      # freed only after the consumer's reads
        return t

    def _gather(self, out: torch.Tensor, futs: dict, plan) -> None:
        """Wait for a batch's reads and assemble it into ``out`` on the
        consumer's current stream: windows (``plan`` None) row by row,
        range reads through ``plan = (tasks, placements)``."""
        if plan is None:
            for wi, fut in futs.items():
                out[wi] = self._ready(*fut.result())
            return
        tasks, placements = plan
        segs = {cid: (self._ready(*fut.result()), tasks[cid][0]) for cid, fut in futs.items()}
        _assemble(out, placements, segs, self._ld.source.grid, self._ld.source.block_size)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for entry in self._pending:
            for fut in entry[1].values():
                fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "PipelinedBatches":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------- LM adapter
class StoreLM:
    """LM batch source over a compressed store: the ``--data-store`` path.

    Each sampled window's first ``seq_len + 1`` values (C order) are
    min/max-normalized per window and quantized into token ids
    ``[1, vocab - 2]`` (0 and ``vocab - 1`` stay reserved); ``labels`` is
    the one-step shift.  The quantization runs on the store's device in
    float64, in the reference's order of operations, so ``tokens`` and
    ``labels`` (int32 tensors there) equal the reference's bit for bit.
    ``batch_at(step, rank, num_ranks)`` mirrors ``SyntheticLM`` exactly --
    the stream is a pure function of the store contents and ``(cfg.seed,
    step, rank)``, so Trainer's restart-from-checkpoint replay holds.
    """

    def __init__(self, store, cfg: DataConfig, *, window_shape=None,
                 workers: int = 2, lookahead: int = 2,
                 device=None, fused_range: bool = False, cache=None):
        if cfg.vocab_size < 4:
            raise ValueError("StoreLM needs vocab_size >= 4")
        self.cfg = cfg
        self.source = make_source(store, device=device, fused_range=fused_range,
                                  cache=cache)
        self._needs = cfg.seq_len + 1
        self.window_shape = tuple(int(w) for w in window_shape) \
            if window_shape is not None \
            else window_for_values(self.source.shape, self._needs)
        if math.prod(self.window_shape) < self._needs:
            raise ValueError(
                f"window {self.window_shape} holds "
                f"{math.prod(self.window_shape)} values; seq_len "
                f"{cfg.seq_len} needs {self._needs}"
            )
        self._workers = workers
        self._lookahead = lookahead
        self._loaders: dict[tuple[int, int], StoreLoader] = {}

    def _loader(self, rank: int, num_ranks: int) -> StoreLoader:
        key = (rank, num_ranks)
        ld = self._loaders.get(key)
        if ld is None:
            ld = self._loaders[key] = StoreLoader(
                self.source, self.window_shape, self.cfg.global_batch,
                seed=self.cfg.seed, rank=rank, num_ranks=num_ranks,
                workers=self._workers, lookahead=self._lookahead,
            )
        return ld

    def _to_batch(self, wins: torch.Tensor) -> dict:
        vocab = self.cfg.vocab_size
        b = wins.shape[0]
        v = wins.to(torch.float64).reshape(b, -1)[:, : self._needs]
        lo = v.amin(dim=1, keepdim=True)
        hi = v.amax(dim=1, keepdim=True)
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        q = torch.floor((v - lo) / span * (vocab - 3)).to(torch.int32) + 1
        q = q.clamp(1, vocab - 2)
        return {"tokens": q[:, :-1].contiguous(), "labels": q[:, 1:].contiguous()}

    def batch_at(self, step: int, rank: int = 0, num_ranks: int = 1) -> dict:
        return self._to_batch(self._loader(rank, num_ranks).batch_at(step))

    def batches(self, rank: int = 0, num_ranks: int = 1, start_step: int = 0):
        it = self._loader(rank, num_ranks).batches(start_step=start_step)
        try:
            for wins in it:
                yield self._to_batch(wins)
        finally:
            it.close()

    def close(self) -> None:
        self.source.close()


class SteppedBatches:
    """``batch_fn(step)`` adapter over a pipelined batch stream.

    The Trainer calls ``batch_fn`` with monotonically increasing steps --
    except after restart-from-checkpoint, where it jumps backward.  The
    adapter keeps one pipelined iterator alive for the common sequential
    case and transparently re-opens it at the requested step whenever the
    sequence breaks, so fault-tolerant replay stays exact while steady
    state stays pipelined.

    ``open_at`` is any ``start_step -> iterator`` factory (e.g.
    ``lambda s: store_lm.batches(start_step=s)``).
    """

    def __init__(self, open_at):
        self._open_at = open_at
        self._it = None
        self._expect: int | None = None

    def __call__(self, step: int):
        if self._it is None or step != self._expect:
            self.close()
            self._it = self._open_at(step)
        batch = next(self._it)
        self._expect = step + 1
        return batch

    def close(self) -> None:
        it, self._it = self._it, None
        self._expect = None
        if it is not None:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def __enter__(self) -> "SteppedBatches":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
