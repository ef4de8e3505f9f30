"""Deterministic synthetic token pipeline with a compressed in-memory cache.

Counterpart of ``repro/data/pipeline.py``.  :class:`SyntheticLM` is numpy,
as there: the tokens of (seed, step, rank) are the reference's bit for bit,
so a restart at step N resumes the exact stream on either package.
:class:`CompressedInMemoryCache` keeps float shards SZx-compressed in host
memory through the port's :class:`SZxCodec` (on the card unless ``device=``
says otherwise) and decompresses them on demand.  The store-backed loader
(``StoreLM``, ``SteppedBatches``) is :mod:`repro_torch.data.store_loader`.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.codec.plan import Bound, as_bound
from repro_torch.core.codec.szx_codec import SZxCodec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    frames: int = 0            # enc-dec stub frames per example
    frame_dim: int = 0
    prefix_embeds: int = 0     # VLM stub patches per example
    prefix_dim: int = 0


class SyntheticLM:
    """Markov-ish synthetic token stream: deterministic, seekable, sharded."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, rank: int = 0, num_ranks: int = 1) -> dict:
        """numpy arrays: tokens and labels (B, S) int32, labels -1 at the end."""
        cfg = self.cfg
        if cfg.global_batch % num_ranks:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{num_ranks} ranks")
        b = cfg.global_batch // num_ranks
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, rank]))
        # zipf-ish marginal over the vocab with local repetition structure
        base = rng.zipf(1.3, size=(b, cfg.seq_len)).astype(np.int64)
        toks = (base % (cfg.vocab_size - 2)) + 1
        rep = rng.random((b, cfg.seq_len)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        tokens = toks.astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        out = {"tokens": tokens, "labels": labels}
        if cfg.frames:
            out["frames"] = rng.standard_normal((b, cfg.frames, cfg.frame_dim), dtype=np.float32)
        if cfg.prefix_embeds:
            out["image_embeds"] = rng.standard_normal(
                (b, cfg.prefix_embeds, cfg.prefix_dim), dtype=np.float32)
        return out

    def batches(self, rank: int = 0, num_ranks: int = 1, start_step: int = 0
                ) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step, rank, num_ranks)
            step += 1


class CompressedInMemoryCache:
    """SZx-compressed RAM cache of float32 shards.

    ``put`` compresses on the codec's device (``device=None``: the card) and
    keeps the stream bytes; ``get`` decompresses there and returns a tensor
    of the stored shape.  ``bound`` is a :class:`Bound` or a bare float
    (``Bound.abs``); the default, ``Bound.abs(1e-4)``, is strict, so
    consumers can rely on ``|x - x'| <= e``.

    Thread-safe: one lock covers the entry map and the byte counters.
    ``max_bytes`` caps the COMPRESSED footprint with LRU eviction (``put``
    and ``get`` both touch recency); ``None`` means unbounded."""

    def __init__(self, bound: Bound | float | None = None, *,
                 max_bytes: int | None = None, device=None):
        self.bound = Bound.abs(1e-4) if bound is None else as_bound(
            bound, owner="CompressedInMemoryCache")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.max_bytes = max_bytes
        self._codec = SZxCodec(device=device)
        self._lock = threading.Lock()
        self._store: collections.OrderedDict = collections.OrderedDict()
        self._raw_bytes = 0
        self._stored_bytes = 0
        self._evictions = 0

    @property
    def error_bound(self) -> float:
        return self.bound.value

    @property
    def mode(self) -> str:
        return self.bound.mode

    def put(self, key, arr) -> None:
        x = arr.to(torch.float32) if isinstance(arr, torch.Tensor) else \
            np.asarray(arr, np.float32)
        shape, nbytes = tuple(x.shape), int(np.prod(x.shape, dtype=np.int64)) * 4
        buf = self._codec.compress(x, self.bound)     # compress outside the lock
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._raw_bytes -= old[2]
                self._stored_bytes -= len(old[0])
            self._store[key] = (buf, shape, nbytes)
            self._raw_bytes += nbytes
            self._stored_bytes += len(buf)
            if self.max_bytes is not None:
                while self._stored_bytes > self.max_bytes and len(self._store) > 1:
                    _, (ebuf, _eshape, eraw) = self._store.popitem(last=False)
                    self._raw_bytes -= eraw
                    self._stored_bytes -= len(ebuf)
                    self._evictions += 1

    def get(self, key) -> torch.Tensor:
        with self._lock:
            buf, shape, _raw = self._store[key]
            self._store.move_to_end(key)
        return self._codec.decompress(buf).reshape(shape)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._store

    @property
    def compression_ratio(self) -> float:
        with self._lock:
            return self._raw_bytes / max(self._stored_bytes, 1)

    @property
    def stored_bytes(self) -> int:
        with self._lock:
            return self._stored_bytes

    @property
    def evictions(self) -> int:
        with self._lock:
            return self._evictions

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


class Prefetcher:
    """Background-thread prefetch of a batch iterator (host-side overlap).

    A worker exception is queued and re-raised from ``__next__`` on the
    consumer, after which the iterator is exhausted.  ``close()`` (or ``with
    Prefetcher(...)``) stops the worker, drains the queue and joins the
    thread."""

    _ITEM, _DONE, _ERROR = 0, 1, 2

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if not self._enqueue((self._ITEM, item)):
                    return
        except BaseException as exc:    # noqa: BLE001 -- relayed to the consumer
            self._enqueue((self._ERROR, exc))
        else:
            self._enqueue((self._DONE, None))

    def _enqueue(self, msg) -> bool:
        """Bounded put that gives up once close() is requested (a plain
        blocking put would deadlock shutdown against a full queue)."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        kind, val = self._q.get()
        if kind == self._ITEM:
            return val
        self._finished = True
        if kind == self._ERROR:
            raise val
        raise StopIteration

    def close(self) -> None:
        """Stop the worker and reclaim the thread; idempotent."""
        self._stop.set()
        self._finished = True
        while self._thread.is_alive():
            try:                        # drain so a blocked put can exit
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.05)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
