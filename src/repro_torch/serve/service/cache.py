"""Size-bounded LRU cache for decoded chunk ranges, on the card.

Counterpart of ``repro/serve/service/cache.py``.  The serving tier's
working-set memory: hot chunks decode ONCE and serve many readers.  Keys are
``(namespace, chunk_id, lo_block, hi_block)`` where the namespace encodes
store identity AND content version (the registry uses the store's ETag, so
replacing a store file on disk implicitly invalidates every cached chunk of
the old bytes -- no explicit flush protocol).

The values are the decoded segments that
``CompressedArray._decode_chunk_range`` puts: tensors on the store's
device, which is the card unless the service was asked for the CPU.  The
budget (``max_bytes``, 256 MiB by default) therefore bounds DEVICE memory
held by decoded chunks, not host memory.  A segment is complete on the card
before it is put (the store synchronizes its stream first), so a reader on
any thread or stream may use what ``get`` returns; readers must not write
into it.

Thread-safe: one mutex around the OrderedDict; get/put are O(1).  The
budget bounds decoded bytes held, not entry count.  Counters
(hits/misses/evictions) are served at ``/v1/metrics``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class LRUBytesCache:
    """LRU keyed mapping bounded by total value bytes, with hit counters."""

    def __init__(self, max_bytes: int = 256 << 20):
        if max_bytes < 0:
            raise ValueError("cache budget must be >= 0")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._data: OrderedDict = OrderedDict()   # key -> (value, nbytes)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key, value, nbytes: int) -> None:
        nbytes = int(nbytes)
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if nbytes > self.max_bytes:
                # value alone busts the budget: don't thrash the whole cache
                return
            self._data[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes:
                _k, (_v, nb) = self._data.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
            }
