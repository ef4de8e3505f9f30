"""Thread-safe metric registry: counters, gauges, fixed-bucket histograms,
plus the bounded span log and codec frame log.

Everything here is stdlib-only and allocation-light: one small lock per
metric (so concurrent observers never contend on a global lock for the
increment itself), one registry-level lock for metric creation and the two
bounded logs.  The registry never samples the clock -- callers time with
``time.perf_counter_ns`` and hand finished durations in -- so a
:class:`Registry` is equally usable from tests, the serve tier, and the
codec hot paths.

Metric names are dotted lowercase (``codec.compress.calls``); label sets are
part of the metric identity, so ``counter("x", route="/a")`` and
``counter("x", route="/b")`` are two series of one family (exactly the
Prometheus data model, see :mod:`repro_torch.obs.export`).
"""
from __future__ import annotations

import bisect
import threading
from collections import deque

# Default histogram buckets: wall-time seconds from 100us to 10s.  Chosen to
# straddle the codec's per-chunk encode/decode times (ms) and the serve
# tier's request latencies (sub-ms cache hits to multi-second cold reads).
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (also supports add/sub for occupancy tracking)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative counts at export time).

    ``buckets`` are ascending upper bounds; one implicit +Inf bucket is
    appended.  ``observe`` is O(log n_buckets) via bisect.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "buckets", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, labels: dict, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram buckets must ascend: {buckets}")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def value(self):
        """(per-bucket counts, sum, count) -- non-cumulative counts."""
        with self._lock:
            return list(self._counts), self._sum, self._count


class Registry:
    """Thread-safe home for metrics, the span log, and the codec frame log.

    The two logs are bounded deques (oldest entries drop); aggregate span
    timings survive the bound in ``span_aggregates`` so long runs still
    export correct totals.
    """

    def __init__(self, *, max_spans: int = 16384, max_frames: int = 4096):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._frames: deque = deque(maxlen=max_frames)
        self._span_agg: dict[str, list] = {}

    # ------------------------------------------------------------- metrics
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, buckets=DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    # ---------------------------------------------------------------- logs
    def record_span(self, name: str, t0_ns: int, dur_ns: int, tid: int,
                    depth: int, attrs: dict | None) -> None:
        with self._lock:
            self._spans.append((name, t0_ns, dur_ns, tid, depth, attrs))
            agg = self._span_agg.get(name)
            if agg is None:
                self._span_agg[name] = [1, dur_ns]
            else:
                agg[0] += 1
                agg[1] += dur_ns

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def span_aggregates(self) -> dict[str, tuple[int, int]]:
        """name -> (count, total_ns); survives the span-log bound."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._span_agg.items()}

    def record_frame(self, rec: dict) -> None:
        with self._lock:
            self._frames.append(rec)

    def frames(self) -> list[dict]:
        with self._lock:
            return list(self._frames)

    # ------------------------------------------------------------ lifecycle
    def snapshot(self) -> dict:
        """JSON-able view: metric families -> {label-string: value}."""
        out: dict = {}
        for m in self.metrics():
            fam = out.setdefault(m.name, {"kind": m.kind, "series": {}})
            lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
            if m.kind == "histogram":
                counts, total, count = m.value
                fam["series"][lbl] = {
                    "count": count, "sum": total,
                    "buckets": dict(zip([*map(str, m.buckets), "+Inf"],
                                        counts)),
                }
            else:
                fam["series"][lbl] = m.value
        spans = {
            name: {"count": c, "total_s": t * 1e-9}
            for name, (c, t) in sorted(self.span_aggregates().items())
        }
        return {"metrics": out, "spans": spans}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._spans.clear()
            self._frames.clear()
            self._span_agg.clear()
