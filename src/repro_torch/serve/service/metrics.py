"""Request counters and latency percentiles for the store service.

Counterpart of ``repro/serve/service/metrics.py``, with the same snapshot
schema and ``serve.*`` series.

Lock-guarded in-process counters plus a bounded ring of recent request
latencies per route class; the ``/v1/metrics`` endpoint serves
``snapshot()``.  Percentiles are computed over the ring at snapshot time
(the ring is small), so the hot path cost is one append under a mutex.

Every observation is also mirrored into the shared :mod:`repro_torch.obs`
registry (``serve.*`` series) when telemetry is enabled, so the service
shows up in the same Prometheus exposition / Chrome trace as the codec
and store layers; the local snapshot does not depend on it.
"""
from __future__ import annotations

import math
import threading
from collections import defaultdict, deque

from repro_torch import obs


class Metrics:
    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self.requests = 0
        self.errors = 0
        self.bytes_sent = 0
        self.by_route: dict[str, int] = defaultdict(int)
        self.by_status: dict[int, int] = defaultdict(int)
        self.by_tenant: dict[str, dict] = defaultdict(
            lambda: {"requests": 0, "bytes": 0}
        )
        self._lat: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self._window)
        )

    def observe(self, route: str, status: int, seconds: float,
                nbytes: int, tenant: str | None = None) -> None:
        with self._lock:
            self.requests += 1
            self.bytes_sent += nbytes
            self.by_route[route] += 1
            self.by_status[status] += 1
            if status >= 400:
                self.errors += 1
            if tenant is not None:
                t = self.by_tenant[tenant]
                t["requests"] += 1
                t["bytes"] += nbytes
            self._lat[route].append(seconds)
        if obs.enabled():
            obs.counter("serve.requests", route=route).inc()
            obs.counter("serve.responses", status=str(status)).inc()
            obs.counter("serve.bytes_sent").inc(nbytes)
            if status >= 400:
                obs.counter("serve.errors").inc()
            if tenant is not None:
                obs.counter("serve.tenant_requests", tenant=tenant).inc()
            obs.histogram("serve.request_seconds", route=route).observe(seconds)

    @staticmethod
    def _pct(samples: list[float], q: float) -> float:
        """Nearest-rank (ceil) percentile: the smallest sample s such that at
        least ``q`` of the samples are <= s.  The previous round-half-up rank
        over-shot on small windows (p50 of [10,20,30,40] gave 30, not 20)."""
        if not samples:
            return 0.0
        samples = sorted(samples)
        idx = max(math.ceil(q * len(samples)), 1) - 1
        return samples[min(idx, len(samples) - 1)]

    def snapshot(self) -> dict:
        with self._lock:
            lat = {
                route: {
                    "count": len(d),
                    "p50_ms": self._pct(list(d), 0.50) * 1e3,
                    "p99_ms": self._pct(list(d), 0.99) * 1e3,
                }
                for route, d in self._lat.items()
            }
            return {
                "requests": self.requests,
                "errors": self.errors,
                "bytes_sent": self.bytes_sent,
                "by_route": dict(self.by_route),
                "by_status": {str(k): v for k, v in self.by_status.items()},
                "by_tenant": {k: dict(v) for k, v in self.by_tenant.items()},
                "latency": lat,
            }
