"""repro_torch.obs: dependency-free runtime telemetry for the SZx stack.

Counterpart of ``repro/obs``, copied so that the port imports nothing of
the reference: one global :class:`Registry` of counters / gauges /
fixed-bucket histograms, a ``span(name, **attrs)`` context manager with
monotonic timing and nesting, a bounded per-frame codec stream-stats log,
and three exporters (Prometheus text, Chrome ``trace_event`` JSON, human
summary table) with the reference's metric names, labels and text format.

Telemetry is OFF by default and costs nearly nothing while off: every
instrumented hot path checks :func:`enabled` -- a module-level flag read --
before allocating or recording anything, and ``span()`` returns a shared
no-op context manager when disabled.  Turn it on with ``SZX_OBS=1`` in the
environment or :func:`enable` at runtime::

    from repro_torch import obs

    obs.enable()
    ... run compression / training / serving ...
    print(obs.summary())
    obs.write_chrome_trace("trace.json")

Spans time the host clock and add no ``torch.cuda.synchronize``: with
telemetry on the program runs on the same schedule as with it off, so a
span around work that ends in a queued kernel measures the host's part
(planning, copies, launches); device time comes from ``torch.profiler``
(the train launcher's ``--profile-dir``).  Output bytes are identical with
telemetry on and off.

While a ``torch.profiler`` records, every span opened through ``span()``
or ``traced()`` also opens a host range of the same name on the
profiler's timeline, with telemetry on or off: a function-scope record
(``_RecordFunctionFast``), not a user annotation, so the device side of
the trace gains no event of its name and each idle gap on the card can be
put down to the spans around it.  The hot paths' spans: ``serve.prefill``
(with ``serve.prefill.forward`` and ``serve.prefill.kv_fill``),
``train.forward_backward``, ``train.grad_exchange``, ``train.optimizer``
and, per gradient leaf, ``gradcomp.encode``, ``gradcomp.all_gather`` and
``gradcomp.decode``.  With telemetry off and no profiler recording,
``span()`` reads two flags and returns the shared no-op.  The registry's
span log keeps ``perf_counter_ns`` times, which are not the profiler's
clock.
"""
from __future__ import annotations

import functools
import os
import threading
import time

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from repro_torch.obs import stream_stats
from repro_torch.obs.export import (
    chrome_trace,
    prometheus_text,
    summary,
    write_chrome_trace,
)
from repro_torch.obs.registry import DEFAULT_BUCKETS, Registry

__all__ = [
    "Registry", "REGISTRY", "DEFAULT_BUCKETS",
    "enabled", "enable", "disable",
    "counter", "gauge", "histogram", "span", "traced",
    "prometheus_text", "chrome_trace", "write_chrome_trace", "summary",
    "stream_stats", "reset",
]

REGISTRY = Registry()

_ENABLED = os.environ.get("SZX_OBS", "") not in ("", "0")
_local = threading.local()


def enabled() -> bool:
    """True when telemetry is recording (``SZX_OBS=1`` or :func:`enable`)."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Clear every metric, span, and frame record in the global registry."""
    REGISTRY.reset()


def counter(name: str, **labels):
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels):
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, *, buckets=DEFAULT_BUCKETS, **labels):
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def _depth() -> int:
    return getattr(_local, "depth", 0)


class _Span:
    """Live span: times with ``perf_counter_ns``, records on exit; while a
    profiler records, also a range of its name on the profiler's timeline."""

    __slots__ = ("name", "attrs", "_t0", "_rf")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = attrs or None

    def __enter__(self):
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        _local.depth = _depth() + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        depth = _depth()
        _local.depth = depth - 1
        REGISTRY.record_span(
            self.name, self._t0, dur, threading.get_ident(), depth,
            self.attrs,
        )
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        return _live(fn, self.name, self.attrs)


class _Range:
    """Span while only a profiler records: a range of its name on the
    profiler's timeline, nothing in the registry."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._rf.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        return _live(fn, self.name, None)


class _NullSpan:
    """Shared disabled-mode span: no allocation, no clock, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __call__(self, fn):
        # decorator applied while disabled: stay live under the function's
        # qualname so a later obs.enable() or profiler still sees the calls
        return _live(fn, fn.__qualname__, None)


_NULL = _NullSpan()


def _live(fn, name: str, attrs: dict | None):
    """``fn`` wrapped in a span of ``name``, both switches read on every call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not (_ENABLED or _profiler._is_profiler_enabled):
            return fn(*args, **kwargs)
        with _Span(name, attrs) if _ENABLED else _Range(name):
            return fn(*args, **kwargs)

    return wrapper


def span(name: str, **attrs):
    """Timed span context manager / decorator.

    When telemetry is disabled and no profiler records this returns a
    shared no-op object (two flags are read before any allocation).  When
    enabled, the span records (name, start, duration, thread, nesting
    depth, attrs) into the registry's span log on exit.  While a profiler
    records, it is also a range of ``name`` on the profiler's timeline.
    """
    if _ENABLED:
        return _Span(name, attrs)
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _NULL


def traced(name: str | None = None, **attrs):
    """Decorator form with a late check of both switches on every call, so
    functions decorated at import time respond to :func:`enable` and to a
    profiler started later."""

    def deco(fn):
        return _live(fn, name or fn.__qualname__, attrs or None)

    return deco
