"""The program's own spans in a :class:`perfbench.trace.Trace`: the host
ranges that ``repro_torch.obs`` opens on the profiler's timeline while it
records (``serve.prefill``, ``train.grad_exchange``, ...), on the clock of
the device intervals, so that the card's idle time inside a span can be
read.  A program without such spans leaves a trace with none, and every
reading here is then None.
"""
from __future__ import annotations

import bisect

LAUNCHES = ("cudaLaunch", "cuLaunch")      # the host runtime's kernel launches


def of(trace, name: str) -> list | None:
    """The host intervals ``(start_us, end_us)`` of the spans named ``name``,
    in order: None without a trace, without device work, or with another
    number of them than one a traced prompt or step."""
    if trace is None or not trace.kernels:
        return None
    iv = sorted((a, b) for a, b, n in trace.host_ops if n == name)
    if not iv or len(iv) != len(trace.work):
        return None
    return iv


def idle_us(merged: list, a: float, b: float) -> float:
    """The microseconds of ``[a, b]`` that no device interval of ``merged``
    (``Trace.merged()``: disjoint, in order) covers."""
    busy = 0.0
    for x, y in merged[max(bisect.bisect_right(merged, [a]) - 1, 0):]:
        if x >= b:
            break
        busy += max(0.0, min(b, y) - max(a, x))
    return (b - a) - busy


def idle_ms(trace, name: str) -> list | None:
    """The device's idle milliseconds inside each span named ``name``."""
    iv = of(trace, name)
    if iv is None:
        return None
    merged = trace.merged()
    return [idle_us(merged, a, b) / 1e3 for a, b in iv]


def launches(trace, name: str) -> list | None:
    """The kernel launches the host made inside each span named ``name``."""
    iv = of(trace, name)
    if iv is None:
        return None
    starts = sorted(a for a, _, n in trace.host_ops if n.startswith(LAUNCHES))
    return [bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a) for a, b in iv]
