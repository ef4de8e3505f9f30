"""The traced part of a window: torch.profiler over whole requests or steps,
reduced to device intervals, busy time, kernel times by name and the host's
activity in the longest idle gaps.

The profiler starts and stops between requests (or steps) after a
synchronize, so every kernel of the traced work lies inside it.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType


@dataclass
class Trace:
    window_s: float = 0.0
    kernels: list = field(default_factory=list)        # (name, start_us, end_us) on the device
    host_ops: list = field(default_factory=list)       # (start_us, end_us, name) on the host
    work: list = field(default_factory=list)           # what ran: prompt lengths or step indices

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def merged(self) -> list:
        """Union of the device intervals, in order."""
        out = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_seconds(self, part: str) -> tuple[float, int]:
        """Total device seconds and launches of kernels whose name holds ``part``."""
        hits = [b - a for name, a, b in self.kernels if part in name]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between device intervals, summed by the innermost
        host operation running at each gap's start (the longest 200 gaps)."""
        iv = self.merged()
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1]) for i in range(len(iv) - 1)),
                      reverse=True)[:200]
        ops = sorted(self.host_ops)
        starts = [o[0] for o in ops]
        by = {}
        for length, at in gaps:
            name = "host outside any operation"
            j = bisect.bisect_right(starts, at) - 1
            for k in range(j, max(j - 64, -1), -1):     # the latest-started that spans it
                if ops[k][1] >= at:
                    name = ops[k][2]
                    break
            by[name] = by.get(name, 0.0) + length / 1e6
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Tracer:
    """``start()`` and ``stop()`` around whole units of work; ``reduce()``,
    once the window has closed, turns the profile into a :class:`Trace`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._work = None          # what the stopped profile covers

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, work: list) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._window = time.perf_counter() - self._t0
        self._prof.stop()
        self._work = list(work)

    @property
    def stopped(self) -> bool:
        return self._work is not None

    def reduce(self) -> Trace | None:
        if not self.stopped:
            return None
        tr = Trace(window_s=self._window, work=self._work)
        for e in self._prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                tr.kernels.append((e.name, a, b))
            else:
                tr.host_ops.append((a, b, e.name))
        self._prof = self._work = None
        return tr
