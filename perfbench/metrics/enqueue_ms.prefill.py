"""Median over the window's requests of the host time of the
``engine.prefill`` call, up to its return and before the first token is
read (the benchmark's own span)."""
import statistics


def read(run):
    if not run.requests:
        return None
    return statistics.median(r[3] for r in run.requests) * 1e3
