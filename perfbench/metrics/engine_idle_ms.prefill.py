"""Median over the traced prompts of the device's idle time inside the
program's ``serve.prefill`` span (the whole ``engine.prefill`` call, on the
profiler's clock): how long the card waited on the engine's host work."""
import statistics

from perfbench import spans


def read(run):
    ms = spans.idle_ms(run.trace, "serve.prefill")
    return statistics.median(ms) if ms else None
