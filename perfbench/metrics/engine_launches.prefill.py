"""Median over the traced prompts of the kernel launches (host runtime
events ``cudaLaunch*``/``cuLaunch*``) inside the program's ``serve.prefill``
span."""
import statistics

from perfbench import spans


def read(run):
    n = spans.launches(run.trace, "serve.prefill")
    return statistics.median(n) if n else None
