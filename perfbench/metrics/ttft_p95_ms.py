"""95th percentile over all requests of the window of the time from a
request's issue to its first token on the host."""
import statistics


def read(run):
    ms = [(r[1] - r[0]) * 1e3 for r in run.requests]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
