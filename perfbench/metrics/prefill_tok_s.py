"""Prompt tokens of every request of the window over the window's time."""


def read(run):
    if not run.requests:
        return None
    return sum(r[2] for r in run.requests) / run.window_s
