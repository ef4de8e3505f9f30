"""Tokens of all completed steps over the time from the window's start to
the end of its last step, synchronized."""


def read(run):
    if not run.steps:
        return None
    return sum(s[2] for s in run.steps) / run.window_s
