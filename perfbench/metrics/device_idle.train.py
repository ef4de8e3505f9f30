"""Share of the traced window in which nothing ran on the device (the union
of the profiler's kernel and copy intervals), in percent."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
