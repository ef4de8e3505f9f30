"""Model FLOPs of the window's steps (``counts.train_flops``, no recompute)
over the window's time at the device's bf16 peak, in percent."""
from perfbench import counts


def read(run):
    if not run.steps or not run.peaks:
        return None
    flops = len(run.steps) * counts.train_flops(run.arch, run.mix["batch"], run.mix["seq"])
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
