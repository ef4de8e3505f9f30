"""Model FLOPs of the window's prefills (``counts.prefill_flops``) over the
window's time at the device's bf16 peak, in percent."""
from perfbench import counts


def read(run):
    if not run.requests or not run.peaks:
        return None
    flops = sum(counts.prefill_flops(run.arch, r[2]) for r in run.requests)
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
