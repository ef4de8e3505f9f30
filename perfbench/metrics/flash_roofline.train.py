"""The flash-attention forward kernel's share of its roofline over the
traced steps: each launch (the forward and the recompute of each layer) at
the step's shape (``counts.attention_flops``) at the bf16 peak, over the
kernel's device time by name."""
from perfbench import counts

KERNEL = "flash_fwd"


def read(run):
    tr = run.trace
    if tr is None or not tr.work or not run.peaks:
        return None
    secs, launches = tr.kernel_seconds(KERNEL)
    if not secs or launches % (run.arch.layers * len(tr.work)):
        return None
    ops = launches * counts.attention_flops(run.arch, run.mix["batch"], run.mix["seq"])
    return 100.0 * ops / run.peaks["bf16_flops"] / secs
