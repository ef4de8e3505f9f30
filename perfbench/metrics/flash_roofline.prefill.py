"""The flash-attention forward kernel's share of its roofline over the
traced prefills: their attention operations (``counts.attention_flops``,
each layer) at the bf16 peak, over the kernel's device time by name.
Nothing where the trace holds another number of launches than one a layer
and prompt."""
from perfbench import counts

KERNEL = "flash_fwd"


def read(run):
    tr = run.trace
    if tr is None or not tr.work or not run.peaks:
        return None
    secs, launches = tr.kernel_seconds(KERNEL)
    if not secs or launches != run.arch.layers * len(tr.work):
        return None
    ops = sum(run.arch.layers * counts.attention_flops(run.arch, 1, s) for s in tr.work)
    return 100.0 * ops / run.peaks["bf16_flops"] / secs
