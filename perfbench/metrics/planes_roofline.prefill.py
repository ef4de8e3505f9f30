"""The szx-planes encode kernel's share of its roofline over the traced
prefills' cache fills: K and V of every layer, a block a (position, kv
head) (``counts.kv_encode_bytes``) at the HBM peak, over the device time of
the ``planes_encode*`` kernels by name.  Nothing where the trace holds
another number of launches than two a prompt."""
from perfbench import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.work or run.mix.get("kv_mode") != "compressed" or not run.peaks:
        return None
    secs, launches = tr.kernel_seconds("planes_encode")
    if not secs or launches != 2 * len(tr.work):
        return None
    nbytes = sum(counts.kv_encode_bytes(run.arch, s, run.mix["num_planes"]) for s in tr.work)
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / secs
