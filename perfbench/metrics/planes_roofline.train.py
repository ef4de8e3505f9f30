"""The szx-planes kernels' share of their roofline over the traced steps:
the bytes of one encode and one decode of every gradient leaf a step
(``counts.grad_planes_bytes``) at the HBM peak, over the device time of the
``planes_encode*`` and ``planes_decode*`` kernels by name.  Nothing where
the trace holds another number of launches than one of each a leaf and
step."""
from perfbench import counts
from perfbench.reference import planes as ref_planes, weights


def read(run):
    tr = run.trace
    planes = run.mix.get("compress_planes", 0)
    if tr is None or not tr.work or not planes or not run.peaks:
        return None
    shapes = [s for _, s, _ in weights.all_leaf_specs(run.arch)]
    enc, n_enc = tr.kernel_seconds("planes_encode")
    dec, n_dec = tr.kernel_seconds("planes_decode")
    if n_enc != len(shapes) * len(tr.work) or n_dec != n_enc:
        return None
    nbytes = len(tr.work) * counts.grad_planes_bytes(shapes, ref_planes.GRAD_BLOCK, planes)
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / (enc + dec)
