"""Synthetic scientific-field generator for the compressor benchmarks.

Counterpart of ``repro/data/scidata.py`` (numpy only, a copy).  SDRBench is
not downloadable offline, so six "applications" are synthesized whose
block-smoothness statistics are shaped to match the paper's Fig. 2 CDF
characterization (e.g. Miranda/QMCPack: 80+% of size-8 blocks with relative
range <= 0.01; Hurricane/NYX rougher).  Each application has several fields
with different roughness/feature mixes so min/avg/max CR spread like
Table III.

``field()`` seeds from ``hash(app)``, as the reference does: Python
randomizes string hashes per process (``PYTHONHASHSEED``), so a field is
the same in both packages within one process but differs from process to
process.  The expression is kept so that the two packages agree.
"""
from __future__ import annotations

import numpy as np


def _smooth_field(rng, shape, octaves, roughness, spike_frac=0.0):
    """Multi-octave separable smooth noise + optional spikes."""
    out = np.zeros(shape, np.float32)
    for o in range(octaves):
        amp = roughness**o
        coarse = [max(2, s // (2 ** (octaves - o))) for s in shape]
        small = rng.standard_normal(coarse).astype(np.float32)
        for ax, (cs, fs) in enumerate(zip(coarse, shape)):
            reps = int(np.ceil(fs / cs))
            small = np.repeat(small, reps, axis=ax)
            sl = [slice(None)] * len(shape)
            sl[ax] = slice(0, fs)
            small = small[tuple(sl)]
            # box smooth along the axis
            k = max(1, fs // cs // 2)
            if k > 1:
                c = np.cumsum(small, axis=ax)
                sl_a = [slice(None)] * len(shape)
                sl_b = [slice(None)] * len(shape)
                sl_a[ax] = slice(k, None)
                sl_b[ax] = slice(0, -k)
                body = (c[tuple(sl_a)] - c[tuple(sl_b)]) / k
                pad = [(0, 0)] * len(shape)
                pad[ax] = (0, small.shape[ax] - body.shape[ax])
                small = np.pad(body, pad, mode="edge")
        out += amp * small
    if spike_frac:
        n = int(out.size * spike_frac)
        idx = rng.integers(0, out.size, n)
        out.reshape(-1)[idx] *= 50.0
    return out


# (octaves, roughness, spike_frac, scale) per field; tuned so the block-range
# CDFs span the paper's smooth (Miranda/QMCPack) to rough (NYX) spectrum
APPLICATIONS = {
    "CESM": dict(shape=(1800, 360), fields=6, octaves=5, rough=0.55, spikes=0.0002),
    "Hurricane": dict(shape=(100, 500, 50), fields=5, octaves=4, rough=0.65, spikes=0.0005),
    "Miranda": dict(shape=(256, 384, 38), fields=4, octaves=6, rough=0.22, spikes=0.0),
    "NYX": dict(shape=(256, 256, 64), fields=4, octaves=3, rough=0.85, spikes=0.001),
    "QMCPack": dict(shape=(288, 115, 69), fields=2, octaves=6, rough=0.18, spikes=0.0),
    "SCALE-LetKF": dict(shape=(98, 1200, 12), fields=5, octaves=4, rough=0.6, spikes=0.0003),
}


def field(app: str, idx: int) -> np.ndarray:
    spec = APPLICATIONS[app]
    rng = np.random.default_rng(np.random.SeedSequence([hash(app) % 2**31, idx]))
    rough = spec["rough"] * (1.0 + 0.25 * (idx - spec["fields"] / 2) / spec["fields"])
    f = _smooth_field(rng, spec["shape"], spec["octaves"], rough, spec["spikes"])
    scale = 10.0 ** rng.integers(-2, 4)
    return (f * scale).astype(np.float32)


def fields(app: str):
    for i in range(APPLICATIONS[app]["fields"]):
        yield f"{app}.f{i}", field(app, i)


def block_relative_range_cdf(x: np.ndarray, block: int = 8) -> np.ndarray:
    """Fraction of blocks with relative value range <= thresholds (Fig. 2)."""
    flat = x.reshape(-1)
    n = (flat.size // block) * block
    xb = flat[:n].reshape(-1, block)
    rng_b = xb.max(1) - xb.min(1)
    g = x.max() - x.min()
    rel = rng_b / max(g, 1e-30)
    thresholds = np.logspace(-6, 0, 25)
    return np.array([(rel <= t).mean() for t in thresholds])
