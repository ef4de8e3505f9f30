"""Reconstruction-quality metrics used throughout the paper (Section III).

Counterpart of ``repro/core/metrics.py`` (a copy: the port imports nothing
of the reference).  Each function takes tensors on any device or numpy
arrays and computes in float64 on the device of its first tensor argument;
the sums run in torch's order, so the results can differ from numpy's in
the last digits.
"""
from __future__ import annotations

import math

import torch


def _f64(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(device=device or t.device, dtype=torch.float64).reshape(-1)


def _pair(orig, recon):
    x = _f64(orig)
    return x, _f64(recon, x.device)


def psnr(orig, recon) -> float:
    """Peak signal-to-noise ratio, Formula (7) of the paper."""
    x, y = _pair(orig, recon)
    rng = float(x.max() - x.min())
    mse = float(torch.mean((x - y) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * math.log10(rng / math.sqrt(mse))


def ssim(orig, recon, *, window: int = 7) -> float:
    """Mean 1-D windowed SSIM (flattened); sufficient for regression checks."""
    x, y = _pair(orig, recon)
    rng = float(x.max() - x.min())
    if rng == 0:
        return 1.0
    c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
    n = (x.numel() // window) * window
    xw = x[:n].reshape(-1, window)
    yw = y[:n].reshape(-1, window)
    mx, my = xw.mean(1), yw.mean(1)
    vx, vy = xw.var(1, correction=0), yw.var(1, correction=0)
    cov = ((xw - mx[:, None]) * (yw - my[:, None])).mean(1)
    s = ((2 * mx * my + c1) * (2 * cov + c2)) / ((mx**2 + my**2 + c1) * (vx + vy + c2))
    return float(s.mean())


def max_abs_error(orig, recon) -> float:
    x, y = _pair(orig, recon)
    return float(torch.max(torch.abs(x - y)))


def compression_ratio(raw_bytes: int, compressed_bytes: int) -> float:
    return raw_bytes / max(compressed_bytes, 1)
