"""The szx-planes block codec in plain PyTorch, float32.

A block of ``bs`` values keeps its mean of min and max ``mu`` (float32), an
exponent ``sexp`` and P bytes a value: with E = floor(log2(radius)), radius
the larger distance of min or max from mu, sexp = 8P - 2 - E, and
q = round((x - mu) * 2**sexp) clamped to the signed 8P-bit range, stored as
P byte planes (lowest byte first).  Decoding gives q * 2**-sexp + mu; a
constant block (radius 0) decodes to mu exactly.  The error of a value is at
most 2**(E + 1 - 8P), half a step.
"""
from __future__ import annotations

import torch

# The program's gradient exchange blocks each leaf by 64 values along its
# last axis, a fixed size it takes from no setting; the reference's round
# trip and the byte counts use the same.
GRAD_BLOCK = 64


def encode(xb, num_planes: int):
    """(..., bs) -> (mu (...,) float32, sexp (...,) int32, planes (P, ..., bs) uint8)."""
    x = xb.to(torch.float32)
    mn, mx = x.amin(-1), x.amax(-1)
    mu = 0.5 * (mn + mx)
    radius = torch.maximum(mx - mu, mu - mn)
    _, e = torch.frexp(radius)                      # radius = m * 2**e, m in [0.5, 1)
    sexp = (8 * num_planes - 2) - (e - 1)
    lim = 2.0 ** (8 * num_planes - 1)
    q = torch.round((x - mu[..., None]).double() * torch.exp2(sexp[..., None].double()))
    q = torch.where((radius > 0)[..., None], q, 0.0).clamp(-lim, lim - 1).to(torch.int32)
    planes = torch.stack([((q >> (8 * k)) & 0xFF).to(torch.uint8) for k in range(num_planes)])
    return mu, sexp.to(torch.int32), planes


def decode(mu, sexp, planes):
    """Inverse of :func:`encode` -> (..., bs) float32."""
    n = planes.shape[0]
    u = torch.zeros(planes.shape[1:], dtype=torch.int64, device=planes.device)
    for k in range(n):
        u |= planes[k].to(torch.int64) << (8 * k)
    q = torch.where(u >= 2 ** (8 * n - 1), u - 2 ** (8 * n), u)
    v = (q.double() * torch.exp2(-sexp.double())[..., None]).float()
    return v + mu.to(torch.float32)[..., None]


def roundtrip_last_axis(x, num_planes: int, block: int):
    """decode(encode(x)) in blocks of ``block`` along the last axis, the
    last axis zero-padded to whole blocks and trimmed after."""
    shape = x.shape if x.dim() else (1,)
    flat = x.reshape(shape).to(torch.float32)
    pad = (-shape[-1]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    xb = flat.reshape(flat.shape[:-1] + (-1, block))
    out = decode(*encode(xb, num_planes)).reshape(flat.shape)[..., :shape[-1]]
    return out.reshape(x.shape)

