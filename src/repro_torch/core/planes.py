"""szx-planes: the fixed-shape byte-plane codec as flat-array functions.

Encoded record for an input of n values, flattened and edge-padded to blocks
of ``block_size``:
  mu     : (nb,)  f32     block mean of min and max
  sexp   : (nb,)  int32   quantization exponent of the block's scale
  planes : (P, nb, bs) uint8

Wire size = n*P + 6*ceil(n/bs) bytes vs 4n raw (P=1, bs=128 -> 3.83x).
Reconstruction error <= 2^(E_k + 1 - 8P) per block (E_k = radius exponent),
about 0.4% of the block's range at P=1, apart from clamp events.

A tensor stays on its device; a host array goes to ``device`` (default: the
card, which raises without one).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.codec.planes_codec import PlanesCodec
from repro_torch.kernels import ref

DEFAULT_BLOCK_SIZE = 128


class PlanesEncoded(NamedTuple):
    mu: torch.Tensor        # (nb,) f32
    sexp: torch.Tensor      # (nb,) int32
    planes: torch.Tensor    # (P, nb, bs) uint8
    n: int                  # logical element count
    block_size: int


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def wire_bytes(enc: PlanesEncoded) -> int:
    """Bytes actually moved by a collective transferring `enc`."""
    return int(enc.planes.numel()) + 8 * int(enc.mu.numel())


def encode(x, *, num_planes: int = 1, block_size: int = DEFAULT_BLOCK_SIZE,
           device=None) -> PlanesEncoded:
    """Compress a flat f32 array into the fixed-shape plane representation."""
    mu, sexp, planes = PlanesCodec(num_planes, device).encode_flat(x, block_size)
    return PlanesEncoded(mu, sexp, planes, _numel(x), block_size)


def decode(enc: PlanesEncoded, shape=None, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the (optionally reshaped) array."""
    xb = PlanesCodec(enc.planes.shape[0]).decode_blocks(enc.mu, enc.sexp, enc.planes)
    flat = xb.reshape(-1)[: enc.n]
    if shape is not None:
        flat = flat.reshape(tuple(shape))
    return flat.to(_torch_dtype(dtype))


def roundtrip(x, *, num_planes: int = 1, block_size: int = DEFAULT_BLOCK_SIZE, device=None):
    """decode(encode(x)) with the original shape -- the lossy identity."""
    return decode(
        encode(x, num_planes=num_planes, block_size=block_size, device=device),
        shape=x.shape,
        dtype=x.dtype,
    )


def max_block_error_bound(enc: PlanesEncoded) -> torch.Tensor:
    """Per-block a-priori error bound (excludes clamp events).

    Quantization contributes 2^(E+1-8P); for P=3 the 24-bit integers sit at
    the edge of the f32 mantissa so the encode/decode product rounding adds up
    to a further 2^(8P-23) multiple of it (negligible for P=1,2).  The power
    of two is the reference's exp2 (``ref.planes_exp2``).
    """
    num_planes = enc.planes.shape[0]
    E = (8 * num_planes - 2) - enc.sexp.to(torch.int32)
    fp_slack = 1.0 + 2.0 ** (8 * num_planes - 23)
    scale = ref.planes_exp2((E + 1 - 8 * num_planes).to(torch.float32))
    return ref.mul_flushed(torch.full_like(scale, fp_slack), scale)
