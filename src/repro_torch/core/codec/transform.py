"""Transform layer: the fixed-shape block encoding, its layout rule, and the
decode of a laid-out encoding.

Stage two of the pipeline (paper Algorithm 1 lines 3-9) runs in the kernels
(``repro_torch.kernels``); this module keeps the record the device layer
hands to the body assembly, the Formula-5 layout rule that turns a stored
reqlen back into (shift, nbytes), and :func:`decode_blocks`, the decode of
the host-parse route (``container.parse_stream`` /
``extract_block_range``), which runs the unpack kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops


@dataclass(frozen=True)
class BlockEncoding:
    """Fixed-shape transform output, ready for container serialization."""

    mu: torch.Tensor       # (nb,) plan dtype -- block mean-of-min/max
    const: torch.Tensor    # (nb,) bool -- constant-block flags
    reqlen: torch.Tensor   # (nb,) int32 -- required bits (0 for const blocks)
    shift: torch.Tensor    # (nb,) int32 -- Solution-C right shift
    nbytes: torch.Tensor   # (nb,) int32 -- stored bytes/value before XOR-lead
    planes: torch.Tensor   # (nb, W, bs) uint8 -- byte planes, MSB-first
    L: torch.Tensor        # (nb, bs) uint8 -- identical-leading-byte counts
    # (nb,) bool on the host -- blocks with an elided byte (any L > 0), where
    # a host parse knows it; None for encodings made on the device
    elided: np.ndarray | None = None


def derive_layout(reqlen: torch.Tensor, const: torch.Tensor):
    """(shift, nbytes) from stored reqlen (Formula 5); 0 for const blocks."""
    reqlen = reqlen.to(torch.int32)
    shift = torch.where(const, 0, (8 - reqlen % 8) % 8).to(torch.int32)
    nbytes = torch.where(const, 0, (reqlen + shift) // 8).to(torch.int32)
    return shift, nbytes


def decode_blocks(enc: BlockEncoding, p) -> torch.Tensor:
    """(nb, bs) values in the plan's dtype, on the encoding's device.

    Encodings with no XOR-lead elision anywhere (every L = 0) take the dense
    path, which skips the index-propagation scan.  The choice reads the
    host's ``enc.elided`` where the encoding has it, and only otherwise asks
    the device (a reduction of L and a wait for it).
    """
    elided = enc.elided.any() if enc.elided is not None else enc.L.any()
    if not bool(elided):
        return ops.unpack_dense(enc.planes, enc.mu, enc.shift, enc.nbytes, spec=p.dtype)
    return ops.unpack(enc.planes, enc.mu, enc.shift, enc.nbytes, enc.L, spec=p.dtype)


def decode_block_range(enc: BlockEncoding, p, lo: int, hi: int) -> torch.Tensor:
    """Partial decode: blocks [lo, hi) only -> (hi - lo, bs), at O(hi - lo)."""
    return ops.unpack_range(enc.planes, enc.mu, enc.shift, enc.nbytes, enc.L, lo, hi,
                            spec=p.dtype, elided=enc.elided)
