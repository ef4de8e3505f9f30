"""Transform layer records: the fixed-shape block encoding and its layout rule.

Stage two of the pipeline (paper Algorithm 1 lines 3-9) runs in the kernels
(``repro_torch.kernels``); this module keeps the record the device layer
hands to the body assembly, and the Formula-5 layout rule that turns a
stored reqlen back into (shift, nbytes).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


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


def derive_layout(reqlen: torch.Tensor, const: torch.Tensor):
    """(shift, nbytes) from stored reqlen (Formula 5); 0 for const blocks."""
    reqlen = reqlen.to(torch.int32)
    shift = torch.where(const, 0, (8 - reqlen % 8) % 8).to(torch.int32)
    nbytes = torch.where(const, 0, (reqlen + shift) // 8).to(torch.int32)
    return shift, nbytes
