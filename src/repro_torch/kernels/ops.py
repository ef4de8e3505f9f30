"""Dispatch for the SZx kernels on the codec's main path.

The route follows the tensor's device: a CUDA tensor goes to the hand-written
Hopper kernel (``kernels/encode.py``, ``kernels/decode.py``), a CPU tensor to
its plain PyTorch version (``kernels/ref.py``).  There is no backend knob and
no fallback: a CUDA call that cannot launch raises.

Each kernel wrapper counts its launches in a plain int (``encode.LAUNCHES``,
``decode.LAUNCHES``); :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode, encode, ref, specs
from repro_torch.kernels.specs import DtypeSpec


def encode_staged(xb: torch.Tensor, e: float, p_e: int, *,
                  spec: DtypeSpec = specs.F32):
    """Fused encode of (nb, bs) blocks -> (mu, const, reqlen, shift, nbytes,
    planes, L), on the device ``xb`` lies on, without a host sync."""
    return encode.encode(xb, e, p_e, spec=spec)


def decode_staged(body: torch.Tensor, nnc: int, lo: int = 0, *,
                  spec: DtypeSpec = specs.F32, nb: int, bs: int,
                  rb: int | None = None, rebase: bool = False):
    """Fused stream decode from the raw body (header stripped).

    Parses the metadata sections (``ref.parse_body_ref``, tensor ops on the
    body's device) then runs the fused unpack+compose.  Returns (vals (rb,
    bs), measured (3,) int64): the bitmap's nonconst count, the max
    per-block nbytes, and the L-implied mid-stream total -- checked against
    the header fields on the host after one small readback.
    """
    if rb is None:
        rb = nb
    _const, mu, shift, nbytes, rank, nnc_seen = ref.parse_body_ref(body, nnc, spec, nb)
    vals, mid_total = decode.decode_body(
        body, nnc, lo, mu, shift, nbytes, rank, spec=spec, bs=bs, rb=rb,
        rebase=rebase,
    )
    measured = torch.stack([nnc_seen, nbytes.max().to(torch.int64), mid_total])
    return vals, measured


def launch_counts() -> dict[str, int]:
    return {"encode": encode.LAUNCHES, "decode_body": decode.LAUNCHES}


def reset_launch_counts() -> None:
    encode.LAUNCHES = 0
    decode.LAUNCHES = 0
