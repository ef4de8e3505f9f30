"""Dispatch for the port's kernels: the SZx codec's, szx-planes' and the
model's attention.

The route follows the tensor's device: a CUDA tensor goes to the hand-written
Hopper kernel (``kernels/encode.py``, ``block_stats.py``, ``pack.py``,
``decode.py``, ``bitshuffle.py``, ``unpack.py``, ``planes.py``,
``flash_attention.py``), a CPU tensor to its
plain PyTorch version (``kernels/ref.py``).  There is no backend knob and no fallback: a CUDA call
that cannot launch raises.

Each kernel wrapper counts its launches in a plain int (``encode.LAUNCHES``,
``decode.LAUNCHES``, ...); :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitshuffle as bitshuffle_mod, decode, encode, ref, specs
from repro_torch.kernels import block_stats as block_stats_mod, pack as pack_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import planes as planes_mod, unpack as unpack_mod
from repro_torch.kernels.specs import DtypeSpec


def block_stats(xb: torch.Tensor, e: float, *, spec: DtypeSpec = specs.F32):
    """Per-block statistics of (nb, bs) blocks -> (mu, radius, const, reqlen,
    shift, nbytes), each (nb,): mu in the spec's dtype, radius in its compute
    dtype, const bool, the rest int32.  ``e`` is the absolute bound."""
    return block_stats_mod.block_stats(xb.to(spec.dtype).contiguous(), e,
                                       specs.exact_exponent_of(float(e)), spec=spec)


def pack(xb: torch.Tensor, mu, shift, nbytes, *, spec: DtypeSpec = specs.F32):
    """Normalize, shift by the caller's ``shift``, XOR-lead and split into
    byte planes -> (planes (nb, itemsize, bs) uint8, L (nb, bs) int32, mid
    (nb, bs) int32); ``ops.encode_staged`` fuses this with
    :func:`block_stats`."""
    return pack_mod.pack(xb.to(spec.dtype).contiguous(), mu.to(spec.dtype).contiguous(),
                         shift.to(torch.int32).contiguous(),
                         nbytes.to(torch.int32).contiguous(), spec=spec)


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


def unpack(planes, mu, shift, nbytes, L, *, spec: DtypeSpec = specs.F32):
    """Inverse of the encode's pack: (nb, W, bs) planes -> (nb, bs) values."""
    return unpack_mod.unpack(planes, mu, shift, nbytes, L.to(torch.uint8).contiguous(),
                             spec=spec)


def unpack_dense(planes, mu, shift, nbytes, *, spec: DtypeSpec = specs.F32):
    """Fast path for blocks whose L codes are all zero: no index-propagation
    scan.  Bit-identical to ``unpack(..., L=0)``."""
    return unpack_mod.unpack_dense(planes, mu, shift, nbytes, spec=spec)


def unpack_range(planes, mu, shift, nbytes, L, lo: int, hi: int, *,
                 spec: DtypeSpec = specs.F32, elided=None):
    """Partial decode of blocks [lo, hi): ``unpack(...)[lo:hi]`` at O(hi - lo)
    cost; a range with no XOR-lead elision takes the dense path.  ``elided``
    (nb,) bool on the host, where the caller has it, says which blocks hold
    an L > 0, so the choice needs no reduction on the device."""
    nb = mu.shape[0]
    if not 0 <= lo < hi <= nb:
        raise ValueError(f"block range [{lo}, {hi}) out of [0, {nb})")
    args = (planes[lo:hi].contiguous(), mu[lo:hi].contiguous(),
            shift[lo:hi].contiguous(), nbytes[lo:hi].contiguous())
    L_r = L[lo:hi]
    if not bool(elided[lo:hi].any() if elided is not None else L_r.any()):
        return unpack_dense(*args, spec=spec)
    return unpack(*args, L_r, spec=spec)


def bitshuffle(tiles: torch.Tensor, *, spec: DtypeSpec = specs.F32,
               inverse: bool = False) -> torch.Tensor:
    """Bit-transpose uint8 tiles of ``specs.tile_bytes(spec)`` bytes; the
    inverse with ``inverse=True``."""
    return bitshuffle_mod.bitshuffle(tiles, spec=spec, inverse=inverse)


def planes_encode(xb, num_planes: int):
    """szx-planes fixed-plane encode of (..., bs) blocks -> (mu, sexp int32,
    planes (P, ..., bs) uint8), on the device ``xb`` lies on."""
    return planes_mod.planes_encode(xb.to(torch.float32), num_planes)


def planes_decode(mu, sexp, planes):
    """Inverse of :func:`planes_encode` -> (..., bs) float32 (any integer
    sexp dtype; int8, int16 and int32 go to the kernel as they are, with no
    cast launch)."""
    if sexp.dtype not in planes_mod.SEXP_DTYPES:
        sexp = sexp.to(torch.int32)
    return planes_mod.planes_decode(mu.to(torch.float32), sexp, planes.to(torch.uint8))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """GQA attention, q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq,
    hd) in q.dtype, query i at key index ``q_offset`` + i; differentiable
    (the forward kernel, a recomputing backward)."""
    return flash_mod.FlashAttention.apply(q, k, v, causal, window, q_offset)


def launch_counts() -> dict[str, int]:
    return {"encode": encode.LAUNCHES, "decode_body": decode.LAUNCHES,
            "block_stats": block_stats_mod.LAUNCHES, "pack": pack_mod.LAUNCHES,
            "bitshuffle": bitshuffle_mod.LAUNCHES,
            "bitshuffle_inverse": bitshuffle_mod.INVERSE_LAUNCHES,
            "unpack": unpack_mod.LAUNCHES, "unpack_dense": unpack_mod.DENSE_LAUNCHES,
            "planes_encode": planes_mod.ENCODE_LAUNCHES,
            "planes_decode": planes_mod.DECODE_LAUNCHES,
            "flash_attention": flash_mod.LAUNCHES}


def store_route_counts() -> dict[str, int]:
    """The store path's kernels' launches by route (``unpack_vector``,
    ``unpack_scalar``, ``unpack_dense_vector``, ``unpack_dense_scalar``,
    ``bitshuffle_vector``, ``bitshuffle_scalar``,
    ``bitshuffle_inverse_vector``, ``bitshuffle_inverse_scalar``); zeroed by
    :func:`reset_launch_counts`."""
    return {**unpack_mod.ROUTE_LAUNCHES, **bitshuffle_mod.ROUTE_LAUNCHES}


def planes_route_counts() -> dict[str, int]:
    """The planes kernels' launches by route (``planes_encode_vector``,
    ``planes_encode_scalar``, ``planes_decode_vector``,
    ``planes_decode_scalar``); zeroed by :func:`reset_launch_counts`."""
    return {f"planes_{k}": v for k, v in planes_mod.ROUTE_LAUNCHES.items()}


def reset_launch_counts() -> None:
    encode.LAUNCHES = 0
    block_stats_mod.LAUNCHES = pack_mod.LAUNCHES = 0
    decode.LAUNCHES = 0
    bitshuffle_mod.LAUNCHES = bitshuffle_mod.INVERSE_LAUNCHES = 0
    unpack_mod.LAUNCHES = unpack_mod.DENSE_LAUNCHES = 0
    for counts in (unpack_mod.ROUTE_LAUNCHES, bitshuffle_mod.ROUTE_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    planes_mod.ENCODE_LAUNCHES = planes_mod.DECODE_LAUNCHES = 0
    planes_mod.ROUTE_LAUNCHES.update(dict.fromkeys(planes_mod.ROUTE_LAUNCHES, 0))
    flash_mod.LAUNCHES = 0
