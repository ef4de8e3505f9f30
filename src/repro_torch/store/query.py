"""Compressed-domain analytics: aggregate queries without full decompression.

SZx's block structure is what makes in-place analytics possible: a constant
block stores ONLY its value ``mu`` (every decoded element equals it
exactly), and a non-constant block's header (``mu`` + its required-length
byte) bounds the block's whole value range.  Two query tiers exploit this:

* **exact** (default): constant blocks are answered from their headers
  alone on the host; only non-constant blocks decode, on the device
  (``transform.decode_blocks``, the unpack kernels), where their values
  are summed in float64 and their min/max taken -- one readback of three
  numbers per frame.  Count, min and max equal those of the decompressed
  array; sum and mean differ from a numpy sum only by the order of the
  float64 additions.
* **header-only**: NEVER reads L codes or mid bytes -- one metadata read per
  frame, host arithmetic only (the JAX package's, so its intervals are
  identical).  Returns guaranteed ``[lo, hi]`` intervals: a non-constant
  block's radius ``r`` satisfies ``r < 2**(R + p(e))`` where ``R = reqlen -
  1 - exp_bits`` is read straight from the header (Formula 4 inverted), so
  its decoded values all lie within ``mu +- (2**(R + p(e)) + e)``.
  Verbatim blocks (``R == mant_bits``) are unbounded from the header and
  widen the interval to infinity.

Both tiers stream frame-by-frame in O(frame) memory.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.codec import container, plan as plan_mod, transform
from repro_torch.core.codec.device import to_host
from repro_torch.core.codec.transform import BlockEncoding
from repro_torch.kernels import specs


@dataclass(frozen=True)
class QueryStats:
    """Aggregate query result; every stat is a ``(lo, hi)`` interval that is
    guaranteed to contain the corresponding stat of the decompressed array.
    ``exact=True`` means every interval has zero width (``lo == hi``)."""

    count: int
    nblocks: int
    const_blocks: int
    verbatim_blocks: int
    sum: tuple[float, float]
    min: tuple[float, float]
    max: tuple[float, float]
    exact: bool

    @property
    def mean(self) -> tuple[float, float]:
        return (self.sum[0] / self.count, self.sum[1] / self.count)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "nblocks": self.nblocks,
            "const_blocks": self.const_blocks,
            "verbatim_blocks": self.verbatim_blocks,
            "exact": self.exact,
            "sum": list(self.sum),
            "mean": list(self.mean),
            "min": list(self.min),
            "max": list(self.max),
        }


class _Acc:
    def __init__(self):
        self.count = 0
        self.nblocks = 0
        self.const_blocks = 0
        self.verbatim_blocks = 0
        self.sum_lo = self.sum_hi = 0.0
        self.min_lo = self.min_hi = np.inf
        self.max_lo = self.max_hi = -np.inf
        self.exact = True

    def add_exact(self, s: float, lo: float, hi: float) -> None:
        """An exact contribution: its sum, min and max."""
        self.sum_lo += s
        self.sum_hi += s
        self.min_lo, self.min_hi = min(self.min_lo, lo), min(self.min_hi, lo)
        self.max_lo, self.max_hi = max(self.max_lo, hi), max(self.max_hi, hi)

    def add_points(self, values: np.ndarray, weights=None) -> None:
        """Exact contributions of per-block (or per-element) known values."""
        if values.size == 0:
            return
        v = values.astype(np.float64, copy=False)
        s = float(v.sum() if weights is None else (v * weights).sum())
        self.add_exact(s, float(v.min()), float(v.max()))

    def done(self) -> QueryStats:
        return QueryStats(
            self.count, self.nblocks, self.const_blocks, self.verbatim_blocks,
            (self.sum_lo, self.sum_hi), (self.min_lo, self.min_hi),
            (self.max_lo, self.max_hi), self.exact,
        )


def _frame_meta(f, off: int, length: int, seq: int):
    """Read + parse ONLY the header-tier metadata of one frame: stream
    header, const bitmap, mu section (as float64), reqlen section.  Never
    touches the L-code or mid sections."""
    _flags, plen, sheader = container.read_frame_stream_header_at(f, off, seq)
    _m, _sv, dtype_code, bs, n, e, nb, nnc, _nmid = container.HEADER.unpack_from(
        sheader, 0
    )
    spec = plan_mod.spec_for_code(dtype_code)
    nbm = (nb + 7) // 8
    meta = container._read_exact(f, nbm + spec.itemsize * nb + nnc)
    const = np.unpackbits(np.frombuffer(meta, np.uint8, nbm, 0))[:nb].astype(bool)
    words = np.frombuffer(meta, f"<i{spec.itemsize}", nb, nbm).copy()
    mu = torch.from_numpy(words).view(spec.dtype).to(torch.float64).numpy()
    reqlen_nc = np.frombuffer(meta, np.uint8, nnc, nbm + spec.itemsize * nb)
    if int((~const).sum()) != nnc:
        raise ValueError("corrupt SZx stream (const bitmap / n_nonconst mismatch)")
    return spec, int(bs), int(n), float(e), const, mu, reqlen_nc, int(plen)


def _valid_counts(n: int, nb: int, bs: int) -> np.ndarray:
    """Logical (un-padded) element count of each block."""
    counts = np.full(nb, bs, np.int64)
    if nb:
        counts[-1] = n - (nb - 1) * bs
    return counts


def scan_frames(f, frames, *, device, header_only: bool = False,
                locs=None) -> QueryStats:
    """Aggregate stats over an indexed frame sequence (store or chunked
    stream): ``frames`` is the footer's ``[offset, length, elements]`` list.
    ``locs`` overrides the frame locations for multi-file (sharded) stores:
    an iterable of ``(fileobj, seq, offset, length, elements)``.  The exact
    tier decodes on ``device``.  See the module docstring for the tiers."""
    if locs is None:
        locs = (
            (f, seq, int(fr[0]), int(fr[1]), int(fr[2]))
            for seq, fr in enumerate(frames)
        )
    acc = _Acc()
    for f, seq, off, length, elements in locs:
        spec, bs, n, e, const, mu, reqlen_nc, plen = _frame_meta(f, off, length, seq)
        if n != elements:
            raise ValueError(
                f"corrupt store index (frame {seq}: stream has {n} elements, "
                f"index says {elements})"
            )
        nb = const.size
        counts = _valid_counts(n, nb, bs)
        acc.count += n
        acc.nblocks += nb
        acc.const_blocks += int(const.sum())
        # constant blocks: every decoded element IS mu -- exact from headers
        acc.add_points(mu[const], weights=counts[const].astype(np.float64))
        if int((~const).sum()) == 0:
            continue
        if header_only:
            _add_header_intervals(acc, spec, e, mu, const, reqlen_nc, counts)
        else:
            _add_exact_nonconst(acc, f, off, length, seq, const, counts, device)
    return acc.done()


def _add_header_intervals(acc, spec, e, mu, const, reqlen_nc, counts) -> None:
    """Interval contributions of non-constant blocks, headers only."""
    p_e = specs.exact_exponent_of(e)
    R = reqlen_nc.astype(np.int64) - 1 - spec.exp_bits
    verbatim = R >= spec.mant_bits
    acc.verbatim_blocks += int(verbatim.sum())
    # r < 2**(R + p_e) (Formula 4 inverted); decoded values within r + e of mu
    with np.errstate(over="ignore"):
        r_ub = np.exp2((R + p_e).astype(np.float64))
    r_ub[verbatim] = np.inf
    b = r_ub + e
    mu_nc = mu[~const]
    cnt = counts[~const].astype(np.float64)
    acc.exact = False
    acc.sum_lo += float(((mu_nc - b) * cnt).sum())
    acc.sum_hi += float(((mu_nc + b) * cnt).sum())
    # block min is within [mu - b, mu + e], block max within [mu - e, mu + b]
    # -- EXCEPT verbatim blocks, whose stored mu is zeroed (the values are
    # exact but unbounded from the header): their inner bounds open to +-inf
    min_hi_blk = np.where(verbatim, np.inf, mu_nc + e)
    max_lo_blk = np.where(verbatim, -np.inf, mu_nc - e)
    acc.min_lo = min(acc.min_lo, float((mu_nc - b).min()))
    acc.min_hi = min(acc.min_hi, float(min_hi_blk.min()))
    acc.max_lo = max(acc.max_lo, float(max_lo_blk.max()))
    acc.max_hi = max(acc.max_hi, float((mu_nc + b).max()))


def _add_exact_nonconst(acc, f, off, length, seq, const, counts, device) -> None:
    """Exact contributions of non-constant blocks: decode ONLY those blocks
    of the frame's payload, on ``device``; sum/min/max there in float64."""
    payload, _flags = container.read_frame_at(f, off, length, seq, device=device)
    p, enc = container.parse_stream(payload, device=device)
    dev = enc.L.device
    # block indices from the host's bitmap: an index gather, where a boolean
    # mask would wait on the device for its count
    nc = torch.from_numpy(np.flatnonzero(~const)).to(dev)
    sub = BlockEncoding(enc.mu[nc], enc.const[nc], enc.reqlen[nc], enc.shift[nc],
                        enc.nbytes[nc], enc.planes[nc], enc.L[nc], enc.elided[~const])
    dec = transform.decode_blocks(sub, p).to(torch.float64)
    # only the stream's last block can be partly padding
    cnt = torch.from_numpy(counts[~const]).to(dev)
    valid = torch.arange(p.block_size, device=dev)[None, :] < cnt[:, None]
    s = torch.where(valid, dec, 0.0).sum()
    lo = torch.where(valid, dec, torch.inf).amin()
    hi = torch.where(valid, dec, -torch.inf).amax()
    s, lo, hi = to_host(torch.stack([s, lo, hi])).tolist()
    acc.add_exact(s, lo, hi)
