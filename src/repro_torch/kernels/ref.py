"""Plain PyTorch versions of the width-generic SZx kernels.

These functions are the semantics the CUDA kernels in ``csrc/`` are held to,
bit for bit: the CPU tests run them against the JAX package, and
``chip_smoke.py`` runs them on the card beside the kernels.  They are plain
tensor code and run on any device.

Every op is parameterized by a :class:`repro_torch.kernels.specs.DtypeSpec`.
Per-block statistics run in the spec's *compute dtype* (f32 for words up to 4
bytes, f64 for float64); the bit-level split runs on the *storage* word after
rounding the normalized residual to the input dtype.

Words live in ``int64`` here, zero-extended for the 16- and 32-bit formats:
torch has no logical right shift, so :func:`_lsr` masks the sign extension
of 64-bit words away.  Byte extraction (``>> k & 0xFF``) and the "leading
bytes are zero" test (``>> k == 0``) give the same answer under arithmetic
and logical shifts, so they need no mask.

Notation follows the paper (Algorithm 1 / Formulas 4-5):
  mu      -- mean of min and max of a block
  radius  -- r_k = max(|max - mu|, |mu - min|)
  reqlen  -- 1 sign + exp_bits + R_k mantissa bits,
             R_k = clip(p(r_k) - p(e) + 1, 0, mant_bits)
  shift   -- Solution-C right shift s = (8 - reqlen % 8) % 8 (Formula 5)
  nbytes  -- bytes kept per value = (reqlen + shift) / 8; 0 marks a constant
             block
  L       -- identical-leading-byte count vs. the predecessor (2-bit code,
             capped at min(3, itemsize)); the first value of a block
             compares against the zero word
"""
from __future__ import annotations

import torch

from repro_torch.kernels.specs import DtypeSpec


def _words(v: torch.Tensor, spec: DtypeSpec) -> torch.Tensor:
    """Bits of storage-dtype ``v`` as zero-extended int64 words."""
    w = v.view(spec.word_dtype).to(torch.int64)
    if spec.itemsize < 8:
        w = w & ((1 << spec.word_bits) - 1)
    return w


def _from_words(w: torch.Tensor, spec: DtypeSpec) -> torch.Tensor:
    """Inverse of :func:`_words`: the low ``word_bits`` of int64 words,
    reinterpreted as the storage dtype."""
    return w.to(spec.word_dtype).view(spec.dtype)


def _numpy_nan(v: torch.Tensor, spec: DtypeSpec) -> torch.Tensor:
    """``v`` with every NaN replaced by the bits numpy gives it after a trip
    through the compute dtype and arithmetic: the quiet bit set and the
    payload kept, or for bfloat16 (ml_dtypes) the quiet NaN of the same
    sign.  Torch and the card would otherwise emit their own canonical NaN."""
    w = v.view(spec.word_dtype)
    if spec.name == "bfloat16":
        q = (w & -0x8000) | 0x7FC0
    else:
        q = w | (1 << (spec.mant_bits - 1))
    return torch.where(torch.isnan(v), q, w).view(spec.dtype)


def _lsr(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 words by ``s`` in [0, 63]."""
    keep = ~((torch.full_like(w, -1) << (63 - s)) << 1)   # low 64 - s bits
    return (w >> s) & keep


def float_exponent(x: torch.Tensor, spec: DtypeSpec) -> torch.Tensor:
    """Unbiased binary exponent field of |x| in the spec's COMPUTE dtype.

    floor(log2|x|) for compute-dtype normals; ``-compute_exp_bias`` for
    zero/subnormals (conservative: a too-large exponent keeps more bits).
    """
    bits = x.to(spec.compute_dtype).view(spec.compute_word_dtype)
    field = (bits >> spec.compute_mant_bits) & ((1 << spec.compute_exp_bits) - 1)
    return field.to(torch.int32) - spec.compute_exp_bias


def block_stats_ref(xb: torch.Tensor, e: float, spec: DtypeSpec, p_e: int):
    """Per-block statistics (paper Alg. 1 lines 3-7), width-generic.

    xb: (nb, bs) in the spec's dtype.  e: absolute error bound (> 0), rounded
    to the compute dtype here.  p_e: exact floor(log2 e) of the unrounded
    bound (``specs.exact_exponent_of``).
    Returns (mu, radius, const, reqlen, shift, nbytes); mu is (nb,) in the
    spec's dtype, radius in the compute dtype, the rest int32/bool (nb,) with
    reqlen/shift/nbytes 0 for constant blocks.
    """
    cdt = spec.compute_dtype
    x = xb.to(spec.dtype).to(cdt)
    e = torch.as_tensor(e, dtype=cdt, device=x.device)
    mn = x.amin(dim=1)
    mx = x.amax(dim=1)
    mu = (0.5 * (mn + mx)).to(spec.dtype)          # storage-rounded mu
    mu_w = mu.to(cdt)                              # exact widening
    # radius vs the ROUNDED mu: the constant-block test then already covers
    # the mu storage rounding of the narrow dtypes
    radius = torch.maximum(mx - mu_w, mu_w - mn)
    r_test = radius
    if spec.stats_rounding_guard:
        # 16-bit formats: the f32 subtraction can round BELOW the true block
        # deviation; testing the next-up radius keeps the bound strict
        r_test = (radius.view(spec.compute_word_dtype) + 1).view(cdt)
    # a NaN radius (a block holding NaN or inf) is never constant, whatever
    # its bits: the next-up step would wrap the all-ones NaN to -0.0
    const = (r_test <= e) & ~torch.isnan(radius)
    req_m_raw = float_exponent(radius, spec) - int(p_e) + 1
    req_m = req_m_raw.clamp(0, spec.mant_bits)
    # verbatim blocks: if the bound is below the ulp of the normalized values
    # (req_m_raw > mant_bits), store the block bit-exactly against mu = 0
    mu = torch.where(req_m_raw > spec.mant_bits, torch.zeros_like(mu), mu)
    reqlen = 1 + spec.exp_bits + req_m
    shift = (8 - reqlen % 8) % 8
    nbytes = (reqlen + shift) // 8
    zero = torch.zeros_like(reqlen)
    return (
        mu,
        radius,
        const,
        torch.where(const, zero, reqlen),
        torch.where(const, zero, shift),
        torch.where(const, zero, nbytes),
    )


def pack_ref(xb: torch.Tensor, mu, shift, nbytes, spec: DtypeSpec):
    """Normalize, right-shift (Solution C), XOR-lead, and byte-plane split.

    xb: (nb, bs) spec dtype; mu: (nb,) spec dtype; shift/nbytes: (nb,) int32.
    Returns:
      planes: (nb, itemsize, bs) uint8 -- byte j of the shifted word (0 = most
              significant).
      L:      (nb, bs) uint8 -- identical leading bytes vs. predecessor,
              clipped to [0, min(lead_cap, nbytes)].
      mid:    (nb, bs) int32 -- mid-bytes to store per value (nbytes - L).
    """
    cdt = spec.compute_dtype
    W = spec.itemsize
    xs = xb.to(spec.dtype)
    mu_w = mu.to(spec.dtype).to(cdt)
    v = (xs.to(cdt) - mu_w[:, None]).to(spec.dtype)  # storage-rounded residual
    # NaN inputs sit in verbatim blocks (mu = 0): numpy keeps their payload
    v = torch.where(torch.isnan(xs), _numpy_nan(xs, spec), v)
    ws = _lsr(_words(v, spec), shift[:, None].to(torch.int64))
    prev = torch.nn.functional.pad(ws[:, :-1], (1, 0))
    xw = ws ^ prev
    L = torch.zeros(ws.shape, dtype=torch.int32, device=ws.device)
    run = torch.ones(ws.shape, dtype=torch.bool, device=ws.device)
    for j in range(spec.lead_cap):
        run = run & ((xw >> (8 * (W - 1 - j))) == 0)
        L = L + run.to(torch.int32)
    L = torch.minimum(L, nbytes[:, None])
    planes = torch.stack(
        [((ws >> (8 * (W - 1 - j))) & 0xFF).to(torch.uint8) for j in range(W)],
        dim=1,
    )
    mid = nbytes[:, None] - L
    return planes, L.to(torch.uint8), mid


def encode_ref(xb: torch.Tensor, e: float, spec: DtypeSpec, p_e: int):
    """Fused block_stats + pack -> (mu, const, reqlen, shift, nbytes, planes, L),
    exactly the fields the container layer serializes."""
    mu, _radius, const, reqlen, shift, nbytes = block_stats_ref(xb, e, spec, p_e)
    planes, L, _mid = pack_ref(xb, mu, shift, nbytes, spec)
    return mu, const, reqlen, shift, nbytes, planes, L


def _compose_word(ws, mu, shift, nbytes, spec: DtypeSpec):
    """Shift the reassembled word back, bitcast, and re-add mu (in the
    compute dtype, rounded to storage); constant blocks decode to mu."""
    w = ws << shift[:, None].to(torch.int64)          # low word_bits survive
    v = _from_words(w, spec)
    cdt = spec.compute_dtype
    mu = mu.to(spec.dtype)
    x = (v.to(cdt) + mu.to(cdt)[:, None]).to(spec.dtype)
    x = torch.where(torch.isnan(v), _numpy_nan(v, spec), x)
    return torch.where((nbytes == 0)[:, None], mu[:, None], x)


# ---------------------------------------------------------------------------
# Device-resident stream decode: the inverse of core.codec.device assembly.
# ---------------------------------------------------------------------------

def parse_body_ref(body: torch.Tensor, nnc: int, spec: DtypeSpec, nb: int):
    """Parse of the v2 metadata sections from the raw stream body.

    ``body`` is the stream minus its 40-byte header, one uint8 vector.
    ``nnc`` is the header's n_nonconst field.  Section offsets are derived
    exactly as the serializer lays them out: ``[const bitmap][mu words]
    [compacted reqlen]``.

    Returns (const, mu, shift, nbytes, rank, nnc_seen): per-block metadata
    (rank = compacted index of each non-const block, -1 for const) plus the
    bitmap's own nonconst count, compared against the header's ``nnc`` after
    the readback (corrupt-stream validation).
    """
    W = spec.itemsize
    nbm = (nb + 7) // 8
    req_off = nbm + W * nb
    dev = body.device
    # const bitmap, MSB-first (numpy packbits order)
    sh = torch.arange(7, -1, -1, device=dev, dtype=torch.int32)
    bits = (body[:nbm].to(torch.int32)[:, None] >> sh) & 1
    const = bits.reshape(-1)[:nb].to(torch.bool)
    # mu words: little-endian bytes (clone: the slice offset need not be
    # aligned for a wider view)
    mu = body[nbm:req_off].clone().view(spec.dtype)
    nonconst = ~const
    incl = torch.cumsum(nonconst.to(torch.int64), 0)
    rank = torch.where(nonconst, incl - 1, -1)
    ridx = (req_off + rank).clamp(0, body.numel() - 1)
    reqlen = torch.where(nonconst, body[ridx].to(torch.int32), 0)
    # layout derivation (Formula 5, Solution C) -- same as derive_layout
    shift = torch.where(const, 0, (8 - reqlen % 8) % 8).to(torch.int32)
    nbytes = ((reqlen + shift) // 8).to(torch.int32)
    return const, mu, shift, nbytes, rank.to(torch.int32), incl[-1]


def decode_body_ref(body, nnc: int, lo: int, mu, shift, nbytes, rank,
                    spec: DtypeSpec, *, bs: int, rb: int, rebase: bool = False):
    """Fused unpack+compose straight from raw body bytes.

    Expands the compacted 2-bit L codes, derives each value's mid-stream
    offset as the exclusive cumsum of ``nbytes - L``, gathers the stored
    bytes directly out of ``body``, runs the XOR-lead index propagation as a
    fused-key (``idx*256 + byte``) cummax, and composes via
    :func:`_compose_word`.  ``lo`` is the first decoded block, ``rb`` blocks
    are produced.  ``rebase=True`` reads the mid section as starting at
    block ``lo``'s first mid byte (the store ROI buffer layout).

    Returns (vals (rb, bs) in the spec's dtype, mid_total int64): the
    full-stream mid byte count implied by the L codes, for validation
    against the header's nmid.
    """
    W = spec.itemsize
    nb = rank.shape[0]
    dev = body.device
    nbm = (nb + 7) // 8
    req_off = nbm + W * nb
    l_off = req_off + nnc
    mid_off = l_off + (nnc * bs + 3) // 4
    cap = body.numel()
    rank = rank.to(torch.int64)
    nbytes = nbytes.to(torch.int64)
    # 2-bit L codes: little-endian 4 per byte, compacted over non-const blocks
    pos = rank[:, None] * bs + torch.arange(bs, device=dev, dtype=torch.int64)
    live_blk = (rank >= 0)[:, None]
    lidx = torch.where(live_blk, l_off + pos // 4, 0).clamp(0, cap - 1)
    code = (body[lidx].to(torch.int64) >> ((pos % 4) * 2)) & 3
    L = torch.where(live_blk, code, 0)
    # mid-stream offsets: exclusive cumsum of per-value stored-byte counts
    counts = (nbytes[:, None] - L).clamp(min=0)
    ends = torch.cumsum(counts.reshape(-1), 0).reshape(nb, bs)
    start = ends - counts
    mid_total = ends.reshape(-1)[-1]
    base = mid_off - (start[lo, 0] if rebase else 0)
    sl = slice(lo, lo + rb)
    L, start = L[sl], start[sl]
    nbytes_r, shift_r, mu_r = nbytes[sl], shift[sl], mu[sl]
    idxs = torch.arange(bs, device=dev, dtype=torch.int64)[None, :]
    ws = torch.zeros((rb, bs), dtype=torch.int64, device=dev)
    for j in range(W):
        sh = 8 * (W - 1 - j)
        stored = (L <= j) & (j < nbytes_r[:, None])
        gidx = torch.where(stored, base + start + (j - L), 0).clamp(0, cap - 1)
        byte = torch.where(stored, body[gidx].to(torch.int64), 0)
        if j >= spec.lead_cap:
            # L <= lead_cap <= j: every live value stores this plane itself
            ws = ws | (byte << sh)
            continue
        # fused-key index propagation (idx dominates; the surviving key
        # carries the byte of the nearest preceding stored position)
        key = torch.where(stored, idxs * 256 + byte, -1)
        key = torch.cummax(key, dim=1).values
        b = torch.where(key >= 0, key & 0xFF, 0)
        ws = ws | (b << sh)
    return _compose_word(ws, mu_r, shift_r, nbytes_r, spec), mid_total
