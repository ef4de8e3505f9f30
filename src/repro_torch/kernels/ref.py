"""Plain PyTorch versions of the width-generic SZx kernels, of the szx-planes
kernels and of the flash-attention forward.

These functions are the semantics the CUDA kernels in ``csrc/`` are held to,
bit for bit (the flash-attention forward to a stated tolerance, since its
sums run in another order): the CPU tests run them against the JAX package, and
``chip_smoke.py`` runs them on the card beside the kernels.  They are plain
tensor code and run on any device.

Every codec op is parameterized by a :class:`repro_torch.kernels.specs.DtypeSpec`.
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

import math

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
    # a block of zeros only: numpy's min/max end in a scalar pass that keeps
    # the later of two equal values, so both carry the LAST value's sign
    # (torch's and the card's reductions would pick either zero), and so
    # does mu; the radius is then +0
    zero = (mn == 0) & (mx == 0)
    mu = torch.where(zero, xb[:, -1].to(spec.dtype), mu)
    mu_w = mu.to(cdt)                              # exact widening
    mn = torch.where(zero, mu_w, mn)
    mx = torch.where(zero, mu_w, mx)
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


def unpack_ref(planes, mu, shift, nbytes, L, spec: DtypeSpec):
    """Inverse of :func:`pack_ref`: (nb, W, bs) byte planes -> (nb, bs)
    values in the spec's dtype.

    Planes below the lead cap run the fused-key (``idx*256 + byte``) cummax
    that carries each elided leading byte forward from the nearest
    preceding value that stored it; planes at or past the cap are stored by
    every live value.  Planes ``j >= nbytes`` of a block are not read.
    """
    nb, W, bs = planes.shape
    live = torch.arange(W, device=planes.device)[None, :] < nbytes[:, None]   # (nb, W)
    L = L.to(torch.int64)
    idxs = torch.arange(bs, device=planes.device, dtype=torch.int64)[None, :]
    ws = torch.zeros((nb, bs), dtype=torch.int64, device=planes.device)
    for j in range(W):
        byte = torch.where(live[:, j, None], planes[:, j].to(torch.int64), 0)
        if j < spec.lead_cap:
            key = torch.where((L <= j) & live[:, j, None], idxs * 256 + byte, -1)
            key = torch.cummax(key, dim=1).values
            byte = torch.where(key >= 0, key & 0xFF, 0)
        ws = ws | (byte << (8 * (W - 1 - j)))
    return _compose_word(ws, mu, shift, nbytes, spec)


def unpack_dense_ref(planes, mu, shift, nbytes, spec: DtypeSpec):
    """All-``L == 0`` fast path: every live plane byte sits at its own
    value, so no propagation runs.  Equals ``unpack_ref(..., L=0)``."""
    nb, W, bs = planes.shape
    live = torch.arange(W, device=planes.device)[None, :] < nbytes[:, None]
    ws = torch.zeros((nb, bs), dtype=torch.int64, device=planes.device)
    for j in range(W):
        byte = torch.where(live[:, j, None], planes[:, j].to(torch.int64), 0)
        ws = ws | (byte << (8 * (W - 1 - j)))
    return _compose_word(ws, mu, shift, nbytes, spec)


def bitshuffle_ref(tiles: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Bit transpose of each (T,) uint8 tile of ``tiles`` (nt, T), T % 8 == 0.

    Forward: bit k of input byte i lands at bit ``i % 8`` of output byte
    ``k * T/8 + i // 8`` -- ``np.packbits(..., bitorder="little")`` of the
    (8, T) bit matrix.  ``inverse=True`` is the exact inverse.
    """
    nt, T = tiles.shape
    k = torch.arange(8, device=tiles.device, dtype=torch.int32)
    bits = (tiles.to(torch.int32)[:, :, None] >> k) & 1           # (nt, T, 8)
    if inverse:
        bits = bits.reshape(nt, 8, T // 8, 8).permute(0, 2, 3, 1)
    else:
        bits = bits.permute(0, 2, 1)
    bits = bits.reshape(nt, T, 8)
    return (bits << k).sum(dim=2).to(torch.uint8)


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


# ---------------------------------------------------------------------------
# Fixed-plane ("szx-planes") mode: per-block mu, a scale from the radius
# exponent, and P uint8 quantization planes (gradient and activation traffic).
# ---------------------------------------------------------------------------
#
# The semantics are the reference's jax route on the CPU, which XLA runs with
# subnormals flushed: a subnormal operand counts as a zero of its sign, and a
# result that is tiny after rounding becomes a zero of its sign.  Sums of two
# such floats are exact when they are tiny, so one IEEE add and a flush give
# the same bits; a product is taken exactly in float64 and flushed when it is
# below FLT_MIN after rounding to 24 bits (``_TINY_PRODUCT``), then rounded
# once.  NaN bits follow the host too: an input NaN keeps its payload with the
# quiet bit set, a NaN made by the arithmetic (inf - inf, 0 * inf) is the
# host's default NaN ``0xFFC00000``.
#
# The scale is not an exact power of two: ``jnp.exp2`` lowers to
# ``exp(f32(ln 2) * s)``, and XLA's CPU exp misses 2**s by a few ulps for
# most integers s.  ``PLANES_SCALE_ULPS`` holds, for s = -125 .. 127, the
# difference in ulps between that value and 2**s; s <= -126 gives 0 (the
# result is below FLT_MIN and flushed) and s >= 128 gives inf.  The values
# are those of jax/jaxlib 0.9.0 on an x86-64 host with AVX-512 and FMA; XLA's
# exp differs for some s on other instruction sets, and
# tests/test_torch_planes.py compares the table with ``jnp.exp2``.  The CUDA
# kernels read the same table (``planes_scale_table``).

PLANES_SCALE_MIN, PLANES_SCALE_MAX = -125, 127
PLANES_SCALE_ULPS = (
    26, 14, 2, -20, -44, 30, 18, 6, -12, -36, -60, 22, 10, -4, -28, -52,        # -125
    26, 14, 2, -19, -43, -67, 18, 6, -11, -35, -59, 22, 10, -3, -27, -51,       # -109
    27, 15, 3, -19, 11, -3, -27, 7, -11, -35, 3, -19, 11, -3, -27, 7,           # -93
    -10, 15, 3, -18, 11, -2, -26, 7, -10, -34, 3, -18, 11, -2, -26, 7,          # -77
    -10, 15, 3, -18, 11, -2, -26, 7, -10, -34, 3, -18, 11, -2, -26, 7,          # -61
    -9, -1, 3, -17, -9, -1, 3, 7, -9, -1, 3, -17, -9, -1, 4, 8,                 # -45
    -9, -1, 4, -17, -9, -1, 4, -1, -9, -1, 4, -1, -9, -1, 4, 0,                 # -29
    -8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,                            # -13
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, -8, 0, 4, 0,                            # 3
    -7, 0, 4, 0, -7, 0, 4, 8, -7, 0, 4, -15, -7, 1, 5, 9,                       # 19
    -7, 1, 5, -15, -7, 1, 5, 9, -7, 1, 5, -15, 13, 1, -22, 9,                   # 35
    -6, 17, 5, -14, 13, 1, -22, 9, -6, -30, 5, -14, 13, 1, -22, 9,              # 51
    -6, 17, 5, -14, 13, 1, -22, 9, -6, -30, 5, -14, 13, 1, -21, 9,              # 67
    -5, 17, 5, -13, 13, 1, -21, 9, -5, -29, -53, 26, 14, 2, -21, -45,           # 83
    30, 18, 6, -13, -37, 34, 22, 10, -5, -29, -53, 26, 14, 2, -20, -44,         # 99
    30, 18, 6, -12, -36, -60, 22, 10, -4, -28, -52, 26, 14,                     # 115
)
_TINY = 2.0 ** -126
_TINY_PRODUCT = 2.0 ** -126 - 2.0 ** -151
_DEFAULT_NAN_BITS = -0x00400000          # 0xFFC00000 as int32
_QUIET_BIT = 0x00400000
_SCALE_TABLES: dict[torch.device, torch.Tensor] = {}


def planes_scale_table(device) -> torch.Tensor:
    """The reference's exp2(s) for s = -125 .. 127 as float32 on ``device``
    (cached per device)."""
    device = torch.device(device)
    tab = _SCALE_TABLES.get(device)
    if tab is None:
        bits = [((s + 127) << 23) + d for s, d in
                zip(range(PLANES_SCALE_MIN, PLANES_SCALE_MAX + 1), PLANES_SCALE_ULPS)]
        tab = torch.tensor(bits, dtype=torch.int32).view(torch.float32).to(device)
        _SCALE_TABLES[device] = tab
    return tab


def planes_exp2(s: torch.Tensor) -> torch.Tensor:
    """exp2 of integer-valued float32 ``s`` as the reference computes it."""
    tab = planes_scale_table(s.device)
    idx = s.clamp(PLANES_SCALE_MIN, PLANES_SCALE_MAX).to(torch.int64) - PLANES_SCALE_MIN
    v = tab[idx]
    v = torch.where(s < PLANES_SCALE_MIN, torch.zeros_like(v), v)
    return torch.where(s > PLANES_SCALE_MAX, torch.full_like(v, float("inf")), v)


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of the same sign (NaN passes)."""
    return torch.where(x.abs() < _TINY, torch.copysign(torch.zeros_like(x), x), x)


def mul_flushed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 product with the host's flush (tiny after rounding)."""
    p = a.double() * b.double()                      # exact: 24 + 24 bits
    p = torch.where(p.abs() < _TINY_PRODUCT, torch.copysign(torch.zeros_like(p), p), p)
    return p.float()


def _nan_to(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN replaced by the float32 whose int32 bits are
    ``bits`` (broadcast against ``x``)."""
    return torch.where(torch.isnan(x), bits.view(torch.float32), x)


def _quiet(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of float32 ``x`` with the quiet bit set."""
    return x.view(torch.int32) | _QUIET_BIT


def planes_encode_ref(xb: torch.Tensor, num_planes: int):
    """Error-bounded block quantization of (..., bs) float32 blocks to
    ``num_planes`` bytes.

    Returns (mu (...,) f32, sexp (...,) int32, planes (P, ..., bs) uint8):
    q = rint((x - mu) * scale(sexp)) clamped to the signed 8P-bit range, with
    sexp = 8P - 2 - E from the block radius exponent E, so |q| < 2^(8P-1).
    A NaN product (a constant block: radius 0 makes the scale inf) counts as
    q = 0.
    """
    assert 1 <= num_planes <= 3, "szx-planes supports 1..3 byte planes"
    xb = xb.to(torch.float32)
    xf = flush(xb)
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    # XLA orders -0 below +0 in min and max
    zero, neg = xf == 0, torch.signbit(xf)
    mn = torch.where(mn == 0, torch.where((zero & neg).any(-1), -0.0, 0.0), mn)
    mx = torch.where(mx == 0, torch.where((zero & ~neg).any(-1), 0.0, -0.0), mx)
    mu = mul_flushed(torch.full_like(mn, 0.5), flush(mn + mx))
    # mu of a block holding NaN is its first NaN, quieted; inf - inf is the
    # host's default NaN
    isn = torch.isnan(xb)
    first = torch.gather(xb, -1, isn.to(torch.int8).argmax(dim=-1, keepdim=True))[..., 0]
    mu = _nan_to(mu, torch.where(isn.any(-1), _quiet(first), _DEFAULT_NAN_BITS))
    radius = torch.maximum(flush(mx - mu), flush(mu - mn))
    E = ((radius.view(torch.int32) >> 23) & 0xFF) - 127
    nbits = 8 * num_planes
    sexp = ((nbits - 2) - E).to(torch.int32)
    v = flush(xf - mu[..., None])
    p = mul_flushed(v, planes_exp2(sexp.to(torch.float32))[..., None])
    lim = float(2 ** (nbits - 1))
    q = torch.round(p)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q).clamp(-lim, lim - 1)
    q = q.to(torch.int32)
    planes = torch.stack([((q >> (8 * k)) & 0xFF).to(torch.uint8)
                          for k in range(num_planes)], dim=0)
    return mu, sexp, planes


def planes_decode_ref(mu: torch.Tensor, sexp: torch.Tensor, planes: torch.Tensor):
    """Inverse of :func:`planes_encode_ref` -> (..., bs) float32:
    q * scale(-sexp) + mu.  num_planes (planes.shape[0]) must be <= 3."""
    num_planes = planes.shape[0]
    assert num_planes <= 3, "szx-planes supports 1..3 byte planes"
    nbits = 8 * num_planes
    uq = torch.zeros(planes.shape[1:], dtype=torch.int32, device=planes.device)
    for k in range(num_planes):
        uq = uq | (planes[k].to(torch.int32) << (8 * k))
    # sign-extend a width-`nbits` two's-complement integer
    q = torch.where(uq >= (1 << (nbits - 1)), uq - (1 << nbits), uq).to(torch.float32)
    mu = mu.to(torch.float32)
    scale = planes_exp2(-(sexp.to(torch.int32).to(torch.float32)))
    v = mul_flushed(q, scale[..., None])
    out = flush(v + flush(mu)[..., None])
    # a NaN mu wins over a NaN product (0 * inf); else a NaN is the default
    bits = torch.where(torch.isnan(mu), _quiet(mu), _DEFAULT_NAN_BITS)
    return _nan_to(out, bits[..., None])


# ---------------------------------------------------------------------------
# flash-attention forward (the model's attention)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024, q_offset: int = 0):
    """Online-softmax attention, as ``repro/models/layers.py::flash_attention``
    computes it.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) with Hq % Hkv == 0 (query
    head h reads kv head h // (Hq / Hkv)).  Query i sits at key index qpos =
    ``q_offset`` + i (the reference's "absolute position of q[:, 0]"); keys
    with kpos > qpos are masked when causal, and window > 0 masks keys with
    qpos - kpos >= window.  Scores are q.k^T in float32 (float64 for
    float64 inputs: the float64 checks) times 1/sqrt(hd); masked scores are
    -1e30, and p = exp(s - m) only where s > -5e29, so a fully masked row
    gives 0.  p @ v is in float32 (v promoted; float64 likewise).  Query and
    key chunks of ``q_chunk`` x ``kv_chunk`` set the order of summation.
    Returns (B, Sq, Hq, hd) in q.dtype.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    cq, ck = min(q_chunk, sq), min(kv_chunk, skv)
    pad_q, pad_k = (-sq) % cq, (-skv) % ck
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (sq + pad_q) // cq, (skv + pad_k) // ck
    qg = q.reshape(b, sq + pad_q, hkv, g, hd)
    dev = q.device
    f32 = torch.promote_types(q.dtype, torch.float32)
    outs = []
    for qi in range(nq):
        qx = qg[:, qi * cq:(qi + 1) * cq].to(f32)                  # (B,cq,hkv,g,hd)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=f32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=f32, device=dev)
        for ki in range(nk):
            kx = k[:, ki * ck:(ki + 1) * ck].to(f32)
            vx = v[:, ki * ck:(ki + 1) * ck].to(f32)
            kpos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qx, kx) * scale
            valid = (kpos[None, :] < skv) & (qpos[:, None] < q_offset + sq)
            if causal:
                valid &= kpos[None, :] <= qpos[:, None]
            if window:
                valid &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a fully masked row has s == m_new == -1e30, where exp(0) = 1
            p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vx)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, hd).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]
