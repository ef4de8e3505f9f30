// Per-block SZx statistics and pack, warp-level device code shared by the
// fused encode (encode.cu) and the two-call kernels (block_stats.cu,
// pack.cu), so the three cannot drift.  Counterpart of the Pallas bodies
// repro/kernels/block_stats.py::stats_body and pack.py::pack_body/plane_byte
// (paper Algorithm 1 lines 3-7 and 8-9).
//
// One warp owns one SZx block of `bs` values (any bs >= 1, walked in tiles
// of 32): every lane of the warp must call these functions together.
#pragma once

#include "szx_traits.cuh"

namespace szx {

template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
  // jnp.min / np.min propagate NaN; fminf would drop it
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

template <typename C>
__device__ __forceinline__ C nan_max(C a, C b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// What Algorithm 1 lines 3-7 give one block; every lane holds all of it.
template <typename S>
struct BlockStats {
  S mu;                       // storage-rounded mid-range (0 for verbatim blocks)
  typename Traits<S>::C radius;  // vs the rounded mu, in the compute type
  bool cst;                   // constant block: |x - mu| <= e for every value
  int reqlen, shift, nbytes;  // 0 for constant blocks
};

template <typename S>
__device__ __forceinline__ BlockStats<S> block_stats(const S* xb, int bs,
                                                     typename Traits<S>::C e,
                                                     int p_e, int lane) {
  using T = Traits<S>;
  using C = typename T::C;
  // min/max in the compute type
  C mn = T::widen(xb[0]);
  C mx = mn;
  for (int i = lane; i < bs; i += 32) {
    C v = T::widen(xb[i]);
    mn = nan_min(mn, v);
    mx = nan_max(mx, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(FULL, mn, o));
    mx = nan_max(mx, __shfl_xor_sync(FULL, mx, o));
  }
  BlockStats<S> st;
  st.mu = T::narrow(C(0.5) * (mn + mx));           // storage-rounded mu
  // a block of zeros only: numpy's min/max end in a scalar pass that keeps
  // the later of two equal values, so min, max and mu carry the LAST
  // value's sign (and the radius is +0)
  if (mn == C(0) && mx == C(0)) {
    st.mu = xb[bs - 1];
    mn = mx = T::widen(st.mu);
  }
  const C muw = T::widen(st.mu);
  const C r = nan_max(mx - muw, muw - mn);        // radius vs rounded mu
  C r_test = r;
  if (T::GUARD) r_test = T::from_cbits(T::cbits(r) + 1);  // next-up radius
  // a NaN radius (NaN or inf in the block) is never constant: the next-up
  // step would wrap the card's all-ones NaN to -0.0
  st.cst = r == r && r_test <= e;
  st.radius = r;
  const int rexp = (int)((T::cbits(r) >> T::C_MANT) & T::C_EXP_MASK) - T::C_BIAS;
  const int req_m_raw = rexp - p_e + 1;
  const int req_m = min(max(req_m_raw, 0), T::MANT_BITS);
  if (req_m_raw > T::MANT_BITS) st.mu = T::from_bits(0);  // verbatim block
  st.reqlen = 1 + T::EXP_BITS + req_m;
  st.shift = (8 - st.reqlen % 8) % 8;
  st.nbytes = (st.reqlen + st.shift) / 8;
  if (st.cst) st.reqlen = st.shift = st.nbytes = 0;
  return st;
}

// Pack (lines 8-9): normalize against mu, right-shift by `shift` (Solution
// C), XOR against the predecessor's shifted word (the zero word before
// value 0), count identical leading bytes (capped at LEAD and at nbytes).
// Calls store(i, ws, L) once for each value i of the block, in any order;
// ws is the shifted word whose byte j (0 = most significant) is plane j.
// A shift at or past the word width shifts every bit out.
template <typename S, typename Store>
__device__ __forceinline__ void pack_block(const S* xb, int bs, S mu, int shift,
                                           int nbytes, int lane, Store store) {
  using T = Traits<S>;
  using C = typename T::C;
  using U = typename T::U;
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  const C mu_c = T::widen(mu);
  U carry = 0;                                    // zero word before value 0
  for (int t = 0; t < bs; t += 32) {
    const int i = t + lane;
    const bool valid = i < bs;
    U ws = 0;
    if (valid) {
      const S xs = xb[i];
      const C xc = T::widen(xs);
      // NaN sits in a verbatim block (mu = 0): keep numpy's bits for it
      const U w = xc != xc ? T::quiet(T::bits(xs)) : T::bits(T::narrow(xc - mu_c));
      ws = shift < 8 * W ? (U)(w >> shift) : (U)0;
    }
    U prev = shfl_up(ws, 1);
    if (lane == 0) prev = carry;
    carry = shfl_idx(ws, 31);
    const U xw = ws ^ prev;
    int L = 0;
#pragma unroll
    for (int j = 0; j < LEAD; ++j) {
      if (L == j && (U)(xw >> (8 * (W - 1 - j))) == 0) L = j + 1;
    }
    L = min(L, nbytes);
    if (valid) store(i, ws, L);
  }
}

// The W byte planes of value i of a block whose planes start at pb
// ((W, bs) bytes): byte j of the shifted word lands in plane j.
template <typename U, int W>
__device__ __forceinline__ void store_planes(uint8_t* pb, int bs, int i, U ws) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    pb[(long long)j * bs + i] = (uint8_t)(ws >> (8 * (W - 1 - j)));
  }
}

}  // namespace szx
