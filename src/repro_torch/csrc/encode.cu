// Fused SZx encode for Hopper (sm_90a): block statistics + pack in one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/encode.py::encode, whose
// bodies are block_stats.py::stats_body and pack.py::pack_body/plane_byte
// (paper Algorithm 1 lines 3-9).  Bit-identical to the plain version
// repro_torch/kernels/ref.py::encode_ref.
//
// What bounds it on this card: bytes.  Per value it reads the input word
// once from device memory and writes W plane bytes and one L byte; the
// arithmetic is a few dozen integer/float operations, far below the card's
// operation rate.  The design keeps every SZx block's work in one warp: the
// min/max reduction is a warp shuffle tree, the XOR predecessor of value i is
// lane i-1's shifted word (a shuffle; across 32-value tiles a carried word),
// so no intermediate array touches device memory.  The second read of the
// block for the pack pass hits L1/L2 (a block is bs * W bytes).  L is stored
// as one byte per value, not the reference's int32.
//
// Launch: 8 warps per thread block, one warp per SZx block, grid-stride over
// the nb blocks; bs is a runtime value (1..65535), walked in tiles of 32.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;

template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
  // jnp.min / np.min propagate NaN; fminf would drop it
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

template <typename C>
__device__ __forceinline__ C nan_max(C a, C b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
encode_kernel(const S* __restrict__ x, long long nb, int bs,
              typename Traits<S>::C e, int p_e, S* __restrict__ mu_out,
              uint8_t* __restrict__ const_out, int* __restrict__ reqlen_out,
              int* __restrict__ shift_out, int* __restrict__ nbytes_out,
              uint8_t* __restrict__ planes, uint8_t* __restrict__ L_out) {
  using T = Traits<S>;
  using C = typename T::C;
  using U = typename T::U;
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;

  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const S* xb = x + blk * bs;
    // ---- stats (Alg. 1 lines 3-7): min/max in the compute type
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
    S mu = T::narrow(C(0.5) * (mn + mx));           // storage-rounded mu
    const C muw = T::widen(mu);
    const C r = nan_max(mx - muw, muw - mn);        // radius vs rounded mu
    C r_test = r;
    if (T::GUARD) r_test = T::from_cbits(T::cbits(r) + 1);  // next-up radius
    // a NaN radius (NaN or inf in the block) is never constant: the next-up
    // step would wrap the card's all-ones NaN to -0.0
    const bool cst = r == r && r_test <= e;
    const int rexp = (int)((T::cbits(r) >> T::C_MANT) & T::C_EXP_MASK) - T::C_BIAS;
    const int req_m_raw = rexp - p_e + 1;
    const int req_m = min(max(req_m_raw, 0), T::MANT_BITS);
    if (req_m_raw > T::MANT_BITS) mu = T::from_bits(0);  // verbatim block
    int reqlen = 1 + T::EXP_BITS + req_m;
    int shift = (8 - reqlen % 8) % 8;
    int nbytes = (reqlen + shift) / 8;
    if (cst) reqlen = shift = nbytes = 0;
    if (lane == 0) {
      mu_out[blk] = mu;
      const_out[blk] = cst ? 1 : 0;
      reqlen_out[blk] = reqlen;
      shift_out[blk] = shift;
      nbytes_out[blk] = nbytes;
    }
    // ---- pack (lines 8-9): normalize, shift, XOR-lead, byte planes
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
        ws = (U)(w >> shift);
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
      if (valid) {
        uint8_t* pb = planes + blk * W * (long long)bs + i;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          pb[(long long)j * bs] = (uint8_t)(ws >> (8 * (W - 1 - j)));
        }
        L_out[blk * bs + i] = (uint8_t)L;
      }
    }
  }
}

template <typename S>
int launch(const void* x, long long nb, int bs, double e, int p_e, void* mu,
           uint8_t* cst, int* reqlen, int* shift, int* nbytes, uint8_t* planes,
           uint8_t* L, cudaStream_t stream) {
  using C = typename Traits<S>::C;
  long long blocks = (nb + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  // e reaches the kernel rounded to the compute type (round to nearest)
  encode_kernel<S><<<grid, WARPS * 32, 0, stream>>>(
      (const S*)x, nb, bs, (C)e, p_e, (S*)mu, cst, reqlen, shift, nbytes,
      planes, L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for an
// unknown dtype code.  Launches on `stream`, never synchronizes, allocates
// nothing: the caller passes every output buffer.
extern "C" int szx_encode(int code, const void* x, long long nb, int bs,
                          double e, int p_e, void* mu, uint8_t* cst,
                          int* reqlen, int* shift, int* nbytes,
                          uint8_t* planes, uint8_t* L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return szx::launch<float>(x, nb, bs, e, p_e, mu, cst, reqlen, shift,
                                nbytes, planes, L, s);
    case 1:
      return szx::launch<double>(x, nb, bs, e, p_e, mu, cst, reqlen, shift,
                                 nbytes, planes, L, s);
    case 2:
      return szx::launch<__half>(x, nb, bs, e, p_e, mu, cst, reqlen, shift,
                                 nbytes, planes, L, s);
    case 3:
      return szx::launch<__nv_bfloat16>(x, nb, bs, e, p_e, mu, cst, reqlen,
                                        shift, nbytes, planes, L, s);
    default:
      return -1;
  }
}
