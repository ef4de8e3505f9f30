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
// The per-block stats and pack are szx_blockcode.cuh's, shared with the
// two-call kernels block_stats.cu and pack.cu.
#include "szx_blockcode.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
encode_kernel(const S* __restrict__ x, long long nb, int bs,
              typename Traits<S>::C e, int p_e, S* __restrict__ mu_out,
              uint8_t* __restrict__ const_out, int* __restrict__ reqlen_out,
              int* __restrict__ shift_out, int* __restrict__ nbytes_out,
              uint8_t* __restrict__ planes, uint8_t* __restrict__ L_out) {
  using T = Traits<S>;
  using U = typename T::U;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;

  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const S* xb = x + blk * bs;
    const BlockStats<S> st = block_stats(xb, bs, e, p_e, lane);
    if (lane == 0) {
      mu_out[blk] = st.mu;
      const_out[blk] = st.cst ? 1 : 0;
      reqlen_out[blk] = st.reqlen;
      shift_out[blk] = st.shift;
      nbytes_out[blk] = st.nbytes;
    }
    uint8_t* pb = planes + blk * T::W * (long long)bs;
    uint8_t* Lb = L_out + blk * bs;
    pack_block(xb, bs, st.mu, st.shift, st.nbytes, lane, [&](int i, U ws, int L) {
      store_planes<U, T::W>(pb, bs, i, ws);
      Lb[i] = (uint8_t)L;
    });
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
