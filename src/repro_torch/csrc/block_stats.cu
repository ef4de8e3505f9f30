// SZx per-block statistics for Hopper (sm_90a): the first of the two-call
// encode's kernels.
//
// Replaces the Pallas TPU kernel repro/kernels/block_stats.py::block_stats
// (paper Algorithm 1 lines 3-7).  Bit-identical to the plain version
// repro_torch/kernels/ref.py::block_stats_ref, and to the stats half of the
// fused encode (encode.cu): both run szx_blockcode.cuh's block_stats.
//
// What bounds it on this card: bytes.  It reads each input value once and
// writes 4-8 bytes of statistics per block of bs values, with a few float
// operations per value.  One warp owns one SZx block: the min/max
// reduction is a warp shuffle tree and lane 0 writes the block's six
// outputs (mu, radius, const as a byte, reqlen, shift, nbytes).
//
// Launch: 8 warps per thread block, grid-stride over the nb blocks.
#include "szx_blockcode.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
block_stats_kernel(const S* __restrict__ x, long long nb, int bs,
                   typename Traits<S>::C e, int p_e, S* __restrict__ mu_out,
                   typename Traits<S>::C* __restrict__ radius_out,
                   uint8_t* __restrict__ const_out, int* __restrict__ reqlen_out,
                   int* __restrict__ shift_out, int* __restrict__ nbytes_out) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const BlockStats<S> st = block_stats(x + blk * bs, bs, e, p_e, lane);
    if (lane == 0) {
      mu_out[blk] = st.mu;
      radius_out[blk] = st.radius;
      const_out[blk] = st.cst ? 1 : 0;
      reqlen_out[blk] = st.reqlen;
      shift_out[blk] = st.shift;
      nbytes_out[blk] = st.nbytes;
    }
  }
}

template <typename S>
int launch(const void* x, long long nb, int bs, double e, int p_e, void* mu,
           void* radius, uint8_t* cst, int* reqlen, int* shift, int* nbytes,
           cudaStream_t stream) {
  using C = typename Traits<S>::C;
  long long blocks = (nb + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  // e reaches the kernel rounded to the compute type (round to nearest)
  block_stats_kernel<S><<<grid, WARPS * 32, 0, stream>>>(
      (const S*)x, nb, bs, (C)e, p_e, (S*)mu, (C*)radius, cst, reqlen, shift,
      nbytes);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for an
// unknown dtype code.  Launches on `stream`, never synchronizes, allocates
// nothing: the caller passes every output buffer.
extern "C" int szx_block_stats(int code, const void* x, long long nb, int bs,
                               double e, int p_e, void* mu, void* radius,
                               uint8_t* cst, int* reqlen, int* shift,
                               int* nbytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return szx::launch<float>(x, nb, bs, e, p_e, mu, radius, cst, reqlen,
                                shift, nbytes, s);
    case 1:
      return szx::launch<double>(x, nb, bs, e, p_e, mu, radius, cst, reqlen,
                                 shift, nbytes, s);
    case 2:
      return szx::launch<__half>(x, nb, bs, e, p_e, mu, radius, cst, reqlen,
                                 shift, nbytes, s);
    case 3:
      return szx::launch<__nv_bfloat16>(x, nb, bs, e, p_e, mu, radius, cst,
                                        reqlen, shift, nbytes, s);
    default:
      return -1;
  }
}
