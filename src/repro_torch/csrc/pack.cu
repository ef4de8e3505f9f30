// SZx pack for Hopper (sm_90a): the second of the two-call encode's kernels.
//
// Replaces the Pallas TPU kernel repro/kernels/pack.py::pack (paper
// Algorithm 1 lines 8-9): normalize against mu, right-shift by the caller's
// shift (Solution C), XOR-lead against the predecessor, byte planes, and
// the per-value mid-byte counts nbytes - L.  Bit-identical to the plain
// version repro_torch/kernels/ref.py::pack_ref (L and mid as int32, the
// reference's dtypes), and to the pack half of the fused encode (encode.cu):
// both run szx_blockcode.cuh's pack_block.  shift and nbytes are the
// caller's and are never recomputed: the paper's Fig. 6 analysis packs with
// shift = 0 to count Solution B's bits.
//
// What bounds it on this card: bytes.  Per value it reads the input word
// once and writes W plane bytes plus two int32 counts (L, mid), so writes
// dominate.  One warp owns one SZx block; the XOR predecessor of value i is
// lane i-1's shifted word (a shuffle; across 32-value tiles a carried word).
//
// Launch: 8 warps per thread block, grid-stride over the nb blocks.
#include "szx_blockcode.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
pack_kernel(const S* __restrict__ x, long long nb, int bs,
            const S* __restrict__ mu, const int* __restrict__ shift,
            const int* __restrict__ nbytes, uint8_t* __restrict__ planes,
            int* __restrict__ L_out, int* __restrict__ mid_out) {
  using T = Traits<S>;
  using U = typename T::U;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const int nbk = nbytes[blk];
    uint8_t* pb = planes + blk * T::W * (long long)bs;
    int* Lb = L_out + blk * bs;
    int* mb = mid_out + blk * bs;
    pack_block(x + blk * bs, bs, mu[blk], shift[blk], nbk, lane,
               [&](int i, U ws, int L) {
                 store_planes<U, T::W>(pb, bs, i, ws);
                 Lb[i] = L;
                 mb[i] = nbk - L;
               });
  }
}

template <typename S>
int launch(const void* x, long long nb, int bs, const void* mu, const int* shift,
           const int* nbytes, uint8_t* planes, int* L, int* mid,
           cudaStream_t stream) {
  long long blocks = (nb + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  pack_kernel<S><<<grid, WARPS * 32, 0, stream>>>(
      (const S*)x, nb, bs, (const S*)mu, shift, nbytes, planes, L, mid);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for an
// unknown dtype code.  Launches on `stream`, never synchronizes, allocates
// nothing: the caller passes every output buffer.
extern "C" int szx_pack(int code, const void* x, long long nb, int bs,
                        const void* mu, const int* shift, const int* nbytes,
                        uint8_t* planes, int* L, int* mid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return szx::launch<float>(x, nb, bs, mu, shift, nbytes, planes, L, mid, s);
    case 1:
      return szx::launch<double>(x, nb, bs, mu, shift, nbytes, planes, L, mid, s);
    case 2:
      return szx::launch<__half>(x, nb, bs, mu, shift, nbytes, planes, L, mid, s);
    case 3:
      return szx::launch<__nv_bfloat16>(x, nb, bs, mu, shift, nbytes, planes, L,
                                        mid, s);
    default:
      return -1;
  }
}
