// SZx decompression from laid-out byte planes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/unpack.py::unpack and
// ::unpack_dense (bodies _make_kernel, _make_dense_kernel, _compose).
// Bit-identical to the plain versions repro_torch/kernels/ref.py::unpack_ref
// and ::unpack_dense_ref.  The store's host-parse route and its exact query
// tier reach them through core/codec/transform.py::decode_blocks.
//
// Input: planes (nb, W, bs) uint8 (byte j of each shifted word, MSB first),
// per-block mu / shift / nbytes, and for `unpack` the XOR-lead counts L
// (nb, bs) uint8.  Output: (nb, bs) values.
//
// What bounds it on this card: bytes.  It reads each live plane byte and L
// once and writes each value once.  Design: one warp per SZx block (as in
// decode.cu, whose index propagation and compose it shares through
// szx_traits.cuh), walking the block in 32-value tiles.  Planes below the
// lead cap run the fused-key max-scan carried across tiles; planes at or
// past it are stored by every live value and are read as they are.
// `unpack_dense` (every L = 0) skips the scan.  Offsets are int64.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;

template <typename S, bool DENSE>
__global__ void __launch_bounds__(WARPS * 32)
unpack_kernel(const uint8_t* __restrict__ planes, const S* __restrict__ mu,
              const int* __restrict__ shift, const int* __restrict__ nbytes,
              const uint8_t* __restrict__ L, long long nb, int bs,
              S* __restrict__ out) {
  using T = Traits<S>;
  using U = typename T::U;
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;

  for (long long b = warp0; b < nb; b += nwarps) {
    const int nbt = nbytes[b];
    const int sh = shift[b];
    const S m = mu[b];
    const uint8_t* pb = planes + b * W * (long long)bs;
    int carry_key[LEAD];
#pragma unroll
    for (int j = 0; j < LEAD; ++j) carry_key[j] = -1;
    for (int t = 0; t < bs; t += 32) {
      const int i = t + lane;
      const bool valid = i < bs;
      const int Lv = (DENSE || !valid) ? 0 : L[b * bs + i];
      U ws = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const bool live = valid && j < nbt;
        const int byte = live ? pb[(long long)j * bs + i] : 0;
        if (DENSE || j >= LEAD) {        // every live value stores this plane
          ws |= (U)((U)byte << (8 * (W - 1 - j)));
          continue;
        }
        const int key = max_scan(live && Lv <= j ? i * 256 + byte : -1, lane, carry_key[j]);
        const int bb = key >= 0 ? (key & 0xFF) : 0;
        ws |= (U)((U)bb << (8 * (W - 1 - j)));
      }
      if (valid) out[b * bs + i] = compose<S>(ws, sh, m, nbt);
    }
  }
}

template <typename S>
int launch(const uint8_t* planes, const void* mu, const int* shift,
           const int* nbytes, const uint8_t* L, long long nb, int bs, void* out,
           cudaStream_t stream) {
  const long long blocks = (nb + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  if (L == nullptr) {
    unpack_kernel<S, true><<<grid, WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, (S*)out);
  } else {
    unpack_kernel<S, false><<<grid, WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, (S*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// Decodes nb blocks of bs values from their byte planes into `out`.  L ==
// NULL runs unpack_dense (every L = 0).  Returns cudaGetLastError() after
// the launch (0 = launched), or -1 for an unknown dtype code.  Launches on
// `stream`, never synchronizes, allocates nothing.
extern "C" int szx_unpack(int code, const uint8_t* planes, const void* mu,
                          const int* shift, const int* nbytes, const uint8_t* L,
                          long long nb, int bs, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return szx::launch<float>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 1:
      return szx::launch<double>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 2:
      return szx::launch<__half>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 3:
      return szx::launch<__nv_bfloat16>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    default:
      return -1;
  }
}
