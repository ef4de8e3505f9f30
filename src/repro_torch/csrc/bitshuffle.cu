// Bit transpose of byte tiles for Hopper (sm_90a): the second stage's shuffle.
//
// Replaces the Pallas TPU kernel repro/kernels/bitshuffle.py::bitshuffle
// (body shuffle_body).  Bit-identical to the plain version
// repro_torch/kernels/ref.py::bitshuffle_ref.  A tile is T = 1024 * itemsize
// bytes (2048, 4096 or 8192); tiles never mix.
//
//   forward: bit k of input byte i -> bit i % 8 of output byte k*T/8 + i/8
//            (np.packbits(..., bitorder="little") of the (8, T) bit matrix)
//   inverse: bit k of output byte i <- bit i % 8 of input byte k*T/8 + i/8
//
// What bounds it on this card: bytes.  It reads and writes each tile once;
// the bit work per byte is eight ballots or eight byte loads from L1.
// One thread block of 256 threads per tile.  Forward: a warp holds 32
// consecutive bytes i0..i0+31, and __ballot_sync of bit k over the warp is
// exactly the 4 output bytes k*T/8 + i0/8 ..+3; lane 4k + j stores byte j of
// mask k, so every lane stores one byte.  Inverse: each thread gathers its
// eight bits from the eight input rows (the 8 lanes of one output group read
// the same byte, served by L1).  Byte stores keep the kernel free of any
// alignment demand on the tensors it is given.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int T) {
  const long long base = (long long)blockIdx.x * T;
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;
  const int lane = threadIdx.x & 31;
  const int row = T / 8;
  for (int i = threadIdx.x; i < T; i += THREADS) {   // T % THREADS == 0
    const unsigned b = src[i];
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned m = __ballot_sync(FULL, (b >> k) & 1u);
      if ((lane >> 2) == k) mine = m;
    }
    const int i0 = i - lane;
    dst[(lane >> 2) * row + i0 / 8 + (lane & 3)] = (uint8_t)(mine >> (8 * (lane & 3)));
  }
}

__global__ void __launch_bounds__(THREADS)
bitunshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int T) {
  const long long base = (long long)blockIdx.x * T;
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;
  const int row = T / 8;
  for (int i = threadIdx.x; i < T; i += THREADS) {
    unsigned v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= ((src[k * row + i / 8] >> (i & 7)) & 1u) << k;
    dst[i] = (uint8_t)v;
  }
}

}  // namespace
}  // namespace szx

// Bit-transposes nt tiles of T bytes from `in` into `out` (forward, or the
// inverse with inverse != 0).  Returns cudaGetLastError() after the launch
// (0 = launched), or -1 when T is not a positive multiple of 256.  Launches
// on `stream`, never synchronizes, allocates nothing.
extern "C" int szx_bitshuffle(const uint8_t* in, uint8_t* out, long long nt, int T,
                              int inverse, void* stream) {
  using namespace szx;
  if (T <= 0 || T % THREADS) return -1;
  if (nt <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (inverse) {
    bitunshuffle_kernel<<<(unsigned)nt, THREADS, 0, s>>>(in, out, T);
  } else {
    bitshuffle_kernel<<<(unsigned)nt, THREADS, 0, s>>>(in, out, T);
  }
  return (int)cudaGetLastError();
}
