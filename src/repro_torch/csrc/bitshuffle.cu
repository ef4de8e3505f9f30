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
// What bounds it on this card: bytes.  It reads and writes each tile once.
// Two routes, chosen by the caller from the pointers alone
// (kernels/bitshuffle.py::route); each entry point refuses what its route
// does not take.
//
//   vector (input and output on 16 bytes; T a multiple of 64): a thread
//     owns 64 consecutive bytes i0..i0+63 of a tile.  Output row k, bytes
//     i0/8 .. i0/8+7, is bit k of those bytes, so with the eight 64-bit
//     words of the 64 bytes (four 16-byte loads) it is an 8x8 bit transpose
//     of each word (three delta swaps, no ballots) followed by an 8x8 byte
//     transpose across the eight words (byte permutes), then one 8-byte
//     store a row; neighbouring threads store neighbouring words.  The
//     inverse is the mirror: one 8-byte load from each of the eight rows,
//     the byte transpose, the bit transposes, four 16-byte stores.  Blocks
//     of 64 threads (one 4096-byte tile), so the store chunk's ~164 tiles
//     already spread over the 132 SMs.
//   scalar (any other pointer): one block of 256 threads per tile.
//     Forward: a warp holds 32 consecutive bytes i0..i0+31, and
//     __ballot_sync of bit k over the warp is exactly the 4 output bytes
//     k*T/8 + i0/8 ..+3; lane 4k + j stores byte j of mask k.  Inverse: each
//     thread gathers its eight bits from the eight input rows.  Byte loads
//     and stores ask no alignment of the tensors.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int THREADS = 256;          // scalar route
constexpr int VTHREADS = 64;          // vector route
constexpr int CHUNK = 64;             // vector route: bytes a thread

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

// 8x8 bit transpose of the 64-bit word (lo, hi) whose byte r, bit c is
// element (r, c): afterwards byte c, bit r holds it.  Delta swaps within
// 2x2, then 4x4 blocks inside each 32-bit half, then the 4x4 blocks across
// the halves.
__device__ __forceinline__ void transpose_bits(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = ((lo >> 4) ^ hi) & 0x0F0F0F0Fu;
  hi ^= t;
  lo ^= t << 4;
}

// 8x8 byte transpose of eight 64-bit words w[m] = (lo[m], hi[m]): byte k
// of the result's word m is byte m of w[k].  Four 4x4 transposes
// (szx_traits.cuh), the two off-diagonal ones trading places.
__device__ __forceinline__ void transpose_bytes(uint32_t (&lo)[8], uint32_t (&hi)[8]) {
  uint32_t a[8], b[8];
  transpose_bytes4(lo[0], lo[1], lo[2], lo[3], a[0], a[1], a[2], a[3]);
  transpose_bytes4(lo[4], lo[5], lo[6], lo[7], b[0], b[1], b[2], b[3]);
  transpose_bytes4(hi[0], hi[1], hi[2], hi[3], a[4], a[5], a[6], a[7]);
  transpose_bytes4(hi[4], hi[5], hi[6], hi[7], b[4], b[5], b[6], b[7]);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    lo[m] = a[m];
    hi[m] = b[m];
  }
}

template <bool INVERSE>
__device__ __forceinline__ void shuffle_chunks(const uint8_t* __restrict__ in,
                                               uint8_t* __restrict__ out, long long chunks,
                                               int T) {
  const int per_tile = T / CHUNK;
  const int row = T / 8;
  for (long long c = (long long)blockIdx.x * VTHREADS + threadIdx.x; c < chunks;
       c += (long long)gridDim.x * VTHREADS) {
    const long long tile = c / per_tile;
    const int q = (int)(c - tile * per_tile);        // this thread's 64 bytes: q*64 ..
    const long long base = tile * T;
    uint32_t lo[8], hi[8];
    if (!INVERSE) {
      const uint4* src = reinterpret_cast<const uint4*>(in + base + (long long)q * CHUNK);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint4 v = src[h];
        lo[2 * h] = v.x, hi[2 * h] = v.y, lo[2 * h + 1] = v.z, hi[2 * h + 1] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) transpose_bits(lo[m], hi[m]);
      transpose_bytes(lo, hi);                       // word k: row k's 8 bytes
#pragma unroll
      for (int k = 0; k < 8; ++k)
        *reinterpret_cast<uint2*>(out + base + (long long)k * row + 8 * q) =
            make_uint2(lo[k], hi[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(in + base + (long long)k * row + 8 * q);
        lo[k] = v.x, hi[k] = v.y;
      }
      transpose_bytes(lo, hi);                       // word m: output bytes 8m .. 8m+7
#pragma unroll
      for (int m = 0; m < 8; ++m) transpose_bits(lo[m], hi[m]);
      uint4* dst = reinterpret_cast<uint4*>(out + base + (long long)q * CHUNK);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        dst[h] = make_uint4(lo[2 * h], hi[2 * h], lo[2 * h + 1], hi[2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(VTHREADS)
bitshuffle_vector_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                         long long chunks, int T) {
  shuffle_chunks<false>(in, out, chunks, T);
}

__global__ void __launch_bounds__(VTHREADS)
bitunshuffle_vector_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                           long long chunks, int T) {
  shuffle_chunks<true>(in, out, chunks, T);
}

}  // namespace
}  // namespace szx

// Bit-transposes nt tiles of T bytes from `in` into `out` (forward, or the
// inverse with inverse != 0).  Returns cudaGetLastError() after the launch
// (0 = launched, or nothing to launch), or -1 for what the route does not
// take: T a positive multiple of 64 with `in` and `out` on 16 bytes for the
// vector route, T a positive multiple of 256 for the scalar route.
// Launches on `stream`, never synchronizes, allocates nothing.
extern "C" int szx_bitshuffle_vector(const uint8_t* in, uint8_t* out, long long nt, int T,
                                     int inverse, void* stream) {
  using namespace szx;
  if (T <= 0 || T % CHUNK || (uintptr_t)in % 16 || (uintptr_t)out % 16) return -1;
  if (nt <= 0) return 0;
  const long long chunks = nt * (T / CHUNK);
  const long long blocks = (chunks + VTHREADS - 1) / VTHREADS;
  const unsigned grid = (unsigned)(blocks < (1ll << 30) ? blocks : (1ll << 30));
  cudaStream_t s = (cudaStream_t)stream;
  if (inverse) {
    bitunshuffle_vector_kernel<<<grid, VTHREADS, 0, s>>>(in, out, chunks, T);
  } else {
    bitshuffle_vector_kernel<<<grid, VTHREADS, 0, s>>>(in, out, chunks, T);
  }
  return (int)cudaGetLastError();
}

extern "C" int szx_bitshuffle_scalar(const uint8_t* in, uint8_t* out, long long nt, int T,
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
