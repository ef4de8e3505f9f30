// Fused SZx stream-body decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode.py::decode_body (with
// unpack.py::_compose): 2-bit L-code expansion, the exclusive cumsum of
// `nbytes - L` that gives every value's offset into the mid-byte stream,
// the gather of the stored bytes straight from the raw body, the fused-key
// (idx*256 + byte) max-scan that propagates elided leading bytes, and the
// compose (shift back, bitcast, add mu, fill constant blocks).  Bit-identical
// to the plain version repro_torch/kernels/ref.py::decode_body_ref.
//
// What bounds it on this card: bytes.  It reads the body (the compressed
// size) and writes the values; the integer work per value is small.  The
// cumsum couples every SZx block to all earlier ones, which the TPU kernel
// handled by running gridless over the whole chunk.  Here it is three
// launches:
//   1. one warp per SZx block sums max(nbytes - L, 0) over its values;
//   2. one thread block scans those per-block totals (exclusive), looping
//      over nb in tiles of 1024 -- simple, and the first suspect if decode
//      time is ever dominated by it;
//   3. one warp per decoded block redoes the in-block exclusive scan of the
//      counts (warp shuffles, carried across 32-value tiles), gathers its
//      bytes, runs the max-scan per plane below the lead cap (carried across
//      tiles), and composes the values.  The max-scan and the compose are
//      szx_traits.cuh's max_scan and compose, shared with unpack.cu.
// Every body offset is int64 and every gather index is clamped to the body,
// so a corrupt stream cannot read out of bounds; the host then checks the
// measured counts and raises.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ long long clamp_idx(long long i, long long cap) {
  return i < 0 ? 0 : (i >= cap ? cap - 1 : i);
}

// 2-bit L code of value i of a block with compacted rank rk (-1: const).
__device__ __forceinline__ int l_code(const uint8_t* body, long long cap,
                                      long long l_off, int rk, int bs, int i) {
  if (rk < 0) return 0;
  const long long pos = (long long)rk * bs + i;
  const long long li = clamp_idx(l_off + pos / 4, cap);
  return (body[li] >> ((pos % 4) * 2)) & 3;
}

// Launch 1: per-block stored-byte totals sum_v max(nbytes - L_v, 0).
__global__ void __launch_bounds__(WARPS * 32)
block_counts_kernel(const uint8_t* __restrict__ body, long long cap,
                    long long nb, int bs, long long l_off,
                    const int* __restrict__ nbytes, const int* __restrict__ rank,
                    long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long b = warp0; b < nb; b += nwarps) {
    const int nbt = nbytes[b];
    const int rk = rank[b];
    long long sum = 0;
    for (int i = lane; i < bs; i += 32) {
      sum += max(nbt - l_code(body, cap, l_off, rk, bs, i), 0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) counts[b] = sum;
  }
}

// Launch 2: exclusive scan of the per-block totals; *total = their sum.
__global__ void __launch_bounds__(SCAN_THREADS)
exclusive_scan_kernel(const long long* __restrict__ in, long long n,
                      long long* __restrict__ out, long long* __restrict__ total) {
  __shared__ long long warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < n; base += SCAN_THREADS) {
    const long long i = base + threadIdx.x;
    const long long v = i < n ? in[i] : 0;
    long long s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    if (lane == 31) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long t = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const long long prefix = warp > 0 ? warp_sums[warp - 1] : 0;
    if (i < n) out[i] = carry + prefix + s - v;
    carry += warp_sums[SCAN_THREADS / 32 - 1];
    __syncthreads();                     // warp_sums is rewritten next tile
  }
  if (threadIdx.x == 0) *total = carry;
}

// Launch 3: gather + propagate + compose, one warp per decoded block.
template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
decode_blocks_kernel(const uint8_t* __restrict__ body, long long cap, int bs,
                     long long l_off, long long mid_off, long long lo,
                     long long rb, int rebase, const S* __restrict__ mu,
                     const int* __restrict__ shift, const int* __restrict__ nbytes,
                     const int* __restrict__ rank,
                     const long long* __restrict__ block_start,
                     S* __restrict__ out) {
  using T = Traits<S>;
  using U = typename T::U;
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  // rebase: the body's mid section starts at block lo's first mid byte
  const long long base = mid_off - (rebase ? block_start[lo] : 0);

  for (long long r = warp0; r < rb; r += nwarps) {
    const long long b = lo + r;
    const int nbt = nbytes[b];
    const int sh = shift[b];
    const int rk = rank[b];
    const S m = mu[b];
    const long long bstart = base + block_start[b];
    long long run = 0;                   // stored bytes of earlier tiles
    int carry_key[LEAD];
#pragma unroll
    for (int j = 0; j < LEAD; ++j) carry_key[j] = -1;
    for (int t = 0; t < bs; t += 32) {
      const int i = t + lane;
      const bool valid = i < bs;
      const int Lv = valid ? l_code(body, cap, l_off, rk, bs, i) : 0;
      const int cnt = valid ? max(nbt - Lv, 0) : 0;
      int s = cnt;                       // inclusive in-tile scan of counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += u;
      }
      const long long start = bstart + run + (s - cnt);
      run += __shfl_sync(FULL, s, 31);
      U ws = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const bool stored = valid && Lv <= j && j < nbt;
        const int byte = stored ? body[clamp_idx(start + (j - Lv), cap)] : 0;
        if (j >= LEAD) {                 // every live value stores this plane
          ws |= (U)((U)byte << (8 * (W - 1 - j)));
          continue;
        }
        const int key = max_scan(stored ? i * 256 + byte : -1, lane, carry_key[j]);
        const int bb = key >= 0 ? (key & 0xFF) : 0;
        ws |= (U)((U)bb << (8 * (W - 1 - j)));
      }
      if (valid) out[r * bs + i] = compose<S>(ws, sh, m, nbt);
    }
  }
}

int grid_for(long long items) {
  const long long blocks = (items + WARPS - 1) / WARPS;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

template <typename S>
int launch_blocks(const uint8_t* body, long long cap, int bs, long long l_off,
                  long long mid_off, long long lo, long long rb, int rebase,
                  const void* mu, const int* shift, const int* nbytes,
                  const int* rank, const long long* block_start, void* out,
                  cudaStream_t stream) {
  decode_blocks_kernel<S><<<grid_for(rb), WARPS * 32, 0, stream>>>(
      body, cap, bs, l_off, mid_off, lo, rb, rebase, (const S*)mu, shift,
      nbytes, rank, block_start, (S*)out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// Decodes blocks [lo, lo + rb) of a stream body into `out` (rb * bs values)
// and writes the body's L-implied mid-stream total to *mid_total.  `counts`
// and `block_start` are caller-owned scratch of nb int64 each.  Returns the
// first nonzero cudaGetLastError() of the three launches (0 = launched), or
// -1 for an unknown dtype code.  Never synchronizes, allocates nothing.
extern "C" int szx_decode(int code, const uint8_t* body, long long cap,
                          long long nb, int bs, long long l_off,
                          long long mid_off, long long lo, long long rb,
                          int rebase, const void* mu, const int* shift,
                          const int* nbytes, const int* rank, long long* counts,
                          long long* block_start, long long* mid_total,
                          void* out, void* stream) {
  using namespace szx;
  cudaStream_t s = (cudaStream_t)stream;
  if (code < 0 || code > 3) return -1;
  block_counts_kernel<<<grid_for(nb), WARPS * 32, 0, s>>>(
      body, cap, nb, bs, l_off, nbytes, rank, counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  exclusive_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(counts, nb, block_start, mid_total);
  err = (int)cudaGetLastError();
  if (err) return err;
  switch (code) {
    case 0:
      return launch_blocks<float>(body, cap, bs, l_off, mid_off, lo, rb, rebase,
                                  mu, shift, nbytes, rank, block_start, out, s);
    case 1:
      return launch_blocks<double>(body, cap, bs, l_off, mid_off, lo, rb, rebase,
                                   mu, shift, nbytes, rank, block_start, out, s);
    case 2:
      return launch_blocks<__half>(body, cap, bs, l_off, mid_off, lo, rb, rebase,
                                   mu, shift, nbytes, rank, block_start, out, s);
    default:
      return launch_blocks<__nv_bfloat16>(body, cap, bs, l_off, mid_off, lo, rb,
                                          rebase, mu, shift, nbytes, rank,
                                          block_start, out, s);
  }
}
