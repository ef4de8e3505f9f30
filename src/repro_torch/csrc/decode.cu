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
// handled by running gridless over the whole chunk.  Here it is two
// launches:
//   1. scan: one thread block per tile of SZx blocks counts each block's
//      stored bytes, sum max(nbytes - L, 0), from the L codes read a 32-bit
//      word (16 codes) at a time -- per word, the codes of each value
//      0..3 are counted with popc, no loop over codes -- scans the tile's
//      counts, and takes its tile's prefix by a decoupled look-back over the
//      earlier tiles' published sums (tiles numbered in the order they start,
//      so a tile only waits on tiles that run).  One pass over the L codes on
//      the whole card; the last tile writes the body's mid total.  The tile
//      status is scratch that the wrapper zeroes.
//   2. gather: each warp decodes a run of whole SZx blocks, 128 values at a
//      time, a lane holding V consecutive values of one block (V = 4 where
//      bs is a multiple of 4), so that the warp's scans -- the counts' scan
//      and, per plane, the carry of elided bytes across lanes -- run once
//      per V values.  The 128 values' metadata, L words and stored bytes
//      (one contiguous range of the body, staged into shared memory with
//      16-byte loads) are loaded first, in two rounds of independent loads.
//      The max-scan and the compose are szx_traits.cuh's max_scan and
//      compose, shared with unpack.cu.
// Measured, the gather is held by its instructions rather than its bytes: about a hundred a
// value (scans, the fused keys, the compose) at 64 registers, four blocks an
// SM; PERF.md has its times.
// Every body offset is int64 and every read index is clamped to the body as
// the plain version clamps it, so a corrupt stream cannot read out of bounds
// and still decodes as the plain version does; the host then checks the
// measured counts and raises.
#include <type_traits>

#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;                 // gather: warps per thread block
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int TILE_MAX = 2048;           // SZx blocks per scan tile, at most
constexpr int TILE_CODES = 32768;        // ... and about this many L codes
constexpr unsigned long long AGGREGATE = 1ull << 62;   // tile status flags
constexpr unsigned long long INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = (1ull << 62) - 1;

__device__ __forceinline__ long long clamp_idx(long long i, long long cap) {
  return i < 0 ? 0 : (i >= cap ? cap - 1 : i);
}

// The little-endian word of body bytes [off, off + 4), each clamped to the
// body as the plain version clamps it; `off` is 4-byte aligned in memory.
__device__ __forceinline__ uint32_t load_word(const uint8_t* body, long long cap, long long off) {
  if (off >= 0 && off + 4 <= cap) return *reinterpret_cast<const uint32_t*>(body + off);
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) w |= (uint32_t)body[clamp_idx(off + k, cap)] << (8 * k);
  return w;
}

// L codes: code `pos` (rank * bs + i) sits at body byte l_off + pos / 4, bits
// 2 * (pos % 4).  With mis = (address of body + l_off) % 4 and sp = pos +
// 4 * mis, code sp lies in the aligned word sp / 16 at body byte
// l_off - mis + 4 * (sp / 16), bits 2 * (sp % 16).

// Group size (lanes that count one SZx block) and tile size (SZx blocks a
// scan tile holds) for block size bs.
__host__ __device__ inline int group_lanes(int bs) {
  int g = 1;
  while (g < 32 && 2 * g <= bs / 16) g <<= 1;
  return g;
}
__host__ __device__ inline int tile_blocks(int bs) {
  const int t = TILE_CODES / (bs > 0 ? bs : 1);
  return t < 1 ? 1 : (t > TILE_MAX ? TILE_MAX : t);
}

// Launch 1: every block's first mid byte (exclusive scan of the stored-byte
// counts) and the body's total, in one pass with a decoupled look-back.
// status[ntiles] is the tile counter; status and it start at zero.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const uint8_t* __restrict__ body, long long cap, long long nb, int bs,
            long long l_off, int mis, const int* __restrict__ nbytes,
            const int* __restrict__ rank, unsigned long long* status, long long ntiles,
            long long* __restrict__ block_start, long long* __restrict__ mid_total) {
  __shared__ long long cnt[TILE_MAX];
  __shared__ long long wsum[SCAN_WARPS];
  __shared__ long long s_prefix;
  __shared__ long long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = (long long)atomicAdd(status + ntiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const int tb = tile_blocks(bs);
  const long long b0 = tile * tb;
  const int len = (int)(nb - b0 < tb ? nb - b0 : tb);

  // per-block counts: a group of G lanes a block, a word of 16 codes a lane
  const int G = group_lanes(bs);
  const int gid = tid / G, gl = tid % G;
  for (int base = 0; base < len; base += SCAN_THREADS / G) {
    const int bl = base + gid;
    long long c = 0;
    if (bl < len) {
      const int nbt = nbytes[b0 + bl];
      const int rk = rank[b0 + bl];
      if (rk < 0) {
        if (gl == 0) c = (long long)bs * max(nbt, 0);
      } else {
        const int per[4] = {max(nbt, 0), max(nbt - 1, 0), max(nbt - 2, 0), max(nbt - 3, 0)};
        const long long sp0 = (long long)rk * bs + 4 * mis;
        const long long wl = (sp0 + bs - 1) >> 4;
        for (long long w = (sp0 >> 4) + gl; w <= wl; w += G) {
          const uint32_t word = load_word(body, cap, l_off - mis + 4 * w);
          const long long f0 = sp0 - 16 * w, f1 = sp0 + bs - 16 * w;
          const int lo = f0 > 0 ? (int)f0 : 0, hi = f1 < 16 ? (int)f1 : 16;
          // one bit per code (its low bit) for the codes of this block
          const uint32_t mask = 0x55555555u & (hi == 16 ? 0xffffffffu : (1u << (2 * hi)) - 1u) &
                                ~((1u << (2 * lo)) - 1u);
          const uint32_t b_lo = word & mask, b_hi = (word >> 1) & mask;
          const int n3 = __popc(b_lo & b_hi), n1 = __popc(b_lo & ~b_hi);
          const int n2 = __popc(~b_lo & b_hi), n0 = __popc(mask) - n1 - n2 - n3;
          c += (long long)n0 * per[0] + (long long)n1 * per[1] + (long long)n2 * per[2] +
               (long long)n3 * per[3];
        }
      }
    }
    for (int o = G / 2; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
    if (bl < len && gl == 0) cnt[bl] = c;
  }
  __syncthreads();

  // the tile's exclusive scan: a run of items a thread, then across threads
  const int ipt = (len + SCAN_THREADS - 1) / SCAN_THREADS;
  const int i0 = min(tid * ipt, len), i1 = min(i0 + ipt, len);
  long long ts = 0;
  for (int i = i0; i < i1; ++i) ts += cnt[i];
  long long incl = ts;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < SCAN_WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < SCAN_WARPS; o <<= 1) {
      const long long u = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += u;
    }
    if (lane < SCAN_WARPS) wsum[lane] = w;
  }
  __syncthreads();
  const long long excl = incl - ts + (warp > 0 ? wsum[warp - 1] : 0);
  const long long agg = wsum[SCAN_WARPS - 1];

  // the tile's prefix: look back over the earlier tiles, 32 at a time
  if (warp == 0) {
    long long prefix = 0;
    if (tile > 0) {
      if (lane == 0) atomicExch(status + tile, AGGREGATE | (unsigned long long)agg);
      for (long long j0 = tile - 1;; j0 -= 32) {
        const long long j = j0 - lane;
        unsigned long long st = INCLUSIVE;           // before tile 0: an inclusive 0
        if (j >= 0) {
          do {
            st = *reinterpret_cast<volatile unsigned long long*>(status + j);
          } while ((st & ~VALUE) == 0);
        }
        const unsigned incl_lanes = __ballot_sync(FULL, (st & ~VALUE) == INCLUSIVE);
        const int stop = incl_lanes ? __ffs(incl_lanes) - 1 : 31;
        long long v = lane <= stop ? (long long)(st & VALUE) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        prefix += v;
        if (incl_lanes) break;
      }
    }
    if (lane == 0) {
      atomicExch(status + tile, INCLUSIVE | (unsigned long long)(prefix + agg));
      s_prefix = prefix;
      if (tile == ntiles - 1) *mid_total = prefix + agg;
    }
  }
  __syncthreads();
  long long run = s_prefix + excl;
  for (int i = i0; i < i1; ++i) {
    block_start[b0 + i] = run;
    run += cnt[i];
  }
}

// Inclusive sum over the lanes seg_lo..lane of the warp: seg_lo is the lane
// of this lane's block's first value in the tile (0 if it began earlier).
__device__ __forceinline__ int seg_sum(int x, int lane, int seg_lo) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, x, o);
    if (lane - o >= seg_lo) x += u;
  }
  return x;
}

// Launch 2: gather + propagate + compose.  Each warp decodes a run of whole
// SZx blocks (several where bs is small), 128 values at a time: a window of
// 4 / V tiles, where a lane holds V consecutive values of one block in each
// (V = 4 where bs is a multiple of 4, else 2 or 1), so that the warp's scans
// run once per V values.  A window first loads what its tiles need -- each
// lane's block metadata and the L-code word of its V values, and the
// window's stored bytes (one contiguous range of the body, at most W a
// value) staged into shared memory with 16-byte loads -- then per tile:
// the scan of the lanes' stored-byte counts, each value's stored bytes from
// the stage as one word (two or three aligned 32-bit reads and a funnel
// shift), and per plane below the lead cap the running max of the fused key
// over the lane's values, carried across lanes by max_scan.
template <typename S, int V>
__global__ void __launch_bounds__(WARPS * 32, 4)
gather_kernel(const uint8_t* __restrict__ body, long long cap, int bs, long long l_off,
              int mis, long long mid_off, long long lo, long long rb, int rebase,
              int per_warp, const S* __restrict__ mu, const int* __restrict__ shift,
              const int* __restrict__ nbytes, const int* __restrict__ rank,
              const long long* __restrict__ block_start, S* __restrict__ out) {
  using T = Traits<S>;
  using U = typename T::U;
  using X = typename std::conditional<T::W == 8, uint64_t, uint32_t>::type;
  struct alignas(sizeof(S) * V) Vals { S v[V]; };
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  constexpr int NT = 4 / V;                 // tiles a window
  constexpr int SPAN = 128 * W;             // a window's stored bytes, at most
  constexpr int NCHUNK = SPAN / 16 + 1;     // 16-byte loads that cover them
  // the stage, with a chunk to spare for the word reads past its end
  __shared__ __align__(16) uint32_t stage[WARPS][(NCHUNK + 1) * 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* buf = stage[warp];
  const unsigned le = FULL >> (31 - lane);  // this lane and the ones below
  const uintptr_t body_addr = reinterpret_cast<uintptr_t>(body);
  // rebase: the body's mid section starts at block lo's first mid byte
  const long long base = mid_off - (rebase ? block_start[lo] : 0);
  const long long nruns = (rb + per_warp - 1) / per_warp;

  for (long long run_i = (long long)blockIdx.x * WARPS + warp; run_i < nruns;
       run_i += (long long)gridDim.x * WARPS) {
    const long long r0 = run_i * per_warp;                  // first block, from lo
    const long long nblk = rb - r0 < per_warp ? rb - r0 : per_warp;
    const int nv = (int)nblk * bs;                          // a multiple of V
    S* const out_run = out + r0 * bs;
    int run = 0;                         // stored bytes of the block's earlier tiles
    int carry_key[LEAD];
#pragma unroll
    for (int j = 0; j < LEAD; ++j) carry_key[j] = -1;
    for (int v0 = 0; v0 < nv; v0 += 128) {
      // round 1: each lane's block and its metadata, for every tile
      int rr[NT], ii[NT], nbt[NT], sh[NT];
      long long bst[NT], sp[NT];
      S m[NT];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int v = min(v0 + (u * 32 + lane) * V, nv - V);
        rr[u] = per_warp == 1 ? 0 : v / bs;
        ii[u] = v - rr[u] * bs;
        const long long b = lo + r0 + rr[u];
        nbt[u] = nbytes[b];
        sh[u] = shift[b];
        m[u] = mu[b];
        const int rk = rank[b];
        bst[u] = base + block_start[b];
        sp[u] = rk < 0 ? -1 : (long long)rk * bs + ii[u] + 4 * mis;   // a multiple of V
      }
      // round 2: the L-code words and the window's stored bytes
      uint32_t word[NT];
#pragma unroll
      for (int u = 0; u < NT; ++u)
        word[u] = sp[u] >= 0 ? load_word(body, cap, l_off - mis + 4 * (sp[u] >> 4)) >>
                                   (2 * (sp[u] & 15))
                             : 0;
      long long w0 = __shfl_sync(FULL, bst[0] + (ii[0] > 0 ? run : 0), 0);
      long long w1 = w0 + SPAN;
      if (w0 < 0) w0 = 0;
      if (w1 > cap) w1 = cap;
      const long long a0 = w0 - (long long)((body_addr + (uintptr_t)w0) & 15);
      // the stage holds body bytes [a0, a0 + 16 * NCHUNK); [w0, w1) is read there
      const int lo_rel = (int)(w0 - a0), hi_rel = (int)max(w1 - a0, 0ll);
      for (int c = lane; c < NCHUNK && a0 + 16 * c < w1; c += 32) {
        const long long off = a0 + 16 * c;
        uint4 chunk;
        if (off >= 0 && off + 16 <= cap) {
          chunk = *reinterpret_cast<const uint4*>(body + off);
        } else {
          uint8_t tmp[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) tmp[k] = body[clamp_idx(off + k, cap)];
          chunk = *reinterpret_cast<const uint4*>(tmp);
        }
        *reinterpret_cast<uint4*>(stage[warp] + 4 * c) = chunk;
      }
      __syncwarp();

#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const bool valid = v0 + (u * 32 + lane) * V < nv;
        const int i0 = ii[u];            // the block index of the lane's first value
        const bool cont = i0 / V > lane;  // the block began in an earlier tile
        const int seg_lo = cont ? 0 : lane - i0 / V;
        const unsigned seg = le & ~((1u << seg_lo) - 1u);
        int L[V], cnt[V], lane_cnt = 0;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          L[k] = (int)(word[u] >> (2 * k)) & 3;
          cnt[k] = valid ? max(nbt[u] - L[k], 0) : 0;
          lane_cnt += cnt[k];
        }
        const int before = (cont ? run : 0) + seg_sum(lane_cnt, lane, seg_lo);   // inclusive
        run = __shfl_sync(FULL, before, 31);
        // the values' stored bytes, byte k of x[q] holding plane L[q] + k
        const long long start = bst[u] + before - lane_cnt;
        const long long d = start - a0;
        X x[V];
        if (d >= lo_rel && d + lane_cnt <= hi_rel) {
          int r = (int)d;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int q = r >> 2, f = 8 * (r & 3);
            const uint32_t lo32 = __funnelshift_r(buf[q], buf[q + 1], f);
            if constexpr (W == 8) {
              x[k] = (X)lo32 | ((X)__funnelshift_r(buf[q + 1], buf[q + 2], f) << 32);
            } else {
              x[k] = lo32;
            }
            r += cnt[k];
          }
        } else {                         // outside the window: a corrupt stream
          long long g = start;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            x[k] = 0;
#pragma unroll
            for (int t = 0; t < W; ++t)
              if (t < cnt[k]) x[k] |= (X)body[clamp_idx(g + t, cap)] << (8 * t);
            g += cnt[k];
          }
        }

        U ws[V];
#pragma unroll
        for (int k = 0; k < V; ++k) ws[k] = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          int key[V], lm = -1;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const bool stored = valid && L[k] <= j && j < nbt[u];
            key[k] = stored ? (i0 + k) * 256 + (int)((x[k] >> (8 * (j - L[k]))) & 0xFF) : -1;
            lm = max(lm, key[k]);
            key[k] = lm;                 // the running max over the lane's values
          }
          if (j < LEAD) {                // elided bytes come from earlier values
            const int carried = carry_key[j];
            const int upto = __shfl_up_sync(FULL, max_scan(lm, seg, carry_key[j], cont), 1);
            const int in = i0 == 0 ? -1 : (lane == 0 ? carried : upto);
#pragma unroll
            for (int k = 0; k < V; ++k) key[k] = max(key[k], in);
          }
#pragma unroll
          for (int k = 0; k < V; ++k)
            ws[k] |= (U)((U)(key[k] >= 0 ? key[k] & 0xFF : 0) << (8 * (W - 1 - j)));
        }
        if (valid) {
          Vals o;
#pragma unroll
          for (int k = 0; k < V; ++k) o.v[k] = compose<S>(ws[k], sh[u], m[u], nbt[u]);
          *reinterpret_cast<Vals*>(out_run + rr[u] * bs + i0) = o;
        }
      }
      __syncwarp();                      // the stage is rewritten next window
    }
  }
}

int blocks_per_warp(int bs) { return bs >= 128 ? 1 : 128 / bs; }

int grid_for(long long items) {
  const long long blocks = (items + WARPS - 1) / WARPS;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

int misalignment(const uint8_t* body, long long l_off) {
  return (int)((reinterpret_cast<uintptr_t>(body) + (uintptr_t)l_off) & 3);
}

template <typename S>
int launch_gather(const uint8_t* body, long long cap, int bs, long long l_off,
                  long long mid_off, long long lo, long long rb, int rebase,
                  const void* mu, const int* shift, const int* nbytes, const int* rank,
                  const long long* block_start, void* out, cudaStream_t stream) {
  const int per = blocks_per_warp(bs);
  const int grid = grid_for((rb + per - 1) / per);
  const int mis = misalignment(body, l_off);
  // V values a lane: out (from torch.empty) is aligned for V * sizeof(S)
  if (bs % 4 == 0)
    gather_kernel<S, 4><<<grid, WARPS * 32, 0, stream>>>(
        body, cap, bs, l_off, mis, mid_off, lo, rb, rebase, per, (const S*)mu, shift,
        nbytes, rank, block_start, (S*)out);
  else if (bs % 2 == 0)
    gather_kernel<S, 2><<<grid, WARPS * 32, 0, stream>>>(
        body, cap, bs, l_off, mis, mid_off, lo, rb, rebase, per, (const S*)mu, shift,
        nbytes, rank, block_start, (S*)out);
  else
    gather_kernel<S, 1><<<grid, WARPS * 32, 0, stream>>>(
        body, cap, bs, l_off, mis, mid_off, lo, rb, rebase, per, (const S*)mu, shift,
        nbytes, rank, block_start, (S*)out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace szx

// int64 words of tile status the caller zeroes for szx_decode_scan: one a
// tile and the tile counter.
extern "C" int szx_decode_status_len(long long nb, int bs) {
  const long long tb = szx::tile_blocks(bs);
  return (int)((nb + tb - 1) / tb + 1);
}

// Launch 1 alone: block_start[nb] (each block's first mid byte) and
// *mid_total, the body's L-implied mid-stream total.  `status` holds
// szx_decode_status_len(nb, bs) zeroed int64 words.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int szx_decode_scan(const uint8_t* body, long long cap, long long nb, int bs,
                               long long l_off, const int* nbytes, const int* rank,
                               unsigned long long* status, long long* block_start,
                               long long* mid_total, void* stream) {
  using namespace szx;
  const long long tb = tile_blocks(bs);
  const long long ntiles = (nb + tb - 1) / tb;
  scan_kernel<<<(unsigned)ntiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      body, cap, nb, bs, l_off, misalignment(body, l_off), nbytes, rank, status, ntiles,
      block_start, mid_total);
  return (int)cudaGetLastError();
}

// Launch 2 alone: blocks [lo, lo + rb) into `out` (rb * bs values), from
// the block_start of szx_decode_scan.  Returns cudaGetLastError(), or -1
// for an unknown dtype code.
extern "C" int szx_decode_gather(int code, const uint8_t* body, long long cap, int bs,
                                 long long l_off, long long mid_off, long long lo,
                                 long long rb, int rebase, const void* mu, const int* shift,
                                 const int* nbytes, const int* rank,
                                 const long long* block_start, void* out, void* stream) {
  using namespace szx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0:
      return launch_gather<float>(body, cap, bs, l_off, mid_off, lo, rb, rebase, mu, shift,
                                  nbytes, rank, block_start, out, s);
    case 1:
      return launch_gather<double>(body, cap, bs, l_off, mid_off, lo, rb, rebase, mu, shift,
                                   nbytes, rank, block_start, out, s);
    case 2:
      return launch_gather<__half>(body, cap, bs, l_off, mid_off, lo, rb, rebase, mu, shift,
                                   nbytes, rank, block_start, out, s);
    case 3:
      return launch_gather<__nv_bfloat16>(body, cap, bs, l_off, mid_off, lo, rb, rebase, mu,
                                          shift, nbytes, rank, block_start, out, s);
    default:
      return -1;
  }
}

// Decodes blocks [lo, lo + rb) of a stream body into `out` (rb * bs values)
// and writes the body's L-implied mid-stream total to *mid_total: the scan,
// then the gather.  `status` (zeroed, szx_decode_status_len words) and
// `block_start` (nb int64) are caller-owned scratch.  Returns the first
// nonzero cudaGetLastError() of the two launches (0 = launched), or -1 for
// an unknown dtype code.  Never synchronizes, allocates nothing.
extern "C" int szx_decode(int code, const uint8_t* body, long long cap, long long nb, int bs,
                          long long l_off, long long mid_off, long long lo, long long rb,
                          int rebase, const void* mu, const int* shift, const int* nbytes,
                          const int* rank, unsigned long long* status,
                          long long* block_start, long long* mid_total, void* out,
                          void* stream) {
  if (code < 0 || code > 3) return -1;
  const int err = szx_decode_scan(body, cap, nb, bs, l_off, nbytes, rank, status, block_start,
                                  mid_total, stream);
  if (err) return err;
  return szx_decode_gather(code, body, cap, bs, l_off, mid_off, lo, rb, rebase, mu, shift,
                           nbytes, rank, block_start, out, stream);
}
