// Flash-attention forward for Hopper (sm_90a): GQA, causal or sliding-window,
// online softmax with float32 accumulators.  Two routes, one per input type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (the fused form of repro/models/layers.py::
// flash_attention).  Held to the plain version
// repro_torch/kernels/ref.py::flash_attention_ref to a tolerance, not bits:
// the sums run in another order.
//
// What it computes, per query row: s = q.k * scale over the keys, masked to
// -1e30 where kpos >= skv, (causal) kpos > qpos or (window) qpos - kpos >=
// window, where kpos is a key's index and qpos = q_offset + i the query's
// (q_offset: the key index of query 0, the length of the halo of keys a
// sequence-sharded prefill puts before a rank's own; 0 for a whole
// sequence); then the online softmax of the reference --
// m_new = max(m, max_k s), p = exp(s - m_new) where s > -5e29 else 0,
// alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha + p @ v --
// and out = acc / max(l, 1e-30), rounded once to the input type.  A row with
// no valid key keeps m = -1e30, p = 0, alpha = exp(0) = 1 and gives 0, never
// NaN (-1e30 is finite).
//
// Layout: q, o (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd); contiguous, bf16 or
// float32, hd a multiple of 8 up to 128.  Both routes: a thread block owns
// one (batch, kv head) and a tile of query positions, with all G = Hq / Hkv
// query heads of that kv head -- its 64 rows are (position, head) pairs, so
// each K/V tile is read once per group -- and skips the key tiles that are
// wholly masked for it (above the causal diagonal, before the window): in
// the reference they leave m, l and acc unchanged.
//
// bf16 route (the main path: serving and training), on the tensor cores.
// Four warps of 16 rows each.  K/V tiles of 64 keys are double-buffered in
// bf16 shared memory by cp.async (16 B a thread; rows past Skv and the
// columns that pad hd to a multiple of 16 are zero-filled), rows padded by
// 16 B so that ldmatrix is free of bank conflicts.  q.k is
// mma.sync.m16n8k16 bf16 -> f32 (Q fragments by ldmatrix, K by ldmatrix):
// the products of bf16 values are exact in float32, as in the reference.
// p @ v needs float32 p (the reference's p and v are float32): p is split
// into three bf16 terms, hi = bf16(p), mid = bf16(p - hi), lo =
// bf16(p - hi - mid) (each subtraction exact), and each term is one MMA
// against the same V fragment (ldmatrix.trans), so p is carried to 24
// bits.  One bf16 term misses the bf16 output tolerance (2^-7 |ref| + 1e-6)
// by far; two still miss it on 1-2 outputs a case near zero
// (tests/test_torch_flash.py emulates the three).  Each key tile's p @ v is
// summed in its own float32 fragment and added as acc * alpha + tile, so the
// tensor cores' accumulation spans one tile.  Running max and sum stay in
// registers per row, reduced across the quad of lanes that hold the row.
// Bound: operations.  At the prefill shape (B 4, S 2048, 32 query and 8 kv
// heads of 64, causal) the useful work is 68.8 GFLOP (q.k and p @ v) and
// 84 MB; the route does 4 products, 137.5 GFLOP, whose floor at 989
// TFLOP/s bf16 is 0.139 ms, besides the exponentials and the split on the
// CUDA cores.  wgmma with TMA and warp specialisation are later work.
//
// float32 route, on the CUDA cores (off the main path).  Its tolerance
// (1e-5 |ref| + 1e-6) needs float32 products, which bf16 tensor cores do
// not give.  256 threads each own 4 rows x 4 keys of the score tile and 4
// rows x hd/16 columns of the accumulator; K/V tiles of 64 keys are staged
// in float32 shared memory (K transposed); p goes through shared memory
// between the two products, read only by the half-warp that wrote it.
// Bound: operations, 68.8 GFLOP at 67 TFLOP/s float32, 1.03 ms at the
// prefill shape.
//
// Contraction: every source is built with --fmad=false (the codec's bit
// identity needs it), so the multiply-adds of the softmax and the float32
// products are written as explicit __fmaf_rn, one rounding each, and the
// rest rounds step by step.
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int ROWS = 64;            // (position, head) rows a block owns
constexpr int BK = 64;              // keys per tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, hq, hkv, hd;
  int g, bq;                        // heads per kv head, positions per block
  int causal, window;
  int q_offset;                     // key index of query 0
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 route: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = ROWS / 16;
constexpr int MMA_THREADS = MMA_WARPS * 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<const unsigned*>(&h);
}

// (x, y) -> three bf16x2 terms hi + mid + lo == (x, y) to 24 bits; x, y
// become what is left after the three (each subtraction is exact)
__device__ __forceinline__ void split3(float x, float y, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  hi = pack_bf16(x, y);
  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xffff0000u);
  lo = pack_bf16(x, y);
}

// HDP: hd rounded up to 16, 32, 64, 80 or 128 (zero columns pad it).  Up to
// 64, at most 128 registers, so that four blocks (16 warps) share an SM: the
// warps' dependent chains (products, softmax, products) need the company.
template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS, HDP <= 64 ? 4 : 1) flash_fwd_bf16(const Params p) {
  constexpr int STR = HDP + 8;            // shared row stride (bf16): odd 16 B units
  constexpr int CH = HDP / 8;             // 16-byte chunks of a padded row
  constexpr int NT = HDP / 8;             // 8-column tiles of the output
  constexpr int KT = BK / 8;              // 8-key tiles of the scores
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [ROWS][STR]
  __nv_bfloat16* Ks = Qs + ROWS * STR;                           // [2][BK][STR]
  __nv_bfloat16* Vs = Ks + 2 * BK * STR;                         // [2][BK][STR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int bi = blockIdx.y / p.hkv;
  const int kh = blockIdx.y % p.hkv;
  const int q0 = qt * p.bq;
  const int nrows = p.g * p.bq;
  const int hdc = p.hd / 8;                      // real 16-byte chunks of a row
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kbase = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vbase = static_cast<const __nv_bfloat16*>(p.v);
  const int64_t kv_row = (int64_t)p.hkv * p.hd;  // elements per key position
  kbase += (int64_t)bi * p.skv * kv_row + (int64_t)kh * p.hd;
  vbase += (int64_t)bi * p.skv * kv_row + (int64_t)kh * p.hd;

  // row r of the block is query position q0 + r / g of head kh * g + r % g
  for (int it = tid; it < ROWS * CH; it += MMA_THREADS) {
    const int r = it / CH, c = it % CH;
    const int pos = q0 + r / p.g;
    const bool ok = r < nrows && pos < p.sq && c < hdc;
    const __nv_bfloat16* src =
        ok ? q + (((int64_t)bi * p.sq + pos) * p.hq + kh * p.g + r % p.g) * p.hd + c * 8 : q;
    cp_async16(Qs + r * STR + c * 8, src, ok);
  }
  // a K/V tile: each thread copies one 16-byte column chunk of rows
  // lr, lr + RPT, ... (threads past RPT * CH idle)
  constexpr int RPT = MMA_THREADS / CH;
  const int lc = tid % CH, lr = tid < RPT * CH ? tid / CH : BK;
  const bool col_ok = lc < hdc;
  const __nv_bfloat16* ksrc = kbase + lc * 8;
  const __nv_bfloat16* vsrc = vbase + lc * 8;
  auto load_kv = [&](int k0, int buf) {
#pragma unroll
    for (int j = lr; j < BK; j += RPT) {
      const bool ok = col_ok && k0 + j < p.skv;
      const int64_t off = ok ? (int64_t)(k0 + j) * kv_row : 0;
      cp_async16(Ks + (buf * BK + j) * STR + lc * 8, ksrc + off, ok);
      cp_async16(Vs + (buf * BK + j) * STR + lc * 8, vsrc + off, ok);
    }
  };

  // this thread's two rows: warp * 16 + gid and that + 8; qpos is the
  // row's query index, qpos + q_offset its key index
  int qpos[2], qkey[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
    qpos[h] = q0 + r / p.g;
    qkey[h] = p.q_offset + qpos[h];
    row_ok[h] = r < nrows && qpos[h] < p.sq;
  }
  // keys outside [kbeg, kend) are masked for every row of the block
  const int qlast = min(q0 + p.bq, p.sq) - 1;
  const int kfirst = p.q_offset + q0, klast = p.q_offset + qlast;   // the rows' key indices
  const int kend = p.causal ? min(p.skv, klast + 1) : p.skv;
  const int kbeg = p.window > 0 ? max(0, kfirst - p.window + 1) : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (ntiles > 0) load_kv(kbeg, 0);
  cp_async_commit();                      // Q and the first K/V tile

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lrow = lane & 7, lmat = lane >> 3;
  const __nv_bfloat16* qfrag = Qs + (warp * 16 + lrow + (lmat & 1) * 8) * STR + (lmat >> 1) * 8;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * BK;
    const int buf = t & 1;
    if (t + 1 < ntiles) load_kv(k0 + BK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                   // this tile (and Q) have landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BK * STR;
    const __nv_bfloat16* Vt = Vs + buf * BK * STR;

    // s = q.k on the tensor cores: 16 rows x 64 keys a warp
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, qfrag + kk * 16);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        unsigned b[4];              // keys jp*16 + (0..7 | 8..15), hd kk*16 + (0..7 | 8..15)
        ldsm_x4(b, Kt + (jp * 16 + lrow + (lmat >> 1) * 8) * STR + kk * 16 + (lmat & 1) * 8);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // scale, mask (only where the tile crosses an edge), online softmax
    bool edge = k0 + BK > p.skv;
    if (p.causal) edge = edge || k0 + BK - 1 > kfirst;
    if (p.window > 0) edge = edge || klast - k0 >= p.window;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * p.scale;
        if (edge) {
          const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
          bool ok = kpos < p.skv;
          if (p.causal) ok = ok && kpos <= qkey[h];
          if (p.window > 0) ok = ok && qkey[h] - kpos < p.window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
    if (edge) {
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[j][e] = s[j][e] > NEG_INF / 2 ? expf(s[j][e] - m[h]) : 0.f;
          sum[h] += s[j][e];
        }
    } else {                              // no score of the tile is masked
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[j][e] = expf(s[j][e] - m[h]);
          sum[h] += s[j][e];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = __fmaf_rn(l[h], alpha[h], sum[h]);
    }

    // this tile's p @ v: p = hi + mid + lo, three MMAs against each V fragment
    float pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A fragment of keys kk*16 .. +15: the score tiles 2kk and 2kk + 1
      unsigned hi[4], mid[4], lo[4];
      split3(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
      split3(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned b[4];              // keys kk*16 + (0..7 | 8..15), columns np*16 + (0..7 | 8..15)
        ldsm_x4_trans(b, Vt + (kk * 16 + lrow + (lmat & 1) * 8) * STR + np * 16 + (lmat >> 1) * 8);
        mma_bf16(pv[2 * np], lo, b[0], b[1]);
        mma_bf16(pv[2 * np], mid, b[0], b[1]);
        mma_bf16(pv[2 * np], hi, b[0], b[1]);
        mma_bf16(pv[2 * np + 1], lo, b[2], b[3]);
        mma_bf16(pv[2 * np + 1], mid, b[2], b[3]);
        mma_bf16(pv[2 * np + 1], hi, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fmaf_rn(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();                      // before the next load overwrites this buffer
  }
  cp_async_wait<0>();

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int r = warp * 16 + gid + 8 * h;
    __nv_bfloat16* dst = o + (((int64_t)bi * p.sq + qpos[h]) * p.hq + kh * p.g + r % p.g) * p.hd;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < p.hd)
        *reinterpret_cast<unsigned*>(dst + d) =
            pack_bf16(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    }
  }
}

template <int HDP>
cudaError_t launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(ROWS + 4 * BK) * (HDP + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, batch * p.hkv);
  flash_fwd_bf16<HDP><<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 route: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int PSTRIDE = BK + 4;     // row stride of p in shared memory

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// HDP: hd rounded up to 32, 64 or 128 (the padding columns hold zeros).
template <int HDP>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32(const Params p) {
  using T = float;
  constexpr int THREADS = F32_THREADS;
  constexpr int DCH = HDP / 8;            // 8-value chunks of a row
  constexpr int DPT = HDP / 16;           // accumulator columns per thread
  constexpr int VW = DPT < 4 ? DPT : 4;   // ... read VW at a time
  constexpr int NCH = DPT / VW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HDP][ROWS], transposed
  float* Ks = Qs + HDP * ROWS;                   // [HDP][BK], transposed
  float* Vs = Ks + HDP * BK;                     // [BK][HDP]
  float* Ps = Vs + BK * HDP;                     // [ROWS][PSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 15;                // key / column group
  const int ty = tid >> 4;                // row group: rows ty*4 .. ty*4+3
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int bi = blockIdx.y / p.hkv;
  const int kh = blockIdx.y % p.hkv;
  const int q0 = qt * p.bq;
  const int nrows = p.g * p.bq;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);
  const int64_t kv_row = (int64_t)p.hkv * p.hd;  // elements per key position
  const T* kbase = k + (int64_t)bi * p.skv * kv_row + (int64_t)kh * p.hd;
  const T* vbase = v + (int64_t)bi * p.skv * kv_row + (int64_t)kh * p.hd;

  // row r of the block is query position q0 + r / g of head kh * g + r % g
  for (int it = tid; it < ROWS * DCH; it += THREADS) {
    const int r = it % ROWS, dc = it / ROWS;
    const int pos = q0 + r / p.g;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nrows && pos < p.sq && dc * 8 < p.hd)
      load8(q + (((int64_t)bi * p.sq + pos) * p.hq + kh * p.g + r % p.g) * p.hd + dc * 8, x);
#pragma unroll
    for (int w = 0; w < 8; ++w) Qs[(dc * 8 + w) * ROWS + r] = x[w];
  }

  int qpos[4], qkey[4];                   // query index, key index (+ q_offset)
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = q0 + r / p.g;
    qkey[i] = p.q_offset + qpos[i];
    row_ok[i] = r < nrows && qpos[i] < p.sq;
  }
  // keys outside [kbeg, kend) are masked for every row of the block
  const int qlast = min(q0 + p.bq, p.sq) - 1;
  const int kend = p.causal ? min(p.skv, p.q_offset + qlast + 1) : p.skv;
  const int kbeg = p.window > 0 ? max(0, p.q_offset + q0 - p.window + 1) : 0;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int it = tid; it < BK * DCH; it += THREADS) {
      const int j = it % BK, dc = it / BK;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < p.skv && dc * 8 < p.hd) load8(kbase + (int64_t)(k0 + j) * kv_row + dc * 8, x);
#pragma unroll
      for (int w = 0; w < 8; ++w) Ks[(dc * 8 + w) * BK + j] = x[w];
    }
    for (int it = tid; it < BK * DCH; it += THREADS) {
      const int j = it / DCH, dc = it % DCH;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < p.skv && dc * 8 < p.hd) load8(vbase + (int64_t)(k0 + j) * kv_row + dc * 8, x);
      float4* dst = reinterpret_cast<float4*>(Vs + j * HDP + dc * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qs + d * ROWS + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Ks + d * BK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = __fmaf_rn(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx * 4 + jj;
        bool ok = row_ok[i] && kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qkey[i];
        if (p.window > 0) ok = ok && qkey[i] - kpos < p.window;
        s[i][jj] = ok ? s[i][jj] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = s[i][jj] > NEG_INF / 2 ? expf(s[i][jj] - m_new) : 0.f;
        sum += s[i][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = __fmaf_rn(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * PSTRIDE + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncwarp();                       // p rows are read by the half-warp that wrote them

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PSTRIDE + j);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * HDP + tx * VW;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float vv[VW];
          if constexpr (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + c * 16 * VW);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + c * 16 * VW);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][c * VW + w] = __fmaf_rn(pr[i][jj], vv[w], acc[i][c * VW + w]);
        }
      }
    }
    __syncthreads();                    // before the next tile overwrites K, V and p
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int r = ty * 4 + i;
    T* dst = o + (((int64_t)bi * p.sq + qpos[i]) * p.hq + kh * p.g + r % p.g) * p.hd;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        const int d = c * 16 * VW + tx * VW + w;
        if (d < p.hd) dst[d] = acc[i][c * VW + w] / denom;
      }
  }
}

template <int HDP>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(HDP * ROWS + HDP * BK + BK * HDP + ROWS * PSTRIDE);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, batch * p.hkv);
  flash_fwd_f32<HDP><<<grid, F32_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, int sq, int skv,
                   int hq, int hkv, int hd, int causal, int window, int q_offset,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.skv = skv; p.hq = hq; p.hkv = hkv; p.hd = hd;
  p.g = hq / hkv;
  p.bq = ROWS / p.g;
  p.causal = causal; p.window = window; p.q_offset = q_offset; p.scale = scale;
  return p;
}

}  // namespace

// The wrapper (kernels/flash_attention.py) picks the route by dtype and
// checks shapes, types, contiguity, 16-byte alignment, hd % 8 == 0,
// hd <= 128, Hq % Hkv == 0, Hq / Hkv <= 64 and q_offset >= 0; it launches
// nothing for an empty input.  Each returns the launch's cudaError_t (0: launched).
extern "C" int szx_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            void* o, int batch, int sq, int skv, int hq,
                                            int hkv, int hd, int causal, int window,
                                            int q_offset, float scale, cudaStream_t stream) {
  const Params p = make_params(q, k, v, o, sq, skv, hq, hkv, hd, causal, window, q_offset,
                               scale);
  cudaError_t err;
  if (hd <= 16) err = launch_bf16<16>(p, batch, stream);
  else if (hd <= 32) err = launch_bf16<32>(p, batch, stream);
  else if (hd <= 64) err = launch_bf16<64>(p, batch, stream);
  else if (hd <= 80) err = launch_bf16<80>(p, batch, stream);
  else err = launch_bf16<128>(p, batch, stream);
  return (int)err;
}

extern "C" int szx_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                           void* o, int batch, int sq, int skv, int hq,
                                           int hkv, int hd, int causal, int window,
                                           int q_offset, float scale, cudaStream_t stream) {
  const Params p = make_params(q, k, v, o, sq, skv, hq, hkv, hd, causal, window, q_offset,
                               scale);
  cudaError_t err;
  if (hd <= 32) err = launch_f32<32>(p, batch, stream);
  else if (hd <= 64) err = launch_f32<64>(p, batch, stream);
  else err = launch_f32<128>(p, batch, stream);
  return (int)err;
}
