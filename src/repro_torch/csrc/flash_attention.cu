// Flash-attention forward for Hopper (sm_90a): GQA, causal or sliding-window,
// online softmax with float32 accumulators.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (the fused form of repro/models/layers.py::
// flash_attention).  Held to the plain version
// repro_torch/kernels/ref.py::flash_attention_ref to a tolerance, not bits:
// the sums run in another order.
//
// What it computes, per query row: s = q.k * scale over the keys, masked to
// -1e30 where kpos >= skv, qpos >= sq, (causal) kpos > qpos or (window)
// qpos - kpos >= window; then the online softmax of the reference --
// m_new = max(m, max_k s), p = exp(s - m_new) where s > -5e29 else 0,
// alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha + p @ v --
// and out = acc / max(l, 1e-30), rounded once to the input type.  A row with
// no valid key keeps m = -1e30, p = 0, alpha = exp(0) = 1 and gives 0, never
// NaN (-1e30 is finite).
//
// Layout: q, o (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd); contiguous, bf16 or
// float32, hd a multiple of 8 up to 128.
//
// Design.  A thread block owns one (batch, kv head) and a tile of query
// positions, with all G = Hq / Hkv query heads of that kv head: its 64 rows
// are (position, head) pairs, so each K/V tile is read once per group.  K/V
// tiles of 64 keys are staged in shared memory as float32 (K transposed);
// 256 threads each own 4 rows x 4 keys of the score tile and 4 rows x hd/16
// columns of the accumulator.  Scores and p @ v are float32 FMAs on the CUDA
// cores (p @ v must be float32 as in the reference; the bf16 products q.k
// are exact in float32).  The running max, sum and accumulator stay in
// registers; p goes through shared memory between the two products, read
// only by the half-warp that wrote it.  Key tiles wholly masked for the
// block (above the causal diagonal, before the window) are skipped: in the
// reference they leave m, l and acc unchanged.
//
// What bounds it on this card: operations.  At the prefill shape (B 4,
// S 2048, 32 query and 8 kv heads of 64, causal) it moves 84 MB but does
// 68.7 GFLOP, and on the CUDA cores float32 runs at 67 TFLOP/s, not the
// tensor cores' 989 (bf16): the floor of this design is about 1 ms.  Tensor
// cores (mma.sync or wgmma for q.k; the p @ v in float32 needs a split or
// TF32 scheme), TMA and warp specialisation are later work.
//
// Contraction: every source is built with --fmad=false (the codec's bit
// identity needs it), so the products here are written as explicit
// __fmaf_rn, one rounding a multiply-add, and the rest rounds step by step.
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;            // (position, head) rows a block owns
constexpr int BK = 64;              // keys per tile
constexpr int PSTRIDE = BK + 4;     // row stride of p in shared memory
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, hq, hkv, hd;
  int g, bq;                        // heads per kv head, positions per block
  int causal, window;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// HDP: hd rounded up to 32, 64 or 128 (the padding columns hold zeros).
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS) flash_fwd(const Params p) {
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

  int qpos[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = q0 + r / p.g;
    row_ok[i] = r < nrows && qpos[i] < p.sq;
  }
  // keys outside [kbeg, kend) are masked for every row of the block
  const int qlast = min(q0 + p.bq, p.sq) - 1;
  const int kend = p.causal ? min(p.skv, qlast + 1) : p.skv;
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

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
        if (p.causal) ok = ok && kpos <= qpos[i];
        if (p.window > 0) ok = ok && qpos[i] - kpos < p.window;
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
        if (d < p.hd) store1(dst + d, acc[i][c * VW + w] / denom);
      }
  }
}

template <typename T, int HDP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(HDP * ROWS + HDP * BK + BK * HDP + ROWS * PSTRIDE);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, batch * p.hkv);
  flash_fwd<T, HDP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, batch, stream);
  if (p.hd <= 64) return launch<T, 64>(p, batch, stream);
  return launch<T, 128>(p, batch, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  The wrapper (kernels/flash_attention.py)
// checks shapes, types, contiguity, hd % 8 == 0, hd <= 128, Hq % Hkv == 0
// and Hq / Hkv <= 64, and launches nothing for an empty input.
extern "C" int szx_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int batch, int sq, int skv, int hq, int hkv,
                                       int hd, int causal, int window, float scale,
                                       cudaStream_t stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.skv = skv; p.hq = hq; p.hkv = hkv; p.hd = hd;
  p.g = hq / hkv;
  p.bq = ROWS / p.g;
  p.causal = causal; p.window = window; p.scale = scale;
  const cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(p, batch, stream)
                                     : dispatch<float>(p, batch, stream);
  return (int)err;
}
