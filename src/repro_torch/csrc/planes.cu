// szx-planes encode and decode for Hopper (sm_90a): fixed-plane block
// quantization of float32 (gradient and activation traffic).
//
// Replaces the Pallas TPU kernels repro/kernels/planes.py::planes_encode and
// ::planes_decode.  Bit-identical to the plain versions
// repro_torch/kernels/ref.py::planes_encode_ref and ::planes_decode_ref,
// which reproduce the reference's jax route on the CPU:
//
//   - subnormals are flushed, explicitly: an operand below FLT_MIN counts as a
//     zero of its sign; a sum is taken in IEEE float and flushed when it is
//     tiny (such a sum is exact); a product is taken exactly in double and
//     flushed when it is tiny after rounding to 24 bits (below
//     2^-126 - 2^-151), then rounded once.  The rules are written out, not
//     left to -ftz=true, so kernel and plain version apply one test;
//   - min and max propagate NaN and order -0 below +0;
//   - the scale exp2(s) is read from the reference's table (`scale_tab`,
//     s = -125 .. 127: XLA computes exp2 as exp(ln2 * s), a few ulps off
//     2^s); below -125 it is 0, above 127 inf.  Never exp2f;
//   - NaN bits: mu of a block holding NaN is its first NaN, quieted; a NaN
//     made by the arithmetic (inf - inf, 0 * inf) is 0xFFC00000; a NaN
//     quantized value counts as q = 0 before the clamp (fminf/fmaxf would
//     turn it into the clamp's bound).
//
// What bounds them on this card: bytes.  Encode reads 4 B a value and writes
// P B a value plus 8 B a block; decode the reverse.  At 3.35 TB/s that is
// about 1.5 ns per 1000 values, so a kernel that waits on one dependent
// chain per 256 B of reads (what a warp per block with 2 values a lane did)
// is held by latency, not by the bytes.  Two routes, chosen by the wrapper
// from the shape and the pointers' alignment alone (kernels/planes.py,
// `route`), never on failure:
//
//   - the vector route, for a power-of-two block of 4 or more values, float32
//     data on 16 bytes and planes on min(bs, 16) bytes.  Encode: a lane owns
//     V = min(bs, 16) consecutive values, read as V/4 float4 loads and kept in
//     registers (flushed) from the min/max to the quantization: one read.  A
//     block is a group of G = bs/V lanes (4 at the gradient's and the KV
//     cache's 64, so 8 blocks a warp); a block wider than 512 values takes
//     the whole warp in bs/512 chunks and is read a second time for the
//     quantization (from L2).  Min and max run on ordered integer keys of the
//     flushed values (see `key_of`: -0 below +0, +-inf at the ends, which is
//     xla_min/xla_max without NaN), one unsigned min and max a value and
//     log2(G) shuffle rounds a block; one ballot tells a group whether it
//     holds a NaN, and only such a group looks for its first NaN.  The scale
//     table sits in shared memory, the per-block scalar work (mu, radius,
//     sexp, scale) is done once per V values, and each lane writes its V
//     bytes of a plane as one 4/8/16-byte store, so a warp's plane store is
//     128 B or more.  Decode: a lane owns 4 values, reads its 4 bytes of each
//     plane as one 32-bit load (mu and sexp of its block beside them; the
//     lanes of one block read one address) and writes one float4; each
//     thread issues the loads of 4 such quads before it computes, and sexp is
//     read at its stored width (int8 for the KV cache, int16 on the gradient
//     wire, int32), so the caller launches no cast.  Both size the grid to
//     the card (resident blocks x SMs) and walk it grid-stride;
//   - the scalar route, for every other shape (bs = 1, 3, 6, ..., or a view
//     off 16 bytes): a warp per block, 32 lanes stepping through it, two
//     reads of the block, one-byte plane stores.
//
// The arithmetic per value is the same on both routes, and the same as the
// plain version's.  Indices are 64-bit throughout.
#include <float.h>
#include <limits.h>
#include <stdint.h>
#include <cuda_runtime.h>

namespace szx {
namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;                     // warps a thread block
constexpr int SCALE_MIN = -125, SCALE_MAX = 127;
constexpr int NSCALE = SCALE_MAX - SCALE_MIN + 1;
constexpr int QUADS = 4;                     // decode: quads of 4 values a thread at a time
constexpr int WIDE = 512;                    // encode: values a warp holds of a wide block
constexpr unsigned DEFAULT_NAN = 0xFFC00000u;
constexpr unsigned QUIET = 0x00400000u;
// 2^-126 - 2^-151: a product below it rounds (to 24 bits) below FLT_MIN
constexpr double TINY_PRODUCT = 0x1.ffffffp-127;

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// a * b with the product's flush; `b` already in double (exact)
__device__ __forceinline__ float mul_ftz(float a, double b) {
  const double p = __dmul_rn((double)a, b);               // exact
  if (fabs(p) < TINY_PRODUCT) return copysignf(0.0f, (float)p);
  return __double2float_rn(p);
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  return flush(__fadd_rn(a, b));
}

__device__ __forceinline__ float xla_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? a : b;                  // -0 below +0
  return b < a ? b : a;
}

__device__ __forceinline__ float xla_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return signbit(a) ? b : a;
  return b > a ? b : a;
}

__device__ __forceinline__ float scale_of(float s, const float* __restrict__ tab) {
  if (s < (float)SCALE_MIN) return 0.0f;
  if (s > (float)SCALE_MAX) return __int_as_float(0x7F800000);
  return tab[(int)s - SCALE_MIN];
}

// Order-preserving key of a float that is not NaN: unsigned order of keys is
// xla_min/xla_max's order of the values (-inf < ... < -0 < +0 < ... < +inf).
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float(k ^ ((unsigned)((int)~k >> 31) | 0x80000000u));
}

// q = rint((f - mu) * scale), a NaN q as 0, clamped to [-lim, lim - 1]
__device__ __forceinline__ unsigned quantize(float f, float mu, double scale, float lim) {
  float q = rintf(mul_ftz(add_ftz(f, -mu), scale));       // half to even
  if (q != q) q = 0.0f;                                   // before the clamp
  q = fminf(fmaxf(q, -lim), lim - 1.0f);
  return (unsigned)(int)q;
}

// sexp of a block from its min, max and mu
__device__ __forceinline__ int block_sexp(float mn, float mx, float mu, int nbits) {
  const float radius = xla_max(add_ftz(mx, -mu), add_ftz(mu, -mn));
  const int E = (int)((__float_as_uint(radius) >> 23) & 0xFFu) - 127;
  return (nbits - 2) - E;
}

// decoded value of quantized q: q * scale(-sexp) + flush(mu), NaN rules
__device__ __forceinline__ float dequantize(int q, double scale, float m, float fm) {
  float y = add_ftz(mul_ftz((float)q, scale), fm);
  if (m != m) {
    y = __uint_as_float(__float_as_uint(m) | QUIET);      // a NaN mu wins
  } else if (y != y) {
    y = __uint_as_float(DEFAULT_NAN);
  }
  return y;
}

__device__ __forceinline__ void load_table(float* tab, const float* __restrict__ tab_g) {
  for (int i = threadIdx.x; i < NSCALE; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// vector route
// ---------------------------------------------------------------------------

// V floats at p (16-byte aligned), flushed
template <int V>
__device__ __forceinline__ void load_flushed(float (&f)[V], const float* __restrict__ p) {
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + j);
    f[4 * j] = flush(w.x);
    f[4 * j + 1] = flush(w.y);
    f[4 * j + 2] = flush(w.z);
    f[4 * j + 3] = flush(w.w);
  }
}

// fold V values at block offset `at` into a lane's key range and first NaN
template <int V>
__device__ __forceinline__ void fold(const float (&f)[V], int at, unsigned& kmin,
                                     unsigned& kmax, int& first_nan) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned k = key_of(f[i]);
    kmin = min(kmin, k);
    kmax = max(kmax, k);
    if (f[i] != f[i]) first_nan = min(first_nan, at + i);
  }
}

// quantize V values and write byte k of each to plane k (V bytes a plane,
// one store: p is V-byte aligned)
template <int V, int P>
__device__ __forceinline__ void store_planes(const float (&f)[V], float mu, double scale,
                                             float lim, uint8_t* __restrict__ p,
                                             long long plane_stride) {
  unsigned q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = quantize(f[i], mu, scale, lim);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const unsigned sel = (unsigned)k | ((unsigned)(k + 4) << 4);   // byte k of a, of b
    unsigned w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const unsigned lo = __byte_perm(q[4 * j], q[4 * j + 1], sel);
      const unsigned hi = __byte_perm(q[4 * j + 2], q[4 * j + 3], sel);
      w[j] = __byte_perm(lo, hi, 0x5410);
    }
    uint8_t* pk = p + k * plane_stride;
    if constexpr (V == 4) {
      *reinterpret_cast<unsigned*>(pk) = w[0];
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(pk) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(pk) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Encode of blocks of bs = (V << lg_g) * chunks values: a group of 2^lg_g
// lanes a block (32 >> lg_g blocks a warp), V values a lane a chunk; chunk 0
// stays in registers, later chunks (wide blocks, lg_g = 5) are read again.
template <int V, int P>
__global__ void __launch_bounds__(WARPS * 32)
planes_encode_vector_kernel(const float* __restrict__ x, long long nb, int lg_g, int chunks,
                            const float* __restrict__ tab_g, float* __restrict__ mu_out,
                            int* __restrict__ sexp_out, uint8_t* __restrict__ planes) {
  __shared__ float tab[NSCALE];
  load_table(tab, tab_g);
  const int lane = threadIdx.x & 31;
  const int G = 1 << lg_g;
  const int gl = lane & (G - 1);
  const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int span = G * V;                                 // values of one chunk
  const long long bs = (long long)span * chunks;
  const long long per_warp = 32 >> lg_g;
  const long long ntiles = (nb + per_warp - 1) / per_warp;
  const long long plane_stride = nb * bs;
  const int nbits = 8 * P;
  const float lim = (float)(1 << (nbits - 1));

  for (long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); t < ntiles;
       t += (long long)gridDim.x * WARPS) {
    const long long blk = t * per_warp + (lane >> lg_g);
    const bool live = blk < nb;
    const long long base = blk * bs + gl * V;
    float f[V];
    unsigned kmin = FULL, kmax = 0u;
    int first_nan = INT_MAX;
    if (live) {
      load_flushed(f, x + base);
      fold(f, gl * V, kmin, kmax, first_nan);
      for (int c = 1; c < chunks; ++c) {
        float g[V];
        load_flushed(g, x + base + (long long)c * span);
        fold(g, c * span + gl * V, kmin, kmax, first_nan);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < G) {
        kmin = min(kmin, __shfl_xor_sync(FULL, kmin, o));
        kmax = max(kmax, __shfl_xor_sync(FULL, kmax, o));
      }
    }
    const bool nan_group = (__ballot_sync(FULL, first_nan != INT_MAX) & gmask) != 0u;
    const float mn = value_of(kmin), mx = value_of(kmax);
    float mu = mul_ftz(0.5f, (double)add_ftz(mn, mx));
    if (nan_group) {                                      // the first NaN, quieted
      for (int o = 16; o > 0; o >>= 1) {
        if (o < G) first_nan = min(first_nan, __shfl_xor_sync(gmask, first_nan, o));
      }
      mu = __uint_as_float(__float_as_uint(x[blk * bs + first_nan]) | QUIET);
    } else if (mu != mu) {
      mu = __uint_as_float(DEFAULT_NAN);                  // inf - inf
    }
    if (!live) continue;
    const int sexp = block_sexp(mn, mx, mu, nbits);
    const double scale = (double)scale_of((float)sexp, tab);
    if (gl == 0) {
      mu_out[blk] = mu;
      sexp_out[blk] = sexp;
    }
    store_planes<V, P>(f, mu, scale, lim, planes + base, plane_stride);
    for (int c = 1; c < chunks; ++c) {
      const long long off = base + (long long)c * span;
      load_flushed(f, x + off);
      store_planes<V, P>(f, mu, scale, lim, planes + off, plane_stride);
    }
  }
}

// Decode of blocks of bs = 4 << lg_q values: a thread takes QUADS quads of 4
// values at a stride of the thread block, issuing all their loads first.
template <int P, typename S>
__global__ void __launch_bounds__(WARPS * 32)
planes_decode_vector_kernel(const float* __restrict__ mu, const S* __restrict__ sexp,
                            const uint8_t* __restrict__ planes, long long nb, int lg_q,
                            const float* __restrict__ tab_g, float* __restrict__ out) {
  __shared__ float tab[NSCALE];
  load_table(tab, tab_g);
  const long long nq = nb << lg_q;                        // quads in all
  const unsigned* words = reinterpret_cast<const unsigned*>(planes);   // plane k: words[k * nq + q]
  float4* out4 = reinterpret_cast<float4*>(out);
  constexpr int T = WARPS * 32;
  const int shift = 32 - 8 * P;                           // sign-extends 8P bits

  for (long long q0 = (long long)blockIdx.x * (QUADS * T) + threadIdx.x; q0 < nq;
       q0 += (long long)gridDim.x * (QUADS * T)) {
    unsigned w[QUADS][P];
    float m[QUADS];
    int s[QUADS];
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const long long q = q0 + (long long)j * T;
      if (q < nq) {
#pragma unroll
        for (int k = 0; k < P; ++k) w[j][k] = words[k * nq + q];
        m[j] = mu[q >> lg_q];
        s[j] = (int)sexp[q >> lg_q];
      }
    }
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const long long q = q0 + (long long)j * T;
      if (q >= nq) break;
      const double scale = (double)scale_of(-(float)s[j], tab);
      const float fm = flush(m[j]);
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned uq = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) uq |= ((w[j][k] >> (8 * i)) & 0xFFu) << (8 * k);
        y[i] = dequantize((int)(uq << shift) >> shift, scale, m[j], fm);
      }
      out4[q] = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// scalar route: a warp per block, any bs and alignment
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(WARPS * 32)
planes_encode_scalar_kernel(const float* __restrict__ x, long long nb, int bs, int P,
                            const float* __restrict__ tab, float* __restrict__ mu_out,
                            int* __restrict__ sexp_out, uint8_t* __restrict__ planes) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long plane_stride = nb * (long long)bs;
  const int nbits = 8 * P;
  const float lim = (float)(1 << (nbits - 1));

  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const float* xb = x + blk * bs;
    float mn = __int_as_float(0x7F800000), mx = -mn;
    int first_nan = INT_MAX;
    for (int i = lane; i < bs; i += 32) {
      const float v = xb[i];
      if (v != v && first_nan == INT_MAX) first_nan = i;
      const float f = flush(v);
      mn = xla_min(mn, f);
      mx = xla_max(mx, f);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = xla_min(mn, __shfl_xor_sync(FULL, mn, o));
      mx = xla_max(mx, __shfl_xor_sync(FULL, mx, o));
      first_nan = min(first_nan, __shfl_xor_sync(FULL, first_nan, o));
    }
    float mu = mul_ftz(0.5f, (double)add_ftz(mn, mx));
    if (first_nan != INT_MAX) {
      mu = __uint_as_float(__float_as_uint(xb[first_nan]) | QUIET);
    } else if (mu != mu) {
      mu = __uint_as_float(DEFAULT_NAN);                  // inf - inf
    }
    const int sexp = block_sexp(mn, mx, mu, nbits);
    const double scale = (double)scale_of((float)sexp, tab);
    if (lane == 0) {
      mu_out[blk] = mu;
      sexp_out[blk] = sexp;
    }
    uint8_t* pb = planes + blk * bs;
    for (int i = lane; i < bs; i += 32) {
      const unsigned uq = quantize(flush(xb[i]), mu, scale, lim);
      for (int k = 0; k < P; ++k) {
        pb[k * plane_stride + i] = (uint8_t)(uq >> (8 * k));
      }
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
planes_decode_scalar_kernel(const float* __restrict__ mu, const S* __restrict__ sexp,
                            const uint8_t* __restrict__ planes, long long nb, int bs, int P,
                            const float* __restrict__ tab, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long n = nb * (long long)bs;
  const int nbits = 8 * P;

  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const float m = mu[blk];
    const double scale = (double)scale_of(-(float)(int)sexp[blk], tab);
    const float fm = flush(m);
    const long long base = blk * bs;
    for (int i = lane; i < bs; i += 32) {
      const long long idx = base + i;
      unsigned uq = 0;
      for (int k = 0; k < P; ++k) {
        uq |= (unsigned)planes[k * n + idx] << (8 * k);
      }
      const int qi = uq >= (1u << (nbits - 1)) ? (int)uq - (1 << nbits) : (int)uq;
      out[idx] = dequantize(qi, scale, m, fm);
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

int grid_for(long long work, int per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

int sm_count() {
  static int counts[64];                      // per device, filled at first use
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    counts[dev] = 0;
  }
  return counts[dev] > 0 ? counts[dev] : 1;
}

// thread blocks for `work` units of `per_block` each, at most as many as the
// card holds at once (resident blocks of `Kernel` x SMs): a persistent grid.
// The occupancy query runs once per kernel.
template <auto Kernel>
int resident_grid(long long work, int per_block) {
  static int per_sm = 0;
  if (!per_sm && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, WARPS * 32, 0)
                  != cudaSuccess || per_sm < 1)) {
    per_sm = 1;
  }
  const long long want = (work + per_block - 1) / per_block;
  const long long cap = (long long)sm_count() * per_sm;
  return (int)(want < cap ? want : cap);
}

int log2_exact(long long v) {                 // log2 of a power of two, else -1
  if (v < 1 || (v & (v - 1))) return -1;
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

template <int V, int P>
int launch_encode_vector(const float* x, long long nb, int bs, const float* tab, float* mu,
                         int* sexp, uint8_t* planes, cudaStream_t stream) {
  const int span = bs < WIDE ? bs : WIDE;                 // values of a group's chunk
  const int lg_g = log2_exact(span / V);
  const int chunks = bs / span;
  const long long per_warp = 32 >> lg_g;
  const long long ntiles = (nb + per_warp - 1) / per_warp;
  constexpr auto kernel = planes_encode_vector_kernel<V, P>;
  kernel<<<resident_grid<kernel>(ntiles, WARPS), WARPS * 32, 0, stream>>>(
      x, nb, lg_g, chunks, tab, mu, sexp, planes);
  return (int)cudaGetLastError();
}

template <int V>
int encode_vector_p(int P, const float* x, long long nb, int bs, const float* tab, float* mu,
                    int* sexp, uint8_t* planes, cudaStream_t stream) {
  switch (P) {
    case 1: return launch_encode_vector<V, 1>(x, nb, bs, tab, mu, sexp, planes, stream);
    case 2: return launch_encode_vector<V, 2>(x, nb, bs, tab, mu, sexp, planes, stream);
    default: return launch_encode_vector<V, 3>(x, nb, bs, tab, mu, sexp, planes, stream);
  }
}

template <int P, typename S>
int launch_decode_vector(const float* mu, const void* sexp, const uint8_t* planes,
                         long long nb, int bs, const float* tab, float* out,
                         cudaStream_t stream) {
  const int lg_q = log2_exact(bs / 4);
  constexpr auto kernel = planes_decode_vector_kernel<P, S>;
  kernel<<<resident_grid<kernel>(nb << lg_q, QUADS * WARPS * 32), WARPS * 32, 0, stream>>>(
      mu, static_cast<const S*>(sexp), planes, nb, lg_q, tab, out);
  return (int)cudaGetLastError();
}

template <typename S>
int decode_vector_p(int P, const float* mu, const void* sexp, const uint8_t* planes,
                    long long nb, int bs, const float* tab, float* out, cudaStream_t stream) {
  switch (P) {
    case 1: return launch_decode_vector<1, S>(mu, sexp, planes, nb, bs, tab, out, stream);
    case 2: return launch_decode_vector<2, S>(mu, sexp, planes, nb, bs, tab, out, stream);
    default: return launch_decode_vector<3, S>(mu, sexp, planes, nb, bs, tab, out, stream);
  }
}

// the vector route's shape and alignment rule (kernels/planes.py `route`)
bool vector_fits(int bs, const void* values, const void* planes) {
  const int v = bs < 16 ? bs : 16;
  return bs >= 4 && log2_exact(bs) >= 0 && (uintptr_t)values % 16 == 0 &&
         (uintptr_t)planes % v == 0;
}

}  // namespace
}  // namespace szx

// Encodes nb blocks of bs floats (x, row-major) into mu (nb,), sexp (nb,)
// int32 and planes (P, nb, bs).  `tab` is the 253-entry scale table on the
// device.  Returns cudaGetLastError() after the launch (0 = launched), or -1
// for P outside 1..3, bs < 1, or (vector route) a shape or alignment the
// route does not take.  Launches on `stream`, never synchronizes, allocates
// nothing.
extern "C" int szx_planes_encode_vector(const float* x, long long nb, int bs, int P,
                                        const float* tab, float* mu, int* sexp,
                                        uint8_t* planes, void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || !vector_fits(bs, x, planes)) return -1;
  if (nb <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bs) {
    case 4: return encode_vector_p<4>(P, x, nb, bs, tab, mu, sexp, planes, s);
    case 8: return encode_vector_p<8>(P, x, nb, bs, tab, mu, sexp, planes, s);
    default: return encode_vector_p<16>(P, x, nb, bs, tab, mu, sexp, planes, s);
  }
}

extern "C" int szx_planes_encode_scalar(const float* x, long long nb, int bs, int P,
                                        const float* tab, float* mu, int* sexp,
                                        uint8_t* planes, void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || bs < 1) return -1;
  if (nb <= 0) return 0;
  planes_encode_scalar_kernel<<<grid_for(nb, WARPS), WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, nb, bs, P, tab, mu, sexp, planes);
  return (int)cudaGetLastError();
}

// Decodes planes (P, nb, bs) with mu (nb,) and sexp (nb,) of `sexp_bytes`
// bytes a value (1, 2 or 4: int8, int16, int32) into out (nb * bs floats).
// Same return and launch contract as the encode; -1 also for another sexp
// width.
extern "C" int szx_planes_decode_vector(const float* mu, const void* sexp, int sexp_bytes,
                                        const uint8_t* planes, long long nb, int bs, int P,
                                        const float* tab, float* out, void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || !vector_fits(bs, out, planes)) return -1;
  if (nb <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (sexp_bytes) {
    case 1: return decode_vector_p<int8_t>(P, mu, sexp, planes, nb, bs, tab, out, s);
    case 2: return decode_vector_p<int16_t>(P, mu, sexp, planes, nb, bs, tab, out, s);
    case 4: return decode_vector_p<int32_t>(P, mu, sexp, planes, nb, bs, tab, out, s);
    default: return -1;
  }
}

extern "C" int szx_planes_decode_scalar(const float* mu, const void* sexp, int sexp_bytes,
                                        const uint8_t* planes, long long nb, int bs, int P,
                                        const float* tab, float* out, void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || bs < 1) return -1;
  if (nb <= 0) return 0;
  const int grid = grid_for(nb, WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (sexp_bytes) {
    case 1:
      planes_decode_scalar_kernel<int8_t><<<grid, WARPS * 32, 0, s>>>(
          mu, static_cast<const int8_t*>(sexp), planes, nb, bs, P, tab, out);
      break;
    case 2:
      planes_decode_scalar_kernel<int16_t><<<grid, WARPS * 32, 0, s>>>(
          mu, static_cast<const int16_t*>(sexp), planes, nb, bs, P, tab, out);
      break;
    case 4:
      planes_decode_scalar_kernel<int32_t><<<grid, WARPS * 32, 0, s>>>(
          mu, static_cast<const int32_t*>(sexp), planes, nb, bs, P, tab, out);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
