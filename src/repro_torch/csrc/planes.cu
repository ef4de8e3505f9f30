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
// What bounds it on this card: bytes.  Encode reads each value (twice: the
// second pass hits L1/L2, a block is bs * 4 bytes) and writes P bytes; decode
// reads P bytes and writes 4.  The arithmetic is a few dozen operations per
// value, two of them in double.  Encode runs one warp per SZx block
// (grid-stride over blocks, bs walked in tiles of 32, warp-shuffle min/max),
// with plane k of the (P, nb, bs) output written by consecutive lanes, so
// each plane's stores coalesce.  Decode runs the same grid of warps, a lane
// per value (mu and sexp read once per block), so it needs no division to
// find a value's block.  Indices are 64-bit throughout.
#include <float.h>
#include <limits.h>
#include <stdint.h>
#include <cuda_runtime.h>

namespace szx {
namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int SCALE_MIN = -125, SCALE_MAX = 127;
constexpr unsigned DEFAULT_NAN = 0xFFC00000u;
constexpr unsigned QUIET = 0x00400000u;
// 2^-126 - 2^-151: a product below it rounds (to 24 bits) below FLT_MIN
constexpr double TINY_PRODUCT = 0x1.ffffffp-127;

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  const double p = __dmul_rn((double)a, (double)b);       // exact
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

__global__ void __launch_bounds__(WARPS * 32)
planes_encode_kernel(const float* __restrict__ x, long long nb, int bs, int P,
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
    float mu = mul_ftz(0.5f, add_ftz(mn, mx));
    if (first_nan != INT_MAX) {
      mu = __uint_as_float(__float_as_uint(xb[first_nan]) | QUIET);
    } else if (mu != mu) {
      mu = __uint_as_float(DEFAULT_NAN);                  // inf - inf
    }
    const float radius = xla_max(add_ftz(mx, -mu), add_ftz(mu, -mn));
    const int E = (int)((__float_as_uint(radius) >> 23) & 0xFFu) - 127;
    const int sexp = (nbits - 2) - E;
    const float scale = scale_of((float)sexp, tab);
    if (lane == 0) {
      mu_out[blk] = mu;
      sexp_out[blk] = sexp;
    }
    uint8_t* pb = planes + blk * bs;
    for (int i = lane; i < bs; i += 32) {
      const float v = add_ftz(flush(xb[i]), -mu);
      float q = rintf(mul_ftz(v, scale));                 // half to even
      if (q != q) q = 0.0f;                               // before the clamp
      q = fminf(fmaxf(q, -lim), lim - 1.0f);
      const unsigned uq = (unsigned)(int)q;
      for (int k = 0; k < P; ++k) {
        pb[k * plane_stride + i] = (uint8_t)(uq >> (8 * k));
      }
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
planes_decode_kernel(const float* __restrict__ mu, const int* __restrict__ sexp,
                     const uint8_t* __restrict__ planes, long long nb, int bs, int P,
                     const float* __restrict__ tab, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long n = nb * (long long)bs;
  const int nbits = 8 * P;

  for (long long blk = warp0; blk < nb; blk += nwarps) {
    const float m = mu[blk];
    const float scale = scale_of(-(float)sexp[blk], tab);
    const long long base = blk * bs;
    for (int i = lane; i < bs; i += 32) {
      const long long idx = base + i;
      unsigned uq = 0;
      for (int k = 0; k < P; ++k) {
        uq |= (unsigned)planes[k * n + idx] << (8 * k);
      }
      const int qi = uq >= (1u << (nbits - 1)) ? (int)uq - (1 << nbits) : (int)uq;
      float y = add_ftz(mul_ftz((float)qi, scale), flush(m));
      if (m != m) {
        y = __uint_as_float(__float_as_uint(m) | QUIET);  // a NaN mu wins
      } else if (y != y) {
        y = __uint_as_float(DEFAULT_NAN);
      }
      out[idx] = y;
    }
  }
}

int grid_for(long long work, int per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace
}  // namespace szx

// Encodes nb blocks of bs floats (x, row-major) into mu (nb,), sexp (nb,)
// and planes (P, nb, bs).  `tab` is the 253-entry scale table on the device.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for
// P outside 1..3 or bs < 1.  Launches on `stream`, never synchronizes,
// allocates nothing.
extern "C" int szx_planes_encode(const float* x, long long nb, int bs, int P,
                                 const float* tab, float* mu, int* sexp,
                                 uint8_t* planes, void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || bs < 1) return -1;
  if (nb <= 0) return 0;
  planes_encode_kernel<<<grid_for(nb, WARPS), WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, nb, bs, P, tab, mu, sexp, planes);
  return (int)cudaGetLastError();
}

// Decodes planes (P, nb, bs) with mu (nb,) and sexp (nb,) int32 into out
// (nb * bs floats).  Same return and launch contract as the encode.
extern "C" int szx_planes_decode(const float* mu, const int* sexp,
                                 const uint8_t* planes, long long nb, int bs,
                                 int P, const float* tab, float* out,
                                 void* stream) {
  using namespace szx;
  if (P < 1 || P > 3 || bs < 1) return -1;
  if (nb <= 0) return 0;
  planes_decode_kernel<<<grid_for(nb, WARPS), WARPS * 32, 0, (cudaStream_t)stream>>>(
      mu, sexp, planes, nb, bs, P, tab, out);
  return (int)cudaGetLastError();
}
