// Per-dtype geometry shared by the SZx encode and decode kernels.
//
// Storage type S is what the stream holds (float, double, __half,
// __nv_bfloat16); C is the compute type the block statistics run in (float
// for words of up to 4 bytes, double for double); U is the unsigned storage
// word; CU the unsigned compute word.  LEAD is the XOR-lead elision cap:
// the 2-bit L code tops out at 3, a 2-byte word at its own 2 planes.
// quiet(b) is the bits numpy gives NaN b after a trip through the compute
// type and arithmetic: the quiet bit set, payload kept (for bfloat16,
// ml_dtypes' quiet NaN of the same sign).  The card's own arithmetic would
// return its canonical NaN instead.  Mirrors repro_torch/kernels/specs.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace szx {

constexpr unsigned FULL = 0xffffffffu;

template <typename S>
struct Traits;

template <>
struct Traits<float> {
  using C = float;
  using U = uint32_t;
  using CU = uint32_t;
  static constexpr int CODE = 0, W = 4, LEAD = 3, EXP_BITS = 8, MANT_BITS = 23;
  static constexpr int C_MANT = 23, C_EXP_MASK = 0xFF, C_BIAS = 127;
  static constexpr bool GUARD = false;
  __device__ static C widen(float s) { return s; }
  __device__ static float narrow(C c) { return c; }
  __device__ static U bits(float s) { return __float_as_uint(s); }
  __device__ static float from_bits(U u) { return __uint_as_float(u); }
  __device__ static CU cbits(C c) { return __float_as_uint(c); }
  __device__ static C from_cbits(CU u) { return __uint_as_float(u); }
  __device__ static U quiet(U b) { return b | 0x00400000u; }
};

template <>
struct Traits<double> {
  using C = double;
  using U = uint64_t;
  using CU = uint64_t;
  static constexpr int CODE = 1, W = 8, LEAD = 3, EXP_BITS = 11, MANT_BITS = 52;
  static constexpr int C_MANT = 52, C_EXP_MASK = 0x7FF, C_BIAS = 1023;
  static constexpr bool GUARD = false;
  __device__ static C widen(double s) { return s; }
  __device__ static double narrow(C c) { return c; }
  __device__ static U bits(double s) { return (U)__double_as_longlong(s); }
  __device__ static double from_bits(U u) { return __longlong_as_double((long long)u); }
  __device__ static CU cbits(C c) { return (CU)__double_as_longlong(c); }
  __device__ static C from_cbits(CU u) { return __longlong_as_double((long long)u); }
  __device__ static U quiet(U b) { return b | (1ull << 51); }
};

template <>
struct Traits<__half> {
  using C = float;
  using U = uint16_t;
  using CU = uint32_t;
  static constexpr int CODE = 2, W = 2, LEAD = 2, EXP_BITS = 5, MANT_BITS = 10;
  static constexpr int C_MANT = 23, C_EXP_MASK = 0xFF, C_BIAS = 127;
  static constexpr bool GUARD = true;
  __device__ static C widen(__half s) { return __half2float(s); }
  // round to nearest, ties to even: what numpy's float16 cast does
  __device__ static __half narrow(C c) { return __float2half_rn(c); }
  __device__ static U bits(__half s) { return __half_as_ushort(s); }
  __device__ static __half from_bits(U u) { return __ushort_as_half(u); }
  __device__ static CU cbits(C c) { return __float_as_uint(c); }
  __device__ static C from_cbits(CU u) { return __uint_as_float(u); }
  __device__ static U quiet(U b) { return (U)(b | 0x0200u); }
};

template <>
struct Traits<__nv_bfloat16> {
  using C = float;
  using U = uint16_t;
  using CU = uint32_t;
  static constexpr int CODE = 3, W = 2, LEAD = 2, EXP_BITS = 8, MANT_BITS = 7;
  static constexpr int C_MANT = 23, C_EXP_MASK = 0xFF, C_BIAS = 127;
  static constexpr bool GUARD = true;
  __device__ static C widen(__nv_bfloat16 s) { return __bfloat162float(s); }
  // round to nearest, ties to even: what ml_dtypes' bfloat16 cast does
  __device__ static __nv_bfloat16 narrow(C c) { return __float2bfloat16_rn(c); }
  __device__ static U bits(__nv_bfloat16 s) { return __bfloat16_as_ushort(s); }
  __device__ static __nv_bfloat16 from_bits(U u) { return __ushort_as_bfloat16(u); }
  __device__ static CU cbits(C c) { return __float_as_uint(c); }
  __device__ static C from_cbits(CU u) { return __uint_as_float(u); }
  __device__ static U quiet(U b) { return (U)((b & 0x8000u) | 0x7FC0u); }
};

// Word shuffles: 16/32-bit words travel as one 32-bit lane value.
template <typename U>
__device__ __forceinline__ U shfl_up(U v, int d) {
  if constexpr (sizeof(U) == 8) {
    return (U)__shfl_up_sync(FULL, (unsigned long long)v, d);
  } else {
    return (U)__shfl_up_sync(FULL, (unsigned)v, d);
  }
}

template <typename U>
__device__ __forceinline__ U shfl_idx(U v, int src) {
  if constexpr (sizeof(U) == 8) {
    return (U)__shfl_sync(FULL, (unsigned long long)v, src);
  } else {
    return (U)__shfl_sync(FULL, (unsigned)v, src);
  }
}

}  // namespace szx
