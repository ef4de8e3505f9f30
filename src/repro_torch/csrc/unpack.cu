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
// What bounds it on this card: bytes.  It needs each stored plane byte (a
// live plane j of a value whose L <= j; the elided ones are zeros it fills
// from earlier values), L and the block metadata once, and writes each
// value once.  Two routes, chosen by the caller from the shape alone
// (kernels/unpack.py::route); each entry point refuses a shape its route
// does not take.
//
//   vector (bs % 4 == 0, planes and L on 4 bytes, out on 4 values): a lane
//     owns four consecutive values of one block, as decode.cu's gather
//     does, so a plane is one 32-bit load a lane and L one more, and the
//     four composed values leave as one store (16 bytes for float, two for
//     double, 8 for half and bfloat16).  A warp walks a run of whole blocks
//     in windows of 128 values, NT windows a round: the round first loads
//     every lane's block metadata and L word, then its live plane words,
//     and only then propagates and composes, so each warp keeps NT windows
//     of loads in flight; a lane skips the word of a plane that all four
//     of its values elide.  Elided leading bytes take the byte of the
//     nearest preceding value that stored the plane, as the plain version's
//     fused-key (idx*256 + byte) cummax gives it, computed on the lane's
//     32-bit plane word: a SIMD compare of the L word, a fill in two shift
//     steps, then one ballot and one shuffle across the block's lanes (and
//     a carry from window to window where a block spans windows).  A
//     window whose L words are all zero (one ballot) skips that, since
//     every live value then stores its own byte; `unpack_dense` never
//     propagates.  The plane words become the values' words by byte
//     permutes.  Working on bytes rather than keys matters: with a key
//     max-scan a plane (szx_traits.cuh's max_scan, as the scalar route
//     runs it) the vector route takes 1.3x as long at a 64 MiB frame, 49 %
//     of its byte bound against 64 %, held by instructions (PERF.md).
//   scalar (any other shape: bs 1, 3, 97, views off alignment): one warp
//     per block walking it in 32-value tiles, a byte load a plane a lane,
//     the key scan carried across tiles.
//
// Offsets are int64.
#include "szx_traits.cuh"

namespace szx {
namespace {

constexpr int WARPS = 8;
constexpr int NT = 2;           // vector route: windows of 128 values a round

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

// The four values' shifted words from their plane words v[j] (byte k of
// v[j] is plane j of value k, plane 0 the most significant byte): a byte
// transpose by byte permutes.
template <int W, typename U>
__device__ __forceinline__ void assemble(const uint32_t (&v)[W], U (&ws)[4]) {
  if constexpr (W == 2) {
    const uint32_t a = __byte_perm(v[1], v[0], 0x5140), b = __byte_perm(v[1], v[0], 0x7362);
    ws[0] = (U)a, ws[1] = (U)(a >> 16), ws[2] = (U)b, ws[3] = (U)(b >> 16);
  } else if constexpr (W == 4) {
    transpose_bytes4(v[3], v[2], v[1], v[0], ws[0], ws[1], ws[2], ws[3]);
  } else {
    uint32_t hi[4], lo[4];
    transpose_bytes4(v[3], v[2], v[1], v[0], hi[0], hi[1], hi[2], hi[3]);
    transpose_bytes4(v[7], v[6], v[5], v[4], lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) ws[k] = ((U)hi[k] << 32) | lo[k];
  }
}

// The vector route.  A run is `per_run` whole blocks (nv values, a multiple
// of 4); lane l of window u of a round holds values v0 + 128 u + 4 l ..+3.
// Propagation of plane j works on the lane's plane word b (byte k = value
// k) as the plain version's key cummax does: a value stores its byte where
// L <= j (one SIMD compare of the L word), the lane fills each elided byte
// from the nearest stored one below it (two shift steps), and the bytes
// with none below in the lane take `in`: the last stored byte of the
// nearest lane below in the same block that stored any (one ballot, one
// shuffle), or the block's last stored byte of the earlier windows
// (`carry`, kept only where a block can span windows), or 0.
template <typename S, bool DENSE>
__global__ void __launch_bounds__(WARPS * 32, 4)
unpack_vector_kernel(const uint8_t* __restrict__ planes, const S* __restrict__ mu,
                     const int* __restrict__ shift, const int* __restrict__ nbytes,
                     const uint8_t* __restrict__ L, long long nb, int bs, int per_run,
                     S* __restrict__ out) {
  using T = Traits<S>;
  using U = typename T::U;
  struct alignas(4 * sizeof(S)) Vals { S v[4]; };
  constexpr int W = T::W;
  constexpr int LEAD = T::LEAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below_me = (1u << lane) - 1u;
  const bool spans = 128 % bs != 0;          // a block can continue into the next window
  const long long nruns = (nb + per_run - 1) / per_run;

  for (long long run_i = (long long)blockIdx.x * WARPS + warp; run_i < nruns;
       run_i += (long long)gridDim.x * WARPS) {
    const long long b0 = run_i * per_run;
    const int nv = (int)(nb - b0 < per_run ? nb - b0 : per_run) * bs;
    int carry[LEAD];                     // last stored byte of the block so far, or -1
#pragma unroll
    for (int j = 0; j < LEAD; ++j) carry[j] = -1;
    for (int v0 = 0; v0 < nv; v0 += 128 * NT) {
      // round 1: each lane's block, its metadata and its L word
      int ii[NT], nbt[NT], sh[NT];
      long long at[NT];                  // offset of the lane's first value
      bool valid[NT];
      S m[NT];
      uint32_t lw[NT];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int v = v0 + (u * 32 + lane) * 4;
        valid[u] = v < nv;
        const int vc = valid[u] ? v : nv - 4;
        const int r = per_run == 1 ? 0 : vc / bs;
        ii[u] = vc - r * bs;
        const long long b = b0 + r;
        at[u] = b * bs + ii[u];
        nbt[u] = valid[u] ? nbytes[b] : 0;
        sh[u] = shift[b];
        m[u] = mu[b];
        lw[u] = DENSE || !valid[u] ? 0u : *reinterpret_cast<const uint32_t*>(L + at[u]);
      }
      // round 2: the plane words that hold a stored byte (a plane below the
      // lead cap whose four values all elide it is never read: its bytes
      // come from earlier values)
      uint32_t pw[NT][W];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const uint8_t* pb = planes + (at[u] - ii[u]) * W + ii[u];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const bool stored = DENSE || j >= LEAD || __vcmpleu4(lw[u], 0x01010101u * j) != 0u;
          pw[u][j] = j < nbt[u] && stored
                         ? *reinterpret_cast<const uint32_t*>(pb + (long long)j * bs) : 0u;
        }
      }

#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int i0 = ii[u];
        const bool cont = i0 / 4 > lane;   // the block began in an earlier window
        // lanes below this one in its block (all of them when it began earlier)
        const unsigned seg_below = below_me & (cont ? FULL : ~((1u << (lane - i0 / 4)) - 1u));
        const bool scan = !DENSE && __ballot_sync(FULL, lw[u] != 0u) != 0u;
#pragma unroll
        for (int j = 0; j < LEAD; ++j) {
          if (DENSE) break;
          uint32_t b = pw[u][j];
          if (scan) {                      // elided bytes come from earlier values
            const uint32_t M = j < nbt[u] ? __vcmpleu4(lw[u], 0x01010101u * j) : 0u;
            uint32_t have = M;
            b &= M;
            b |= (b << 8) & ~have;
            have |= have << 8;
            b |= (b << 16) & ~have;
            have |= have << 16;
            const unsigned below = __ballot_sync(FULL, M != 0u) & seg_below;
            const int got = __shfl_sync(FULL, (int)(b >> 24), below ? 31 - __clz(below) : 0);
            const int in = below ? got : (cont ? carry[j] : -1);
            if (in >= 0) b |= ((uint32_t)in * 0x01010101u) & ~have;
            if (spans) carry[j] = __shfl_sync(FULL, M ? (int)(b >> 24) : in, 31);
          } else if (spans) {              // every live value stores its own byte
            const int last = j < nbt[u] ? (int)(b >> 24) : -1;
            carry[j] = __shfl_sync(FULL, cont && last < 0 ? carry[j] : last, 31);
          }
          pw[u][j] = b;
        }
        if (valid[u]) {
          U ws[4];
          assemble<W>(pw[u], ws);
          Vals o;
#pragma unroll
          for (int k = 0; k < 4; ++k) o.v[k] = compose<S>(ws[k], sh[u], m[u], nbt[u]);
          *reinterpret_cast<Vals*>(out + at[u]) = o;
        }
      }
    }
  }
}

int grid_for(long long warps) {
  const long long blocks = (warps + WARPS - 1) / WARPS;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

template <typename S>
int launch_scalar(const uint8_t* planes, const void* mu, const int* shift,
                  const int* nbytes, const uint8_t* L, long long nb, int bs, void* out,
                  cudaStream_t stream) {
  if (L == nullptr) {
    unpack_kernel<S, true><<<grid_for(nb), WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, (S*)out);
  } else {
    unpack_kernel<S, false><<<grid_for(nb), WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, (S*)out);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int launch_vector(const uint8_t* planes, const void* mu, const int* shift,
                  const int* nbytes, const uint8_t* L, long long nb, int bs, void* out,
                  cudaStream_t stream) {
  if ((uintptr_t)out % (4 * sizeof(S))) return -1;
  const int per_run = bs >= 128 * NT ? 1 : 128 * NT / bs;
  const int grid = grid_for((nb + per_run - 1) / per_run);
  if (L == nullptr) {
    unpack_vector_kernel<S, true><<<grid, WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, per_run, (S*)out);
  } else {
    unpack_vector_kernel<S, false><<<grid, WARPS * 32, 0, stream>>>(
        planes, (const S*)mu, shift, nbytes, L, nb, bs, per_run, (S*)out);
  }
  return (int)cudaGetLastError();
}

template <bool VECTOR>
int dispatch(int code, const uint8_t* planes, const void* mu, const int* shift,
             const int* nbytes, const uint8_t* L, long long nb, int bs, void* out,
             cudaStream_t s) {
  switch (code) {
    case 0:
      return VECTOR ? launch_vector<float>(planes, mu, shift, nbytes, L, nb, bs, out, s)
                    : launch_scalar<float>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 1:
      return VECTOR ? launch_vector<double>(planes, mu, shift, nbytes, L, nb, bs, out, s)
                    : launch_scalar<double>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 2:
      return VECTOR ? launch_vector<__half>(planes, mu, shift, nbytes, L, nb, bs, out, s)
                    : launch_scalar<__half>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    case 3:
      return VECTOR
                 ? launch_vector<__nv_bfloat16>(planes, mu, shift, nbytes, L, nb, bs, out, s)
                 : launch_scalar<__nv_bfloat16>(planes, mu, shift, nbytes, L, nb, bs, out, s);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace szx

// Decodes nb blocks of bs values from their byte planes into `out`.  L ==
// NULL runs unpack_dense (every L = 0).  Returns cudaGetLastError() after
// the launch (0 = launched, or nothing to launch), or -1 for an unknown
// dtype code or a shape the route does not take: the vector route needs
// bs a positive multiple of 4, planes and L on 4 bytes and out on four
// values.  Launches on `stream`, never synchronizes, allocates nothing.
extern "C" int szx_unpack_vector(int code, const uint8_t* planes, const void* mu,
                                 const int* shift, const int* nbytes, const uint8_t* L,
                                 long long nb, int bs, void* out, void* stream) {
  if (bs < 4 || bs % 4 || (uintptr_t)planes % 4 || (uintptr_t)L % 4) return -1;
  if (nb <= 0) return code >= 0 && code <= 3 ? 0 : -1;
  return szx::dispatch<true>(code, planes, mu, shift, nbytes, L, nb, bs, out,
                             (cudaStream_t)stream);
}

extern "C" int szx_unpack_scalar(int code, const uint8_t* planes, const void* mu,
                                 const int* shift, const int* nbytes, const uint8_t* L,
                                 long long nb, int bs, void* out, void* stream) {
  if (bs < 0) return -1;
  if (nb <= 0 || bs == 0) return code >= 0 && code <= 3 ? 0 : -1;
  return szx::dispatch<false>(code, planes, mu, shift, nbytes, L, nb, bs, out,
                              (cudaStream_t)stream);
}
