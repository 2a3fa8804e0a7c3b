// Chunked gradient codecs for Hopper (sm_90a): the MinMaxUInt8 codec, the
// absmax reduction of the int8/fp8 codecs and the 1-bit sign codec.
//
// Replaces the Pallas TPU kernels of bagua_tpu/compression/pallas_codec.py:
//   bagua_minmax_compress   <- compress_chunked_pallas   (K1: pallas_call :176
//                              fused, :198 + :213 tiled; _compress_kernel :82,
//                              _minmax_tile_kernel :102, _quantize_tile_kernel :134)
//   bagua_minmax_decompress <- decompress_chunked_pallas (K2: pallas_call :546,
//                              _decompress_kernel :147)
//   bagua_absmax            <- absmax_chunked_pallas     (K3: pallas_call :295
//                              fused, :311 tiled; _absmax_kernel :235,
//                              _absmax_tile_kernel :249)
//   bagua_sign_compress     <- sign_compress_chunked_pallas (K4: pallas_call
//                              :424 fused, :452 tiled; _sign_pack_kernel :347,
//                              _sumabs_tile_kernel :368, _jnp_sign_pack :394)
//   bagua_sign_decompress   <- sign_decompress_chunked_pallas (K5: pallas_call
//                              :496, _sign_unpack_kernel :471)
// (K4 and K5 are described with their kernels below.)
//
// Layout: x is [n, m] row-major (n chunks of m elements, f32 or bf16), m any
// positive count, so a chunk need not start on a 16-byte boundary.
//   compress:   mn[c], mx[c] = min, max of chunk c (f32);
//               scale = 255 / (mx - mn + 1e-7), upper = rint(mx * scale),
//               lower = upper - 255;
//               payload[c, i] = u8(clip(rint(x * scale), lower, upper) - lower)
//   decompress: out[c, i] = (payload[c, i] + lower) / scale   (f32)
//   absmax:     out[c] = max |x| over chunk c (f32)
// The u8 conversion saturates (NaN -> 0, below 0 -> 0, above 255 -> 255), as
// XLA's f32 -> u8 convert does in the jnp codec (minmax_uint8.py:55).  It
// matters for a constant chunk: there mx * scale is about 2.55e9, where an
// f32 ulp is 256, so lower = upper - 256 and a level lands on 256.
//
// What bounds them on an H100: each element is read once and written once
// (K1 4 + 1 bytes, K2 1 + 4, K3 4), with a few flops per element, far below
// the card's flop-per-byte ridge: all three are bound by memory bandwidth.
//
// Design.  The TPU runs one chunk per grid step and, past VMEM's ceiling,
// carries min/max across the sequential steps of a tiled grid.  Here blocks
// run in parallel and in no order, and at world size 2 a bucket has only two
// chunks, so one block per chunk would use 2 of 132 SMs.  The grid is
// (tile, chunk): pass 1 writes each tile's partial min/max (absmax) into
// scratch that the wrapper allocates; in pass 2 every quantize block first
// reduces its own chunk's partials (at most 1024 pairs, from L2), then
// quantizes its tile.  Deterministic, no atomics.  K3 is pass 1 plus a small
// reduce over the partials.  Loads are scalar and coalesced, four in flight
// per thread, which handles a ragged chunk start without a special case.
//
// Exactness: every product, sum and quotient uses the IEEE-rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn: nothing is contracted into an
// FMA and division is not approximated), rounding is rintf (half to even, as
// jnp.round and torch.round), so the payload equals the plain PyTorch
// version's and the jnp codec's byte for byte.  fminf/fmaxf drop a NaN; the
// reductions here keep it (as jnp.min/max and torch.amin/amax do), so a NaN
// chunk gives a NaN sidecar and a NaN decode.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr float kLevels = 255.0f;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }

// min / max that keep a NaN from either side
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? nan_max(a, b) : nan_min(a, b);
}

// Reduce v over the block; every thread gets the result.  `scratch` holds
// kWarps floats.  A fixed tree, so the result does not depend on timing.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = combine<kMax>(v, scratch[w]);
  return v;
}

// Pass 1: partial min and max (kAbs: max |x|) of one tile of one chunk.
// grid (tiles, n); partials [n, tiles, 2] (min, max) or [n, tiles] (absmax).
template <typename T, bool kAbs>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const T* __restrict__ x, long long m, long long tile, int tiles,
                float* __restrict__ partials) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.y, t = blockIdx.x;
  const T* xc = x + (long long)c * m;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < m ? lo + tile : m;
  float vmin = inf(), vmax = -inf();
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(xc + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kAbs) {
        vmax = nan_max(vmax, fabsf(v[u]));
      } else {
        vmin = nan_min(vmin, v[u]);
        vmax = nan_max(vmax, v[u]);
      }
    }
  }
  for (; i < hi; i += kThreads) {
    const float v = load(xc + i);
    if (kAbs) {
      vmax = nan_max(vmax, fabsf(v));
    } else {
      vmin = nan_min(vmin, v);
      vmax = nan_max(vmax, v);
    }
  }
  vmax = block_reduce<true>(vmax, scratch);
  if (kAbs) {
    if (threadIdx.x == 0) partials[(long long)c * tiles + t] = vmax;
  } else {
    vmin = block_reduce<false>(vmin, scratch);
    if (threadIdx.x == 0) {
      partials[((long long)c * tiles + t) * 2] = vmin;
      partials[((long long)c * tiles + t) * 2 + 1] = vmax;
    }
  }
}

// The chunk's min and max from its tiles' partials, in every thread.
__device__ void chunk_minmax(const float* __restrict__ partials, int c, int tiles,
                             float* scratch, float& mn, float& mx) {
  float vmin = inf(), vmax = -inf();
  const float* p = partials + (long long)c * tiles * 2;
  for (int j = threadIdx.x; j < tiles; j += kThreads) {
    vmin = nan_min(vmin, p[2 * j]);
    vmax = nan_max(vmax, p[2 * j + 1]);
  }
  mn = block_reduce<false>(vmin, scratch);
  mx = block_reduce<true>(vmax, scratch);
}

struct Grid {
  float scale, lower, upper;
};

// scale = 255 / (mx - mn + eps), upper = rint(mx * scale), lower = upper - 255
__device__ __forceinline__ Grid make_grid(float mn, float mx) {
  Grid g;
  g.scale = __fdiv_rn(kLevels, __fadd_rn(__fsub_rn(mx, mn), kEps));
  g.upper = rintf(__fmul_rn(mx, g.scale));
  g.lower = __fsub_rn(g.upper, kLevels);
  return g;
}

// jnp.clip (NaN-propagating) then the saturating u8 convert
__device__ __forceinline__ uint8_t quantize(float v, const Grid& g) {
  float level = rintf(__fmul_rn(v, g.scale));
  level = nan_min(nan_max(level, g.lower), g.upper);
  const float d = __fsub_rn(level, g.lower);
  if (!(d > 0.0f)) return 0;  // NaN and below zero
  if (d >= kLevels) return 255;
  return (uint8_t)(unsigned)d;
}

// Pass 2: reduce the chunk's partials, write its sidecar (tile 0), quantize
// this tile.  grid (tiles, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long m, long long tile, int tiles,
                const float* __restrict__ partials, float* __restrict__ mn_out,
                float* __restrict__ mx_out, uint8_t* __restrict__ payload) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.y, t = blockIdx.x;
  float mn, mx;
  chunk_minmax(partials, c, tiles, scratch, mn, mx);
  if (t == 0 && threadIdx.x == 0) {
    mn_out[c] = mn;
    mx_out[c] = mx;
  }
  const Grid g = make_grid(mn, mx);
  const T* xc = x + (long long)c * m;
  uint8_t* pc = payload + (long long)c * m;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < m ? lo + tile : m;
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(xc + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pc[i + u * kThreads] = quantize(v[u], g);
  }
  for (; i < hi; i += kThreads) pc[i] = quantize(load(xc + i), g);
}

// out[c, i] = (payload[c, i] + lower) / scale.  grid (tiles, n).
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const float* __restrict__ mn, const float* __restrict__ mx,
                  const uint8_t* __restrict__ payload, long long m, long long tile,
                  float* __restrict__ out) {
  const int c = blockIdx.y, t = blockIdx.x;
  const Grid g = make_grid(mn[c], mx[c]);
  const uint8_t* pc = payload + (long long)c * m;
  float* oc = out + (long long)c * m;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < m ? lo + tile : m;
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    uint8_t p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) p[u] = pc[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      oc[i + u * kThreads] = __fdiv_rn(__fadd_rn((float)p[u], g.lower), g.scale);
  }
  for (; i < hi; i += kThreads) oc[i] = __fdiv_rn(__fadd_rn((float)pc[i], g.lower), g.scale);
}

// out[c] = max over the chunk's absmax partials.  grid (n).
__global__ void __launch_bounds__(kThreads)
absmax_final_kernel(const float* __restrict__ partials, int tiles, float* __restrict__ out) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.x;
  float v = -inf();
  for (int j = threadIdx.x; j < tiles; j += kThreads)
    v = nan_max(v, partials[(long long)c * tiles + j]);
  v = block_reduce<true>(v, scratch);
  if (threadIdx.x == 0) out[c] = v;
}

bool bad_shape(int n, long long m, long long tile, int tiles) {
  return n < 1 || n > 65535 || m < 1 || tile < 1 || tiles < 1 ||
         (long long)tiles != (m + tile - 1) / tile;
}

// ---- 1-bit sign codec (K4, K5) --------------------------------------------
//
// A chunk of m elements packs into B = ceil(m / 1024) * 128 bytes, bit-planar:
// bit b of byte j is x_pad[b * B + j] >= 0, where x_pad is the chunk padded
// with zeros to 8 * B elements (a pad element's bit is 1; a NaN's is 0).  The
// flat input is not padded in memory: an index >= m reads as 0 and is never
// loaded.  scale = sum |x| / m over the m real elements.
//
// Both are bound by memory bandwidth: K4 reads 4 bytes an element and writes
// 1/8, K5 reads 1/8 and writes 4.  Each thread makes (K4) or unpacks (K5) one
// byte from 8 elements at stride B, so in every plane neighbouring threads
// touch neighbouring addresses.  The grid is (tile, chunk) over the payload's
// bytes, as for K1/K3: pass 1 packs its tile's bytes (the pack does not need
// the scale) and writes the tile's partial sum of |x|; pass 2, one block a
// chunk, adds the partials in a fixed order and divides with __fdiv_rn.  No
// atomics: the scale does not depend on timing.

// Sum over the block in a fixed tree; every thread gets the result.  The xor
// butterfly adds the same two values in every lane of a pair, so all lanes
// agree.  `scratch` holds kWarps floats.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, scratch[w]);
  return v;
}

// Pass 1: pack bytes [t * tile, min((t + 1) * tile, B)) of chunk c and write
// the partial sum of |x| over their elements.  grid (tiles, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const T* __restrict__ x, long long m, long long B, long long tile, int tiles,
                 float* __restrict__ partials, uint8_t* __restrict__ payload) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.y, t = blockIdx.x;
  const T* xc = x + (long long)c * m;
  uint8_t* pc = payload + (long long)c * B;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < B ? lo + tile : B;
  float acc = 0.0f;
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    float v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const long long i = b * B + j;
      v[b] = i < m ? load(xc + i) : 0.0f;
    }
    unsigned byte = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      byte |= (v[b] >= 0.0f ? 1u : 0u) << b;
      acc = __fadd_rn(acc, fabsf(v[b]));
    }
    pc[j] = (uint8_t)byte;
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[(long long)c * tiles + t] = acc;
}

// Pass 2: scale[c] = (sum of chunk c's partials) / m.  grid (n).
__global__ void __launch_bounds__(kThreads)
sign_scale_kernel(const float* __restrict__ partials, int tiles, long long m,
                  float* __restrict__ scale) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.x;
  float v = 0.0f;
  for (int j = threadIdx.x; j < tiles; j += kThreads)
    v = __fadd_rn(v, partials[(long long)c * tiles + j]);
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) scale[c] = __fdiv_rn(v, (float)m);
}

// out[c, b * B + j] = (bit b of payload[c, j] ? 1 : -1) * scale[c], the padded
// [n, 8 * B] block.  A NaN or Inf scale makes the whole chunk non-finite.
// grid (tiles, n).
__global__ void __launch_bounds__(kThreads)
sign_unpack_kernel(const float* __restrict__ scale, const uint8_t* __restrict__ payload,
                   long long B, long long tile, float* __restrict__ out) {
  const int c = blockIdx.y, t = blockIdx.x;
  const float s = scale[c];
  const uint8_t* pc = payload + (long long)c * B;
  float* oc = out + (long long)c * 8 * B;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < B ? lo + tile : B;
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const unsigned byte = pc[j];
#pragma unroll
    for (int b = 0; b < 8; ++b)
      oc[b * B + j] = __fmul_rn(((byte >> b) & 1u) ? 1.0f : -1.0f, s);
  }
}

bool bad_sign_shape(int n, long long m, long long B, long long tile, int tiles) {
  return n < 1 || n > 65535 || m < 1 || B != (m + 1023) / 1024 * 128 || tile < 1 ||
         tiles < 1 || (long long)tiles != (B + tile - 1) / tile;
}

}  // namespace

extern "C" {

// x [n, m] f32 (is_bf16 0) or bf16 (1); partials [n, tiles, 2] f32 scratch;
// mn, mx [n] f32; payload [n, m] u8.  tiles = ceil(m / tile).
int bagua_minmax_compress(const void* x, int is_bf16, int n, long long m, long long tile,
                          int tiles, void* partials, void* mn, void* mx, void* payload,
                          void* stream) {
  if (bad_shape(n, m, tile, tiles)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    partials_kernel<bf16, false><<<grid, kThreads, 0, s>>>((const bf16*)x, m, tile, tiles,
                                                           (float*)partials);
    quantize_kernel<bf16><<<grid, kThreads, 0, s>>>((const bf16*)x, m, tile, tiles,
                                                    (const float*)partials, (float*)mn,
                                                    (float*)mx, (uint8_t*)payload);
  } else {
    partials_kernel<float, false><<<grid, kThreads, 0, s>>>((const float*)x, m, tile, tiles,
                                                            (float*)partials);
    quantize_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, m, tile, tiles,
                                                     (const float*)partials, (float*)mn,
                                                     (float*)mx, (uint8_t*)payload);
  }
  return (int)cudaGetLastError();
}

// mn, mx [n] f32; payload [n, m] u8; out [n, m] f32.
int bagua_minmax_decompress(const void* mn, const void* mx, const void* payload, int n,
                            long long m, long long tile, int tiles, void* out,
                            void* stream) {
  if (bad_shape(n, m, tile, tiles)) return (int)cudaErrorInvalidValue;
  decompress_kernel<<<dim3(tiles, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mn, (const float*)mx, (const uint8_t*)payload, m, tile, (float*)out);
  return (int)cudaGetLastError();
}

// x [n, m] f32 or bf16; partials [n, tiles] f32 scratch; out [n] f32.
int bagua_absmax(const void* x, int is_bf16, int n, long long m, long long tile, int tiles,
                 void* partials, void* out, void* stream) {
  if (bad_shape(n, m, tile, tiles)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    partials_kernel<bf16, true><<<grid, kThreads, 0, s>>>((const bf16*)x, m, tile, tiles,
                                                          (float*)partials);
  else
    partials_kernel<float, true><<<grid, kThreads, 0, s>>>((const float*)x, m, tile, tiles,
                                                           (float*)partials);
  absmax_final_kernel<<<n, kThreads, 0, s>>>((const float*)partials, tiles, (float*)out);
  return (int)cudaGetLastError();
}

// x [n, m] f32 or bf16; partials [n, tiles] f32 scratch; scale [n] f32;
// payload [n, B] u8 with B = ceil(m / 1024) * 128; tiles = ceil(B / tile).
int bagua_sign_compress(const void* x, int is_bf16, int n, long long m, long long B,
                        long long tile, int tiles, void* partials, void* scale, void* payload,
                        void* stream) {
  if (bad_sign_shape(n, m, B, tile, tiles)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    sign_pack_kernel<bf16><<<grid, kThreads, 0, s>>>((const bf16*)x, m, B, tile, tiles,
                                                     (float*)partials, (uint8_t*)payload);
  else
    sign_pack_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, m, B, tile, tiles,
                                                      (float*)partials, (uint8_t*)payload);
  sign_scale_kernel<<<n, kThreads, 0, s>>>((const float*)partials, tiles, m, (float*)scale);
  return (int)cudaGetLastError();
}

// scale [n] f32; payload [n, B] u8; out [n, 8 * B] f32.
int bagua_sign_decompress(const void* scale, const void* payload, int n, long long B,
                          long long tile, int tiles, void* out, void* stream) {
  if (n < 1 || n > 65535 || B < 1 || B % 128 || tile < 1 || tiles < 1 ||
      (long long)tiles != (B + tile - 1) / tile)
    return (int)cudaErrorInvalidValue;
  sign_unpack_kernel<<<dim3(tiles, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)scale, (const uint8_t*)payload, B, tile, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
