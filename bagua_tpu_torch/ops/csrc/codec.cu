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
// (K1, K4 and K5 are described with their kernels below.)
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
// the card's flop-per-byte ridge: all are bound by memory bandwidth, and at
// the path's chunks (a few MiB) by the fixed cost of a launch beside it.
//
// K2 runs a (tile, chunk) grid: blocks run in parallel and in no order, and
// at world size 2 a bucket has only two chunks, so one block per chunk would
// use 2 of 132 SMs.  Its loads are scalar and coalesced, four in flight per
// thread.  K3 is one launch (described with its kernel below).
//
// Exactness: every product, sum and quotient uses the IEEE-rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn: nothing is contracted into an
// FMA and division is not approximated), rounding is rintf (half to even, as
// jnp.round and torch.round), so the payload equals the plain PyTorch
// version's and the jnp codec's byte for byte.  fminf/fmaxf drop a NaN; the
// reductions here keep it (as jnp.min/max and torch.amin/amax do), so a NaN
// chunk gives a NaN sidecar and a NaN decode.
//
// Library state.  K3 and K4 keep a ticket counter a chunk (and K3 a max word
// a chunk) in this library's device memory; every launch leaves them at zero.
// Two launches of one of them running at once (on two streams) would share
// them.  The port does launch codecs on several streams: the trainer's
// overlap scheduler runs the rings and ByteGrad's pipeline on its comm
// stream, from its comm worker thread, while the error-feedback compensation
// runs on the backward's stream, from autograd's thread.  So the wrappers
// (ops/codec.py) order every K3 and K4 launch after the last one made on
// another stream of the device, under a lock held until the launch is
// enqueued.  K1 (one cooperative grid), K2 and K5 keep no state between
// launches and may run on several streams at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

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

// min / max that keep a NaN from either side (one instruction each)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// jnp.clip (NaN-propagating) then the saturating u8 convert.  fmaxf/fminf
// drop a NaN level where jnp.clip keeps it, but the byte is the same: a NaN
// level comes from a NaN element or a NaN grid, a chunk holding a NaN has a
// NaN grid (its min is NaN), and a NaN lower makes d NaN either way.  The
// float-to-integer convert gives 0 for NaN and below zero.
__device__ __forceinline__ uint32_t quantize(float v, const Grid& g) {
  const float level = fminf(fmaxf(rintf(__fmul_rn(v, g.scale)), g.lower), g.upper);
  return min(__float2uint_rz(__fsub_rn(level, g.lower)), 255u);
}

// ---- K1, the MinMaxUInt8 compress: one cooperative launch -------------------
//
// The TPU computes a chunk's min and max and quantizes it in one pallas_call,
// reading the chunk once from VMEM, where it fits (:176), and from HBM twice
// in a tiled form where it does not (:198 + :213).  Here the chunk's min and
// max need every block of the card, and the quantize needs that result, so the
// kernel is one persistent grid (one block of 512 threads an SM, all of them
// resident: launched cooperatively, a grid too large is refused, never
// deadlocked) with one grid barrier:
//   phase 1: the flat input x [n * m] is cut into one contiguous slice a
//            block, over every SM.  A block loads its slice into shared
//            memory (as much as fits: up to 113 x 2 KB), two units a thread
//            in flight, and computes the min and max of each part of a chunk
//            the slice holds (a segment), two segments a pass; they are
//            published as one partial pair per (chunk c, block g) at index
//            c + g: walking along x, each segment ends at a chunk's end
//            (c + 1) or a slice's end (g + 1), so c + g grows by one at
//            least, and the segments of chunk c are the pairs c + gs .. c + ge;
//   barrier: cooperative groups' grid sync (its counter is epoch-tagged by
//            its own flip bit, so no launch clears it);
//   phase 2: for each pair of its segments, a warp a chunk reduces the
//            chunk's partial pairs in index order, 128 pairs a round trip
//            (every block the same order, so every block gets the same
//            grid), the block holding the chunk's first element writes the
//            sidecar, and the block quantizes its slice from shared memory,
//            re-reading from device memory only the part that did not fit
//            (the TPU's tiled form, for inputs above the grid's shared
//            memory: 132 x 226 KB = 29.8 MB on an H100).
// A thread moves units of 64 input bytes (four 16-byte loads; 16 f32 or 32
// bf16 elements) and writes a unit's payload as one or two 16-byte stores.
// A warp's 32 units lie in shared memory piece by piece ([4][32][16 bytes]),
// so that every 16-byte shared access of a warp is free of bank conflicts.  A
// unit that crosses the end of the input, or an input that does not start on
// a 16-byte boundary, is loaded element by element; a unit that crosses a
// chunk's end takes each element's grid.  At the path's chunk most of the
// time is a fixed cost (PERF.md): the launch, the barrier and the partials'
// round trip after it, which the kernel also pays on a chunk of 128 KiB.

constexpr int kK1Threads = 512;
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kUnitBytes = 64;                  // one thread's unit of input
constexpr int kSpanBytes = 32 * kUnitBytes;     // a warp's 32 units
constexpr int kK1MaxSpans = 113;                // 113 x 2 KB of the 227 KB a block may hold

template <typename T>
constexpr int kUnitElems = kUnitBytes / sizeof(T);   // 16 f32, 32 bf16
// units a thread has in flight in phase 1 (four ran slower: phase 1 reads
// near the rate L2 gives this access, and the extra registers cost)
constexpr int kK1InFlight = 2;

struct MinmaxArgs {
  const void* x;
  long long m, total;   // chunk length, n * m
  long long slice;      // elements of a block's slice (a multiple of the unit)
  long long held;       // units of a slice held in shared memory (a multiple of 32)
  int n;
  float* partials;      // [n + blocks - 1][2]
  float* mn;
  float* mx;
  uint8_t* payload;
};

// the 16-byte piece k of a unit: four f32 or eight bf16 as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& p, float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// unit u of a block's slice (its first element e): loaded from x, four
// 16-byte loads when it lies whole inside the input and x is aligned, else
// element by element (zeros past the input's end, never used)
template <typename T>
__device__ __forceinline__ void load_unit(uint4 (&p)[4], const T* __restrict__ x, long long e,
                                          long long total, bool vec) {
  if (vec && e + kUnitElems<T> <= total) {
    const uint4* src = reinterpret_cast<const uint4*>(x + e);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __ldg(src + k);
    return;
  }
  uint32_t w[16];   // the unit's 64 bytes
  if constexpr (sizeof(T) == 4) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = e + i < total ? src[e + i] : 0u;
  } else {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t lo = e + 2 * i < total ? src[e + 2 * i] : 0u;
      const uint32_t hi = e + 2 * i + 1 < total ? src[e + 2 * i + 1] : 0u;
      w[i] = lo | hi << 16;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// shared-memory home of piece k of unit u: [span][piece][lane]
__device__ __forceinline__ uint4* unit_piece(unsigned char* smem, long long u, int k) {
  return reinterpret_cast<uint4*>(smem + (u / 32) * kSpanBytes + k * 32 * 16 + (u % 32) * 16);
}

// a / b for a, b >= 0, in 32 bits where both fit (a 64-bit division is a
// long subroutine on the card)
__device__ __forceinline__ long long udiv(long long a, long long b) {
  if (((unsigned long long)a | (unsigned long long)b) >> 32 == 0)
    return (unsigned)a / (unsigned)b;
  return (unsigned long long)a / (unsigned long long)b;
}

// v = (min, max, min, max) of two segments, reduced over the block, in
// thread 0: each warp by shuffles, then warp 0 over the warps' values, a
// fixed tree.  `scratch` holds four floats a warp.
__device__ __forceinline__ void block_minmax(float (&v)[4], float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = i % 2 ? nan_max(v[i], w) : nan_min(v[i], w);
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // scratch may still be read from the previous pair
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) scratch[4 * warp + i] = v[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = lane < kK1Warps ? scratch[4 * lane + i] : i % 2 ? -inf() : inf();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = __shfl_xor_sync(0xffffffffu, v[i], o);
        v[i] = i % 2 ? nan_max(v[i], w) : nan_min(v[i], w);
      }
  }
}

// the unit at e into the (min, max) of its segments: elements in [lo, mid)
// are segment 0's, in [mid, hi) segment 1's, others neither
template <typename T>
__device__ __forceinline__ void unit_minmax(const uint4 (&p)[4], long long e, long long lo,
                                            long long mid, long long hi, float (&v)[4]) {
  constexpr int EPU = kUnitElems<T>, EPP = EPU / 4;
  float f[4][EPP];
#pragma unroll
  for (int k = 0; k < 4; ++k) unpack<T>(p[k], f[k]);
  // v is indexed by constants only, so that it stays in registers
  if (e >= lo && e + EPU <= mid) {   // the whole unit in segment 0
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < EPP; ++i) {
        v[0] = nan_min(v[0], f[k][i]);
        v[1] = nan_max(v[1], f[k][i]);
      }
  } else if (e >= mid && e + EPU <= hi) {   // in segment 1
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < EPP; ++i) {
        v[2] = nan_min(v[2], f[k][i]);
        v[3] = nan_max(v[3], f[k][i]);
      }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < EPP; ++i) {
        const long long ei = e + k * EPP + i;
        if (ei >= lo && ei < mid) {
          v[0] = nan_min(v[0], f[k][i]);
          v[1] = nan_max(v[1], f[k][i]);
        } else if (ei >= mid && ei < hi) {
          v[2] = nan_min(v[2], f[k][i]);
          v[3] = nan_max(v[3], f[k][i]);
        }
      }
  }
}

// the min and max of chunk c from its partial pairs first..last, in index
// order, in every lane of the calling warp (the same in every block)
__device__ __forceinline__ float2 chunk_minmax(const float* partials, long long first,
                                               long long last) {
  const int lane = threadIdx.x % 32;
  float vmin = inf(), vmax = -inf();
  for (long long base = first; base <= last; base += 128) {
    float2 q[4];   // four loads in flight a lane
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = base + 32 * k + lane;
      q[k] = j <= last ? __ldcg(reinterpret_cast<const float2*>(partials) + j)
                       : make_float2(inf(), -inf());
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vmin = nan_min(vmin, q[k].x);
      vmax = nan_max(vmax, q[k].y);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vmin = nan_min(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
    vmax = nan_max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  return make_float2(vmin, vmax);
}

// the unit's payload bytes, four a word, each element on its segment's grid
template <typename T>
__device__ __forceinline__ void unit_quantize(const uint4 (&p)[4], long long e, long long mid,
                                              const Grid& g0, const Grid& g1,
                                              uint32_t (&out)[kUnitElems<T> / 4]) {
  constexpr int EPU = kUnitElems<T>, EPP = EPU / 4;
  float f[4][EPP];
#pragma unroll
  for (int k = 0; k < 4; ++k) unpack<T>(p[k], f[k]);
  if (e + EPU <= mid || e >= mid) {   // one grid for the whole unit
    const Grid g = e >= mid ? g1 : g0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int w = 0; w < EPP / 4; ++w)
        out[k * EPP / 4 + w] = quantize(f[k][4 * w], g) | quantize(f[k][4 * w + 1], g) << 8 |
                               quantize(f[k][4 * w + 2], g) << 16 |
                               quantize(f[k][4 * w + 3], g) << 24;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int w = 0; w < EPP / 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long ei = e + k * EPP + 4 * w + i;
          word |= quantize(f[k][4 * w + i], ei < mid ? g0 : g1) << (8 * i);
        }
        out[k * EPP / 4 + w] = word;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kK1Threads, 1) minmax_compress_kernel(MinmaxArgs a) {
  constexpr int EPU = kUnitElems<T>;
  extern __shared__ __align__(16) unsigned char held[];
  __shared__ float scratch[4 * kK1Warps];
  __shared__ Grid grids[2];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const long long g = blockIdx.x, s0 = g * a.slice;
  const long long s1 = s0 + a.slice < a.total ? s0 + a.slice : a.total;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long c_first = udiv(s0, a.m), c_last = udiv(s1 - 1, a.m);

  // phase 1: load the slice (into shared memory while it fits) and publish
  // the min and max of each of its segments, two segments a pass (a slice
  // crosses at most one chunk's end at the path's sizes)
  for (long long c = c_first; c <= c_last; c += 2) {
    const long long lo = c * a.m > s0 ? c * a.m : s0;
    const long long mid = (c + 1) * a.m < s1 ? (c + 1) * a.m : s1;
    const long long hi = c + 1 <= c_last ? ((c + 2) * a.m < s1 ? (c + 2) * a.m : s1) : mid;
    const long long u_end = (hi - s0 + EPU - 1) / EPU;   // units overlapping [lo, hi)
    float v[4] = {inf(), -inf(), inf(), -inf()};
    for (long long u = (lo - s0) / EPU + threadIdx.x; u < u_end; u += kK1InFlight * kK1Threads) {
      // kK1InFlight units loaded before the first is used (a unit past the
      // segment's end is replaced by the first, loaded again and not used)
      uint4 p[kK1InFlight][4];
#pragma unroll
      for (int w = 0; w < kK1InFlight; ++w) {
        const long long uw = u + w * kK1Threads < u_end ? u + w * kK1Threads : u;
        load_unit<T>(p[w], x, s0 + uw * EPU, a.total, vec);
      }
#pragma unroll
      for (int w = 0; w < kK1InFlight; ++w) {
        const long long uw = u + w * kK1Threads;
        if (uw >= u_end) break;
        if (uw < a.held) {
#pragma unroll
          for (int k = 0; k < 4; ++k) *unit_piece(held, uw, k) = p[w][k];
        }
        unit_minmax<T>(p[w], s0 + uw * EPU, lo, mid, hi, v);
      }
    }
    block_minmax(v, scratch);
    if (threadIdx.x == 0) {
      reinterpret_cast<float2*>(a.partials)[c + g] = make_float2(v[0], v[1]);
      if (c + 1 <= c_last) reinterpret_cast<float2*>(a.partials)[c + 1 + g] = make_float2(v[2], v[3]);
    }
  }

  cg::this_grid().sync();

  // phase 2: the grids of each pair of segments (warp s reads chunk c + s's
  // partials), then their payload
  for (long long c = c_first; c <= c_last; c += 2) {
    const long long lo = c * a.m > s0 ? c * a.m : s0;
    const long long mid = (c + 1) * a.m < s1 ? (c + 1) * a.m : s1;
    const long long hi = c + 1 <= c_last ? ((c + 2) * a.m < s1 ? (c + 2) * a.m : s1) : mid;
    const int warp = threadIdx.x / 32;
    if (warp < 2 && c + warp <= c_last) {
      const long long cc = c + warp;
      const float2 r = chunk_minmax(a.partials, cc + udiv(cc * a.m, a.slice),
                                    cc + udiv((cc + 1) * a.m - 1, a.slice));
      if (threadIdx.x % 32 == 0) {
        grids[warp] = make_grid(r.x, r.y);
        if (cc * a.m >= s0) {   // this block holds the chunk's first element
          a.mn[cc] = r.x;
          a.mx[cc] = r.y;
        }
      }
    }
    __syncthreads();
    const Grid g0 = grids[0], g1 = grids[1];
    const long long u_end = (hi - s0 + EPU - 1) / EPU;
    for (long long u = (lo - s0) / EPU + threadIdx.x; u < u_end; u += kK1Threads) {
      const long long e = s0 + u * EPU;
      uint4 p[4];
      if (u < a.held) {
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = *unit_piece(held, u, k);
      } else {
        load_unit<T>(p, x, e, a.total, vec);
      }
      uint32_t out[EPU / 4];
      unit_quantize<T>(p, e, mid, g0, g1, out);
      if (e >= lo && e + EPU <= hi) {
        uint4* dst = reinterpret_cast<uint4*>(a.payload + e);
#pragma unroll
        for (int q = 0; q < EPU / 16; ++q)
          dst[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
      } else {
        for (int i = 0; i < EPU; ++i)
          if (e + i >= lo && e + i < hi) a.payload[e + i] = (uint8_t)(out[i / 4] >> (8 * (i % 4)));
      }
    }
    __syncthreads();   // grids are read before the next pair writes them
  }
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

bool bad_shape(int n, long long m, long long tile, int tiles) {
  return n < 1 || n > 65535 || m < 1 || tile < 1 || tiles < 1 ||
         (long long)tiles != (m + tile - 1) / tile;
}

// ---- K3, the absmax of the int8 and fp8 codecs: one launch -----------------
//
// out[c] = max |x| over chunk c (f32; bf16 widens exactly).  The TPU reads a
// chunk once in one pallas_call where it fits in VMEM (:295) and in tiles
// with a sequential grid otherwise (:311).  Here a chunk's max needs many
// blocks at once: at world size 2 the ring encodes one chunk of 1.31 M
// elements, and one block would use 1 of 132 SMs.  So one launch of a
// (blocks, chunk) grid sized from the SM count: each block takes a contiguous
// share of the chunk's 16-byte vectors (4 f32 or 8 bf16), eight read-only
// loads a thread in flight, a share of eight loads a thread at least (80
// blocks at the path's 5 MiB chunk), at most four blocks an SM.  A chunk that
// does not start on a 16-byte boundary has a head (and a tail) of fewer than
// one vector's elements, which block 0 loads one by one.
//
// Exact in bits (design (b)): |x| has its sign bit clear, so as a u32 its bit
// pattern orders like its value, and every NaN's lies above +inf's
// 0x7f800000.  The kernel takes the max of those u32 patterns throughout (one
// integer instruction an element; a NaN is kept, -0.0 gives +0.0, the start
// value 0 is +0.0), which does not depend on the order.  A chunk holding a
// NaN gives a NaN whose payload bits are not defined.  Each block reduces its
// threads (warp max reductions, then warp 0 over the warps), and where a
// chunk has more than one block, thread 0 `red.max`es the block's result into
// the chunk's word in this library's memory and takes a ticket
// (`atom.add.acq_rel`, which orders the red before it); the chunk's last
// block swaps the word for 0, writes out[c] and sets the ticket back to 0.
// Chosen over K4's partials summed by the last block: no scratch, and the
// last block reads one word instead of walking the partials.  A chunk of one
// block writes out[c] directly.  At the path's chunk most of the time is fixed
// (PERF.md): the launch, and the ticket's three serial L2 round trips (the red
// before the ticket, the ticket, the swap); a release-only ticket with an
// acquire fence in the last block was slower there, as were four loads in
// flight, one block an SM, 256 threads, and one block for a chunk of up to
// 128 KiB, which is faster at 128 KiB alone (scripts/torch_codec_variants.py).

constexpr int kMaxChunks = 65535;   // the wrappers' limit, and a grid's y
constexpr int kAbsmaxThreads = 512;
constexpr int kAbsmaxInFlight = 8;      // 16-byte loads a thread in flight
constexpr int kAbsmaxMinLoads = 8;      // a block's share: this many loads a thread at least
constexpr int kAbsmaxBlocksPerSm = 4;   // a chunk's blocks: at most this many an SM
__device__ unsigned int g_absmax_tickets[kMaxChunks];
__device__ unsigned int g_absmax_bits[kMaxChunks];

// |x| as u32 bits: the sign bit cleared (bf16 widened by a shift)
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ uint32_t abs_bits(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v) << 16 & 0x7fffffffu;
}

// max |x| bits of one 16-byte vector: four f32, or eight bf16 (two a word)
template <typename T>
__device__ __forceinline__ uint32_t vector_abs_bits(const uint4& p) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      r = max(r, w[i] & 0x7fffffffu);
    } else {
      r = max(r, max(w[i] << 16 & 0x7fffffffu, w[i] & 0x7fff0000u));
    }
  }
  return r;
}

__device__ __forceinline__ unsigned int atomic_add_acq_rel(unsigned int* p, unsigned int v) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void red_max(unsigned int* p, unsigned int v) {
  asm volatile("red.relaxed.gpu.global.max.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// grid (blocks, n): block b's share of chunk c's vectors
template <typename T>
__global__ void __launch_bounds__(kAbsmaxThreads)
absmax_kernel(const T* __restrict__ x, long long m, float* __restrict__ out) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int kWarpsA = kAbsmaxThreads / 32;
  __shared__ uint32_t scratch[kWarpsA];
  const int c = blockIdx.y, b = blockIdx.x, blocks = gridDim.x;
  const T* xc = x + (long long)c * m;
  // elements before the first 16-byte boundary, the whole vectors, the rest
  const long long skew = (long long)((16 - (reinterpret_cast<uintptr_t>(xc) & 15)) & 15) / sizeof(T);
  const long long head = skew < m ? skew : m;
  const long long vecs = (m - head) / EPV;
  const long long tail = head + vecs * EPV;
  uint32_t acc = 0;
  if (b == 0) {
    if (threadIdx.x < head) acc = abs_bits(xc[threadIdx.x]);
    if (tail + threadIdx.x < m) acc = max(acc, abs_bits(xc[tail + threadIdx.x]));
  }
  const long long per = udiv(vecs + blocks - 1, blocks);
  const long long lo = b * per;
  const long long hi = lo + per < vecs ? lo + per : vecs;
  const uint4* v = reinterpret_cast<const uint4*>(xc + head);
  for (long long i = lo + threadIdx.x; i < hi; i += kAbsmaxInFlight * kAbsmaxThreads) {
    // every load issued before any is used; one past the share reads vector
    // i again, which a max does not mind
    uint4 p[kAbsmaxInFlight];
#pragma unroll
    for (int u = 0; u < kAbsmaxInFlight; ++u) {
      const long long j = i + u * kAbsmaxThreads;
      p[u] = __ldg(v + (j < hi ? j : i));
    }
#pragma unroll
    for (int u = 0; u < kAbsmaxInFlight; ++u) acc = max(acc, vector_abs_bits<T>(p[u]));
  }
  acc = __reduce_max_sync(0xffffffffu, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = __reduce_max_sync(0xffffffffu, lane < kWarpsA ? scratch[lane] : 0u);
  if (lane != 0) return;
  if (blocks == 1) {
    out[c] = __uint_as_float(acc);
    return;
  }
  red_max(&g_absmax_bits[c], acc);
  if (atomic_add_acq_rel(&g_absmax_tickets[c], 1u) != (unsigned)blocks - 1) return;
  // every block's red came before its ticket, and this ticket was the last
  out[c] = __uint_as_float(atomicExch(&g_absmax_bits[c], 0u));
  g_absmax_tickets[c] = 0;
}

// the card's SM count, per device, read once
cudaError_t sm_count(int& sms) {
  constexpr int kMaxDevices = 64;
  static int known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    known[dev] = v;
  }
  sms = known[dev];
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_absmax(const T* x, int n, long long m, float* out, cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const long long vectors = (m * (long long)sizeof(T) + 15) / 16;
  const long long share = (long long)kAbsmaxThreads * kAbsmaxMinLoads;
  const long long most = (long long)sms * kAbsmaxBlocksPerSm / n;
  long long blocks = (vectors + share - 1) / share;
  blocks = blocks < most ? blocks : most;
  blocks = blocks > 1 ? blocks : 1;
  absmax_kernel<T><<<dim3((unsigned)blocks, n), kAbsmaxThreads, 0, s>>>(x, m, out);
  return cudaGetLastError();
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
// 1/8, K5 reads 1/8 and writes 4.  The grid is (tile, chunk) over the
// payload's bytes.  K5: each thread unpacks one byte to 8 elements at stride
// B, so in every plane neighbouring threads touch neighbouring addresses.
//
// K4 is one launch.  Each thread makes V neighbouring payload bytes (V = 4
// for f32, 8 for bf16): from each of the 8 planes it reads the V neighbouring
// elements as one 16-byte load, the 8 loads issued before any is used (one
// round trip; a branch per plane had made them 8), and it stores the V bytes
// as one 4- or 8-byte word.  A chunk that does not start on a 16-byte boundary (m not a
// multiple of the vector) and the group that crosses m load element by
// element.  A tile is one pass of the block's threads at least.  Each block
// writes its partial sum of |x| to device memory, and the last block of the
// chunk to finish (a ticket from an acquire-release atomicAdd, which orders
// the partial before it) adds the chunk's partials in index order and
// divides with __fdiv_rn, so the scale does not depend on which block came
// last, and sets the chunk's ticket back to zero for the next launch.  The last bytes a thread makes
// are stored after the ticket, so that its release has not them to wait for.

constexpr int kSignThreads = 256;
__device__ unsigned int g_sign_tickets[kMaxChunks];

// Sum over a block of NT threads in a fixed tree; every thread gets the
// result.  The xor butterfly adds the same two values in every lane of a
// pair, so all lanes agree.  `scratch` holds NT / 32 floats.
template <int NT>
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < NT / 32 ? scratch[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
using SignWord = typename std::conditional<sizeof(T) == 4, uint32_t, uint64_t>::type;

// bytes [t * tile, min((t + 1) * tile, B)) of chunk c (tile a multiple of
// V), the partial sum of |x| over their elements, and in the chunk's last
// block to finish the scale.  grid (tiles, n).
template <typename T, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
sign_compress_kernel(const T* __restrict__ x, long long m, long long B, long long tile,
                     int tiles, float* __restrict__ partials, float* __restrict__ scale,
                     uint8_t* __restrict__ payload) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float scratch[NT / 32];
  __shared__ bool last;
  const int c = blockIdx.y, t = blockIdx.x;
  const T* xc = x + (long long)c * m;
  uint8_t* pc = payload + (long long)c * B;
  const bool vec = (reinterpret_cast<uintptr_t>(xc) & 15) == 0;
  const long long lo = (long long)t * tile;
  const long long hi = lo + tile < B ? lo + tile : B;
  float acc = 0.0f;
  SignWord<T> word = 0;   // the bytes at jw, stored when the next are made
  long long jw = -1;
  for (long long j = lo + (long long)threadIdx.x * V; j < hi; j += (long long)NT * V) {
    if (jw >= 0) *reinterpret_cast<SignWord<T>*>(pc + jw) = word;
    word = 0;
    jw = j;
    if (vec && 7 * B + j + V <= m) {
      // every plane's V elements lie in the chunk: the 8 loads are issued
      // together (one round trip), then used
      uint4 raw[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) raw[b] = __ldg(reinterpret_cast<const uint4*>(xc + b * B + j));
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float v[V];
        unpack<T>(raw[b], v);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          word |= (SignWord<T>)(v[u] >= 0.0f ? 1u : 0u) << (8 * u + b);
          acc = __fadd_rn(acc, fabsf(v[u]));
        }
      }
    } else {   // an unaligned chunk, or the planes past m: element by element
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const long long i = b * B + j + u;
          const float v = i < m ? load(xc + i) : 0.0f;
          word |= (SignWord<T>)(v >= 0.0f ? 1u : 0u) << (8 * u + b);
          acc = __fadd_rn(acc, fabsf(v));
        }
    }
  }
  acc = block_sum<NT>(acc, scratch);
  if (threadIdx.x == 0) {
    partials[(long long)c * tiles + t] = acc;
    last = atomic_add_acq_rel(&g_sign_tickets[c], 1u) == (unsigned)tiles - 1;
  }
  if (jw >= 0) *reinterpret_cast<SignWord<T>*>(pc + jw) = word;
  __syncthreads();
  if (!last) return;
  // every partial of the chunk was written before its block's ticket, and
  // this block's ticket was the last: read them from L2
  float v = 0.0f;
  for (int j = threadIdx.x; j < tiles; j += NT)
    v = __fadd_rn(v, __ldcg(partials + (long long)c * tiles + j));
  v = block_sum<NT>(v, scratch);
  if (threadIdx.x == 0) {
    scale[c] = __fdiv_rn(v, (float)m);
    g_sign_tickets[c] = 0;
  }
}

template <typename T>
cudaError_t launch_sign(const T* x, int n, long long m, long long B, long long tile, int tiles,
                        float* partials, float* scale, uint8_t* payload, cudaStream_t s) {
  sign_compress_kernel<T, kSignThreads><<<dim3(tiles, n), kSignThreads, 0, s>>>(
      x, m, B, tile, tiles, partials, scale, payload);
  return cudaGetLastError();
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

// K1's grid for a call: one block an SM, fewer only where a block would
// get less than a warp's 32 units (the per-element work is spread over as
// many SMs as the input allows); each block's slice, and the units of it
// held in shared memory
struct MinmaxPlan {
  int blocks;
  long long slice, held;
  size_t smem;
};

MinmaxPlan minmax_plan(long long total, int elems_per_unit, int sms) {
  MinmaxPlan p;
  const long long units = (total + elems_per_unit - 1) / elems_per_unit;
  long long blocks = (units + 31) / 32;
  blocks = blocks < sms ? blocks : sms;
  const long long per_block = (units + blocks - 1) / blocks;   // units of a slice
  p.slice = per_block * elems_per_unit;
  p.blocks = (int)((total + p.slice - 1) / p.slice);
  const long long spans = (per_block + 31) / 32;
  p.held = 32 * (spans < kK1MaxSpans ? spans : kK1MaxSpans);
  p.smem = (size_t)p.held * kUnitBytes;
  return p;
}

// the card's SM count and the blocks of K1 an SM holds at its most shared
// memory, per device, read once (the attribute is set on first use)
struct MinmaxDevice {
  int sms = 0, per_sm = 0;
};

template <typename T>
cudaError_t minmax_device(MinmaxDevice& d) {
  constexpr int kMaxDevices = 64;
  static MinmaxDevice known[kMaxDevices];
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[dev].per_sm > 0) {
    d = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = sm_count(d.sms);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const void* kernel = reinterpret_cast<const void*>(&minmax_compress_kernel<T>);
  constexpr int kMaxSmem = kK1MaxSpans * kSpanBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, kernel, kK1Threads, kMaxSmem);
  if (err != cudaSuccess) return err;
  if (d.per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  known[dev] = d;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_minmax(MinmaxArgs a, long long partial_pairs, cudaStream_t stream) {
  MinmaxDevice d;
  const cudaError_t err = minmax_device<T>(d);
  if (err != cudaSuccess) return err;
  // at most one block an SM: more resident blocks than SMs would only cut
  // each block's share of shared memory
  const MinmaxPlan p = minmax_plan(a.total, kUnitElems<T>, d.sms);
  if ((long long)a.n + p.blocks - 1 > partial_pairs) return cudaErrorInvalidValue;
  a.slice = p.slice;
  a.held = p.held;
  void* args[] = {&a};
  // a grid that cannot be resident all at once is refused here, with its
  // error, instead of deadlocking at the barrier
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&minmax_compress_kernel<T>),
                                     dim3(p.blocks), dim3(kK1Threads), args, p.smem, stream);
}

}  // namespace

extern "C" {

// x [n, m] f32 (is_bf16 0) or bf16 (1); partials [partial_pairs, 2] f32
// scratch (n + the card's SM count pairs are always enough); mn, mx [n] f32;
// payload [n, m] u8, starting on a 16-byte boundary.  One cooperative launch.
int bagua_minmax_compress(const void* x, int is_bf16, int n, long long m, void* partials,
                          long long partial_pairs, void* mn, void* mx, void* payload,
                          void* stream) {
  if (n < 1 || n > 65535 || m < 1 || (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  MinmaxArgs a{x, m, (long long)n * m, 0, 0, n, (float*)partials, (float*)mn, (float*)mx,
               (uint8_t*)payload};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_minmax<bf16>(a, partial_pairs, s)
                       : launch_minmax<float>(a, partial_pairs, s));
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

// x [n, m] f32 or bf16; out [n] f32.  One launch.
int bagua_absmax(const void* x, int is_bf16, int n, long long m, void* out, void* stream) {
  if (n < 1 || n > kMaxChunks || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return (int)launch_absmax((const bf16*)x, n, m, (float*)out, s);
  return (int)launch_absmax((const float*)x, n, m, (float*)out, s);
}

// x [n, m] f32 or bf16; partials [n, tiles] f32 scratch; scale [n] f32;
// payload [n, B] u8 with B = ceil(m / 1024) * 128, starting on a 16-byte boundary; tiles =
// ceil(B / tile), tile a multiple of 16 / sizeof(element).  One launch.
int bagua_sign_compress(const void* x, int is_bf16, int n, long long m, long long B,
                        long long tile, int tiles, void* partials, void* scale, void* payload,
                        void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (n < 1 || n > kMaxChunks || m < 1 || B != (m + 1023) / 1024 * 128 || tile < 1 ||
      tile % vec || tiles < 1 || (long long)tiles != (B + tile - 1) / tile ||
      (reinterpret_cast<uintptr_t>(payload) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_sign((const bf16*)x, n, m, B, tile, tiles, (float*)partials,
                            (float*)scale, (uint8_t*)payload, s);
  return (int)launch_sign((const float*)x, n, m, B, tile, tiles, (float*)partials,
                          (float*)scale, (uint8_t*)payload, s);
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
