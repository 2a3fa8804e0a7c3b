// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels of bagua_tpu/ops/flash_attention.py:
//   bagua_flash_fwd     <- _fwd          (pallas_call :119, _fwd_kernel :61-110)
//   bagua_flash_bwd_dkv <- _bwd dK/dV    (pallas_call :274, _bwd_dkv_kernel :150-201)
//   bagua_flash_bwd_dq  <- _bwd dQ       (pallas_call :291, _bwd_dq_kernel :204-247)
//
// Layout: q, k, v, o, do, dq, dk, dv are [bh, s, d] row-major in T (float,
// bf16 or f16); lse and delta are [bh, s] float.  d, the stored width, is any
// multiple of 8 (TMA needs 16-byte row strides; the Python entry points pad a
// head to it): up to 256 the kernels compute at width D = 64 (d <= 64), 128
// (d <= 128) or 256, the columns past d zero in shared memory and never
// stored, so a narrow head costs the time of its D; a wider head runs the
// wide FMA kernels (below), which slice the output's columns.  The softmax
// scale is 1 / sqrt(head_dim), head_dim <= d being the real head before
// padding.
// Any s >= 1 is taken: keys at or past s are masked out and rows at or past
// s are never written, so ragged sequences need no padding by the caller.
//
// What bounds them on an H100: at the model's shapes (s = 4096, D = 64,
// causal) each kernel does 2-3 x 10^10 multiply-adds on ~17 MB per operand,
// far above the card's ~295 flop/byte ridge, so all three are bound by
// arithmetic: by how fully the tensor cores are kept busy, in the forward
// also by the softmax beside them (one exp2 a score: the SM's 16
// special-function results a clock take as long as the two products' wgmma
// at D = 64), and in the backward by the dependent chain S -> P -> dP
// -> dS -> products that each streamed tile walks through.  The TPU kernels
// keep whole-sequence K/V (forward, dQ) or Q/dO (dK/dV) resident in VMEM; at
// s = 4096 that is over 1 MiB, far above the 227 KB a block can hold, so
// here every operand is streamed through shared memory tile by tile, and the
// [s, s] score matrix only ever exists as one tile in registers.
//
// Design: blocks never depend on each other.  The TPU grid's in-order carry
// is a loop inside the block, each output tile is written by exactly one
// block in a fixed order (no atomics: outputs and gradients are
// deterministic), and causal blocks with the most work are launched first.
//
// Every bf16 and f16 kernel is warp-specialized wgmma fed by TMA through an
// mbarrier ring (three stages; two at D = 256): a producer warp streams one
// operand pair into the ring while consumer warpgroups run wgmma on the tiles
// that have landed, so loads overlap the products; every score product takes
// both operands from shared memory, and every product after it takes P or
// dS from registers, its B operand being a streamed tile read MN-major.  The
// forward (a block owns 192 queries, three consumer warpgroups, at D = 64;
// 128 queries at D = 128 and 256) streams K and V in 128-key tiles (64 at
// D = 256), keeps the softmax state and O in registers, and issues a tile's
// S = Q K^T before O += P V of the tile before, so that its softmax runs
// beside that product (FlashAttention-3's order within a warpgroup); the
// tile size, the three warpgroups and that order were each chosen by timing
// the alternatives (PERF.md has the times; scripts/torch_flash_variants.py
// keeps the tile size and the order as variants to time again).  The
// backward is two kernels, the layout the TPU kernels have: dK/dV (a block
// owns 128 keys; 64 at D = 256, where its two warpgroups split dK and dV) and
// dQ (a block owns 128 queries; 64 at D = 256, one warpgroup).  It is not
// fused into one kernel with an atomic f32 dQ (FlashAttention-3): that would
// do 5 products instead of these 7, but the sum order of dQ would change from
// run to run, and every kernel of the port writes each output tile from one
// block in a fixed order.  D = 256 is laid out to be right within the
// budgets (227 KB of shared memory, 240 registers a consumer thread), not
// tuned.
//
// f32 (kept for precision checks, on no training path) has no tensor-core
// format of full precision, so it runs 256 threads of FP32 FMAs from shared
// memory, each thread owning a piece of the R x R score tile (R = 64; 32 at
// D = 256, so that the tiles fit in shared memory).  Heads above 256, which
// no configuration of the repo uses, run the same FMA layout in every dtype,
// one block a 128-column slice of the output (design note at the kernels).
//
// Numerics follow the TPU kernels: softmax state in f32, masking with -1e30
// (not -inf) and l clamped at 1e-30; in bf16 and f16, P is rounded to T
// before P.V and in the dK/dV pass, and dS before its products.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid over an R x R score tile
constexpr float kNegInf = -1e30f;
// rows of an f32 tile (query or key rows): 64, or 32 at D = 256, where four
// 64-row tiles of 256 f32 columns would not fit in shared memory
template <int D>
constexpr int kFR = D == 256 ? 32 : 64;

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(v);
  else return __half2float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, bf16>::value) return __float2bfloat16_rn(v);
  else return __float2half_rn(v);
}
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// rows [row0, row0 + R) and columns [c0, c0 + C) of a T [s, dg] matrix ->
// shared f32 tile of stride C + 1, zero past s and past dg
template <int R, int C, typename T>
__device__ __forceinline__ void load_piece(float* dst, const T* __restrict__ src, int row0,
                                           int s, int c0, int dg) {
  for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, row = row0 + r, col = c0 + c;
    dst[r * (C + 1) + c] = row < s && col < dg ? to_f32(src[(size_t)row * dg + col]) : 0.f;
  }
}

// rows [row0, row0 + R) of an f32 [s, dg] matrix -> shared tile of D
// columns and stride D + 1, zero past s and past dg
template <int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int s, int dg) {
  load_piece<R, D>(dst, src, row0, s, 0, dg);
}

template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int s) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = row0 + r < s ? src[row0 + r] : 0.f;
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]
template <int R, int D>
__device__ __forceinline__ void dot_acc(float (&acc)[R / 16][R / 16], const float* A,
                                        const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R / 16], b[R / 16];
#pragma unroll
    for (int i = 0; i < R / 16; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < R / 16; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R / 16; ++i)
#pragma unroll
      for (int j = 0; j < R / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]
template <int R, int D>
__device__ __forceinline__ void dot_tile(float (&acc)[R / 16][R / 16], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R / 16; ++i)
#pragma unroll
    for (int j = 0; j < R / 16; ++j) acc[i][j] = 0.f;
  dot_acc<R, D>(acc, A, B, ty, tx);
}

// acc[i][j] += sum_c P'[ty + 16 i][c] * X[c][tx + 16 j], where P' is the
// score tile P (row = q, column = k, stride R + 1) or, with TRANS, its
// transpose
template <int R, int D, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[R / 16][D / 16], const float* P,
                                         const float* X, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < R; ++c) {
    float p[R / 16], x[D / 16];
#pragma unroll
    for (int i = 0; i < R / 16; ++i)
      p[i] = TRANS ? P[c * (R + 1) + ty + 16 * i] : P[(ty + 16 * i) * (R + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R / 16; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// the rows below s and columns below dg of an R x D accumulator (columns
// c0 + tx + 16 j), times mul, rounded to T, into a T [s, dg] matrix
template <int R, int D, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, float (&acc)[R / 16][D / 16],
                                           int row0, int s, int dg, int ty, int tx, float mul,
                                           int c0 = 0) {
#pragma unroll
  for (int i = 0; i < R / 16; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < dg) dst[(size_t)row * dg + col] = from_f32<T>(acc[i][j] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernels.  forward: block (q tile, bh), k tiles up to the diagonal
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, int s, int dg, int causal,
           float scale) {
  constexpr int R = kFR<D>, RT = R / 16, PS = R + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + R * (D + 1);
  float* sV = sK + R * (D + 1);
  float* sP = sV + R * (D + 1);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qb * R;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<R, D>(sQ, q + base, q0, s, dg);
  int nkb = (s + R - 1) / R;
  if (causal) nkb = min(nkb, qb + 1);

  float m[RT], l[RT], acc[RT][D / 16];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * R;
    __syncthreads();  // the previous tile's sK/sV/sP readers are done
    load_tile<R, D>(sK, k + base, k0, s, dg);
    load_tile<R, D>(sV, v + base, k0, s, dg);
    __syncthreads();
    float sc[RT][RT];
    dot_tile<R, D>(sc, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kpos >= s || (causal && kpos > qpos)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    acc_tile<R, D, false>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty + 16 * i;
    const float li = fmaxf(l[i], 1e-30f);
    if (row < s) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        if (tx + 16 * j < dg) o[base + (size_t)row * dg + tx + 16 * j] = acc[i][j] / li;
      if (tx == 0) lse[(size_t)blockIdx.y * s + row] = m[i] + logf(li);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: block (k tile, bh); loop over q tiles from the diagonal on
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
           int s, int dg, int causal, float scale) {
  constexpr int R = kFR<D>, RT = R / 16, PS = R + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + R * (D + 1);
  float* sQ = sV + R * (D + 1);
  float* sdO = sQ + R * (D + 1);
  float* sP = sdO + R * (D + 1);
  float* sdS = sP + R * PS;
  float* sL = sdS + R * PS;
  float* sDelta = sL + R;

  const int kb = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int k0 = kb * R;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<R, D>(sK, k + base, k0, s, dg);
  load_tile<R, D>(sV, v + base, k0, s, dg);
  const int nqb = (s + R - 1) / R;
  const int qb_start = causal ? kb : 0;

  float dk_acc[RT][D / 16], dv_acc[RT][D / 16];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb_start; qb < nqb; ++qb) {
    const int q0 = qb * R;
    __syncthreads();
    load_tile<R, D>(sQ, q + base, q0, s, dg);
    load_tile<R, D>(sdO, dout + base, q0, s, dg);
    load_rows<R>(sL, lse + rbase, q0, s);
    load_rows<R>(sDelta, delta + rbase, q0, s);
    __syncthreads();
    float sc[RT][RT], dp[RT][RT];
    dot_tile<R, D>(sc, sQ, sK, ty, tx);    // rows q, columns k
    dot_tile<R, D>(dp, sdO, sV, ty, tx);   // dP = dO V^T
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sP[r * PS + c] = p;
        sdS[r * PS + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    acc_tile<R, D, true>(dv_acc, sP, sdO, ty, tx);   // dV += P^T dO
    acc_tile<R, D, true>(dk_acc, sdS, sQ, ty, tx);   // dK += dS^T Q
  }
  store_tile<R, D>(dk + base, dk_acc, k0, s, dg, ty, tx, scale);
  store_tile<R, D>(dv + base, dv_acc, k0, s, dg, ty, tx, 1.f);
}

// ---------------------------------------------------------------------------
// dQ: block (q tile, bh); loop over k tiles up to the diagonal
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int s, int dg, int causal,
          float scale) {
  constexpr int R = kFR<D>, RT = R / 16, PS = R + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + R * (D + 1);
  float* sK = sdO + R * (D + 1);
  float* sV = sK + R * (D + 1);
  float* sdS = sV + R * (D + 1);
  float* sL = sdS + R * PS;
  float* sDelta = sL + R;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * R;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<R, D>(sQ, q + base, q0, s, dg);
  load_tile<R, D>(sdO, dout + base, q0, s, dg);
  load_rows<R>(sL, lse + rbase, q0, s);
  load_rows<R>(sDelta, delta + rbase, q0, s);
  int nkb = (s + R - 1) / R;
  if (causal) nkb = min(nkb, qb + 1);

  float dq_acc[RT][D / 16];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * R;
    __syncthreads();
    load_tile<R, D>(sK, k + base, k0, s, dg);
    load_tile<R, D>(sV, v + base, k0, s, dg);
    __syncthreads();
    float sc[RT][RT], dp[RT][RT];
    dot_tile<R, D>(sc, sQ, sK, ty, tx);
    dot_tile<R, D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sdS[r * PS + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    acc_tile<R, D, false>(dq_acc, sdS, sK, ty, tx);  // dQ += dS K
  }
  store_tile<R, D>(dq + base, dq_acc, q0, s, dg, ty, tx, scale);
}

// ---------------------------------------------------------------------------
// heads wider than 256, every dtype: FMA kernels over column slices
//
// wgmma's N and a TMA box stop at 256, and a 64-row operand tile of a wider
// head leaves no room in shared memory for a ring beside it.  These kernels
// are the f32 kernels' layout made generic in the input type and the width:
// a block owns 64 rows (queries; keys for dK/dV) and kWideOut columns of its
// output (grid dimension z).  The scores S = Q K^T and dP = dO V^T contract
// over the whole head: they stream through shared memory in pieces of
// kWidePiece columns, and every column slice of a row tile computes them
// anew, in the same order, so all slices agree and slice 0 alone writes the
// lse.  Operands widen to f32 in shared memory; in bf16 and f16, P is rounded
// to T before P V and the dK/dV products, and dS before its products, where
// the wgmma kernels round their A fragments.  Right, not fast: each score is
// computed ceil(d / 128) times, on FP32 FMAs.
// ---------------------------------------------------------------------------

constexpr int kWide = 0;          // the "compute width" of these kernels in the dispatch
constexpr int kWideRows = 64;     // rows of a tile (queries or keys)
constexpr int kWidePiece = 64;    // head columns of a streamed piece of S or dP
constexpr int kWideOut = 128;     // output columns a block owns

// acc = A B^T over the whole head: rows ra.. of a and rb.. of b, both T
// [s, dg], streamed in pieces through sA and sB (each kWideRows x
// (kWidePiece + 1) floats)
template <typename T>
__device__ __forceinline__ void scores_wide(float (&acc)[kWideRows / 16][kWideRows / 16],
                                            float* sA, float* sB, const T* __restrict__ a,
                                            int ra, const T* __restrict__ b, int rb, int s,
                                            int dg, int ty, int tx) {
  constexpr int R = kWideRows;
#pragma unroll
  for (int i = 0; i < R / 16; ++i)
#pragma unroll
    for (int j = 0; j < R / 16; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < dg; c0 += kWidePiece) {
    __syncthreads();   // the last piece's (and tile's) readers are done
    load_piece<R, kWidePiece>(sA, a, ra, s, c0, dg);
    load_piece<R, kWidePiece>(sB, b, rb, s, c0, dg);
    __syncthreads();
    dot_acc<R, kWidePiece>(acc, sA, sB, ty, tx);
  }
}

constexpr int kWidePieceFloats = kWideRows * (kWidePiece + 1);
constexpr int kWideOutFloats = kWideRows * (kWideOut + 1);
constexpr int kWideScoreFloats = kWideRows * (kWideRows + 1);

// forward: block (64 queries, bh, output slice); k tiles up to the diagonal
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int s, int dg, int causal,
                float scale) {
  constexpr int R = kWideRows, RT = R / 16, PS = R + 1, OT = kWideOut / 16;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kWidePieceFloats;
  float* sV = sB + kWidePieceFloats;
  float* sP = sV + kWideOutFloats;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qb * R, c0 = blockIdx.z * kWideOut;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int nkb = (s + R - 1) / R;
  if (causal) nkb = min(nkb, qb + 1);

  float m[RT], l[RT], acc[RT][OT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * R;
    float sc[RT][RT];
    scores_wide<T>(sc, sA, sB, q + base, q0, k + base, k0, s, dg, ty, tx);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kpos >= s || (causal && kpos > qpos)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OT; ++j) acc[i][j] *= corr;
    }
    load_piece<R, kWideOut>(sV, v + base, k0, s, c0, dg);
    __syncthreads();
    acc_tile<R, kWideOut, false>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[i][j] /= li;
    const int row = q0 + ty + 16 * i;
    if (blockIdx.z == 0 && tx == 0 && row < s) lse[(size_t)blockIdx.y * s + row] = m[i] + logf(li);
  }
  store_tile<R, kWideOut>(o + base, acc, q0, s, dg, ty, tx, 1.f, c0);
}

// dK/dV: block (64 keys, bh, output slice); q tiles from the diagonal on
template <typename T>
__global__ void __launch_bounds__(kThreads)
dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s,
                int dg, int causal, float scale) {
  constexpr int R = kWideRows, RT = R / 16, PS = R + 1, OT = kWideOut / 16;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kWidePieceFloats;
  float* sdO = sB + kWidePieceFloats;   // the slice's columns of dO and Q
  float* sQ = sdO + kWideOutFloats;
  float* sP = sQ + kWideOutFloats;
  float* sdS = sP + kWideScoreFloats;
  float* sL = sdS + kWideScoreFloats;
  float* sDelta = sL + R;

  const int kb = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int k0 = kb * R, c0 = blockIdx.z * kWideOut;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nqb = (s + R - 1) / R;

  float dk_acc[RT][OT], dv_acc[RT][OT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = causal ? kb : 0; qb < nqb; ++qb) {
    const int q0 = qb * R;
    float sc[RT][RT], dp[RT][RT];
    scores_wide<T>(sc, sA, sB, q + base, q0, k + base, k0, s, dg, ty, tx);     // rows q, columns k
    scores_wide<T>(dp, sA, sB, dout + base, q0, v + base, k0, s, dg, ty, tx);  // dP = dO V^T
    load_piece<R, kWideOut>(sdO, dout + base, q0, s, c0, dg);
    load_piece<R, kWideOut>(sQ, q + base, q0, s, c0, dg);
    load_rows<R>(sL, lse + rbase, q0, s);
    load_rows<R>(sDelta, delta + rbase, q0, s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? round_to<T>(expf(sc[i][j] * scale - sL[r])) : 0.f;
        sP[r * PS + c] = p;
        sdS[r * PS + c] = round_to<T>(p * (dp[i][j] - sDelta[r]));
      }
    }
    __syncthreads();
    acc_tile<R, kWideOut, true>(dv_acc, sP, sdO, ty, tx);   // dV += P^T dO
    acc_tile<R, kWideOut, true>(dk_acc, sdS, sQ, ty, tx);   // dK += dS^T Q
  }
  store_tile<R, kWideOut>(dk + base, dk_acc, k0, s, dg, ty, tx, scale, c0);
  store_tile<R, kWideOut>(dv + base, dv_acc, k0, s, dg, ty, tx, 1.f, c0);
}

// dQ: block (64 queries, bh, output slice); k tiles up to the diagonal
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int s, int dg, int causal,
               float scale) {
  constexpr int R = kWideRows, RT = R / 16, PS = R + 1, OT = kWideOut / 16;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kWidePieceFloats;
  float* sK = sB + kWidePieceFloats;    // the slice's columns of K
  float* sdS = sK + kWideOutFloats;
  float* sL = sdS + kWideScoreFloats;
  float* sDelta = sL + R;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * R, c0 = blockIdx.z * kWideOut;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<R>(sL, lse + rbase, q0, s);   // read after scores_wide's barriers
  load_rows<R>(sDelta, delta + rbase, q0, s);
  int nkb = (s + R - 1) / R;
  if (causal) nkb = min(nkb, qb + 1);

  float dq_acc[RT][OT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) dq_acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * R;
    float sc[RT][RT], dp[RT][RT];
    scores_wide<T>(sc, sA, sB, q + base, q0, k + base, k0, s, dg, ty, tx);
    scores_wide<T>(dp, sA, sB, dout + base, q0, v + base, k0, s, dg, ty, tx);
    load_piece<R, kWideOut>(sK, k + base, k0, s, c0, dg);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sdS[r * PS + c] = round_to<T>(p * (dp[i][j] - sDelta[r]));
      }
    }
    __syncthreads();
    acc_tile<R, kWideOut, false>(dq_acc, sdS, sK, ty, tx);  // dQ += dS K
  }
  store_tile<R, kWideOut>(dq + base, dq_acc, q0, s, dg, ty, tx, scale, c0);
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma fed by TMA through an mbarrier-guarded ring
// (hopper.cuh has the barriers, TMA, descriptors and wgmma instructions)
//
// A block owns 64-192 rows (queries for the forward and dQ, keys for dK/dV):
// consumer warpgroups of 64 rows each, and a producer warpgroup of which
// one warp works.  The producer loads the block's own rows once, then streams
// the other operand pair tile by tile through a ring of stages, each guarded
// by a "full" and an "empty" mbarrier, while the consumers run wgmma on the
// stages that have landed.  Every tile is one [rows, 64] TMA box per
// 64-column slice in the 128-byte swizzle (a 64-column 16-bit row is exactly
// 128 bytes), the layout the wgmma descriptors read.  Rows at or past s and
// columns at or past d arrive as zeros: the tensor maps are [bh, s, d], so a
// head's last partial tile never reads the next head's rows, and a head
// narrower than D is widened in shared memory.
//
// Scores and their gradients stay in registers.  The accumulator of a score
// product is, rounded to T, the register A operand of the next product (a
// thread's accumulator elements of a 16-column step are the elements of its
// A fragment for that k step), so P and dS never pass through shared memory.
//
// Budget (backward, D = 64): a consumer thread holds the f32 dK and dV
// accumulators (64 registers) beside S and dP (32 each), about 140
// registers in all.  Two blocks on an SM, each with a producer warp, leave
// 96 registers a thread, and both kernels then spill (PERF.md has the
// times of that layout).  So a block has the SM to itself: 384 threads at
// 168 registers each, the producer's warpgroup handing its registers to the
// consumers with setmaxnreg (24 and 240), which also holds D = 128's 128
// accumulator registers without a spill.  At D = 256 one accumulator is 128
// registers a thread: the dK/dV block splits dK and dV between its two
// warpgroups, and dQ runs one consumer warpgroup.  Shared memory: 84 KB a
// block at D = 64, 165 KB at D = 128, 193 KB at D = 256.
// ---------------------------------------------------------------------------

constexpr int kRows = 64;             // rows of a streamed backward tile (one stage)
constexpr int kBlockRows = 128;       // rows a backward block owns at D <= 128
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kBwdThreads = kConsumers + 128;   // and the producer's warpgroup
constexpr int kProducerRegs = 24;     // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;    // (3 x 168 = 24 + 2 x 240 per SM sub-partition)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// depth of the ring: three stages, two at D = 256 (a stage of two 64-row
// tiles of 256 columns is 64 KB)
template <int D>
constexpr int kStages = D == 256 ? 2 : 3;

// TMA: rows [row0, row0 + rows) of head bh of a [bh, s, d] tensor into dst,
// one [rows, 64] box per 64-column slice, completing on `bar`
template <int D, typename T>
__device__ __forceinline__ void tma_load_rows(T* dst, const CUtensorMap* map, int rows,
                                              int row0, int bh, uint64_t* bar) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) tma_load_3d(dst + h * rows * 64, map, h * 64, row0, bh, bar);
}

// rows `row` and `row + 8` of an m64nD accumulator, times mul, into a T
// [s, dg] matrix; rows at or past s and columns at or past dg (a multiple of
// 8) are not written
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[D / 2],
                                           int row, int s, int dg, int tq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < dg)
        *reinterpret_cast<uint32_t*>(dst + (size_t)(row + 8 * r) * dg + 8 * j + 2 * tq) =
            pack2<T>(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, int full_count, uint64_t* empty,
                                          uint64_t* once, int empty_count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], full_count);
      mbar_init(&empty[i], empty_count);
    }
    mbar_init(once, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward: block (64 x kFwdGroups queries, bh); the key tiles up to the
// diagonal stream through the ring.  Each consumer warpgroup computes, for
// its 64 queries and a key tile, S = Q K^T (A = Q, B = K, both from shared
// memory), the online softmax of S in registers, and O += P V with P from
// registers and V read MN-major.  S of a tile is issued before O += P V of
// the tile before it, and its softmax runs while that product is on the
// tensor cores (FlashAttention-3's order within a warpgroup).  What bounds
// the forward here is the softmax beside the products: its exp2 and its
// three FP32 instructions a score take about as long as the two products, so
// the design is about keeping the tensor cores busy while it runs.
// ---------------------------------------------------------------------------

// keys of a streamed forward tile: S is one m64n128 product a warpgroup,
// with half the barriers and softmax steps a key of 64-key tiles; 64 at
// D = 256, where a stage of 128 keys would be 128 KB
template <int D>
constexpr int kFwdKeys = D == 256 ? 64 : 128;
// consumer warpgroups of a block, 64 queries each, beside the producer's
// warpgroup: three at D = 64 (each K/V tile loaded serves 192 queries, and
// three warps a sub-partition hide each other's softmax), two at D = 128 and
// 256, whose 64 or 128 O accumulators a thread leave no room for a third.
// The producer keeps 24 registers a thread and the consumers share the rest
// (a sub-partition's 16384: 32 x 24 + 3 x 32 x 160, or 32 x 24 + 2 x 32 x 240)
template <int D>
constexpr int kFwdGroups = D == 64 ? 3 : 2;
template <int D>
constexpr int kFwdRows = 64 * kFwdGroups<D>;
template <int D>
constexpr int kFwdThreads = 128 * (kFwdGroups<D> + 1);
template <int D>
constexpr int kFwdConsumerRegs = kFwdGroups<D> == 2 ? 240 : 160;

template <typename T, int D>
struct FwdSmem {
  T q[kFwdRows<D> * D];                      // the block's queries, [D / 64][rows][64]
  T k[kStages<D>][kFwdKeys<D> * D];          // streamed keys, [D / 64][keys][64] a stage
  T v[kStages<D>][kFwdKeys<D> * D];
  uint64_t full[kStages<D>], empty[kStages<D>], q_full;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T of a warpgroup's 64 queries and a key tile, issued and committed
template <typename T, int D, int KEYS>
__device__ __forceinline__ void issue_qk(float (&sc)[KEYS / 2], const T* q, int wg,
                                         const T* kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, 0, 0>(sc, kmajor(q, kFwdRows<D>, wg * 64, kk), kmajor(kt, KEYS, 0, kk), kk);
  wgmma_commit();
}

// O += P V, P the A fragments of a key tile, issued and committed
template <typename T, int D, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[KEYS / 16][4],
                                         const T* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) wgmma_rs<T>(o, pf[kk], mnmajor(vt, KEYS, 16 * kk), 1);
  wgmma_commit();
}

// 2^x by the special-function unit alone (exp2f adds the steps that keep a
// denormal result; here one is as good as 0 beside the row's largest term)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one online-softmax step on S of the key tile at k0, in place: S becomes
// P = exp2(S scale log2(e) - m), m the new row maximum in those units
// (masking with -1e30 only in a MASK step: the diagonal and the ragged
// tile); l, this thread's part of each row sum, is rescaled and grows by P's
// unrounded sum, and corr is what O must be multiplied by.  A row's maximum
// and sum run in four chains each (element i's chain is c), so that their
// compares and adds overlap instead of waiting on each other.
template <bool MASK, int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int row_lo, int s,
                                             int causal, int tq, float scale_log2) {
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = kNegInf, sum[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i % 4) / 2, c = i % 2 + 2 * (i / 4 % 2);
    if (MASK) {
      const int key = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
      if (key >= s || (causal && key > row_lo + 8 * r)) sc[i] = kNegInf;
    }
    mx[r][c] = fmaxf(mx[r][c], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mr = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    const float m_new = fmaxf(m[r], quad_max(mr) * scale_log2);
    corr[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i % 4) / 2, c = i % 2 + 2 * (i / 4 % 2);
    sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m[r]));
    sum[r][c] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// the softmax step of the key tile at k0 for a warpgroup whose first query
// is qw: masked on the diagonal and the ragged tile only
template <int N>
__device__ __forceinline__ void softmax(float (&sc)[N], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], int k0, int qw, int row_lo, int s,
                                        int causal, int tq, float scale_log2) {
  if ((causal && k0 + 2 * N - 1 > qw) || k0 + 2 * N > s)
    softmax_step<true>(sc, m, l, corr, k0, row_lo, s, causal, tq, scale_log2);
  else
    softmax_step<false>(sc, m, l, corr, k0, row_lo, s, causal, tq, scale_log2);
}

// the forward's body; w is the stored head dim (D, or narrower)
template <typename T, int D>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, T* __restrict__ o,
                                          float* __restrict__ lse, int s, int w, int causal,
                                          float scale) {
  constexpr int KEYS = kFwdKeys<D>, S = kStages<D>;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FwdSmem<T, D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows<D>;   // longest causal rows first
  int ntiles = (s + KEYS - 1) / KEYS;
  if (causal) ntiles = min(ntiles, (min(q0 + kFwdRows<D>, s) - 1) / KEYS + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer's one arrival and the TMA bytes
  init_ring<S>(sm.full, 1, sm.empty, &sm.q_full, 128 * kFwdGroups<D>);

  if (warp >= 4 * kFwdGroups<D>) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * kFwdGroups<D> || lane != 0) return;
    // producer: the block's Q once, then K and V tile by tile
    mbar_arrive_expect_tx(&sm.q_full, kFwdRows<D> * D * sizeof(T));
    tma_load_rows<D>(sm.q, tm_q, kFwdRows<D>, q0, bh, &sm.q_full);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S;
      if (it >= S) mbar_wait(&sm.empty[st], (it / S - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], 2 * KEYS * D * sizeof(T));
      tma_load_rows<D>(sm.k[st], tm_k, KEYS, it * KEYS, bh, &sm.full[st]);
      tma_load_rows<D>(sm.v[st], tm_v, KEYS, it * KEYS, bh, &sm.full[st]);
    }
    return;
  }

  setmaxnreg_inc<kFwdConsumerRegs<D>>();
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int qw = q0 + wg * 64;                   // this warpgroup's first query
  const int row_lo = qw + (warp % 4) * 16 + g;   // this thread's rows: row_lo, row_lo + 8
  const float scale_log2 = scale * kLog2e;
  // the tiles this warpgroup computes, a prefix of the stream: none when its
  // queries are all at or past s (never stored), and under causal none that
  // lies wholly after them.  Each such tile starts at or before qw, so no
  // row of a computed tile is masked whole.
  int own = qw < s ? ntiles : 0;
  if (causal && own > 0) own = min(own, (min(qw + 64, s) - 1) / KEYS + 1);
  float o_acc[D / 2], sc[KEYS / 2], corr[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pf[KEYS / 16][4];   // P rounded to T: the A operand of O += P V
  zero(o_acc);
  mbar_wait(&sm.q_full, 0);
  __syncwarp();   // wgmma wants converged warps

  // tile it: S = Q K^T is issued before O += P V of tile it - 1, and the
  // softmax of tile it runs while that product is on the tensor cores.
  // Tile 0's S and softmax come before the loop, the last O += P V after
  // it; the tiles this warpgroup does not compute are waited for and
  // released all the same.
  if (own > 0) {
    mbar_wait(&sm.full[0], 0);
    __syncwarp();
    issue_qk<T, D, KEYS>(sc, sm.q, wg, sm.k[0]);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(sc, m, l, corr, 0, qw, row_lo, s, causal, tq, scale_log2);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
  }
  for (int it = 1; it < own; ++it) {
    const int st = it % S, prev = (it - 1) % S;
    mbar_wait(&sm.full[st], (it / S) & 1);
    __syncwarp();
    issue_qk<T, D, KEYS>(sc, sm.q, wg, sm.k[st]);
    issue_pv<T, D, KEYS>(o_acc, pf, sm.v[prev]);
    wgmma_wait<1>();   // S
    reg_fence(sc);
    softmax(sc, m, l, corr, it * KEYS, qw, row_lo, s, causal, tq, scale_log2);
    wgmma_wait<0>();   // O += P V
    reg_fence(o_acc);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) reg_fence(pf[kk]);
    mbar_arrive(&sm.empty[prev]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i % 4) / 2];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
  }
  if (own > 0) {
    const int last = (own - 1) % S;
    issue_pv<T, D, KEYS>(o_acc, pf, sm.v[last]);
    wgmma_wait<0>();
    reg_fence(o_acc);
    mbar_arrive(&sm.empty[last]);
  }
  for (int it = own; it < ntiles; ++it) {
    mbar_wait(&sm.full[it % S], (it / S) & 1);
    mbar_arrive(&sm.empty[it % S]);
  }

  // O / l and lse = m + log(l) (natural log: m is in log2 units), rows
  // below s only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    if (tq == 0 && row_lo + 8 * r < s)
      lse[(size_t)bh * s + row_lo + 8 * r] = m[r] * kLn2 + logf(l[r]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] /= l[(i % 4) / 2];
  store_rows<T, D>(o + (size_t)bh * s * w, o_acc, row_lo, s, w, tq, 1.f);
}

// Two entry points a kernel: one for heads of width D, with the stored width
// fixed at compile time, and one for narrower heads that reads it at run
// time.  The full-width one keeps no head-dim argument: with one (even
// unused), dQ ran 4-5% slower at D = 64.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads<D>, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int causal, float scale) {
  fwd_wgmma<T, D>(&tm_q, &tm_k, &tm_v, o, lse, s, D, causal, scale);
}
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads<D>, 1)
fwd_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                        float* __restrict__ lse, int s, int w, int causal, float scale) {
  fwd_wgmma<T, D>(&tm_q, &tm_k, &tm_v, o, lse, s, w, causal, scale);
}

// P^T in place of S^T = K Q^T (rows: this thread's keys key_lo, key_lo + 8;
// columns: the 64 queries of the tile at q0), the row statistic lse2 (lse
// times log2(e)) a query; masked on the diagonal and past s only (edge)
__device__ __forceinline__ void probs_t(float (&sc)[kRows / 2], const float* lse2, int q0,
                                        int key_lo, int s, int causal, bool edge, int tq,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(&lse2[8 * j + 2 * tq]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = exp2f(fmaf(sc[4 * j + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
      if (edge) {
        const int qpos = q0 + 8 * j + 2 * tq + (e & 1), key = key_lo + 8 * (e >> 1);
        if (qpos >= s || (causal && key > qpos)) x = 0.f;
      }
      sc[4 * j + e] = x;
    }
  }
}

// dS^T = P^T (dP^T - delta), rounded to T, as the A fragments of dK += dS^T Q;
// p holds P^T already rounded to T (the fragments of dV += P^T dO)
template <typename T>
__device__ __forceinline__ void ds_frags(uint32_t (&dsf)[kRows / 16][4],
                                         const uint32_t (&pf)[kRows / 16][4],
                                         const float (&dp)[kRows / 2], const float* delta,
                                         int tq) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = 8 * kk + 2 * w;   // accumulator elements i, i + 1
      const float2 p = unpack2<T>(pf[kk][w]);
      const float2 dl = *reinterpret_cast<const float2*>(&delta[8 * (i / 4) + 2 * tq]);
      dsf[kk][w] = pack2<T>(p.x * (dp[i] - dl.x), p.y * (dp[i + 1] - dl.y));
    }
}

template <typename T, int D>
struct DkvSmem {
  T k[kBlockRows * D];             // the block's keys, [D / 64][128][64]
  T v[kBlockRows * D];
  T q[kStages<D>][kRows * D];      // streamed queries, [D / 64][64][64] a stage
  T dout[kStages<D>][kRows * D];
  float lse[kStages<D>][kRows];    // times log2(e)
  float delta[kStages<D>][kRows];
  uint64_t full[kStages<D>], empty[kStages<D>], kv_full;
};

// the dK/dV producer warp: the block's `keys` keys and values once, then Q,
// dO, lse and delta tile by tile, each stage once the consumers released it
template <int D, int S, typename T, typename Smem>
__device__ __forceinline__ void dkv_producer(Smem& sm, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             const CUtensorMap* tm_do,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, int keys, int k0,
                                             int bh, int qt0, int ntiles, int s, int lane) {
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * keys * D * sizeof(T));
    tma_load_rows<D>(sm.k, tm_k, keys, k0, bh, &sm.kv_full);
    tma_load_rows<D>(sm.v, tm_v, keys, k0, bh, &sm.kv_full);
  }
  const size_t rbase = (size_t)bh * s;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S, q0 = (qt0 + it) * kRows;
    if (it >= S) mbar_wait(&sm.empty[st], (it / S - 1) & 1);
    for (int r = lane; r < kRows; r += 32) {
      const bool in = q0 + r < s;
      sm.lse[st][r] = in ? lse[rbase + q0 + r] * kLog2e : 0.f;
      sm.delta[st][r] = in ? delta[rbase + q0 + r] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[st], 2 * kRows * D * sizeof(T));
      tma_load_rows<D>(sm.q[st], tm_q, kRows, q0, bh, &sm.full[st]);
      tma_load_rows<D>(sm.dout[st], tm_do, kRows, q0, bh, &sm.full[st]);
    } else {
      mbar_arrive(&sm.full[st]);
    }
  }
}

// dK/dV at D <= 128: block (128 keys, bh); the query tiles from the diagonal
// on stream through the ring.  Each consumer warpgroup computes, for its 64
// keys and a 64-query tile, S^T = K Q^T and dP^T = V dO^T (A = K / V, B =
// Q / dO, both from shared memory), then dV += P^T dO and dK += dS^T Q with
// P^T and dS^T from registers and B the same Q / dO tile read MN-major.
template <typename T, int D>
__device__ __forceinline__ void dkv_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, T* __restrict__ dk,
                                          T* __restrict__ dv, int s, int w, int causal,
                                          float scale) {
  constexpr int S = kStages<D>;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<T, D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;   // causal: low key blocks see the most query tiles
  const int qt0 = causal ? k0 / kRows : 0;
  const int ntiles = (s + kRows - 1) / kRows - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer warp's 32 arrivals (row statistics) and the TMA bytes
  init_ring<S>(sm.full, 32, sm.empty, &sm.kv_full, kConsumers);

  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;
    dkv_producer<D, S, T>(sm, tm_q, tm_k, tm_v, tm_do, lse, delta, kBlockRows, k0, bh, qt0,
                          ntiles, s, lane);
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int kw = k0 + wg * 64;                   // this warpgroup's first key
  const int key_lo = kw + (warp % 4) * 16 + g;   // this thread's keys: key_lo, key_lo + 8
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(&sm.kv_full, 0);
  __syncwarp();   // wgmma wants converged warps

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S, q0 = (qt0 + it) * kRows;
    const T* qt = sm.q[st];
    const T* dot = sm.dout[st];
    mbar_wait(&sm.full[st], (it / S) & 1);
    __syncwarp();
    // skipped: a causal tile wholly before this warpgroup's keys, and keys
    // all at or past s (never stored)
    if (kw < s && (!causal || q0 >= kw)) {
      float sc[kRows / 2], dp[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S^T = K Q^T
        wgmma_ss<T, 0, 0>(sc, kmajor(sm.k, kBlockRows, wg * 64, kk), kmajor(qt, kRows, 0, kk),
                          kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      probs_t(sc, sm.lse[st], q0, key_lo, s, causal, (causal && q0 == kw) || q0 + kRows > s,
              tq, scale_log2);
      uint32_t pf[kRows / 16][4];   // P^T rounded to T, used by both products
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V dO^T
        wgmma_ss<T, 0, 0>(dp, kmajor(sm.v, kBlockRows, wg * 64, kk), kmajor(dot, kRows, 0, kk),
                          kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dV += P^T dO
        wgmma_rs<T>(dv_acc, pf[kk], mnmajor(dot, kRows, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(dp);
      uint32_t dsf[kRows / 16][4];
      ds_frags<T>(dsf, pf, dp, sm.delta[st], tq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dK += dS^T Q
        wgmma_rs<T>(dk_acc, dsf[kk], mnmajor(qt, kRows, 16 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    mbar_arrive(&sm.empty[st]);
  }
  const size_t base = (size_t)bh * s * w;
  store_rows<T, D>(dk + base, dk_acc, key_lo, s, w, tq, scale);
  store_rows<T, D>(dv + base, dv_acc, key_lo, s, w, tq, 1.f);
}

template <typename T>
struct DkvSplitSmem {
  T k[kRows * 256];                  // the block's keys, [4][64][64]
  T v[kRows * 256];
  T q[kStages<256>][kRows * 256];    // streamed queries, [4][64][64] a stage
  T dout[kStages<256>][kRows * 256];
  float lse[kStages<256>][kRows];    // times log2(e)
  float delta[kStages<256>][kRows];
  uint64_t full[kStages<256>], empty[kStages<256>], kv_full;
};

// dK/dV at D = 256: block (64 keys, bh).  One warpgroup cannot hold both
// 64 x 256 f32 accumulators (256 registers a thread), so the two consumer
// warpgroups split the block's work: warpgroup 0 recomputes S^T = K Q^T and
// accumulates dV += P^T dO; warpgroup 1 recomputes S^T and dP^T = V dO^T and
// accumulates dK += dS^T Q.  Eight products a tile instead of seven; each
// output tile still comes from one block in a fixed order, and the numerics
// are those of D <= 128 (P^T rounded to T before both of its uses).
template <typename T>
__device__ __forceinline__ void dkv_split(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, T* __restrict__ dk,
                                          T* __restrict__ dv, int s, int w, int causal,
                                          float scale) {
  constexpr int D = 256, S = kStages<D>;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSplitSmem<T>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;   // causal: low key blocks see the most query tiles
  const int qt0 = causal ? k0 / kRows : 0;
  const int ntiles = (s + kRows - 1) / kRows - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<S>(sm.full, 32, sm.empty, &sm.kv_full, kConsumers);

  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers / 32) return;
    dkv_producer<D, S, T>(sm, tm_q, tm_k, tm_v, tm_do, lse, delta, kRows, k0, bh, qt0, ntiles,
                          s, lane);
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int key_lo = k0 + (warp % 4) * 16 + g;   // this thread's keys: key_lo, key_lo + 8
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];   // dV (warpgroup 0) or dK (warpgroup 1)
  zero(acc);
  mbar_wait(&sm.kv_full, 0);
  __syncwarp();   // wgmma wants converged warps

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S, q0 = (qt0 + it) * kRows;
    const T* qt = sm.q[st];
    const T* dot = sm.dout[st];
    mbar_wait(&sm.full[st], (it / S) & 1);
    __syncwarp();
    if (k0 < s) {   // keys all at or past s are never stored
      const bool edge = (causal && q0 == k0) || q0 + kRows > s;
      float sc[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S^T = K Q^T
        wgmma_ss<T, 0, 0>(sc, kmajor(sm.k, kRows, 0, kk), kmajor(qt, kRows, 0, kk), kk);
      wgmma_commit();
      uint32_t pf[kRows / 16][4];   // P^T rounded to T
      if (wg == 0) {
        wgmma_wait<0>();
        reg_fence(sc);
        probs_t(sc, sm.lse[st], q0, key_lo, s, causal, edge, tq, scale_log2);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)   // dV += P^T dO
          wgmma_rs<T>(acc, pf[kk], mnmajor(dot, kRows, 16 * kk), 1);
        wgmma_commit();
      } else {
        float dp[kRows / 2];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V dO^T
          wgmma_ss<T, 0, 0>(dp, kmajor(sm.v, kRows, 0, kk), kmajor(dot, kRows, 0, kk), kk);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(sc);
        probs_t(sc, sm.lse[st], q0, key_lo, s, causal, edge, tq, scale_log2);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
        wgmma_wait<0>();
        reg_fence(dp);
        uint32_t dsf[kRows / 16][4];
        ds_frags<T>(dsf, pf, dp, sm.delta[st], tq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)   // dK += dS^T Q
          wgmma_rs<T>(acc, dsf[kk], mnmajor(qt, kRows, 16 * kk), 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(&sm.empty[st]);
  }
  const size_t base = (size_t)bh * s * w;
  store_rows<T, D>((wg == 0 ? dv : dk) + base, acc, key_lo, s, w, tq, wg == 0 ? 1.f : scale);
}

template <typename T, int D>
__device__ __forceinline__ void dkv_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const float* lse, const float* delta, T* dk, T* dv,
                                         int s, int w, int causal, float scale) {
  if constexpr (D == 256)
    dkv_split<T>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, s, w, causal, scale);
  else
    dkv_wgmma<T, D>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, s, w, causal, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int s, int causal, float scale) {
  dkv_body<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, s, D, causal, scale);
}
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int s, int w, int causal, float scale) {
  dkv_body<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, s, w, causal, scale);
}

// dQ's consumer warpgroups, 64 queries each: two, one at D = 256 (its 128
// dQ accumulators and a two-stage ring of 64-key K and V tiles leave no
// room for a second warpgroup's queries in shared memory)
template <int D>
constexpr int kDqGroups = D == 256 ? 1 : 2;
template <int D>
constexpr int kDqRows = 64 * kDqGroups<D>;
template <int D>
constexpr int kDqThreads = 128 * (kDqGroups<D> + 1);

template <typename T, int D>
struct DqSmem {
  T q[kDqRows<D> * D];             // the block's queries, [D / 64][rows][64]
  T dout[kDqRows<D> * D];
  T k[kStages<D>][kRows * D];      // streamed keys, [D / 64][64][64] a stage
  T v[kStages<D>][kRows * D];
  uint64_t full[kStages<D>], empty[kStages<D>], qo_full;
};

// dQ: block (kDqRows queries, bh); the key tiles up to the diagonal stream
// through the ring.  Each consumer warpgroup computes, for its 64 queries
// and a 64-key tile, S = Q K^T and dP = dO V^T (both operands from shared
// memory), then dQ += dS K with dS from registers and K read MN-major.
template <typename T, int D>
__device__ __forceinline__ void dq_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dq,
                                         int s, int w, int causal, float scale) {
  constexpr int S = kStages<D>, G = kDqGroups<D>, ROWS = kDqRows<D>;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<T, D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // longest causal rows first
  int ntiles = (s + kRows - 1) / kRows;
  if (causal) ntiles = min(ntiles, (min(q0 + ROWS, s) - 1) / kRows + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer's one arrival and the TMA bytes
  init_ring<S>(sm.full, 1, sm.empty, &sm.qo_full, 128 * G);

  if (warp >= 4 * G) {
    if constexpr (G == 2) setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * G || lane != 0) return;
    // producer: the block's Q and dO once, then K and V tile by tile
    mbar_arrive_expect_tx(&sm.qo_full, 2 * ROWS * D * sizeof(T));
    tma_load_rows<D>(sm.q, tm_q, ROWS, q0, bh, &sm.qo_full);
    tma_load_rows<D>(sm.dout, tm_do, ROWS, q0, bh, &sm.qo_full);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % S;
      if (it >= S) mbar_wait(&sm.empty[st], (it / S - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], 2 * kRows * D * sizeof(T));
      tma_load_rows<D>(sm.k[st], tm_k, kRows, it * kRows, bh, &sm.full[st]);
      tma_load_rows<D>(sm.v[st], tm_v, kRows, it * kRows, bh, &sm.full[st]);
    }
    return;
  }

  // one consumer warpgroup (D = 256) has the registers of 256 threads to
  // itself and needs no setmaxnreg
  if constexpr (G == 2) setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int qw = q0 + wg * 64;                   // this warpgroup's first query
  const int row_lo = qw + (warp % 4) * 16 + g;   // this thread's rows: row_lo, row_lo + 8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    lse2[r] = row < s ? lse[(size_t)bh * s + row] * kLog2e : 0.f;
    dlt[r] = row < s ? delta[(size_t)bh * s + row] : 0.f;
  }
  float dq_acc[D / 2];
  zero(dq_acc);
  mbar_wait(&sm.qo_full, 0);
  __syncwarp();   // wgmma wants converged warps

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S, k0 = it * kRows;
    const T* kt = sm.k[st];
    const T* vt = sm.v[st];
    mbar_wait(&sm.full[st], (it / S) & 1);
    __syncwarp();
    // skipped: a causal tile wholly after this warpgroup's queries, and
    // queries all at or past s (never stored)
    if (qw < s && (!causal || k0 <= qw)) {
      float sc[kRows / 2], dp[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S = Q K^T
        wgmma_ss<T, 0, 0>(sc, kmajor(sm.q, ROWS, wg * 64, kk), kmajor(kt, kRows, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // dP = dO V^T
        wgmma_ss<T, 0, 0>(dp, kmajor(sm.dout, ROWS, wg * 64, kk), kmajor(vt, kRows, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sc);
      // P in f32, masked on the diagonal and past s only
      const bool edge = (causal && k0 == qw) || k0 + kRows > s;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int r = (i % 4) / 2;
        float x = exp2f(fmaf(sc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
          if (key >= s || (causal && key > row_lo + 8 * r)) x = 0.f;
        }
        sc[i] = x;
      }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) sc[i] *= dp[i] - dlt[(i % 4) / 2];   // dS
      uint32_t dsf[kRows / 16][4];   // dS rounded to T
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) frag_a<T>(dsf[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dQ += dS K
        wgmma_rs<T>(dq_acc, dsf[kk], mnmajor(kt, kRows, 16 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dq_acc);
    mbar_arrive(&sm.empty[st]);
  }
  store_rows<T, D>(dq + (size_t)bh * s * w, dq_acc, row_lo, s, w, tq, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads<D>, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int s, int causal, float scale) {
  dq_wgmma<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, s, D, causal, scale);
}
template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads<D>, 1)
dq_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq, int s, int w,
                       int causal, float scale) {
  dq_wgmma<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, s, w, causal, scale);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

dim3 tiles(int s, int bh, int rows, int slices = 1) {
  return dim3((s + rows - 1) / rows, bh, slices);
}

// the wide kernels' grid: row tiles, heads, output slices of kWideOut columns
dim3 wide_tiles(int s, int bh, int dg) {
  return tiles(s, bh, kWideRows, (dg + kWideOut - 1) / kWideOut);
}

// the T [bh, s, d] tensor at `base` as a 3-D map of [rows, 64] boxes
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int bh, int s, int d, int rows) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)s, (uint64_t)bh};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return encode_map<T>(map, base, 3, dims, box);
}

// the four operand maps of a backward kernel: q and dout in boxes of
// q_rows, k and v in boxes of k_rows
template <typename T>
struct BwdMaps {
  CUtensorMap q, k, v, dout;
  bool ok;
  BwdMaps(const void* q_, const void* k_, const void* v_, const void* do_, int bh, int s, int d,
          int q_rows, int k_rows)
      : ok(encode_rows<T>(&q, q_, bh, s, d, q_rows) && encode_rows<T>(&k, k_, bh, s, d, k_rows) &&
           encode_rows<T>(&v, v_, bh, s, d, k_rows) &&
           encode_rows<T>(&dout, do_, bh, s, d, q_rows)) {}
};

// the three operand maps of the forward: q in boxes of q_rows, k and v in
// boxes of k_rows
template <typename T>
struct FwdMaps {
  CUtensorMap q, k, v;
  bool ok;
  FwdMaps(const void* q_, const void* k_, const void* v_, int bh, int s, int d, int q_rows,
          int k_rows)
      : ok(encode_rows<T>(&q, q_, bh, s, d, q_rows) && encode_rows<T>(&k, k_, bh, s, d, k_rows) &&
           encode_rows<T>(&v, v_, bh, s, d, k_rows)) {}
};

// Each launcher runs the kernels of compute width D (64, 128 or 256) on
// tensors of stored width dg <= D: the columns from dg to D are zero in
// shared memory (the loads fill them, TMA past the map's last column), add
// nothing to a score, and are never stored.  The scale is that of head_dim,
// the real head before the entry point padded it to dg.  A bf16 or f16
// kernel of width D has its own entry point for dg < D.  D = kWide runs the
// wide kernels, for any dg above 256, in every dtype.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int s, int dg, int head_dim, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)head_dim);
  if constexpr (D == kWide) {
    return launch(fwd_wide_kernel<T>, kThreads,
                  (2 * kWidePieceFloats + kWideOutFloats + kWideScoreFloats) * sizeof(float),
                  wide_tiles(s, bh, dg), stream, (const T*)q, (const T*)k, (const T*)v, (T*)o,
                  (float*)lse, s, dg, causal, scale);
  } else if constexpr (std::is_same<T, float>::value) {
    constexpr int R = kFR<D>;
    return launch(fwd_kernel<D>, kThreads, (3 * R * (D + 1) + R * (R + 1)) * sizeof(float),
                  tiles(s, bh, R), stream, (const float*)q, (const float*)k, (const float*)v,
                  (float*)o, (float*)lse, s, dg, causal, scale);
  } else {
    const FwdMaps<T> maps(q, k, v, bh, s, dg, kFwdRows<D>, kFwdKeys<D>);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = sizeof(FwdSmem<T, D>) + 1024;
    const dim3 grid = tiles(s, bh, kFwdRows<D>);
    if (dg == D)
      return launch(fwd_wgmma_kernel<T, D>, kFwdThreads<D>, smem, grid, stream, maps.q, maps.k,
                    maps.v, (T*)o, (float*)lse, s, causal, scale);
    return launch(fwd_wgmma_narrow_kernel<T, D>, kFwdThreads<D>, smem, grid, stream, maps.q,
                  maps.k, maps.v, (T*)o, (float*)lse, s, dg, causal, scale);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int s, int dg, int head_dim, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)head_dim);
  if constexpr (D == kWide) {
    return launch(dkv_wide_kernel<T>, kThreads,
                  (2 * kWidePieceFloats + 2 * kWideOutFloats + 2 * kWideScoreFloats +
                   2 * kWideRows) * sizeof(float),
                  wide_tiles(s, bh, dg), stream, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s, dg,
                  causal, scale);
  } else if constexpr (std::is_same<T, float>::value) {
    constexpr int R = kFR<D>;
    return launch(dkv_kernel<D>, kThreads,
                  (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R) * sizeof(float),
                  tiles(s, bh, R), stream, (const float*)q, (const float*)k,
                  (const float*)v, (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dk, (float*)dv, s, dg, causal, scale);
  } else {
    constexpr int keys = D == 256 ? kRows : kBlockRows;
    const BwdMaps<T> maps(q, k, v, dout, bh, s, dg, kRows, keys);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = (D == 256 ? sizeof(DkvSplitSmem<T>) : sizeof(DkvSmem<T, D>)) + 1024;
    const dim3 grid = tiles(s, bh, keys);
    if (dg == D)
      return launch(dkv_wgmma_kernel<T, D>, kBwdThreads, smem, grid, stream, maps.q, maps.k,
                    maps.v, maps.dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                    s, causal, scale);
    return launch(dkv_wgmma_narrow_kernel<T, D>, kBwdThreads, smem, grid, stream, maps.q,
                  maps.k, maps.v, maps.dout, (const float*)lse, (const float*)delta, (T*)dk,
                  (T*)dv, s, dg, causal, scale);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s,
                      int dg, int head_dim, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)head_dim);
  if constexpr (D == kWide) {
    return launch(dq_wide_kernel<T>, kThreads,
                  (2 * kWidePieceFloats + kWideOutFloats + kWideScoreFloats + 2 * kWideRows) *
                      sizeof(float),
                  wide_tiles(s, bh, dg), stream, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, s, dg, causal,
                  scale);
  } else if constexpr (std::is_same<T, float>::value) {
    constexpr int R = kFR<D>;
    return launch(dq_kernel<D>, kThreads,
                  (4 * R * (D + 1) + R * (R + 1) + 2 * R) * sizeof(float),
                  tiles(s, bh, R), stream, (const float*)q, (const float*)k,
                  (const float*)v, (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dq, s, dg, causal, scale);
  } else {
    const BwdMaps<T> maps(q, k, v, dout, bh, s, dg, kDqRows<D>, kRows);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = sizeof(DqSmem<T, D>) + 1024;
    const dim3 grid = tiles(s, bh, kDqRows<D>);
    if (dg == D)
      return launch(dq_wgmma_kernel<T, D>, kDqThreads<D>, smem, grid, stream, maps.q, maps.k,
                    maps.v, maps.dout, (const float*)lse, (const float*)delta, (T*)dq, s,
                    causal, scale);
    return launch(dq_wgmma_narrow_kernel<T, D>, kDqThreads<D>, smem, grid, stream, maps.q,
                  maps.k, maps.v, maps.dout, (const float*)lse, (const float*)delta, (T*)dq, s,
                  dg, causal, scale);
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; d, the stored width, a
// multiple of 8, runs at compute width 64, 128 or 256, or on the wide kernels
// above 256; head_dim (1 to d) sets the scale
#define BY_WIDTH(T, d, CALL)                                                      \
  (d <= 64 ? CALL(T, 64) : d <= 128 ? CALL(T, 128) : d <= 256 ? CALL(T, 256)      \
                                                              : CALL(T, kWide))
#define DISPATCH(dtype, d, CALL)                                                  \
  do {                                                                            \
    if (bh < 1 || s < 1 || bh > 65535 || d < 8 || d % 8 ||                        \
        (d + kWideOut - 1) / kWideOut > 65535 || head_dim < 1 || head_dim > d)    \
      return (int)cudaErrorInvalidValue;                                          \
    if (dtype == 0) return (int)BY_WIDTH(float, d, CALL);                         \
    if (dtype == 1) return (int)BY_WIDTH(bf16, d, CALL);                          \
    if (dtype == 2) return (int)BY_WIDTH(f16, d, CALL);                           \
    return (int)cudaErrorInvalidValue;                                            \
  } while (0)

}  // namespace

extern "C" {

int bagua_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int bh, int s, int d, int head_dim, int dtype, int causal, void* stream) {
#define CALL(T, D) \
  launch_fwd<T, D>(q, k, v, o, lse, bh, s, d, head_dim, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int bh,
                        int s, int d, int head_dim, int dtype, int causal, void* stream) {
#define CALL(T, D)                                                                         \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, head_dim, causal,          \
                   (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int bh, int s, int d,
                       int head_dim, int dtype, int causal, void* stream) {
#define CALL(T, D)                                                                         \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, s, d, head_dim, causal,               \
                  (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

}  // extern "C"
