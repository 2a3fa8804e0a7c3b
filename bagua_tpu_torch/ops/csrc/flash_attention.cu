// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels of bagua_tpu/ops/flash_attention.py:
//   bagua_flash_fwd     <- _fwd          (pallas_call :119, _fwd_kernel :61-110)
//   bagua_flash_bwd_dkv <- _bwd dK/dV    (pallas_call :274, _bwd_dkv_kernel :150-201)
//   bagua_flash_bwd_dq  <- _bwd dQ       (pallas_call :291, _bwd_dq_kernel :204-247)
//
// Layout: q, k, v, o, do, dq, dk, dv are [bh, s, D] row-major in T (float or
// bf16); lse and delta are [bh, s] float.  D is 64 or 128.  Any s >= 1 is
// taken: keys at or past s are masked out and rows at or past s are never
// written, so ragged sequences need no padding by the caller.
//
// What bounds them on an H100: at the model's shapes (s = 4096, D = 64,
// causal) each kernel does 2-3 x 10^10 multiply-adds on ~17 MB per operand,
// far above the card's ~295 flop/byte ridge, so all three are bound by
// arithmetic.  The TPU kernels keep whole-sequence K/V (forward, dQ) or Q/dO
// (dK/dV) resident in VMEM; at s = 4096 that is over 1 MiB, far above the
// 227 KB a block can hold, so here every operand is streamed through shared
// memory one 64-row tile at a time, and the [s, s] score matrix only ever
// exists as one 64 x 64 tile.
//
// Design (FlashAttention-2 order, a simple first version): one block per
// (64-row tile, batch*head).  The forward and dQ blocks loop over k tiles up
// to the diagonal, the dK/dV blocks over q tiles from the diagonal on.  Blocks
// never depend on each other: the TPU grid's in-order carry is a loop inside
// the block, and each output tile is written by exactly one block, so no
// atomics are needed.  Causal blocks with the most work are launched first.
//
// bf16 (the training path) runs on the tensor cores: four warps of
// mma.sync.m16n8k16 with f32 accumulation, each warp owning 16 rows, scores
// and P kept in registers.  wgmma, TMA and a pipelined ring of tiles are left
// to a later version.  f32 (kept for precision checks) has no tensor-core
// format of full precision, so it runs 256 threads of FP32 FMAs from shared
// memory, each thread owning a 4 x 4 piece of the 64 x 64 score tile.
//
// Numerics follow the TPU kernels: softmax state in f32, masking with -1e30
// (not -inf) and l clamped at 1e-30; in bf16, P is rounded before P.V and in
// the dK/dV pass, and dS before its products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over a 64 x 64 tile
constexpr int kPS = kTile + 1; // padded row stride of a score tile
constexpr float kNegInf = -1e30f;

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

// rows [row0, row0 + 64) of a [s, D] matrix -> shared tile of stride D + 1,
// zero past s
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int s) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? src[(size_t)row * D + c] : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < s ? src[row0 + r] : 0.f;
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P'[ty + 16 i][c] * X[c][tx + 16 j], where P' is the
// score tile P (row = q, column = k) or, with TRANS, its transpose
template <int D, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16], const float* P,
                                         const float* X, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? P[c * kPS + ty + 16 * i] : P[(ty + 16 * i) * kPS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, float (&acc)[4][D / 16],
                                           int row0, int s, int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[(size_t)row * D + tx + 16 * j] = acc[i][j] * mul;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernels.  forward: block (q tile, bh), k tiles up to the diagonal
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, int s, int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sQ, q + base, q0, s);
  int nkb = (s + kTile - 1) / kTile;
  if (causal) nkb = min(nkb, qb + 1);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's sK/sV/sP readers are done
    load_tile<D>(sK, k + base, k0, s);
    load_tile<D>(sV, v + base, k0, s);
    __syncthreads();
    float sc[4][4];
    dot_tile<D>(sc, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    acc_tile<D, false>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float li = fmaxf(l[i], 1e-30f);
    if (row < s) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        o[base + (size_t)row * D + tx + 16 * j] = acc[i][j] / li;
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
           int s, int causal, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sdS = sP + kTile * kPS;
  float* sL = sdS + kTile * kPS;
  float* sDelta = sL + kTile;

  const int kb = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int k0 = kb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sK, k + base, k0, s);
  load_tile<D>(sV, v + base, k0, s);
  const int nqb = (s + kTile - 1) / kTile;
  const int qb_start = causal ? kb : 0;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb_start; qb < nqb; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile<D>(sQ, q + base, q0, s);
    load_tile<D>(sdO, dout + base, q0, s);
    load_rows(sL, lse + rbase, q0, s);
    load_rows(sDelta, delta + rbase, q0, s);
    __syncthreads();
    float sc[4][4], dp[4][4];
    dot_tile<D>(sc, sQ, sK, ty, tx);    // rows q, columns k
    dot_tile<D>(dp, sdO, sV, ty, tx);   // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sP[r * kPS + c] = p;
        sdS[r * kPS + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    acc_tile<D, true>(dv_acc, sP, sdO, ty, tx);   // dV += P^T dO
    acc_tile<D, true>(dk_acc, sdS, sQ, ty, tx);   // dK += dS^T Q
  }
  store_tile<D>(dk + base, dk_acc, k0, s, ty, tx, scale);
  store_tile<D>(dv + base, dv_acc, k0, s, ty, tx, 1.f);
}

// ---------------------------------------------------------------------------
// dQ: block (q tile, bh); loop over k tiles up to the diagonal
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int s, int causal,
          float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sdS = sV + kTile * (D + 1);
  float* sL = sdS + kTile * kPS;
  float* sDelta = sL + kTile;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sQ, q + base, q0, s);
  load_tile<D>(sdO, dout + base, q0, s);
  load_rows(sL, lse + rbase, q0, s);
  load_rows(sDelta, delta + rbase, q0, s);
  int nkb = (s + kTile - 1) / kTile;
  if (causal) nkb = min(nkb, qb + 1);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile<D>(sK, k + base, k0, s);
    load_tile<D>(sV, v + base, k0, s);
    __syncthreads();
    float sc[4][4], dp[4][4];
    dot_tile<D>(sc, sQ, sK, ty, tx);
    dot_tile<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = qpos < s && kpos < s && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[i][j] * scale - sL[r]) : 0.f;
        sdS[r * kPS + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    acc_tile<D, false>(dq_acc, sdS, sK, ty, tx);  // dQ += dS K
  }
  store_tile<D>(dq + base, dq_acc, q0, s, ty, tx, scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, f32 accumulation)
//
// 128 threads: four warps, each owning 16 rows of the 64-row tile.  Tiles
// sit in shared memory as bf16 with rows padded to D + 8 elements, so the
// fragment loads of a warp hit 32 distinct banks.  Scores, P and dS never
// leave registers: an m16n8k16 accumulator pair is exactly the A operand of
// the next product (the FlashAttention-2 register layout).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + 64) of a [s, D] bf16 matrix -> shared tile of stride
// D + 8, 16 bytes per thread per step, zero past s
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int row0, int s) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kMmaThreads) {
    const int r = idx / kVecs, c = idx % kVecs, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < s) val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

// fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   C 16x8:  c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix of the 16 x 16 region at p (row stride ld) as four 8 x 8
// matrices: r0 rows 0-7 / cols 0-7, r1 rows 8-15 / cols 0-7, r2 rows 0-7 /
// cols 8-15, r3 rows 8-15 / cols 8-15 (lane l addresses row l % 16, column
// block l / 16).  With TRANS each 8 x 8 matrix arrives transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  const uint32_t addr = smem_addr(p + (lane % 16) * ld + (lane / 16) * 8);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the A operand for columns [16 j, 16 j + 16) of an accumulator row block
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[8][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// acc[nt] = sum_k A[16 rows of warp][k] * Bt[nt * 8 + n][k] over k < D: the
// 16 x 64 product of the warp's rows of `a_tile` with the rows of `b_tile`
template <int D>
__device__ __forceinline__ void mma_rows_x_rows(float (&acc)[8][4], const bf16* a_tile,
                                                const bf16* b_tile, int wr, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4<false>(a, a_tile + wr * ld + kk * 16, ld, lane);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      // rows n of b_tile, columns k: B fragments of n tiles nt and nt + 1
      uint32_t r[4];
      ldsm_x4<false>(r, b_tile + nt * 8 * ld + kk * 16, ld, lane);
      const uint32_t b0[2] = {r[0], r[2]}, b1[2] = {r[1], r[3]};
      mma_bf16(acc[nt], a, b0);
      mma_bf16(acc[nt + 1], a, b1);
    }
  }
}

// acc[nt] += P (16 x 64, accumulator layout) x tile (64 x D)
template <int D>
__device__ __forceinline__ void mma_acc_x_tile(float (&acc)[D / 8][4], const float (&p)[8][4],
                                               const bf16* tile, int lane) {
  constexpr int ld = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4];
    acc_to_a(a, p, j);
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      // rows k of the tile, columns n, transposed: n tiles nt and nt + 1
      uint32_t r[4];
      ldsm_x4<true>(r, tile + j * 16 * ld + nt * 8, ld, lane);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[nt], a, b0);
      mma_bf16(acc[nt + 1], a, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_acc_bf16(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                               int row0, int s, int g, int tq, float mul0,
                                               float mul1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float mul = r ? mul1 : mul0;
    if (row >= s) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + nt * 8 + 2 * tq) =
          pack_bf16(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int s, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int ld = D + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_bytes);
  bf16* sK = sQ + kTile * ld;
  bf16* sV = sK + kTile * ld;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_tile_bf16<D>(sQ, q + base, q0, s);
  int nkb = (s + kTile - 1) / kTile;
  if (causal) nkb = min(nkb, qb + 1);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile_bf16<D>(sK, k + base, k0, s);
    load_tile_bf16<D>(sV, v + base, k0, s);
    __syncthreads();
    float sc[8][4];
    mma_rows_x_rows<D>(sc, sQ, sK, wr, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, key = k0 + nt * 8 + 2 * tq + (e % 2);
        float x = sc[nt][e] * scale;
        if (key >= s || (causal && key > rows[r])) x = kNegInf;
        sc[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e / 2]);
        l[e / 2] += p;   // this thread's part of the row sum, reduced at the end
        sc[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e / 2];
    mma_acc_x_tile<D>(acc, sc, sV, lane);   // O += P V, P rounded to bf16
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float li = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / li;
    if (tq == 0 && rows[r] < s) lse[(size_t)blockIdx.y * s + rows[r]] = m[r] + logf(li);
  }
  store_acc_bf16<D>(o + base, acc, q0 + wr, s, g, tq, inv[0], inv[1]);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int causal,
               float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int ld = D + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem_bytes);
  bf16* sV = sK + kTile * ld;
  bf16* sQ = sV + kTile * ld;
  bf16* sdO = sQ + kTile * ld;
  float* sL = reinterpret_cast<float*>(sdO + kTile * ld);
  float* sDelta = sL + kTile;

  const int kb = blockIdx.x;  // causal: low k tiles see the most q tiles
  const int k0 = kb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};

  load_tile_bf16<D>(sK, k + base, k0, s);
  load_tile_bf16<D>(sV, v + base, k0, s);
  const int nqb = (s + kTile - 1) / kTile;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  for (int qb = causal ? kb : 0; qb < nqb; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile_bf16<D>(sQ, q + base, q0, s);
    load_tile_bf16<D>(sdO, dout + base, q0, s);
    for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
      sL[r] = q0 + r < s ? lse[rbase + q0 + r] : 0.f;
      sDelta[r] = q0 + r < s ? delta[rbase + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the tile's queries
    float p[8][4], ds[8][4];
    mma_rows_x_rows<D>(p, sK, sQ, wr, lane);     // S^T = K Q^T
    mma_rows_x_rows<D>(ds, sV, sdO, wr, lane);   // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e / 2], qi = nt * 8 + 2 * tq + (e % 2), qpos = q0 + qi;
        const bool valid = qpos < s && key < s && (!causal || key <= qpos);
        const float pe = valid ? round_bf16(expf(p[nt][e] * scale - sL[qi])) : 0.f;
        p[nt][e] = pe;
        ds[nt][e] = pe * (ds[nt][e] - sDelta[qi]);
      }
    mma_acc_x_tile<D>(dv_acc, p, sdO, lane);    // dV += P^T dO
    mma_acc_x_tile<D>(dk_acc, ds, sQ, lane);    // dK += dS^T Q, dS rounded
  }
  store_acc_bf16<D>(dk + base, dk_acc, k0 + wr, s, g, tq, scale, scale);
  store_acc_bf16<D>(dv + base, dv_acc, k0 + wr, s, g, tq, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int s, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int ld = D + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_bytes);
  bf16* sdO = sQ + kTile * ld;
  bf16* sK = sdO + kTile * ld;
  bf16* sV = sK + kTile * ld;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * s * D;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = rows[r] < s ? lse[rbase + rows[r]] : 0.f;
    row_delta[r] = rows[r] < s ? delta[rbase + rows[r]] : 0.f;
  }

  load_tile_bf16<D>(sQ, q + base, q0, s);
  load_tile_bf16<D>(sdO, dout + base, q0, s);
  int nkb = (s + kTile - 1) / kTile;
  if (causal) nkb = min(nkb, qb + 1);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile_bf16<D>(sK, k + base, k0, s);
    load_tile_bf16<D>(sV, v + base, k0, s);
    __syncthreads();
    float sc[8][4], dp[8][4];
    mma_rows_x_rows<D>(sc, sQ, sK, wr, lane);    // S = Q K^T
    mma_rows_x_rows<D>(dp, sdO, sV, wr, lane);   // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, key = k0 + nt * 8 + 2 * tq + (e % 2);
        const bool valid = rows[r] < s && key < s && (!causal || key <= rows[r]);
        const float p = valid ? expf(sc[nt][e] * scale - row_lse[r]) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - row_delta[r]);
      }
    mma_acc_x_tile<D>(acc, sc, sK, lane);   // dQ += dS K, dS rounded
  }
  store_acc_bf16<D>(dq + base, acc, q0 + wr, s, g, tq, scale, scale);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int bh, int s,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kTile - 1) / kTile, bh);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
constexpr size_t bf16_tiles(int n) { return (size_t)n * kTile * (D + 8) * sizeof(bf16); }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int s, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(fwd_mma_kernel<D>, kMmaThreads, bf16_tiles<D>(3), bh, s, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
                  s, causal, scale);
  else
    return launch(fwd_kernel<D>, kThreads,
                  (3 * kTile * (D + 1) + kTile * kPS) * sizeof(float), bh, s, stream,
                  (const float*)q, (const float*)k, (const float*)v, (float*)o,
                  (float*)lse, s, causal, scale);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int s, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(dkv_mma_kernel<D>, kMmaThreads,
                  bf16_tiles<D>(4) + 2 * kTile * sizeof(float), bh, s, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, s,
                  causal, scale);
  else
    return launch(dkv_kernel<D>, kThreads,
                  (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * sizeof(float),
                  bh, s, stream, (const float*)q, (const float*)k, (const float*)v,
                  (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dk, (float*)dv, s, causal, scale);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s,
                      int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(dq_mma_kernel<D>, kMmaThreads, bf16_tiles<D>(4), bh, s, stream,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dq, s, causal, scale);
  else
    return launch(dq_kernel<D>, kThreads,
                  (4 * kTile * (D + 1) + kTile * kPS + 2 * kTile) * sizeof(float), bh,
                  s, stream, (const float*)q, (const float*)k, (const float*)v,
                  (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dq, s, causal, scale);
}

// dtype: 0 = float32, 1 = bfloat16
#define DISPATCH(dtype, d, CALL)                                        \
  do {                                                                  \
    if (bh < 1 || s < 1 || bh > 65535) return (int)cudaErrorInvalidValue; \
    if (dtype == 0 && d == 64) return (int)CALL(float, 64);             \
    if (dtype == 0 && d == 128) return (int)CALL(float, 128);           \
    if (dtype == 1 && d == 64) return (int)CALL(__nv_bfloat16, 64);     \
    if (dtype == 1 && d == 128) return (int)CALL(__nv_bfloat16, 128);   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

extern "C" {

int bagua_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int bh, int s, int d, int dtype, int causal, void* stream) {
#define CALL(T, D) launch_fwd<T, D>(q, k, v, o, lse, bh, s, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int bh,
                        int s, int d, int dtype, int causal, void* stream) {
#define CALL(T, D) \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int bh, int s, int d,
                       int dtype, int causal, void* stream) {
#define CALL(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, s, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

}  // extern "C"
