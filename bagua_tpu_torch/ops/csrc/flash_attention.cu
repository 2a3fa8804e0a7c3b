// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels of bagua_tpu/ops/flash_attention.py:
//   bagua_flash_fwd     <- _fwd          (pallas_call :119, _fwd_kernel :61-110)
//   bagua_flash_bwd_dkv <- _bwd dK/dV    (pallas_call :274, _bwd_dkv_kernel :150-201)
//   bagua_flash_bwd_dq  <- _bwd dQ       (pallas_call :291, _bwd_dq_kernel :204-247)
//
// Layout: q, k, v, o, do, dq, dk, dv are [bh, s, d] row-major in T (float or
// bf16); lse and delta are [bh, s] float.  d is a multiple of 8 up to 128:
// the kernels compute at width D = 64 (d <= 64) or 128, the columns past d
// zero in shared memory and never stored, so a narrow head costs the time of
// its D.  Any s >= 1 is taken: keys at or past s are masked out and rows at
// or past s are never written, so ragged sequences need no padding by the
// caller.
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
// Every bf16 kernel is warp-specialized wgmma fed by TMA through a
// three-stage mbarrier ring: a producer warp streams one operand pair into
// the ring while two consumer warpgroups run wgmma on the tiles that have
// landed, so loads overlap the products; every score product takes both
// operands from shared memory, and every product after it takes P or dS
// from registers, its B operand being a streamed tile read MN-major.  The
// forward (a block owns 192 queries, three consumer warpgroups, at D = 64;
// 128 queries at D = 128) streams K and V in 128-key tiles, keeps the
// softmax state and O in registers, and issues a tile's S = Q K^T before O
// += P V of the tile before, so that its softmax runs beside that product
// (FlashAttention-3's order within a warpgroup); the tile size, the three
// warpgroups and that order were each chosen by timing the alternatives
// (PERF.md has the times; scripts/torch_flash_variants.py keeps the tile
// size and the order as variants to time again).  The backward is
// two kernels, the layout the TPU kernels have: dK/dV (a block owns 128
// keys) and dQ (a block owns 128 queries).  It is not fused into one kernel
// with an atomic f32 dQ (FlashAttention-3): that would do 5 products instead
// of these 7, but the sum order of dQ would change from run to run, and
// every kernel of the port writes each output tile from one block in a fixed
// order.
//
// f32 (kept for precision checks, on no training path) has no tensor-core
// format of full precision, so it runs 256 threads of FP32 FMAs from shared
// memory, each thread owning a 4 x 4 piece of the 64 x 64 score tile.
//
// Numerics follow the TPU kernels: softmax state in f32, masking with -1e30
// (not -inf) and l clamped at 1e-30; in bf16, P is rounded before P.V and in
// the dK/dV pass, and dS before its products.

#include <cuda.h>
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

// rows [row0, row0 + 64) of a [s, dg] matrix -> shared tile of D columns
// and stride D + 1, zero past s and past dg
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int s, int dg) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < s && c < dg ? src[(size_t)row * dg + c] : 0.f;
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

// the rows below s and columns below dg of a 64 x D accumulator, times mul,
// into a [s, dg] matrix
template <int D>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, float (&acc)[4][D / 16],
                                           int row0, int s, int dg, int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      if (tx + 16 * j < dg) dst[(size_t)row * dg + tx + 16 * j] = acc[i][j] * mul;
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
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * s * dg;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sQ, q + base, q0, s, dg);
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
    load_tile<D>(sK, k + base, k0, s, dg);
    load_tile<D>(sV, v + base, k0, s, dg);
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
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sK, k + base, k0, s, dg);
  load_tile<D>(sV, v + base, k0, s, dg);
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
    load_tile<D>(sQ, q + base, q0, s, dg);
    load_tile<D>(sdO, dout + base, q0, s, dg);
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
  store_tile<D>(dk + base, dk_acc, k0, s, dg, ty, tx, scale);
  store_tile<D>(dv + base, dv_acc, k0, s, dg, ty, tx, 1.f);
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
  const size_t base = (size_t)blockIdx.y * s * dg;
  const size_t rbase = (size_t)blockIdx.y * s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sQ, q + base, q0, s, dg);
  load_tile<D>(sdO, dout + base, q0, s, dg);
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
    load_tile<D>(sK, k + base, k0, s, dg);
    load_tile<D>(sV, v + base, k0, s, dg);
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
  store_tile<D>(dq + base, dq_acc, q0, s, dg, ty, tx, scale);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier-guarded ring
//
// A block owns 128 rows (queries for the forward and dQ, keys for dK/dV):
// two consumer warpgroups of 64 rows each, and a producer warpgroup of which
// one warp works.  The producer loads the block's own rows once, then streams
// the other operand pair tile by tile through a ring of kStages shared-memory
// stages, each guarded by a "full" and an "empty" mbarrier, while the
// consumers run wgmma on the stages that have landed.  Every tile is one
// [rows, 64] TMA box per 64-column half in the 128-byte swizzle (a D = 64
// bf16 row is exactly 128 bytes), the layout the wgmma descriptors below
// read.  Rows at or past s and columns at or past d arrive as zeros: the
// tensor maps are [bh, s, d], so a head's last partial tile never reads the
// next head's rows, and a head narrower than D is widened in shared memory.
//
// Scores and their gradients stay in registers.  The accumulator of a score
// product is, rounded to bf16, the register A operand of the next product
// (a thread's accumulator elements of a 16-column step are the elements of
// its A fragment for that k step), so P and dS never pass through shared
// memory.
//
// Budget (backward, D = 64): a consumer thread holds the f32 dK and dV
// accumulators (64 registers) beside S and dP (32 each), about 140
// registers in all.  Two blocks on an SM, each with a producer warp, leave
// 96 registers a thread, and both kernels then spill (PERF.md has the
// times of that layout).  So a block has the SM to itself: 384 threads at
// 168 registers each, the producer's warpgroup handing its registers to the
// consumers with setmaxnreg (24 and 240), which also holds D = 128's 128
// accumulator registers without a spill.  Shared memory: 84 KB a block at D = 64, 165 KB
// at D = 128.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;             // rows of a streamed backward tile (one stage)
constexpr int kBlockRows = 128;       // rows a block owns: two warpgroups of 64
constexpr int kStages = 3;            // depth of the ring
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kBwdThreads = kConsumers + 128;   // and the producer's warpgroup
constexpr int kProducerRegs = 24;     // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;    // (3 x 168 = 24 + 2 x 240 per SM sub-partition)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary of shared memory at or after p (the
// 128-byte swizzle repeats every 1024 bytes, and the descriptors assume it
// starts on one)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` more that the phase waits for from TMA
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: rows [row0, row0 + rows) of head bh of a [bh, s, d] tensor into dst,
// one [rows, 64] box per 64-column half, completing on `bar`
template <int D>
__device__ __forceinline__ void tma_load_rows(bf16* dst, const CUtensorMap* map, int rows,
                                              int row0, int bh, uint64_t* bar) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst + h * rows * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(h * 64), "r"(row0), "r"(bh),
        "r"(smem_u32(bar))
        : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
// K-major operand: rows from r0 of a tile of `rows` rows, reduction columns
// [16 kk, 16 kk + 16): 8-row groups 1024 bytes apart, the k step 32 bytes
// into the swizzled 128-byte row of its 64-column half
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int rows, int r0, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 64 + r0 * 64 + (kk % 4) * 16, 16, 1024);
}
// MN-major operand (the tile's rows are the reduction dimension): rows
// [r0, r0 + 16) by all D columns: 8-row groups 1024 bytes apart, the
// 64-column halves rows * 128 bytes apart
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int rows, int r0) {
  return sw128_desc(tile + r0 * 64, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to registers across a wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma.m64nNk16 bf16 -> f32 on the accumulator d (N / 2 registers a
// thread: element 4 j + e is row 16 warp + lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2), N = 64 or 128 by the size of d.  wgmma_ss: A
// and B from shared memory, both K-major, d overwritten when acc is 0.
// wgmma_rs: A from registers, B MN-major, added to d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand of k step kk (columns [16 kk, 16 kk + 16)) from an
// accumulator, rounded to bf16
template <int R>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&c)[R], int kk) {
#pragma unroll
  for (int w = 0; w < 4; ++w) a[w] = pack_bf16(c[8 * kk + 2 * w], c[8 * kk + 2 * w + 1]);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// rows `row` and `row + 8` of an m64nD accumulator, times mul, into a bf16
// [s, dg] matrix; rows at or past s and columns at or past dg (a multiple of
// 8) are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           int row, int s, int dg, int tq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < dg)
        *reinterpret_cast<uint32_t*>(dst + (size_t)(row + 8 * r) * dg + 8 * j + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, int full_count, uint64_t* empty,
                                          uint64_t* once, int empty_count = kConsumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], full_count);
      mbar_init(&empty[i], empty_count);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16 forward: block (64 x kFwdGroups queries, bh); the 128-key tiles up to
// the diagonal stream through the ring.  Each consumer warpgroup computes,
// for its 64 queries and a key tile, S = Q K^T (A = Q, B = K, both from
// shared memory), the online softmax of S in registers, and O += P V with P
// from registers and V read MN-major.  S of a tile is issued before O += P V
// of the tile before it, and its softmax runs while that product is on the
// tensor cores (FlashAttention-3's order within a warpgroup).  What bounds
// the forward here is the softmax beside the products: its exp2 and its
// three FP32 instructions a score take about as long as the two products, so
// the design is about keeping the tensor cores busy while it runs.
// ---------------------------------------------------------------------------

// keys of a streamed forward tile: S is one m64n128 product a warpgroup,
// with half the barriers and softmax steps a key of 64-key tiles
constexpr int kFwdKeys = 128;
// consumer warpgroups of a block, 64 queries each, beside the producer's
// warpgroup: three at D = 64 (each K/V tile loaded serves 192 queries, and
// three warps a sub-partition hide each other's softmax), two at D = 128,
// whose 64 O accumulators a thread leave no room for a third.  The
// producer keeps 24 registers a thread and the consumers share the rest (a
// sub-partition's 16384: 32 x 24 + 3 x 32 x 160, or 32 x 24 + 2 x 32 x 240)
template <int D>
constexpr int kFwdGroups = D == 64 ? 3 : 2;
template <int D>
constexpr int kFwdRows = 64 * kFwdGroups<D>;
template <int D>
constexpr int kFwdThreads = 128 * (kFwdGroups<D> + 1);
template <int D>
constexpr int kFwdConsumerRegs = kFwdGroups<D> == 2 ? 240 : 160;

template <int D>
struct FwdSmem {
  bf16 q[kFwdRows<D> * D];                   // the block's queries, [D / 64][rows][64]
  bf16 k[kStages][kFwdKeys * D];       // streamed keys, [D / 64][keys][64] a stage
  bf16 v[kStages][kFwdKeys * D];
  uint64_t full[kStages], empty[kStages], q_full;
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
template <int D, int KEYS>
__device__ __forceinline__ void issue_qk(float (&sc)[KEYS / 2], const bf16* q, int wg,
                                         const bf16* kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc, kmajor(q, kFwdRows<D>, wg * 64, kk), kmajor(kt, KEYS, 0, kk), kk);
  wgmma_commit();
}

// O += P V, P the bf16 A fragments of a key tile, issued and committed
template <int D, int KEYS>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[KEYS / 16][4],
                                         const bf16* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) wgmma_rs(o, pf[kk], mnmajor(vt, KEYS, 16 * kk), 1);
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
template <int D>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, bf16* __restrict__ o,
                                          float* __restrict__ lse, int s, int w, int causal,
                                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows<D>;   // longest causal rows first
  int ntiles = (s + kFwdKeys - 1) / kFwdKeys;
  if (causal) ntiles = min(ntiles, (min(q0 + kFwdRows<D>, s) - 1) / kFwdKeys + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer's one arrival and the TMA bytes
  init_ring(sm.full, 1, sm.empty, &sm.q_full, 128 * kFwdGroups<D>);

  if (warp >= 4 * kFwdGroups<D>) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != 4 * kFwdGroups<D> || lane != 0) return;
    // producer: the block's Q once, then K and V tile by tile
    mbar_arrive_expect_tx(&sm.q_full, kFwdRows<D> * D * sizeof(bf16));
    tma_load_rows<D>(sm.q, tm_q, kFwdRows<D>, q0, bh, &sm.q_full);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], 2 * kFwdKeys * D * sizeof(bf16));
      tma_load_rows<D>(sm.k[st], tm_k, kFwdKeys, it * kFwdKeys, bh, &sm.full[st]);
      tma_load_rows<D>(sm.v[st], tm_v, kFwdKeys, it * kFwdKeys, bh, &sm.full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFwdConsumerRegs<D>));
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int qw = q0 + wg * 64;                   // this warpgroup's first query
  const int row_lo = qw + (warp % 4) * 16 + g;   // this thread's rows: row_lo, row_lo + 8
  const float scale_log2 = scale * kLog2e;
  // the tiles this warpgroup computes, a prefix of the stream: none when its
  // queries are all at or past s (never stored), and under causal none that
  // lies wholly after them.  Each such tile starts at or before qw, so no
  // row of a computed tile is masked whole.
  int own = qw < s ? ntiles : 0;
  if (causal && own > 0) own = min(own, (min(qw + 64, s) - 1) / kFwdKeys + 1);
  float o_acc[D / 2], sc[kFwdKeys / 2], corr[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pf[kFwdKeys / 16][4];   // P rounded to bf16: the A operand of O += P V
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
    issue_qk<D, kFwdKeys>(sc, sm.q, wg, sm.k[0]);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(sc, m, l, corr, 0, qw, row_lo, s, causal, tq, scale_log2);
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) frag_a(pf[kk], sc, kk);
  }
  for (int it = 1; it < own; ++it) {
    const int st = it % kStages, prev = (it - 1) % kStages;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    __syncwarp();
    issue_qk<D, kFwdKeys>(sc, sm.q, wg, sm.k[st]);
    issue_pv<D, kFwdKeys>(o_acc, pf, sm.v[prev]);
    wgmma_wait<1>();   // S
    reg_fence(sc);
    softmax(sc, m, l, corr, it * kFwdKeys, qw, row_lo, s, causal, tq, scale_log2);
    wgmma_wait<0>();   // O += P V
    reg_fence(o_acc);
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) reg_fence(pf[kk]);
    mbar_arrive(&sm.empty[prev]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i % 4) / 2];
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) frag_a(pf[kk], sc, kk);
  }
  if (own > 0) {
    const int last = (own - 1) % kStages;
    issue_pv<D, kFwdKeys>(o_acc, pf, sm.v[last]);
    wgmma_wait<0>();
    reg_fence(o_acc);
    mbar_arrive(&sm.empty[last]);
  }
  for (int it = own; it < ntiles; ++it) {
    mbar_wait(&sm.full[it % kStages], (it / kStages) & 1);
    mbar_arrive(&sm.empty[it % kStages]);
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
  store_rows<D>(o + (size_t)bh * s * w, o_acc, row_lo, s, w, tq, 1.f);
}

// Two entry points a kernel: one for heads of width D, with the stored width
// fixed at compile time, and one for narrower heads that reads it at run
// time.  The full-width one keeps no head-dim argument: with one (even
// unused), dQ ran 4-5% slower at D = 64.
template <int D>
__global__ void __launch_bounds__(kFwdThreads<D>, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int s, int causal, float scale) {
  fwd_wgmma<D>(&tm_q, &tm_k, &tm_v, o, lse, s, D, causal, scale);
}
template <int D>
__global__ void __launch_bounds__(kFwdThreads<D>, 1)
fwd_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                        float* __restrict__ lse, int s, int w, int causal, float scale) {
  fwd_wgmma<D>(&tm_q, &tm_k, &tm_v, o, lse, s, w, causal, scale);
}

template <int D>
struct DkvSmem {
  bf16 k[kBlockRows * D];          // the block's keys, [D / 64][128][64]
  bf16 v[kBlockRows * D];
  bf16 q[kStages][kRows * D];      // streamed queries, [D / 64][64][64] a stage
  bf16 dout[kStages][kRows * D];
  float lse[kStages][kRows];       // times log2(e)
  float delta[kStages][kRows];
  uint64_t full[kStages], empty[kStages], kv_full;
};

// dK/dV: block (128 keys, bh); the query tiles from the diagonal on stream
// through the ring.  Each consumer warpgroup computes, for its 64 keys and a
// 64-query tile, S^T = K Q^T and dP^T = V dO^T (A = K / V, B = Q / dO, both
// from shared memory), then dV += P^T dO and dK += dS^T Q with P^T and dS^T
// from registers and B the same Q / dO tile read MN-major.
template <int D>
__device__ __forceinline__ void dkv_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int s, int w, int causal,
                                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;   // causal: low key blocks see the most query tiles
  const int qt0 = causal ? k0 / kRows : 0;
  const int ntiles = (s + kRows - 1) / kRows - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer warp's 32 arrivals (row statistics) and the TMA bytes
  init_ring(sm.full, 32, sm.empty, &sm.kv_full);

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32) return;
    // producer warp: the block's K and V once, then Q, dO, lse and delta
    // tile by tile, each stage once both consumer warpgroups released it
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kBlockRows * D * sizeof(bf16));
      tma_load_rows<D>(sm.k, tm_k, kBlockRows, k0, bh, &sm.kv_full);
      tma_load_rows<D>(sm.v, tm_v, kBlockRows, k0, bh, &sm.kv_full);
    }
    const size_t rbase = (size_t)bh * s;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages, q0 = (qt0 + it) * kRows;
      if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
      for (int r = lane; r < kRows; r += 32) {
        const bool in = q0 + r < s;
        sm.lse[st][r] = in ? lse[rbase + q0 + r] * kLog2e : 0.f;
        sm.delta[st][r] = in ? delta[rbase + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * kRows * D * sizeof(bf16));
        tma_load_rows<D>(sm.q[st], tm_q, kRows, q0, bh, &sm.full[st]);
        tma_load_rows<D>(sm.dout[st], tm_do, kRows, q0, bh, &sm.full[st]);
      } else {
        mbar_arrive(&sm.full[st]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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
    const int st = it % kStages, q0 = (qt0 + it) * kRows;
    const bf16* qt = sm.q[st];
    const bf16* dot = sm.dout[st];
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    __syncwarp();
    // skipped: a causal tile wholly before this warpgroup's keys, and keys
    // all at or past s (never stored)
    if (kw < s && (!causal || q0 >= kw)) {
      float sc[kRows / 2], dp[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S^T = K Q^T
        wgmma_ss(sc, kmajor(sm.k, kBlockRows, wg * 64, kk), kmajor(qt, kRows, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      // P^T, masked on the diagonal and past s only
      const bool edge = (causal && q0 == kw) || q0 + kRows > s;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + 2 * tq]);
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
      uint32_t pf[kRows / 16][4];   // P^T rounded to bf16, used by both products
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) frag_a(pf[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V dO^T
        wgmma_ss(dp, kmajor(sm.v, kBlockRows, wg * 64, kk), kmajor(dot, kRows, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dV += P^T dO
        wgmma_rs(dv_acc, pf[kk], mnmajor(dot, kRows, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(dp);
      // dS^T = P^T (dP^T - delta), rounded to bf16
      uint32_t dsf[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 8 * kk + 2 * w;   // accumulator elements i, i + 1
          const float2 p = unpack_bf16(pf[kk][w]);
          const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][8 * (i / 4) + 2 * tq]);
          dsf[kk][w] = pack_bf16(p.x * (dp[i] - dl.x), p.y * (dp[i + 1] - dl.y));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dK += dS^T Q
        wgmma_rs(dk_acc, dsf[kk], mnmajor(qt, kRows, 16 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    mbar_arrive(&sm.empty[st]);
  }
  const size_t base = (size_t)bh * s * w;
  store_rows<D>(dk + base, dk_acc, key_lo, s, w, tq, scale);
  store_rows<D>(dv + base, dv_acc, key_lo, s, w, tq, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int causal, float scale) {
  dkv_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, s, D, causal, scale);
}
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int s, int w, int causal, float scale) {
  dkv_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, s, w, causal, scale);
}

template <int D>
struct DqSmem {
  bf16 q[kBlockRows * D];          // the block's queries, [D / 64][128][64]
  bf16 dout[kBlockRows * D];
  bf16 k[kStages][kRows * D];      // streamed keys, [D / 64][64][64] a stage
  bf16 v[kStages][kRows * D];
  uint64_t full[kStages], empty[kStages], qo_full;
};

// dQ: block (128 queries, bh); the key tiles up to the diagonal stream
// through the ring.  Each consumer warpgroup computes, for its 64 queries
// and a 64-key tile, S = Q K^T and dP = dO V^T (both operands from shared
// memory), then dQ += dS K with dS from registers and K read MN-major.
template <int D>
__device__ __forceinline__ void dq_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dq,
                                         int s, int w, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(smem_raw));
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;   // longest causal rows first
  int ntiles = (s + kRows - 1) / kRows;
  if (causal) ntiles = min(ntiles, (min(q0 + kBlockRows, s) - 1) / kRows + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // full: the producer's one arrival and the TMA bytes
  init_ring(sm.full, 1, sm.empty, &sm.qo_full);

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    // producer: the block's Q and dO once, then K and V tile by tile
    mbar_arrive_expect_tx(&sm.qo_full, 2 * kBlockRows * D * sizeof(bf16));
    tma_load_rows<D>(sm.q, tm_q, kBlockRows, q0, bh, &sm.qo_full);
    tma_load_rows<D>(sm.dout, tm_do, kBlockRows, q0, bh, &sm.qo_full);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&sm.empty[st], (it / kStages - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], 2 * kRows * D * sizeof(bf16));
      tma_load_rows<D>(sm.k[st], tm_k, kRows, it * kRows, bh, &sm.full[st]);
      tma_load_rows<D>(sm.v[st], tm_v, kRows, it * kRows, bh, &sm.full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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
    const int st = it % kStages, k0 = it * kRows;
    const bf16* kt = sm.k[st];
    const bf16* vt = sm.v[st];
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    __syncwarp();
    // skipped: a causal tile wholly after this warpgroup's queries, and
    // queries all at or past s (never stored)
    if (qw < s && (!causal || k0 <= qw)) {
      float sc[kRows / 2], dp[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S = Q K^T
        wgmma_ss(sc, kmajor(sm.q, kBlockRows, wg * 64, kk), kmajor(kt, kRows, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // dP = dO V^T
        wgmma_ss(dp, kmajor(sm.dout, kBlockRows, wg * 64, kk), kmajor(vt, kRows, 0, kk), kk);
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
      uint32_t dsf[kRows / 16][4];   // dS rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) frag_a(dsf[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)   // dQ += dS K
        wgmma_rs(dq_acc, dsf[kk], mnmajor(kt, kRows, 16 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dq_acc);
    mbar_arrive(&sm.empty[st]);
  }
  store_rows<D>(dq + (size_t)bh * s * w, dq_acc, row_lo, s, w, tq, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int s, int causal, float scale) {
  dq_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, s, D, causal, scale);
}
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_wgmma_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int s, int w,
                       int causal, float scale) {
  dq_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, s, w, causal, scale);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

dim3 tiles(int s, int bh, int rows) { return dim3((s + rows - 1) / rows, bh); }

// cuTensorMapEncodeTiled lives in the driver library, which the build does
// not link: fetch it through the runtime once
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the bf16 [bh, s, d] tensor at `base` as a 3-D map of [rows, 64] boxes in
// the 128-byte swizzle; the map holds the address, so it is made per call
bool encode_rows(CUtensorMap* map, const void* base, int bh, int s, int d, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(bf16), (cuuint64_t)s * d * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the four operand maps of a backward kernel: q and dout in boxes of
// q_rows, k and v in boxes of k_rows
struct BwdMaps {
  CUtensorMap q, k, v, dout;
  bool ok;
  BwdMaps(const void* q_, const void* k_, const void* v_, const void* do_, int bh, int s, int d,
          int q_rows, int k_rows)
      : ok(encode_rows(&q, q_, bh, s, d, q_rows) && encode_rows(&k, k_, bh, s, d, k_rows) &&
           encode_rows(&v, v_, bh, s, d, k_rows) && encode_rows(&dout, do_, bh, s, d, q_rows)) {}
};

// the three operand maps of the forward: q in boxes of q_rows, k and v in
// boxes of k_rows
struct FwdMaps {
  CUtensorMap q, k, v;
  bool ok;
  FwdMaps(const void* q_, const void* k_, const void* v_, int bh, int s, int d, int q_rows,
          int k_rows)
      : ok(encode_rows(&q, q_, bh, s, d, q_rows) && encode_rows(&k, k_, bh, s, d, k_rows) &&
           encode_rows(&v, v_, bh, s, d, k_rows)) {}
};

// Each launcher runs the kernels of compute width D (64 or 128) on tensors of
// head dim dg <= D: the columns from dg to D are zero in shared memory (the
// loads fill them, TMA past the map's last column), add nothing to a score,
// and are never stored.  The scale is that of dg.  A bf16 kernel of width D
// has its own entry point for dg < D.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int s, int dg, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dg);
  if constexpr (std::is_same<T, bf16>::value) {
    const FwdMaps maps(q, k, v, bh, s, dg, kFwdRows<D>, kFwdKeys);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = sizeof(FwdSmem<D>) + 1024;
    const dim3 grid = tiles(s, bh, kFwdRows<D>);
    if (dg == D)
      return launch(fwd_wgmma_kernel<D>, kFwdThreads<D>, smem, grid, stream, maps.q, maps.k,
                    maps.v, (bf16*)o, (float*)lse, s, causal, scale);
    return launch(fwd_wgmma_narrow_kernel<D>, kFwdThreads<D>, smem, grid, stream, maps.q,
                  maps.k, maps.v, (bf16*)o, (float*)lse, s, dg, causal, scale);
  } else {
    return launch(fwd_kernel<D>, kThreads,
                  (3 * kTile * (D + 1) + kTile * kPS) * sizeof(float), tiles(s, bh, kTile),
                  stream, (const float*)q, (const float*)k, (const float*)v, (float*)o,
                  (float*)lse, s, dg, causal, scale);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int s, int dg, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dg);
  if constexpr (std::is_same<T, bf16>::value) {
    const BwdMaps maps(q, k, v, dout, bh, s, dg, kRows, kBlockRows);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = sizeof(DkvSmem<D>) + 1024;
    const dim3 grid = tiles(s, bh, kBlockRows);
    if (dg == D)
      return launch(dkv_wgmma_kernel<D>, kBwdThreads, smem, grid, stream, maps.q, maps.k,
                    maps.v, maps.dout, (const float*)lse, (const float*)delta, (bf16*)dk,
                    (bf16*)dv, s, causal, scale);
    return launch(dkv_wgmma_narrow_kernel<D>, kBwdThreads, smem, grid, stream, maps.q, maps.k,
                  maps.v, maps.dout, (const float*)lse, (const float*)delta, (bf16*)dk,
                  (bf16*)dv, s, dg, causal, scale);
  } else {
    return launch(dkv_kernel<D>, kThreads,
                  (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * sizeof(float),
                  tiles(s, bh, kTile), stream, (const float*)q, (const float*)k,
                  (const float*)v, (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dk, (float*)dv, s, dg, causal, scale);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s,
                      int dg, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)dg);
  if constexpr (std::is_same<T, bf16>::value) {
    const BwdMaps maps(q, k, v, dout, bh, s, dg, kBlockRows, kRows);
    if (!maps.ok) return cudaErrorInvalidValue;
    const size_t smem = sizeof(DqSmem<D>) + 1024;
    const dim3 grid = tiles(s, bh, kBlockRows);
    if (dg == D)
      return launch(dq_wgmma_kernel<D>, kBwdThreads, smem, grid, stream, maps.q, maps.k,
                    maps.v, maps.dout, (const float*)lse, (const float*)delta, (bf16*)dq, s,
                    causal, scale);
    return launch(dq_wgmma_narrow_kernel<D>, kBwdThreads, smem, grid, stream, maps.q, maps.k,
                  maps.v, maps.dout, (const float*)lse, (const float*)delta, (bf16*)dq, s, dg,
                  causal, scale);
  } else {
    return launch(dq_kernel<D>, kThreads,
                  (4 * kTile * (D + 1) + kTile * kPS + 2 * kTile) * sizeof(float),
                  tiles(s, bh, kTile), stream, (const float*)q, (const float*)k,
                  (const float*)v, (const float*)dout, (const float*)lse, (const float*)delta,
                  (float*)dq, s, dg, causal, scale);
  }
}

// dtype: 0 = float32, 1 = bfloat16; d, a multiple of 8 up to 128, runs at
// compute width 64 up to 64 and 128 above
#define DISPATCH(dtype, d, CALL)                                                  \
  do {                                                                            \
    if (bh < 1 || s < 1 || bh > 65535 || d < 8 || d > 128 || d % 8)               \
      return (int)cudaErrorInvalidValue;                                          \
    if (dtype == 0) return (int)(d <= 64 ? CALL(float, 64) : CALL(float, 128));   \
    if (dtype == 1) return (int)(d <= 64 ? CALL(bf16, 64) : CALL(bf16, 128));     \
    return (int)cudaErrorInvalidValue;                                            \
  } while (0)

}  // namespace

extern "C" {

int bagua_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int bh, int s, int d, int dtype, int causal, void* stream) {
#define CALL(T, D) launch_fwd<T, D>(q, k, v, o, lse, bh, s, d, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int bh,
                        int s, int d, int dtype, int causal, void* stream) {
#define CALL(T, D) \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, s, d, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

int bagua_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int bh, int s, int d,
                       int dtype, int causal, void* stream) {
#define CALL(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, s, d, causal, (cudaStream_t)stream)
  DISPATCH(dtype, d, CALL);
#undef CALL
}

}  // extern "C"
