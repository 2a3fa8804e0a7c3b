// Grouped matrix multiply for Hopper (sm_90a): the two kernels of dropless MoE.
//
// Replaces the two Pallas TPU kernels of bagua_tpu/ops/gmm.py:
//   bagua_gmm       <- _gmm_padded       (pallas_call :95, _fwd_kernel :75-78);
//                      with trans_rhs = 1 also the d_lhs product (:172-175)
//   bagua_gmm_drhs  <- _gmm_drhs_padded  (pallas_call :133, _drhs_kernel :103-116)
//
// Layout: rows of `lhs` [rows, K] are sorted by group; group g owns rows
// [off_g, off_g + sizes[g]) with off_g the sum of the sizes before it.  The
// offsets are summed on the device from `group_sizes` (int32 [G]), clamped
// to [0, rows], so the host never reads them and the launch grid does not
// depend on them.
//   bagua_gmm:      out[r] = lhs[r] @ B_g, B_g = rhs[g] ([K, N] row-major) or,
//                   with trans_rhs, rhs[g]^T (rhs[g] is [N, K] row-major);
//                   bf16 in, f32 accumulation, bf16 out.  Rows past the last
//                   group are written as zeros.
//   bagua_gmm_drhs: out[g] = lhs_g^T @ gout_g over the group's rows, [G, M, N]
//                   f32; an empty group writes zeros.
// K, M and N are multiples of 128 (the JAX kernel path's own domain).
//
// What bounds them on an H100: at the MoE path's shapes (rows 65536, G 8,
// (K, N) = (512, 2048) or (2048, 512)) each call is 2 * 65536 * 512 * 2048 =
// 137 GFLOP on 64-256 MB of operands, about 500 flop per byte, above the
// card's ~295 flop/byte ridge: bound by the tensor cores (0.139 ms at 989
// TFLOP/s), provided no operand is read from device memory more than once.
//
// Design.  The TPU kernels pad every group up to whole 128-row MXU blocks and
// scalar-prefetch a block -> group table; here nothing is padded.
//   bagua_gmm: one block per [128, 128] output tile of one group.  blockIdx.y
//   walks the groups' row tiles in order (each group's last tile is ragged and
//   masked), with a static worst case of ceil(rows / 128) + G + 1 tiles; a
//   block past the last tile exits.  blockIdx.x walks the N tiles, so the
//   blocks that run together share one lhs row tile and lhs is read from
//   device memory once; the group's B panel (2 MB) stays in L2.
//   bagua_gmm_drhs: one block per (N tile, M tile, group), looping over the
//   group's rows 32 at a time.  Each output tile has exactly one writer: no
//   atomics, the sum order is fixed, and the result is deterministic.
// Both: 256 threads (eight warps, 2 x 4, each a 64 x 32 piece of the tile) of
// mma.sync.m16n8k16 (bf16 in, f32 accumulation), operands staged in shared
// memory by cp.async in two stages (the next 32-deep slice loads while the
// current one multiplies), rows padded by 16 bytes so ldmatrix is free of bank
// conflicts, rows outside the group zero-filled by the copy itself.  wgmma,
// TMA and a deeper pipeline are left to a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // rows of an output tile
constexpr int kBN = 128;      // columns of an output tile
constexpr int kBK = 32;       // depth of one pipeline stage
constexpr int kPad = 8;       // bf16 elements of padding per shared row
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false the 16 bytes are zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// A 16 x 16 block of A, stored [m][k] (row-major A): ldmatrix without
// transpose, lane l addressing row l % 16, column 8 (l / 16).
__device__ __forceinline__ void load_a_mk(uint32_t (&a)[4], const bf16* p, int ld, int lane) {
  ldsm_x4(a, p + (lane % 16) * ld + (lane / 16) * 8);
}
// ... stored [k][m] (A transposed in memory): ldmatrix with transpose; the
// four 8 x 8 matrices are (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
// (k 8-15, m 8-15), so lane l addresses k row 8 (l / 16) + l % 8, m column
// 8 ((l / 8) % 2).
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4], const bf16* p, int ld, int lane) {
  ldsm_x4_trans(a, p + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8);
}
// B fragments of two neighbouring n8 tiles (16 columns), B stored [k][n]
__device__ __forceinline__ void load_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* p,
                                          int ld, int lane) {
  uint32_t r[4];
  ldsm_x4_trans(r, p + (lane % 16) * ld + (lane / 16) * 8);
  b0[0] = r[0]; b0[1] = r[1];
  b1[0] = r[2]; b1[1] = r[3];
}
// ... B stored [n][k]
__device__ __forceinline__ void load_b_nk(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* p,
                                          int ld, int lane) {
  uint32_t r[4];
  ldsm_x4(r, p + (lane % 16) * ld + (lane / 16) * 8);
  b0[0] = r[0]; b0[1] = r[2];
  b1[0] = r[1]; b1[1] = r[3];
}

// Rows [start, end) of group g, the group sizes summed in order and clamped
// to [0, rows].  Every thread computes it: G is the expert count, a handful.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes, int g, int rows,
                                           int& start, int& end) {
  int off = 0;
  for (int i = 0; i < g; ++i) off = min(rows, off + max(sizes[i], 0));
  start = off;
  end = min(rows, off + max(sizes[g], 0));
}

// ---------------------------------------------------------------------------
// bagua_gmm: out[r] = lhs[r] @ B_g
// ---------------------------------------------------------------------------

template <bool TRANS_B>
struct GmmSmem {
  static constexpr int kBRows = TRANS_B ? kBN : kBK;          // [n][k] or [k][n]
  static constexpr int kBCols = (TRANS_B ? kBK : kBN) + kPad;
  bf16 a[2][kBM][kBK + kPad];
  bf16 b[2][kBRows][kBCols];
};

template <bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ sizes, bf16* __restrict__ out, int rows, int K, int N,
           int G) {
  __shared__ __align__(16) GmmSmem<TRANS_B> sm;
  using S = GmmSmem<TRANS_B>;

  // this block's group and row range: walk the groups' row tiles in order;
  // "group" G is the tail past the last group, written as zeros
  int t = blockIdx.y, g = 0, rs = 0, re = 0, start = 0;
  for (; g <= G; ++g) {
    const int end = g < G ? min(rows, start + max(sizes[g], 0)) : rows;
    const int tiles = (end - start + kBM - 1) / kBM;
    if (t < tiles) {
      rs = start + t * kBM;
      re = min(end, rs + kBM);
      break;
    }
    t -= tiles;
    start = end;
  }
  if (g > G) return;  // surplus block of the static worst-case grid

  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gq = lane / 4, tq = lane % 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (g < G) {
    const bf16* B = rhs + (size_t)g * K * N;
    auto load_stage = [&](int stage, int k0) {
#pragma unroll
      for (int it = 0; it < (kBM * kBK / 8) / kThreads; ++it) {
        const int v = threadIdx.x + it * kThreads;
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        const bool valid = rs + r < re;
        cp_async16(&sm.a[stage][r][c], valid ? lhs + (size_t)(rs + r) * K + k0 + c : lhs,
                   valid);
      }
#pragma unroll
      for (int it = 0; it < (kBN * kBK / 8) / kThreads; ++it) {
        const int v = threadIdx.x + it * kThreads;
        if (TRANS_B) {  // rhs[g] is [N, K]: rows n, columns k
          const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
          cp_async16(&sm.b[stage][r][c], B + (size_t)(n0 + r) * K + k0 + c, true);
        } else {        // rhs[g] is [K, N]: rows k, columns n
          const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
          cp_async16(&sm.b[stage][r][c], B + (size_t)(k0 + r) * N + n0 + c, true);
        }
      }
    };

    const int nk = K / kBK;
    load_stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait_one();  // stage kt has landed
      __syncthreads();
      const int s = kt & 1;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_a_mk(a[i], &sm.a[s][wm + 16 * i][kk], kBK + kPad, lane);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (TRANS_B)
            load_b_nk(b[j], b[j + 1], &sm.b[s][wn + 8 * j][kk], S::kBCols, lane);
          else
            load_b_kn(b[j], b[j + 1], &sm.b[s][kk][wn + 8 * j], S::kBCols, lane);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
      __syncthreads();  // everyone is done with stage kt before it is refilled
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rs + wm + 16 * i + gq + 8 * h;
      if (row >= re) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + n0 + wn + 8 * j + 2 * tq) =
            pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// bagua_gmm_drhs: out[g] = lhs_g^T @ gout_g, f32
// ---------------------------------------------------------------------------

struct DrhsSmem {
  bf16 a[2][kBK][kBM + kPad];  // lhs rows (k) x this tile's M columns
  bf16 b[2][kBK][kBN + kPad];  // gout rows (k) x this tile's N columns
};

__global__ void __launch_bounds__(kThreads)
gmm_drhs_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ gout,
                const int* __restrict__ sizes, float* __restrict__ out, int rows, int M,
                int N) {
  __shared__ __align__(16) DrhsSmem sm;
  const int g = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int start, end;
  group_rows(sizes, g, rows, start, end);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gq = lane / 4, tq = lane % 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_stage = [&](int stage, int r0) {
#pragma unroll
    for (int it = 0; it < (kBK * kBM / 8) / kThreads; ++it) {
      const int v = threadIdx.x + it * kThreads;
      const int r = v / (kBM / 8), c = (v % (kBM / 8)) * 8;
      const bool valid = r0 + r < end;
      cp_async16(&sm.a[stage][r][c], valid ? lhs + (size_t)(r0 + r) * M + m0 + c : lhs, valid);
    }
#pragma unroll
    for (int it = 0; it < (kBK * kBN / 8) / kThreads; ++it) {
      const int v = threadIdx.x + it * kThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const bool valid = r0 + r < end;
      cp_async16(&sm.b[stage][r][c], valid ? gout + (size_t)(r0 + r) * N + n0 + c : gout,
                 valid);
    }
  };

  const int nk = (end - start + kBK - 1) / kBK;  // 0 for an empty group
  if (nk > 0) {
    load_stage(0, start);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, start + (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a_km(a[i], &sm.a[s][kk][wm + 16 * i], kBM + kPad, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2)
        load_b_kn(b[j], b[j + 1], &sm.b[s][kk][wn + 8 * j], kBN + kPad, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  float* dst = out + (size_t)g * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(dst + (size_t)row * N + n0 + wn + 8 * j + 2 * tq) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

}  // namespace

extern "C" {

// lhs [rows, k] bf16, rhs [groups, k, n] bf16 (trans_rhs 0) or [groups, n, k]
// (trans_rhs 1), group_sizes [groups] int32, out [rows, n] bf16
int bagua_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int rows,
              int k, int n, int groups, int trans_rhs, void* stream) {
  if (rows < 0 || groups < 1 || k < kBK || k % kBK || n < kBN || n % kBN)
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)rows + kBM - 1) / kBM + groups + 1;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kBN, (unsigned)tiles);
  cudaStream_t s = (cudaStream_t)stream;
  if (trans_rhs)
    gmm_kernel<true><<<grid, kThreads, 0, s>>>((const bf16*)lhs, (const bf16*)rhs,
                                               (const int*)group_sizes, (bf16*)out, rows, k,
                                               n, groups);
  else
    gmm_kernel<false><<<grid, kThreads, 0, s>>>((const bf16*)lhs, (const bf16*)rhs,
                                                (const int*)group_sizes, (bf16*)out, rows,
                                                k, n, groups);
  return (int)cudaGetLastError();
}

// lhs [rows, m] bf16, gout [rows, n] bf16, group_sizes [groups] int32,
// out [groups, m, n] float32
int bagua_gmm_drhs(const void* lhs, const void* gout, const void* group_sizes, void* out,
                   int rows, int m, int n, int groups, void* stream) {
  if (rows < 0 || groups < 1 || groups > 65535 || m < kBM || m % kBM || n < kBN || n % kBN ||
      m / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kBN, m / kBM, groups);
  gmm_drhs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)lhs, (const bf16*)gout, (const int*)group_sizes, (float*)out, rows, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
