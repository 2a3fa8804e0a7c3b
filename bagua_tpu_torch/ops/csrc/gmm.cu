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
//                   f32 accumulation, out in the operands' dtype.  Rows past
//                   the last group are written as zeros.
//   bagua_gmm_drhs: out[g] = lhs_g^T @ gout_g over the group's rows, [G, M, N]
//                   f32; an empty group writes zeros.
// The operands are f32, bf16 or f16 (dtype 0, 1 or 2).  K, M and N are
// multiples of 8 (a 16-bit row then starts on a 16-byte boundary, as TMA
// requires; the Python entry point pads other widths with zeros); a tile
// that reaches past one is zero-filled by its load and stored only up to it.
//
// What bounds them on an H100: at the MoE path's shapes (rows 65536, G 8,
// (K, N) = (512, 2048) or (2048, 512)) each call is 2 * 65536 * 512 * 2048 =
// 137 GFLOP on 64-256 MB of operands, about 500 flop per byte, above the
// card's ~295 flop/byte ridge: bound by the tensor cores (0.139 ms at 989
// TFLOP/s), provided no operand is read from device memory more than once
// and the stores (K7a writes up to 268 MB, a memory floor of 0.08 ms) run
// beside the products.
//
// Design (bf16, f16).  The TPU kernels pad every group up to whole 128-row
// MXU blocks and scalar-prefetch a block -> group table; here nothing is
// padded.  Both kernels are warp-specialized wgmma fed by TMA through a ring
// of stages in dynamic shared memory, one 384-thread block an SM: one warp
// of a producer warpgroup (24 registers after setmaxnreg) keeps the ring
// full, and two consumer warpgroups (240 registers) each own 64 rows of a
// 128 x kTileN output tile and issue m64n{kTileN}k16 wgmma on the stages that
// have landed, one 64-deep slice a stage, so that each operand byte loaded
// serves 128 or kTileN products.  The grid is persistent, one block an SM,
// each block taking the work units b, b + grid, ... in increasing order, so
// that one unit's epilogue runs while the producer already loads the next.
//   bagua_gmm (K7a): a unit is a (row tile, N tile) pair, N tiles fastest,
//   so the blocks that run together share one lhs row tile and lhs is read
//   from device memory once; the row tiles walk the groups in order (each
//   group's last tile ragged) in a static worst case of ceil(rows / 128) +
//   G + 1 tiles, whose surplus tiles end the walk.  lhs goes through a 2-D
//   map [rows, K] (K-major A); rhs through a 3-D map [G, K, N] read MN-major
//   or, with trans_rhs, [G, N, K] read K-major.  A row tile's A box may hold
//   rows of the next group: they are multiplied and never stored.  The
//   epilogue goes through shared memory: each warpgroup rounds its 64 x
//   kTileN piece to T into padded staging rows, then stores them in
//   coalesced 16-byte pieces, masked to the tile's rows [rs, re) (the next
//   group's tile writes the others) and to N.
//   bagua_gmm_drhs (K7b): a unit is (group, chunk of kChunkRows of its rows,
//   M tile, N tile); the full chunks come first and the groups' last, shorter
//   chunks after them, longest first, so that the blocks get even shares
//   of the rows whatever the routing (each block makes that order once, in
//   shared memory: make_chunk_order; at most kMaxGroups groups).  Both
//   operands are MN-major: lhs [rows, M] is A^T, gout [rows, N] is B, each
//   through a 2-D map.  A chunk's boxes start at its first row; rows of its
//   last box past the chunk (the next chunk's or group's) are zeroed in the
//   A tile before its wgmma (in the 128-byte swizzle one row of the box is
//   one whole 128-byte line, so the swizzle does not move which bytes to
//   clear).  Chunks cut the time of a skewed routing to that of its chunks:
//   without them the largest group's tiles set it.  A group of up to
//   kChunkRows rows is one chunk, whose unit stores its tile; the chunks of
//   a larger group are combined in chunk order through the output: chunk 0
//   stores its partial, chunk c waits until the tile's flag says c, adds its
//   partial to what is there and sets the flag to c + 1.  No atomics on data:
//   the sum order is fixed and a second run is bitwise equal.  The lowest
//   unfinished unit never waits (its predecessors are lower units, taken
//   first), and every block of the grid is resident at once, so the waits
//   cannot deadlock.  Flags live in this library's device memory and carry
//   the launch's epoch in their upper 32 bits, so no launch has to clear
//   them; K7b launches on one device run one at a time (one stream).
// The tile's width (256 against 128) and K7b's chunk (8192 rows against
// 4096) were each chosen by timing (PERF.md has the times;
// scripts/torch_gmm_variants.py keeps both as variants to time again).
//
// f32 has no tensor-core format of full precision, so its two kernels (on no
// measured path: the MoE layers of the port's models compute in bf16) run
// FP32 FMAs from shared memory, 256 threads on a [64, 64] output tile, each
// thread a 4 x 4 piece of it, one block a tile; K7b's f32 kernel loops over
// its group's rows unchunked.

#include "hopper.cuh"

#include <atomic>
#include <climits>

namespace {

constexpr int kTileM = 128;        // rows of an output tile: two consumer warpgroups of 64
constexpr int kTileN = 256;        // columns of an output tile, the N of each wgmma
constexpr int kDepth = 64;         // reduction depth of a stage: one 128-byte line of 16-bit values
constexpr int kChunkRows = 8192;   // K7b: rows of a group one work unit reduces
// ring depth: K7a keeps its epilogue's staging rows beside the ring
constexpr int kStagesA = kTileN == 256 ? 3 : 4;
constexpr int kStagesB = 4;
constexpr int kWgThreads = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;  // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;
constexpr int kThreads = 256;      // the f32 kernels
constexpr int kMaxFlags = 1 << 19; // K7b output tiles (G x M tiles x N tiles) with a flag
constexpr int kMaxGroups = 2048;   // K7b: groups its order table in shared memory holds

__device__ unsigned long long g_flags[kMaxFlags];

// Rows [start, end) of group g, the group sizes summed in order and clamped
// to [0, rows].  Every thread computes it: G is the expert count, a handful.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes, int g, int rows,
                                           int& start, int& end) {
  int off = 0;
  for (int i = 0; i < g; ++i) off = min(rows, off + max(sizes[i], 0));
  start = off;
  end = min(rows, off + max(sizes[g], 0));
}

// The row tile t of the static worst-case grid: walking the groups' tiles of
// `tile` rows in order (each group's last tile ragged), tile t is rows
// [rs, re) of group g; "group" G is the tail past the last group, written
// as zeros.  False for a surplus tile past the end.
__device__ __forceinline__ bool row_tile(const int* __restrict__ sizes, int rows, int G, int t,
                                         int tile, int& g, int& rs, int& re) {
  int start = 0;
  for (g = 0; g <= G; ++g) {
    const int end = g < G ? min(rows, start + max(sizes[g], 0)) : rows;
    const int tiles = (end - start + tile - 1) / tile;
    if (t < tiles) {
      rs = start + t * tile;
      re = min(end, rs + tile);
      return true;
    }
    t -= tiles;
    start = end;
  }
  return false;
}

// ---------------------------------------------------------------------------
// bagua_gmm (K7a): out[r] = lhs[r] @ B_g
// ---------------------------------------------------------------------------

constexpr int kStageLd = kTileN + 8;   // staging row stride in elements: conflict-free writes

template <typename T>
struct GmmSmem {
  T a[kStagesA][kTileM * kDepth];   // lhs rows, [128][64] a stage
  T b[kStagesA][kTileN * kDepth];   // B: [kTileN / 64][64 k][64 n], or [kTileN n][64 k]
  T out[2][64 * kStageLd];          // each consumer warpgroup's 64 output rows
  uint64_t full[kStagesA], empty[kStagesA];
};

template <int S>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);                   // the producer's arrival and the TMA bytes
      mbar_init(&empty[i], kConsumerThreads);   // every consumer thread's release
    }
    mbar_init_fence();
  }
  __syncthreads();
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                 const __grid_constant__ CUtensorMap tm_rhs, const int* __restrict__ sizes,
                 T* __restrict__ out, int rows, int K, int N, int G) {
  constexpr int S = kStagesA;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<GmmSmem<T>*>(align_1024(smem_raw));
  const int ntn = (N + kTileN - 1) / kTileN, nk = (K + kDepth - 1) / kDepth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<S>(sm.full, sm.empty);

  if (warp >= kConsumerThreads / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerThreads / 32 || lane != 0) return;
    // producer: for each unit, the lhs row tile and the B panel slice by slice
    int it = 0;
    for (int t = blockIdx.x;; t += gridDim.x) {
      int g, rs, re;
      if (!row_tile(sizes, rows, G, t / ntn, kTileM, g, rs, re)) break;
      if (g == G) continue;   // rows past the last group: zeros, nothing to load
      const int n0 = (t % ntn) * kTileN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(&sm.empty[st], (it / S - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], (kTileM + kTileN) * kDepth * sizeof(T));
        tma_load_2d(sm.a[st], &tm_lhs, kt * kDepth, rs, &sm.full[st]);
        if (TRANS) {
          tma_load_3d(sm.b[st], &tm_rhs, kt * kDepth, n0, g, &sm.full[st]);
        } else {
#pragma unroll
          for (int h = 0; h < kTileN / 64; ++h)
            tma_load_3d(sm.b[st] + h * kDepth * 64, &tm_rhs, n0 + 64 * h, kt * kDepth, g,
                        &sm.full[st]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row_in = (warp % 4) * 16 + lane / 4, tq = lane % 4;   // rows row_in, row_in + 8
  T* stage = sm.out[wg];
  // the accumulator is defined by wgmma alone (its first slice overwrites
  // it): an instruction that wrote it between wgmmas would make ptxas
  // serialize them
  float acc[kTileN / 2];
  int it = 0;
  for (int t = blockIdx.x;; t += gridDim.x) {
    int g, rs, re;
    if (!row_tile(sizes, rows, G, t / ntn, kTileM, g, rs, re)) break;
    const int n0 = (t % ntn) * kTileN;
    const bool tail = g == G;   // rows past the last group: zeros
    if (!tail) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % S;
        mbar_wait(&sm.full[st], (it / S) & 1);
        __syncwarp();   // wgmma wants converged warps
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          const uint64_t a = kmajor(sm.a[st], kTileM, 64 * wg, kk);
          const uint64_t b =
              TRANS ? kmajor(sm.b[st], kTileN, 0, kk) : mnmajor(sm.b[st], kDepth, 16 * kk);
          wgmma_ss<T, 0, TRANS ? 0 : 1>(acc, a, b, kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the slice before is done: release its stage
        if (kt > 0) mbar_arrive(&sm.empty[(it - 1) % S]);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(&sm.empty[(it - 1) % S]);
    }
    // epilogue: the warpgroup's 64 x kTileN piece, rounded to T, into its
    // staging rows, then out in 16-byte pieces, rows [rs, re) and columns
    // below N only
    named_bar_sync(2 + wg, 128);   // the previous unit's stores have read the staging
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(stage + (row_in + 8 * r) * kStageLd + 8 * j + 2 * tq) =
            tail ? 0u : pack2<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    named_bar_sync(2 + wg, 128);
    const int r0 = rs + 64 * wg;
    for (int i = tid; i < 64 * (kTileN / 8); i += 128) {
      const int r = i / (kTileN / 8), c = (i % (kTileN / 8)) * 8;
      if (r0 + r < re && n0 + c < N)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * kStageLd + c);
    }
  }
}

// ---------------------------------------------------------------------------
// bagua_gmm_drhs (K7b): out[g] = lhs_g^T @ gout_g, f32
// ---------------------------------------------------------------------------

// the order of K7b's chunks (drhs_unit), made once a block: where each group
// starts, how many full chunks there are, and the groups whose last chunk
// comes at each place after them
struct ChunkOrder {
  int start[kMaxGroups + 1];   // group g owns rows [start[g], start[g + 1])
  int last[kMaxGroups];        // last[i]: the group of the i-th last chunk
  int fulls, lasts;
};

template <typename T>
struct DrhsSmem {
  T a[kStagesB][kTileM * kDepth];   // lhs rows: [2][64 rows][64 m] a stage (A, MN-major)
  T b[kStagesB][kTileN * kDepth];   // gout rows: [kTileN / 64][64 rows][64 n] (B, MN-major)
  uint64_t full[kStagesB], empty[kStagesB];
  ChunkOrder order;
};

// K7b's chunks: a group's chunks are `chunk` rows each, but for the last,
// which holds the rows past them (an empty group's last chunk holds no rows
// and writes zeros).  Units come chunk by chunk, each chunk's tiles
// together: first every full chunk, in group and row order, then the
// groups' last chunks, longest first (ties in group order), so that the
// blocks taking units in turn get even shares of the rows, and a group's
// last chunk comes after its others.  Every thread of the block takes part.
__device__ __forceinline__ void make_chunk_order(ChunkOrder& o, const int* __restrict__ sizes,
                                                 int rows, int G, int chunk) {
  if (threadIdx.x == 0) {
    int start = 0, fulls = 0, lasts = 0;
    for (int g = 0; g < G; ++g) {
      o.start[g] = start;
      const int end = min(rows, start + max(sizes[g], 0));
      fulls += (end - start) / chunk;
      lasts += end == start || (end - start) % chunk != 0;
      start = end;
    }
    o.start[G] = start;
    o.fulls = fulls;
    o.lasts = lasts;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int n = o.start[g + 1] - o.start[g], rest = n % chunk;
    if (n > 0 && rest == 0) continue;   // no last chunk past the full ones
    int rank = 0;
    for (int h = 0; h < G; ++h) {
      const int nh = o.start[h + 1] - o.start[h], rh = nh % chunk;
      rank += (nh == 0 || rh > 0) && (rh > rest || (rh == rest && h < g));
    }
    o.last[rank] = g;
  }
  __syncthreads();
}

// The K7b work unit u: chunk c of group g's nch chunks, rows [r0, r1), and
// the output tile within the group; false past the last unit
__device__ __forceinline__ bool drhs_unit(const ChunkOrder& o, int G, int chunk, int tiles,
                                          int u, int& g, int& c, int& nch, int& tile, int& r0,
                                          int& r1) {
  int k = u / tiles;
  tile = u % tiles;
  if (k < o.fulls) {
    for (g = 0;; ++g) {
      const int n = o.start[g + 1] - o.start[g];
      if (k < n / chunk) {
        c = k;
        nch = n / chunk + (n % chunk != 0);
        r0 = o.start[g] + c * chunk;
        r1 = r0 + chunk;
        return true;
      }
      k -= n / chunk;
    }
  }
  if (k - o.fulls >= o.lasts) return false;
  g = o.last[k - o.fulls];
  c = nch = (o.start[g + 1] - o.start[g]) / chunk;
  ++nch;
  r0 = o.start[g] + c * chunk;
  r1 = o.start[g + 1];
  return true;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_drhs_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                      const __grid_constant__ CUtensorMap tm_gout, const int* __restrict__ sizes,
                      float* __restrict__ out, unsigned long long* __restrict__ flags, int rows,
                      int M, int N, int G, int chunk, unsigned epoch) {
  constexpr int S = kStagesB;
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DrhsSmem<T>*>(align_1024(smem_raw));
  const int ntn = (N + kTileN - 1) / kTileN;
  const int tiles = (M + kTileM - 1) / kTileM * ntn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<S>(sm.full, sm.empty);
  make_chunk_order(sm.order, sizes, rows, G, chunk);
  int g, c, nch, tile, r0, r1;

  if (warp >= kConsumerThreads / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerThreads / 32 || lane != 0) return;
    // producer: for each unit, the chunk's lhs and gout rows 64 at a time
    int it = 0;
    for (int u = blockIdx.x; drhs_unit(sm.order, G, chunk, tiles, u, g, c, nch, tile, r0, r1);
         u += gridDim.x) {
      const int m0 = tile / ntn * kTileM, n0 = tile % ntn * kTileN;
      for (int r = r0; r < r1; r += kDepth, ++it) {
        const int st = it % S;
        if (it >= S) mbar_wait(&sm.empty[st], (it / S - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], (kTileM + kTileN) * kDepth * sizeof(T));
#pragma unroll
        for (int h = 0; h < kTileM / 64; ++h)
          tma_load_2d(sm.a[st] + h * kDepth * 64, &tm_lhs, m0 + 64 * h, r, &sm.full[st]);
#pragma unroll
        for (int h = 0; h < kTileN / 64; ++h)
          tma_load_2d(sm.b[st] + h * kDepth * 64, &tm_gout, n0 + 64 * h, r, &sm.full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row_in = (warp % 4) * 16 + lane / 4, tq = lane % 4;   // rows row_in, row_in + 8
  float acc[kTileN / 2];
  int it = 0;
  for (int u = blockIdx.x; drhs_unit(sm.order, G, chunk, tiles, u, g, c, nch, tile, r0, r1);
       u += gridDim.x) {
    const int m0 = tile / ntn * kTileM, n0 = tile % ntn * kTileN;
    zero(acc);
    for (int r = r0; r < r1; r += kDepth, ++it) {
      const int st = it % S;
      T* a = sm.a[st] + wg * kDepth * 64;   // this warpgroup's 64 columns of M
      mbar_wait(&sm.full[st], (it / S) & 1);
      __syncwarp();   // wgmma wants converged warps
      if (r1 - r < kDepth) {   // the box's rows past the chunk add nothing
        for (int i = tid + (r1 - r) * 8; i < kDepth * 8; i += 128)
          reinterpret_cast<uint4*>(a)[i] = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        named_bar_sync(2 + wg, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_ss<T, 1, 1>(acc, mnmajor(a, kDepth, 16 * kk), mnmajor(sm.b[st], kDepth, 16 * kk),
                          1);
      wgmma_commit();
      wgmma_wait<1>();   // the slice before is done: release its stage
      if (r > r0) mbar_arrive(&sm.empty[(it - 1) % S]);
    }
    if (r1 > r0) {
      wgmma_wait<0>();
      reg_fence(acc);
      mbar_arrive(&sm.empty[(it - 1) % S]);
    }
    // epilogue: chunk 0 stores its partial; chunk c > 0 waits for the
    // tile's flag to say c and adds its partial to the sum of chunks 0..c-1
    unsigned long long* flag = flags + (size_t)g * tiles + tile;
    if (c > 0) {
      if (threadIdx.x == 0) {
        const unsigned long long want = (unsigned long long)epoch << 32 | (unsigned)c;
        while (ld_acquire(flag) != want) __nanosleep(256);
      }
      named_bar_sync(1, kConsumerThreads);
    }
    float* dst = out + (size_t)g * M * N;
    const int m_lo = m0 + 64 * wg + row_in;
    // the sums of chunks before are loaded kBatch column steps at a time, all
    // of a batch before its stores, so that their latencies overlap
    constexpr int kBatch = 8;
#pragma unroll
    for (int j0 = 0; j0 < kTileN / 8; j0 += kBatch) {
      float2 before[kBatch][2];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m_lo + 8 * h, col = n0 + 8 * (j0 + j) + 2 * tq;
          before[j][h] = c > 0 && row < M && col < N   // another SM wrote it: read past L1
                             ? __ldcg(reinterpret_cast<const float2*>(dst + (size_t)row * N + col))
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m_lo + 8 * h, col = n0 + 8 * (j0 + j) + 2 * tq, i = 4 * (j0 + j) + 2 * h;
          if (row < M && col < N)
            __stcg(reinterpret_cast<float2*>(dst + (size_t)row * N + col),
                   c > 0 ? make_float2(before[j][h].x + acc[i], before[j][h].y + acc[i + 1])
                         : make_float2(acc[i], acc[i + 1]));
        }
    }
    if (nch > 1) {   // hand the tile to chunk c + 1
      __threadfence();
      named_bar_sync(1, kConsumerThreads);
      if (threadIdx.x == 0) st_release(flag, (unsigned long long)epoch << 32 | (unsigned)(c + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the same two products by FMA
// ---------------------------------------------------------------------------

constexpr int kFT = 64;   // rows and columns of an f32 output tile
constexpr int kFK = 16;   // depth of one f32 step

// acc[i][j] += sum_kk a[kk][ty + 16 i] * b[kk][tx + 16 j]
__device__ __forceinline__ void fma_step(float (&acc)[4][4], const float (&a)[kFK][kFT],
                                         const float (&b)[kFK][kFT], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kFK; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[kk][ty + 16 * i], y[i] = b[kk][tx + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

template <bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ sizes, float* __restrict__ out, int rows, int K, int N,
               int G) {
  __shared__ float a[kFK][kFT], b[kFK][kFT];   // [k][row], [k][n]
  int g, rs, re;
  if (!row_tile(sizes, rows, G, blockIdx.y, kFT, g, rs, re)) return;
  const int n0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  if (g < G) {
    const float* B = rhs + (size_t)g * K * N;
    for (int k0 = 0; k0 < K; k0 += kFK) {
      for (int v = threadIdx.x; v < kFK * kFT; v += kThreads) {
        const int r = v / kFK, c = v % kFK;   // a row (or n) and a depth
        a[c][r] = rs + r < re && k0 + c < K ? lhs[(size_t)(rs + r) * K + k0 + c] : 0.f;
        if (TRANS_B) {   // rhs[g] is [N, K]
          b[c][r] = n0 + r < N && k0 + c < K ? B[(size_t)(n0 + r) * K + k0 + c] : 0.f;
        } else {         // rhs[g] is [K, N]
          const int kr = v / kFT, n = v % kFT;
          b[kr][n] = k0 + kr < K && n0 + n < N ? B[(size_t)(k0 + kr) * N + n0 + n] : 0.f;
        }
      }
      __syncthreads();
      fma_step(acc, a, b, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rs + ty + 16 * i;
    if (row >= re) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + 16 * j < N) out[(size_t)row * N + n0 + tx + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_drhs_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ gout,
                    const int* __restrict__ sizes, float* __restrict__ out, int rows, int M,
                    int N) {
  __shared__ float a[kFK][kFT], b[kFK][kFT];   // [row][m], [row][n]
  const int g = blockIdx.z, m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  int start, end;
  group_rows(sizes, g, rows, start, end);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = start; r0 < end; r0 += kFK) {
    for (int v = threadIdx.x; v < kFK * kFT; v += kThreads) {
      const int r = v / kFT, c = v % kFT;
      const bool in = r0 + r < end;
      a[r][c] = in && m0 + c < M ? lhs[(size_t)(r0 + r) * M + m0 + c] : 0.f;
      b[r][c] = in && n0 + c < N ? gout[(size_t)(r0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
    fma_step(acc, a, b, ty, tx);
    __syncthreads();
  }
  float* dst = out + (size_t)g * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + 16 * j < N) dst[(size_t)row * N + n0 + tx + 16 * j] = acc[i][j];
  }
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the number of SMs of the current device: the persistent grids' size
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <typename T>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const int* sizes, void* out, int rows,
                       int k, int n, int groups, int trans_rhs, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  CUtensorMap tm_lhs, tm_rhs;
  const uint64_t lhs_dims[2] = {(uint64_t)k, (uint64_t)rows};
  const uint32_t lhs_box[2] = {64, kTileM};
  const uint64_t rhs_dims[3] = {(uint64_t)(trans_rhs ? k : n), (uint64_t)(trans_rhs ? n : k),
                                (uint64_t)groups};
  const uint32_t rhs_box[3] = {64, (uint32_t)(trans_rhs ? kTileN : kDepth), 1};
  if (!encode_map<T>(&tm_lhs, lhs, 2, lhs_dims, lhs_box) ||
      !encode_map<T>(&tm_rhs, rhs, 3, rhs_dims, rhs_box))
    return cudaErrorInvalidValue;
  const long long units =
      (((long long)rows + kTileM - 1) / kTileM + groups + 1) * ((n + kTileN - 1) / kTileN);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const dim3 grid((unsigned)(units < sms ? units : sms));
  const size_t smem = sizeof(GmmSmem<T>) + 1024;
  if (trans_rhs)
    return launch(gmm_wgmma_kernel<T, true>, kWgThreads, smem, grid, stream, tm_lhs, tm_rhs,
                  sizes, (T*)out, rows, k, n, groups);
  return launch(gmm_wgmma_kernel<T, false>, kWgThreads, smem, grid, stream, tm_lhs, tm_rhs,
                sizes, (T*)out, rows, k, n, groups);
}

template <typename T>
cudaError_t launch_drhs(const void* lhs, const void* gout, const int* sizes, float* out,
                        int rows, int m, int n, int groups, cudaStream_t stream) {
  if (rows == 0) return cudaMemsetAsync(out, 0, (size_t)groups * m * n * sizeof(float), stream);
  CUtensorMap tm_lhs, tm_gout;
  const uint64_t lhs_dims[2] = {(uint64_t)m, (uint64_t)rows};
  const uint64_t gout_dims[2] = {(uint64_t)n, (uint64_t)rows};
  const uint32_t box[2] = {64, kDepth};
  if (!encode_map<T>(&tm_lhs, lhs, 2, lhs_dims, box) ||
      !encode_map<T>(&tm_gout, gout, 2, gout_dims, box))
    return cudaErrorInvalidValue;
  unsigned long long* flags = nullptr;
  cudaError_t err = cudaGetSymbolAddress((void**)&flags, g_flags);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned> epochs{0};
  const unsigned epoch = ++epochs;
  // groups with more than kChunkRows rows are split, each output tile then
  // keeping a flag; past the flags' room, no group is split
  const long long tiles =
      (long long)groups * ((m + kTileM - 1) / kTileM) * ((n + kTileN - 1) / kTileN);
  const int chunk = tiles <= kMaxFlags ? kChunkRows : INT_MAX;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  return launch(gmm_drhs_wgmma_kernel<T>, kWgThreads, sizeof(DrhsSmem<T>) + 1024, dim3(sms),
                stream, tm_lhs, tm_gout, sizes, out, flags, rows, m, n, groups, chunk, epoch);
}

}  // namespace

extern "C" {

// lhs [rows, k], rhs [groups, k, n] (trans_rhs 0) or [groups, n, k] (trans_rhs
// 1), out [rows, n], all f32 (dtype 0), bf16 (1) or f16 (2); group_sizes
// [groups] int32
int bagua_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int rows,
              int k, int n, int groups, int trans_rhs, int dtype, void* stream) {
  if (rows < 0 || groups < 1 || k < 8 || k % 8 || n < 8 || n % 8 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* sizes = (const int*)group_sizes;
  if (dtype == 1) return (int)launch_gmm<bf16>(lhs, rhs, sizes, out, rows, k, n, groups, trans_rhs, s);
  if (dtype == 2) return (int)launch_gmm<f16>(lhs, rhs, sizes, out, rows, k, n, groups, trans_rhs, s);
  const long long tiles = ((long long)rows + kFT - 1) / kFT + groups + 1;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kFT - 1) / kFT, (unsigned)tiles);
  if (trans_rhs)
    gmm_f32_kernel<true><<<grid, kThreads, 0, s>>>((const float*)lhs, (const float*)rhs, sizes,
                                                   (float*)out, rows, k, n, groups);
  else
    gmm_f32_kernel<false><<<grid, kThreads, 0, s>>>((const float*)lhs, (const float*)rhs, sizes,
                                                    (float*)out, rows, k, n, groups);
  return (int)cudaGetLastError();
}

// lhs [rows, m], gout [rows, n], both f32 (dtype 0), bf16 (1) or f16 (2);
// group_sizes [groups] int32; out [groups, m, n] float32
int bagua_gmm_drhs(const void* lhs, const void* gout, const void* group_sizes, void* out,
                   int rows, int m, int n, int groups, int dtype, void* stream) {
  if (rows < 0 || groups < 1 || groups > kMaxGroups || m < 8 || m % 8 || n < 8 || n % 8 ||
      dtype < 0 || dtype > 2 || (m + kFT - 1) / kFT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* sizes = (const int*)group_sizes;
  if (dtype == 1) return (int)launch_drhs<bf16>(lhs, gout, sizes, (float*)out, rows, m, n, groups, s);
  if (dtype == 2) return (int)launch_drhs<f16>(lhs, gout, sizes, (float*)out, rows, m, n, groups, s);
  const dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT, groups);
  gmm_drhs_f32_kernel<<<grid, kThreads, 0, s>>>((const float*)lhs, (const float*)gout, sizes,
                                                (float*)out, rows, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
