// The tile core of the MoR matmuls for sm_90a: one block computes a
// 64-row x 128-column output tile over a range of the contraction, sums
// in float32, and stores it (split-K partials summed across a thread
// block cluster) with an 8-row mask.
//
// Geometry.  A block is 256 threads (8 warps, two warpgroups) and owns
// BM = 64 rows (8 of the reference's 8-row mask blocks, and wgmma's M) x
// BN = 128 columns (one mask column tile).  The contraction streams
// through a ring of STAGES = 4 shared-memory stages, each filled by
// 16-byte cp.async copies from every thread (no registers spent on the
// copy): an A stage of 64 rows x BK and a B stage of BK x 128, BK = 64
// in bf16 and 32 in float32 (24 KB a stage either way, 96 KB of dynamic
// shared memory a block, two blocks an SM).  Only the A rows of the
// 8-row blocks whose outputs are kept (`need`) are copied: the others'
// products are discarded, so whatever their rows hold never reaches an
// output.  A needed row block dead in the step, a row past M, a
// contraction index past K and a column past N zero-fill: the copy
// reads nothing and writes zeros.
//
// The product.  bf16 runs on the tensor cores with wgmma: warpgroup wc
// issues m64n64k16 over columns 64 wc.., reading both operands from
// shared memory through descriptors, 32 float32 accumulators a thread.
// The stages are laid out in the 128-byte swizzle wgmma reads: A (x,
// K-major) as 128-byte rows whose 16-byte chunks are XORed with the row's
// low 3 bits, B (w, N-major, so wgmma transposes it) as 1 KB atoms of 8
// k rows x 64 columns, swizzled the same way; the ring's base is 1 KB
// aligned.  float32 keeps full float32 (no TF32): warp w owns 8-row
// block w, each lane 4 columns, and the FMAs run on the CUDA cores in
// contraction order; a warp whose rows are dead for a step skips.
//
// Split-K.  A cluster of `split` blocks (at most 8, the portable size)
// shares one output tile; block rank r sums its own segment of whole
// 128-wide k blocks.  Each block writes its float32 partial tile into its
// own shared memory, the cluster synchronises, and rank r sums its share
// of the tile from ranks 0, 1, ..., split-1 in that order through
// distributed shared memory, then stores it: the same inputs give the
// same bits on every run.  split = 1 is the same code with a cluster of
// one.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace mor {
namespace tile {

namespace cg = cooperative_groups;

constexpr int BM = 64;            // rows a block
constexpr int BN = 128;           // columns a block (one mask column tile)
constexpr int KB = 128;           // k block: mask and split-K granularity
constexpr int THREADS = 256;      // 8 warps
constexpr int STAGES = 4;         // the cp.async ring
constexpr int STAGE_BYTES = 24576;
// the ring, plus slack to align its base to the 1 KB swizzle atom
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int LDT = BN + 4;       // float row stride of the epilogue tile
static_assert(BM * LDT * 4 <= STAGES * STAGE_BYTES, "the tile fits");

// per element type: 16-byte chunk, stage depth and chunk counts
template <typename T> struct Geo {
  static constexpr int EPC = 16 / sizeof(T);       // elements a chunk
  static constexpr int BK = 128 / sizeof(T);       // 64 bf16, 32 float
  static constexpr int ACH = BK / EPC;             // chunks an A row (8)
  static constexpr int BCH = BN / EPC;             // chunks a B row
  static constexpr int A_BYTES = BM * BK * sizeof(T);
  static constexpr int STEPS = KB / BK;            // steps a k block
  static_assert(A_BYTES + BK * BN * sizeof(T) == STAGE_BYTES, "stage");
};

// Element offsets of 16-byte chunk `ch` of A row `r` / B row `k` in a
// stage.  bf16: the 128-byte swizzle (A rows of 64 k; B in two 8 KB
// column halves of 64, each k row 128 bytes).  float32 is plain: its
// core reads A by broadcast and B by consecutive lanes.
__device__ __forceinline__ int a_off(const __nv_bfloat16*, int r, int ch) {
  return r * 64 + ((ch ^ (r & 7)) << 3);
}
__device__ __forceinline__ int a_off(const float*, int r, int ch) {
  return r * 32 + (ch << 2);
}
__device__ __forceinline__ int b_off(const __nv_bfloat16*, int k, int ch) {
  return (ch >> 3) * 4096 + k * 64 + (((ch & 7) ^ (k & 7)) << 3);
}
__device__ __forceinline__ int b_off(const float*, int k, int ch) {
  return k * BN + (ch << 2);
}

// 16 bytes global -> shared; `ok` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
  // the copies' writes are seen by wgmma's (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring inside the dynamic shared memory, its base 1 KB aligned (the
// swizzle atom: wgmma's swizzle is a function of the address bits).
__device__ __forceinline__ char* ring_base(char* smem) {
  return smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
}

// The operands of one block: x (M, K) and w (K, N) row-major, the
// block's first output row and column.  K and N are multiples of a
// 16-byte chunk (the wrappers pad), so a chunk is wholly in or out.
template <typename T> struct Operands {
  const T* x;
  const T* w;
  int M, K, N, row0, col0;
};

// Fill one stage with the contraction step at k0: the A rows of the
// 8-row blocks in `need` (zeros for those whose bit in `rows`, the
// blocks live in the step, is 0, and for rows at or past M) and the B
// rows.
template <typename T>
__device__ __forceinline__ void load_stage(T* sA, T* sB, const Operands<T>& o,
                                           int k0, unsigned rows,
                                           unsigned need) {
  using G = Geo<T>;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * G::ACH / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int r = idx / G::ACH, ch = idx % G::ACH;
    if (!((need >> (r / TM)) & 1u)) continue;
    const int gk = k0 + ch * G::EPC;
    const bool ok = ((rows >> (r / TM)) & 1u) && gk < o.K &&
                    o.row0 + r < o.M;
    cp_async16(sA + a_off(sA, r, ch),
               ok ? o.x + (size_t)(o.row0 + r) * o.K + gk : o.x, ok);
  }
#pragma unroll
  for (int i = 0; i < G::BK * G::BCH / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int k = idx / G::BCH, ch = idx % G::BCH;
    const int gk = k0 + k, gc = o.col0 + ch * G::EPC;
    const bool ok = gk < o.K && gc < o.N;
    cp_async16(sB + b_off(sB, k, ch),
               ok ? o.w + (size_t)gk * o.N + gc : o.w, ok);
  }
}

// a shared-memory matrix descriptor, 128-byte swizzle (byte offsets)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// d += A (64 x 16, K-major) B (16 x 64), bf16 in, float32 accumulators:
// d[nt] is n8 tile nt of warp w's rows 16 w.. in the m16n8 layout.  B is
// N-major (transposed on read) for TRANS_B = 1, K-major for 0.
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// d += A (64 x 16, K-major) B (16 x 32), both from shared memory, B
// K-major: the 32-column form of the product above (d[nt]: n8 tile nt)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B with A (64 x 16 bf16) from registers, in the m16n8k16 A
// layout of warp w's rows 16 w.., and B (16 x 64) N-major from shared
// memory (transposed on read): float32 accumulators as above
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two floats as a bf16x2 word (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc += A B for one stage on the tensor cores: warpgroup wc takes
// columns 64 wc.., four k16 steps, then waits for them so that the stage
// may be refilled
__device__ __forceinline__ void compute_stage(const __nv_bfloat16* sA,
                                              const __nv_bfloat16* sB,
                                              float (&acc)[8][4], unsigned) {
  const int wc = threadIdx.x >> 7;
  const uint32_t a0 = smem_u32(sA), b0 = smem_u32(sB) + wc * 8192;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < Geo<__nv_bfloat16>::BK / 16; ++s)
    // A: +32 bytes a k16 step inside the swizzled row, 1 KB between
    // 8-row groups; B: +2 KB (two 8-row atoms) a step, 1 KB between
    // atoms along k (64 columns are one atom wide)
    wgmma_m64n64k16(acc, sw128_desc(a0 + 32 * s, 0, 1024),
                    sw128_desc(b0 + 2048 * s, 1024, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// acc[i][c] += A B for one stage on the CUDA cores: warp w's row i of
// block w, columns 4 lane + c, in contraction order
__device__ __forceinline__ void compute_stage(const float* sA,
                                              const float* sB,
                                              float (&acc)[8][4],
                                              unsigned rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!((rows >> warp) & 1u)) return;               // uniform per warp
#pragma unroll
  for (int k = 0; k < Geo<float>::BK; k += 4) {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          sA + (warp * 8 + i) * Geo<float>::BK + k);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(
          sB + (k + kk) * BN + lane * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i][kk], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], b.w, acc[i][3]);
      }
    }
  }
}

// The contraction steps [s0, s1) (step s covers k in [s BK, (s+1) BK))
// through the ring.  rows_at(s) gives the 8-row blocks live at step s;
// a step with none is neither loaded nor multiplied.
template <typename T, typename RowsAt>
__device__ __forceinline__ void mainloop(char* ring, const Operands<T>& o,
                                         int s0, int s1, RowsAt rows_at,
                                         unsigned need, float (&acc)[8][4]) {
  using G = Geo<T>;
  auto sa = [&](int st) {
    return reinterpret_cast<T*>(ring + st * STAGE_BYTES);
  };
  auto sb = [&](int st) {
    return reinterpret_cast<T*>(ring + st * STAGE_BYTES + G::A_BYTES);
  };
  auto next = [&](int s) {
    while (s < s1 && rows_at(s) == 0u) ++s;
    return s;
  };
  int ls = next(s0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (ls < s1) {
      load_stage(sa(st), sb(st), o, ls * G::BK, rows_at(ls), need);
      ls = next(ls + 1);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int cs = next(s0); cs < s1; cs = next(cs + 1)) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ws = (stage + STAGES - 1) % STAGES;   // computed last round
    if (ls < s1) {
      load_stage(sa(ws), sb(ws), o, ls * G::BK, rows_at(ls), need);
      ls = next(ls + 1);
    }
    cp_async_commit();
    compute_stage(sa(stage), sb(stage), acc, rows_at(cs));
    stage = (stage + 1) % STAGES;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the float32 tile at `tile` (BM x LDT) from each thread's accumulators
__device__ __forceinline__ void acc_to_tile(const __nv_bfloat16*,
                                            const float (&acc)[8][4],
                                            float* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int c0 = (warp >> 2) * 64 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = c0 + nt * 8;
    *reinterpret_cast<float2*>(tile + r * LDT + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(tile + (r + 8) * LDT + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}
__device__ __forceinline__ void acc_to_tile(const float*,
                                            const float (&acc)[8][4],
                                            float* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(tile + (warp * 8 + i) * LDT + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The number of non-zero bytes of m[lo, hi), in every thread (all of
// the block calls it; `red` is 8 ints of shared memory).
__device__ __forceinline__ int block_count(const unsigned char* m, int lo,
                                           int hi, int* red) {
  int c = 0;
  for (int f = lo + (int)threadIdx.x; f < hi; f += THREADS) c += m[f] != 0;
  c = __reduce_add_sync(0xffffffffu, c);
  __syncthreads();                       // red is free (earlier calls)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  return total;
}

// Rank `rank` of `split` owns the tile's float4 groups [q0, q1).
__device__ __forceinline__ void rank_range(int rank, int split, int& q0,
                                           int& q1) {
  constexpr int n4 = BM * BN / 4;
  const int per = (n4 + split - 1) / split;
  q0 = min(n4, rank * per);
  q1 = min(n4, q0 + per);
}

// An output tile of exact zeros, each rank its share (no cluster sync:
// every block of the cluster takes this path together).
template <typename T>
__device__ void zero_tile(T* out, int M, int N, int row0, int col0,
                          int rank, int split) {
  int q0, q1;
  rank_range(rank, split, q0, q1);
  for (int q = q0 + (int)threadIdx.x; q < q1; q += THREADS) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    if (row0 + r < M && col0 + c < N)
      store4(out + (size_t)(row0 + r) * N + col0 + c,
             make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Sum the cluster's partial tiles in rank order and store rows < M,
// columns < N; an 8-row block whose bit in `store_rows` is 0 is stored
// as exact zeros.  Every block of the cluster calls this.
template <typename T>
__device__ void epilogue(char* ring, const float (&acc)[8][4], T* out,
                         int M, int N, int row0, int col0,
                         unsigned store_rows, int split) {
  float* tile = reinterpret_cast<float*>(ring);
  acc_to_tile(static_cast<const T*>(nullptr), acc, tile);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                        // every partial is in place
  int q0, q1;
  rank_range((int)cluster.block_rank(), split, q0, q1);
  for (int q = q0 + (int)threadIdx.x; q < q1; q += THREADS) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    if (row0 + r >= M || col0 + c >= N) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((store_rows >> (r / TM)) & 1u) {
      for (int p = 0; p < split; ++p) {   // fixed order: deterministic
        const float4 u = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(tile, p) + r * LDT + c);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    store4(out + (size_t)(row0 + r) * N + col0 + c, v);
  }
  cluster.sync();                        // no block leaves while read
}

// One block's tile after its prologue: the contraction steps [s0, s1)
// (rows_at(s): the 8-row blocks live at step s), then the epilogue.
// `need` is the 8-row blocks whose outputs are kept.
template <typename T, typename RowsAt>
__device__ __forceinline__ void run_tile(char* smem, const Operands<T>& o,
                                         int s0, int s1, RowsAt rows_at,
                                         T* out, unsigned need, int split) {
  float acc[8][4] = {};
  char* ring = ring_base(smem);
  mainloop(ring, o, s0, s1, rows_at, need, acc);
  epilogue(ring, acc, out, o.M, o.N, o.row0, o.col0, need, split);
}

// Launch `kernel` on a (grid.x / split) x grid.y x grid.z grid of
// clusters of `split` blocks along x, with SMEM_BYTES of dynamic shared
// memory (the attribute is set once a device, in `ready`).
template <typename... P, typename... A>
int launch(void (*kernel)(P...), unsigned long long& ready, dim3 grid,
           int split, cudaStream_t stream, A... args) {
  static_assert(THREADS == 256, "launch_cluster's block");
  return launch_cluster(kernel, ready, SMEM_BYTES, grid, split, SMEM_BYTES,
                        stream, args...);
}

}  // namespace tile
}  // namespace mor
