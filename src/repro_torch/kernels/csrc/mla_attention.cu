// Absorbed-MLA paged flash attention for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:302
// `mla_paged_flash` (pallas_call at l.348) in its single-device form:
// normalised output (partial=False), no shard window (lo=None).  The
// query arrives in the rank-kr latent space (W_uk absorbed by the
// caller): for each slot b the kernel walks the block-table entries in
// order; a null entry (page id 0) is skipped before anything is loaded;
// each live page's rows are scored (q_lat . c_kv + q_pe . k_pe) * scale
// in float32, a row is masked unless its tag is >= 0 and <= qpos; the
// pages fold into online-softmax statistics (m, l, acc) over the kr
// latent columns, all float32; the output o_lat = acc / max(l, 1e-30)
// in q's dtype, laid out (B, C, h, kr).  The caller absorbs W_uv.
//
// Bound on the H100: near the ridge.  A cached token costs 2 h (kr +
// rd + kr) flops (278.5 kFLOP at full width) for its 1,152 bytes of
// latent and rope row, ~242 flops a byte against the bf16 ridge of
// ~295.  A decode dispatch (8 slots, ~16k cached tokens) is bound by
// those bytes (~6 us); a mixed one (8 slots x 32 rows over ~64 keys) by
// q and the output (~71 MB), with operations a fifth of that.
//
// Design for bf16 (serving): MLA is multi-query attention with h = 128
// query heads reading the same latent row (kr + rd = 576 values) of
// every key, so it is a matrix product per slot.
//   - A block owns an M tile of 64 (query row, head) pairs of one slot
//     (c-major, so a tile shares one qpos when h >= 64); their [q_lat |
//     q_pe] rows are staged once in shared memory (64 x 576 bf16, 72 KB,
//     by TMA) in the 128-byte swizzle wgmma reads (regions of 64
//     columns: kr / 64 latent ones, then one for the rope, rd <= 64).
//   - Keys stream as K tiles of 64 rows of whole live pages (8 pages of
//     8): each block first compacts its table range, 256 entries at a
//     time, into the list of live page ids, so a null entry is never
//     loaded.  The tensor memory accelerator (TMA) copies a tile into a
//     ring of 2 stages, one 8-row box of a page per 64-column region
//     (pages are not contiguous; the boxes land in the swizzle wgmma
//     reads), and the rows' tags by a bulk copy; warp w's lane 0 issues
//     the tile's 8-row group w, and the stage's mbarrier counts the
//     bytes.  The next tile flies while this one is multiplied, and the
//     warps issue 80 copies a tile (10 a warp), not 4,608 16-byte ones,
//     whose issue held them for about a quarter of a tile (PERF.md).
//     Pages must hold a multiple of 8 rows.
//   - Scores S = Q K^T (64 x 64, float32 sums) on the tensor cores:
//     wgmma m64n64k16 from shared memory, both operands K-major, by
//     warpgroup 0, which also runs the masks and the online softmax and
//     hands P and the rows' rescales to warpgroup 1 through shared
//     memory (ldmatrix reads them back as A fragments).  Each score is
//     computed once: S reads Q and the tile from shared memory at the
//     rate that bounds it, and two warpgroups scoring the same tile
//     doubled those reads.
//   - V is the staged K tile's first kr columns: the latent rows are
//     read from device memory once and serve both products.  The
//     accumulator (64 x 512 float32) is split over the two warpgroups,
//     256 columns each, and P.V runs on wgmma m64n256k16 with P from
//     registers and V N-major (the transposed read of the same tile).
//   - P is split into bf16 hi + lo halves (two products): P in bf16
//     alone misses the one-bf16-step bar against the float32 plain
//     version on diffuse softmaxes (a mixed dispatch's 64-96 keys).
//   - The context split: at decode (8 slots x 2 M tiles) the tiles
//     alone fill an eighth of the SMs, so the table columns [0, W) of a
//     slot are split into `split` ranges of whole entries (at most 8,
//     planned on the host from shapes), one block each, and the blocks
//     of a split form a cluster.  Each rank leaves its (m, l, acc) in
//     its own shared memory, reusing the ring once its walk ends, and
//     rank r merges its share of the rows from ranks 0 .. split-1, in
//     that order, through distributed shared memory: one launch, no
//     float32 partials in device memory, the same bits on every run.
// float32 (the reduced models' card-vs-CPU check) keeps full float32
// products on the CUDA cores: one block of 8 pairs walks the whole
// table, 8 keys a step (`cc` below).
//
// The finite sentinel: a masked score is -1e30, never -INFINITY, as in
// the Pallas kernel, so a pair that sees no key in any live page gets
// exp(0) = 1 weights over the live pages' rows, i.e. what the Pallas
// kernel gives, and a slot whose table is all null gives exact zeros.
// A rank whose range holds no live page merges as m = -1e30, l = 0,
// acc = 0 (never -INFINITY, whose exp(-inf - (-inf)) would be NaN);
// one whose live keys are all masked has m = -1e30 and loses to any
// rank with a real score (exp(-1e30 - m) = 0), as in a single pass.
// Rows past a tile's live pages are zeros (boxes past the pool) and
// score -INFINITY: they weigh nothing, and stale shared memory never
// meets a zero weight.  The
// strided block table and 64-bit pool offsets are as in
// paged_attention.cu.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_tile.cuh"

namespace mla {

using mor::load16;
using mor::smem_u32;

constexpr float NEG_INF = -1e30f;                // the finite sentinel
constexpr int MAX_KR = 512;

// ==========================================================================
// float32: the CUDA cores
// ==========================================================================
namespace cc {

constexpr int NT = 256;                          // threads per block
constexpr int R = 8;                             // pairs per block
constexpr int KT = 8;                            // keys per step
constexpr int SL = NT / ((R / 2) * (KT / 2));    // 16 lanes per 2x2 block
constexpr int NCOL = MAX_KR / NT;                // latent columns a thread

// floats between staged rows: D rounded up so that stride % 32 == 16
__host__ __device__ inline int row_stride(int D) {
  return D + ((16 - D % 32) + 32) % 32;
}

__host__ __device__ inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(R + KT) * row_stride(D) + 2 * R * KT +
                          3 * R) +
         sizeof(int) * (KT + R);
}

// One block serves R pairs of one slot and walks the slot's whole
// table; per step of KT keys: the 256 threads stage the keys' rows
// (padded so that stride % 32 == 16) and tags; 16 groups of 16 lanes
// score a 2 (pairs) x 2 (keys) block over every 16th dim, summed by
// shuffles; one thread per pair updates (m, l); every thread rescales
// its accumulators (columns t and t + 256 of all R pairs) and adds
// p . c_kv.  The walk, step and shuffle orders are fixed.
__global__ void __launch_bounds__(NT)
mla_paged_kernel(const float* __restrict__ ql, const float* __restrict__ qe,
                 const float* __restrict__ ck, const float* __restrict__ cpe,
                 const int* __restrict__ cp, const int* __restrict__ tbl,
                 const int* __restrict__ qpos, float* __restrict__ out, int C,
                 int h, int kr, int rd, int P, int W, int tbl_stride,
                 float scale) {
  extern __shared__ float smem[];
  const int D = kr + rd, S = row_stride(D);
  const int b = blockIdx.y, p0 = blockIdx.x * R;
  const int Rb = min(R, C * h - p0);             // live pairs here
  const int tid = threadIdx.x;
  float* qs = smem;                              // R x S
  float* ks = qs + R * S;                        // KT x S
  float* Sc = ks + KT * S;                       // R x KT scores
  float* Pw = Sc + R * KT;                       // R x KT weights
  float* Mr = Pw + R * KT;                       // running max
  float* Lr = Mr + R;                            // running sum
  float* Cr = Lr + R;                            // this step's rescale
  int* tg = reinterpret_cast<int*>(Cr + R);      // KT tags
  int* qp = tg + KT;                             // R query positions

  constexpr int VEC = 4;                         // floats per load
  const int DV = D / VEC;                        // loads per row
  const size_t row0 = (size_t)b * C * h + p0;    // first pair's q row
  for (int e = tid; e < R * DV; e += NT) {
    const int r = e / DV, d = (e % DV) * VEC;
    float v[VEC] = {};
    if (r < Rb) {
      if (d < kr) load16(ql + (row0 + r) * kr + d, v);
      else load16(qe + (row0 + r) * rd + d - kr, v);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[r * S + d + i] = v[i];
  }
  if (tid < R) {
    qp[tid] = tid < Rb ? qpos[(size_t)b * C + (p0 + tid) / h] : -1;
    Mr[tid] = NEG_INF;
    Lr[tid] = 0.f;
  }
  float acc[NCOL][R];
#pragma unroll
  for (int j = 0; j < NCOL; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r] = 0.f;

  // the thread's 2 x 2 score block: pairs r0, r0 + 1; keys t0, t0 + 4
  const int combo = tid / SL, slice = tid % SL;
  const int r0 = 2 * (combo / (KT / 2)), t0 = combo % (KT / 2);
  __syncthreads();

  for (int j = 0; j < W; ++j) {
    const int pg = tbl[(size_t)b * tbl_stride + j];
    if (pg == 0) continue;                       // null page: nothing loaded
    const size_t pbase = (size_t)pg * P;         // the page's first row
    for (int k0 = 0; k0 < P; k0 += KT) {
      // 1. stage the step's keys
#pragma unroll 3
      for (int e = tid; e < KT * DV; e += NT) {
        const int t = e / DV, d = (e % DV) * VEC;
        float v[VEC] = {};
        if (k0 + t < P) {
          const size_t row = pbase + k0 + t;
          if (d < kr) load16(ck + row * kr + d, v);
          else load16(cpe + row * rd + d - kr, v);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) ks[t * S + d + i] = v[i];
      }
      if (tid < KT) tg[tid] = k0 + tid < P ? cp[pbase + k0 + tid] : -1;
      __syncthreads();
      // 2. scores
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      const float* q0 = qs + r0 * S;
      const float* q1 = q0 + S;
      const float* k0p = ks + t0 * S;
      const float* k1p = ks + (t0 + KT / 2) * S;
      for (int d = slice; d < D; d += SL) {
        const float x0 = q0[d], x1 = q1[d], y0 = k0p[d], y1 = k1p[d];
        a00 = fmaf(x0, y0, a00);
        a01 = fmaf(x0, y1, a01);
        a10 = fmaf(x1, y0, a10);
        a11 = fmaf(x1, y1, a11);
      }
#pragma unroll
      for (int off = SL / 2; off > 0; off /= 2) {
        a00 += __shfl_xor_sync(0xffffffffu, a00, off);
        a01 += __shfl_xor_sync(0xffffffffu, a01, off);
        a10 += __shfl_xor_sync(0xffffffffu, a10, off);
        a11 += __shfl_xor_sync(0xffffffffu, a11, off);
      }
      if (slice == 0) {
        const float a[2][2] = {{a00, a01}, {a10, a11}};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = r0 + i, t = t0 + u * (KT / 2);
            const int tag = tg[t];
            float sc = -INFINITY;                // past the page's end
            if (k0 + t < P)
              sc = (tag >= 0 && tag <= qp[r]) ? a[i][u] * scale : NEG_INF;
            Sc[r * KT + t] = sc;
          }
      }
      __syncthreads();
      // 3. online-softmax statistics, one thread per pair
      if (tid < R) {
        const float mp = Mr[tid];
        float mx = mp;
#pragma unroll
        for (int t = 0; t < KT; ++t) mx = fmaxf(mx, Sc[tid * KT + t]);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const float p = expf(Sc[tid * KT + t] - mx);
          Pw[tid * KT + t] = p;
          sum += p;
        }
        const float corr = expf(mp - mx);
        Lr[tid] = Lr[tid] * corr + sum;
        Mr[tid] = mx;
        Cr[tid] = corr;
      }
      __syncthreads();
      // 4. acc = acc * corr + p . c_kv over the thread's columns
      float kv[NCOL][KT];
#pragma unroll
      for (int jc = 0; jc < NCOL; ++jc) {
        const int c = tid + jc * NT;
#pragma unroll
        for (int t = 0; t < KT; ++t) kv[jc][t] = c < kr ? ks[t * S + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float corr = Cr[r];
#pragma unroll
        for (int jc = 0; jc < NCOL; ++jc) {
          float a = acc[jc][r] * corr;
#pragma unroll
          for (int t = 0; t < KT; ++t) a = fmaf(Pw[r * KT + t], kv[jc][t], a);
          acc[jc][r] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int jc = 0; jc < NCOL; ++jc) {
    const int c = tid + jc * NT;
    if (c >= kr) continue;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < Rb) out[(row0 + r) * kr + c] = acc[jc][r] / fmaxf(Lr[r], 1e-30f);
  }
}

int launch(const float* ql, const float* qe, const float* ck,
           const float* cpe, const int* cp, const int* tbl, const int* qpos,
           float* out, int B, int C, int h, int kr, int rd, int P, int W,
           int tbl_stride, float scale, cudaStream_t st) {
  if (kr < 1 || kr > MAX_KR || rd < 0 || P < 1 || C * h < 1 || kr % 4 ||
      rd % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kr + rd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C * h + R - 1) / R, B);
  mla_paged_kernel<<<grid, NT, smem, st>>>(ql, qe, ck, cpe, cp, tbl, qpos,
                                           out, C, h, kr, rd, P, W,
                                           tbl_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ==========================================================================
// bf16: the tensor cores
// ==========================================================================
namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mor::tile::pack_bf16;
using mor::tile::sw128_desc;

constexpr int THREADS = 256;                  // two warpgroups
constexpr int BM = 64;                        // pairs a block (wgmma's M)
constexpr int BK = 64;                        // keys a tile
constexpr int REGIONS = MAX_KR / 64 + 1;      // 64-column swizzled regions:
                                              // the latent's, the rope's
constexpr int REGION = BM * 128;              // bytes: 64 rows x 128 bytes
constexpr int TILE = REGIONS * REGION;        // 73,728 bytes
constexpr int LIST = THREADS;                 // table entries per scan
constexpr int MAX_SPLIT = 8;                  // the portable cluster
constexpr int LDO = MAX_KR + 8;               // float stride, merge tile
constexpr int LDB = MAX_KR + 8;               // bf16 stride, output tile
constexpr int GROUP = 8 * 128;                // bytes: 8 rows of a region
// shared memory, from the 1 KB aligned base: Q, two K stages, the
// stages' tags, the live-page list, the pairs' qpos, warp counts, the
// barriers of q's copies and of the two stages, P's lo half
constexpr int OFF_K = TILE;
constexpr int OFF_TAG = OFF_K + 2 * TILE;
constexpr int OFF_LIST = OFF_TAG + 2 * BK * 4;
constexpr int OFF_QPOS = OFF_LIST + LIST * 4;
constexpr int OFF_CNT = OFF_QPOS + BM * 4;
constexpr int OFF_BAR = OFF_CNT + 32;
constexpr int OFF_PLO = OFF_BAR + 32;         // P's lo half, 64 x 128 bytes
constexpr int SMEM_BYTES = OFF_PLO + BM * 128 + 1024;   // + alignment slack
static_assert(SMEM_BYTES <= 232448, "the H100's shared memory a block");
// the merge reuses Q and the ring: the acc tile, m, l, and per row the
// ranks' weights and the denominator
static_assert((BM * LDO + 2 * BM + BM * (MAX_SPLIT + 1)) * 4 <= OFF_TAG,
              "the merge tile fits in the ring");
static_assert(THREADS / 32 == BK / 8, "a warp stages one 8-row group");

// The copies run on the tensor memory accelerator (TMA), completing on
// an mbarrier in shared memory: `expect` arrives and announces the
// bytes, `wait` spins until the barrier's phase `parity` completes.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the box at (column c0, row c1) of a 2D tensor map -> shared `dst`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes -> shared `dst`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers: 1 among warpgroup 0's 128 threads, 2 between
// warpgroup 0 (arrives) and warpgroup 1 (waits).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, as an m16n8k16 A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B: A (64 x 16 bf16) from registers in the m16n8k16 layout of
// warp w's rows 16 w.., B (16 x 256) N-major from shared memory
// (transposed on read), float32 accumulators d[j] = n8 tile j
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[32][4],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One block: pairs [p0, p0 + 64) of slot b against its table columns
// [lo, hi) (rank `rank` of the slot's `split`).  The tensor maps view
// q_lat / q_pe (64-row boxes) and the latent / rope pools (8-row boxes)
// as 2D bf16 (rows, columns), 64 columns a box, 128-byte swizzled; a
// box past the pool's `rows` rows is zeros.
__global__ void __launch_bounds__(THREADS, 1)
mla_paged_kernel(const __grid_constant__ CUtensorMap tm_ql,
                 const __grid_constant__ CUtensorMap tm_qe,
                 const __grid_constant__ CUtensorMap tm_ck,
                 const __grid_constant__ CUtensorMap tm_cpe,
                 const int* __restrict__ cp, const int* __restrict__ tbl,
                 const int* __restrict__ qpos, bf16* __restrict__ out, int C,
                 int h, int kr, int rd, int P, int rows, int W,
                 int tbl_stride, float scale, int split) {
  extern __shared__ __align__(16) char smem_raw[];
  char* sm = mor::tile::ring_base(smem_raw);
  int* tags = reinterpret_cast<int*>(sm + OFF_TAG);
  int* list = reinterpret_cast<int*>(sm + OFF_LIST);
  int* qps = reinterpret_cast<int*>(sm + OFF_QPOS);
  int* cnt = reinterpret_cast<int*>(sm + OFF_CNT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, ra = 16 * (warp & 3) + (lane >> 2), rb = ra + 8;
  const int tq = lane & 3;
  const int rank = blockIdx.x % split, b = blockIdx.y;
  const int npairs = C * h, p0 = (blockIdx.x / split) * BM;
  const size_t row0 = (size_t)b * npairs + p0;
  const int lo = (int)((long long)W * rank / split);
  const int hi = (int)((long long)W * (rank + 1) / split);

  // Regions: the latent columns' nlat (64 columns each, the last
  // zero-filled past kr), then the rope's (rd <= 64).
  const int nlat = (kr + 63) / 64, nreg = nlat + 1;
  const uint32_t bar_q = smem_u32(sm + OFF_BAR);
  auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k(0), THREADS / 32);    // a stage: one arrival a warp
    mbar_init(bar_k(1), THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this thread's entry of the first scan, read before q's copies are
  // issued so that its latency hides behind them
  const int* trow = tbl + (size_t)b * tbl_stride;
  int pg_next = lo + tid < hi ? trow[lo + tid] : 0;

  // the pairs' q rows (one 64-row box a region; rows past the last
  // slot's are zeros, a next slot's rows are read and never stored)
  if (tid == 0) {
    const int q0 = (int)row0;
    mbar_expect(bar_q, nreg * REGION);
    for (int r = 0; r < nlat; ++r)
      tma_box(smem_u32(sm) + r * REGION, &tm_ql, 64 * r, q0, bar_q);
    tma_box(smem_u32(sm) + nlat * REGION, &tm_qe, 0, q0, bar_q);
  }
  if (tid < BM)
    qps[tid] = p0 + tid < npairs ? qpos[(size_t)b * C + (p0 + tid) / h]
                                 : -1;
  bool q_ready = false;

  // K tiles: E entries of RE rows each (RE = P when a page fits a tile,
  // else 64 rows of one page, nsub tiles a page); the first nv rows of
  // a tile are real keys.  P % 8 == 0, so warp w stages the tile's
  // 8-row group w: nreg boxes of one page's rows and their 8 tags, or
  // zero boxes (past the pool) where the group holds no key.
  const int RE = min(P, BK), E = BK / RE, nsub = (P + BK - 1) / BK;
  auto tile_rows = [&](int i, int nlive) {
    return P <= BK ? min(E, nlive - (i / nsub) * E) * P
                   : min(BK, P - (i % nsub) * BK);
  };
  auto stage_tile = [&](int i, int st, int nlive) {
    if (lane != 0) return;
    const int k = 8 * warp;               // the group's first key
    const bool ok = k < tile_rows(i, nlive);
    const int row = ok ? list[(i / nsub) * E + k / RE] * P +
                             (i % nsub) * BK + k % RE
                       : rows;
    const uint32_t dst = smem_u32(sm + OFF_K + st * TILE) + warp * GROUP;
    mbar_expect(bar_k(st), nreg * GROUP + (ok ? 32 : 0));
    for (int r = 0; r < nlat; ++r)
      tma_box(dst + r * REGION, &tm_ck, 64 * r, row, bar_k(st));
    tma_box(dst + nlat * REGION, &tm_cpe, 0, row, bar_k(st));
    if (ok)
      bulk_copy(smem_u32(tags + st * BK + k), cp + row, 32, bar_k(st));
  };
  uint32_t phases = 0u;                   // bit st: stage st's parity
  int g = 0;                              // tiles computed so far

  float o[32][4];                 // rows ra, rb; columns 256 wg + 8 j + ..
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  const uint32_t qa = smem_u32(sm);

  // Tile i on stage st (nv real keys).  Warpgroup 0 scores it (S, the
  // masks, the online softmax) and hands P (bf16 hi and lo halves, as
  // m16n8k16 A fragments) and each row's rescale to warpgroup 1 through
  // shared memory: hi in the stage's rope region, dead once S is done,
  // lo in its own buffer, both as 64 rows of 128 bytes with the
  // regions' chunk swizzle; the rescales over the stage's tags.  Each
  // score is computed once and its shared-memory reads halve.
  auto compute = [&](int st, int nv) {
    const uint32_t ka = smem_u32(sm + OFF_K + st * TILE);
    const int* tg = tags + st * BK;
    float* corr = reinterpret_cast<float*>(tags + st * BK);
    const uint32_t phi = ka + nlat * REGION, plo = smem_u32(sm + OFF_PLO);
    uint32_t ph[4][4], pl[4][4];
    float ca, cb;
    if (wg == 0) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
      for (int r = 0; r < nreg; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)   // +32 bytes a k16 step in the row
          mor::tile::wgmma_m64n64k16<0>(
              s, sw128_desc(qa + r * REGION + 32 * k, 0, 1024),
              sw128_desc(ka + r * REGION + 32 * k, 0, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // masks, the online softmax (a row's 64 keys over the lane quad)
      const int qpa = qps[ra], qpb = qps[rb];
      float xa = ma, xb = mb;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * tq + e, tag = tg[key];
          const bool real = key < nv;
          s[j][e] = !real ? -INFINITY
                    : (tag >= 0 && tag <= qpa) ? s[j][e] * scale : NEG_INF;
          s[j][2 + e] = !real ? -INFINITY
                        : (tag >= 0 && tag <= qpb) ? s[j][2 + e] * scale
                                                    : NEG_INF;
          xa = fmaxf(xa, s[j][e]);
          xb = fmaxf(xb, s[j][2 + e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      ca = __expf(ma - xa);
      cb = __expf(mb - xb);
      ma = xa;
      mb = xb;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = __expf(s[j][0] - xa);
        s[j][1] = __expf(s[j][1] - xa);
        s[j][2] = __expf(s[j][2] - xb);
        s[j][3] = __expf(s[j][3] - xb);
        sa += s[j][0] + s[j][1];
        sb += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sb += __shfl_xor_sync(0xffffffffu, sb, off);
      }
      la = la * ca + sa;
      lb = lb * cb + sb;
      // P as A fragments of the four k16 steps: hi = bf16(p), lo =
      // bf16(p - hi)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* v = s[2 * k + (u >> 1)] + 2 * (u & 1);
          ph[k][u] = pack_bf16(v[0], v[1]);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&ph[k][u]);
          pl[k][u] = pack_bf16(v[0] - __low2float(hv), v[1] - __high2float(hv));
        }
      named_sync(1, 128);                 // every tag is read
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (u & 1) ? rb : ra, kc = 2 * k + (u >> 1);
          const uint32_t off = row * 128 + ((kc ^ (row & 7)) << 4) + 4 * tq;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(phi + off),
                       "r"(ph[k][u]) : "memory");
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(plo + off),
                       "r"(pl[k][u]) : "memory");
        }
      if (tq == 0) {
        corr[ra] = ca;
        corr[rb] = cb;
      }
      named_arrive(2, THREADS);           // P and the rescales are out
    } else {
      named_sync(2, THREADS);
      ca = corr[ra];
      cb = corr[rb];
      // ldmatrix: lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of
      // its warp's 16, key chunk (l >> 4) of the k16 step
      const int mr = 16 * (warp & 3) + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int kc = 2 * k + (lane >> 4);
        const uint32_t off = mr * 128 + ((kc ^ (mr & 7)) << 4);
        ldsm_x4(ph[k], phi + off);
        ldsm_x4(pl[k], plo + off);
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[j][0] *= ca;
      o[j][1] *= ca;
      o[j][2] *= cb;
      o[j][3] *= cb;
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // V: the warpgroup's 4 regions (256 columns), +2 KB (16 key rows) a
    // k16 step, 8 KB between 64-column atoms, 1 KB between 8-row groups
    const uint32_t va = ka + wg * 4 * REGION;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n256k16_rs(o, ph[k], sw128_desc(va + 2048 * k, 8192, 1024));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n256k16_rs(o, pl[k], sw128_desc(va + 2048 * k, 8192, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };

  for (int c0 = lo; c0 < hi; c0 += LIST) {
    // compact the live entries of [c0, c0 + LIST) into `list`, in order
    const int pg = pg_next;
    const unsigned live = __ballot_sync(0xffffffffu, pg != 0);
    if (lane == 0) cnt[warp] = __popc(live);
    __syncthreads();
    int base = 0, nlive = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      base += w < warp ? cnt[w] : 0;
      nlive += cnt[w];
    }
    if (pg != 0) list[base + __popc(live & ((1u << lane) - 1u))] = pg;
    __syncthreads();
    const int jn = c0 + LIST + tid;       // the next scan's entry, early
    pg_next = jn < hi ? trow[jn] : 0;
    const int ntiles = (nlive + E - 1) / E * nsub;
    if (ntiles > 0) stage_tile(0, g & 1, nlive);
    for (int i = 0; i < ntiles; ++i, ++g) {
      const int st = g & 1;
      // the next tile flies while this one computes (its stage was
      // freed by the barrier that ended the tile before)
      if (i + 1 < ntiles) stage_tile(i + 1, st ^ 1, nlive);
      if (!q_ready) {
        mbar_wait(bar_q, 0);
        q_ready = true;
      }
      mbar_wait(bar_k(st), (phases >> st) & 1u);
      phases ^= 1u << st;
      compute(st, tile_rows(i, nlive));
      // this thread's generic writes and reads of the stage (P, the
      // rescales) are ordered before the TMA copies that refill it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                    // its stage may be refilled
    }
  }
  if (!q_ready) mbar_wait(bar_q, 0);      // an idle range's q copies

  __syncthreads();                        // Q and the ring are free
  // the rows' statistics, which warpgroup 0 kept, in shared memory
  float* acc = reinterpret_cast<float*>(sm);
  float* mrow = acc + BM * LDO;
  float* lrow = mrow + BM;
  float* wts = lrow + BM;                 // BM x (MAX_SPLIT + 1)
  if (wg == 0 && tq == 0) {
    mrow[ra] = ma;
    lrow[ra] = la;
    mrow[rb] = mb;
    lrow[rb] = lb;
  }
  if (split == 1) {
    // the normalised rows through shared memory (rows LDB apart: a
    // quad's bf16 pairs fall in distinct banks), then 16-byte stores
    __syncthreads();
    bf16* ot = reinterpret_cast<bf16*>(sm);
    const float ia = 1.f / fmaxf(lrow[ra], 1e-30f);
    const float ib = 1.f / fmaxf(lrow[rb], 1e-30f);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 256 * wg + 8 * j + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(ot + ra * LDB + c) =
          __floats2bfloat162_rn(o[j][0] * ia, o[j][1] * ia);
      *reinterpret_cast<__nv_bfloat162*>(ot + rb * LDB + c) =
          __floats2bfloat162_rn(o[j][2] * ib, o[j][3] * ib);
    }
    __syncthreads();
    const int n8 = kr / 8;
    for (int e = tid; e < BM * n8; e += THREADS) {
      const int r = e / n8, c = (e % n8) * 8;
      if (p0 + r < npairs)
        *reinterpret_cast<uint4*>(out + (row0 + r) * kr + c) =
            *reinterpret_cast<const uint4*>(ot + r * LDB + c);
    }
    return;
  }

  // the merge: each rank's (m, l, acc) in its own shared memory
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 256 * wg + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(acc + ra * LDO + c) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(acc + rb * LDO + c) =
        make_float2(o[j][2], o[j][3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                         // every rank's stats in place
  // Remote reads are issued for every rank before any is used (all
  // loads in flight at once), then summed in rank order.
  const int r_lo = BM * rank / split, r_hi = BM * (rank + 1) / split;
  if (tid < r_hi - r_lo) {                // the row's weights, rank order
    const int r = r_lo + tid;
    float mq[MAX_SPLIT], lq[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      mq[q] = q < split ? cluster.map_shared_rank(mrow, q)[r] : NEG_INF;
      lq[q] = q < split ? cluster.map_shared_rank(lrow, q)[r] : 0.f;
    }
    float M = mq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) M = fmaxf(M, mq[q]);
    float L = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      if (q >= split) break;
      const float w = expf(mq[q] - M);
      wts[r * (MAX_SPLIT + 1) + q] = w;
      L = fmaf(lq[q], w, L);
    }
    wts[r * (MAX_SPLIT + 1) + MAX_SPLIT] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int n4 = kr / 4;
  for (int e = tid; e < (r_hi - r_lo) * n4; e += THREADS) {
    const int r = r_lo + e / n4, c = (e % n4) * 4;
    if (p0 + r >= npairs) continue;
    const float* w = wts + r * (MAX_SPLIT + 1);
    float4 u[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split)
        u[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc, q) + r * LDO + c);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {  // fixed order: deterministic
      if (q >= split) break;
      v.x = fmaf(u[q].x, w[q], v.x);
      v.y = fmaf(u[q].y, w[q], v.y);
      v.z = fmaf(u[q].z, w[q], v.z);
      v.w = fmaf(u[q].w, w[q], v.w);
    }
    const float d = w[MAX_SPLIT];               // 1 / max(L, 1e-30)
    mor::tile::store4(out + (row0 + r) * kr + c,
                      make_float4(v.x * d, v.y * d, v.z * d, v.w * d));
  }
  cluster.sync();                         // no block leaves while read
}

// A 2D bf16 tensor map over `rows` rows of `cols` columns, rows `ld`
// elements apart: boxes of 64 columns x `box_rows` rows, 128-byte
// swizzled, zeros past either extent.  cuTensorMapEncodeTiled lives in
// libcuda: the runtime's entry-point query finds it, so the library
// needs no link against libcuda.
int tensor_map(CUtensorMap* map, const void* base, int cols, long long rows,
               int ld, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch(const bf16* ql, const bf16* qe, const bf16* ck, const bf16* cpe,
           const int* cp, const int* tbl, const int* qpos, bf16* out, int B,
           int C, int h, int kr, int rd, int P, int n_pages, int W,
           int tbl_stride, int split, float scale, cudaStream_t st) {
  static unsigned long long ready = 0;
  const long long tiles = ((long long)C * h + BM - 1) / BM;
  const long long rows = (long long)n_pages * P, qrows = (long long)B * C * h;
  if (kr < 8 || kr > MAX_KR || rd < 8 || rd > 64 || kr % 8 || rd % 8 ||
      P < 8 || P % 8 || C * h < 1 || B > 65535 || split < 1 ||
      split > MAX_SPLIT || split > W || tiles * split > 0x7fffffff ||
      rows > 0x7fffffff - 8 || qrows > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(cp) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[4];
  int err = tensor_map(&tm[0], ql, kr, qrows, kr, BM);
  if (!err) err = tensor_map(&tm[1], qe, rd, qrows, rd, BM);
  if (!err) err = tensor_map(&tm[2], ck, kr, rows, kr, 8);
  if (!err) err = tensor_map(&tm[3], cpe, rd, rows, rd, 8);
  if (err) return err;
  const dim3 grid((unsigned)(tiles * split), B);
  return mor::launch_cluster(mla_paged_kernel, ready, SMEM_BYTES, grid,
                             split, SMEM_BYTES, st, tm[0], tm[1], tm[2],
                             tm[3], cp, tbl, qpos, out, C, h, kr, rd, P,
                             (int)rows, W, tbl_stride, scale, split);
}

}  // namespace tc
}  // namespace mla

// q_lat (B, C, h, kr), q_pe (B, C, h, rd); ck (n_pages, P, kr), cpe
// (n_pages, P, rd) in `dtype`, 16-byte aligned; cp (n_pages, P) int32;
// tbl (B, >= W) int32 with rows tbl_stride apart; qpos (B, C) int32; out
// (B, C, h, kr).  kr <= 512, kr and rd multiples of 16 bytes; bf16 also
// rd <= 64, P a multiple of 8 and cp 16-byte aligned, and splits each
// slot's table columns over `split` blocks of a cluster (1 <= split <=
// min(8, W), the wrapper's plan); float32 takes split = 1.  Returns the
// launch's error code.
extern "C" int mla_paged_flash(const void* ql, const void* qe, const void* ck,
                               const void* cpe, const int* cp,
                               const int* tbl, const int* qpos, void* out,
                               int B, int C, int h, int kr, int rd, int P,
                               int n_pages, int W, int tbl_stride, int split,
                               float scale, int dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mor::BF16)
    return mla::tc::launch(
        static_cast<const bf16*>(ql), static_cast<const bf16*>(qe),
        static_cast<const bf16*>(ck), static_cast<const bf16*>(cpe), cp,
        tbl, qpos, static_cast<bf16*>(out), B, C, h, kr, rd, P, n_pages, W,
        tbl_stride, split, scale, st);
  if (dtype == mor::F32 && split == 1)
    return mla::cc::launch(
        static_cast<const float*>(ql), static_cast<const float*>(qe),
        static_cast<const float*>(ck), static_cast<const float*>(cpe), cp,
        tbl, qpos, static_cast<float*>(out), B, C, h, kr, rd, P, W,
        tbl_stride, scale, st);
  return (int)cudaErrorInvalidValue;
}
