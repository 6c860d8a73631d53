// GQA paged flash attention for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:178
// `gqa_paged_flash` (pallas_call at l.227), with its shard window and
// its partial form.  For each slot b the kernel walks the block-table
// entries j = 0..W-1 of global page ids.  An entry is live where its id
// is > 0 and lies in the window [base, base + n_local) of the pool this
// call holds (a page shard's resident range, `_live_tables`; the whole
// pool on one device, base 0), and is read at local index id - base; a
// null entry and a foreign one are skipped before anything is loaded.  A
// live page's `page` rows are scored q.k * D^-0.5 in float32, a row is
// masked unless its tag is >= 0, qpos - tag >= 0 and, with window > 0,
// qpos - tag < window; the pages fold into online-softmax statistics
// (m, l, acc), all float32.  The output is acc / max(l, 1e-30) in q's
// dtype, laid out (B, C, H, D); or, in the partial form (`pm` given),
// the statistics themselves, unnormalised, in the Pallas kernel's
// layout: m and l (B, hkv, G, C), acc (B, hkv, G, C, D), m in natural
// log units (the largest scaled score), l and acc relative to it: the
// operands of the page shards' flash merge.
//
// Bound on the H100: bytes.  The work is 4 flops per K/V element read
// (q.k and p.v), far below the ridge, so the floor is the live pages'
// K, V and tags (2 KB + 32 B per page and KV head in bf16 at page 8,
// D 64) plus q and the output, over 3.35 TB/s: ~10 us for a decode
// dispatch of 8 slots over ~16k cached tokens.
//
// Design for bf16 at head dims 64, 96, 112 and 128 (serving; `tc`
// below): the MLA kernel's design (mla_attention.cu) carried over to
// GQA.
//   - Columns padded to whole 128-byte swizzle panels: the body is
//     templated on D and computes over DC = D rounded up to 64 columns
//     (64 at D 64, 128 at D 96 / 112 / 128), each 64-column panel one
//     128-byte row of wgmma's swizzle.  Only a row's D / 8 real 16-byte
//     chunks are copied (12 at D 96, 14 at D 112); the pad chunks are
//     zero-filled by a cp.async that reads nothing, q's pad columns are
//     zeros, so they add nothing to q.k, the scale stays the real
//     D^-0.5, and only the D real columns reach `out` or `pacc`.
//   - A block owns an M tile of 64 (query row, head) pairs of one slot
//     and one KV head, c-major over that head's G query heads (granite,
//     G 4: 16 query rows x 4 heads at a mixed dispatch, 4 real pairs at
//     decode; granite-20b's MQA, G 48: all 48 heads of a decode row in
//     one tile, so its pages are read once).  Their q rows are staged
//     once in shared memory, DC / 64 panels of 64 rows x 128 bytes.
//   - Keys stream as K tiles of BK = 4096 / DC rows (64 at DC 64, 32 at
//     DC 128: 8 KB a tile either way) of whole live pages: the block
//     first compacts its range of table entries, 128 at a time, into the
//     list of live page ids, so a null entry is never loaded.  Every
//     thread copies its share of a tile's K and V rows of the block's KV
//     head (a page's rows are hkv D elements apart) and of their tags by
//     16-byte cp.async into a ring of 2 stages, in the swizzle wgmma
//     reads: the next tile's copies are issued while this tile's S
//     product runs, and fly while it is multiplied.  Pages
//     hold a multiple of 8 rows (a 4-tag copy never straddles two
//     pages).  The copies were TMA boxes first (8 rows x 128 bytes a
//     page, 24 a tile from 8 threads): a clock64 trace of one block put
//     their issue about as long as the softmax on the critical warp, and
//     the same kernel fed by TMA lost to these copies in one call
//     (PERF.md); a deeper ring and 128-key tiles tied at D 64, and a ring
//     of 3 or 4 at DC 128 lost at the plan's splits (see RESIDENT).  The
//     copies' per-key divisions are hoisted out of the walk.
//   - One warpgroup computes.  S = Q K^T (64 x BK, float32 sums) on
//     wgmma m64n64k16 (m64n32k16 at DC 128), DC / 16 k16 steps across
//     the panels, from shared memory (both operands K-major); the masks
//     and the online softmax run on S's registers, and a warp whose 16
//     rows hold no real pair (warps 1-3 at a decode with G <= 16) skips
//     them; P, split into bf16 hi + lo halves (P in bf16 alone misses the
//     one-bf16-step bar on a mixed dispatch's diffuse softmaxes, as in
//     MLA), feeds two P.V products per V panel on wgmma m64n64k16 with P
//     from registers and V N-major (the transposed read of the staged V
//     tile).  At DC 128 the accumulator holds 64 floats a thread and S
//     and P's halves 16 each: the 128-register cap of four blocks an SM
//     holds, with 72 bytes of spill stores at D 128 (60 at D 64; the
//     smoke logs every instantiation's ptxas line).
//   - The context split: at decode a slot's B x hkv tiles (64 for
//     granite, 32 for qwen2-7b, 8 for granite-20b) leave most of the
//     card idle, and at G 1 (zamba2-7b, phi-3) one block walks a slot's
//     whole context, so its table columns [0, W) are split into `split`
//     ranges of whole entries (at most 8, the host's plan `gqa_plan`,
//     from shapes alone), one block each, and the blocks of a split form
//     a cluster.  Each rank leaves its (m, l, acc) in its own shared
//     memory and rank r merges its share of the tile's real rows from
//     ranks 0 .. split-1, in that order, through distributed shared
//     memory: one launch, no float32 partials in device memory, the same
//     bits on every run.  A block takes ~42 KB of shared memory at DC 64
//     (~51 KB at DC 128) and 128 registers a thread, so four fit an SM:
//     a granite decode dispatch's 448 blocks (split 7) run in one wave.
// float32 (the reduced models' card-vs-CPU check and the sharded
// layout's reduced references) and bf16 at head dim 32 keep the CUDA
// cores (`cc` below): one block per
// (query-row tile, head group, KV head, slot) serves `heads` of that KV
// head's G query heads for up to `rows` query rows, rows x heads <= RMAX
// = 2048 / DP, DP being D rounded up to a multiple of 32 (21 at D 96; 16
// at D 112, see `padded` below), so that a row's acc[D] stays in
// registers.  The host's plan (`gqa_heads_plan`) takes
// all G heads and RMAX / G rows where G <= RMAX (qwen2-7b's G 7 at D 128:
// 2 rows, 14 of 16 pairs used), else one row and the G heads in
// ceil(G / RMAX) groups of equal size (granite-20b's MQA, G 48 at D 128:
// 3 groups of 16); grid.x runs over (row tile, head group), head group
// fastest.  The block's NW warps split the walk, warp w taking entries
// w, w + NW, ..., staging its page's K, V (float32) and tags in its own
// shared memory, scoring, rescaling and accumulating for all the block's
// rows, with (m, l) in shared memory and acc in registers; at the end the
// warps' statistics merge in warp order.  The page-to-warp map and the
// merge order are fixed, so results are deterministic run to run.  A
// row's K and V are loaded 16 bytes a lane: D 96 is 24 such loads in
// float32, D 112 (zamba2-7b's) 28, and a KV head's offset (kvh D
// elements) stays 16-byte aligned for every D that is a multiple of 8
// (in bf16 too, on the tensor cores).
//
// The strided block table: the engine passes `block_table[:, :W]`, a
// view whose rows are `tbl_stride` apart, not W.  Reading it as a dense
// (B, W) array would read other slots' pages without any error, so the
// row stride is an argument.
//
// The finite sentinel: a masked score is -1e30, never -INFINITY, as in
// the Pallas kernel.  -inf - (-inf) is NaN; with -1e30 a query row that
// sees no key in any live page gets exp(0) = 1 weights, i.e. what the
// Pallas kernel gives, and a slot whose table is all null gives exact
// zeros (l = 0, acc = 0).  A rank whose range holds no live page merges
// as m = -1e30, l = 0, acc = 0; one whose live keys are all masked has
// m = -1e30 and loses to any rank with a real score, as in a single
// pass.  Rows of a K tile past its live pages are zeros (boxes past the
// pool) and score -INFINITY: they weigh nothing.  The partial form keeps
// both conventions bit for bit: a window with no live page gives m =
// -1e30, l = 0, acc = 0, one whose live keys are all masked m = -1e30
// and l = the count of its live keys.
//
// Pool offsets are 64-bit: a full-width pool holds more than 2^31
// elements over all layers, and one layer's pool can come close.
#include <cooperative_groups.h>

#include "mma_tile.cuh"

namespace paged {

constexpr float NEG_INF = -1e30f;    // the finite sentinel

// ==========================================================================
// float32, and bf16 at head dim 32: the CUDA cores
// ==========================================================================
namespace cc {

using mor::from_f;
using mor::load16;
using mor::to_f;

constexpr int NW = 8;             // warps per block
constexpr int ELEMS = 2048;       // acc slots a block holds: rows x DP
constexpr int NE = ELEMS / 32;    // acc registers per lane

// A row's acc slots are its D columns rounded up to whole warps, DP: a
// lane's k-th slot is then row k / (DP / 32), column lane + 32 (k % (DP
// / 32)), the row known at compile time.  Where D is not a multiple of
// 32 and the row is not padded, the row of each slot depends on the lane
// and the unrolled accumulate no longer fits the registers (D 112
// unpadded: 18 rows, 255 registers and 312 bytes of spill); padded, D 112
// holds 16 rows of 128 slots (the last 16 of each row idle).
template <int D>
__host__ __device__ constexpr int padded() { return (D + 31) / 32 * 32; }

template <int D>
__host__ __device__ constexpr int rmax() { return ELEMS / padded<D>(); }

// per-warp shared floats: K page (rows padded to D + 1 so that lanes
// scoring different keys hit different banks), V page, tags, scores /
// weights (RMAX x P), and m, l, rescale factor per row
template <int D>
__host__ __device__ constexpr int warp_floats(int P) {
  return P * (D + 1) + P * D + P + rmax<D>() * P + 3 * rmax<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
gqa_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ pp,
                 const int* __restrict__ tbl, const int* __restrict__ qpos,
                 T* __restrict__ out, int C, int H, int hkv, int P, int W,
                 int tbl_stride, int window, float scale, int CT, int GT,
                 int base, int n_local, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ pacc) {
  constexpr int RMAX = rmax<D>(), DP = padded<D>();
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int G = H / hkv;
  const int NG = (G + GT - 1) / GT;           // head groups
  const int c0 = (blockIdx.x / NG) * CT, g0 = (blockIdx.x % NG) * GT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Gb = min(GT, G - g0);             // this group's heads
  const int R = min(CT, C - c0) * Gb;         // rows r = c_local * Gb + g
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float* qs = smem;                           // RMAX x (D + 1); merge acc
  int* qp = reinterpret_cast<int*>(qs + RMAX * (D + 1));
  float* Mm = reinterpret_cast<float*>(qp + RMAX);
  float* Ml = Mm + RMAX;
  float* ws = Ml + RMAX + warp * warp_floats<D>(P);
  float* ks = ws;
  float* vs = ks + P * (D + 1);
  int* tg = reinterpret_cast<int*>(vs + P * D);
  float* S = reinterpret_cast<float*>(tg + P);
  float* wm = S + RMAX * P;
  float* wl = wm + RMAX;
  float* wc = wl + RMAX;

  for (int e = threadIdx.x; e < R * D; e += NW * 32) {
    const int r = e / D, d = e % D;
    const int cl = r / Gb, g = g0 + r % Gb;
    qs[r * (D + 1) + d] =
        to_f(q[(((size_t)b * C + c0 + cl) * H + kvh * G + g) * D + d]);
  }
  for (int r = threadIdx.x; r < R; r += NW * 32)
    qp[r] = qpos[(size_t)b * C + c0 + r / Gb];
  for (int r = lane; r < R; r += 32) {
    wm[r] = NEG_INF;
    wl[r] = 0.f;
  }
  float acc[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) acc[k] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)hkv * D;  // elements between page rows
  for (int j = warp; j < W; j += NW) {
    const int id = tbl[(size_t)b * tbl_stride + j], pg = id - base;
    // null or foreign page: nothing loaded
    if (id <= 0 || pg < 0 || pg >= n_local) continue;
    const size_t off = (size_t)pg * P * row_stride + (size_t)kvh * D;
    for (int c = lane; c < P * (D / VEC); c += 32) {
      const int t = c / (D / VEC), dv = (c % (D / VEC)) * VEC;
      float tmp[VEC];
      load16(kp + off + t * row_stride + dv, tmp);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ks[t * (D + 1) + dv + i] = tmp[i];
      load16(vp + off + t * row_stride + dv, tmp);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vs[t * D + dv + i] = tmp[i];
    }
    for (int t = lane; t < P; t += 32) tg[t] = pp[(size_t)pg * P + t];
    __syncwarp();
    // scores, masked to the finite sentinel
    for (int s = lane; s < R * P; s += 32) {
      const int r = s / P, t = s % P;
      const int tag = tg[t], rel = qp[r] - tag;
      float sc = NEG_INF;
      if (tag >= 0 && rel >= 0 && (window <= 0 || rel < window)) {
        const float* qr = qs + r * (D + 1);
        const float* kr = ks + t * (D + 1);
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      S[s] = sc;
    }
    __syncwarp();
    // online-softmax statistics, one lane per row
    for (int r = lane; r < R; r += 32) {
      const float mp = wm[r];
      float mx = mp;
      for (int t = 0; t < P; ++t) mx = fmaxf(mx, S[r * P + t]);
      float sum = 0.f;
      for (int t = 0; t < P; ++t) {
        const float p = expf(S[r * P + t] - mx);
        S[r * P + t] = p;
        sum += p;
      }
      const float corr = expf(mp - mx);
      wl[r] = wl[r] * corr + sum;
      wm[r] = mx;
      wc[r] = corr;
    }
    __syncwarp();
    // acc = acc * corr + p . V; lane owns slots lane + 32 k of (R, DP)
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = lane + 32 * k, r = e / DP, d = e % DP;
      if (r < R && d < D) {
        float a = acc[k] * wc[r];
        for (int t = 0; t < P; ++t) a = fmaf(S[r * P + t], vs[t * D + d], a);
        acc[k] = a;
      }
    }
    __syncwarp();
  }

  // merge the warps' (m, l, acc) in warp order; the q buffer becomes the
  // block's accumulator
  __syncthreads();
  for (int w2 = 0; w2 < NW; ++w2) {
    if (warp == w2) {
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        const int e = lane + 32 * k, r = e / DP, d = e % DP;
        if (r < R && d < D) {
          float* m = qs + r * (D + 1) + d;
          if (w2 == 0) {
            *m = acc[k];
          } else {
            const float mx = fmaxf(Mm[r], wm[r]);
            *m = *m * expf(Mm[r] - mx) + acc[k] * expf(wm[r] - mx);
          }
        }
      }
      __syncwarp();
      for (int r = lane; r < R; r += 32) {
        if (w2 == 0) {
          Mm[r] = wm[r];
          Ml[r] = wl[r];
        } else {
          const float mx = fmaxf(Mm[r], wm[r]);
          Ml[r] = Ml[r] * expf(Mm[r] - mx) + wl[r] * expf(wm[r] - mx);
          Mm[r] = mx;
        }
      }
    }
    __syncthreads();
  }
  // the partial form's row of pair r: (b, kvh, g, c) of (B, hkv, G, C)
  auto prow = [&](int r) {
    return (((size_t)b * hkv + kvh) * G + g0 + r % Gb) * C + c0 + r / Gb;
  };
  if (pm != nullptr) {
    for (int e = threadIdx.x; e < R * D; e += NW * 32)
      pacc[prow(e / D) * D + e % D] = qs[(e / D) * (D + 1) + e % D];
    for (int r = threadIdx.x; r < R; r += NW * 32) {
      pm[prow(r)] = Mm[r];
      pl[prow(r)] = Ml[r];
    }
    return;
  }
  for (int e = threadIdx.x; e < R * D; e += NW * 32) {
    const int r = e / D, d = e % D;
    const int cl = r / Gb, g = g0 + r % Gb;
    out[(((size_t)b * C + c0 + cl) * H + kvh * G + g) * D + d] =
        from_f<T>(qs[r * (D + 1) + d] / fmaxf(Ml[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* pp,
           const int* tbl, const int* qpos, void* out, int B, int C, int H,
           int hkv, int P, int W, int tbl_stride, int window, float scale,
           int rows, int heads, int base, int n_local, float* pm, float* pl,
           cudaStream_t st) {
  constexpr int RMAX = rmax<D>();
  if (hkv < 1 || H % hkv || C < 1 || rows < 1 || heads < 1 ||
      heads > H / hkv || rows * heads > RMAX || hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long groups = (H / hkv + heads - 1) / heads;
  const long long tiles = ((long long)C + rows - 1) / rows * groups;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (RMAX * (D + 1) + 3 * RMAX + NW * warp_floats<D>(P));
  auto kern = gqa_paged_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)tiles, hkv, B);
  kern<<<grid, NW * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pp, tbl, qpos,
      pm != nullptr ? nullptr : static_cast<T*>(out), C, H, hkv, P, W,
      tbl_stride, window, scale, rows, heads, base, n_local, pm, pl,
      pm != nullptr ? static_cast<float*>(out) : nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int D, const void* q, const void* kp, const void* vp,
           const int* pp, const int* tbl, const int* qpos, void* out, int B,
           int C, int H, int hkv, int P, int W, int tbl_stride, int window,
           float scale, int rows, int heads, int base, int n_local, float* pm,
           float* pl, cudaStream_t st) {
#define PAGED_CC_CASE(DIM)                                                  \
  case DIM:                                                                 \
    return launch<T, DIM>(q, kp, vp, pp, tbl, qpos, out, B, C, H, hkv, P, W, \
                          tbl_stride, window, scale, rows, heads, base,     \
                          n_local, pm, pl, st);
  switch (D) {
    PAGED_CC_CASE(32)
    PAGED_CC_CASE(64)
    PAGED_CC_CASE(96)
    PAGED_CC_CASE(112)
    PAGED_CC_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CC_CASE
}

}  // namespace cc

// ==========================================================================
// bf16 at head dims 64, 96, 112 and 128: the tensor cores
// ==========================================================================
namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mor::smem_u32;
using mor::tile::cp_async16;
using mor::tile::cp_async_commit;
using mor::tile::cp_async_wait;
using mor::tile::pack_bf16;
using mor::tile::sw128_desc;

constexpr int THREADS = 128;                  // one warpgroup
constexpr int BM = 64;                        // pairs a block (wgmma's M)
constexpr int PANEL_Q = BM * 128;             // a Q panel: 64 rows x 128 B
constexpr int LIST = THREADS;                 // table entries a scan
constexpr int MAX_SPLIT = 8;                  // the portable cluster
constexpr int STAGES = 2;                     // the cp.async ring
// Blocks an SM, which the host's plan counts on (paged_attention.py
// gqa_resident): registers are held to 128 a thread (__launch_bounds__
// below), and shared memory (the H100's 228 KB, 1 KB reserved a block:
// ~42 KB a block at DC 64, ~51 KB at DC 128) allows four at every D.
// A ring of 3 or 4 stages at DC 128 (3 or 2 blocks an SM, no spill)
// was faster at small splits but slower at the plan's, whose blocks then
// no longer fit one wave.
constexpr int RESIDENT = 4;

// The geometry at head dim D: DC columns (D rounded up to whole 64-column
// panels of one 128-byte swizzle row each), BK keys a tile (a K or V tile
// is 8 KB at every D: 64 keys at DC 64, 32 at DC 128).
template <int D>
struct Geo {
  static_assert(D % 8 == 0 && D > 32 && D <= 128, "head dim");
  static constexpr int DC = (D + 63) / 64 * 64;
  static constexpr int NP = DC / 64;          // column panels
  static constexpr int BK = 4096 / DC;        // keys a tile
  static constexpr int CH = DC / 8;           // 16-byte chunks a row
  static constexpr int REAL = D / 8;          // ... of them real
  static constexpr int PANEL = BK * 128;      // a K (V) panel's bytes
  static constexpr int KV = NP * PANEL;       // a K (or V) tile's bytes
  static constexpr int STAGE = 2 * KV;        // K then V
  // shared memory, from the 1 KB aligned base: Q, the ring, the stages'
  // tags, the live-page list, the pairs' qpos, warp counts
  static constexpr int OFF_K = NP * PANEL_Q;
  static constexpr int OFF_TAG = OFF_K + STAGES * STAGE;
  static constexpr int OFF_LIST = OFF_TAG + STAGES * BK * 4;
  static constexpr int OFF_QPOS = OFF_LIST + LIST * 4;
  static constexpr int OFF_CNT = OFF_QPOS + BM * 4;
  static constexpr int SMEM_BYTES = OFF_CNT + 32 + 1024;   // + alignment
  static constexpr int LDO = DC + 4;          // float stride, merge tile
  static constexpr int LDB = DC + 8;          // bf16 stride, output tile
  static constexpr int KPT = BK * CH / THREADS;   // key rows a thread copies
  static_assert(KV == 8192 && BK * CH % THREADS == 0, "tile");
  static_assert(233472 / (SMEM_BYTES + 1024) >= RESIDENT, "shared memory");
  // the merge reuses Q and the ring: the acc tile, m, l, and per row the
  // ranks' weights and the denominator
  static_assert((BM * LDO + 2 * BM + BM * (MAX_SPLIT + 1)) * 4 <= OFF_TAG,
                "the merge tile fits in the ring");
  static_assert(BM * LDB * 2 <= OFF_TAG, "the output tile fits");
};

// 2^x on the special function unit: the softmax runs in base 2 (scores
// scaled by log2(e) D^-0.5, the running maxima in the same units)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block: pairs [p0, p0 + 64) of KV head kvh of slot b against its
// table columns [lo, hi) (rank `rank` of the slot's `split`).
template <int D>
__global__ void __launch_bounds__(THREADS, RESIDENT)
gqa_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ pp,
                 const int* __restrict__ tbl, const int* __restrict__ qpos,
                 bf16* __restrict__ out, int C, int H, int hkv, int P, int W,
                 int tbl_stride, int window, float scale_log2,
                 int split, int base, int n_local, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ pacc) {
  using Gm = Geo<D>;
  constexpr int NP = Gm::NP, BK = Gm::BK, CH = Gm::CH, PANEL = Gm::PANEL;
  constexpr int KV = Gm::KV, STAGE = Gm::STAGE, LDO = Gm::LDO;
  constexpr int LDB = Gm::LDB;
  extern __shared__ __align__(16) char smem_raw[];
  char* sm = mor::tile::ring_base(smem_raw);
  int* tags = reinterpret_cast<int*>(sm + Gm::OFF_TAG);
  int* list = reinterpret_cast<int*>(sm + Gm::OFF_LIST);
  int* qps = reinterpret_cast<int*>(sm + Gm::OFF_QPOS);
  int* cnt = reinterpret_cast<int*>(sm + Gm::OFF_CNT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8, tq = lane & 3;
  const int rank = blockIdx.x % split, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / hkv, npairs = C * G, p0 = (blockIdx.x / split) * BM;
  const int nreal = min(BM, npairs - p0);      // the tile's real pairs
  const int lo = (int)((long long)W * rank / split);
  const int hi = (int)((long long)W * (rank + 1) / split);
  // pair p's q and output row: (b, c = p / G, head kvh G + p % G)
  auto row_of = [&](int p) {
    return (((size_t)b * C + p / G) * H + kvh * G + p % G) * D;
  };
  // the partial form's row of pair p: (b, kvh, g = p % G, c = p / G) of
  // (B, hkv, G, C); its m in natural log units, the sentinel kept
  auto prow = [&](int p) {
    return (((size_t)b * hkv + kvh) * G + p % G) * C + p / G;
  };
  auto nat = [](float m) {
    return m == NEG_INF ? NEG_INF : m * 0.6931471805599453f;
  };
  // 16-byte chunk c of row r of a region of 128-byte panels (`panel`
  // bytes each): panel c / 8, at chunk (c % 8) ^ (r & 7) of the row (the
  // 128-byte swizzle wgmma reads)
  auto swz = [](int r, int c, int panel) {
    return (c >> 3) * panel + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  };

  // this thread's entry of the first scan
  const int* trow = tbl + (size_t)b * tbl_stride;
  int pg_next = lo + tid < hi ? trow[lo + tid] : 0;
  // the pairs' q rows; rows past the tile's real pairs and the pad
  // columns past D are zeros (the pad adds nothing to q.k)
  for (int e = tid; e < BM * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nreal && c < Gm::REAL)
      v = *reinterpret_cast<const uint4*>(q + row_of(p0 + r) + 8 * c);
    *reinterpret_cast<uint4*>(sm + swz(r, c, PANEL_Q)) = v;
  }
  if (tid < BM)
    qps[tid] = tid < nreal ? qpos[(size_t)b * C + (p0 + tid) / G] : -1;
  // the generic stores are seen by wgmma's (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // K tiles: E entries of RE rows each (RE = P when a page fits a tile,
  // else BK rows of one page, nsub tiles a page); the first nv rows of
  // a tile are real keys, key k from row k % RE of its page.
  const int RE = min(P, BK), E = BK / RE, nsub = (P + BK - 1) / BK;
  auto tile_rows = [&](int i, int nlive) {
    return P <= BK ? min(E, nlive - (i / nsub) * E) * P
                   : min(BK, P - (i % nsub) * BK);
  };
  // Tile i of the scan into stage st, by 16-byte cp.async copies from
  // every thread: key k's K and V rows of this KV head (its D / 8 real
  // chunks; the pad chunks up to DC zero-filled, reading nothing) in the
  // column panels wgmma reads, and its tags, 4 keys a chunk (P % 8 == 0:
  // a chunk is one page's); rows past the tile's real keys are
  // zero-filled and read nothing.
  // This thread copies chunk tid % CH of keys k_j = tid / CH + (128 /
  // CH) j and, below BK / 4, the tags of keys 4 tid..; their (entry of
  // the tile, row of the page) are the same for every tile, so they are
  // divided out once: a tile's copies then cost no division (they cost
  // about half of the copies' issue time in the trace).
  constexpr int KPT = Gm::KPT;
  const int ch = tid % CH;
  const bool real_ch = ch < Gm::REAL;
  int kq[KPT + 1], kr[KPT + 1];
#pragma unroll
  for (int j = 0; j <= KPT; ++j) {
    const int k = j < KPT ? tid / CH + (THREADS / CH) * j : 4 * tid;
    kq[j] = k / RE;
    kr[j] = k % RE;
  }
  auto load_tile = [&](int i, int st, int nlive) {
    const int nv = tile_rows(i, nlive);
    const int* ent = list + (i / nsub) * E;      // the tile's first entry
    const int sub = (i % nsub) * BK;             // its first row of a page
    char* kd = sm + Gm::OFF_K + st * STAGE;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int k = tid / CH + (THREADS / CH) * j;
      const bool ok = real_ch && k < nv;
      const size_t row = ok ? (size_t)ent[kq[j]] * P + sub + kr[j] : 0;
      const size_t off = ok ? (row * hkv + kvh) * D + 8 * ch : 0;
      const int d = swz(k, ch, PANEL);
      cp_async16(kd + d, kp + off, ok);
      cp_async16(kd + KV + d, vp + off, ok);
    }
    if (tid < BK / 4) {
      const bool ok = 4 * tid < nv;
      cp_async16(tags + st * BK + 4 * tid,
                 pp + (ok ? (size_t)ent[kq[KPT]] * P + sub + kr[KPT] : 0),
                 ok);
    }
  };
  int g = 0;                              // tiles computed so far

  float o[NP][8][4];                      // rows ra, rb; panel p's columns
#pragma unroll                            // 64 p + 8 j + ..
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[p][j][0] = o[p][j][1] = o[p][j][2] = o[p][j][3] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  const uint32_t qa = smem_u32(sm);

  // Tile on stage st (nv real keys): S, the masks, the online softmax,
  // then acc = acc * corr + P V with P's hi and lo halves; `prefetch`
  // (the next tile's copies, by every thread) runs while S's product is
  // in flight.
  auto compute = [&](int st, int nv, auto&& prefetch) {
    const uint32_t ka = smem_u32(sm + Gm::OFF_K + st * STAGE), va = ka + KV;
    const int* tg = tags + st * BK;
    constexpr int NJ = BK / 8, NK = BK / 16;    // n8 tiles, k16 steps
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // DC / 16 k16 steps over the panels: +32 bytes a step inside a
    // panel's swizzled rows
#pragma unroll
    for (int u = 0; u < Gm::DC / 16; ++u) {
      const uint64_t da = sw128_desc(qa + PANEL_Q * (u / 4) + 32 * (u % 4),
                                     0, 1024);
      const uint64_t db = sw128_desc(ka + PANEL * (u / 4) + 32 * (u % 4),
                                     0, 1024);
      if constexpr (BK == 64)
        mor::tile::wgmma_m64n64k16<0>(s, da, db);
      else
        mor::tile::wgmma_m64n32k16(s, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    prefetch();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // A warp whose 16 rows are all past the tile's real pairs (warps 1-3
    // at decode, where G <= 16 pairs are real) skips the masks and the
    // softmax: its P is 0 and its accumulators stay 0.
    uint32_t ph[NK][4], pl[NK][4];
    if (16 * warp >= nreal) {
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) ph[k][u] = pl[k][u] = 0u;
    } else {
      // masks, the online softmax (a row's BK keys over the lane quad)
      const int qpa = qps[ra], qpb = qps[rb];
      auto seen = [&](int qp, int tag) {
        const int rel = qp - tag;
        return tag >= 0 && rel >= 0 && (window <= 0 || rel < window);
      };
      float xa = ma, xb = mb;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * tq + e, tag = tg[key];
          const bool real = key < nv;
          s[j][e] = !real ? -INFINITY
                    : seen(qpa, tag) ? s[j][e] * scale_log2 : NEG_INF;
          s[j][2 + e] = !real ? -INFINITY
                        : seen(qpb, tag) ? s[j][2 + e] * scale_log2
                                         : NEG_INF;
          xa = fmaxf(xa, s[j][e]);
          xb = fmaxf(xb, s[j][2 + e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      const float ca = ex2(ma - xa), cb = ex2(mb - xb);
      ma = xa;
      mb = xb;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = ex2(s[j][0] - xa);
        s[j][1] = ex2(s[j][1] - xa);
        s[j][2] = ex2(s[j][2] - xb);
        s[j][3] = ex2(s[j][3] - xb);
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
      // P as A fragments of the NK k16 steps (the accumulators' n8 tiles
      // 2k and 2k + 1): hi = bf16(p), lo = bf16(p - hi)
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* v = s[2 * k + (u >> 1)] + 2 * (u & 1);
          ph[k][u] = pack_bf16(v[0], v[1]);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&ph[k][u]);
          pl[k][u] =
              pack_bf16(v[0] - __low2float(hv), v[1] - __high2float(hv));
        }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[p][j][0] *= ca;
          o[p][j][1] *= ca;
          o[p][j][2] *= cb;
          o[p][j][3] *= cb;
        }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // V, panel by panel: +2 KB (16 key rows) a k16 step, 1 KB between
    // 8-row groups
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < NK; ++k)
        mor::tile::wgmma_m64n64k16_rs(
            o[p], ph[k], sw128_desc(va + PANEL * p + 2048 * k, 1024, 1024));
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < NK; ++k)
        mor::tile::wgmma_m64n64k16_rs(
            o[p], pl[k], sw128_desc(va + PANEL * p + 2048 * k, 1024, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };

  for (int c0 = lo; c0 < hi; c0 += LIST) {
    // compact the live entries of [c0, c0 + LIST) into `list`, in order,
    // as local page ids: a null or foreign entry is not live
    const int pg = pg_next - base;
    const bool is_live = pg_next > 0 && pg >= 0 && pg < n_local;
    const unsigned live = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) cnt[warp] = __popc(live);
    __syncthreads();
    int at = 0, nlive = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      at += w < warp ? cnt[w] : 0;
      nlive += cnt[w];
    }
    if (is_live) list[at + __popc(live & ((1u << lane) - 1u))] = pg;
    __syncthreads();
    const int jn = c0 + LIST + tid;       // the next scan's entry, early
    pg_next = jn < hi ? trow[jn] : 0;
    const int ntiles = (nlive + E - 1) / E * nsub;
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < ntiles) load_tile(i, (g + i) % STAGES, nlive);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i, ++g) {
      cp_async_wait<STAGES - 2>();        // this thread's copies of tile i
      __syncthreads();                    // everyone's; tile i - 1 is done
      // the ring's last stage (tile i - 1's) takes tile i + STAGES - 1,
      // its copies issued while S's product runs
      compute(g % STAGES, tile_rows(i, nlive), [&] {
        if (i + STAGES - 1 < ntiles)
          load_tile(i + STAGES - 1, (g + STAGES - 1) % STAGES, nlive);
        cp_async_commit();
      });
    }
  }

  __syncthreads();                        // Q and the ring are free
  float* acc = reinterpret_cast<float*>(sm);
  float* mrow = acc + BM * LDO;
  float* lrow = mrow + BM;
  float* wts = lrow + BM;                 // BM x (MAX_SPLIT + 1)
  if (split == 1 && pm != nullptr) {
    // the partial form: the real pairs' statistics from the registers,
    // their D real columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      if (r >= nreal) continue;
      const size_t row = prow(p0 + r);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * p + 8 * j + 2 * tq;
          if (c < D)
            *reinterpret_cast<float2*>(pacc + row * D + c) =
                make_float2(o[p][j][2 * h], o[p][j][2 * h + 1]);
        }
      if (tq == 0) {
        pm[row] = nat(h ? mb : ma);
        pl[row] = h ? lb : la;
      }
    }
    return;
  }
  if (split == 1) {
    // the normalised rows through shared memory (rows LDB apart), then
    // 16-byte stores of the real pairs' D columns
    bf16* ot = reinterpret_cast<bf16*>(sm);
    const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * p + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(ot + ra * LDB + c) =
            __floats2bfloat162_rn(o[p][j][0] * ia, o[p][j][1] * ia);
        *reinterpret_cast<__nv_bfloat162*>(ot + rb * LDB + c) =
            __floats2bfloat162_rn(o[p][j][2] * ib, o[p][j][3] * ib);
      }
    __syncthreads();
    for (int e = tid; e < nreal * Gm::REAL; e += THREADS) {
      const int r = e / Gm::REAL, c = (e % Gm::REAL) * 8;
      *reinterpret_cast<uint4*>(out + row_of(p0 + r) + c) =
          *reinterpret_cast<const uint4*>(ot + r * LDB + c);
    }
    return;
  }

  // the merge: each rank's (m, l, acc) in its own shared memory
  if (tq == 0) {
    mrow[ra] = ma;
    lrow[ra] = la;
    mrow[rb] = mb;
    lrow[rb] = lb;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * p + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(acc + ra * LDO + c) =
          make_float2(o[p][j][0], o[p][j][1]);
      *reinterpret_cast<float2*>(acc + rb * LDO + c) =
          make_float2(o[p][j][2], o[p][j][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                         // every rank's stats in place
  // Rank r merges the real rows [r_lo, r_hi); remote reads are issued
  // for every rank before any is used, then summed in rank order.
  const int r_lo = nreal * rank / split, r_hi = nreal * (rank + 1) / split;
  if (tid < r_hi - r_lo) {                // the row's weights, rank order
    const int r = r_lo + tid;
    float mq[MAX_SPLIT], lq[MAX_SPLIT];
#pragma unroll
    for (int u = 0; u < MAX_SPLIT; ++u) {
      mq[u] = u < split ? cluster.map_shared_rank(mrow, u)[r] : NEG_INF;
      lq[u] = u < split ? cluster.map_shared_rank(lrow, u)[r] : 0.f;
    }
    float M = mq[0];
#pragma unroll
    for (int u = 1; u < MAX_SPLIT; ++u) M = fmaxf(M, mq[u]);
    float L = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_SPLIT; ++u) {
      if (u >= split) break;
      const float wu = exp2f(mq[u] - M);
      wts[r * (MAX_SPLIT + 1) + u] = wu;
      L = fmaf(lq[u], wu, L);
    }
    // the partial form keeps the merged statistics unnormalised
    wts[r * (MAX_SPLIT + 1) + MAX_SPLIT] =
        pm != nullptr ? 1.f : 1.f / fmaxf(L, 1e-30f);
    if (pm != nullptr) {
      pm[prow(p0 + r)] = nat(M);
      pl[prow(p0 + r)] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < (r_hi - r_lo) * (D / 4); e += THREADS) {
    const int r = r_lo + e / (D / 4), c = (e % (D / 4)) * 4;
    const float* wr = wts + r * (MAX_SPLIT + 1);
    float4 u4[MAX_SPLIT];
#pragma unroll
    for (int u = 0; u < MAX_SPLIT; ++u)
      if (u < split)
        u4[u] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc, u) + r * LDO + c);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < MAX_SPLIT; ++u) {  // fixed order: deterministic
      if (u >= split) break;
      v.x = fmaf(u4[u].x, wr[u], v.x);
      v.y = fmaf(u4[u].y, wr[u], v.y);
      v.z = fmaf(u4[u].z, wr[u], v.z);
      v.w = fmaf(u4[u].w, wr[u], v.w);
    }
    const float dn = wr[MAX_SPLIT];             // 1 / max(L, 1e-30)
    if (pm != nullptr)
      *reinterpret_cast<float4*>(pacc + prow(p0 + r) * D + c) = v;
    else
      mor::tile::store4(out + row_of(p0 + r) + c,
                        make_float4(v.x * dn, v.y * dn, v.z * dn, v.w * dn));
  }
  cluster.sync();                         // no block leaves while read
}

template <int D>
int launch(const bf16* q, const bf16* kp, const bf16* vp, const int* pp,
           const int* tbl, const int* qpos, void* out, int B, int C, int H,
           int hkv, int P, int W, int tbl_stride, int window, int split,
           float scale, int base, int n_local, float* pm, float* pl,
           cudaStream_t st) {
  static unsigned long long ready = 0;
  const long long tiles = ((long long)C * (H / max(hkv, 1)) + BM - 1) / BM;
  if (hkv < 1 || H % hkv || C < 1 || P < 8 || P % 8 || B > 65535 ||
      hkv > 65535 || split < 1 || split > MAX_SPLIT ||
      split > max(W, 1) || tiles * split > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp) | reinterpret_cast<uintptr_t>(pp)) %
          16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * split), hkv, B);
  constexpr int SMEM = Geo<D>::SMEM_BYTES;
  return mor::launch_cluster<THREADS>(
      gqa_paged_kernel<D>, ready, SMEM, grid, split, SMEM, st, q, kp, vp, pp,
      tbl, qpos, pm != nullptr ? nullptr : static_cast<bf16*>(out), C, H,
      hkv, P, W, tbl_stride, window, scale * 1.4426950408889634f, split,
      base, n_local, pm, pl,
      pm != nullptr ? static_cast<float*>(out) : nullptr);
}

// the head dims the tensor-core body serves (bf16)
constexpr bool serves(int D) {
  return D == 64 || D == 96 || D == 112 || D == 128;
}

int by_dim(int D, const bf16* q, const bf16* kp, const bf16* vp,
           const int* pp, const int* tbl, const int* qpos, void* out, int B,
           int C, int H, int hkv, int P, int W, int tbl_stride, int window,
           int split, float scale, int base, int n_local, float* pm,
           float* pl, cudaStream_t st) {
#define PAGED_TC_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return launch<DIM>(q, kp, vp, pp, tbl, qpos, out, B, C, H, hkv, P, W,    \
                       tbl_stride, window, split, scale, base, n_local, pm,  \
                       pl, st);
  switch (D) {
    PAGED_TC_CASE(64)
    PAGED_TC_CASE(96)
    PAGED_TC_CASE(112)
    PAGED_TC_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAGED_TC_CASE
}

}  // namespace tc
}  // namespace paged

// q (B, C, H, D); kp, vp (n_pages, P, hkv, D) in `dtype`, 16-byte
// aligned; pp (n_pages, P) int32; tbl (B, >= W) int32 global page ids
// with rows tbl_stride apart, live where in [base, base + n_local)
// (base 0, n_local n_pages on one device); qpos (B, C) int32; out (B,
// C, H, D) in `dtype`, or with pm and pl given (the partial form) the
// float32 acc (B, hkv, G, C, D) beside m and l (B, hkv, G, C).  bf16 at
// D 64, 96, 112 or 128 runs on the tensor cores (P a multiple of 8, pp
// 16-byte aligned) and splits each slot's table columns over `split`
// blocks of a cluster (1 <= split <= min(8, W), the wrapper's plan);
// float32, and bf16 at D 32, run on the CUDA cores with split = 1, a
// block serving `rows` query rows x `heads` query heads of one KV head
// (the wrapper's plan; rows and heads are not read on the tensor
// cores).  Nothing falls back from one body to the other: a refused
// launch returns its error.  Returns the launch's error code.
extern "C" int gqa_paged_flash(const void* q, const void* kp, const void* vp,
                               const int* pp, const int* tbl,
                               const int* qpos, void* out, float* pm,
                               float* pl, int B, int C, int H, int hkv,
                               int D, int P, int W, int tbl_stride,
                               int window, int split, int rows, int heads,
                               int base, int n_local, float scale, int dtype,
                               void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pm == nullptr) != (pl == nullptr) || base < 0 || n_local < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == mor::BF16 && paged::tc::serves(D))
    return paged::tc::by_dim(
        D, static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), pp, tbl, qpos, out, B, C, H, hkv, P, W,
        tbl_stride, window, split, scale, base, n_local, pm, pl, st);
  if (split != 1) return (int)cudaErrorInvalidValue;
  if (dtype == mor::BF16 && D == 32)
    return paged::cc::launch<bf16, 32>(q, kp, vp, pp, tbl, qpos, out, B, C,
                                       H, hkv, P, W, tbl_stride, window,
                                       scale, rows, heads, base, n_local, pm,
                                       pl, st);
  if (dtype == mor::F32)
    return paged::cc::by_dim<float>(D, q, kp, vp, pp, tbl, qpos, out, B, C,
                                    H, hkv, P, W, tbl_stride, window, scale,
                                    rows, heads, base, n_local, pm, pl, st);
  return (int)cudaErrorInvalidValue;
}
