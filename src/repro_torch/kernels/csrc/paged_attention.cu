// GQA paged flash attention for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:178
// `gqa_paged_flash` (pallas_call at l.227) in its single-device form:
// normalised output (partial=False), no shard window (lo=None).  For
// each slot b the kernel walks the block-table entries j = 0..W-1; a
// null entry (page id 0) is skipped before anything is loaded; a live
// page's `page` rows are scored q.k * D^-0.5 in float32, a row is
// masked unless its tag is >= 0, qpos - tag >= 0 and, with window > 0,
// qpos - tag < window; the page folds into online-softmax statistics
// (m, l, acc), all float32; the output is acc / max(l, 1e-30) in q's
// dtype, laid out (B, C, H, D).
//
// Design.  One block per (query-row tile, KV head, slot): it serves the
// G = H / hkv query heads of that KV head for up to CT query rows
// (RMAX = CT * G rows in all; the C dimension is split over blocks so
// that a row's acc[D] stays in registers).  The Pallas grid walks the
// table in order on one core; here the block's NW warps split the walk,
// warp w taking entries w, w + NW, ...  Each warp stages its page's K,
// V (float32) and tags in its own shared memory, then scores, rescales
// and accumulates for all the block's rows, keeping (m, l) in shared
// memory and acc in registers.  At the end the warps' statistics merge
// in warp order.  The page-to-warp map and the merge order are fixed,
// so results are deterministic run to run.
//
// Bound on the H100: bytes.  The work is 4 flops per K/V element read
// (q.k and p.v), far below the ridge, so the floor is the live pages'
// K, V and tags (2 KB + 32 B per page and KV head in bf16 at page 8,
// D 64) plus q and the output, over 3.35 TB/s.  At decode only B x hkv
// = 64 blocks run on 132 SMs, and each warp has one page in flight: the
// split-context (flash-decoding) form that fills the card is the
// partial=True variant, a later change.
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
// zeros (l = 0, acc = 0).
//
// Pool offsets are 64-bit: a full-width pool holds more than 2^31
// elements over all layers, and one layer's pool can come close.
#include "common.cuh"

namespace paged {

using mor::from_f;
using mor::load16;
using mor::to_f;

constexpr int NW = 8;             // warps per block
constexpr int ELEMS = 2048;       // rows x head dim one block holds
constexpr int NE = ELEMS / 32;    // acc registers per lane
constexpr float NEG_INF = -1e30f;

// per-warp shared floats: K page (rows padded to D + 1 so that lanes
// scoring different keys hit different banks), V page, tags, scores /
// weights (RMAX x P), and m, l, rescale factor per row
template <int D>
__host__ __device__ constexpr int warp_floats(int P) {
  return P * (D + 1) + P * D + P + (ELEMS / D) * P + 3 * (ELEMS / D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
gqa_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ pp,
                 const int* __restrict__ tbl, const int* __restrict__ qpos,
                 T* __restrict__ out, int C, int H, int hkv, int P, int W,
                 int tbl_stride, int window, float scale) {
  constexpr int RMAX = ELEMS / D;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int G = H / hkv;
  const int CT = RMAX / G;
  const int c0 = blockIdx.x * CT, kvh = blockIdx.y, b = blockIdx.z;
  const int R = min(CT, C - c0) * G;          // rows r = c_local * G + g
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
    const int cl = r / G, g = r % G;
    qs[r * (D + 1) + d] =
        to_f(q[(((size_t)b * C + c0 + cl) * H + kvh * G + g) * D + d]);
  }
  for (int r = threadIdx.x; r < R; r += NW * 32)
    qp[r] = qpos[(size_t)b * C + c0 + r / G];
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
    const int pg = tbl[(size_t)b * tbl_stride + j];
    if (pg == 0) continue;                    // null page: nothing loaded
    const size_t base = (size_t)pg * P * row_stride + (size_t)kvh * D;
    for (int c = lane; c < P * (D / VEC); c += 32) {
      const int t = c / (D / VEC), dv = (c % (D / VEC)) * VEC;
      float tmp[VEC];
      load16(kp + base + t * row_stride + dv, tmp);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ks[t * (D + 1) + dv + i] = tmp[i];
      load16(vp + base + t * row_stride + dv, tmp);
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
    // acc = acc * corr + p . V; lane owns elements lane + 32 k of (R, D)
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = lane + 32 * k, r = e / D, d = e % D;
      if (r < R) {
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
        const int e = lane + 32 * k, r = e / D, d = e % D;
        if (r < R) {
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
  for (int e = threadIdx.x; e < R * D; e += NW * 32) {
    const int r = e / D, d = e % D;
    const int cl = r / G, g = r % G;
    out[(((size_t)b * C + c0 + cl) * H + kvh * G + g) * D + d] =
        from_f<T>(qs[r * (D + 1) + d] / fmaxf(Ml[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* pp,
           const int* tbl, const int* qpos, void* out, int B, int C, int H,
           int hkv, int P, int W, int tbl_stride, int window, float scale,
           cudaStream_t st) {
  constexpr int RMAX = ELEMS / D;
  const int G = H / hkv;
  if (G < 1 || G > RMAX || H % hkv) return (int)cudaErrorInvalidValue;
  const int CT = RMAX / G;
  const size_t smem =
      sizeof(float) * (RMAX * (D + 1) + 3 * RMAX + NW * warp_floats<D>(P));
  auto kern = gqa_paged_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C + CT - 1) / CT, hkv, B);
  kern<<<grid, NW * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pp, tbl, qpos, static_cast<T*>(out), C, H,
      hkv, P, W, tbl_stride, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int D, const void* q, const void* kp, const void* vp,
           const int* pp, const int* tbl, const int* qpos, void* out, int B,
           int C, int H, int hkv, int P, int W, int tbl_stride, int window,
           float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, pp, tbl, qpos, out, B, C, H, hkv, P,
                           W, tbl_stride, window, scale, st);
    case 64:
      return launch<T, 64>(q, kp, vp, pp, tbl, qpos, out, B, C, H, hkv, P,
                           W, tbl_stride, window, scale, st);
    case 128:
      return launch<T, 128>(q, kp, vp, pp, tbl, qpos, out, B, C, H, hkv, P,
                            W, tbl_stride, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace paged

// q (B, C, H, D); kp, vp (pages, P, hkv, D) in `dtype`; pp (pages, P)
// int32; tbl (B, >= W) int32 with rows tbl_stride apart; qpos (B, C)
// int32; out (B, C, H, D).  D in {32, 64, 128}.  Returns
// cudaGetLastError().
extern "C" int gqa_paged_flash(const void* q, const void* kp, const void* vp,
                               const int* pp, const int* tbl,
                               const int* qpos, void* out, int B, int C,
                               int H, int hkv, int D, int P, int W,
                               int tbl_stride, int window, float scale,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mor::BF16)
    return paged::by_dim<__nv_bfloat16>(D, q, kp, vp, pp, tbl, qpos, out, B,
                                        C, H, hkv, P, W, tbl_stride, window,
                                        scale, st);
  if (dtype == mor::F32)
    return paged::by_dim<float>(D, q, kp, vp, pp, tbl, qpos, out, B, C, H,
                                hkv, P, W, tbl_stride, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
