// Absorbed-MLA paged flash attention for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:302
// `mla_paged_flash` (pallas_call at l.348) in its single-device form:
// normalised output (partial=False), no shard window (lo=None).  The
// query arrives in the rank-kr latent space (W_uk absorbed by the
// caller): for each slot b the kernel walks the block-table entries
// j = 0..W-1 in order; a null entry (page id 0) is skipped before
// anything is loaded; each live page's rows are scored
// (q_lat . c_kv + q_pe . k_pe) * scale in float32, a row is masked
// unless its tag is >= 0 and <= qpos; the page folds into online-
// softmax statistics (m, l, acc) over the kr latent columns, all
// float32; the output o_lat = acc / max(l, 1e-30) in q's dtype, laid
// out (B, C, h, kr).  The caller absorbs W_uv.
//
// Design.  MLA is multi-query attention with h = 128 query heads: every
// head reads the same latent row (kr + rd = 576 values) of every key.
// One block therefore serves R = 8 (query row, head) pairs of one slot
// ("pairs", c-major, so that their q rows are contiguous) and walks
// the slot's whole table, staging each page once in shared memory for
// all its pairs; the grid is (ceil(C h / R), B), 128 blocks at a
// decode dispatch of 8 slots, 4,096 at a mixed one (8 x 32 rows).  The
// Pallas block, which holds all h x C pairs of a slot with an (h, C,
// kr) float32 accumulator (8 MB at the mixed shape), does not fit a
// Hopper SM; R pairs x 512 columns of float32 (16 KB) live in
// registers: thread t owns latent columns t and t + 256 of all R
// pairs.  Per step of KT = 8 keys:
//   1. the 256 threads stage the keys' latent and rope rows with
//      16-byte loads, as float32 (rows padded so that stride % 32 ==
//      16), and their tags;
//   2. scores: 16 groups of 16 lanes, each group a 2 (pairs) x 2
//      (keys) register block over every 16th of the 576 dims, summed
//      by shuffles: bank-conflict free, one shared load per FMA;
//   3. one thread per pair updates (m, l) and the step's weights;
//   4. every thread rescales its accumulators and adds p . c_kv.
// Keys past the page's end (page % 8 != 0) score -inf and weigh
// nothing; the walk order, the step order and the shuffle tree are
// fixed, so results are deterministic run to run.
//
// Bound on the H100: near the ridge.  A cached token costs 2 h (kr +
// rd + kr) flops (278.5 kFLOP at full width) for its 1,152 bytes of
// latent and rope row, ~242 flops a byte against the bf16 ridge of
// ~295: a decode dispatch over ~16k cached tokens is bound by bytes
// (~5 us), a mixed one by operations.  These CUDA-core products sit far
// above that bound; tensor-core products (mma.sync / wgmma over the
// staged page) and a split-context form at decode are later changes.
//
// The finite sentinel: a masked score is -1e30, never -INFINITY, as in
// the Pallas kernel, so a pair that sees no key in any live page gets
// exp(0) = 1 weights over the live pages' rows, i.e. what the Pallas
// kernel gives, and a slot whose table is all null gives exact zeros.
// The strided block table and 64-bit pool offsets are as in
// paged_attention.cu.
#include "common.cuh"

namespace mla {

using mor::from_f;
using mor::load16;

constexpr int NT = 256;                          // threads per block
constexpr int R = 8;                             // pairs per block
constexpr int KT = 8;                            // keys per step
constexpr int SL = NT / ((R / 2) * (KT / 2));    // 16 lanes per 2x2 block
constexpr int MAX_KR = 512;
constexpr int NCOL = MAX_KR / NT;                // latent columns a thread
constexpr float NEG_INF = -1e30f;

// floats between staged rows: D rounded up so that stride % 32 == 16
__host__ __device__ inline int row_stride(int D) {
  return D + ((16 - D % 32) + 32) % 32;
}

__host__ __device__ inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(R + KT) * row_stride(D) + 2 * R * KT +
                          3 * R) +
         sizeof(int) * (KT + R);
}

template <typename T>
__global__ void __launch_bounds__(NT)
mla_paged_kernel(const T* __restrict__ ql, const T* __restrict__ qe,
                 const T* __restrict__ ck, const T* __restrict__ cpe,
                 const int* __restrict__ cp, const int* __restrict__ tbl,
                 const int* __restrict__ qpos, T* __restrict__ out, int C,
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

  constexpr int VEC = 16 / sizeof(T);            // elements per load
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
      if (r < Rb)
        out[(row0 + r) * kr + c] = from_f<T>(acc[jc][r] / fmaxf(Lr[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* ql, const void* qe, const void* ck, const void* cpe,
           const int* cp, const int* tbl, const int* qpos, void* out, int B,
           int C, int h, int kr, int rd, int P, int W, int tbl_stride,
           float scale, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (kr < 1 || kr > MAX_KR || rd < 0 || P < 1 || C * h < 1 ||
      kr % VEC || rd % VEC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kr + rd);
  auto kern = mla_paged_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C * h + R - 1) / R, B);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(ql), static_cast<const T*>(qe),
      static_cast<const T*>(ck), static_cast<const T*>(cpe), cp, tbl, qpos,
      static_cast<T*>(out), C, h, kr, rd, P, W, tbl_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace mla

// q_lat (B, C, h, kr), q_pe (B, C, h, rd); ck (pages, P, kr), cpe
// (pages, P, rd) in `dtype`, 16-byte aligned; cp (pages, P) int32; tbl
// (B, >= W) int32 with rows tbl_stride apart; qpos (B, C) int32; out
// (B, C, h, kr).  kr <= 512, and kr and rd multiples of 16 bytes.
// Returns cudaGetLastError().
extern "C" int mla_paged_flash(const void* ql, const void* qe, const void* ck,
                               const void* cpe, const int* cp,
                               const int* tbl, const int* qpos, void* out,
                               int B, int C, int h, int kr, int rd, int P,
                               int W, int tbl_stride, float scale, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mor::BF16)
    return mla::launch<__nv_bfloat16>(ql, qe, ck, cpe, cp, tbl, qpos, out, B,
                                      C, h, kr, rd, P, W, tbl_stride, scale,
                                      st);
  if (dtype == mor::F32)
    return mla::launch<float>(ql, qe, ck, cpe, cp, tbl, qpos, out, B, C, h,
                              kr, rd, P, W, tbl_stride, scale, st);
  return (int)cudaErrorInvalidValue;
}
