// Fused MoR tile-mask predictor for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mor_predict.py
// `mor_tile_mask` (pallas_call at l.104; wrapper repro/kernels/ops.py
// `mor_tile_mask`).  For each 8-row x 128-column mask block:
//   p_bin  = sign_act(x) . sign(w)        summed exactly in int32
//   p_hat  = (m * p_bin + b) * sc + bi    (+ res_scale * residual)
//   skip   = (p_hat < 0 & enable & proxy_neg == 1) | proxy_neg > 1
//   out    = any(!skip) over the block
//
// Bound on the H100: bytes.  The kernel reads the whole weight (K x N,
// 33.5 MB in bf16 at granite-3-2b's 2048 x 8192) only for its signs,
// against 2 M K N sign operations, far below the int8 ridge at M <= 256
// rows.  p_bin is binary_dot's product bit for bit (the same sign
// conventions: x > 0 -> +1; w >= 0 -> +1, -0.0 +1, NaN -1; exact int32
// sums in any order), so it runs on binary_dot's core (sign_mma.cuh):
// signs made in registers from 16-byte loads with packed compares, int8
// mma.sync m16n8k32 tiles, and K split over a thread block cluster
// where the tiles alone leave the card idle.  The column tile is always
// the mask's 128 columns, so no mask block spans two blocks: 16 x 128 at
// a decode dispatch (M <= 16), 64 x 128 elsewhere, and the split from
// split_k.split_over (mor_predict.plan).
//
// The fused epilogue: the block's int32 p_bin tile lies in its shared
// memory (rank r's partial in rank r's); the cluster synchronises, and
// warp w of rank r takes 8-row block w split + r of the tile, summing
// its p_bin from ranks 0 .. split-1 in that order through distributed
// shared memory (exact integers), folding it with the coef table, the
// proxy states and the residual, and reducing any(!skip) over the
// block's 8 x 128 entries by a warp vote.  One int32 a mask block leaves
// the cluster: p_hat and p_bin never reach device memory.  The epilogue
// uses __fmul_rn / __fadd_rn in the plain version's order: nvcc would
// otherwise contract a*b+c into one FMA, and near p_hat = 0 a single
// rounding difference can flip a mask bit.
//
// The early exit: a tile whose proxy states are all 2 (forced skip:
// shape padding, or an expert's capacity rows past its routed count)
// writes its mask blocks dead before anything of x or w is loaded; that
// is exact, the plain version gives the same dead blocks.  The expert
// grid (MoE layers; the JAX package vmaps the Pallas call) is
// blockIdx.z, every operand offset by its expert stride, so one FFN is
// the E = 1 case; at a decode dispatch of 8 tokens, top-6 of 160
// experts, at most 48 experts hold a token, and the exit keeps the read
// near those experts' gate weights.  Rows past M inside a 16-row tile
// (the expert grid's 8-row capacity) are neither read nor written.
#include "sign_mma.cuh"

namespace mor {

namespace cg = cooperative_groups;

constexpr int N_COEF = 6;  // coef rows: m, b, bn_scale, bn_bias, enable, res

// any(proxy state <= 1) over the tile's `rows` rows x 128 columns (16
// bytes a load: N % 128 == 0 and pn is 16-byte aligned), in every
// thread of the block
__device__ __forceinline__ bool tile_maybe_live(const int8_t* pn, int N,
                                                int row0, int col0,
                                                int rows) {
  int maybe = 0;
  for (int e = threadIdx.x; e < rows * (TN / 16); e += sgn::THREADS) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        pn + (size_t)(row0 + e / (TN / 16)) * N + col0 + (e % (TN / 16)) * 16));
    // bytes as signed: 0xFF where the state is > 1
    const uint32_t gt = __vcmpgts4(u.x, 0x01010101u) &
                        __vcmpgts4(u.y, 0x01010101u) &
                        __vcmpgts4(u.z, 0x01010101u) &
                        __vcmpgts4(u.w, 0x01010101u);
    maybe |= gt != 0xFFFFFFFFu;
  }
  return __syncthreads_or(maybe);
}

// Registers: a 16-row tile's block keeps to 85, so that three fit an
// SM (a decode dispatch's clusters of 4 then pack the card in one
// wave), a 64-row tile's to 128 (two an SM)
template <typename T, int BM, int WM, bool VEC>
__global__ void __launch_bounds__(sgn::THREADS, BM == 16 ? 3 : 2)
mor_tile_mask_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ coef,
                     const int8_t* __restrict__ pn,
                     const float* __restrict__ res, int* __restrict__ out,
                     int M, int K, int N, int split, int kb_per) {
  using Tile = sgn::SignTile<T, BM, TN, WM, VEC, sgn::FloatSigns<T, TN, VEC>>;
  using S = sgn::Smem<T, BM, TN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = blockIdx.x % split, ct = blockIdx.x / split;
  const int row0 = blockIdx.y * BM, col0 = ct * TN;
  const int nct = N / TN;
  const size_t ex = blockIdx.z;                 // expert
  x += ex * M * K;
  w += ex * K * N;
  coef += ex * N_COEF * N;
  pn += ex * M * N;
  if (res != nullptr) res += ex * M * N;
  out += ex * (M / TM) * nct;
  const int groups = min(BM, M - row0) / TM;    // mask blocks of the tile

  if (!tile_maybe_live(pn, N, row0, col0, groups * TM)) {
    if (rank == 0 && (int)threadIdx.x < groups)
      out[(size_t)(row0 / TM + threadIdx.x) * nct + ct] = 0;
    return;                                     // every rank exits here
  }

  int acc[Tile::MI][Tile::NI][4] = {};
  Tile::product(x, w, M, K, N, row0, col0, rank * kb_per * sgn::KB,
                min(K, (rank + 1) * kb_per * sgn::KB), smem, acc);
  __syncthreads();                              // the stages are free
  int* tile = reinterpret_cast<int*>(smem);
  Tile::to_tile(acc, tile);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                               // every partial in place

  const int g = warp * split + rank;            // this warp's mask block
  if (g < groups) {
    // every global operand of the block's 8 x 128 entries first (one
    // round trip), then p_bin from the ranks, then the fold
    const int c = col0 + 4 * lane;              // the lane's 4 columns
    const size_t idx0 = (size_t)(row0 + TM * g) * N + c;
    float4 cf[N_COEF], rv[TM];
    uint32_t p4[TM];
#pragma unroll
    for (int i = 0; i < N_COEF; ++i)
      cf[i] = __ldg(reinterpret_cast<const float4*>(coef + (size_t)i * N + c));
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      p4[r] = __ldg(reinterpret_cast<const unsigned int*>(pn + idx0 +
                                                          (size_t)r * N));
      rv[r] = res != nullptr ? __ldg(reinterpret_cast<const float4*>(
                                   res + idx0 + (size_t)r * N))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    bool live = false;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      int v[4] = {0, 0, 0, 0};
      for (int q = 0; q < split; ++q) {         // fixed order (exact)
        const int4 u = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(tile, q) + (TM * g + r) * S::LDT +
            4 * lane);
        v[0] += u.x; v[1] += u.y; v[2] += u.z; v[3] += u.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = (&cf[0].x)[e], b = (&cf[1].x)[e];
        const float sc = (&cf[2].x)[e], bi = (&cf[3].x)[e];
        const float en = (&cf[4].x)[e], rs = (&cf[5].x)[e];
        float ph = __fadd_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(m, (float)v[e]), b), sc), bi);
        if (res != nullptr) ph = __fadd_rn(ph, __fmul_rn(rs, (&rv[r].x)[e]));
        const int8_t p = (int8_t)((p4[r] >> (8 * e)) & 0xFFu);
        const bool skip = (ph < 0.f && en > 0.5f && p == 1) || p > 1;
        live |= !skip;
      }
    }
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) out[(size_t)(row0 / TM + g) * nct + ct] = live;
  }
  cluster.sync();                               // no block leaves while read
}

template <typename T, int BM, int WM, bool VEC>
int mor_launch(const T* x, const T* w, const float* coef, const int8_t* pn,
               const float* res, int* out, int E, int M, int K, int N,
               int split, int kb_per, cudaStream_t st) {
  using S = sgn::Smem<T, BM, TN>;
  static unsigned long long ready = 0;          // one an instantiation
  const int rows = (M + BM - 1) / BM;
  if (rows > 65535 || E > 65535 || split < 1 || split > 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N / TN) * split, rows, E);
  return launch_cluster(mor_tile_mask_kernel<T, BM, WM, VEC>, ready, S::MAX,
                        grid, split, S::MAX, st, x, w, coef, pn, res, out, M,
                        K, N, split, kb_per);
}

template <typename T>
int mor_typed(const void* x, const void* w, const float* coef,
              const int8_t* pn, const float* res, int* out, int E, int M,
              int K, int N, int bm, int split, int kb_per, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  constexpr int EPC = sgn::Geo<T>::EPC;
  // 16-byte chunks: every expert's x and w start on a chunk boundary
  const bool vec = K % EPC == 0 && N % EPC == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (bm == 16)
    return vec ? mor_launch<T, 16, 1, true>(xt, wt, coef, pn, res, out, E, M,
                                            K, N, split, kb_per, st)
               : mor_launch<T, 16, 1, false>(xt, wt, coef, pn, res, out, E,
                                             M, K, N, split, kb_per, st);
  if (bm == 64)
    return vec ? mor_launch<T, 64, 2, true>(xt, wt, coef, pn, res, out, E, M,
                                            K, N, split, kb_per, st)
               : mor_launch<T, 64, 2, false>(xt, wt, coef, pn, res, out, E,
                                             M, K, N, split, kb_per, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mor

// E experts, each x (M, K), w (K, N) in `dtype`; coef (6, N) f32; pn
// (M, N) int8; res (M, N) f32 or null; out (M/8, N/128) int32; all
// contiguous with the expert dim leading; coef, pn and res 16-byte
// aligned.  M % 8 == 0 and N % 128 == 0 (the wrapper pads).  The tile is
// bm x 128 rows x columns (bm 16 or 64, mor_predict.plan), and split
// blocks a cluster share it, each kb_per 128-wide k blocks.  Returns the
// launch's error code.
extern "C" int mor_tile_mask(const void* x, const void* w, const float* coef,
                             const int8_t* pn, const float* res, int* out,
                             int E, int M, int K, int N, int bm, int split,
                             int kb_per, int dtype, void* stream) {
  using namespace mor;
  if (M % TM || N % TN || E < 1 ||
      (reinterpret_cast<uintptr_t>(coef) | reinterpret_cast<uintptr_t>(pn) |
       reinterpret_cast<uintptr_t>(res)) % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return mor_typed<__nv_bfloat16>(x, w, coef, pn, res, out, E, M, K, N, bm,
                                    split, kb_per, st);
  if (dtype == F32)
    return mor_typed<float>(x, w, coef, pn, res, out, E, M, K, N, bm, split,
                            kb_per, st);
  return (int)cudaErrorInvalidValue;
}
