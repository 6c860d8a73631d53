// Fused MoR tile-mask predictor for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mor_predict.py
// `mor_tile_mask` (pallas_call at l.104; wrapper repro/kernels/ops.py
// `mor_tile_mask`).  One pass per (8-row block, 128-column tile):
//   p_bin  = sign_act(x) . sign(w)        summed exactly in int32
//   p_hat  = (m * p_bin + b) * sc + bi    (+ res_scale * residual)
//   skip   = (p_hat < 0 & enable & proxy_neg == 1) | proxy_neg == 2
//   out    = any(!skip) over the tile     (__syncthreads_or)
//
// Bound on the H100: bytes.  The kernel reads the whole weight (K x N,
// 33.5 MB in bf16 at granite-3-2b's 2048 x 8192) only for its signs,
// against 2*M*K*N sign operations, which at M <= 256 rows is far below
// the card's int8 rate.  The design therefore streams each weight
// element once per row block from device memory with coalesced loads,
// puts row blocks of the same column tile on neighbouring block ids so
// that the re-reads of a weight strip hit L2, and never writes p_hat:
// only one int32 per tile leaves the block.  (Reading a bf16 weight
// for its sign is the cost a packed 1-bit copy would cut 16x.)
//
// The expert grid (MoE layers; the JAX package vmaps the Pallas call):
// blockIdx.z is the expert, and every operand is offset by its expert
// stride, so one FFN is the E = 1 case of the same body.  A tile whose
// proxy states are all 2 (forced skip: shape padding, or an expert's
// capacity rows past its routed count) is written dead before anything
// of x or w is loaded; that is exact, the plain version gives the same
// dead tile.  At a decode dispatch of 8 tokens, top-6 of 160 experts,
// at most 48 experts hold a token, so the early exit is what keeps the
// predictor's read near those experts' gate weights (0.75 GB of 2.5 GB
// for deepseek-v2-236b's 160 x 5120 x 1536 bf16 gates).
//
// The epilogue uses __fmul_rn / __fadd_rn: nvcc would otherwise
// contract a*b+c into one FMA, and near p_hat = 0 a single rounding
// difference can flip a mask bit against the plain PyTorch version,
// which rounds after every operation.
#include "common.cuh"

namespace mor {

constexpr int N_COEF = 6;  // coef rows: m, b, bn_scale, bn_bias, enable, res

template <typename T>
__global__ void __launch_bounds__(TN * KS)
mor_tile_mask_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ coef,
                     const int8_t* __restrict__ pn,
                     const float* __restrict__ res, int* __restrict__ out,
                     int M, int K, int N) {
  __shared__ int8_t xs[TM][KC];
  __shared__ int part[KS][TM][TN];
  const int rb = blockIdx.x, ct = blockIdx.y;
  const size_t ex = blockIdx.z;                 // expert
  x += ex * M * K;
  w += ex * K * N;
  coef += ex * N_COEF * N;
  pn += ex * M * N;
  if (res != nullptr) res += ex * M * N;
  out += ex * gridDim.x * gridDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;
  const int col = ct * TN + tx;
  const size_t row0 = (size_t)rb * TM;

  // all rows forced dead: the tile is dead, nothing else is read
  int maybe_live = 0;
  for (int e = tid; e < TM * TN; e += TN * KS)
    maybe_live |= pn[(row0 + e / TN) * N + ct * TN + e % TN] <= 1;
  if (!__syncthreads_or(maybe_live)) {
    if (tid == 0) out[(size_t)rb * gridDim.y + ct] = 0;
    return;
  }

  int acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int e = tid; e < TM * KC; e += TN * KS) {
      const int r = e / KC, kk = e % KC;
      // activation sign: strictly positive -> +1, else -1
      xs[r][kk] = (kk < kc && to_f(x[(row0 + r) * K + k0 + kk]) > 0.f)
                      ? 1 : -1;
    }
    __syncthreads();
    for (int kk = ty; kk < kc; kk += KS) {
      // weight sign from the sign convention w >= 0 -> +1
      const int ws = to_f(w[(size_t)(k0 + kk) * N + col]) >= 0.f ? 1 : -1;
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] += xs[r][kk] * ws;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) part[ty][r][tx] = acc[r];
  __syncthreads();

  int live = 0;
  if (ty == 0) {
    const float m = coef[col], b = coef[N + col];
    const float sc = coef[2 * N + col], bi = coef[3 * N + col];
    const float en = coef[4 * N + col], rs = coef[5 * N + col];
    for (int r = 0; r < TM; ++r) {
      int tot = 0;
      for (int s = 0; s < KS; ++s) tot += part[s][r][tx];
      const size_t idx = (row0 + r) * N + col;
      float ph = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(m, (float)tot), b),
                                     sc), bi);
      if (res != nullptr) ph = __fadd_rn(ph, __fmul_rn(rs, res[idx]));
      const int8_t p = pn[idx];
      const bool skip = (ph < 0.f && en > 0.5f && p == 1) || p > 1;
      live |= !skip;
    }
  }
  live = __syncthreads_or(live);
  if (tid == 0) out[(size_t)rb * gridDim.y + ct] = live;
}

}  // namespace mor

// E experts, each x (M, K), w (K, N) in `dtype`; coef (6, N) f32; pn
// (M, N) int8; res (M, N) f32 or null; out (M/8, N/128) int32; all
// contiguous with the expert dim leading.  M % 8 == 0 and N % 128 == 0
// (the wrapper pads).  Returns cudaGetLastError().
extern "C" int mor_tile_mask(const void* x, const void* w, const float* coef,
                             const int8_t* pn, const float* res, int* out,
                             int E, int M, int K, int N, int dtype,
                             void* stream) {
  using namespace mor;
  const dim3 grid(M / TM, N / TN, E), block(TN, KS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    mor_tile_mask_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), coef, pn, res, out, M, K, N);
  } else if (dtype == F32) {
    mor_tile_mask_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), coef,
        pn, res, out, M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
