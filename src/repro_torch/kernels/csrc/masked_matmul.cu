// Two masked matmuls for sm_90a: the contraction-masked MoR down
// projection (`masked_matmul_kdim`) and the output-tile-masked product
// of the kernel API (`masked_matmul`, at the end of the file).
//
// masked_matmul_kdim:
//
// Replaces the Pallas TPU kernel repro/kernels/masked_matmul.py
// `masked_matmul_kdim` (pallas_call at l.121; wrapper
// repro/kernels/ops.py `masked_matmul_kdim`).  out = x @ w where the
// (8-row block i, 128-wide k block) pairs whose mask is 0 are skipped:
// they are dead FFN hidden tiles, exact zeros, so the skip is exact.
// One block per (row block, 128-column output tile); it loops over the
// k blocks and skips a dead one before loading anything of it.  Sums
// are float32 and stored in the input dtype.
//
// Bound on the H100: bytes.  For granite-3-2b's down projection the
// weight is 8192 x 2048 (33.5 MB in bf16) against 2 x rows flops per
// element; only the k blocks live for some row block need to be read.
// Row blocks of one output tile sit on neighbouring block ids, so the
// re-reads of a weight strip across row blocks hit L2.  The multiply-
// adds run on the CUDA cores; tensor cores are a later change.
//
// The expert grid (MoE layers; the JAX package vmaps the Pallas call):
// blockIdx.z is the expert and every operand is offset by its expert
// stride; one FFN is E = 1.  A row block whose k blocks are all dead
// (an expert's capacity rows past its routed count) writes zeros and
// reads nothing.
#include "common.cuh"

namespace mor {

template <typename T>
__global__ void __launch_bounds__(TN * KS)
masked_matmul_kdim_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const int* __restrict__ mask, T* __restrict__ out,
                          int M, int K, int N) {
  __shared__ float xs[TM][KC];
  __shared__ float part[KS][TM][TN];
  const int rb = blockIdx.x;
  const size_t ex = blockIdx.z;                 // expert
  x += ex * M * K;
  w += ex * K * N;
  out += ex * M * N;
  mask += ex * (M / TM) * (K / KC);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;
  const int col = blockIdx.y * TN + tx;
  const bool in_n = col < N;
  const size_t row0 = (size_t)rb * TM;
  const int nk = K / KC;

  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (mask[(size_t)rb * nk + kt] == 0) continue;   // uniform per block
    const int k0 = kt * KC;
    for (int e = tid; e < TM * KC; e += TN * KS) {
      const int r = e / KC, kk = e % KC;
      xs[r][kk] = to_f(x[(row0 + r) * K + k0 + kk]);
    }
    __syncthreads();
    if (in_n) {
      for (int kk = ty; kk < KC; kk += KS) {
        const float wv = to_f(w[(size_t)(k0 + kk) * N + col]);
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = fmaf(xs[r][kk], wv, acc[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) part[ty][r][tx] = acc[r];
  __syncthreads();
  if (ty == 0 && in_n) {
    for (int r = 0; r < TM; ++r) {
      float v = 0.f;
      for (int q = 0; q < KS; ++q) v += part[q][r][tx];
      out[(row0 + r) * N + col] = from_f<T>(v);
    }
  }
}

}  // namespace mor

// E experts, each x (M, K), w (K, N), out (M, N) in `dtype` and mask
// (M/8, K/128) int32.  M % 8 == 0 and K % 128 == 0 (the wrapper pads);
// any N.
extern "C" int masked_matmul_kdim(const void* x, const void* w,
                                  const int* mask, void* out, int E, int M,
                                  int K, int N, int dtype, void* stream) {
  using namespace mor;
  const dim3 grid(M / TM, (N + TN - 1) / TN, E), block(TN, KS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    masked_matmul_kdim_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), mask,
        static_cast<__nv_bfloat16*>(out), M, K, N);
  } else if (dtype == F32) {
    masked_matmul_kdim_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), mask,
        static_cast<float*>(out), M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// masked_matmul:
//
// Replaces the Pallas TPU kernel repro/kernels/masked_matmul.py
// `masked_matmul` (pallas_call at l.63; wrapper repro/kernels/ops.py
// `masked_matmul`, tile 8 x 128).  out = x @ w where each (8-row,
// 128-column) output tile whose mask is 0 is written as zeros without a
// multiply-add: one block per output tile, and a dead block writes its
// zeros and returns before it reads x or w.  A live block loops over
// the whole contraction in chunks of 128 (the last one ragged), sums in
// float32 and stores in the input dtype.  The live-tile count is the
// wrapper's device-side sum of the mask.
//
// Bound on the H100: bytes.  At the rows of a decode dispatch or a
// conv layer's im2col (M up to a few thousand) against 2 * 8 flops per
// weight element a live tile reads, the floor is the live column
// strips of w, the live row blocks of x and the output over 3.35 TB/s.
// Row blocks of one column tile sit on neighbouring block ids, so a
// weight strip's re-reads across row blocks hit L2.  CUDA cores, as in
// the other first kernels; tensor cores are a later change.

namespace mor {

template <typename T>
__global__ void __launch_bounds__(TN * KS)
masked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ mask, T* __restrict__ out,
                     int M, int K, int N) {
  const int rb = blockIdx.x, ct = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;
  const int col = ct * TN + tx;
  const size_t row0 = (size_t)rb * TM;
  if (mask[(size_t)rb * gridDim.y + ct] == 0) {      // uniform per block
    for (int e = tid; e < TM * TN; e += TN * KS)
      out[(row0 + e / TN) * N + ct * TN + e % TN] = from_f<T>(0.f);
    return;
  }
  __shared__ float xs[TM][KC];
  __shared__ float part[KS][TM][TN];

  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int e = tid; e < TM * KC; e += TN * KS) {
      const int r = e / KC, kk = e % KC;
      xs[r][kk] = kk < kc ? to_f(x[(row0 + r) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = ty; kk < kc; kk += KS) {
      const float wv = to_f(w[(size_t)(k0 + kk) * N + col]);
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(xs[r][kk], wv, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) part[ty][r][tx] = acc[r];
  __syncthreads();
  if (ty == 0) {
    for (int r = 0; r < TM; ++r) {
      float v = 0.f;
      for (int q = 0; q < KS; ++q) v += part[q][r][tx];
      out[(row0 + r) * N + col] = from_f<T>(v);
    }
  }
}

}  // namespace mor

// x (M, K), w (K, N), out (M, N) in `dtype`; mask (M/8, N/128) int32;
// all contiguous.  M % 8 == 0 and N % 128 == 0 (the wrapper pads); any
// K.
extern "C" int masked_matmul(const void* x, const void* w, const int* mask,
                             void* out, int M, int K, int N, int dtype,
                             void* stream) {
  using namespace mor;
  const dim3 grid(M / TM, N / TN), block(TN, KS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    masked_matmul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), mask,
        static_cast<__nv_bfloat16*>(out), M, K, N);
  } else if (dtype == F32) {
    masked_matmul_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), mask,
        static_cast<float*>(out), M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
