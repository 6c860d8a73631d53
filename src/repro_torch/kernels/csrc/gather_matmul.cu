// Capacity-compacted MoR matmul for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/gather_matmul.py
// `gather_matmul` (pallas_call at l.101; wrapper repro/kernels/ops.py
// `gather_matmul`).  The wrapper compacts the live (8-row block,
// 128-column tile) pairs into a slot list, live tiles first in
// row-major order, and keeps `n_live` = min(live tiles, clamped
// capacity) on the device.  The grid has one block per provisioned
// slot; a block whose slot is past n_live returns before it loads
// anything, so only live weight strips are ever read.  The output is
// zeroed by the wrapper, which makes every unvisited tile an exact zero.
// Sums are float32 and stored in the input dtype.
//
// Bound on the H100: bytes.  At decode (8 rows) a live tile does 2 x 8
// flops per weight element it reads, far below the bf16 ridge of ~295
// flops/byte, so the floor is the live share of the weight (33.5 MB
// for a dense 2048 x 8192 bf16 gate) over 3.35 TB/s.  The design reads
// each live weight strip once per row block with coalesced loads and
// reads nothing for dead slots.  It does the multiply-adds on the CUDA
// cores: at 256 rows that costs more than a tensor-core product would,
// which is a later change (wgmma over the compacted slot list).
//
// The expert grid (MoE layers; the JAX package vmaps the Pallas call):
// blockIdx.z is the expert, each expert has its own slot list, built
// on the device by the wrapper, and its own n_live (its calibrated
// per-expert budget already applied), and every operand is offset by
// its expert stride; one FFN is E = 1.  An expert that holds no routed
// token has no live tile, so all its blocks return at once.
#include "common.cuh"

namespace mor {

template <typename T>
__global__ void __launch_bounds__(TN * KS)
gather_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ slots,
                     const int* __restrict__ n_live, T* __restrict__ out,
                     int M, int K, int N, int capacity) {
  const int s = blockIdx.x;
  const size_t ex = blockIdx.z;                 // expert
  if (s >= n_live[ex]) return;
  x += ex * M * K;
  w += ex * K * N;
  out += ex * M * N;
  slots += ex * capacity;
  __shared__ float xs[TM][KC];
  __shared__ float part[KS][TM][TN];
  const int nn = N / TN;
  const int tile = slots[s];
  const size_t row0 = (size_t)(tile / nn) * TM;
  const int col = (tile % nn) * TN + threadIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;

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

// E experts, each x (M, K), w (K, N), out (M, N) zero-filled, all in
// `dtype`; slots (E, capacity) int32 flattened tile ids (i * N/128 +
// j); n_live (E,) int32 on the device.  M % 8 == 0, N % 128 == 0.
extern "C" int gather_matmul(const void* x, const void* w, const int* slots,
                             const int* n_live, void* out, int E, int M,
                             int K, int N, int capacity, int dtype,
                             void* stream) {
  using namespace mor;
  const dim3 grid(capacity, 1, E), block(TN, KS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    gather_matmul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), slots, n_live,
        static_cast<__nv_bfloat16*>(out), M, K, N, capacity);
  } else if (dtype == F32) {
    gather_matmul_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), slots,
        n_live, static_cast<float*>(out), M, K, N, capacity);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
