// Shared geometry and conversions for the MoR kernels (sm_90a).
//
// Every kernel keeps the reference's mask geometry: a mask decision
// covers TM = 8 rows x TN = 128 columns (repro/configs/base.py
// MoRConfig.tile_m / tile_n), and a contraction mask block is KC = 128
// wide.  mor_tile_mask runs a block of TN x KS threads on the CUDA
// cores: thread (tx, ty) owns output column tx of the block's 8-row
// tile and sums the contraction indices k = ty, ty + KS, ... of each
// KC-wide chunk, so a warp reads 32 neighbouring columns of one weight
// row (coalesced), and the KS partial sums meet in shared memory in a
// fixed order.  The three MoR matmuls (gather_matmul,
// masked_matmul_kdim, masked_matmul) left that geometry for the 64 x
// 128 tiles of mma_tile.cuh (tensor cores in bf16), and binary_dot for
// the int8 tensor-core tiles of sign_mma.cuh; both sum split-K partials
// in a fixed order: every result is deterministic run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mor {

constexpr int TM = 8;     // rows per mask decision
constexpr int TN = 128;   // columns per mask decision
constexpr int KS = 4;     // contraction lanes per column
constexpr int KC = 128;   // contraction chunk staged in shared memory

enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes of T -> float (the source 16-byte aligned)
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
}

// Launch `kernel` with NT-thread blocks on `grid`, in clusters of
// `split` blocks along x (split = 1 is a cluster of one), with `smem`
// bytes of dynamic shared memory.  The attribute that lets a block take
// more than 48 KB is set up to `smem_max` once a device (bit `dev` of
// `ready`, one word an instantiation).  Returns the launch's error code.
template <int NT = 256, typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), unsigned long long& ready,
                   int smem_max, dim3 grid, int split, int smem,
                   cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!((ready >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace mor
