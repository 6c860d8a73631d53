// Two masked matmuls for sm_90a on one tile core (mma_tile.cuh): the
// contraction-masked MoR down projection (`masked_matmul_kdim`) and the
// output-tile-masked product of the kernel API (`masked_matmul`, at the
// end of the file).
//
// masked_matmul_kdim:
//
// Replaces the Pallas TPU kernel repro/kernels/masked_matmul.py
// `masked_matmul_kdim` (pallas_call at l.121; wrapper
// repro/kernels/ops.py `masked_matmul_kdim`).  out = x @ w where each
// (8-row block i, 128-wide k block) pair whose mask is 0 contributes
// nothing, whatever x holds there: the Pallas kernel skips the pair, and
// the plain version zeroes it before its product.  Sums are float32 and
// stored in the input dtype.
//
// Bound on the H100: bytes.  For granite-3-2b's down projection the
// weight is 8192 x 2048 (33.5 MB in bf16) against 2 x rows flops per
// element; only the k blocks live for some row block need to be read
// (about 0.006 ms at 8 rows and 0.011 ms at 256 over 3.35 TB/s).
//
// Design (the tile core is csrc/mma_tile.cuh).  The grid is (128-column
// output tile x split, 64-row group, expert).  A block first folds the
// mask of its 8 row blocks into one byte a k block.  A group whose k
// blocks are all dead (an expert's capacity rows past its routed count)
// writes zeros and reads nothing; a row block dead in every k block is
// stored as zeros and its rows are never read.  Otherwise the ring walks
// the k blocks of the block's segment and skips, without a load or a
// product, each one dead for all 8 row blocks.  In a live k block the x
// rows of a dead (row block, k block) pair are not read: their cp.async
// copies are zero-fills, so the tile holds zeros there before the
// product, and grouping 8 row blocks never multiplies what x holds in a
// dead pair.  The product runs on the tensor cores (bf16, wgmma) or the
// CUDA cores (float32).  At decode the grid has a block per column tile
// (16 at granite's width), so the wrapper's planner splits K over a
// cluster of up to 8 blocks, summed in rank order through distributed
// shared memory (deterministic).
//
// The expert grid (MoE layers; the JAX package vmaps the Pallas call):
// blockIdx.z is the expert and every operand is offset by its expert
// stride; one FFN is E = 1.
#include "mma_tile.cuh"

namespace mor {

constexpr int KDIM_MAX_KB = 1024;      // k blocks: K <= 131072

template <typename T>
__global__ void __launch_bounds__(tile::THREADS, 2)
masked_matmul_kdim_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const unsigned char* __restrict__ mask,
                          T* __restrict__ out, int M, int K, int N,
                          int split, int kb_per) {
  using namespace tile;
  extern __shared__ __align__(128) char smem[];
  __shared__ unsigned char live_rows[KDIM_MAX_KB];  // k block -> row bits
  __shared__ unsigned need;                         // live in any k block
  const int rank = blockIdx.x % split, j = blockIdx.x / split;
  const size_t ex = blockIdx.z;                     // expert
  const int nm = M / TM, nkb = K / KB;
  x += ex * M * K;
  w += ex * K * N;
  out += ex * M * N;
  mask += ex * nm * nkb;
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const int rb0 = row0 / TM;
  if (threadIdx.x == 0) need = 0;
  __syncthreads();
  unsigned any = 0;
  for (int kb = threadIdx.x; kb < nkb; kb += THREADS) {
    unsigned r = 0;
#pragma unroll
    for (int i = 0; i < BM / TM; ++i)
      if (rb0 + i < nm && mask[(size_t)(rb0 + i) * nkb + kb]) r |= 1u << i;
    live_rows[kb] = (unsigned char)r;
    any |= r;
  }
  if (any) atomicOr(&need, any);
  __syncthreads();
  // a row block dead in every k block (an expert's capacity rows past
  // its routed count) is stored as zeros and never read; every rank
  // folds the whole K range, so the choices are uniform per cluster
  const unsigned rows = need;
  if (rows == 0) {
    zero_tile(out, M, N, row0, col0, rank, split);
    return;
  }
  using G = Geo<T>;
  const int s0 = rank * kb_per * G::STEPS;
  const int s1 = min(nkb, (rank + 1) * kb_per) * G::STEPS;
  const Operands<T> o{x, w, M, K, N, row0, col0};
  run_tile(smem, o, s0, s1,
           [&](int s) { return (unsigned)live_rows[s / G::STEPS]; }, out,
           rows, split);
}

}  // namespace mor

// E experts, each x (M, K), w (K, N), out (M, N) in `dtype` and mask
// (M/8, K/128) bytes.  M % 8 == 0 and K % 128 == 0 (the wrapper pads), N
// a multiple of a 16-byte chunk (8 bf16, 4 float32).  split blocks a
// cluster share a tile, each kb_per k blocks.
extern "C" int masked_matmul_kdim(const void* x, const void* w,
                                  const void* mask, void* out, int E, int M,
                                  int K, int N, int split, int kb_per,
                                  int dtype, void* stream) {
  using namespace mor;
  static unsigned long long ready[2] = {0, 0};
  if (K / tile::KB > KDIM_MAX_KB) return (int)cudaErrorInvalidValue;
  const dim3 grid(((N + TN - 1) / TN) * split,
                  (M + tile::BM - 1) / tile::BM, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m8 = static_cast<const unsigned char*>(mask);
  if (dtype == BF16) {
    using T = __nv_bfloat16;
    return tile::launch(masked_matmul_kdim_kernel<T>, ready[BF16], grid,
                        split, st, static_cast<const T*>(x),
                        static_cast<const T*>(w), m8, static_cast<T*>(out),
                        M, K, N, split, kb_per);
  }
  if (dtype == F32) {
    return tile::launch(masked_matmul_kdim_kernel<float>, ready[F32], grid,
                        split, st, static_cast<const float*>(x),
                        static_cast<const float*>(w), m8,
                        static_cast<float*>(out), M, K, N, split, kb_per);
  }
  return (int)cudaErrorInvalidValue;
}

// masked_matmul:
//
// Replaces the Pallas TPU kernel repro/kernels/masked_matmul.py
// `masked_matmul` (pallas_call at l.63; wrapper repro/kernels/ops.py
// `masked_matmul`, tile 8 x 128).  out = x @ w where each (8-row,
// 128-column) output tile whose mask is 0 is written as exact zeros:
// its x rows are never read and no product of its is stored.  Sums are
// float32, stored in the input dtype; the live-tile count is the
// wrapper's device-side sum of the mask.
//
// Bound on the H100: bytes at a decode dispatch (granite's gate, M = 8:
// the live column strips of w, 0.006 ms) and at 256 rows; operations in
// float32 at a conv layer's im2col (ResNet18 layer 1, M = 131072, K =
// 576, N = 64: 9.7 GFLOP on the CUDA cores, 0.14 ms at 67 TFLOP/s).
//
// Design: the tile core of masked_matmul_kdim, with the output mask in
// place of the contraction mask.  The grid is (128-column tile x split,
// 64-row group); a block folds the mask of its column tile and its 8
// row blocks into `need`.  need = 0 writes the tile's zeros and returns
// before it reads x or w.  Otherwise every contraction step of the
// block's segment is live for exactly the row blocks in `need`: only
// their x rows are copied, the epilogue stores the others as zeros, and
// the float32 path skips their FMAs (in bf16 a warpgroup's wgmma covers
// all 64 rows, and the dead rows' sums are discarded).  bf16 runs on
// wgmma, float32 in full float32 on the CUDA cores (no TF32).  K is any
// length (steps past K zero-fill); the core reads columns up to N only.
// At a decode dispatch the grid holds a block per column tile (64 at
// granite's gate), so the wrapper's planner splits K over a cluster
// (split_k.plan), summed in rank order: the bits repeat run to run.

namespace mor {

template <typename T>
__global__ void __launch_bounds__(tile::THREADS, 2)
masked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const unsigned char* __restrict__ mask,
                     T* __restrict__ out, int M, int K, int N, int split,
                     int kb_per) {
  using namespace tile;
  extern __shared__ __align__(128) char smem[];
  __shared__ unsigned need;
  const int rank = blockIdx.x % split, j = blockIdx.x / split;
  const int nm = (M + TM - 1) / TM, nn = (N + TN - 1) / TN;
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const int rb0 = row0 / TM;
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const bool live = i < BM / TM && rb0 + i < nm &&
                      mask[(size_t)(rb0 + i) * nn + j] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if (i == 0) need = bits;
  }
  __syncthreads();
  const unsigned rows = need;           // uniform per cluster
  if (rows == 0) {
    zero_tile(out, M, N, row0, col0, rank, split);
    return;
  }
  using G = Geo<T>;
  const int steps = (K + G::BK - 1) / G::BK;
  const int s0 = rank * kb_per * G::STEPS;
  const int s1 = min(steps, (rank + 1) * kb_per * G::STEPS);
  const Operands<T> o{x, w, M, K, N, row0, col0};
  run_tile(smem, o, s0, s1, [rows](int) { return rows; }, out, rows,
           split);
}

}  // namespace mor

// x (M, K), w (K, N), out (M, N) in `dtype`; mask (ceil(M/8),
// ceil(N/128)) bytes, non-zero where live.  Any M; K and N multiples of
// a 16-byte chunk (8 bf16, 4 float32: the wrapper pads with zeros).
// split blocks a cluster share a tile, each kb_per 128-wide k blocks.
extern "C" int masked_matmul(const void* x, const void* w, const void* mask,
                             void* out, int M, int K, int N, int split,
                             int kb_per, int dtype, void* stream) {
  using namespace mor;
  static unsigned long long ready[2] = {0, 0};
  if (M == 0 || N == 0) return 0;
  const dim3 grid(((N + TN - 1) / TN) * split,
                  (M + tile::BM - 1) / tile::BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m8 = static_cast<const unsigned char*>(mask);
  if (dtype == BF16) {
    using T = __nv_bfloat16;
    return tile::launch(masked_matmul_kernel<T>, ready[BF16], grid, split,
                        st, static_cast<const T*>(x),
                        static_cast<const T*>(w), m8, static_cast<T*>(out),
                        M, K, N, split, kb_per);
  }
  if (dtype == F32) {
    return tile::launch(masked_matmul_kernel<float>, ready[F32], grid,
                        split, st, static_cast<const float*>(x),
                        static_cast<const float*>(w), m8,
                        static_cast<float*>(out), M, K, N, split, kb_per);
  }
  return (int)cudaErrorInvalidValue;
}
