// Two masked matmuls for sm_90a: the contraction-masked MoR down
// projection (`masked_matmul_kdim`) and the output-tile-masked product
// of the kernel API (`masked_matmul`, at the end of the file).
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
