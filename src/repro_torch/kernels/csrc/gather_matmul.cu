// Capacity-compacted MoR matmul for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/gather_matmul.py
// `gather_matmul` (pallas_call at l.101; wrapper repro/kernels/ops.py
// `gather_matmul`).  out = x @ w on the kept (8-row block, 128-column)
// tiles: the first `cap_eff` live tiles of each expert in row-major
// order (flat & (cumsum(flat) - 1 < cap_eff), cap_eff the static
// capacity clamped by the calibrated budget).  Every other tile is an
// exact zero, written by the kernel, which also writes the two counters
// (n_live_total, n_computed): one launch, no memset, no slot list.  Sums
// are float32 and stored in the input dtype.
//
// Bound on the H100: bytes.  At granite-3-2b's gate (K = 2048, N = 8192)
// a decode dispatch (8 rows) does 2 x 8 flops per weight element of a
// kept column strip, far below the bf16 ridge of ~295 flops/byte: the
// floor is the kept strips of w (about 0.005 ms at capacity 0.5 over
// 3.35 TB/s); at 256 rows it is still the weight's bytes (about 0.012
// ms), with the tensor cores' 8.6 GFLOP close behind.
//
// Design (the tile core is csrc/mma_tile.cuh).  The grid is (128-column
// tile j x split, 64-row group g, expert e): a block reads a weight
// strip once for 64 rows, where the first port read it once for every 8.
// A block first ranks the live tiles of its 8 row blocks at column j
// under the budget (reading only the mask); if none is kept it writes
// its tile's zeros and returns before it reads x or w.  Otherwise it
// streams the kept rows of x and the weight strip through the cp.async
// ring, multiplies on the tensor cores (bf16, wgmma) or the CUDA cores
// (float32, full precision), and stores the kept 8-row sub-tiles, zeros
// in the others.  Where the grid cannot fill the card (decode: a few
// dozen kept column tiles) the wrapper's planner splits K over a cluster
// of up to 8 blocks, whose partials meet in distributed shared memory in
// rank order (deterministic).
//
// The expert grid (MoE layers; the JAX package vmaps the Pallas call):
// blockIdx.z is the expert, each with its own budget, counters and
// operand stride; one FFN is E = 1.  An expert that holds no routed
// token has no kept tile, so all its blocks write zeros and return.
#include "mma_tile.cuh"

namespace mor {

// The kept 8-row blocks of rows row0 .. row0 + 63 at column tile j of
// one expert's (nm, nn) mask m: live, and among the first `cap` live
// tiles in row-major order, i.e. flat & (cumsum(flat) - 1 < cap).  Bit
// i is row block row0 / 8 + i; uniform in the block.
__device__ __forceinline__ unsigned kept_rows(const unsigned char* m,
                                              int nm, int nn, int rb0,
                                              int j, int cap, int* red) {
  constexpr int R = tile::BM / TM;               // 8 row blocks
  __shared__ int row_all[R], row_before[R];
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (rb0 + i < nm && m[(size_t)(rb0 + i) * nn + j]) live |= 1u << i;
  if (live == 0 || cap >= nm * nn) return live;  // nothing to cut
  // rank of each live tile: live tiles of the rows above the block, of
  // the block's rows above its own, and of its own row left of column j
  const int base = tile::block_count(m, 0, rb0 * nn, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int all = 0, before = 0;                       // warp i: row rb0 + i
  for (int c0 = 0; c0 < nn; c0 += 32) {
    const int c = c0 + lane;
    const bool v = rb0 + warp < nm && c < nn &&
                   m[(size_t)(rb0 + warp) * nn + c];
    all += __popc(__ballot_sync(0xffffffffu, v));
    before += __popc(__ballot_sync(0xffffffffu, v && c < j));
  }
  if (lane == 0) row_all[warp] = all, row_before[warp] = before;
  __syncthreads();
  unsigned kept = 0;
  int run = base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (((live >> i) & 1u) && run + row_before[i] < cap) kept |= 1u << i;
    run += row_all[i];
  }
  return kept;
}

template <typename T>
__global__ void __launch_bounds__(tile::THREADS, 2)
gather_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ cap_live, T* __restrict__ out,
                     int* __restrict__ n_live_total,
                     int* __restrict__ n_computed, int M, int K, int N,
                     int capacity, int split, int kb_per) {
  using namespace tile;
  extern __shared__ __align__(128) char smem[];
  __shared__ int red[THREADS / 32];
  const int rank = blockIdx.x % split, j = blockIdx.x / split;
  const size_t ex = blockIdx.z;                 // expert
  const int nm = M / TM, nn = N / TN;
  x += ex * M * K;
  w += ex * K * N;
  out += ex * M * N;
  mask += ex * nm * nn;
  // the budget in force: capacity clamped by the calibrated cap_live
  const int cap = cap_live ? min(capacity, max(cap_live[ex], 1)) : capacity;
  if (blockIdx.x == 0 && blockIdx.y == 0) {     // the expert's counters
    const int total = block_count(mask, 0, nm * nn, red);
    if (threadIdx.x == 0) {
      n_live_total[ex] = total;
      n_computed[ex] = min(total, cap);
    }
  }
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const unsigned rows = kept_rows(mask, nm, nn, row0 / TM, j, cap, red);
  if (rows == 0) {                              // uniform per cluster
    zero_tile(out, M, N, row0, col0, rank, split);
    return;
  }
  using G = Geo<T>;
  const int s0 = rank * kb_per * G::STEPS;
  const int k1 = min(K, (rank + 1) * kb_per * KB);
  const int s1 = (k1 + G::BK - 1) / G::BK;
  const Operands<T> o{x, w, M, K, N, row0, col0};
  run_tile(smem, o, s0, s1, [rows](int) { return rows; }, out, rows, split);
}

}  // namespace mor

// E experts, each x (M, K), w (K, N), out (M, N) in `dtype`; mask (E,
// M/8, N/128) bytes, non-zero for a live tile; cap_live (E,) int32 or
// null; n_live_total and n_computed (E,) int32 outputs.  M % 8 == 0,
// N % 128 == 0, K a multiple of a 16-byte chunk (8 bf16, 4 float32).
// split blocks a cluster share a tile, each kb_per k blocks of 128 (the
// last ragged).
extern "C" int gather_matmul(const void* x, const void* w, const void* mask,
                             const int* cap_live, void* out,
                             int* n_live_total, int* n_computed, int E,
                             int M, int K, int N, int capacity, int split,
                             int kb_per, int dtype, void* stream) {
  using namespace mor;
  static unsigned long long ready[2] = {0, 0};
  const dim3 grid((N / TN) * split, (M + tile::BM - 1) / tile::BM, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m8 = static_cast<const unsigned char*>(mask);
  if (dtype == BF16) {
    using T = __nv_bfloat16;
    return tile::launch(gather_matmul_kernel<T>, ready[BF16], grid, split,
                        st, static_cast<const T*>(x),
                        static_cast<const T*>(w), m8, cap_live,
                        static_cast<T*>(out), n_live_total, n_computed, M, K,
                        N, capacity, split, kb_per);
  }
  if (dtype == F32) {
    return tile::launch(gather_matmul_kernel<float>, ready[F32], grid, split,
                        st, static_cast<const float*>(x),
                        static_cast<const float*>(w), m8, cap_live,
                        static_cast<float*>(out), n_live_total, n_computed,
                        M, K, N, capacity, split, kb_per);
  }
  return (int)cudaErrorInvalidValue;
}
