// The binary rookie's sign product as XNOR-popcount (sm_90a), shared by
// binary_dot.cu (float weights, signs taken in the kernel) and
// binary_dot_packed.cu (1-bit signs packed 8 per byte).
//
// Signs are bits, 1 = negative: an activation x is +1 when x > 0, else
// -1 (a post-ReLU zero is informative); a weight w is +1 when w >= 0.
// For 32 contraction indices packed into one word each,
//   sum_k s_x[k] * s_w[k] = 32 - 2 * popc(xbits ^ wbits),
// so a row-column dot is K - 2 * (the popcounts summed over its words),
// with every index past K given bit 0 on both sides (it adds nothing).
// The sum is an integer, exact in any order, and written as float32.
//
// A block covers TMR rows x 32 columns (one warp wide) with KL warps,
// warp q taking the contraction words q, q + KL, ...; the TMR rows' x
// signs are packed by warp ballots into shared memory, one chunk of
// BCW words (2048 indices) at a time, and each thread builds its
// column's weight word with the Loader (32 strided loads, coalesced
// across the warp's 32 neighbouring columns).  The KL partial counts of
// each output meet by shared-memory integer atomics (exact, so the
// order does not matter).
#pragma once

#include "common.cuh"

namespace mor {

constexpr int BCOLS = 32;   // columns per block (one warp wide)
constexpr int KL = 8;       // warps per block, splitting the k words
constexpr int BCW = 64;     // k words (of 32) staged per chunk

template <int TMR, typename T, typename Loader>
__global__ void __launch_bounds__(BCOLS * KL)
binary_dot_kernel(const T* __restrict__ x, Loader wl,
                  float* __restrict__ out, int M, int K, int N) {
  __shared__ uint32_t xb[TMR][BCW];
  __shared__ int red[TMR][BCOLS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * BCOLS + lane;
  const int row0 = blockIdx.x * TMR;
  const int col = blockIdx.y * BCOLS + lane;
  const int nw = (K + 31) / 32;
  for (int e = tid; e < TMR * BCOLS; e += BCOLS * KL)
    red[e / BCOLS][e % BCOLS] = 0;
  __syncthreads();

  int acc[TMR];
#pragma unroll
  for (int r = 0; r < TMR; ++r) acc[r] = 0;

  for (int c0 = 0; c0 < nw; c0 += BCW) {
    const int cw = min(BCW, nw - c0);
    // pack the activation signs: one ballot per (row, word)
    for (int p = warp; p < TMR * cw; p += KL) {
      const int r = p / cw, j = p % cw;
      const int row = row0 + r, k = (c0 + j) * 32 + lane;
      const bool neg = row < M && k < K &&
                       !(to_f(x[(size_t)row * K + k]) > 0.f);
      const uint32_t word = __ballot_sync(0xffffffffu, neg);
      if (lane == 0) xb[r][j] = word;
    }
    __syncthreads();
    for (int j = warp; j < cw; j += KL) {
      const uint32_t ww = wl.word(col, c0 + j);
#pragma unroll
      for (int r = 0; r < TMR; ++r) acc[r] += __popc(xb[r][j] ^ ww);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TMR; ++r) atomicAdd(&red[r][lane], acc[r]);
  __syncthreads();
  for (int e = tid; e < TMR * BCOLS; e += BCOLS * KL) {
    const int r = e / BCOLS, c = blockIdx.y * BCOLS + e % BCOLS;
    if (row0 + r < M && c < N)
      out[(size_t)(row0 + r) * N + c] = (float)(K - 2 * red[r][e % BCOLS]);
  }
}

// Launch with TMR = 8 rows a block for M <= 8 (a decode dispatch), else
// 32.  Returns cudaGetLastError().
template <typename T, typename Loader>
int launch_binary_dot(const T* x, Loader wl, float* out, int M, int K,
                      int N, cudaStream_t st) {
  const dim3 block(BCOLS, KL);
  if (M <= 8) {
    const dim3 grid((M + 7) / 8, (N + BCOLS - 1) / BCOLS);
    binary_dot_kernel<8, T, Loader><<<grid, block, 0, st>>>(x, wl, out, M,
                                                            K, N);
  } else {
    const dim3 grid((M + 31) / 32, (N + BCOLS - 1) / BCOLS);
    binary_dot_kernel<32, T, Loader><<<grid, block, 0, st>>>(x, wl, out, M,
                                                             K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace mor
