// The binary rookie's sign matmul from bit-packed weight signs, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/binary_dot_packed.py
// `binary_dot_packed` (pallas_call at l.82).  The weight arrives as the
// JAX package's `pack_signs` layout: w_packed (K/8, N) uint8, bit b of
// byte [k8, n] the sign (1 = negative) of w[8 * k8 + b, n].  The TPU
// kernel unpacks in registers to +-1 int8 for the MXU; here the four
// bytes [4 * kw .. 4 * kw + 3, n] of one column (strided by N, so the
// layout is read as it is, with no transposed copy) are one 32-bit word
// whose bit i is the sign of row 32 * kw + i, which is how the x signs
// are packed too: the product is XNOR-popcount (binary.cuh).
//
// Bound on the H100: bytes.  The packed weight is K * N / 8 bytes, 16x
// fewer than a bf16 weight read for its signs; x (M x K floats) is read
// once per 32-column block, and the output is M x N float32.  Against
// 2 * M * K * N sign operations the card's int8 rate is far away at
// these row counts.  The design reads each weight byte once per block
// row with warp-coalesced byte loads (32 neighbouring columns).
#include "binary.cuh"

namespace mor {

struct PackedSignLoader {
  const uint8_t* wp;
  int K8, N;
  __device__ __forceinline__ uint32_t word(int col, int kw) const {
    if (col >= N) return 0u;
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k8 = kw * 4 + j;
      if (k8 < K8) bits |= (uint32_t)wp[(size_t)k8 * N + col] << (8 * j);
    }
    return bits;
  }
};

}  // namespace mor

// x (M, K) in `dtype`; w_packed (K/8, N) uint8; out (M, N) float32; all
// contiguous.  K % 8 == 0 (the wrapper checks); any M, N.
extern "C" int binary_dot_packed(const void* x, const uint8_t* wp,
                                 float* out, int M, int K, int N, int dtype,
                                 void* stream) {
  using namespace mor;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PackedSignLoader wl{wp, K / 8, N};
  if (dtype == BF16)
    return launch_binary_dot(static_cast<const __nv_bfloat16*>(x), wl, out,
                             M, K, N, st);
  if (dtype == F32)
    return launch_binary_dot(static_cast<const float*>(x), wl, out, M, K, N,
                             st);
  return (int)cudaErrorInvalidValue;
}
