// The binary rookie's sign matmul for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/binary_dot.py
// `binary_dot` (pallas_call at l.50; wrapper repro/kernels/ops.py
// `binary_dot`, which pads and adds the K padding back).
//   out[m, n] = sum_k sign_act(x[m, k]) * sign(w[k, n])    (float32)
// with sign_act(x) = +1 for x > 0 else -1 and sign(w) = +1 for w >= 0
// else -1.  The TPU kernel materialises int8 signs and runs an int8 MXU
// product; here the signs become bits and the product XNOR-popcount
// (binary.cuh): the weight's signs are taken from its float values in
// the kernel, 32 per word.
//
// Bound on the H100: bytes.  The kernel must read the float weight (K x
// N, 2 or 4 bytes an element) for one bit each, against 2 * M * K * N
// sign operations, which at the rows of a conv layer's im2col (a few
// thousand) or a decode dispatch (8) sit far below the card's int8 rate
// (1,979 TOP/s).  The design reads each weight element once per block
// row (TMR rows share it) with warp-coalesced loads and keeps the x
// signs in shared memory as bits (32x fewer bytes than the float x).
// Reading only the signs of a bf16 weight is what the packed form
// (binary_dot_packed.cu) cuts 16x.
#include "binary.cuh"

namespace mor {

template <typename T>
struct FloatSignLoader {
  const T* w;
  int K, N;
  // bits (1 = negative) of rows 32 * kw ... 32 * kw + 31 of column col
  __device__ __forceinline__ uint32_t word(int col, int kw) const {
    if (col >= N) return 0u;
    uint32_t bits = 0u;
    const int k0 = kw * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int k = k0 + i;
      if (k < K && !(to_f(w[(size_t)k * N + col]) >= 0.f)) bits |= 1u << i;
    }
    return bits;
  }
};

}  // namespace mor

// x (M, K), w (K, N) in `dtype`, contiguous; out (M, N) float32.  Any
// M, K, N.
extern "C" int binary_dot(const void* x, const void* w, float* out, int M,
                          int K, int N, int dtype, void* stream) {
  using namespace mor;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    const FloatSignLoader<__nv_bfloat16> wl{
        static_cast<const __nv_bfloat16*>(w), K, N};
    return launch_binary_dot(static_cast<const __nv_bfloat16*>(x), wl, out,
                             M, K, N, st);
  }
  if (dtype == F32) {
    const FloatSignLoader<float> wl{static_cast<const float*>(w), K, N};
    return launch_binary_dot(static_cast<const float*>(x), wl, out, M, K,
                             N, st);
  }
  return (int)cudaErrorInvalidValue;
}
