// The binary rookie's sign matmul from bit-packed weight signs, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/binary_dot_packed.py
// `binary_dot_packed` (pallas_call at l.82).  The weight arrives as the
// JAX package's `pack_signs` layout: w_packed (K/8, N) uint8, bit b of
// byte [k8, n] the sign (1 = negative) of w[8 * k8 + b, n].
//   out[m, n] = sum_k sign_act(x[m, k]) * unpack(w_packed)[k, n]  (float32)
// with sign_act(x) = +1 for x > 0 else -1: binary_dot's product, bit for
// bit, on the same operands.  The TPU kernel unpacks in registers to
// +-1 int8 for the MXU; here it is binary_dot's kernel (sign_mma.cuh:
// x's signs from 16-byte loads with packed compares, int8 mma.sync
// m16n8k32, split-K over a cluster) with the weight stage swapped
// (PackedSigns): a packed byte [k8, n] holds exactly 8 consecutive k of
// column n, so it expands, by one multiply and mask a nibble, to the
// 8-byte word of int8 signs that the stage holds at column n's row.
//
// Bound on the H100: bytes.  The packed weight is K N / 8 bytes, 16x
// fewer than a bf16 weight read for its signs, so x (M K floats, read
// once for one sign each) and the float32 output dominate from a few
// dozen rows on, against 2 M K N sign operations far below the int8
// ridge.  With a 16x smaller weight stage the column tile widens to 128
// (binary_dot's is 64) wherever 64 x 128 tiles fit one wave of two
// blocks an SM, so x's signs are made, and x re-read through L2, once
// per 128 columns; elsewhere (N <= 64, as ResNet18's first layers,
// where x's 302 MB of im2col rows set the time, or tiles past a wave)
// it takes binary_dot's tiles.  A 128 x 128 tile holds one block an SM
// (its registers) and lost to both at every main-path shape.  The tile
// and split are `binary_dot.plan(..., packed=True)`.
#include "sign_mma.cuh"

namespace mor {

template <typename T>
int binary_dot_packed_launch(const T* x, const uint8_t* wp, float* out,
                             int M, int K, int N, int bm, int bn, int split,
                             int kb_per, cudaStream_t st) {
  using sgn::launch;
  using sgn::PackedSigns;
  if (bm == 16 && bn == 128)
    return launch<T, 16, 128, 1, true, PackedSigns<T, 128>>(
        x, wp, out, M, K, N, split, kb_per, st);
  if (bm == 64 && bn == 64)
    return launch<T, 64, 64, 4, true, PackedSigns<T, 64>>(
        x, wp, out, M, K, N, split, kb_per, st);
  if (bm == 128 && bn == 64)
    return launch<T, 128, 64, 4, true, PackedSigns<T, 64>>(
        x, wp, out, M, K, N, split, kb_per, st);
  if (bm == 64 && bn == 128)
    return launch<T, 64, 128, 2, true, PackedSigns<T, 128>>(
        x, wp, out, M, K, N, split, kb_per, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mor

// x (M, K) in `dtype`, contiguous and 16-byte aligned; w_packed (K/8, N)
// uint8 and out (M, N) float32, contiguous.  K % 8 == 0 (so x's rows are
// whole 16-byte chunks); any M, N.  The tile is bm x bn (16 x 128, 64 or
// 128 x 64, 64 x 128, as binary_dot.plan chooses with packed=True), and
// split blocks a cluster share one, each kb_per 128-wide k blocks.
extern "C" int binary_dot_packed(const void* x, const uint8_t* wp,
                                 float* out, int M, int K, int N, int bm,
                                 int bn, int split, int kb_per, int dtype,
                                 void* stream) {
  using namespace mor;
  if (M == 0 || N == 0) return 0;
  if (K % 8 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return binary_dot_packed_launch(static_cast<const __nv_bfloat16*>(x), wp,
                                    out, M, K, N, bm, bn, split, kb_per, st);
  if (dtype == F32)
    return binary_dot_packed_launch(static_cast<const float*>(x), wp, out,
                                    M, K, N, bm, bn, split, kb_per, st);
  return (int)cudaErrorInvalidValue;
}
