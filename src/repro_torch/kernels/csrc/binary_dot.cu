// The binary rookie's sign matmul for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/binary_dot.py
// `binary_dot` (pallas_call at l.50; wrapper repro/kernels/ops.py
// `binary_dot`, which pads to its blocks and adds the K padding back).
//   out[m, n] = sum_k sign_act(x[m, k]) * sign(w[k, n])    (float32)
// with sign_act(x) = +1 for x > 0 else -1 and sign(w) = +1 for w >= 0
// else -1.  The TPU kernel materialises int8 signs in VMEM and runs an
// int8 MXU product; here the signs are made in registers from 16-byte
// loads of x and w, stored as int8 in shared memory, and multiplied by
// the int8 tensor cores (mma.sync m16n8k32, int32 sums): sign_mma.cuh.
// This kernel takes any M, K, N: an index past K is 0, not a sign, so
// no padding and no K-pad compensation is needed.
//
// Bound on the H100: bytes.  The kernel must read the float x and w
// once for one sign each, against 2 M K N sign operations: about 250
// operations a byte at granite's gate with 256 rows and 32 at ResNet18's
// first conv layer (M = 131072, K = 576, N = 64), far below the int8
// ridge (1,979 TOP/s over 3.35 TB/s, about 590).  So the signs are made
// from 16-byte loads with packed compares (about 1.5 instructions an
// element), each block reads its x rows and w columns once, the re-reads
// across tiles come from L2, and where the tiles alone do not fill the
// card (a decode dispatch, Darknet19's 128-row layers) K is split over
// a cluster (the wrapper's plan).  What holds it back on the card: the
// re-reads through L2 (x once per 64-column tile) and one step of loads
// in flight per block (PERF.md).
#include "sign_mma.cuh"

namespace mor {

template <typename T, bool VEC>
int binary_dot_launch(const T* x, const T* w, float* out, int M, int K,
                      int N, int bm, int bn, int split, int kb_per,
                      cudaStream_t st) {
  using sgn::FloatSigns;
  using sgn::launch;
  if (bm == 16 && bn == 128)
    return launch<T, 16, 128, 1, VEC, FloatSigns<T, 128, VEC>>(
        x, w, out, M, K, N, split, kb_per, st);
  if (bm == 64 && bn == 64)
    return launch<T, 64, 64, 4, VEC, FloatSigns<T, 64, VEC>>(
        x, w, out, M, K, N, split, kb_per, st);
  if (bm == 128 && bn == 64)
    return launch<T, 128, 64, 4, VEC, FloatSigns<T, 64, VEC>>(
        x, w, out, M, K, N, split, kb_per, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int binary_dot_typed(const void* x, const void* w, float* out, int M, int K,
                     int N, int bm, int bn, int split, int kb_per,
                     cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  constexpr int EPC = sgn::Geo<T>::EPC;
  const bool vec = K % EPC == 0 && N % EPC == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? binary_dot_launch<T, true>(xt, wt, out, M, K, N, bm, bn,
                                          split, kb_per, st)
             : binary_dot_launch<T, false>(xt, wt, out, M, K, N, bm, bn,
                                           split, kb_per, st);
}

}  // namespace mor

// x (M, K), w (K, N) in `dtype`, contiguous; out (M, N) float32.  Any
// M, K, N.  The tile is bm x bn (16 x 128, 64 x 64 or 128 x 64, as
// binary_dot.plan chooses), and split blocks a cluster share one, each
// kb_per 128-wide k blocks.
extern "C" int binary_dot(const void* x, const void* w, float* out, int M,
                          int K, int N, int bm, int bn, int split,
                          int kb_per, int dtype, void* stream) {
  using namespace mor;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return binary_dot_typed<__nv_bfloat16>(x, w, out, M, K, N, bm, bn,
                                           split, kb_per, st);
  if (dtype == F32)
    return binary_dot_typed<float>(x, w, out, M, K, N, bm, bn, split,
                                   kb_per, st);
  return (int)cudaErrorInvalidValue;
}
