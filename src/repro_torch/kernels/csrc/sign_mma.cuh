// The binary rookie's sign product on the int8 tensor cores (sm_90a):
//   out[m, n] = sum_k sign_act(x[m, k]) * sign(w[k, n])    (float32)
// with sign_act(x) = +1 for x > 0 else -1 (a post-ReLU zero and a NaN
// are -1) and sign(w) = +1 for w >= 0 else -1 (-0.0 is +1, NaN is -1:
// the comparison, not the sign bit).  A contraction index at or past K
// is 0 on both sides, so a ragged tail adds nothing.  The sums are
// integers, exact in any order, so the result is bit-equal to a float32
// product of +-1 matrices while K < 2^24.
//
// Geometry.  A block is 256 threads (8 warps, WM x WN) and owns a BM x
// BN output tile.  The contraction streams in steps of BK elements (128
// bytes of a row: 64 bf16, 32 float32) through two shared-memory
// stages of int8 signs: A (x) as BM rows of BK signs, B (w) transposed,
// BN rows (columns of w) of BK signs, both K-contiguous, rows LDS = BK
// + 16 bytes apart (an odd count of 16-byte chunks, so the 8 rows an
// ldmatrix phase reads fall in 8 distinct bank groups).  Each step:
//   - every thread has 16-byte loads of the step in registers (x: one
//     chunk of EPC elements of a row, neighbouring lanes on neighbouring
//     chunks of a row, so that a warp reads whole 128-byte lines), turns
//     them into signs and stores them: an x chunk as EPC bytes of its
//     row.  Whole chunks (VEC) convert with packed compares
//     (set.u32.bf16x2 or .f32: 0xFFFF.. where true) and byte permutes,
//     about 1.5 instructions an element.  The weight stage is a policy
//     (WL): FloatSigns makes w's signs the same way (a group of 4 k rows
//     x one chunk of EPC columns becomes one 32-bit word of 4 signs per
//     column), PackedSigns expands bit-packed signs (one byte holds 8
//     consecutive k of a column: one 8-byte word per column);
//   - the block synchronises, issues the next step's loads (they fly
//     while it multiplies), and each warp runs ldmatrix.x4 and
//     mma.sync.m16n8k32.s8.s8.s32 over its (BM / WM) x (BN / WN) part.
// One barrier a step: the stage written at step s was last read at
// step s - 2, before every warp passed step s - 1's barrier.
//
// Split-K.  A cluster of `split` blocks (at most 8) shares a tile, rank
// r summing whole 128-wide k blocks [r kb_per, (r + 1) kb_per).  Each
// writes its int32 partial tile into its own shared memory, and rank r
// sums its share of the tile from ranks 0 .. split-1 in that order
// through distributed shared memory (exact integers either way).
// split = 1 stores straight from the accumulators.
//
// VEC: K and N are multiples of a 16-byte chunk and both operands are
// 16-byte aligned, so a chunk is wholly in or out and loads are 16
// bytes; otherwise each element is loaded alone and checked against K
// and N (the same signs, slower).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace mor {
namespace sgn {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int KB = 128;             // split-K granularity (k indices)

template <typename T> struct Geo {
  static constexpr int EPC = 16 / sizeof(T);     // elements a chunk
  static constexpr int BK = 128 / sizeof(T);     // 64 bf16, 32 float
  static constexpr int CPR = BK / EPC;           // chunks a row a step: 8
  static constexpr int LDS = BK + 16;            // int8 row stride
  static constexpr int KQ = BK / 4;              // 4-row weight groups
};

__device__ __forceinline__ uint32_t act_sign(float v) {
  return v > 0.f ? 0x01u : 0xFFu;
}
__device__ __forceinline__ uint32_t wgt_sign(float v) {
  return v >= 0.f ? 0x01u : 0xFFu;
}

// element e of a 16-byte chunk, as float
__device__ __forceinline__ float elem(const uint4& u, int e, const float*) {
  const uint32_t v = e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
  return __uint_as_float(v);
}
__device__ __forceinline__ float elem(const uint4& u, int e,
                                      const __nv_bfloat16*) {
  const int q = e >> 1;
  const uint32_t v = q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (v & 0xFFFF0000u) : (v << 16));
}

__device__ __forceinline__ uint32_t raw_bits(const float* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t raw_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// The chunk at p, its elements e < nv (the rest read nothing, and their
// signs are 0 by nv again at the store).
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* p, int nv) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (nv > 0) u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int EPC = Geo<T>::EPC, BITS = 8 * sizeof(T);
    constexpr int PER = 32 / BITS;
    uint32_t h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < EPC; ++e)
      if (e < nv) h[e / PER] |= raw_bits(p + e) << (BITS * (e % PER));
    u = make_uint4(h[0], h[1], h[2], h[3]);
  }
  return u;
}

// Packed compares: 0xFFFF in each 16-bit half (bf16x2) or 0xFFFFFFFF
// (f32) where the element is > 0 (act) / >= 0 (wgt); a NaN compares
// false, -0.0 >= 0 is true.
__device__ __forceinline__ uint32_t act_mask(uint32_t v,
                                             const __nv_bfloat16*) {
  uint32_t m;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(v), "r"(0u));
  return m;
}
__device__ __forceinline__ uint32_t wgt_mask(uint32_t v,
                                             const __nv_bfloat16*) {
  uint32_t m;
  asm("set.ge.u32.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(v), "r"(0u));
  return m;
}
__device__ __forceinline__ uint32_t act_mask(uint32_t v, const float*) {
  uint32_t m;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(__uint_as_float(v)),
      "f"(0.f));
  return m;
}
__device__ __forceinline__ uint32_t wgt_mask(uint32_t v, const float*) {
  uint32_t m;
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(__uint_as_float(v)),
      "f"(0.f));
  return m;
}
// mask bytes (0xFF true, 0x00 false) -> sign bytes +1 (0x01) / -1 (0xFF)
__device__ __forceinline__ uint32_t mask_signs(uint32_t m) {
  return (~m & 0xFEFEFEFEu) | 0x01010101u;
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  return __byte_perm(a, b, sel);
}
__device__ __forceinline__ uint32_t word_of(const uint4& u, int c) {
  return c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w;
}

// An x chunk's EPC sign bytes at dst (elements e >= nv are 0).
template <typename T, bool VEC>
__device__ __forceinline__ void store_act(unsigned char* dst, const uint4& u,
                                          int nv) {
  constexpr int EPC = Geo<T>::EPC;
  const T* tag = nullptr;
  uint32_t s[2] = {0u, 0u};
  if (VEC) {                    // nv is 0 or EPC
    if (EPC == 8) {             // mask bytes 0 and 2 of each word
      s[0] = mask_signs(prmt(act_mask(u.x, tag), act_mask(u.y, tag),
                             0x6420));
      s[1] = mask_signs(prmt(act_mask(u.z, tag), act_mask(u.w, tag),
                             0x6420));
    } else {
      const uint32_t lo = prmt(act_mask(u.x, tag), act_mask(u.y, tag),
                               0x0040);
      const uint32_t hi = prmt(act_mask(u.z, tag), act_mask(u.w, tag),
                               0x0040);
      s[0] = mask_signs(prmt(lo, hi, 0x5410));
    }
    if (nv == 0) s[0] = s[1] = 0u;
  } else {
#pragma unroll
    for (int e = 0; e < EPC; ++e)
      if (e < nv)
        s[e / 4] |= act_sign(elem(u, e, tag)) << (8 * (e % 4));
  }
  if (EPC == 4)
    *reinterpret_cast<uint32_t*>(dst) = s[0];
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(s[0], s[1]);
}

// A weight group (4 k rows of one chunk) as one 32-bit word of 4 signs
// per column: column e at dst + e LDS (rows i >= kv and columns e >= nc
// are 0).
template <typename T, bool VEC>
__device__ __forceinline__ void store_wgt(unsigned char* dst,
                                          const uint4 (&u)[4], int kv,
                                          int nc) {
  constexpr int EPC = Geo<T>::EPC, LDS = Geo<T>::LDS;
  const T* tag = nullptr;
  uint32_t col[EPC];
  if (VEC) {                    // kv is 0 or 4, nc 0 or EPC
    const bool in = kv > 0 && nc > 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = wgt_mask(word_of(u[i], c), tag);
      if (EPC == 8) {           // word c holds columns 2c and 2c + 1
        const uint32_t t01 = prmt(m[0], m[1], 0x6240);
        const uint32_t t23 = prmt(m[2], m[3], 0x6240);
        col[2 * c] = in ? mask_signs(prmt(t01, t23, 0x5410)) : 0u;
        col[2 * c + 1] = in ? mask_signs(prmt(t01, t23, 0x7632)) : 0u;
      } else {                  // word c is column c
        const uint32_t t01 = prmt(m[0], m[1], 0x0040);
        const uint32_t t23 = prmt(m[2], m[3], 0x0040);
        col[c] = in ? mask_signs(prmt(t01, t23, 0x5410)) : 0u;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      col[e] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < kv && e < nc)
          col[e] |= wgt_sign(elem(u[i], e, tag)) << (8 * i);
    }
  }
#pragma unroll
  for (int e = 0; e < EPC; ++e)
    *reinterpret_cast<uint32_t*>(dst + e * LDS) = col[e];
}

// The weight stage of float w (K, N): a step's BK rows x BN columns,
// loaded as groups of 4 k rows x one chunk of EPC columns (neighbouring
// lanes on neighbouring chunks of a row), stored as one 32-bit word of 4
// signs per column at sB + column LDS + 4 kq.
template <typename T, int BN, bool VEC> struct FloatSigns {
  using Src = T;
  static constexpr int EPC = Geo<T>::EPC;
  static constexpr int GROUPS = Geo<T>::KQ * (BN / EPC);
  static constexpr int PER = (GROUPS + THREADS - 1) / THREADS;
  struct Regs { uint4 q[PER][4]; };

  // group i of this thread: 4 rows from k 4 kq, columns cc EPC.., kv
  // rows and nc columns valid
  __device__ static void group(int i, int K, int N, int k0, int col0,
                               int& kq, int& cc, int& kv, int& nc) {
    const int idx = threadIdx.x + i * THREADS;
    cc = idx % (BN / EPC);
    kq = idx / (BN / EPC);
    const int gc = col0 + cc * EPC;
    const bool in = idx < GROUPS;
    kv = in ? max(0, min(4, K - (k0 + 4 * kq))) : 0;
    nc = in ? max(0, min(EPC, N - gc)) : 0;
  }
  __device__ static void load(Regs& r, const T* w, int K, int N, int k0,
                              int col0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int kq, cc, kv, nc;
      group(i, K, N, k0, col0, kq, cc, kv, nc);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r.q[i][q] = load_chunk<T, VEC>(
            w + (size_t)(k0 + 4 * kq + q) * N + col0 + cc * EPC,
            q < kv ? nc : 0);
    }
  }
  __device__ static void store(const Regs& r, unsigned char* sB, int K,
                               int N, int k0, int col0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int kq, cc, kv, nc;
      group(i, K, N, k0, col0, kq, cc, kv, nc);
      if (threadIdx.x + i * THREADS < GROUPS)
        store_wgt<T, VEC>(sB + cc * EPC * Geo<T>::LDS + 4 * kq, r.q[i], kv,
                          nc);
    }
  }
};

// Bits b of a packed byte (1 = negative) -> bytes b of 8 signs, +1
// (0x01) or -1 (0xFF): each nibble spread to the low bits of 4 bytes by
// one multiply and mask, then 0 -> 0x01 and 1 -> 0xFF.
__device__ __forceinline__ uint2 spread_signs(uint32_t byte) {
  const uint32_t lo = ((byte & 0xFu) * 0x00204081u) & 0x01010101u;
  const uint32_t hi = ((byte >> 4) * 0x00204081u) & 0x01010101u;
  return make_uint2(lo * 0xFEu | 0x01010101u, hi * 0xFEu | 0x01010101u);
}

// The weight stage of bit-packed signs wp (K / 8, N) uint8, the JAX
// package's layout (bit b of byte [k8, n] the sign of row 8 k8 + b): a
// step's BK / 8 packed rows x BN columns, loaded as 16 neighbouring
// columns of one packed row (16 bytes where N % 16 == 0 and wp is
// aligned, byte by byte otherwise; lanes down the rows, so that a
// warp's stores spread over the banks and its loads still fill whole
// sectors), each byte stored as the 8-byte word of its column's 8 k at
// sB + column LDS + 8 r.  Rows past K / 8 and columns past N are 0
// signs.
template <typename T, int BN> struct PackedSigns {
  using Src = uint8_t;
  static constexpr int ROWS = Geo<T>::BK / 8;    // packed rows a step
  static constexpr int GROUPS = ROWS * (BN / 16);
  static constexpr int PER = (GROUPS + THREADS - 1) / THREADS;
  struct Regs { uint4 q[PER]; };

  __device__ static void load(Regs& r, const uint8_t* wp, int K, int N,
                              int k0, int col0) {
    const bool vec = N % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(wp) % 16 == 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int k8 = k0 / 8 + idx % ROWS, gc = col0 + (idx / ROWS) * 16;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (idx < GROUPS && k8 < K / 8 && gc < N) {
        const uint8_t* p = wp + (size_t)k8 * N + gc;
        if (vec) {
          u = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint32_t h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (gc + e < N)
              h[e / 4] |= (uint32_t)__ldg(p + e) << (8 * (e % 4));
          u = make_uint4(h[0], h[1], h[2], h[3]);
        }
      }
      r.q[i] = u;
    }
  }
  __device__ static void store(const Regs& r, unsigned char* sB, int K,
                               int N, int k0, int col0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx >= GROUPS) continue;
      const int row = idx % ROWS, c0 = (idx / ROWS) * 16;
      const bool in = k0 / 8 + row < K / 8;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t byte = (word_of(r.q[i], e / 4) >> (8 * (e % 4))) &
                              0xFFu;
        const uint2 v = in && col0 + c0 + e < N ? spread_signs(byte)
                                                : make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(sB + (c0 + e) * Geo<T>::LDS + 8 * row) = v;
      }
    }
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 32, row) b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Store v[0 .. W) as float at out[r, c ..] (columns < N; rows < M).
template <int W>
__device__ __forceinline__ void put(float* out, int M, int N, int r, int c,
                                    const int* v) {
  if (r >= M) return;
  float* p = out + (size_t)r * N + c;
  if (c + W <= N && N % W == 0) {
    if (W == 2)
      *reinterpret_cast<float2*>(p) = make_float2((float)v[0], (float)v[1]);
    else
      *reinterpret_cast<float4*>(p) = make_float4(
          (float)v[0], (float)v[1], (float)v[2], (float)v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (c + e < N) p[e] = (float)v[e];
  }
}

template <typename T, int BM, int BN> struct Smem {
  static constexpr int A_BYTES = BM * Geo<T>::LDS;
  static constexpr int STAGE = (BM + BN) * Geo<T>::LDS;
  static constexpr int RING = 2 * STAGE;
  static constexpr int LDT = BN + 4;             // int32 partial tile
  static constexpr int TILE = BM * LDT * 4;
  static constexpr int MAX = RING > TILE ? RING : TILE;
};

// One block's part of a BM x BN tile (8 warps, WM x WN, each a WTM x
// WTN warp tile): the sign product over the contraction [kbeg, kend)
// into int32 accumulators, and their int32 tile in shared memory.
// sign_mma_kernel below stores it as float32; mor_predict.cu folds it
// into a tile mask.
template <typename T, int BM, int BN, int WM, bool VEC, typename WL>
struct SignTile {
  using G = Geo<T>;
  using S = Smem<T, BM, BN>;
  static constexpr int WN = 8 / WM, WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WM * WN == 8 && MI >= 1 && NI % 2 == 0, "warp tile");
  static constexpr int XCH = BM * G::CPR;             // x chunks a step
  static constexpr int XPT = (XCH + THREADS - 1) / THREADS;

  // acc += sign_act(x) sign(w) over rows row0.., columns col0.. and k in
  // [kbeg, kend), through the two stages at `smem` (S::RING bytes)
  __device__ static void product(const T* __restrict__ x,
                                 const typename WL::Src* __restrict__ w,
                                 int M, int K, int N, int row0, int col0,
                                 int kbeg, int kend, unsigned char* smem,
                                 int (&acc)[MI][NI][4]) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const int steps = kend > kbeg ? (kend - kbeg + G::BK - 1) / G::BK : 0;
    uint4 xr[XPT];
    typename WL::Regs wr;
    // x chunk i of this thread at step k0: row r, chunk ch, nv valid
    auto xchunk = [&](int i, int k0, int& r, int& ch, int& nv) {
      const int idx = t + i * THREADS;
      r = idx / G::CPR;
      ch = idx % G::CPR;
      const int gk = k0 + ch * G::EPC;
      nv = (idx < XCH && row0 + r < M) ? max(0, min(G::EPC, K - gk)) : 0;
    };
    auto load = [&](uint4 (&xq)[XPT], typename WL::Regs& wq, int k0) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        int r, ch, nv;
        xchunk(i, k0, r, ch, nv);
        xq[i] = load_chunk<T, VEC>(
            x + (size_t)(row0 + r) * K + k0 + ch * G::EPC, nv);
      }
      WL::load(wq, w, K, N, k0, col0);
    };
    auto store = [&](const uint4 (&xq)[XPT], const typename WL::Regs& wq,
                     unsigned char* sA, unsigned char* sB, int k0) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        int r, ch, nv;
        xchunk(i, k0, r, ch, nv);
        if (t + i * THREADS < XCH)
          store_act<T, VEC>(sA + r * G::LDS + ch * G::EPC, xq[i], nv);
      }
      WL::store(wq, sB, K, N, k0, col0);
    };
    auto compute = [&](const unsigned char* sA, const unsigned char* sB) {
#pragma unroll
      for (int ks = 0; ks < G::BK; ks += 32) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi], sA + (wm * WTM + mi * 16 + (lane & 15)) * G::LDS +
                             ks + (lane >> 4) * 16);
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, sB + (wn * WTN + np * 16 + (lane >> 4) * 8 +
                           (lane & 7)) * G::LDS +
                         ks + ((lane >> 3) & 1) * 16);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    };

    if (steps > 0) load(xr, wr, kbeg);
    for (int s = 0; s < steps; ++s) {
      unsigned char* sA = smem + (s & 1) * S::STAGE;
      unsigned char* sB = sA + S::A_BYTES;
      store(xr, wr, sA, sB, kbeg + s * G::BK);
      __syncthreads();
      if (s + 1 < steps) load(xr, wr, kbeg + (s + 1) * G::BK);
      compute(sA, sB);
    }
  }

  // accumulator (mi, ni, e) of this thread: tile row r, column c
  __device__ static void coords(int mi, int ni, int& r, int& c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    r = (warp % WM) * WTM + mi * 16 + (lane >> 2);
    c = (warp / WM) * WTN + ni * 8 + (lane & 3) * 2;
  }

  // the accumulators as the int32 tile at `tile` (BM rows S::LDT apart);
  // the caller has freed the stages it overlays
  __device__ static void to_tile(const int (&acc)[MI][NI][4], int* tile) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        int r, c;
        coords(mi, ni, r, c);
        *reinterpret_cast<int2*>(tile + r * S::LDT + c) =
            make_int2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<int2*>(tile + (r + 8) * S::LDT + c) =
            make_int2(acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
};

template <typename T, int BM, int BN, int WM, bool VEC, typename WL>
__global__ void __launch_bounds__(THREADS)
sign_mma_kernel(const T* __restrict__ x,
                const typename WL::Src* __restrict__ w,
                float* __restrict__ out, int M, int K, int N, int split,
                int kb_per) {
  using Tile = SignTile<T, BM, BN, WM, VEC, WL>;
  using S = Smem<T, BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int rank = blockIdx.x % split, j = blockIdx.x / split;
  const int row0 = blockIdx.y * BM, col0 = j * BN;
  const int kbeg = rank * kb_per * KB;
  const int kend = min(K, (rank + 1) * kb_per * KB);
  int acc[Tile::MI][Tile::NI][4] = {};
  Tile::product(x, w, M, K, N, row0, col0, kbeg, kend, smem, acc);

  if (split == 1) {
#pragma unroll
    for (int mi = 0; mi < Tile::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < Tile::NI; ++ni) {
        int r, c;
        Tile::coords(mi, ni, r, c);
        put<2>(out, M, N, row0 + r, col0 + c, acc[mi][ni]);
        put<2>(out, M, N, row0 + r + 8, col0 + c, acc[mi][ni] + 2);
      }
    return;
  }
  __syncthreads();                         // the ring is free
  int* tile = reinterpret_cast<int*>(smem);
  Tile::to_tile(acc, tile);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                          // every partial is in place
  constexpr int n4 = BM * BN / 4;
  const int per = (n4 + split - 1) / split;
  const int q0 = min(n4, rank * per), q1 = min(n4, q0 + per);
  for (int q = q0 + t; q < q1; q += THREADS) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    if (row0 + r >= M || col0 + c >= N) continue;
    int v[4] = {0, 0, 0, 0};
    for (int p = 0; p < split; ++p) {      // fixed order
      const int4 u = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(tile, p) + r * S::LDT + c);
      v[0] += u.x; v[1] += u.y; v[2] += u.z; v[3] += u.w;
    }
    put<4>(out, M, N, row0 + r, col0 + c, v);
  }
  cluster.sync();                          // no block leaves while read
}

// Launch one instantiation on a (ceil(N / BN) split) x ceil(M / BM)
// grid of clusters of `split`; the partial tile's shared memory only
// where split > 1.
template <typename T, int BM, int BN, int WM, bool VEC, typename WL>
int launch(const T* x, const typename WL::Src* w, float* out, int M, int K,
           int N, int split, int kb_per, cudaStream_t st) {
  using S = Smem<T, BM, BN>;
  static_assert(THREADS == 256, "launch_cluster's block");
  static unsigned long long ready = 0;   // one an instantiation
  const int rows = (M + BM - 1) / BM;
  if (rows > 65535 || split < 1 || split > 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(((N + BN - 1) / BN) * split, rows);
  return launch_cluster(sign_mma_kernel<T, BM, BN, WM, VEC, WL>, ready,
                        S::MAX, grid, split, split > 1 ? S::MAX : S::RING, st,
                        x, w, out, M, K, N, split, kb_per);
}

}  // namespace sgn
}  // namespace mor
