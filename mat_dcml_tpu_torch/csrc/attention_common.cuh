// Pieces shared by attention_fwd.cu and attention_bwd.cu: strided operands,
// cp.async staging into shared memory, and warp-level tensor-core products
// (mma.sync) for the two element types.
//
// Products.  Every L x L x Dh product of the two kernels is a sum of
// m16n8 tiles computed by one warp with mma.sync:
//   - bf16 inputs: m16n8k16 bf16 with f32 accumulate (the products of bf16
//     values are exact in f32, as in the plain version's f32 matmul of
//     upcast inputs); fragments come from shared memory by ldmatrix (x4: a
//     whole A tile, or the B fragments of two 8-wide tiles, in one
//     instruction; .trans where the operand lies transposed, as V does in
//     P.V);
//   - f32 inputs: 3xTF32 on m16n8k8.  Each value is split as a = big + small
//     with big = tf32(a) and small = tf32(a - big) (Mma<float>::split); a
//     product keeps
//     small*big + big*small + big*big, accumulated in f32, which holds f32
//     accuracy (one TF32 pass keeps ~3 decimal digits and is never used).
//     Its fragments are 32-bit scalar loads (ldmatrix moves 16-bit elements).
// An operand that must keep f32 precision under bf16 inputs (dS in the
// backward) is split the same way into two bf16 halves (2 products).
//
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4 g + t.  The
// accumulator of a 16 x 8 tile holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).  A product whose A operand comes from accumulators (P.V, dS.K,
// ...) takes the depth in the order the accumulator holds it: for tf32,
// depth index t is column 2t and t+4 is 2t+1; b_cols reads B in that order.
// For bf16 that order is the natural one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_plan.cuh"

namespace attn {

constexpr int kWarp = 32;
constexpr int kMaxL = 128;                 // Lq and Lk
constexpr int kMaxDh = 128;
constexpr int kNT = 4;                     // 8-wide key tiles in a chunk: 32 keys, one mask word
constexpr float kNegInf = -1e9f;           // ops/attention.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// One (B, H, L, Dh) operand by its element strides; Dh has unit stride.
struct Operand {
  void* ptr;
  long long sb, sh, sl;
};

template <typename T>
__device__ __forceinline__ T* row_ptr(const Operand& o, int n, int H, int l) {
  return static_cast<T*>(o.ptr) + (long long)(n / H) * o.sb + (long long)(n % H) * o.sh +
         (long long)l * o.sl;
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the identity for f32, bf16 rounding for bf16.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The kv-mask row of flattened row n (nullptr when there is no mask).
__device__ __forceinline__ const unsigned char* mask_row(const unsigned char* mask,
                                                         int mask_mode, int n, int H,
                                                         int Lk) {
  if (mask_mode == 1) return mask;
  if (mask_mode == 2) return mask + (size_t)(n / H) * Lk;
  return nullptr;
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows l0 .. l0 + rows - 1 of operand o at row n into s (row stride ld
// elements), zero-filling dims Dh .. dpad - 1 and rows rows .. rpad - 1.
// With vec (every row start 16-byte aligned, Dh a multiple of 16 bytes) the
// rows go by cp.async, 16 bytes a thread, and land once the caller waits on
// the group it commits; otherwise element by element.
template <typename T>
__device__ void stage(T* s, int ld, const Operand& o, int n, int H, int l0, int rows, int rpad,
                      int Dh, int dpad, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const T* base = row_ptr<T>(o, n, H, l0);
  if (vec && kWarp % (Dh / E) == 0) {
    // a row's 16-byte chunks tile a warp evenly: one division a thread
    const int cpr = Dh / E;
    const int c = threadIdx.x % cpr, step = blockDim.x / cpr;
    for (int r = threadIdx.x / cpr; r < rows; r += step) {
      cp_async16(s + r * ld + c * E, base + r * o.sl + c * E);
    }
  } else if (vec) {
    const int cpr = Dh / E;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(s + r * ld + c * E, base + r * o.sl + c * E);
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i - r * Dh;
      s[r * ld + d] = base[r * o.sl + d];
    }
  }
  const T zero = from_f32<T>(0.f);
  const int pd = dpad - Dh;
  for (int i = threadIdx.x; i < rows * pd; i += blockDim.x) {
    const int r = i / pd;
    s[r * ld + Dh + (i - r * pd)] = zero;
  }
  for (int i = threadIdx.x; i < (rpad - rows) * dpad; i += blockDim.x) {
    const int r = i / dpad;
    s[(rows + r) * ld + (i - r * dpad)] = zero;
  }
}

// ---------------------------------------------------------------- mma.sync

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four 8 x 8 matrices of 16-bit elements, lanes 8 i .. 8 i + 7
// giving the row addresses of matrix i; lane 4 g + t receives elements
// (g, 2t) and (g, 2t + 1) of each (with .trans, (2t, g) and (2t + 1, g)).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// An operand fragment: hi is the operand, lo the part hi drops (3xTF32, or
// dS's second bf16 half); a B fragment uses entries 0 and 1.
struct Frag {
  uint32_t hi[4], lo[4];
};

template <typename T> struct Mma;

template <> struct Mma<float> {
  static constexpr int kK = 8;     // depth of one product
  static constexpr int kPad = 4;   // row padding: a row stride of 4 mod 8 words is conflict-free
  // x = hi + lo: hi is x rounded to tf32 (to nearest, ties away from 0),
  // lo what that drops, which the product truncates to tf32 (it reads an
  // operand's top 19 bits; about 2^-22 of x is lost).  Two integer ops and
  // a subtraction: cvt.rna.tf32.f32 issues on a slower unit and made the
  // split, one per product, cost as much as the products.
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  // A[r][k] = s[(r0 + r) * ld + k0 + k]; rows 8..15 read as 0 unless hi_ok
  static __device__ __forceinline__ Frag a_rows(const float* s, int ld, int r0, int k0, int lane,
                                                bool hi_ok) {
    const float* p = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
    Frag f;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[4], f.hi[2], f.lo[2]);
    if (hi_ok) {
      split(p[8 * ld], f.hi[1], f.lo[1]);
      split(p[8 * ld + 4], f.hi[3], f.lo[3]);
    } else {
      f.hi[1] = f.lo[1] = f.hi[3] = f.lo[3] = 0u;
    }
    return f;
  }
  // B[k][n] = s[(n0 + n) * ld + k0 + k]
  static __device__ __forceinline__ Frag b_rows(const float* s, int ld, int n0, int k0, int lane) {
    const float* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
    Frag f;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[4], f.hi[1], f.lo[1]);
    return f;
  }
  // B[k][n] = s[(k0 + k) * ld + n0 + n], depth in the accumulator's order
  static __device__ __forceinline__ Frag b_cols(const float* s, int ld, int k0, int n0, int lane) {
    const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    Frag f;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[ld], f.hi[1], f.lo[1]);
    return f;
  }
  // the loaders the forward shares with bf16: a whole 16-row A tile, and
  // the B fragments of the 8-wide tiles n0 and n0 + 8 (the second only
  // where two)
  static __device__ __forceinline__ Frag a_tile(const float* s, int ld, int r0, int k0, int lane) {
    return a_rows(s, ld, r0, k0, lane, true);
  }
  static __device__ __forceinline__ void b_rows2(const float* s, int ld, int n0, int k0, int lane,
                                                 Frag& b0, Frag& b1, bool two) {
    b0 = b_rows(s, ld, n0, k0, lane);
    if (two) b1 = b_rows(s, ld, n0 + 8, k0, lane);
  }
  static __device__ __forceinline__ void b_cols2(const float* s, int ld, int k0, int n0, int lane,
                                                 Frag& b0, Frag& b1, bool two) {
    b0 = b_cols(s, ld, k0, n0, lane);
    if (two) b1 = b_cols(s, ld, k0, n0 + 8, lane);
  }
  // A from the accumulator tile c (the depth is its 8 columns; c2 unused)
  static __device__ __forceinline__ Frag a_acc(const float* c, const float*) {
    Frag f;
    split(c[0], f.hi[0], f.lo[0]);
    split(c[2], f.hi[1], f.lo[1]);
    split(c[1], f.hi[2], f.lo[2]);
    split(c[3], f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ Frag a_acc_exact(const float* c, const float* c2) {
    return a_acc(c, c2);
  }
  static __device__ __forceinline__ void mma(float* d, const Frag& a, const Frag& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  }
  static __device__ __forceinline__ void mma_exact(float* d, const Frag& a, const Frag& b) {
    mma(d, a, b);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The bf16 pair (lo, hi) of x0, x1, with lo holding what hi drops.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

template <> struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;   // row stride an odd multiple of 16 bytes
  // A[r][k] = s[(r0 + r) * ld + k0 + k]
  static __device__ __forceinline__ Frag a_tile(const T* s, int ld, int r0, int k0, int lane) {
    Frag f;
    ldsm_x4(f.hi, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
    return f;
  }
  // B[k][n] = s[(n0 + n) * ld + k0 + k] for the 8-wide tiles n0 (b0) and
  // n0 + 8 (b1)
  static __device__ __forceinline__ void b_rows2(const T* s, int ld, int n0, int k0, int lane,
                                                 Frag& b0, Frag& b1, bool = true) {
    const int i = lane >> 3;
    uint32_t r[4];
    ldsm_x4(r, s + (n0 + (lane & 7) + (i >> 1) * 8) * ld + k0 + (i & 1) * 8);
    b0.hi[0] = r[0]; b0.hi[1] = r[1];
    b1.hi[0] = r[2]; b1.hi[1] = r[3];
  }
  // B[k][n] = s[(k0 + k) * ld + n0 + n] for the tiles n0 (b0) and n0 + 8 (b1)
  static __device__ __forceinline__ void b_cols2(const T* s, int ld, int k0, int n0, int lane,
                                                 Frag& b0, Frag& b1, bool = true) {
    const int i = lane >> 3;
    uint32_t r[4];
    ldsm_x4_t(r, s + (k0 + (lane & 7) + (i & 1) * 8) * ld + n0 + (i >> 1) * 8);
    b0.hi[0] = r[0]; b0.hi[1] = r[1];
    b1.hi[0] = r[2]; b1.hi[1] = r[3];
  }
  // A from the accumulator tiles c (depth 0..7) and c2 (depth 8..15),
  // rounded to bf16
  static __device__ __forceinline__ Frag a_acc(const float* c, const float* c2) {
    Frag f;
    f.hi[0] = pack_bf16(c[0], c[1]);
    f.hi[1] = pack_bf16(c[2], c[3]);
    f.hi[2] = pack_bf16(c2[0], c2[1]);
    f.hi[3] = pack_bf16(c2[2], c2[3]);
    return f;
  }
  // ... keeping f32 precision in two bf16 halves
  static __device__ __forceinline__ Frag a_acc_exact(const float* c, const float* c2) {
    Frag f;
    split_bf16(c[0], c[1], f.hi[0], f.lo[0]);
    split_bf16(c[2], c[3], f.hi[1], f.lo[1]);
    split_bf16(c2[0], c2[1], f.hi[2], f.lo[2]);
    split_bf16(c2[2], c2[3], f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ void mma(float* d, const Frag& a, const Frag& b) {
    mma_bf16(d, a.hi, b.hi);
  }
  static __device__ __forceinline__ void mma_exact(float* d, const Frag& a, const Frag& b) {
    mma_bf16(d, a.lo, b.hi);
    mma_bf16(d, a.hi, b.hi);
  }
};

// Shared-memory row stride of a staged (L, Dh) plane of T: Dh padded to the
// product depth, plus 16 bytes, which keeps fragment loads conflict-free;
// attention_plan.cuh's row_stride, by the element size, with the constants
// folded in.
template <typename T>
__host__ __device__ inline int row_stride(int Dh) {
  return round_up(Dh, Mma<T>::kK) + Mma<T>::kPad;
}

// Quad reductions: the four lanes 4g .. 4g + 3 hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// exp(x - m), 0 for x = -inf (no key there) whatever m is
__device__ __forceinline__ float exp_sub(float x, float m) {
  return x == -INFINITY ? 0.f : expf(x - m);
}

// x / y rounded to nearest, as IEEE division rounds it, given r = 1 / y
// rounded to nearest (__frcp_rn): q = x r, then Markstein's correction by
// the exact residual x - q y.  Three instructions in place of the division's
// dozen and its branch; equal to x / y for every normal quotient (a
// softmax's: x = exp(S - m) in [0, 1], y its sum in [1, 128]), within a
// denormal's last bit below 2^-126.
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// The key mask of row n as bits in mw (kMaxL / 32 words): bit j set where
// key j < Lk is valid.  Every warp of the block calls it; one word a warp.
__device__ __forceinline__ void mask_words(unsigned* mw, const unsigned char* mrow, int Lk) {
  const int nw = blockDim.x / kWarp, warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int w = warp; w < kMaxL / kWarp; w += nw) {
    const int j = w * kWarp + lane;
    const unsigned bits = __ballot_sync(kFull, j < Lk && (mrow == nullptr || mrow[j]));
    if (lane == 0) mw[w] = bits;
  }
}

// Row masks of the live bits chunk_scores returns: 0x3333 for h = 0.
constexpr unsigned kRowBits = 0x3333u;

// The scores of one warp's 16 query rows (a_of(kc): their A fragment at
// depth kc) against the 32 keys of chunk c (rows 32 c .. of b_s; with
// kGuard, a tile at or past b_rows is not multiplied): s[u] holds keys
// 32 c + 8 u .., scaled, -1e9 where the causal tril (query qi0 + 8 h) or the
// key mask mw hides a key, -inf past Lk.  Returns the live entries as bits
// u * 4 + e (row h = e >> 1: kRowBits << 2 h).  Branch-free but for kGuard's
// tile test.
template <typename T, bool kGuard, typename ALoad>
__device__ __forceinline__ unsigned chunk_scores(float (&s)[kNT][4], const ALoad& a_of,
                                                 const T* b_s, int ld, int c, int b_rows,
                                                 int dpad, int qi0, int Lk, bool causal,
                                                 const unsigned* mw, float scale, int lane) {
  using M = Mma<T>;
#pragma unroll
  for (int u = 0; u < kNT; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  for (int kc = 0; kc < dpad; kc += M::kK) {
    const Frag a = a_of(kc);
#pragma unroll
    for (int u = 0; u < kNT; ++u) {
      if (!kGuard || 8 * (kNT * c + u) < b_rows) {
        M::mma(s[u], a, M::b_rows(b_s, ld, 8 * (kNT * c + u), kc, lane));
      }
    }
  }
  const int j0 = 8 * kNT * c + 2 * (lane & 3);
  const unsigned bits = mw[c] >> (2 * (lane & 3));   // a chunk is one mask word: bit 8 u + (e & 1)
  unsigned live = 0;
#pragma unroll
  for (int u = 0; u < kNT; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 8 * u + (e & 1);
      const bool lv = ((bits >> (8 * u + (e & 1))) & 1u) && !(causal && j > qi0 + 8 * (e >> 1));
      s[u][e] = lv ? s[u][e] * scale : (j < Lk ? kNegInf : -INFINITY);
      live |= (unsigned)lv << (u * 4 + e);
    }
  }
  return live;
}

// Folds a chunk's scores into the running row max m (quad-uniform) and the
// thread's share of the row sum l: the factor each earlier sum is rescaled
// by, per row.  s becomes exp(s - m).
__device__ __forceinline__ void online_softmax(float (&s)[kNT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = m[h];
#pragma unroll
    for (int u = 0; u < kNT; ++u) cm = fmaxf(cm, fmaxf(s[u][2 * h], s[u][2 * h + 1]));
    cm = quad_max(cm);
    alpha[h] = exp_sub(m[h], cm);
    m[h] = cm;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int u = 0; u < kNT; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[u][e] = exp_sub(s[u][e], m[e >> 1]);
      l[e >> 1] += s[u][e];
    }
  }
}

// Whether every row start of o is 16-byte aligned (host side).
template <typename T>
inline bool rows_aligned(const Operand& o) {
  const long long m = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0 && o.sb % m == 0 && o.sh % m == 0 &&
         o.sl % m == 0;
}

}  // namespace attn
