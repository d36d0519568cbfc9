// The launch plan and shared-memory layout of the two attention kernels
// (attention_fwd.cu, attention_bwd.cu): the CTAs of a launch, the query
// rows each owns, and the bytes of every region of its shared memory.
//
// Two element types, by their size esize: f32 (4; 3xTF32 on m16n8k8, so
// operands are padded to a depth of 8) and bf16 (2; m16n8k16, depth 16).
// A staged (L, Dh) plane keeps rows of row_stride elements: Dh padded to
// the depth plus 16 bytes, an odd multiple of 16 bytes, which keeps the
// 8 rows an ldmatrix (or a quad of scalar loads) reads on distinct banks.
//
// It is plain C++ apart from ATTN_HD, so that the plan is written once:
// nvcc compiles it into both attention libraries, which launch by it and
// export it (mat_attention_{fwd,bwd}_plan); g++ compiles this file alone for
// the CPU tests (tests/test_torch_attention_plan.py), which hold the same
// code to the properties the kernels rely on.

#pragma once

#ifdef __CUDACC__
#define ATTN_HD __host__ __device__
#else
#define ATTN_HD
#endif

namespace attn_plan {

constexpr int kWarp = 32;
constexpr int kTile = 16;                // query (or key) rows a warp owns: the M of mma.sync
constexpr int kMaxL = 128;               // Lk, and Lq of the backward's shared-memory plan
constexpr int kMaxDh = 128;
constexpr int kMaxFwdWarps = kMaxL / kTile;
constexpr int kMaxBwdWarps = 8;
constexpr int kStaticSmem = 64;          // static shared memory a kernel declares, at most

ATTN_HD inline int cdiv(int a, int b) { return (a + b - 1) / b; }
ATTN_HD inline int round_up(int x, int m) { return cdiv(x, m) * m; }
ATTN_HD inline int imax(int a, int b) { return a > b ? a : b; }
ATTN_HD inline int imin(int a, int b) { return a < b ? a : b; }

// depth of one product and row stride, in elements of esize bytes
ATTN_HD inline int depth(int esize) { return esize == 4 ? 8 : 16; }
ATTN_HD inline int row_stride(int Dh, int esize) {
  return round_up(Dh, depth(esize)) + 16 / esize;
}

// ---------------------------------------------------------------- forward

// A forward launch: grid (N, tiles); a CTA owns query rows
// [tile * rows, min(Lq, tile * rows + rows)) of row n, a warp each 16.
struct FwdPlan {
  int warps;              // a CTA, 16 query rows each
  int rows;               // query rows a CTA owns: 16 * warps
  int tiles;              // CTAs a row n (gridDim.y)
  long long ctas;         // N * tiles
  long long smem;         // dynamic shared memory a CTA: Q rows, K and V planes
};

// The largest CTA (at most 8 warps, 128 rows) whose grid still gives each
// of the card's sms SMs a CTA; where none does, one warp a CTA, the most
// CTAs a row can have.  At the encoder's N = 256 rows of 101 queries that
// is one CTA a row (7 warps); at the rollout's N = 16, seven CTAs a row of
// one warp each (112 CTAs).  A row of at most 32 queries stays in one CTA:
// its warps' work is too short for a split to shorten, and each CTA of a
// split stages the row's K and V again.
ATTN_HD inline FwdPlan fwd_plan(long long N, int Lq, int Lk, int Dh, int esize, int sms) {
  const int q16 = cdiv(Lq, kTile);
  int w = q16 <= 2 ? q16 : 1;
  for (int c = imin(kMaxFwdWarps, q16); c >= 1 && q16 > 2; --c) {
    if (N * cdiv(q16, c) >= sms) {
      w = c;
      break;
    }
  }
  FwdPlan p;
  p.warps = imin(w, q16);
  p.rows = kTile * p.warps;
  p.tiles = cdiv(Lq, p.rows);
  p.ctas = N * p.tiles;
  p.smem = (long long)esize * (p.rows + 2 * round_up(Lk, kTile)) * row_stride(Dh, esize);
  return p;
}

// ---------------------------------------------------------------- backward

// A backward launch: one CTA a row n (grid N), warps owning 16-row query
// tiles (phase A) and then 16-row key tiles (phase B).
//
// f32: 3 floats a query of row statistics, then Q, dO, K, V, rows padded
// to 8; where the four planes pass the opt-in limit (Dh > 64 and L above
// ~104), two planes (K and V, then Q and dO over them).
//
// bf16: Q, dO, K, V, rows padded to 16, then three L x L planes of bf16,
// query rows (padded to 8 only: phase B reads the rows past them as zeros)
// by key columns: P rounded (for dv = P^T dO) and dS's two bf16 halves (for
// dk = dS^T Q), which hold P in f32 and dP before that; where that passes
// the opt-in limit (L and Dh both above ~120), two planes as in f32.  At
// L = 101, Dh = 32 that is 108 KB, two CTAs an SM.
struct BwdPlan {
  int warps;
  int planes;             // 4, or 2 when the four do not fit
  int ld;                 // row stride of a Q / dO / K / V plane, elements
  int ldp;                // row stride of an L x L plane (bf16), elements
  long long smem;         // dynamic shared memory a CTA
};

ATTN_HD inline int bwd_warps(int Lq, int Lk) {
  return imin(kMaxBwdWarps, imax(cdiv(Lq, kTile), cdiv(Lk, kTile)));
}

ATTN_HD inline long long bwd_smem(int Lq, int Lk, int Dh, int esize, int planes) {
  const int d = depth(esize);
  const long long lq = round_up(Lq, d), lk = round_up(Lk, d);
  const long long rows = planes == 2 ? (lq > lk ? lq : lk) : lq + lk;   // of each pair
  const long long qkv = (long long)esize * 2 * rows * row_stride(Dh, esize);
  if (esize == 4) return 4LL * 3 * round_up(Lq, 32) + qkv;
  return qkv + 2LL * 3 * round_up(Lq, 8) * (lk + 8);
}

// limit: the dynamic shared memory a CTA may opt in to on this card, less
// the kernel's static shared memory
ATTN_HD inline BwdPlan bwd_plan(int Lq, int Lk, int Dh, int esize, long long limit) {
  BwdPlan p;
  p.warps = bwd_warps(Lq, Lk);
  p.ld = row_stride(Dh, esize);
  p.ldp = round_up(Lk, kTile) + 8;
  p.planes = 4;
  p.smem = bwd_smem(Lq, Lk, Dh, esize, 4);
  const bool may_drop = esize == 2 || round_up(Dh, depth(esize)) > 64;
  if (p.smem > limit && may_drop) {
    p.planes = 2;
    p.smem = bwd_smem(Lq, Lk, Dh, esize, 2);
  }
  return p;
}

}  // namespace attn_plan

// out: warps, rows, tiles, ctas, smem
extern "C" void mat_attention_fwd_plan(long long N, int Lq, int Lk, int Dh, int esize, int sms,
                                       long long* out) {
  const attn_plan::FwdPlan p = attn_plan::fwd_plan(N, Lq, Lk, Dh, esize, sms);
  out[0] = p.warps;
  out[1] = p.rows;
  out[2] = p.tiles;
  out[3] = p.ctas;
  out[4] = p.smem;
}

// out: warps, planes, ld, ldp, smem
extern "C" void mat_attention_bwd_plan(int Lq, int Lk, int Dh, int esize, long long limit,
                                       long long* out) {
  const attn_plan::BwdPlan p = attn_plan::bwd_plan(Lq, Lk, Dh, esize, limit);
  out[0] = p.warps;
  out[1] = p.planes;
  out[2] = p.ld;
  out[3] = p.ldp;
  out[4] = p.smem;
}

extern "C" int mat_attention_static_smem() { return attn_plan::kStaticSmem; }
