// Fused masked attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel mat_dcml_tpu/ops/pallas_attention.py::_bwd_kernel,
// launched by the pallas_call in _fused_attention_bwd (the custom_vjp
// backward of fused_masked_attention).  Per flattened row n = b * H + h, with
// S = mask(q k^T * scale) (f32, masked scores -1e9) and P = softmax(S):
//
//   dv = P^T dO,   dP = dO v^T,   dS = P o (dP - rowsum(dP o P)),
//   dq = (dS * scale) k,   dk = (dS * scale)^T q,
//
// no gradient for the mask, and dS = 0 where a score is masked: a row with
// no valid key has a uniform P (it still reaches dv from every key) and no
// dq or dk, as autograd through the XLA path gives.  Under bf16 inputs the
// rounding follows autograd through ops/cuda_attention.py::attention_plain:
// P is rounded to bf16 where it meets dO (dv), dP is rounded to bf16 (the
// output of a bf16 product there), and the softmax backward, dq and dk keep
// f32 (dS enters its products as two bf16 halves).  Operands are read and
// written by their strides.
//
// What bounds it on this card.  A row does 5 products of Lq x Lk x Dh
// multiply-adds (S, dP, dq, dk, dv): at the PPO update's shape (200 rows,
// L = 101, Dh = 32) 0.65 GFLOP against 18 MB moved in f32 (9 MB in bf16):
// 36 (bf16: 72) flops a byte, so operations bound it on paper, on the
// tensor cores; in practice a CTA's latency does (PERF.md).  One CTA a row n
// (L <= 128 fits one CTA, so no atomics and a deterministic result); Q, K,
// V and dO of the row are staged into shared memory once with cp.async.
//
//  - bf16 (attn_bwd_bf16): each product once.  Phase A, a warp per 16 query
//    rows, over its 16-key pairs in a loop (so short rows do only their
//    own work, and registers hold one pair): pass 1 computes S = Q K^T and
//    dP = dO V^T once, P = exp(S - m) / l from the forward's saved row max
//    and sum (a call without them keeps S and takes them from it, without
//    another product), dP rounded, D = rowsum(dP o P); P in f32 and dP wait
//    in three L x L planes of shared memory, query rows by key columns;
//    pass 2 reads them back for dS = P o (dP - D), dq = dS K with dS from
//    registers, and leaves P (rounded) and dS (two bf16 halves) in the same
//    planes.  Phase B, a warp per 16 keys: dv = P^T dO and dk = dS^T Q, the
//    transposed A tiles and every B fragment by ldmatrix (.trans where the
//    operand lies transposed).  At L = 101, Dh = 32 that is 36 KB of planes
//    and 73 KB of L x L planes, two CTAs an SM; at L and Dh near 128 the four
//    planes do not fit beside them, and two are kept (K and V, then Q and
//    dO staged over them), phase A reading its A operands from device
//    memory.
//  - f32 (attn_bwd_f32, 3xTF32): nothing L x L in shared
//    memory.  Phase A over query tiles, two passes over 32-key chunks: the
//    first computes S and dP and folds them into the row max, the sum and
//    D, online as FA2 folds the forward; the second recomputes S and dP for
//    dS, which enters dq = dS K from registers.  The row's max, 1 / sum and
//    D go to shared memory (3 x Lq floats).  Phase B over key tiles: S^T and
//    P^T recomputed, dP^T = V dO^T, dS^T from D, then dv = P^T dO and dk =
//    dS^T Q from registers: nine products where the math needs five, kept
//    because four f32 planes and f32 P and dS would leave an SM one CTA.
//    Where the four planes pass the card's opt-in maximum (Dh > 64 and L
//    above ~104), two are kept, as in bf16.
//  - Under causal, key tiles above the diagonal (phase A) and query tiles
//    below it (phase B) are skipped; phase B skips none when a row of the
//    CTA has no valid key, since that row's uniform P reaches every key.
//
// Limits: Lk <= kMaxL, Dh <= kMaxDh, and the shared memory for the shape
// within the card's opt-in maximum (attention_plan.cuh; the wrapper raises
// beyond it).  The launcher returns the launch's cudaError_t; it neither
// allocates nor synchronises.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kMaxWarps = attn_plan::kMaxBwdWarps;
constexpr int kPairs = kMaxL / 16;   // 16-key pairs of 8-key tiles a row can have

struct BwdParams {
  Operand q, k, v, dout, dq, dk, dv;
  const unsigned char* mask;
  int Lq, Lk, Dh, H, causal, mask_mode, vec;
  float scale;
};

// ... and what the bf16 leg reads besides
struct BwdParams16 : BwdParams {
  const float* stats;     // the forward's (2, N, Lq) row max and sum, or nullptr
  long long nlq;          // N * Lq
};

// The shared memory a block may opt in to on the current device, or -1.
long long optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

template <typename T>
attn_plan::BwdPlan plan_of(int Lq, int Lk, int Dh) {
  return attn_plan::bwd_plan(Lq, Lk, Dh, (int)sizeof(T), optin_limit() - attn_plan::kStaticSmem);
}

// A[r][k] = dim k0 + k of row r0 + r of f32 operand o at row n, read from
// device memory, 0 past L rows or Dh dims: the A operands of the two-plane
// layout.
__device__ __forceinline__ Frag a_rows_global(const Operand& o, int n, int H, int r0, int k0,
                                              int lane, int L, int Dh) {
  const int r = r0 + (lane >> 2), c = k0 + (lane & 3);
  const auto at = [&](int rr, int cc) {
    return rr < L && cc < Dh ? row_ptr<float>(o, n, H, rr)[cc] : 0.f;
  };
  Frag f;
  Mma<float>::split(at(r, c), f.hi[0], f.lo[0]);
  Mma<float>::split(at(r, c + 4), f.hi[2], f.lo[2]);
  Mma<float>::split(at(r + 8, c), f.hi[1], f.lo[1]);
  Mma<float>::split(at(r + 8, c + 4), f.hi[3], f.lo[3]);
  return f;
}

// The f32 backward (the header comment's f32 paragraph).  At Dh <= 32 it
// is held to 128 registers: two CTAs of 7 warps an SM (a sub-partition's
// 16K registers hold 4 warps of 128).
template <int DT, bool kTwo>
__global__ void __launch_bounds__(kMaxWarps * kWarp, DT <= 4 ? 2 : 1)
attn_bwd_f32(const BwdParams p) {
  using T = float;
  using M = Mma<T>;
  constexpr int kT = M::kK / 8;   // accumulator tiles a product's depth spans
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned mw_s[kMaxL / kWarp];   // valid keys, as bits
  __shared__ int nolive;          // some query row of this n has no valid key

  const int n = blockIdx.x;
  // rows padded to the product depth: 8 (f32) or 16 (bf16)
  const int lq_pad = round_up(p.Lq, M::kK), lk_pad = round_up(p.Lk, M::kK);
  const int nqt = (p.Lq + 15) / 16, nkt = (p.Lk + 15) / 16;   // 16-row tiles
  const int dpad = round_up(p.Dh, M::kK);
  const int ld = row_stride<T>(p.Dh);
  const int lq_stat = round_up(p.Lq, 8 * kNT);
  float* m_s = reinterpret_cast<float*>(smem_raw);   // row max of S (phase A)
  float* l_s = m_s + lq_stat;                        // 1 / row sum of exp(S - max)
  float* d_s = l_s + lq_stat;                        // D = rowsum(dP o P)
  T* plane = reinterpret_cast<T*>(d_s + lq_stat);
  T *q_s, *do_s, *k_s, *v_s;
  if constexpr (kTwo) {
    q_s = k_s = plane;
    do_s = v_s = plane + max(lq_pad, lk_pad) * ld;
  } else {
    q_s = plane;
    do_s = q_s + lq_pad * ld;
    k_s = do_s + lq_pad * ld;
    v_s = k_s + lk_pad * ld;
    stage<T>(q_s, ld, p.q, n, p.H, 0, p.Lq, lq_pad, p.Dh, dpad, p.vec);
    stage<T>(do_s, ld, p.dout, n, p.H, 0, p.Lq, lq_pad, p.Dh, dpad, p.vec);
  }
  stage<T>(k_s, ld, p.k, n, p.H, 0, p.Lk, lk_pad, p.Dh, dpad, p.vec);
  stage<T>(v_s, ld, p.v, n, p.H, 0, p.Lk, lk_pad, p.Dh, dpad, p.vec);
  cp_async_commit();
  mask_words(mw_s, mask_row(p.mask, p.mask_mode, n, p.H, p.Lk), p.Lk);
  if (threadIdx.x == 0) nolive = 0;
  cp_async_wait<0>();
  __syncthreads();

  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t4 = lane & 3;

  // ---- phase A: a warp per 16 query rows, two passes over 32-key chunks
  for (int qt = warp; qt < nqt; qt += nw) {
    const int r0 = 16 * qt;
    const bool hi_ok = r0 + 8 < lq_pad;
    const int qi0 = r0 + g;   // this thread's query rows: qi0 and qi0 + 8
    // the A fragments of this warp's rows of Q and dO at depth kc
    const auto a_q = [&](int kc) {
      if constexpr (kTwo) return a_rows_global(p.q, n, p.H, r0, kc, lane, p.Lq, p.Dh);
      else return M::a_rows(q_s, ld, r0, kc, lane, hi_ok);
    };
    const auto a_do = [&](int kc) {
      if constexpr (kTwo) return a_rows_global(p.dout, n, p.H, r0, kc, lane, p.Lq, p.Dh);
      else return M::a_rows(do_s, ld, r0, kc, lane, hi_ok);
    };
    const int nchunks = ((p.causal ? min(lk_pad, r0 + 16) : lk_pad) + 8 * kNT - 1) / (8 * kNT);
    float s[kNT][4], dp[kNT][4];
    // dP of chunk c into dp: dO V^T, rounded as the plain version rounds it
    auto chunk_dp = [&](int c) {
#pragma unroll
      for (int u = 0; u < kNT; ++u) dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.f;
      for (int kc = 0; kc < dpad; kc += M::kK) {
        const Frag a = a_do(kc);
#pragma unroll
        for (int u = 0; u < kNT; ++u) {
          const int j = 8 * (kNT * c + u);
          if (j < lk_pad) M::mma(dp[u], a, M::b_rows(v_s, ld, j, kc, lane));
        }
      }
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[u][e] = round_to<T>(dp[u][e]);
      }
    };
    // pass 1: the row max m and sum l of exp(S - m), online, and with them
    // D l = sum of exp(S - m) dP, rescaled alike
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f}, alpha[2];
    unsigned live = 0;
    for (int c = 0; c < nchunks; ++c) {
      live |= chunk_scores<T, true>(s, a_q, k_s, ld, c, lk_pad, dpad, qi0, p.Lk, p.causal, mw_s,
                                    p.scale, lane);
      chunk_dp(c);
      online_softmax(s, m, l, alpha);
#pragma unroll
      for (int h = 0; h < 2; ++h) dl[h] *= alpha[h];
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dl[e >> 1] = fmaf(s[u][e], dp[u][e], dl[e >> 1]);
      }
    }
    float D[2], inv_l[2];
    bool live_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      inv_l[h] = 1.f / l[h];
      D[h] = quad_sum(dl[h]) * inv_l[h];
      live_row[h] = quad_max((live & (kRowBits << (2 * h))) ? 1.f : 0.f) > 0.f;
    }

    // pass 2: P = exp(S - m) / l, dS = P o (dP - D) * scale where the score
    // is live, then dq += dS K with dS from registers
    float dq[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const unsigned lv = chunk_scores<T, true>(s, a_q, k_s, ld, c, lk_pad, dpad, qi0, p.Lk,
                                                p.causal, mw_s, p.scale, lane);
      chunk_dp(c);
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[u][e] = (lv >> (u * 4 + e)) & 1u
                        ? exp_sub(s[u][e], m[h]) * inv_l[h] * (dp[u][e] - D[h]) * p.scale
                        : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kNT / kT; ++u) {
        const int k0 = 8 * kNT * c + u * M::kK;
        if (k0 < lk_pad) {
          const Frag a = M::a_acc_exact(s[u * kT], s[u * kT + kT - 1]);
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            if (8 * d < dpad) M::mma_exact(dq[d], a, M::b_cols(k_s, ld, k0, 8 * d, lane));
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qi0 + 8 * h;
      if (i >= p.Lq) continue;
      T* row = row_ptr<T>(p.dq, n, p.H, i);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) row[col] = from_f32<T>(dq[d][2 * h + e]);
        }
      }
      if (t4 == 0) {
        // a row with no valid key: P is uniform over all Lk keys
        m_s[i] = live_row[h] ? m[h] : kNegInf;
        l_s[i] = live_row[h] ? inv_l[h] : 1.f / (float)p.Lk;
        d_s[i] = D[h];
        if (!live_row[h]) nolive = 1;
      }
    }
  }
  __syncthreads();
  if constexpr (kTwo) {   // Q and dO over K and V
    stage<T>(q_s, ld, p.q, n, p.H, 0, p.Lq, lq_pad, p.Dh, dpad, p.vec);
    stage<T>(do_s, ld, p.dout, n, p.H, 0, p.Lq, lq_pad, p.Dh, dpad, p.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- phase B: a warp per 16 keys over 32-query chunks; accumulator rows
  // are keys, columns queries
  const bool skip_causal = p.causal && !nolive;
  for (int kt = warp; kt < nkt; kt += nw) {
    const int j0 = 16 * kt;
    const bool hi_ok = j0 + 8 < lk_pad;
    float dv[DT][4], dk[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    }
    bool key_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + g + 8 * h;
      key_ok[h] = (mw_s[j >> 5] >> (j & 31)) & 1u;   // 0 past Lk
    }
    for (int c = skip_causal ? j0 / (8 * kNT) : 0; c * 8 * kNT < lq_pad; ++c) {
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
        st[u][0] = st[u][1] = st[u][2] = st[u][3] = 0.f;
        dpt[u][0] = dpt[u][1] = dpt[u][2] = dpt[u][3] = 0.f;
      }
      for (int kc = 0; kc < dpad; kc += M::kK) {
        Frag ak, av;
        if constexpr (kTwo) {
          ak = a_rows_global(p.k, n, p.H, j0, kc, lane, p.Lk, p.Dh);
          av = a_rows_global(p.v, n, p.H, j0, kc, lane, p.Lk, p.Dh);
        } else {
          ak = M::a_rows(k_s, ld, j0, kc, lane, hi_ok);
          av = M::a_rows(v_s, ld, j0, kc, lane, hi_ok);
        }
#pragma unroll
        for (int u = 0; u < kNT; ++u) {
          const int i0 = 8 * (kNT * c + u);
          if (i0 < lq_pad) {
            M::mma(st[u], ak, M::b_rows(q_s, ld, i0, kc, lane));
            M::mma(dpt[u], av, M::b_rows(do_s, ld, i0, kc, lane));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * (kNT * c + u) + 2 * t4 + (e & 1);
          const int j = j0 + g + 8 * (e >> 1);
          const bool valid = i < p.Lq && j < p.Lk;
          const bool live = valid && key_ok[e >> 1] && !(p.causal && j > i);
          const float pt =
              valid ? expf((live ? st[u][e] * p.scale : kNegInf) - m_s[i]) * l_s[i] : 0.f;
          st[u][e] = pt;
          dpt[u][e] = live ? pt * (round_to<T>(dpt[u][e]) - d_s[i]) * p.scale : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kNT / kT; ++u) {
        const int k0 = 8 * kNT * c + u * M::kK;
        if (k0 >= lq_pad) continue;
        const Frag ap = M::a_acc(st[u * kT], st[u * kT + kT - 1]);
        const Frag as = M::a_acc_exact(dpt[u * kT], dpt[u * kT + kT - 1]);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          if (8 * d < dpad) {
            M::mma(dv[d], ap, M::b_cols(do_s, ld, k0, 8 * d, lane));
            M::mma_exact(dk[d], as, M::b_cols(q_s, ld, k0, 8 * d, lane));
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + g + 8 * h;
      if (j >= p.Lk) continue;
      T* vrow = row_ptr<T>(p.dv, n, p.H, j);
      T* krow = row_ptr<T>(p.dk, n, p.H, j);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) {
            vrow[col] = from_f32<T>(dv[d][2 * h + e]);
            krow[col] = from_f32<T>(dk[d][2 * h + e]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t raw_pair(const __nv_bfloat16* row, int c, int Dh) {
  const unsigned short lo = c < Dh ? __bfloat16_as_ushort(row[c]) : 0;
  const unsigned short hi = c + 1 < Dh ? __bfloat16_as_ushort(row[c + 1]) : 0;
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// A[r][k] = dim k0 + k of row r0 + r of bf16 operand o at row n, read from
// device memory, 0 past L rows or Dh dims: the A operands of phase A in the
// two-plane layout.
__device__ __forceinline__ Frag a_rows_global_bf16(const Operand& o, int n, int H, int r0, int k0,
                                                   int lane, int L, int Dh) {
  const int r = r0 + (lane >> 2), c = k0 + 2 * (lane & 3);
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r + 8 * (i & 1), cc = c + 8 * (i >> 1);
    f.hi[i] = rr < L ? raw_pair(row_ptr<__nv_bfloat16>(o, n, H, rr), cc, Dh) : 0u;
  }
  return f;
}

// An f32 pair as two bf16 planes' words: hi holds the two values' upper
// halves, lo their lower halves (exactly, to be put back by unpack_f32).
__device__ __forceinline__ void pack_f32(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  lo = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x5410);
}
__device__ __forceinline__ void unpack_f32(uint32_t hi, uint32_t lo, float& x0, float& x1) {
  x0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
  x1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
}

// The bf16 backward: every product once a row n.  ld: row stride of the
// Q / dO / K / V planes, ldp: of the L x L planes (attention_plan.cuh).
// kPlain: no mask and no causal tril (the encoder's), where a score is
// live iff its key is one of the Lk and its query one of the Lq.
template <int DT, bool kTwo, bool kPlain>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
attn_bwd_bf16(const BwdParams16 p, int ld, int ldp) {
  using T = __nv_bfloat16;
  using M = Mma<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned mw_s[kMaxL / kWarp];   // valid keys, as bits
  __shared__ int nolive;          // some query row of this n has no valid key
  __shared__ __align__(16) uint4 zero16;   // what phase B reads past the L x L planes' rows

  const int n = blockIdx.x;
  const int lq16 = round_up(p.Lq, 16), lk16 = round_up(p.Lk, 16);
  const int lq8 = round_up(p.Lq, 8);          // query rows the L x L planes hold
  const int nqt = lq16 / 16, nkt = lk16 / 16;   // 16-row tiles
  const int dpad = round_up(p.Dh, 16);
  T* plane = reinterpret_cast<T*>(smem_raw);
  T *q_s, *do_s, *k_s, *v_s, *pl_s;
  if constexpr (kTwo) {
    q_s = k_s = plane;
    do_s = v_s = plane + max(lq16, lk16) * ld;
    pl_s = do_s + max(lq16, lk16) * ld;
  } else {
    q_s = plane;
    do_s = q_s + lq16 * ld;
    k_s = do_s + lq16 * ld;
    v_s = k_s + lk16 * ld;
    pl_s = v_s + lk16 * ld;
    stage<T>(q_s, ld, p.q, n, p.H, 0, p.Lq, lq16, p.Dh, dpad, p.vec);
    stage<T>(do_s, ld, p.dout, n, p.H, 0, p.Lq, lq16, p.Dh, dpad, p.vec);
  }
  // the L x L planes, query rows by key columns: at the end P rounded to
  // bf16 and dS (scaled) as two bf16 halves; in between dP (in P's) and
  // P or S in f32 (split over the two halves' planes)
  T* hi_s = pl_s + lq8 * ldp;
  T* lo_s = hi_s + lq8 * ldp;
  // pad rows are zeroed: a K or V row past Lk meets dS = 0 or P = 0 in a
  // product, a Q or dO row past Lq meets P = dS = 0 in phase B
  stage<T>(k_s, ld, p.k, n, p.H, 0, p.Lk, lk16, p.Dh, dpad, p.vec);
  stage<T>(v_s, ld, p.v, n, p.H, 0, p.Lk, lk16, p.Dh, dpad, p.vec);
  cp_async_commit();
  mask_words(mw_s, mask_row(p.mask, p.mask_mode, n, p.H, p.Lk), p.Lk);
  if (threadIdx.x == 0) {
    nolive = 0;
    zero16 = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const float uniform = 1.f / (float)p.Lk;

  // ---- phase A: a warp per 16 query rows, over its 16-key pairs.  Pass 1
  // computes S = Q K^T and dP = dO V^T once and keeps them in shared
  // memory, P = exp(S - m) / l from the row statistics (where the call has
  // none, S itself, and its max and sum follow from it), and D =
  // rowsum(dP o P); pass 2 reads them back for dS = P o (dP - D) * scale,
  // dq = dS K from registers, and leaves P (rounded) and dS for phase B.
  for (int qt = warp; qt < nqt; qt += nw) {
    const int r0 = 16 * qt;
    const int qi0 = r0 + g;   // this thread's query rows: qi0 and qi0 + 8
    const int np = ((p.causal ? min(p.Lk, r0 + 16) : p.Lk) + 15) / 16;
    const bool kept[2] = {r0 < lq8, r0 + 8 < lq8};   // rows the L x L planes hold
    const bool have = p.stats != nullptr;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
    if (have) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* st = p.stats + (long long)n * p.Lq + min(qi0 + 8 * h, p.Lq - 1);
        m[h] = st[0];
        l[h] = st[p.nlq];
        r[h] = __frcp_rn(l[h]);
      }
    }
    // the live score (i, j) of tile u (keys 8 u ..) entry e; w: the mask
    // word of the pair's keys, shifted to this lane's
    const auto is_live = [&](int u, int e, unsigned w) {
      const int i = qi0 + 8 * (e >> 1), j = 8 * u + 2 * t4 + (e & 1);
      if constexpr (kPlain) return j < p.Lk && i < p.Lq;
      return ((w >> (8 * (u & 3) + (e & 1))) & 1u) && !(p.causal && j > i) && i < p.Lq;
    };
    // f32 values of the thread's entries of tile u, in the hi / lo planes
    const auto put = [&](int u, const float (&x)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kept[h]) {
          const int at = (qi0 + 8 * h) * ldp + 8 * u + 2 * t4;
          uint32_t hw, lw;
          pack_f32(x[2 * h], x[2 * h + 1], hw, lw);
          *reinterpret_cast<uint32_t*>(hi_s + at) = hw;
          *reinterpret_cast<uint32_t*>(lo_s + at) = lw;
        }
      }
    };
    const auto get = [&](int u, float (&x)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[2 * h] = x[2 * h + 1] = 0.f;
        if (kept[h]) {
          const int at = (qi0 + 8 * h) * ldp + 8 * u + 2 * t4;
          unpack_f32(*reinterpret_cast<const uint32_t*>(hi_s + at),
                     *reinterpret_cast<const uint32_t*>(lo_s + at), x[2 * h], x[2 * h + 1]);
        }
      }
    };
    // bf16 pairs of tile u in the P plane
    const auto put16 = [&](int u, const float (&x)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kept[h]) {
          *reinterpret_cast<uint32_t*>(pl_s + (qi0 + 8 * h) * ldp + 8 * u + 2 * t4) =
              pack_bf16(x[2 * h], x[2 * h + 1]);
        }
      }
    };
    const auto get16 = [&](int u, float (&x)[4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[2 * h] = x[2 * h + 1] = 0.f;
        if (kept[h]) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              pl_s + (qi0 + 8 * h) * ldp + 8 * u + 2 * t4);
          x[2 * h] = __low2float(v);
          x[2 * h + 1] = __high2float(v);
        }
      }
    };

    // pass 1: the products, once
    bool any[2] = {false, false};
    float D[2] = {0.f, 0.f};
    for (int pr = 0; pr < np; ++pr) {
      float s[2][4] = {}, dp[2][4] = {};
      for (int kc = 0; kc < dpad; kc += 16) {
        Frag aq, ado, b0, b1;
        if constexpr (kTwo) {
          aq = a_rows_global_bf16(p.q, n, p.H, r0, kc, lane, p.Lq, p.Dh);
          ado = a_rows_global_bf16(p.dout, n, p.H, r0, kc, lane, p.Lq, p.Dh);
        } else {
          aq = M::a_tile(q_s, ld, r0, kc, lane);
          ado = M::a_tile(do_s, ld, r0, kc, lane);
        }
        M::b_rows2(k_s, ld, 16 * pr, kc, lane, b0, b1);
        M::mma(s[0], aq, b0);
        M::mma(s[1], aq, b1);
        M::b_rows2(v_s, ld, 16 * pr, kc, lane, b0, b1);
        M::mma(dp[0], ado, b0);
        M::mma(dp[1], ado, b1);
      }
      const unsigned w = mw_s[pr >> 1] >> (2 * t4);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int u = 2 * pr + t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lv = is_live(u, e, w);
          const int j = 8 * u + 2 * t4 + (e & 1);
          // masked and scaled as the forward does it (the product unfused)
          s[t][e] = lv ? __fmul_rn(s[t][e], p.scale) : (j < p.Lk ? kNegInf : -INFINITY);
          any[e >> 1] |= lv;
          dp[t][e] = round_to<T>(dp[t][e]);   // dP rounded as the plain version rounds it
          if (have) {
            // m >= -1e9, so a key past Lk (-inf) gives exp(-inf) = 0 as in
            // the forward
            s[t][e] = qi0 + 8 * (e >> 1) < p.Lq ? div_rn(expf(s[t][e] - m[e >> 1]), l[e >> 1],
                                                          r[e >> 1])
                                                 : 0.f;
            D[e >> 1] = fmaf(s[t][e], dp[t][e], D[e >> 1]);
          } else {
            m[e >> 1] = fmaxf(m[e >> 1], s[t][e]);
          }
        }
        put(u, s[t]);      // P (or S) in f32
        put16(u, dp[t]);   // dP, exact in bf16
      }
    }
    bool row_live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) row_live[h] = quad_max(any[h] ? 1.f : 0.f) > 0.f;
    if (!have) {
      // the row's max and sum from S; a row with no visible valid key has
      // max -1e9 and sum Lk (every score -1e9), its P uniform over all keys
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
      for (int u = 0; u < 2 * np; ++u) {
        float x[4];
        get(u, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(x[e] - m[e >> 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(l[h]);   // every lane: a shuffle of the whole warp
        l[h] = row_live[h] ? sum : (float)p.Lk;
        r[h] = __frcp_rn(l[h]);
      }
      for (int u = 0; u < 2 * np; ++u) {
        float x[4], dp[4];
        get(u, x);
        get16(u, dp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = qi0 + 8 * (e >> 1) < p.Lq ? div_rn(expf(x[e] - m[e >> 1]), l[e >> 1],
                                                     r[e >> 1])
                                            : 0.f;
          D[e >> 1] = fmaf(x[e], dp[e], D[e >> 1]);
        }
        put(u, x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) D[h] = quad_sum(D[h]);

    // pass 2: dS = P o (dP - D) * scale, dq = dS K, and P (rounded) and dS
    // over P and dP.  A masked score of a row with a valid key has P = 0
    // exactly (exp(-1e9 - m) underflows), and so dS = 0 as autograd gives;
    // a row with none has no dS at all
    float dq[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
    for (int pr = 0; pr < np; ++pr) {
      float ds[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int u = 2 * pr + t;
        float pf[4], dp[4];
        get(u, pf);
        get16(u, dp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[t][e] = row_live[e >> 1] ? pf[e] * (dp[e] - D[e >> 1]) * p.scale : 0.f;
        }
        put16(u, pf);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kept[h]) {
            const int at = (qi0 + 8 * h) * ldp + 8 * u + 2 * t4;
            uint32_t hh, ll;
            split_bf16(ds[t][2 * h], ds[t][2 * h + 1], hh, ll);
            *reinterpret_cast<uint32_t*>(hi_s + at) = hh;
            *reinterpret_cast<uint32_t*>(lo_s + at) = ll;
          }
        }
      }
      const Frag a = M::a_acc_exact(ds[0], ds[1]);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        if (16 * d2 < dpad) {
          Frag b0, b1;
          M::b_cols2(k_s, ld, 16 * pr, 16 * d2, lane, b0, b1);
          M::mma_exact(dq[2 * d2], a, b0);
          M::mma_exact(dq[2 * d2 + 1], a, b1);
        }
      }
    }
    // the key columns past the diagonal: P 0, or 1 / Lk on a row with no
    // valid key (it reaches every key's dv), and dS 0
    for (int u = 2 * np; 8 * u < lk16; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kept[h]) {
          const int i = qi0 + 8 * h, j = 8 * u + 2 * t4;
          const bool dead = !row_live[h] && i < p.Lq;
          const int at = i * ldp + j;
          *reinterpret_cast<uint32_t*>(pl_s + at) =
              pack_bf16(dead && j < p.Lk ? uniform : 0.f, dead && j + 1 < p.Lk ? uniform : 0.f);
          *reinterpret_cast<uint32_t*>(hi_s + at) = 0u;
          *reinterpret_cast<uint32_t*>(lo_s + at) = 0u;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qi0 + 8 * h;
      if (i >= p.Lq) continue;
      T* row = row_ptr<T>(p.dq, n, p.H, i);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) row[col] = from_f32<T>(dq[d][2 * h + e]);
        }
      }
      if (t4 == 0 && !row_live[h]) nolive = 1;
    }
  }
  __syncthreads();
  if constexpr (kTwo) {   // Q and dO over K and V
    stage<T>(q_s, ld, p.q, n, p.H, 0, p.Lq, lq16, p.Dh, dpad, p.vec);
    stage<T>(do_s, ld, p.dout, n, p.H, 0, p.Lq, lq16, p.Dh, dpad, p.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- phase B: a warp per 16 keys over 16-query steps: dv = P^T dO and
  // dk = dS^T Q, the transposed A tiles by ldmatrix.trans from the planes
  // (a query row past them reads zero16).  Under causal, queries before the
  // tile see none of its keys, unless a row with no valid key spreads P
  // over every key.
  const bool skip_causal = p.causal && !nolive;
  const int i8 = lane >> 3;   // the 8 x 8 matrix whose row this lane addresses
  for (int kt = warp; kt < nkt; kt += nw) {
    const int j0 = 16 * kt;
    float dv[DT][4], dk[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    }
    for (int qs = skip_causal ? j0 : 0; qs < lq16; qs += 16) {
      // A[m = key][k = query] = plane[query][key]: the tile stored transposed
      const int qrow = qs + (lane & 7) + (i8 >> 1) * 8;
      const int at = qrow * ldp + j0 + (i8 & 1) * 8;
      const bool in = qrow < lq8;
      Frag ap, as, al;
      ldsm_x4_t(ap.hi, in ? static_cast<const void*>(pl_s + at) : &zero16);
      ldsm_x4_t(as.hi, in ? static_cast<const void*>(hi_s + at) : &zero16);
      ldsm_x4_t(al.hi, in ? static_cast<const void*>(lo_s + at) : &zero16);
#pragma unroll
      for (int i = 0; i < 4; ++i) as.lo[i] = al.hi[i];
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        if (16 * d2 < dpad) {
          Frag b0, b1;
          M::b_cols2(do_s, ld, qs, 16 * d2, lane, b0, b1);
          M::mma(dv[2 * d2], ap, b0);
          M::mma(dv[2 * d2 + 1], ap, b1);
          M::b_cols2(q_s, ld, qs, 16 * d2, lane, b0, b1);
          M::mma_exact(dk[2 * d2], as, b0);
          M::mma_exact(dk[2 * d2 + 1], as, b1);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + g + 8 * h;
      if (j >= p.Lk) continue;
      T* vrow = row_ptr<T>(p.dv, n, p.H, j);
      T* krow = row_ptr<T>(p.dk, n, p.H, j);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) {
            vrow[col] = from_f32<T>(dv[d][2 * h + e]);
            krow[col] = from_f32<T>(dk[d][2 * h + e]);
          }
        }
      }
    }
  }
}

template <int DT, bool kTwo>
cudaError_t launch_f32(const BwdParams& p, int N, const attn_plan::BwdPlan& plan,
                       cudaStream_t stream) {
  if (plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_f32<DT, kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return e;
  }
  attn_bwd_f32<DT, kTwo><<<(unsigned)N, plan.warps * kWarp, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DT, bool kTwo, bool kPlain>
cudaError_t launch_bf16(const BwdParams16& p, int N, const attn_plan::BwdPlan& plan,
                        cudaStream_t stream) {
  const auto kernel = attn_bwd_bf16<DT, kTwo, kPlain>;
  if (plan.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)N, plan.warps * kWarp, plan.smem, stream>>>(p, plan.ld, plan.ldp);
  return cudaGetLastError();
}

template <int DT, bool kTwo>
cudaError_t launch_bf16(const BwdParams16& p, int N, const attn_plan::BwdPlan& plan,
                        cudaStream_t stream) {
  if (!p.causal && p.mask_mode == 0) return launch_bf16<DT, kTwo, true>(p, N, plan, stream);
  return launch_bf16<DT, kTwo, false>(p, N, plan, stream);
}

cudaError_t launch_f32(const BwdParams& p, int N, cudaStream_t stream) {
  const attn_plan::BwdPlan plan = plan_of<float>(p.Lq, p.Lk, p.Dh);
  const int dpad = round_up(p.Dh, Mma<float>::kK);
  if (dpad <= 32) return launch_f32<4, false>(p, N, plan, stream);
  if (dpad <= 64) return launch_f32<8, false>(p, N, plan, stream);
  if (plan.planes == 2) return launch_f32<16, true>(p, N, plan, stream);
  return launch_f32<16, false>(p, N, plan, stream);
}

cudaError_t launch_bf16(const BwdParams16& p, int N, cudaStream_t stream) {
  const attn_plan::BwdPlan plan = plan_of<__nv_bfloat16>(p.Lq, p.Lk, p.Dh);
  const int dpad = round_up(p.Dh, 16);
  if (dpad <= 32) return launch_bf16<4, false>(p, N, plan, stream);
  if (dpad <= 64) return launch_bf16<8, false>(p, N, plan, stream);
  if (plan.planes == 2) return launch_bf16<16, true>(p, N, plan, stream);
  return launch_bf16<16, false>(p, N, plan, stream);
}

}  // namespace

// q and dout (N, Lq, Dh); k and v (N, Lk, Dh); dq, dk, dv shaped as q, k, v;
// each a (B, H, L, Dh) operand with N = B * H, strides holding its element
// strides along b, h and l (q, k, v, dout, dq, dk, dv: 21 values); Dh has
// unit stride.  One dtype for all (0 = f32, 1 = bf16).  mask_mode: 0 none,
// 1 one shared (Lk,) row, 2 one (Lk,) row per batch index n / H.  stats:
// the forward's (2, N, Lq) row max and sum (bf16; the f32 leg finds its
// own), or nullptr, and the kernel takes them from the scores it holds.
extern "C" cudaError_t mat_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const void* mask, const float* stats,
                                         void* dq, void* dk, void* dv, const long long* strides,
                                         int N, int Lq, int Lk, int Dh, int H, int causal,
                                         int mask_mode, int dtype, void* stream) {
  if (N < 1 || Lq < 1 || Lk < 1 || Lk > kMaxL || Dh < 1 || Dh > kMaxDh || H < 1 ||
      N % H != 0 || mask_mode < 0 || mask_mode > 2 || (mask_mode != 0 && mask == nullptr) ||
      (causal && Lq != Lk) || strides == nullptr || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  BwdParams16 p;
  void* ptrs[7] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                   const_cast<void*>(dout), dq, dk, dv};
  Operand* ops[7] = {&p.q, &p.k, &p.v, &p.dout, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 7; ++i) *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  p.mask = static_cast<const unsigned char*>(mask);
  p.stats = stats;
  p.nlq = (long long)N * Lq;
  p.Lq = Lq; p.Lk = Lk; p.Dh = Dh; p.H = H; p.causal = causal; p.mask_mode = mask_mode;
  p.scale = 1.f / sqrtf((float)Dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.vec = Dh % 4 == 0 && rows_aligned<float>(p.q) && rows_aligned<float>(p.k) &&
            rows_aligned<float>(p.v) && rows_aligned<float>(p.dout);
    return launch_f32(p, N, s);
  }
  p.vec = Dh % 8 == 0 && rows_aligned<__nv_bfloat16>(p.q) && rows_aligned<__nv_bfloat16>(p.k) &&
          rows_aligned<__nv_bfloat16>(p.v) && rows_aligned<__nv_bfloat16>(p.dout);
  return launch_bf16(p, N, s);
}

// The limits the wrapper checks against, so the two cannot drift apart.
extern "C" int mat_attention_bwd_max_lk() { return kMaxL; }
extern "C" int mat_attention_bwd_max_dh() { return kMaxDh; }
// The shared memory a block of the launch takes, static included.
extern "C" long long mat_attention_bwd_smem_bytes(int Lq, int Lk, int Dh, int dtype) {
  const attn_plan::BwdPlan plan = dtype == 1 ? plan_of<__nv_bfloat16>(Lq, Lk, Dh)
                                             : plan_of<float>(Lq, Lk, Dh);
  return plan.smem + attn_plan::kStaticSmem;
}
// The shared memory a block may opt in to on the current device, or -1.
extern "C" long long mat_attention_bwd_smem_limit() { return optin_limit(); }
