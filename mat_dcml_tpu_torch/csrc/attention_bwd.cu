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
// dq or dk, as autograd through the XLA path gives.  Like the TPU kernel it
// recomputes P from q and k instead of reading a saved copy.  Under bf16
// inputs the rounding follows autograd through
// ops/cuda_attention.py::attention_plain: P is rounded to bf16 where it
// meets dO (dv), dP is rounded to bf16 (the output of a bf16 product there),
// and the softmax backward, dq and dk keep f32 (dS enters its products as
// two bf16 halves).  Operands are read and written by their strides.
//
// What bounds it on this card.  A row does 5 products of Lq x Lk x Dh
// multiply-adds (S, dP, dq, dk, dv): at the PPO update's shape (200 rows,
// L = 101, Dh = 32, f32) 0.65 GFLOP against 18 MB moved, 36 flops a byte:
// operations bound it, on the tensor cores (3xTF32 in f32, 495 / 3
// TFLOP/s; half the pairs under the causal mask).  The design is FA2's
// recompute, one CTA a row n (L <= 128 fits one CTA, so no atomics and a
// deterministic result):
//
//  - Q, K, V and dO of the row are staged into shared memory once with
//    cp.async, rows padded only to the product depth (f32 at the update's
//    shape: 4 x 104 x 36 x 4 B = 60 KB, so registers, not shared memory,
//    hold an SM to two CTAs; a 16-row tile's upper half past the padding
//    reads as 0); nothing L x L is kept there.  Where the four planes pass
//    the card's opt-in maximum (f32, Dh > 64 and L above ~104), two are
//    kept: K and V for phase A, then Q and dO staged over them for phase B,
//    and each phase reads its A operands (its own 16-row tiles) from device
//    memory instead, so every L <= 128 and Dh <= 128 fits.
//  - Phase A, warps owning 16-row query tiles, two passes over 32-key
//    chunks (the key mask as bits, no branches): the first computes S
//    and dP = dO V^T on the tensor cores and folds them into the row max,
//    the sum and D = rowsum(dP o P), online as FA2 folds the forward; the
//    second recomputes S and dP for dS, which enters dq = dS K from
//    registers as the A operand.  The row's max, 1 / sum and D go to
//    shared memory (3 x Lq floats).
//  - Phase B, warps owning 16-row key tiles, over 32-query chunks: S^T and
//    P^T recomputed from the stored max and sum, dP^T = V dO^T, dS^T from D,
//    then dv = P^T dO and dk = dS^T Q from registers.
//  - Under causal, key tiles above the diagonal (phase A) and query tiles
//    below it (phase B) are skipped; phase B skips none when a row of the
//    CTA has no valid key, since that row's uniform P reaches every key.
//
// What holds it at ~15x its bound (PERF.md): per-CTA latency, with 14 warps
// an SM at the update's shape to hide it; phase A, which computes S and dP
// twice, takes two thirds of a CTA's time.
//
// Limits: Lk <= kMaxL, Dh <= kMaxDh, and the shared memory for the shape
// within the card's opt-in maximum (mat_attention_bwd_smem_bytes; the
// wrapper raises beyond it).  The launcher returns the launch's cudaError_t;
// it neither allocates nor synchronises.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kMaxWarps = 8;

struct BwdParams {
  Operand q, k, v, dout, dq, dk, dv;
  const unsigned char* mask;
  int Lq, Lk, Dh, H, causal, mask_mode, vec;
  float scale;
};

// Row statistics (3 floats a query, for whole 32-query chunks), then Q and
// dO, then K and V, rows padded to the product depth; with kTwo, two planes
// of the longer length (K and V, then Q and dO).
template <typename T, bool kTwo>
inline size_t smem_bytes(int Lq, int Lk, int Dh) {
  const size_t lq = round_up(Lq, Mma<T>::kK), lk = round_up(Lk, Mma<T>::kK);
  const size_t rows = kTwo ? (lq > lk ? lq : lk) : lq + lk;   // of each pair
  return sizeof(float) * 3 * round_up(Lq, 8 * kNT) + sizeof(T) * 2 * rows * row_stride<T>(Dh);
}

// The shared memory a block may opt in to on the current device, or -1.
long long optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Whether the launch keeps two planes: f32 past Dh = 64 (the only case that
// can pass the H100's maximum), when the four do not fit.
template <typename T>
inline bool two_planes(int Lq, int Lk, int Dh) {
  return std::is_same<T, float>::value && round_up(Dh, Mma<T>::kK) > 64 &&
         (long long)smem_bytes<T, false>(Lq, Lk, Dh) > optin_limit();
}

template <typename T>
inline size_t launch_smem(int Lq, int Lk, int Dh) {
  return two_planes<T>(Lq, Lk, Dh) ? smem_bytes<T, true>(Lq, Lk, Dh)
                                   : smem_bytes<T, false>(Lq, Lk, Dh);
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

__host__ __device__ inline int block_warps(int Lq, int Lk) {
  const int tiles = max((Lq + 15) / 16, (Lk + 15) / 16);
  return tiles < kMaxWarps ? tiles : kMaxWarps;
}

template <typename T, int DT, bool kTwo>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
attn_bwd_mma(const BwdParams p) {
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

template <typename T, int DT, bool kTwo>
cudaError_t launch_dt(const BwdParams& p, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kTwo>(p.Lq, p.Lk, p.Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_mma<T, DT, kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_bwd_mma<T, DT, kTwo><<<(unsigned)N, block_warps(p.Lq, p.Lk) * kWarp, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const BwdParams& p, int N, cudaStream_t stream) {
  const int dpad = round_up(p.Dh, Mma<T>::kK);
  if (dpad <= 32) return launch_dt<T, 4, false>(p, N, stream);
  if (dpad <= 64) return launch_dt<T, 8, false>(p, N, stream);
  if constexpr (std::is_same<T, float>::value) {
    if (two_planes<T>(p.Lq, p.Lk, p.Dh)) return launch_dt<T, 16, true>(p, N, stream);
  }
  return launch_dt<T, 16, false>(p, N, stream);
}

}  // namespace

// q and dout (N, Lq, Dh); k and v (N, Lk, Dh); dq, dk, dv shaped as q, k, v;
// each a (B, H, L, Dh) operand with N = B * H, strides holding its element
// strides along b, h and l (q, k, v, dout, dq, dk, dv: 21 values); Dh has
// unit stride.  One dtype for all (0 = f32, 1 = bf16).  mask_mode: 0 none,
// 1 one shared (Lk,) row, 2 one (Lk,) row per batch index n / H.
extern "C" cudaError_t mat_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const void* mask, void* dq,
                                         void* dk, void* dv, const long long* strides, int N,
                                         int Lq, int Lk, int Dh, int H, int causal,
                                         int mask_mode, int dtype, void* stream) {
  if (N < 1 || Lq < 1 || Lk < 1 || Lk > kMaxL || Dh < 1 || Dh > kMaxDh || H < 1 ||
      N % H != 0 || mask_mode < 0 || mask_mode > 2 || (mask_mode != 0 && mask == nullptr) ||
      (causal && Lq != Lk) || strides == nullptr || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  BwdParams p;
  void* ptrs[7] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                   const_cast<void*>(dout), dq, dk, dv};
  Operand* ops[7] = {&p.q, &p.k, &p.v, &p.dout, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 7; ++i) *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  p.mask = static_cast<const unsigned char*>(mask);
  p.Lq = Lq; p.Lk = Lk; p.Dh = Dh; p.H = H; p.causal = causal; p.mask_mode = mask_mode;
  p.scale = 1.f / sqrtf((float)Dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.vec = Dh % 4 == 0 && rows_aligned<float>(p.q) && rows_aligned<float>(p.k) &&
            rows_aligned<float>(p.v) && rows_aligned<float>(p.dout);
    return launch<float>(p, N, s);
  }
  p.vec = Dh % 8 == 0 && rows_aligned<__nv_bfloat16>(p.q) && rows_aligned<__nv_bfloat16>(p.k) &&
          rows_aligned<__nv_bfloat16>(p.v) && rows_aligned<__nv_bfloat16>(p.dout);
  return launch<__nv_bfloat16>(p, N, s);
}

// The limits the wrapper checks against, so the two cannot drift apart.
extern "C" int mat_attention_bwd_max_lk() { return kMaxL; }
extern "C" int mat_attention_bwd_max_dh() { return kMaxDh; }
extern "C" long long mat_attention_bwd_smem_bytes(int Lq, int Lk, int Dh, int dtype) {
  return (long long)(dtype == 1 ? launch_smem<__nv_bfloat16>(Lq, Lk, Dh)
                                : launch_smem<float>(Lq, Lk, Dh));
}
// The shared memory a block may opt in to on the current device, or -1.
extern "C" long long mat_attention_bwd_smem_limit() { return optin_limit(); }
