// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mat_dcml_tpu/ops/pallas_attention.py::_fwd_kernel,
// launched by the pallas_call in _fused_attention_fwd (entry
// fused_masked_attention).  Per flattened row n = b * H + h:
//
//   out[n] = softmax(mask(q[n] k[n]^T / sqrt(Dh))) v[n]
//
// with f32 scores, a causal tril and/or a kv mask (shared (Lk,) row or one
// row per batch b = n / H), masked scores set to -1e9 (not -inf, so a row
// with no valid key gives the uniform softmax over all Lk keys, as the XLA
// path does), and under bf16 inputs the probabilities rounded to bf16 before
// P.V as the XLA path does.  Operands are read and written by their strides
// (unit stride along Dh), so the head-split views of the model need no copy.
//
// What bounds it on this card.  A row n does 2 * Lq * Lk * Dh multiply-adds
// against (2 * Lk + 2 * Lq) * Dh values moved.
//
//  - attn_fwd_mma (Lq > 1: encoder self-attention, both causal decoder
//    attentions of the teacher-forced passes; and Lq = 1 when the row
//    statistics are asked for).  At Lq = Lk = 101, Dh = 32 a row is 25
//    flops a byte in f32 (50 in bf16): operations bound it on paper, on the
//    tensor cores (3xTF32 in f32: 495 / 3 TFLOP/s), and in practice a CTA's
//    latency and instruction count do.  A CTA owns a (row n, query tile):
//    the launch plan (attention_plan.cuh) takes the largest tile, up to 128
//    rows (one CTA a row), whose grid still gives every SM a CTA, and down
//    to 16 rows where N is small (the rollout's 16 rows give 112 CTAs).  A
//    warp owns 16 query rows (the M of mma.sync).  Q and K are staged into
//    shared memory with cp.async in one group and V in a second, which lands
//    while S and the softmax run.  A warp computes S = Q K^T against every
//    key its rows see once and keeps it in registers (64 f32 a lane at 128
//    keys); the row max and sum come from those registers (across a quad of
//    lanes; the key mask as bits, no branches), then P = exp(S - m) / l
//    (bf16: normalised, then rounded as the XLA path rounds it) is the A
//    operand of O = P V straight from registers (f32: exp(S - m), and one
//    reciprocal a row at the end).  bf16 fragments come by ldmatrix (V's by
//    .trans), f32 ones by 32-bit loads split for 3xTF32.  Under causal, key
//    pairs above a warp's diagonal are neither staged nor multiplied; that
//    is exact while the row has a visible valid key (exp(-1e9 - m) is
//    exactly 0 in f32); a row with none averages V over all Lk keys, read
//    from device memory on that rare path.  Asked for (a forward whose
//    gradient will be taken), it writes each row's max and sum, which the
//    backward reads instead of searching for them.  mma.sync, not wgmma: a
//    wgmma tile is 64 rows, so Lq = 101 would take two warpgroups with 27
//    rows idle, and the work a row is too small for its asynchrony to pay.
//  - attn_fwd_decode (Lq = 1: every cached-decode step).  About 1 flop a
//    byte: bytes and latency bound it.  The keys of a row are split over the
//    CTAs of a cluster (1 or 4, so that small batches still spread over
//    the SMs) and the 4 warps of each.  A warp reads its keys' mask bytes
//    first and compacts the valid ones, so keys the mask hides are neither
//    read nor multiplied (half of them on average in the cached decode); 8
//    lanes read one key row with 16-byte loads (one warp load covers 4 f32
//    keys of Dh = 32) and reduce its dot product among themselves.  The
//    row's max and sum are merged across warps in shared memory and across
//    the cluster in distributed shared memory; then P (rounded under bf16)
//    times V, merged the same way.
//
// Limits: Lk <= kMaxL, Dh <= kMaxDh, any Lq (shared memory for every such
// shape fits the card's opt-in maximum: attention_plan.cuh).  The launcher returns the launch's
// cudaError_t; it neither allocates nor synchronises.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace {

using namespace attn;
namespace cg = cooperative_groups;

constexpr int kWarps = 4;                    // attn_fwd_decode

struct FwdParams {
  Operand q, k, v, out;
  const unsigned char* mask;
  float* stats;           // (2, N, Lq): row max, then row sum; nullptr: not written
  long long nlq;          // N * Lq
  int Lq, Lk, Dh, H, causal, mask_mode, vec;
  int rows;               // query rows a CTA of attn_fwd_mma owns (attention_plan.cuh)
  float scale;
};

// DT: 8-wide head-dim tiles of the output a thread accumulates (Dh <= 8 DT,
// DT even); NP: 16-key pairs a row may have (Lk <= 16 NP), which sizes the
// scores' registers (SMAC's 8-27 agents take 16 a lane, not 64); kPlain:
// no mask and no causal tril (the encoder's self-attention), where a key is
// live iff it is one of the Lk.
template <typename T, int DT, int NP, bool kPlain>
__global__ void __launch_bounds__(attn_plan::kMaxFwdWarps * kWarp)
attn_fwd_mma(const FwdParams p) {
  using M = Mma<T>;
  constexpr int kT = M::kK / 8;            // 8-key tiles a product's depth spans
  constexpr bool kRoundP = sizeof(T) == 2;   // bf16: P is normalised and rounded before P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned mw_s[kMaxL / kWarp];   // valid keys, as bits

  const int n = blockIdx.x;   // N on x, whose limit is 2^31 - 1 (y's is 65,535)
  const int q0 = blockIdx.y * p.rows;
  const int rows = min(p.rows, p.Lq - q0);
  const int kv_end = p.causal ? min(p.Lk, q0 + rows) : p.Lk;   // keys any row here sees
  const int kv_pad = round_up(kv_end, 16);                       // whole pairs
  const int dpad = round_up(p.Dh, M::kK);
  const int ld = row_stride<T>(p.Dh);
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + p.rows * ld;
  T* v_s = k_s + round_up(p.Lk, 16) * ld;

  // Two copy groups: Q and K, then V, which lands while S and the softmax
  // run.  Pad rows: Q's and K's only reach scores that are discarded or
  // replaced by a select (so even NaN there is harmless); V's meet P = 0,
  // and 0 x NaN is NaN, so they are zeroed.
  stage<T>(q_s, ld, p.q, n, p.H, q0, rows, rows, p.Dh, dpad, p.vec);
  stage<T>(k_s, ld, p.k, n, p.H, 0, kv_end, kv_end, p.Dh, dpad, p.vec);
  cp_async_commit();
  stage<T>(v_s, ld, p.v, n, p.H, 0, kv_end, kv_pad, p.Dh, dpad, p.vec);
  cp_async_commit();
  mask_words(mw_s, mask_row(p.mask, p.mask_mode, n, p.H, p.Lk), p.Lk);
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t4 = lane & 3;
  const int r0 = warp * 16;               // this warp's first row in the block
  const bool active = r0 < rows;
  const int qi0 = q0 + r0 + (lane >> 2);  // the query rows of this thread's fragments: qi0, qi0 + 8
  // 16-key pairs this warp multiplies: all staged ones, or up to its diagonal
  const int np = ((p.causal ? min(kv_end, q0 + r0 + 16) : kv_end) + 15) / 16;

  // S = Q K^T of the warp's 16 rows against every key it sees, computed
  // once and kept in registers (16 x 16 NP f32: 64 a lane at 128 keys).  Loops
  // over pairs are unrolled, so that s stays in registers, and leave at
  // the warp's last pair, so that short rows run only their own work.
  float s[2 * NP][4];
#pragma unroll
  for (int u = 0; u < 2 * NP; ++u) s[u][0] = s[u][1] = s[u][2] = s[u][3] = 0.f;
  if (active) {
    for (int kc = 0; kc < dpad; kc += M::kK) {
      const Frag a = M::a_tile(q_s, ld, r0, kc, lane);
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        if (pr >= np) break;
        Frag b0, b1;
        M::b_rows2(k_s, ld, 16 * pr, kc, lane, b0, b1, true);
        M::mma(s[2 * pr], a, b0);
        M::mma(s[2 * pr + 1], a, b1);
      }
    }
  }

  // mask and scale (no branches: the key mask as bits; the product rounded
  // on its own, never fused into exp's subtraction, so that the backward
  // forms the same P from the same scores), then the row max and sum from
  // the same registers
  unsigned words[kMaxL / kWarp];
#pragma unroll
  for (int w = 0; w < kMaxL / kWarp; ++w) words[w] = mw_s[w];
  bool any[2] = {false, false};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2 * NP; ++u) {
    if (u / 2 >= np) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * u + 2 * t4 + (e & 1);
      const bool lv = kPlain ? j < p.Lk
                             : ((words[u / 4] >> (j & 31)) & 1u) &&
                                   !(p.causal && j > qi0 + 8 * (e >> 1));
      s[u][e] = lv ? __fmul_rn(s[u][e], p.scale) : (j < p.Lk ? kNegInf : -INFINITY);
      any[e >> 1] |= lv;
      m[e >> 1] = fmaxf(m[e >> 1], s[u][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
#pragma unroll
  for (int u = 0; u < 2 * NP; ++u) {
    if (u / 2 >= np) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // m >= -1e9 (key 0 is always multiplied), so a key past Lk (-inf)
      // gives exp(-inf) = 0 without exp_sub's test
      s[u][e] = expf(s[u][e] - m[e >> 1]);
      l[e >> 1] += s[u][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  if constexpr (kRoundP) {
    // P = exp(S - m) / l, divided as the plain version divides (a product
    // by 1 / l rounds some P to another bf16:
    // tests/test_torch_attention_bf16_design.py)
    const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int u = 0; u < 2 * NP; ++u) {
      if (u / 2 >= np) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][e] = div_rn(s[u][e], l[e >> 1], r[e >> 1]);
    }
  }

  // O = P V (f32: exp(S - m) V, scaled by 1 / l at the end), P from
  // registers as the A operand (rounded to bf16 under bf16)
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int st = 0; st < 2 * NP / kT; ++st) {
      if (st * kT / 2 >= np) break;
      const Frag a = M::a_acc(s[st * kT], s[st * kT + kT - 1]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        if (16 * dp < dpad) {
          const bool two = 16 * dp + 8 < dpad;
          Frag b0, b1;
          M::b_cols2(v_s, ld, st * M::kK, 16 * dp, lane, b0, b1, two);
          M::mma(o[2 * dp], a, b0);
          if (two) M::mma(o[2 * dp + 1], a, b1);
        }
      }
    }
  }
  if (!active) return;

  bool row_live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) row_live[h] = quad_max(any[h] ? 1.f : 0.f) > 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = qi0 + 8 * h;
    if (i >= p.Lq) continue;
    if (p.stats != nullptr && t4 == 0) {
      // the plain softmax's max and sum over all Lk keys: a row with no
      // visible valid key has every score at -1e9, so its sum is Lk
      float* st = p.stats + (long long)n * p.Lq + i;
      st[0] = m[h];
      st[p.nlq] = row_live[h] ? l[h] : (float)p.Lk;
    }
    T* orow = row_ptr<T>(p.out, n, p.H, i);
    if (row_live[h]) {
      const float inv = kRoundP ? 1.f : 1.f / l[h];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) orow[col] = from_f32<T>(o[d][2 * h + e] * inv);
        }
      }
    } else {
      // no valid key is visible: the uniform softmax over all Lk keys, keys
      // after the row included, as the XLA path gives
      const float w = round_to<T>(1.f / (float)p.Lk);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * d + 2 * t4 + e;
          if (col < p.Dh) {
            float acc = 0.f;
            for (int j = 0; j < p.Lk; ++j) {
              acc = fmaf(w, to_f32(row_ptr<T>(p.v, n, p.H, j)[col]), acc);
            }
            orow[col] = from_f32<T>(acc);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- Lq = 1

constexpr int kGroup = 8;   // lanes that read one key row

// x[0 .. E) = row[d0 .. d0 + E) as f32, 0 past Dh.
template <typename T>
__device__ __forceinline__ void load_slice(const T* row, int d0, int Dh, bool vec,
                                           float (&x)[16 / sizeof(T)]) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + d0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = d0 + i < Dh ? to_f32(row[d0 + i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
attn_fwd_decode(const FwdParams p, int split) {
  constexpr int E = 16 / sizeof(T);              // elements a 16-byte load holds
  constexpr int R = kMaxDh / (kGroup * E);       // loads a lane makes per key row, at most
  __shared__ float s_s[kMaxL];                   // scores, then probabilities, by key
  __shared__ int lst[kWarps][kWarp];             // each warp's valid keys, compacted
  __shared__ float red[kWarps];
  __shared__ float part[2];                      // this CTA's (max, sum), read by the cluster
  __shared__ float o_w[kWarps][kMaxDh];
  __shared__ float o_c[kMaxDh];                  // this CTA's share of the output

  const int rank = blockIdx.x % split, n = blockIdx.x / split;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int grp = lane / kGroup, gl = lane % kGroup;
  const bool vec = p.vec;

  // this warp's keys: a contiguous share of the CTA's share of the row
  const int chunk = (p.Lk + split - 1) / split;
  const int c0 = min(p.Lk, rank * chunk), c1 = min(p.Lk, c0 + chunk);
  const int wchunk = (c1 - c0 + kWarps - 1) / kWarps;
  const int w0 = min(c1, c0 + warp * wchunk), w1 = min(c1, w0 + wchunk);
  const unsigned char* mrow = mask_row(p.mask, p.mask_mode, n, p.H, p.Lk);
  const int j = w0 + lane;
  const bool live = j < w1 && !(p.causal && j > 0) && (mrow == nullptr || mrow[j]);
  const unsigned bits = __ballot_sync(kFull, live);
  const int nlive = __popc(bits);
  if (live) lst[warp][__popc(bits & ((1u << lane) - 1))] = j;
  __syncwarp();

  float qv[R][E];
  const T* qrow = row_ptr<T>(p.q, n, p.H, 0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d0 = (r * kGroup + gl) * E;
    if (d0 < p.Dh) {
      load_slice<T>(qrow, d0, p.Dh, vec, qv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qv[r][e] = 0.f;
    }
  }

  // scores of the valid keys, four at a time (one a group of 8 lanes)
  float mx = -INFINITY;
  for (int t0 = 0; t0 < nlive; t0 += kWarp / kGroup) {
    const int t = t0 + grp;
    float dot = 0.f;
    if (t < nlive) {
      const T* krow = row_ptr<T>(p.k, n, p.H, lst[warp][t]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d0 = (r * kGroup + gl) * E;
        if (d0 < p.Dh) {
          float kx[E];
          load_slice<T>(krow, d0, p.Dh, vec, kx);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[r][e], kx[e], dot);
        }
      }
    }
    dot += __shfl_xor_sync(kFull, dot, 1);
    dot += __shfl_xor_sync(kFull, dot, 2);
    dot += __shfl_xor_sync(kFull, dot, 4);
    if (t < nlive) {
      const float x = dot * p.scale;
      if (gl == 0) s_s[lst[warp][t]] = x;
      mx = fmaxf(mx, x);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float m_c = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_c = fmaxf(m_c, red[w]);
  float e_l = lane < nlive ? expf(s_s[lst[warp][lane]] - m_c) : 0.f;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) e_l += __shfl_xor_sync(kFull, e_l, o);
  __syncthreads();   // every warp has read red[] as maxima
  if (lane == 0) red[warp] = e_l;
  __syncthreads();
  if (threadIdx.x == 0) {
    part[0] = m_c;
    part[1] = red[0] + red[1] + red[2] + red[3];
  }

  // the row's max and sum over the cluster
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync(); else __syncthreads();
  float M = -INFINITY, L = 0.f;
  for (int r = 0; r < split; ++r) {
    const float* pr = split > 1 ? cluster.map_shared_rank(part, r) : part;
    M = fmaxf(M, pr[0]);
  }
  for (int r = 0; r < split; ++r) {
    const float* pr = split > 1 ? cluster.map_shared_rank(part, r) : part;
    if (pr[0] != -INFINITY) L += pr[1] * expf(pr[0] - M);
  }
  const bool any_live = M != -INFINITY;

  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  if (any_live) {
    if (lane < nlive) {
      const int key = lst[warp][lane];
      s_s[key] = round_to<T>(expf(s_s[key] - M) / L);
    }
    __syncwarp();
    for (int t = grp; t < nlive; t += kWarp / kGroup) {
      const int key = lst[warp][t];
      const float pk = s_s[key];
      const T* vrow = row_ptr<T>(p.v, n, p.H, key);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d0 = (r * kGroup + gl) * E;
        if (d0 < p.Dh) {
          float vx[E];
          load_slice<T>(vrow, d0, p.Dh, vec, vx);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pk, vx[e], acc[r][e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], 8);
      acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], 16);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (r * kGroup + gl) * E + e;
        if (d < p.Dh) o_w[warp][d] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < p.Dh; d += blockDim.x) {
    o_c[d] = o_w[0][d] + o_w[1][d] + o_w[2][d] + o_w[3][d];
  }
  if (split > 1) cluster.sync(); else __syncthreads();
  if (rank == 0) {
    T* orow = row_ptr<T>(p.out, n, p.H, 0);
    if (any_live) {
      for (int d = threadIdx.x; d < p.Dh; d += blockDim.x) {
        float o = 0.f;
        for (int r = 0; r < split; ++r) o += (split > 1 ? cluster.map_shared_rank(o_c, r) : o_c)[d];
        orow[d] = from_f32<T>(o);
      }
    } else {
      // no valid key: the uniform softmax over all Lk keys, as the XLA path gives
      const float w = round_to<T>(1.f / (float)p.Lk);
      for (int d = threadIdx.x; d < p.Dh; d += blockDim.x) {
        float o = 0.f;
        for (int jj = 0; jj < p.Lk; ++jj) o = fmaf(w, to_f32(row_ptr<T>(p.v, n, p.H, jj)[d]), o);
        orow[d] = from_f32<T>(o);
      }
    }
  }
  if (split > 1) cluster.sync();   // rank 0 has read every CTA's o_c before any exits
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DT, int NP, bool kPlain>
cudaError_t launch_mma(const FwdParams& p, int N, int sms, cudaStream_t stream) {
  const attn_plan::FwdPlan plan = attn_plan::fwd_plan(N, p.Lq, p.Lk, p.Dh, (int)sizeof(T), sms);
  const cudaError_t e = opt_in_smem(attn_fwd_mma<T, DT, NP, kPlain>, (size_t)plan.smem);
  if (e != cudaSuccess) return e;
  FwdParams q = p;
  q.rows = plan.rows;
  attn_fwd_mma<T, DT, NP, kPlain><<<dim3((unsigned)N, (unsigned)plan.tiles), plan.warps * kWarp,
                                    (size_t)plan.smem, stream>>>(q);
  return cudaGetLastError();
}

// the bf16 leg specialised for calls without a mask (the f32 one would take
// more than 128 registers, and fit one CTA of 7 warps an SM, not two)
template <typename T, int DT, int NP>
cudaError_t launch_mma(const FwdParams& p, int N, int sms, cudaStream_t stream) {
  if (sizeof(T) == 2 && !p.causal && p.mask_mode == 0) {
    return launch_mma<T, DT, NP, sizeof(T) == 2>(p, N, sms, stream);
  }
  return launch_mma<T, DT, NP, false>(p, N, sms, stream);
}

template <typename T, int DT>
cudaError_t launch_mma(const FwdParams& p, int N, int sms, cudaStream_t stream) {
  if (p.Lk <= 32) return launch_mma<T, DT, 2>(p, N, sms, stream);
  return launch_mma<T, DT, kMaxL / 16>(p, N, sms, stream);
}

// The SMs of the current device (the plan fills them), or 132 (an H100).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return sms;
}

template <typename T>
cudaError_t launch(const FwdParams& p, int N, cudaStream_t stream) {
  if (p.Lq == 1 && p.stats == nullptr) {
    // CTAs a row: one from N = 128 up (256 rows at bucket 128), else a
    // cluster of 4, so that a small batch still covers more SMs than it has
    // rows (chip_smoke.py times N = 256, 64 and 16)
    const int split = N >= 128 ? 1 : 4;
    if (split == 1) {
      attn_fwd_decode<T><<<(unsigned)N, kWarps * kWarp, 0, stream>>>(p, 1);
      return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(N * split));
    cfg.blockDim = dim3(kWarps * kWarp);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_fwd_decode<T>, p, split);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  static const int sms = sm_count();
  const int dpad = round_up(p.Dh, Mma<T>::kK);
  if (dpad <= 32) return launch_mma<T, 4>(p, N, sms, stream);
  if (dpad <= 64) return launch_mma<T, 8>(p, N, sms, stream);
  return launch_mma<T, 16>(p, N, sms, stream);
}

}  // namespace

// q (N, Lq, Dh), k and v (N, Lk, Dh), out (N, Lq, Dh) as (B, H, L, Dh)
// operands with N = B * H: strides holds each one's element strides along
// b, h and l (q, k, v, out: 12 values); Dh has unit stride.  One dtype for
// all (0 = f32, 1 = bf16).  mask_mode: 0 none, 1 one shared (Lk,) row, 2 one
// (Lk,) row per batch index n / H.  Mask bytes are 0 (masked) or not.
// stats: nullptr, or a contiguous f32 (2, N, Lq) that receives each query
// row's softmax max and sum (the backward's input; written only when a
// gradient is needed).
extern "C" cudaError_t mat_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, float* stats,
                                         const long long* strides, int N, int Lq, int Lk,
                                         int Dh, int H, int causal, int mask_mode, int dtype,
                                         void* stream) {
  if (N < 1 || Lq < 1 || Lk < 1 || Lk > kMaxL || Dh < 1 || Dh > kMaxDh ||
      H < 1 || N % H != 0 || mask_mode < 0 || mask_mode > 2 ||
      (mask_mode != 0 && mask == nullptr) || (causal && Lq != Lk) || strides == nullptr ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  FwdParams p;
  void* ptrs[4] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v), out};
  Operand* ops[4] = {&p.q, &p.k, &p.v, &p.out};
  for (int i = 0; i < 4; ++i) *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  p.mask = static_cast<const unsigned char*>(mask);
  p.stats = stats;
  p.nlq = (long long)N * Lq;
  p.rows = 0;
  p.Lq = Lq; p.Lk = Lk; p.Dh = Dh; p.H = H; p.causal = causal; p.mask_mode = mask_mode;
  p.scale = 1.f / sqrtf((float)Dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.vec = Dh % 4 == 0 && rows_aligned<float>(p.q) && rows_aligned<float>(p.k) &&
            rows_aligned<float>(p.v);
    return launch<float>(p, N, s);
  }
  p.vec = Dh % 8 == 0 && rows_aligned<__nv_bfloat16>(p.q) && rows_aligned<__nv_bfloat16>(p.k) &&
          rows_aligned<__nv_bfloat16>(p.v);
  return launch<__nv_bfloat16>(p, N, s);
}

// The limits the wrapper checks against, so the two cannot drift apart.
extern "C" int mat_attention_fwd_max_lk() { return kMaxL; }
extern "C" int mat_attention_fwd_max_dh() { return kMaxDh; }
