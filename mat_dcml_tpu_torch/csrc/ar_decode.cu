// The whole autoregressive MAT decode, sampling included, in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mat_dcml_tpu/ops/pallas_decode.py::_ar_decode_kernel,
// launched by the pallas_call in fused_ar_decode, for the discrete and
// semi-discrete action families.  For every batch row and every position i
// in order (position i needs the action drawn at i - 1):
//
//   x   = LN0(gelu(start row at i = 0, else the previous action's row))
//   for each block: self-attention over the action stream (K/V written at
//         i, keys <= i), cross-attention with the encoder rep at i as query
//         and K/V from the post-LN1 stream, the MLP, three post-LNs
//   logits = head(x) in f32; unavailable actions masked to -1e10
//   action = argmax(masked + gumbel) (lowest index on ties), log-prob its
//            log-softmax; for i >= nd the Gaussian tail instead: mean = the
//            last logit, std = the last std entry, action = mean + std * z
//
// Exact-erf GELU (erff), LN eps 1e-6, attention scale 1 / sqrtf(Dh) rounded
// as the attention kernel and the plain path round it.  Two legs, as the TPU
// kernel has (it computes in the dtype of the caches it is given): an f32
// trunk, and a bf16 trunk (bf16 weights, obs_rep and caches, f32 sums,
// rounded to bf16 where the TPU kernel rounds; decode_common.cuh).  The
// head, the noise, avail, the sampling and the outputs are f32 in both.
//
// What bounds it.  A row needs about 2 A (10 n_block D^2 + D^2) flops of
// matrix-vector products plus 8 n_block D A (A + 1) / 2 of attention (22.7
// MFLOP at A = 101, D = 64, 2 blocks), against the weights (355 KB) read
// once and a few KB of inputs and outputs per row: operations bound it, at
// 2.7 us for 8 rows.  But the 101 positions depend on each other, and each
// is a chain of dependent stages, so the latency of a stage sets the time.
//
// The design (csrc/decode_common.cuh holds the per-position body it shares
// with decode_step.cu): a cluster of 4 CTAs decodes R rows together; the
// matrices a stage splits are cut by output columns over the 4 CTAs and a
// stage's outputs reach every CTA through distributed shared memory, one
// cluster barrier a stage; the projections, the MLP and the head, whose
// inputs every CTA holds, are held whole in every CTA where shared memory
// allows and computed there without a cluster barrier.  LayerNorms run in
// every CTA, and so does the sampling (the same logits in the same order
// give the same draw everywhere; rank 0 writes it).  Two paths, chosen by
// shape alone (decode_layout.cuh):
//
//  - on chip: each CTA holds its weights (about 200 KB at the recipe's
//    width, copied from the wrapper's image once for the whole decode) and
//    parameters in shared memory.  R = 2 rows a cluster up to B = 32 (one
//    (row, head) pair a CTA, its softmax reduced over the CTA) and 8
//    beyond, so that the clusters run in one wave; at the recipe's
//    width (n_embd 64, 2 heads, 2 blocks) 8 cluster barriers a position at
//    R = 2 (every optional matrix local), 10 at R = 8, against some 60 block
//    barriers before.  That width is compiled with its widths and local
//    matrices as constants, other widths take the generic kernel;
//  - device memory (weights too large for the slices, e.g. n_embd 256):
//    R = 4, the weights read from device memory, every matrix split, 18
//    cluster barriers a position at 2 blocks.
//
// The K/V caches (4 n_block A D of the trunk type a row: 207 KB in f32 at
// the recipe's width, 103 KB in bf16)
// live in the workspace in device memory on both paths; a group of lanes
// takes a key's score and a thread a run of values, so the loads of an
// attention pass are in flight at once.  A prologue, parallel over positions, computes what
// depends on no drawn action: every block's cross-attention query
// rep . Wq2 + b for all A positions (into the workspace; each CTA its own
// columns, read back only by itself), the start token's GELU and LN0, and
// LN0(gelu(.)) of every action's embedding row.  Each position's rep rows,
// query columns and sampling inputs are fetched (cp.async) a position ahead.
//
// The workspace is never zeroed: each CTA reads only the query columns it
// wrote in the prologue, and a cache slot of position j is read (at
// positions > j) only after its owner CTA wrote it at position j.
//
// In bf16 the trunk's weights take half the room, so at the recipe's width
// every optional matrix is local at 8 rows a cluster too (8 cluster
// barriers a position at both row counts).
//
// Limits (the wrapper checks them): D <= kMaxD, A <= kMaxA, heads <=
// kMaxHeads, action_dim <= kMaxAdim, D a multiple of the heads, and even in
// bf16 (rep rows are fetched in 4-byte words).  The launcher
// returns the launch's cudaError_t; it neither allocates nor synchronises.

#include "decode_common.cuh"

namespace {

using namespace dec;

constexpr int kMaxD = 256;
constexpr int kMaxA = 256;
constexpr int kMaxHeads = 8;
constexpr int kMaxAdim = 64;
constexpr float kMaskValue = -1e10f;   // ops/distributions.py MASK_VALUE
constexpr float kHalfLog2Pi = 0.91893853320467274f;

struct Args {
  const void* obs_rep;   // (B, A, D) trunk type
  const float* gumbel;   // (B, A, adim)
  const float* normal;   // (B, n_rows, adim)
  const float* avail;    // (B, A, adim) or null
  const char* wts;
  float* q2ws;           // (B, nb, A, D) cross-attention queries (values of the trunk type)
  void* cache;           // (B, nb, 4, A, D) K/V caches, trunk type
  float* act;            // (B, A)
  float* logp;           // (B, A)
  int B, A, D, H, nb, adim, nd, n_rows;
};

// kD, kH, kLocal: n_embd, heads and the local matrices as compile-time
// constants (0, or -1 for the mask: read at run time).
template <class T, int R, bool kOnChip, int kD, int kH, int kLocal>
__global__ void __launch_bounds__(kThreads, 1) ar_decode_kernel(const Args a, const Smem L) {
  using K = Cfg<T, R, kOnChip, true, kD, kH, kLocal>;
  extern __shared__ __align__(16) char sm[];
  const int D = kD ? kD : a.D, H = kH ? kH : a.H, A = a.A, adim = a.adim;
  // embedded through embed_act
  const Weights WL = weight_layout(true, 0, D, a.nb, adim, sizeof(T));
  Ctx c = make_ctx(sm, L, WL, a.wts, a.B, R, D, H, a.nb, adim, A);
  c.dcache = a.cache;
  c.cs = (long long)A * D;
  c.ps = D;
  c.bs = (long long)a.nb * 4 * A * D;
  const T* obs_rep = static_cast<const T*>(a.obs_rep);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int ncm = cdiv(D, kCluster), c0 = c.rank * ncm, nc = min(ncm, D - c0);
  const int ls = 2 * adim + 1;   // a row's sampling inputs: gumbel, avail, tail noise
  int* idx_s = reinterpret_cast<int*>(sm + L.idx);
  const float sd = wfield<float>(c, WL.std_row)[adim - 1];
  T* emb = sbuf<T>(c, L.emb);

  // ---- prologue: weights on chip; LN0(gelu(.)) of the start row and of
  // every action's row; every block's cross query at every position
  if (kOnChip) copy_image(c, WL.total);
  cp_async_commit();   // waited for at position 0
  for (int t = tid; t < (L.scores - L.x) / 4; t += kThreads) sbuf<float>(c, L.x)[t] = 0.f;
  __syncthreads();
  for (int e = warp; e <= adim; e += kWarps) {
    T* row = emb + e * D;
    const T* src = e == 0 ? wfield<T>(c, WL.embed_start)
                          : wfield<T>(c, WL.embed_act) + (size_t)(e - 1) * D;
    for (int d = lane; d < D; d += kWarp) row[d] = from_f<T>(gelu(to_f(src[d])));
    __syncwarp();
    ln_row(row, wfield<float>(c, WL.ln0), wfield<float>(c, WL.ln0) + D, D, row);
  }
  for (int b = 0; b < a.nb; ++b) {
    const T* w2 = wfield<T>(c, WL.qkvp2_w) + (size_t)b * D * 4 * D + c0;
    const float* b2 = wfield<float>(c, WL.qkvp2_b) + (size_t)b * 4 * D + c0;
    for (int t = tid; t < c.nrows * A * nc; t += kThreads) {
      const int j = t % nc, rp = t / nc;       // rp = r A + position
      const int row = c.row0 + rp / A, pos = rp % A;
      const T* rep = obs_rep + ((size_t)row * A + pos) * D;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc = fmaf(to_f(rep[k]), to_f(w2[(size_t)k * 4 * D + j]), acc);
      a.q2ws[(((size_t)row * a.nb + b) * A + pos) * D + c0 + j] =
          rnd<T>(rnd<T>(acc) + rnd<T>(b2[j]));
    }
  }
  __syncthreads();
  cluster_sync();   // every CTA of the cluster runs before any writes into it

  // a position's rep rows, this CTA's query columns and the sampling inputs,
  // into the buffers of its parity, by cp.async a position ahead (a rep row
  // in 4-byte words)
  const int words = D * (int)sizeof(T) / 4;
  auto prefetch = [&](int pos) {
    const int p = pos & 1;
    char* rep = sm + (p ? L.rep2 : L.rep);
    float* q2l = sbuf<float>(c, L.q2l) + p * a.nb * R * ncm;
    float* smp = sbuf<float>(c, L.smp) + p * R * ls;
    for (int t = tid; t < c.nrows * words; t += kThreads) {
      const int r = t / words, w = t % words;
      cp_async4(rep + 4 * t, reinterpret_cast<const char*>(
                                 obs_rep + ((size_t)(c.row0 + r) * A + pos) * D) + 4 * w);
    }
    for (int t = tid; t < a.nb * c.nrows * nc; t += kThreads) {
      const int j = t % nc, br = t / nc, b = br / c.nrows, r = br % c.nrows;
      cp_async4(q2l + (b * R + r) * ncm + j,
                a.q2ws + (((size_t)(c.row0 + r) * a.nb + b) * A + pos) * D + c0 + j);
    }
    for (int t = tid; t < c.nrows * adim; t += kThreads) {
      const int r = t / adim, k = t % adim;
      const size_t at = ((size_t)(c.row0 + r) * A + pos) * adim + k;
      cp_async4(smp + r * ls + k, a.gumbel + at);
      if (a.avail != nullptr) cp_async4(smp + r * ls + adim + k, a.avail + at);
      if (pos >= a.nd && k == adim - 1)
        cp_async4(smp + r * ls + 2 * adim,
                  a.normal + ((size_t)(c.row0 + r) * a.n_rows + (pos - a.nd)) * adim + k);
    }
    cp_async_commit();
  };
  prefetch(0);

  for (int i = 0; i < A; ++i) {
    __syncthreads();     // the last position is done with the buffers of i + 1's parity
    cp_async_wait_all();  // position i's inputs, issued a position ago
    if (i + 1 < A) prefetch(i + 1);
    const int p = i & 1;
    c.L.rep = p ? L.rep2 : L.rep;
    c.L.q2l = L.q2l + p * a.nb * R * ncm * 4;
    const float* smp = sbuf<float>(c, L.smp) + p * R * ls;
    // ---- the previous action's row (the start row at i = 0), embedded
    if (warp < c.nrows) {
      const T* e = emb + (i == 0 ? 0 : idx_s[warp] + 1) * D;
      T* x = sbuf<T>(c, L.x) + warp * D;
      for (int d = lane; d < D; d += kWarp) x[d] = e[d];
    }
    __syncthreads();
    DEC_MARK(kMarkPosition);

    decoder_position<K>(c, i);

    // ---- the logits, in every CTA
    const float* none = nullptr;
    stage<K>(c, kH2, sbuf<float>(c, L.w_h2), wfield<float>(c, WL.head_w2), adim,
             sbuf<float>(c, L.hh), D, adim, c.P.head_b2, false, none, L.logits);

    // ---- sampling, a warp a row: Gumbel-argmax and its log-prob, or the
    // Gaussian tail
    if (warp < c.nrows) {
      const int row = c.row0 + warp;
      const float* lg = sbuf<float>(c, L.logits) + warp * adim;
      const float* gm = smp + warp * ls;
      const float* av = a.avail != nullptr ? gm + adim : nullptr;
      float best_v = -INFINITY, m = -INFINITY;
      int best = 0x7fffffff;
      for (int k = lane; k < adim; k += kWarp) {
        const float ma = (av != nullptr && av[k] == 0.f) ? kMaskValue : lg[k];
        const float v = ma + gm[k];
        if (v > best_v) {  // strict, k rising: the lowest index wins a tie
          best_v = v;
          best = k;
        }
        m = fmaxf(m, ma);
      }
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best_v, o);
        const int ob = __shfl_xor_sync(kFull, best, o);
        if (ov > best_v || (ov == best_v && ob < best)) {
          best_v = ov;
          best = ob;
        }
      }
      if (best >= adim) best = 0;
      m = warp_max(m);
      float sum = 0.f;
      for (int k = lane; k < adim; k += kWarp)
        sum += expf(((av != nullptr && av[k] == 0.f) ? kMaskValue : lg[k]) - m);
      sum = warp_sum(sum);
      if (lane == 0) {
        const float mb = (av != nullptr && av[best] == 0.f) ? kMaskValue : lg[best];
        float lp = (mb - m) - logf(sum);
        float out = (float)best;
        if (i >= a.nd) {
          const float mean = lg[adim - 1];
          out = mean + sd * gm[2 * adim];
          const float diff = out - mean;
          lp = -(diff * diff) / (2.f * (sd * sd)) - logf(sd) - kHalfLog2Pi;
        }
        if (c.rank == 0) {
          a.act[(size_t)row * A + i] = out;
          a.logp[(size_t)row * A + i] = lp;
        }
        idx_s[warp] = best;  // the next feed is the discrete one-hot, after a tail agent too
      }
      __syncwarp();
    }
    DEC_MARK(kMarkSample);
  }
}

template <class T, int R, bool kOnChip, int kD = 0, int kH = 0, int kLocal = -1>
cudaError_t launch(const Args& a, const Smem& L, cudaStream_t stream) {
  static int smem_set = 0;
  const auto kernel = ar_decode_kernel<T, R, kOnChip, kD, kH, kLocal>;
  const cudaError_t e = allow_smem(kernel, L.total, &smem_set);
  if (e != cudaSuccess) return e;
  return launch_clusters(kernel, cdiv(a.B, R), L.total, stream, a, L);
}

// The plan of the launch (decode_layout.cuh) and the kernel it takes.
template <class T>
cudaError_t run(const Args& a, cudaStream_t s) {
  constexpr int es = sizeof(T);
  const Smem L = plan_layout(true, a.B, a.D, a.H, a.nb, a.adim, a.A, 0, es);
  if (!on_chip(L)) return launch<T, device_rows(true), false>(a, L, s);
  const bool recipe = recipe_kernel(true, L, a.B, a.D, a.H);
  if (chip_rows(a.B) == 2)
    return recipe ? launch<T, 2, true, 64, 2, recipe_local(true, 2, es)>(a, L, s)
                  : launch<T, 2, true>(a, L, s);
  return recipe ? launch<T, 8, true, 64, 2, recipe_local(true, 8, es)>(a, L, s)
                : launch<T, 8, true>(a, L, s);
}

bool valid(int B, int A, int D, int H, int nb, int adim, int nd, int n_rows, int dtype) {
  return !(B < 1 || A < 1 || A > kMaxA || D < 1 || D > kMaxD || H < 1 || H > kMaxHeads ||
           D % H != 0 || nb < 1 || adim < 1 || adim > kMaxAdim || nd < 0 || nd > A ||
           n_rows < (A - nd > 1 ? A - nd : 1) || dtype < 0 || dtype > 1 ||
           (dtype == 1 && D % 2 != 0));
}

}  // namespace

// obs_rep (B, A, D) of the trunk type, gumbel (B, A, adim), normal (B,
// n_rows, adim), avail (B, A, adim) or null (all available), weights: the
// flat ARDecodeWeights (on the on-chip path followed by their image,
// ops/decode_plan.py::with_image), workspace: the (B, nb, A, D) f32 cross
// queries, then the (B, nb, 4, A, D) K/V caches of the trunk type; act and
// logp (B, A) f32; all contiguous.  dtype: the trunk, 0 f32, 1 bf16.
extern "C" cudaError_t mat_ar_decode(const void* obs_rep, const void* gumbel, const void* normal,
                                     const void* avail, const void* weights, void* workspace,
                                     void* act, void* logp, int B, int A, int D, int H, int nb,
                                     int adim, int nd, int n_rows, int dtype, void* stream) {
  if (!valid(B, A, D, H, nb, adim, nd, n_rows, dtype)) return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  const Args a{obs_rep, static_cast<const float*>(gumbel), static_cast<const float*>(normal),
               static_cast<const float*>(avail), static_cast<const char*>(weights), ws,
               ws + (size_t)B * nb * A * D, static_cast<float*>(act), static_cast<float*>(logp),
               B, A, D, H, nb, adim, nd, n_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(a, s) : run<float>(a, s);
}

// The limits the wrapper checks against, so the two sides cannot drift
// apart (the flat weights' bytes: decode_layout.cuh mat_decode_weight_bytes).
extern "C" int mat_ar_decode_max_d() { return kMaxD; }
extern "C" int mat_ar_decode_max_a() { return kMaxA; }
extern "C" int mat_ar_decode_max_heads() { return kMaxHeads; }
extern "C" int mat_ar_decode_max_adim() { return kMaxAdim; }
