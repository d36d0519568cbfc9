// One MAT decode position, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel mat_dcml_tpu/ops/pallas_decode.py::_decode_step_kernel,
// launched by the pallas_call in fused_decode_step (pallas_decode.py:678).  The
// exact decode of the continuous action families calls it once per position
// and samples between calls.  For every batch row:
//
//   x   = LN0(gelu(x_in . W_emb + b_emb))
//   for each block: self-attention over the action stream (K/V written at
//         position i, keys 0 .. i), cross-attention with the encoder rep at i
//         as query and K/V from the post-LN1 stream, the MLP, three post-LNs
//   logits = the f32 head: Dense -> gelu -> LN -> Dense
//
// Exact-erf GELU (erff), LN eps 1e-6, attention scale 1 / sqrtf(Dh) rounded
// as the attention kernel and the plain path round it, keys after i skipped
// (the plain version's -1e9 weight is exactly 0).  Two legs, as the TPU
// kernel has: an f32 trunk, and a bf16 trunk (bf16 x_in, rep, weights and
// caches, f32 sums, rounded to bf16 where the TPU kernel rounds;
// decode_common.cuh); the head and the logits are f32 in both.
//
// The 4 n_block K/V caches are updated in place: cache c of a row holds
// position j at cache + c * cache_stride + j * pos_stride + row * batch_stride,
// so the wrapper may lay them out position-major (L, B, D), as the TPU kernel
// does, or batch-major (B, L, D).  The TPU kernel's copy-forward of every cache
// tile (an artifact of aliasing its inputs to its outputs) has no counterpart.
//
// What bounds it.  A row needs about 2 (10 n_block D^2 + D^2 + D in_dim + D
// adim) flops of matrix-vector products plus 8 n_block D (i + 1) of attention
// (some 0.2 MFLOP at D = 64, 2 blocks), against the weights (about 350 KB f32)
// read once, the 4 n_block (i + 1) D cached values of the row read and 4
// n_block D written: bytes bound it, at about 0.1-0.2 us at B = 8.  One
// position is a chain of dependent stages, and every launch pays the launch
// latency and brings its weights on chip: latency sets its time.
//
// The design is the per-position body of csrc/decode_common.cuh, shared with
// ar_decode.cu: a cluster of 4 CTAs takes R rows (2 up to B = 32, 8 beyond,
// so that B = 128 runs in one wave of 16 clusters).  On the
// on-chip path each CTA copies its row of the weight image, which the
// wrapper gathers once per packed weights (each CTA's weight parts and
// parameters as they lie in its shared memory), with 16-byte cp.async
// copies at the start of every launch; where even the column slices do not
// fit (e.g. n_embd 256), the device-memory path reads the flat weights from
// device memory (chosen by shape alone, decode_layout.cuh).  The embedding,
// the projections and the MLP layers are held whole in every CTA while
// shared memory allows (at multi-agent MuJoCo's width, R = 2: all five) and
// computed there without a cluster barrier; stage 4 of each block also
// computes the cross-attention query from rep.  10 cluster barriers a
// launch at that width (one to start, 4 a block, one for the head; the
// logits go straight to device memory), 12 at R = 8, 19 off chip.  In bf16
// the trunk's matrices take half the room and the head's first layer is
// local too: 9 cluster barriers at both row counts.  The
// caches stay in the caller's workspace; the CTA that owns a (row, head)
// pair writes its key and value at i and reads positions before i.
//
// Layout: the wrapper's workspace is batch-major, so a row's cached keys are
// one contiguous run of (i + 1) D values.  The cache-layout probe
// (csrc/cache_layout_probe.cu, mat_dcml_tpu_torch/probes/cache_layout.py)
// timed both layouts on an H100 (700 W): the per-position store and the
// attention over keys 0 .. i cost the same within 0.3% in either layout at
// B = 8 and 128, because latency, not the access pattern, sets their time; so
// the layout is kept for the contiguous run, not for a measured gain.
//
// Limits (the wrapper checks them): D <= kMaxD, i < L <= kMaxL, heads <=
// kMaxHeads, in_dim <= kMaxIn, adim <= kMaxAdim, D a multiple of the heads,
// and in bf16 D even and rep's rows at even strides (fetched in 4-byte
// words).
// The launcher returns the launch's cudaError_t; it neither allocates nor
// synchronises.

#include "decode_common.cuh"

namespace {

using namespace dec;

constexpr int kMaxD = 256;
constexpr int kMaxL = 256;
constexpr int kMaxHeads = 8;
constexpr int kMaxIn = 257;
constexpr int kMaxAdim = 256;

struct Args {
  const void* x_in;      // trunk type
  long long x_stride;
  const void* rep;       // trunk type
  long long rep_stride;
  const char* wts;
  void* cache;           // trunk type
  long long cache_stride, pos_stride, batch_stride;
  float* logits;   // (B, adim)
  int B, in_dim, D, H, nb, adim, i;
};

// kD, kH, kLocal: n_embd, heads and the local matrices as compile-time
// constants (0, or -1 for the mask: read at run time).
template <class T, int R, bool kOnChip, int kD, int kH, int kLocal>
__global__ void __launch_bounds__(kThreads, 1) decode_step_kernel(const Args a, const Smem L) {
  using K = Cfg<T, R, kOnChip, false, kD, kH, kLocal>;
  extern __shared__ __align__(16) char sm[];
  const int D = kD ? kD : a.D, H = kH ? kH : a.H, in_dim = a.in_dim, tid = threadIdx.x;
  const Weights WL = weight_layout(false, in_dim, D, a.nb, a.adim, sizeof(T));
  Ctx c = make_ctx(sm, L, WL, a.wts, a.B, R, D, H, a.nb, a.adim, a.i + 1);
  c.dcache = a.cache;
  c.cs = a.cache_stride;
  c.ps = a.pos_stride;
  c.bs = a.batch_stride;
  const T* x_in = static_cast<const T*>(a.x_in);
  const T* rep = static_cast<const T*>(a.rep);
  T* xin = sbuf<T>(c, L.xin);

  // ---- weights on chip, the rows' inputs (dead rows of the last cluster
  // 0): by cp.async in f32; in bf16 rep in 4-byte words, x_in (of any
  // width) by plain loads while the copies fly
  if (kOnChip) copy_image(c, WL.total);
  const int words = D * (int)sizeof(T) / 4;
  for (int t = tid; t < R * words; t += kThreads) {
    const int r = t / words, w = t % words;
    if (r < c.nrows)
      cp_async4(sm + L.rep + 4 * t,
                reinterpret_cast<const char*>(rep + (size_t)(c.row0 + r) * a.rep_stride) + 4 * w);
    else sbuf<float>(c, L.rep)[t] = 0.f;
  }
  for (int t = tid; t < R * in_dim; t += kThreads) {
    const int r = t / in_dim, k = t % in_dim;
    const T* src = x_in + (size_t)(c.row0 + r) * a.x_stride + k;
    if (r >= c.nrows) xin[t] = from_f<T>(0.f);
    else if (sizeof(T) == 4) cp_async4(xin + t, src);
    else xin[t] = *src;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  cluster_sync();   // every CTA of the cluster runs before any writes into it

  // ---- embed the position's input, GELU, LN0 (into t3, LN3's input of a
  // block, read again only after the first block's cluster barriers)
  const T* none = nullptr;
  stage<K>(c, kEmb, sbuf<T>(c, L.w_embed), wfield<T>(c, WL.embed_w), D, xin, in_dim, D,
           c.P.embed_b, true, none, L.t3);
  ln_rows<R>(sbuf<T>(c, L.t3), c.P.ln0, c.P.ln0 + D, D, sbuf<T>(c, L.x));

  decoder_position<K>(c, a.i);

  // ---- the logits, each CTA its columns, straight to device memory
  product<R>(sbuf<float>(c, L.hh), D, D,
             view<kOnChip>(sbuf<float>(c, L.w_h2), wfield<float>(c, WL.head_w2), a.adim, D,
                           a.adim, c.rank, kCluster),
             a.adim, c.rank, kCluster, c.P.head_b2, false, (const float*)nullptr, 0, c.peers, 0,
             0, a.adim, a.logits + (size_t)c.row0 * a.adim, c.nrows);
}

template <class T, int R, bool kOnChip, int kD = 0, int kH = 0, int kLocal = -1>
cudaError_t launch(const Args& a, const Smem& L, cudaStream_t stream) {
  static int smem_set = 0;
  const auto kernel = decode_step_kernel<T, R, kOnChip, kD, kH, kLocal>;
  const cudaError_t e = allow_smem(kernel, L.total, &smem_set);
  if (e != cudaSuccess) return e;
  return launch_clusters(kernel, cdiv(a.B, R), L.total, stream, a, L);
}

// The plan of the launch (decode_layout.cuh) and the kernel it takes; the
// scores of a pair take i + 1 floats: the layout for L positions holds them.
template <class T>
cudaError_t run(const Args& a, int L, cudaStream_t s) {
  constexpr int es = sizeof(T);
  const Smem S = plan_layout(false, a.B, a.D, a.H, a.nb, a.adim, L, a.in_dim, es);
  if (!on_chip(S)) return launch<T, device_rows(false), false>(a, S, s);
  const bool recipe = recipe_kernel(false, S, a.B, a.D, a.H);
  if (chip_rows(a.B) == 2)
    return recipe ? launch<T, 2, true, 64, 2, recipe_local(false, 2, es)>(a, S, s)
                  : launch<T, 2, true>(a, S, s);
  return recipe ? launch<T, 8, true, 64, 2, recipe_local(false, 8, es)>(a, S, s)
                : launch<T, 8, true>(a, S, s);
}

}  // namespace

// x_in (B, in_dim) with row stride x_stride, rep (B, D) with row stride
// rep_stride, weights: the flat DecodeStepWeights (on the on-chip path
// followed by their image, ops/decode_plan.py::with_image), cache: the 4 nb
// caches of L positions (strides in elements as above), logits (B, adim)
// f32 contiguous; x_in, rep and the caches of the trunk type (dtype 0 f32,
// 1 bf16), each row's innermost dim contiguous.
extern "C" cudaError_t mat_decode_step(const void* x_in, long long x_stride, const void* rep,
                                       long long rep_stride, const void* weights, void* cache,
                                       long long cache_stride, long long pos_stride,
                                       long long batch_stride, void* logits, int B, int L,
                                       int in_dim, int D, int H, int nb, int adim, int i,
                                       int dtype, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || i < 0 || i >= L || D < 1 || D > kMaxD || H < 1 ||
      H > kMaxHeads || D % H != 0 || nb < 1 || in_dim < 1 || in_dim > kMaxIn || adim < 1 ||
      adim > kMaxAdim || dtype < 0 || dtype > 1 ||
      (dtype == 1 && (D % 2 != 0 || rep_stride % 2 != 0 ||
                      reinterpret_cast<size_t>(rep) % 4 != 0))) {
    return cudaErrorInvalidValue;
  }
  const Args a{x_in, x_stride, rep, rep_stride, static_cast<const char*>(weights), cache,
               cache_stride, pos_stride, batch_stride, static_cast<float*>(logits),
               B, in_dim, D, H, nb, adim, i};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(a, L, s) : run<float>(a, L, s);
}

// The limits the wrapper checks against, so the two sides cannot drift
// apart (the flat weights' bytes: decode_layout.cuh mat_decode_weight_bytes).
extern "C" int mat_decode_step_max_d() { return kMaxD; }
extern "C" int mat_decode_step_max_l() { return kMaxL; }
extern "C" int mat_decode_step_max_heads() { return kMaxHeads; }
extern "C" int mat_decode_step_max_in() { return kMaxIn; }
extern "C" int mat_decode_step_max_adim() { return kMaxAdim; }
