// The per-position body shared by the two decode kernels (ar_decode.cu, the
// whole decode; decode_step.cu, one position a launch), for Hopper (sm_90a).
//
// A cluster of kCluster CTAs decodes R batch rows together.  The weights of
// the matrices a stage splits are divided by output columns over the
// cluster: CTA `rank` owns columns [rank * ceil(n / C), ...) of each, keeps
// that slice in shared memory (the on-chip path: the wrapper gathers each
// CTA's slices and parameters into an image once per packed weights, and
// the kernel copies its row in with 16-byte cp.async) or reads it from
// device memory (the device-memory path, for shapes whose slices do not
// fit; chosen by shape alone), computes those columns for the R rows and
// writes them into every CTA's copy of the output (distributed shared
// memory); one cluster barrier closes the stage, after which every CTA holds
// the whole (R, n) output.  A dot product is never split across CTAs.
//
// A cluster barrier costs more than a small product on an H100, so on the
// on-chip path the matrices whose inputs every CTA already holds are, where
// shared memory allows, held whole in every CTA and computed there
// redundantly ("local": the same inputs, code and order give the same values
// in every CTA), with a block barrier instead of a cluster one.  Which
// matrices are local is decided by shape alone (plan_layout,
// decode_layout.cuh): the projections and MLP of each block, the head, and a
// decode step's embedding, greedily in a fixed order.
//
// Each (row, head) pair of an attention has one owner CTA (pair p = r H + h
// belongs to rank p % C).  It writes the pair's key and value at position i
// into the caches in device memory, attends over positions 0 .. i, and
// writes the head's output into every CTA.  The owner never changes, so a
// cache slot is only ever read by the CTA that wrote it.
//
// Stages of one decoder block at position i, and how each ends:
//   1  x . [Wq|Wk|Wv]                        -> qkv              split
//   2  self-attention of the owned pairs      -> ya               exchange
//   3  ya . Wp1 + b + x                       -> t1, LN1 -> h1    local or split
//   4  h1 . [Wk2|Wv2] (+ the cross query)     -> kv2, q2          split
//   5  cross-attention of the owned pairs     -> yb               exchange
//   6  yb . Wp2 + b + rep                     -> t2, LN2 -> h2    local or split
//   7  gelu(h2 . W1 + b)                      -> u                local or split
//   8  u . W2 + b + h2                        -> t3, LN3 -> x     local or split
// and the head: gelu(x . H1 + b) -> hv, LN -> hh; hh . H2 + b -> logits.
// Split stages and exchanges end at a cluster barrier, local ones at a block
// barrier.  A LayerNorm runs in every CTA on its full copy, a warp a row.
// Every stage writes a buffer of its own, read only by later stages of the
// same block (or position), and each block has four cluster barriers, so a
// CTA writes into a peer's buffer only after a cluster barrier that ends the
// peer's last read of it.
//
// The products: columns j and k-slices s (ks a column, a power of two
// dividing 32, lanes of one warp) give each thread one column and every
// ks-th input; the ks partial sums meet by warp shuffles.  R rows share each
// weight read.  A slice is stored transposed, column j at j * ld + k, with
// ld = ks (mod 32), so the 32 lanes of a warp read 32 distinct banks.
//
// The trunk type T (Cfg::T): f32, or bf16 as the TPU kernel runs a bf16
// trunk (pallas_decode.py _mm, _gelu, _layer_norm).  The trunk's weights,
// the K/V caches, rep and every buffer of the trunk that a stage writes
// (and exchanges) hold T; a bf16 value widens to f32 exactly as it is
// loaded, and every product, LayerNorm, GELU and attention computes in f32.
// The result rounds to T where the TPU kernel rounds it: a product after
// its f32 sum, again after its bias (itself rounded to T) is added, again
// after the GELU and after the residual; a LayerNorm's output; an
// attention's output (its scores, softmax and P.V stay f32).  The head,
// its weights, the biases, the LayerNorm parameters and the sampling stay
// f32.  For T = f32 every rounding is the identity, so the f32 kernels are
// the all-f32 ones.
//
// The kernels are compiled for the recipe's widths (n_embd 64, 2 heads) with
// those widths as constants, so loops unroll and divisions fold, and once
// more for any width; the launcher picks by shape.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "decode_layout.cuh"

namespace dec {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / kWarp;
constexpr float kLnEps = 1e-6f;          // flax LayerNorm
constexpr unsigned kFull = 0xffffffffu;

// The trunk type's conversions: to_f widens (exact), from_f rounds to
// nearest even (as jnp's astype and torch's .to do), rnd rounds through T.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <class T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }
// a load from device memory that bypasses L1 (cached in L2 only), widened
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const bf16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
// four consecutive elements, 4-element aligned, widened
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldcg4(const bf16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// Stage clocks, compiled in only with DEC_PROBE (csrc/decode_probe.cu, read
// by probes/decode_stages.py): thread 0 of the launch's first CTA appends
// (tag, clock64) as each step of the body ends.  Without DEC_PROBE DEC_MARK
// is nothing.
enum Mark { kMarkPosition = 0, kMarkProduct, kMarkAttend, kMarkLn, kMarkBarIn, kMarkBarOut,
            kMarkBlockBar, kMarkSample };
#ifdef DEC_PROBE
constexpr int kProbeMarks = 1 << 15;
__device__ long long probe_clock[kProbeMarks];
__device__ int probe_tag[kProbeMarks];
__device__ int probe_count;
__device__ __forceinline__ void probe_mark(int tag) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && probe_count < kProbeMarks) {
    probe_clock[probe_count] = clock64();
    probe_tag[probe_count] = tag;
    ++probe_count;
  }
}
#define DEC_MARK(tag) ::dec::probe_mark(tag)
#else
#define DEC_MARK(tag) ((void)0)
#endif

__device__ __forceinline__ void cluster_sync() {
  DEC_MARK(kMarkBarIn);
  cg::this_cluster().sync();
  DEC_MARK(kMarkBarOut);
}

// Every CTA's shared memory base in the cluster (index: rank).
struct Peers {
  char* base[kCluster];
};

// A CTA's view of its columns of a weight matrix: element (k, j), j counted
// from the CTA's first column, at p[k * sk + j * sj].
template <class TW>
struct WView {
  const TW* p;
  int sk, sj;
};

// This CTA's view of its columns of the (n_in, ldw-wide) matrix at `g` in
// device memory, or of its slice (the whole matrix when parts is 1) at
// `chip` in shared memory.
template <bool kOnChip, class TW>
__device__ inline WView<TW> view(const TW* chip, const TW* g, int ldw, int n_in, int n_out,
                                 int rank, int parts) {
  const int ncm = cdiv(n_out, parts);
  if (kOnChip) return WView<TW>{chip, 1, slice_depth(n_in, ncm, (int)sizeof(TW))};
  return WView<TW>{g + rank * ncm, ldw, 1};
}

// out[r][c0 + j] = act(bias[c0 + j] + sum_k x[r][k] W[k][c0 + j]) (+ res[r][c0 + j])
// for r < R and this CTA's columns j (all n_out of them when parts is 1),
// rounded to TO where the TPU kernel rounds (after the sum, the bias, the
// GELU and the residual; the bias itself rounded to TO), written at byte
// offset dst (row stride ldd elements) of the first nq shared memories in
// `peers`, or, with gout set, to gout (row stride ldd) in device memory for
// r < nvalid.  Called by the whole CTA; the caller closes the stage.
// Everything is passed by value, so that the caller's context stays in
// registers.
template <int R, class TX, class TW, class TO>
__device__ void product(const TX* x, int ldx, int n_in, WView<TW> w, int n_out, int rank,
                        int parts, const float* __restrict__ bias, bool gelu_act,
                        const TO* res, int ldres, Peers peers, int nq, int dst,
                        int ldd, float* gout = nullptr, int nvalid = 0) {
  const int ncm = cdiv(n_out, parts);
  const int c0 = parts > 1 ? rank * ncm : 0;
  const int nc = min(ncm, n_out - c0);
  if (nc <= 0) return;
  const int ks = k_slices(ncm);
  const int s = threadIdx.x & (ks - 1);
  const int per_pass = kThreads / ks;
  for (int jb = 0; jb < nc; jb += per_pass) {
    const int j = jb + threadIdx.x / ks;
    const bool live = j < nc;
    const float bj = live ? rnd<TO>(bias[c0 + j]) : 0.f;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (live) {
      const TW* wj = w.p + (size_t)j * w.sj;
#pragma unroll 4
      for (int k = s; k < n_in; k += ks) {
        const float wk = to_f(wj[(size_t)k * w.sk]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(to_f(x[r * ldx + k]), wk, acc[r]);
      }
    }
    for (int o = ks / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
    }
    if (live) {
      const int c = c0 + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & (ks - 1)) != s) continue;   // lane s of the column takes rows r = s (mod ks)
        float v = rnd<TO>(rnd<TO>(acc[r]) + bj);
        if (gelu_act) v = rnd<TO>(gelu(v));
        if (res != nullptr) v = rnd<TO>(v + to_f(res[r * ldres + c]));
        if (gout != nullptr) {
          if (r < nvalid) gout[(size_t)r * ldd + c] = v;
        } else {
#pragma unroll
          for (int q = 0; q < kCluster; ++q)
            if (q < nq) reinterpret_cast<TO*>(peers.base[q] + dst)[r * ldd + c] = from_f<TO>(v);
        }
      }
    }
  }
  DEC_MARK(kMarkProduct);
}

// out = LN(in) * scale + bias over D values, by one warp (in may be out),
// in f32, the result rounded to TO.  The sum and the sum of squares go
// through one shuffle tree together; the variance E[x^2] - mean^2 differs
// from the two-pass one by rounding only (the inputs are O(1) residual
// streams).
template <class TI, class TO>
__device__ inline void ln_row(const TI* in, const float* __restrict__ scale,
                              const float* __restrict__ bias, int D, TO* out) {
  const int lane = threadIdx.x % kWarp;
  float s = 0.f, q = 0.f;
  for (int d = lane; d < D; d += kWarp) {
    const float x = to_f(in[d]);
    s += x;
    q = fmaf(x, x, q);
  }
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(kFull, s, o);
    q += __shfl_xor_sync(kFull, q, o);
  }
  const float mu = s / D;
  const float rstd = 1.f / sqrtf(fmaxf(q / D - mu * mu, 0.f) + kLnEps);
  for (int d = lane; d < D; d += kWarp)
    out[d] = from_f<TO>((to_f(in[d]) - mu) * rstd * scale[d] + bias[d]);
}

// LN of each of the R rows of `in` (row stride D) into `out`, warp r taking
// row r, then a block barrier.
template <int R, class TI, class TO>
__device__ inline void ln_rows(const TI* in, const float* __restrict__ scale,
                               const float* __restrict__ bias, int D, TO* out) {
  const int warp = threadIdx.x / kWarp;
  if (warp < R) ln_row(in + warp * D, scale, bias, D, out + warp * D);
  __syncthreads();
  DEC_MARK(kMarkLn);
}

// The biases and LayerNorm parameters (f32), in shared memory on the on-chip
// path (param_floats order), else in device memory.
struct Prm {
  const float *qkvp1_b, *qkvp2_b, *mlp_b1, *mlp_b2, *lns, *head_b1, *head_ln, *head_b2, *embed_b,
      *ln0;
};

// What one CTA of the body needs.
struct Ctx {
  char* sm;              // this CTA's dynamic shared memory
  Peers peers;           // every CTA's
  Smem L;
  Weights W;
  Prm P;
  const char* wts;       // the flat weights in device memory
  int rank, nrows, D, H, nb, n_pos;
  float scale;
  // the caches in device memory, elements of the trunk type: block b's
  // cache c (0: self K, 1: self V, 2: cross K, 3: cross V) of batch row r,
  // position j at dcache + r * bs + (4 b + c) * cs + j * ps
  void* dcache;
  long long cs, ps, bs;
  int row0;              // the cluster's first batch row
};

// Typed views: a shared-memory buffer at byte offset `off`, a field of the
// flat weights at byte offset `off`.
template <class T>
__device__ __forceinline__ T* sbuf(const Ctx& c, int off) {
  return reinterpret_cast<T*>(c.sm + off);
}
template <class T>
__device__ __forceinline__ const T* wfield(const Ctx& c, long long off) {
  return reinterpret_cast<const T*>(c.wts + off);
}

// What a kernel instantiation fixes at compile time: the trunk type, rows a
// cluster, the path, the kernel, and n_embd, heads and the local matrices
// where the launcher picked the recipe's specialisation (0, or -1 for the
// mask: read from the context at run time).
template <class T_, int R_, bool kOnChip_, bool kWhole_, int kD_, int kH_, int kLocal_>
struct Cfg {
  using T = T_;
  static constexpr int R = R_;
  static constexpr bool kOnChip = kOnChip_, kWhole = kWhole_;
  __device__ static int D(const Ctx& c) { return kD_ ? kD_ : c.D; }
  __device__ static int H(const Ctx& c) { return kH_ ? kH_ : c.H; }
  __device__ static int local(const Ctx& c) { return kLocal_ >= 0 ? kLocal_ : c.L.local; }
  __device__ static int pairs(const Ctx& c) { return kH_ ? cdiv(R_ * kH_, kCluster) : c.L.pairs; }
};

// A stage's product: split over the cluster (ends at a cluster barrier) or
// local, all columns in this CTA (ends at a block barrier).  Weights TW
// (the trunk's or the head's f32), output TO at byte offset dst.
template <class K, class TW, class TO, class TX>
__device__ inline void stage(const Ctx& c, int mat, const TW* chip, const TW* g, int ldw,
                             const TX* x, int n_in, int n_out, const float* bias, bool gelu_act,
                             const TO* res, int dst) {
  constexpr int R = K::R;
  constexpr bool kOnChip = K::kOnChip;
  const int parts = kOnChip ? parts_of(K::local(c), mat) : kCluster;
  const bool local = parts == 1;
  Peers to = c.peers;
  if (local) to.base[0] = c.sm;
  product<R>(x, n_in, n_in, view<kOnChip>(chip, g, ldw, n_in, n_out, c.rank, parts), n_out,
             c.rank, parts, bias, gelu_act, res, n_out, to, local ? 1 : kCluster, dst, n_out);
  if (local) {
    __syncthreads();
    DEC_MARK(kMarkBlockBar);
  } else {
    cluster_sync();
  }
}

// The attention of block b at position i over every (row, head) pair this
// CTA owns, by the whole CTA:
//   out[c] = sum_j softmax_j(scale q . K[j]) V[j][c]   over j = 0 .. i
// (the plain version's -1e9 weight after position i is exactly 0 in f32, so
// those keys are skipped), in f32, each head's output rounded to T and
// written into every CTA's ya (self-attention) or yb (cross-attention).
// `self` takes q, k, v from qkv, else q from q2 and k, v from kv2.  The
// current key and value are stored into the caches at i and read from
// shared memory.  A group of lanes takes one key's score, then a thread a
// column over a run of keys, so the cache loads of a pass are in flight at
// once.
template <class K>
__device__ void attend(const Ctx& c, int b, int i, bool self) {
  using T = typename K::T;
  const int D = K::D(c), H = K::H(c), Dh = D / H;
  const int n = i + 1, P = K::pairs(c), tid = threadIdx.x;
  float* S = sbuf<float>(c, c.L.scores);
  float* red = sbuf<float>(c, c.L.red);
  T* dcache = static_cast<T*>(c.dcache);
  const long long kv = (long long)(4 * b + (self ? 0 : 2)) * c.cs;   // this K cache; V after it
  // row r's current key at r * ldcur
  const T* cur0 = self ? sbuf<T>(c, c.L.qkv) + D : sbuf<T>(c, c.L.kv2);
  const int ldcur = self ? 3 * D : 2 * D;
  const T* q0 = sbuf<T>(c, self ? c.L.qkv : c.L.q2);
  const int ldq = self ? 3 * D : D;
  const bool vec = Dh % 4 == 0 && c.ps % 4 == 0 && c.cs % 4 == 0 && c.bs % 4 == 0 &&
                   reinterpret_cast<size_t>(dcache) % (4 * sizeof(T)) == 0;
  // the current keys and values into the caches
  for (int t = tid; t < P * Dh; t += kThreads) {
    const int lp = t / Dh, d = t % Dh, pr = lp * kCluster + c.rank, r = pr / H, h = pr % H;
    if (r >= c.nrows) continue;
    T* ki = dcache + (size_t)(c.row0 + r) * c.bs + kv + (size_t)i * c.ps + h * Dh;
    const T* kc = cur0 + r * ldcur + h * Dh;
    ki[d] = kc[d];
    ki[c.cs + d] = kc[D + d];
  }
  const int warp = tid / kWarp, lane = tid % kWarp;
  // P.V's split: thread t takes column t % Dh of its pair over run s of the
  // keys.  Where that is one item a thread, its first kAhead values are
  // loaded now, so that their latency overlaps the scores and the softmax.
  constexpr int kAhead = 16;
  const int runs = max(1, kThreads / (P * Dh));
  const int run = cdiv(n, runs);
  const bool one_item = P * Dh * runs <= kThreads;
  float ahead[kAhead];
  if (one_item && tid < P * Dh * runs) {
    const int lp = tid / (Dh * runs), s = (tid / Dh) % runs, cc = tid % Dh;
    const int pr = lp * kCluster + c.rank, r = pr / H, h = pr % H;
    const T* V = dcache + (size_t)(c.row0 + (r < c.nrows ? r : 0)) * c.bs + kv + c.cs + h * Dh +
                 cc;
    const int j0 = s * run, jend = r < c.nrows ? min(min(n, j0 + run), i) : j0;
#pragma unroll
    for (int m = 0; m < kAhead; ++m)
      ahead[m] = j0 + m < jend ? ldcg_f(V + (size_t)(j0 + m) * c.ps) : 0.f;
  }
  // scores: a group of kG lanes a key (neighbouring lanes on neighbouring
  // addresses of its row; 8, fewer where there are many keys), summed by
  // shuffles; up to four keys a group, in flight together
  int kG = 8;
  while (kG > 1 && P * n * kG > 4 * kThreads) kG >>= 1;
  const int g = tid / kG, gl = tid % kG;
#pragma unroll 4
  for (int t0 = 0; t0 < P * n; t0 += kThreads / kG) {
    const int t = t0 + g;
    const int lp = P == 1 ? 0 : t / n, j = P == 1 ? t : t % n;
    const int pr = lp * kCluster + c.rank, r = pr / H, h = pr % H;
    const bool ok = t < P * n && r < c.nrows;
    float dot = 0.f;
    if (ok) {
      const T* q = q0 + r * ldq + h * Dh;
      const T* kj = j == i ? cur0 + r * ldcur + h * Dh
                           : dcache + (size_t)(c.row0 + r) * c.bs + kv + (size_t)j * c.ps +
                                 h * Dh;
      if (j < i && vec) {
        for (int d = 4 * gl; d < Dh; d += 4 * kG) {
          const float4 k4 = ldcg4(kj + d);
          dot = fmaf(to_f(q[d]), k4.x, dot);
          dot = fmaf(to_f(q[d + 1]), k4.y, dot);
          dot = fmaf(to_f(q[d + 2]), k4.z, dot);
          dot = fmaf(to_f(q[d + 3]), k4.w, dot);
        }
      } else {
        for (int d = gl; d < Dh; d += kG)
          dot = fmaf(to_f(q[d]), j < i ? ldcg_f(kj + d) : to_f(kj[d]), dot);
      }
    }
    for (int o = kG / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if (ok && gl == 0) S[lp * c.n_pos + j] = dot * c.scale;
  }
  __syncthreads();
  if (P == 1) {
    // one pair (the whole decode's two rows of two heads): thread j takes
    // key j, and the softmax reduces over the CTA
    if (c.rank / H < c.nrows) {
      const float sc = tid < n ? S[tid] : -INFINITY;
      const float wm = warp_max(sc);
      if (lane == 0) red[warp] = wm;
      __syncthreads();
      float m = red[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
      const float e = tid < n ? expf(sc - m) : 0.f;
      const float ws = warp_sum(e);
      if (lane == 0) red[kWarps + warp] = ws;
      __syncthreads();
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[kWarps + w];
      if (tid < n) S[tid] = e / sum;
    }
    __syncthreads();
  } else {
    // a warp a pair
    for (int lp = warp; lp < P; lp += kWarps) {
      if ((lp * kCluster + c.rank) / H >= c.nrows) continue;
      float* s = S + lp * c.n_pos;
      float m = -INFINITY;
      for (int j = lane; j < n; j += kWarp) m = fmaxf(m, s[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += kWarp) {
        const float e = expf(s[j] - m);
        s[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < n; j += kWarp) s[j] /= sum;
    }
    __syncthreads();
  }
  // P.V
  for (int t = tid; t < P * Dh * runs; t += kThreads) {
    const int lp = t / (Dh * runs), s = (t / Dh) % runs, cc = t % Dh;
    const int pr = lp * kCluster + c.rank, r = pr / H, h = pr % H;
    float acc = 0.f;
    if (r < c.nrows) {
      const float* pj = S + lp * c.n_pos;
      const T* V = dcache + (size_t)(c.row0 + r) * c.bs + kv + c.cs + h * Dh + cc;
      const int j0 = s * run, j1 = min(n, j0 + run), jend = min(j1, i);
      int j = j0;
      if (one_item) {
#pragma unroll
        for (int m = 0; m < kAhead; ++m)
          if (j0 + m < jend) acc = fmaf(pj[j0 + m], ahead[m], acc);
        j = max(j0, min(jend, j0 + kAhead));
      }
#pragma unroll 8
      for (; j < jend; ++j) acc = fmaf(pj[j], ldcg_f(V + (size_t)j * c.ps), acc);
      if (j1 == n && j0 <= i) acc = fmaf(pj[i], to_f(cur0[r * ldcur + D + h * Dh + cc]), acc);
    }
    red[t] = acc;
  }
  __syncthreads();
  for (int t = tid; t < P * Dh; t += kThreads) {
    const int lp = t / Dh, cc = t % Dh, pr = lp * kCluster + c.rank, r = pr / H, h = pr % H;
    if (r >= c.nrows) continue;
    float o = 0.f;
    for (int s = 0; s < runs; ++s) o += red[(lp * runs + s) * Dh + cc];
    const T ov = from_f<T>(o);
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      reinterpret_cast<T*>(c.peers.base[q] + (self ? c.L.ya : c.L.yb))[r * D + h * Dh + cc] = ov;
  }
  DEC_MARK(kMarkAttend);
}

// One decoder block at position i, from x (in every CTA) to x.  Stage 4
// also lands the cross-attention query in q2: the whole decode copies this
// CTA's columns of it from q2l (computed in its prologue), a decode step
// computes them from rep.  Returns with x ready in this CTA.
template <class K>
__device__ void decoder_block(const Ctx& c, int b, int i) {
  using T = typename K::T;
  constexpr int R = K::R;
  constexpr bool kOnChip = K::kOnChip, kWhole = K::kWhole;
  const int D = K::D(c);
  const char* wb = c.sm + c.L.w_blk + b * c.L.blk;
  auto chip = [&](int off) { return reinterpret_cast<const T*>(wb + off); };
  const T* w1 = wfield<T>(c, c.W.qkvp1_w) + (size_t)b * D * 4 * D;
  const T* w2 = wfield<T>(c, c.W.qkvp2_w) + (size_t)b * D * 4 * D;
  const T* m1 = wfield<T>(c, c.W.mlp_w1) + (size_t)b * D * D;
  const T* m2 = wfield<T>(c, c.W.mlp_w2) + (size_t)b * D * D;
  const float* b1 = c.P.qkvp1_b + b * 4 * D;
  const float* b2 = c.P.qkvp2_b + b * 4 * D;
  const float* lns = c.P.lns + b * 6 * D;
  const T* none = nullptr;

  // 1: q, k, v of the self-attention
  product<R>(sbuf<T>(c, c.L.x), D, D,
             view<kOnChip>(chip(c.L.o_w1), w1, 4 * D, D, 3 * D, c.rank, kCluster), 3 * D, c.rank,
             kCluster, b1, false, none, 0, c.peers, kCluster, c.L.qkv, 3 * D);
  cluster_sync();
  // 2: causal self-attention over the action stream
  attend<K>(c, b, i, true);
  cluster_sync();
  // 3: its projection and the residual
  stage<K>(c, kP1, chip(c.L.o_p1), w1 + 3 * D, 4 * D, sbuf<T>(c, c.L.ya), D, D, b1 + 3 * D,
           false, sbuf<T>(c, c.L.x), c.L.t1);
  ln_rows<R>(sbuf<T>(c, c.L.t1), lns, lns + D, D, sbuf<T>(c, c.L.h1));
  // 4: cross-attention keys and values from h1, and its query
  product<R>(sbuf<T>(c, c.L.h1), D, D,
             view<kOnChip>(chip(c.L.o_kv2), w2 + D, 4 * D, D, 2 * D, c.rank, kCluster), 2 * D,
             c.rank, kCluster, b2 + D, false, none, 0, c.peers, kCluster, c.L.kv2, 2 * D);
  if (kWhole) {
    const int ncm = cdiv(D, kCluster), c0 = c.rank * ncm, nc = min(ncm, D - c0);
    const float* q2l = sbuf<float>(c, c.L.q2l) + b * R * ncm;
    for (int t = threadIdx.x; t < R * nc; t += kThreads) {
      const int r = t / nc, j = t % nc;
      const T v = from_f<T>(q2l[r * ncm + j]);   // a value of T already: exact
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        reinterpret_cast<T*>(c.peers.base[q] + c.L.q2)[r * D + c0 + j] = v;
    }
  } else {
    product<R>(sbuf<T>(c, c.L.rep), D, D,
               view<kOnChip>(chip(c.L.o_q2), w2, 4 * D, D, D, c.rank, kCluster), D, c.rank,
               kCluster, b2, false, none, 0, c.peers, kCluster, c.L.q2, D);
  }
  cluster_sync();
  // 5: cross-attention, query from the encoder rep, K/V from h1
  attend<K>(c, b, i, false);
  cluster_sync();
  // 6: its projection and the rep residual
  stage<K>(c, kP2, chip(c.L.o_p2), w2 + 3 * D, 4 * D, sbuf<T>(c, c.L.yb), D, D, b2 + 3 * D,
           false, sbuf<T>(c, c.L.rep), c.L.t2);
  ln_rows<R>(sbuf<T>(c, c.L.t2), lns + 2 * D, lns + 3 * D, D, sbuf<T>(c, c.L.h2));
  // 7, 8: the MLP and the block's output
  stage<K>(c, kM1, chip(c.L.o_m1), m1, D, sbuf<T>(c, c.L.h2), D, D, c.P.mlp_b1 + b * D, true,
           none, c.L.u);
  stage<K>(c, kM2, chip(c.L.o_m2), m2, D, sbuf<T>(c, c.L.u), D, D, c.P.mlp_b2 + b * D, false,
           sbuf<T>(c, c.L.h2), c.L.t3);
  ln_rows<R>(sbuf<T>(c, c.L.t3), lns + 4 * D, lns + 5 * D, D, sbuf<T>(c, c.L.x));
}

// The blocks and the head's first half at position i: from x to hh =
// LN(gelu(x . H1 + b)) in every CTA, the head in f32.
template <class K>
__device__ void decoder_position(const Ctx& c, int i) {
  using T = typename K::T;
  const int D = K::D(c);
  const float* none = nullptr;
  for (int b = 0; b < c.nb; ++b) decoder_block<K>(c, b, i);
  stage<K>(c, kH1, sbuf<float>(c, c.L.w_h1), wfield<float>(c, c.W.head_w1), D,
           sbuf<T>(c, c.L.x), D, D, c.P.head_b1, true, none, c.L.hv);
  ln_rows<K::R>(sbuf<float>(c, c.L.hv), c.P.head_ln, c.P.head_ln + D, D, sbuf<float>(c, c.L.hh));
}

// On the on-chip path: copy this CTA's row of the weight image (the flat
// weights' `bytes`, rounded up to whole 16-byte words, are followed by one
// row a CTA: its weight parts and parameters as they lie in shared memory,
// everything before x; decode_layout.cuh::weight_image) into shared memory
// by 16-byte cp.async.  The caller commits and waits.
__device__ inline void copy_image(const Ctx& c, long long bytes) {
  const char* row = c.wts + 16 * ((bytes + 15) / 16) + (size_t)c.rank * c.L.x;
  for (int t = threadIdx.x; t < c.L.x / 16; t += kThreads) cp_async16(c.sm + 16 * t, row + 16 * t);
}

// The CTA's context: shared memory, peers, rank, the cluster's rows and
// where the parameters are.
__device__ inline Ctx make_ctx(char* sm, const Smem& L, const Weights& W, const char* wts,
                               int B, int R, int D, int H, int nb, int adim, int n_pos) {
  Ctx c;
  cg::cluster_group cl = cg::this_cluster();
  c.sm = sm;
  c.rank = (int)cl.block_rank();
  for (int q = 0; q < kCluster; ++q) {
    c.peers.base[q] = cl.map_shared_rank(sm, q);
  }
  c.L = L;
  c.W = W;
  c.wts = wts;
  c.row0 = (int)(blockIdx.x / kCluster) * R;
  c.nrows = min(R, B - c.row0);
  c.D = D;
  c.H = H;
  c.nb = nb;
  c.n_pos = n_pos;
  c.scale = 1.f / sqrtf((float)(D / H));
  c.dcache = nullptr;
  c.cs = c.ps = c.bs = 0;
  if (L.prm >= 0) {
    const float* p = reinterpret_cast<const float*>(sm + L.prm);
    c.P.qkvp1_b = p;  p += nb * 4 * D;
    c.P.qkvp2_b = p;  p += nb * 4 * D;
    c.P.mlp_b1 = p;   p += nb * D;
    c.P.mlp_b2 = p;   p += nb * D;
    c.P.lns = p;      p += nb * 6 * D;
    c.P.head_b1 = p;  p += D;
    c.P.head_ln = p;  p += 2 * D;
    c.P.head_b2 = p;  p += adim;
    c.P.embed_b = p;  p += D;
    c.P.ln0 = p;
  } else {
    const auto f = [&](long long off) { return reinterpret_cast<const float*>(wts + off); };
    c.P = Prm{f(W.qkvp1_b), f(W.qkvp2_b), f(W.mlp_b1), f(W.mlp_b2), f(W.lns),
              f(W.head_b1), f(W.head_ln), f(W.head_b2), f(W.embed_b), f(W.ln0)};
  }
  return c;
}

// Let a kernel take `bytes` of dynamic shared memory (once a process).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* done) {
  if (*done >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

// Launch `kernel` on `clusters` clusters of kCluster CTAs.
template <typename K, typename... Args>
inline cudaError_t launch_clusters(K kernel, int clusters, int smem_bytes, cudaStream_t stream,
                                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace dec
