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
// as the attention kernel and the plain path round it.  f32 throughout.
//
// What bounds it.  A row needs about 2 A (10 n_block D^2 + D^2) flops of
// matrix-vector products plus 8 n_block D A (A + 1) / 2 of attention (22.7
// MFLOP at A = 101, D = 64, 2 blocks), against the weights (355 KB) read
// once and a few KB of inputs and outputs per row: operations bound it, at
// 2.7 us for 8 rows.  But the 101 positions depend on each other and each is
// some 30 dependent stages of 64-deep dot products, reductions and block
// barriers, so latency, not throughput, sets its time.  This first version
// is simple:
//
//  - one block of 256 threads per batch row, looping over the positions;
//    the few D-vectors of a position live in shared memory, and stages are
//    separated by __syncthreads;
//  - a matrix-vector product gives each thread one output column (adjacent
//    threads read adjacent weights) and, where the outputs are fewer than the
//    threads, a slice of the inputs, summed in shared memory;
//  - weights stay in device memory, where every block reads them through L2;
//  - the K/V caches (4 n_block A D f32 a row: 207 KB at DCML, too much for
//    one block's shared memory beside the rest) live in a device-memory
//    workspace the wrapper allocates; a block writes position i's keys and
//    values there and reads them back after a barrier, through L2.  The
//    cache pointer is neither const nor __restrict__, so those reads never
//    take the non-coherent read-only path.
//
// Limits (the wrapper checks them): D <= kMaxD, A <= kMaxA, heads <=
// kMaxHeads, action_dim <= kMaxAdim, D a multiple of the heads.  The launcher
// returns the launch's cudaError_t; it neither allocates nor synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxD = 256;
constexpr int kMaxA = 256;
constexpr int kMaxHeads = 8;
constexpr int kMaxAdim = 64;
constexpr int kRed = 3 * kMaxD > kThreads ? 3 * kMaxD : kThreads;  // partial sums
constexpr float kMaskValue = -1e10f;   // ops/distributions.py MASK_VALUE
constexpr float kLnEps = 1e-6f;        // flax LayerNorm
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr unsigned kFull = 0xffffffffu;

// Offsets into the flat weight buffer: the fields of ops/ar_decode.py's
// ARDecodeWeights in order, each a contiguous array of the shape given there.
struct Layout {
  long long embed_start, embed_act, ln0, qkvp1_w, qkvp1_b, qkvp2_w, qkvp2_b, mlp_w1, mlp_b1,
      mlp_w2, mlp_b2, lns, head_w1, head_b1, head_ln, head_w2, head_b2, std_row, total;
};

__host__ __device__ inline Layout weight_layout(long long D, long long nb, long long adim) {
  Layout l;
  long long o = 0;
  l.embed_start = o; o += D;
  l.embed_act = o;   o += adim * D;
  l.ln0 = o;         o += 2 * D;
  l.qkvp1_w = o;     o += nb * D * 4 * D;
  l.qkvp1_b = o;     o += nb * 4 * D;
  l.qkvp2_w = o;     o += nb * D * 4 * D;
  l.qkvp2_b = o;     o += nb * 4 * D;
  l.mlp_w1 = o;      o += nb * D * D;
  l.mlp_b1 = o;      o += nb * D;
  l.mlp_w2 = o;      o += nb * D * D;
  l.mlp_b2 = o;      o += nb * D;
  l.lns = o;         o += nb * 6 * D;
  l.head_w1 = o;     o += D * D;
  l.head_b1 = o;     o += D;
  l.head_ln = o;     o += 2 * D;
  l.head_w2 = o;     o += D * adim;
  l.head_b2 = o;     o += adim;
  l.std_row = o;     o += adim;
  l.total = o;
  return l;
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

// out[j] = act(bias[j] + sum_k x[k] W[k * ldw + j]) (+ res[j]) for j < n_out,
// with x, res and out in shared memory.  Thread t takes column t % n_out and
// slice t / n_out of the n_in terms (S slices, 1 when the columns fill the
// block); the partial sums meet in red.  Called by the whole block; ends with
// it synchronised.
__device__ void matvec(const float* x, int n_in, const float* __restrict__ W, int ldw,
                       const float* __restrict__ bias, const float* res, bool gelu_act,
                       int n_out, float* out, float* red) {
  const int S = n_out >= kThreads ? 1 : min(kThreads / n_out, n_in);
  const int chunk = (n_in + S - 1) / S;
  for (int t = threadIdx.x; t < S * n_out; t += kThreads) {
    const int j = t % n_out;
    const int s = t / n_out;
    const int k_end = min(n_in, (s + 1) * chunk);
    float acc = 0.f;
    for (int k = s * chunk; k < k_end; ++k) acc = fmaf(x[k], W[(size_t)k * ldw + j], acc);
    red[t] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += red[s * n_out + j];
    acc += bias[j];
    if (gelu_act) acc = gelu(acc);
    if (res != nullptr) acc += res[j];
    out[j] = acc;
  }
  __syncthreads();
}

// out = LN(in) * scale + bias over D values in shared memory, by warp 0.
__device__ void layer_norm(const float* in, const float* __restrict__ scale,
                           const float* __restrict__ bias, int D, float* out) {
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    float s = 0.f;
    for (int d = lane; d < D; d += kWarp) s += in[d];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += kWarp) {
      const float c = in[d] - mu;
      v = fmaf(c, c, v);
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / D + kLnEps);
    for (int d = lane; d < D; d += kWarp) out[d] = (in[d] - mu) * rstd * scale[d] + bias[d];
  }
  __syncthreads();
}

// One query q (D values, H heads of Dh) over cache rows 0 .. n - 1 of K and V
// ((A, D) row-major in the workspace):
//   out[h Dh + c] = sum_j softmax_j(scale q_h . K[j]_h) V[j][h Dh + c].
// The plain version masks the keys after position n - 1 with -1e9, whose
// weight exp(-1e9 - max) is exactly 0 in f32, so they are skipped here.
__device__ void attend(const float* q, const float* K, const float* V, int n, int D, int H,
                       float scale, float* p, float* red, float* out) {
  const int Dh = D / H;
  for (int t = threadIdx.x; t < H * n; t += kThreads) {
    const int h = t / n;
    const int j = t - h * n;
    const float* kj = K + (size_t)j * D + h * Dh;
    const float* qh = q + h * Dh;
    float dot = 0.f;
    for (int d = 0; d < Dh; ++d) dot = fmaf(qh[d], kj[d], dot);
    p[h * kMaxA + j] = dot * scale;
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int h = warp; h < H; h += kThreads / kWarp) {
    float* ph = p + h * kMaxA;
    float m = -INFINITY;
    for (int j = lane; j < n; j += kWarp) m = fmaxf(m, ph[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += kWarp) {
      const float e = expf(ph[j] - m);
      ph[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += kWarp) ph[j] /= sum;
  }
  __syncthreads();
  // P.V: thread t takes output column t % D and slice t / D of the n keys
  const int S = max(1, min(kThreads / D, n));
  const int chunk = (n + S - 1) / S;
  for (int t = threadIdx.x; t < S * D; t += kThreads) {
    const int c = t % D;
    const int s = t / D;
    const float* ph = p + (c / Dh) * kMaxA;
    const int j_end = min(n, (s + 1) * chunk);
    float acc = 0.f;
    for (int j = s * chunk; j < j_end; ++j) acc = fmaf(ph[j], V[(size_t)j * D + c], acc);
    red[t] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += red[s * D + c];
    out[c] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ar_decode_kernel(const float* __restrict__ obs_rep, const float* __restrict__ gumbel,
                 const float* __restrict__ normal, const float* __restrict__ avail,
                 const float* __restrict__ wts, float* cache, float* __restrict__ act,
                 float* __restrict__ logp, int A, int D, int H, int nb, int adim, int nd,
                 int n_rows) {
  __shared__ float x_s[kMaxD];        // the block stream
  __shared__ float rep_s[kMaxD];      // encoder rep at position i
  __shared__ float h_s[kMaxD];        // post-LN1, then post-LN2 stream
  __shared__ float y_s[kMaxD];        // attention output, MLP hidden
  __shared__ float t_s[kMaxD];        // pre-LN sums
  __shared__ float qkv_s[3 * kMaxD];  // projections
  __shared__ float p_s[kMaxHeads * kMaxA];
  __shared__ float red_s[kRed];
  __shared__ float logit_s[kMaxAdim];
  __shared__ float masked_s[kMaxAdim];
  __shared__ int idx_s;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const Layout L = weight_layout(D, nb, adim);
  const float scale = 1.f / sqrtf((float)(D / H));
  float* crow = cache + (size_t)row * nb * 4 * A * D;  // (nb, 4, A, D): k1, v1, k2, v2

  for (int i = 0; i < A; ++i) {
    // ---- embed the previous action (the start token at i = 0), GELU, LN0
    const float* e = i == 0 ? wts + L.embed_start : wts + L.embed_act + (size_t)idx_s * D;
    const float* rep_i = obs_rep + ((size_t)row * A + i) * D;
    for (int d = tid; d < D; d += kThreads) {
      t_s[d] = gelu(e[d]);
      rep_s[d] = rep_i[d];
    }
    __syncthreads();
    layer_norm(t_s, wts + L.ln0, wts + L.ln0 + D, D, x_s);

    for (int b = 0; b < nb; ++b) {
      const float* w1 = wts + L.qkvp1_w + (size_t)b * D * 4 * D;
      const float* b1 = wts + L.qkvp1_b + (size_t)b * 4 * D;
      const float* w2 = wts + L.qkvp2_w + (size_t)b * D * 4 * D;
      const float* b2 = wts + L.qkvp2_b + (size_t)b * 4 * D;
      const float* lns = wts + L.lns + (size_t)b * 6 * D;
      float* k1 = crow + (size_t)(b * 4 + 0) * A * D;
      float* v1 = crow + (size_t)(b * 4 + 1) * A * D;
      float* k2 = crow + (size_t)(b * 4 + 2) * A * D;
      float* v2 = crow + (size_t)(b * 4 + 3) * A * D;

      // ---- causal self-attention over the action stream
      matvec(x_s, D, w1, 4 * D, b1, nullptr, false, 3 * D, qkv_s, red_s);
      for (int d = tid; d < D; d += kThreads) {
        k1[(size_t)i * D + d] = qkv_s[D + d];
        v1[(size_t)i * D + d] = qkv_s[2 * D + d];
      }
      __syncthreads();
      attend(qkv_s, k1, v1, i + 1, D, H, scale, p_s, red_s, y_s);
      matvec(y_s, D, w1 + 3 * D, 4 * D, b1 + 3 * D, x_s, false, D, t_s, red_s);
      layer_norm(t_s, lns, lns + D, D, h_s);

      // ---- cross-attention: query from the encoder rep, K/V from h
      matvec(rep_s, D, w2, 4 * D, b2, nullptr, false, D, qkv_s, red_s);
      matvec(h_s, D, w2 + D, 4 * D, b2 + D, nullptr, false, 2 * D, qkv_s + D, red_s);
      for (int d = tid; d < D; d += kThreads) {
        k2[(size_t)i * D + d] = qkv_s[D + d];
        v2[(size_t)i * D + d] = qkv_s[2 * D + d];
      }
      __syncthreads();
      attend(qkv_s, k2, v2, i + 1, D, H, scale, p_s, red_s, y_s);
      matvec(y_s, D, w2 + 3 * D, 4 * D, b2 + 3 * D, rep_s, false, D, t_s, red_s);
      layer_norm(t_s, lns + 2 * D, lns + 3 * D, D, h_s);

      // ---- MLP and the block's output
      matvec(h_s, D, wts + L.mlp_w1 + (size_t)b * D * D, D, wts + L.mlp_b1 + (size_t)b * D,
             nullptr, true, D, y_s, red_s);
      matvec(y_s, D, wts + L.mlp_w2 + (size_t)b * D * D, D, wts + L.mlp_b2 + (size_t)b * D,
             h_s, false, D, t_s, red_s);
      layer_norm(t_s, lns + 4 * D, lns + 5 * D, D, x_s);
    }

    // ---- the f32 head
    matvec(x_s, D, wts + L.head_w1, D, wts + L.head_b1, nullptr, true, D, t_s, red_s);
    layer_norm(t_s, wts + L.head_ln, wts + L.head_ln + D, D, y_s);
    matvec(y_s, D, wts + L.head_w2, adim, wts + L.head_b2, nullptr, false, adim, logit_s,
           red_s);

    // ---- sampling: Gumbel-argmax and its log-prob, or the Gaussian tail
    if (tid == 0) {
      const size_t at = ((size_t)row * A + i) * adim;
      int best = 0;
      float best_v = -INFINITY;
      float m = -INFINITY;
      for (int a = 0; a < adim; ++a) {
        const float ma = (avail != nullptr && avail[at + a] == 0.f) ? kMaskValue : logit_s[a];
        masked_s[a] = ma;
        const float v = ma + gumbel[at + a];
        if (v > best_v) {  // strict: the lowest index wins a tie
          best_v = v;
          best = a;
        }
        m = fmaxf(m, ma);
      }
      float sum = 0.f;
      for (int a = 0; a < adim; ++a) sum += expf(masked_s[a] - m);
      float lp = (masked_s[best] - m) - logf(sum);
      float out = (float)best;
      if (i >= nd) {
        const float mean = logit_s[adim - 1];
        const float sd = wts[L.std_row + adim - 1];
        const float z = normal[((size_t)row * n_rows + (i - nd)) * adim + adim - 1];
        out = mean + sd * z;
        const float diff = out - mean;
        lp = -(diff * diff) / (2.f * (sd * sd)) - logf(sd) - kHalfLog2Pi;
      }
      act[(size_t)row * A + i] = out;
      logp[(size_t)row * A + i] = lp;
      idx_s = best;  // the next feed is the discrete one-hot, after a tail agent too
    }
    __syncthreads();
  }
}

}  // namespace

// obs_rep (B, A, D), gumbel (B, A, adim), normal (B, n_rows, adim), avail
// (B, A, adim) or null (all available), weights: the flat ARDecodeWeights,
// cache: a (B, nb, 4, A, D) workspace, act and logp (B, A); all f32 and
// contiguous.
extern "C" cudaError_t mat_ar_decode(const void* obs_rep, const void* gumbel, const void* normal,
                                     const void* avail, const void* weights, void* cache,
                                     void* act, void* logp, int B, int A, int D, int H, int nb,
                                     int adim, int nd, int n_rows, void* stream) {
  if (B < 1 || A < 1 || A > kMaxA || D < 1 || D > kMaxD || H < 1 || H > kMaxHeads ||
      D % H != 0 || nb < 1 || adim < 1 || adim > kMaxAdim || nd < 0 || nd > A ||
      n_rows < (A - nd > 1 ? A - nd : 1)) {
    return cudaErrorInvalidValue;
  }
  ar_decode_kernel<<<(unsigned)B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs_rep), static_cast<const float*>(gumbel),
      static_cast<const float*>(normal), static_cast<const float*>(avail),
      static_cast<const float*>(weights), static_cast<float*>(cache), static_cast<float*>(act),
      static_cast<float*>(logp), A, D, H, nb, adim, nd, n_rows);
  return cudaGetLastError();
}

// The number of f32 values in the flat weight buffer, and the limits the
// wrapper checks against, so the two sides cannot drift apart.
extern "C" long long mat_ar_decode_weight_count(int D, int nb, int adim) {
  return weight_layout(D, nb, adim).total;
}
extern "C" int mat_ar_decode_max_d() { return kMaxD; }
extern "C" int mat_ar_decode_max_a() { return kMaxA; }
extern "C" int mat_ar_decode_max_heads() { return kMaxHeads; }
extern "C" int mat_ar_decode_max_adim() { return kMaxAdim; }
