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
// (the plain version's -1e9 weight is exactly 0).  f32 throughout.
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
// position is some 30 dependent stages (matrix-vector products, reductions,
// block barriers), each a few L2 latencies deep, and every launch pays the
// launch latency: latency, not throughput, sets its time.  The design is the
// simple one of one position of ar_decode.cu:
//
//  - one block of 256 threads per batch row; the few D-vectors of the
//    position live in shared memory and stages are separated by __syncthreads;
//  - a matrix-vector product gives each thread one output column (adjacent
//    threads read adjacent weights) and, where the outputs are fewer than the
//    threads, a slice of the inputs, summed in shared memory;
//  - weights stay in device memory and are read through L2 by every block;
//  - the caches live in device memory (the wrapper's workspace); a block
//    writes position i's keys and values and reads them back after a barrier
//    (the cache pointer is neither const nor __restrict__, so those reads
//    never take the non-coherent read-only path).
//
// Layout: the wrapper's workspace is batch-major, so a row's cached keys are
// one contiguous run of (i + 1) D values.  The cache-layout probe
// (csrc/cache_layout_probe.cu, mat_dcml_tpu_torch/probes/cache_layout.py)
// timed both layouts on an H100 (700 W): the per-position store and the
// attention over keys 0 .. i cost the same within 0.3% in either layout at
// B = 8 and 128, because latency, not the access pattern, sets their time; so
// the layout is kept for the contiguous run, not for a measured gain.  The
// row softmax stays a warp-shuffle reduction inside the block (the probe's
// shared-memory version was faster only as a kernel of its own).
//
// Limits (the wrapper checks them): D <= kMaxD, i < L <= kMaxL, heads <=
// kMaxHeads, in_dim <= kMaxIn, adim <= kMaxAdim, D a multiple of the heads.
// The launcher returns the launch's cudaError_t; it neither allocates nor
// synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxD = 256;
constexpr int kMaxL = 256;
constexpr int kMaxHeads = 8;
constexpr int kMaxIn = 257;
constexpr int kMaxAdim = 256;
constexpr int kRed = 3 * kMaxD > kThreads ? 3 * kMaxD : kThreads;  // partial sums
constexpr float kLnEps = 1e-6f;  // flax LayerNorm
constexpr unsigned kFull = 0xffffffffu;

// Offsets into the flat weight buffer: the fields of ops/decode_step.py's
// DecodeStepWeights in order, each a contiguous array of the shape given there.
struct Layout {
  long long embed_w, embed_b, ln0, qkvp1_w, qkvp1_b, qkvp2_w, qkvp2_b, mlp_w1, mlp_b1, mlp_w2,
      mlp_b2, lns, head_w1, head_b1, head_ln, head_w2, head_b2, total;
};

__host__ __device__ inline Layout weight_layout(long long in_dim, long long D, long long nb,
                                                long long adim) {
  Layout l;
  long long o = 0;
  l.embed_w = o;  o += in_dim * D;
  l.embed_b = o;  o += D;
  l.ln0 = o;      o += 2 * D;
  l.qkvp1_w = o;  o += nb * D * 4 * D;
  l.qkvp1_b = o;  o += nb * 4 * D;
  l.qkvp2_w = o;  o += nb * D * 4 * D;
  l.qkvp2_b = o;  o += nb * 4 * D;
  l.mlp_w1 = o;   o += nb * D * D;
  l.mlp_b1 = o;   o += nb * D;
  l.mlp_w2 = o;   o += nb * D * D;
  l.mlp_b2 = o;   o += nb * D;
  l.lns = o;      o += nb * 6 * D;
  l.head_w1 = o;  o += D * D;
  l.head_b1 = o;  o += D;
  l.head_ln = o;  o += 2 * D;
  l.head_w2 = o;  o += D * adim;
  l.head_b2 = o;  o += adim;
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
// with x and res in shared memory; out may be shared or global.  Thread t takes
// column t % n_out and slice t / n_out of the n_in terms (S slices, 1 when the
// columns fill the block); the partial sums meet in red.  Called by the whole
// block; ends with it synchronised.
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
#pragma unroll 4
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

// One query q (D values, H heads of Dh) over cached positions 0 .. n - 1 of K
// and V, position j of a row at K + j * ps:
//   out[h Dh + c] = sum_j softmax_j(scale q_h . K[j]_h) V[j][h Dh + c].
__device__ void attend(const float* q, const float* K, const float* V, long long ps, int n,
                       int D, int H, float scale, float* p, float* red, float* out) {
  const int Dh = D / H;
  for (int t = threadIdx.x; t < H * n; t += kThreads) {
    const int h = t / n;
    const int j = t - h * n;
    const float* kj = K + (size_t)j * ps + h * Dh;
    const float* qh = q + h * Dh;
    float dot = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) dot = fmaf(qh[d], kj[d], dot);
    p[h * kMaxL + j] = dot * scale;
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int h = warp; h < H; h += kThreads / kWarp) {
    float* ph = p + h * kMaxL;
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
    const float* ph = p + (c / Dh) * kMaxL;
    const int j_end = min(n, (s + 1) * chunk);
    float acc = 0.f;
#pragma unroll 4
    for (int j = s * chunk; j < j_end; ++j) acc = fmaf(ph[j], V[(size_t)j * ps + c], acc);
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
decode_step_kernel(const float* __restrict__ x_in, long long x_stride,
                   const float* __restrict__ rep, long long rep_stride,
                   const float* __restrict__ wts, float* cache, long long cache_stride,
                   long long pos_stride, long long batch_stride, float* __restrict__ logits,
                   int in_dim, int D, int H, int nb, int adim, int i) {
  __shared__ float in_s[kMaxIn];      // x_in of the row
  __shared__ float x_s[kMaxD];        // the block stream
  __shared__ float rep_s[kMaxD];      // encoder rep at position i
  __shared__ float h_s[kMaxD];        // post-LN1, then post-LN2 stream
  __shared__ float y_s[kMaxD];        // attention output, MLP hidden
  __shared__ float t_s[kMaxD];        // pre-LN sums
  __shared__ float qkv_s[3 * kMaxD];  // projections
  __shared__ float p_s[kMaxHeads * kMaxL];
  __shared__ float red_s[kRed];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const Layout L = weight_layout(in_dim, D, nb, adim);
  const float scale = 1.f / sqrtf((float)(D / H));
  float* crow = cache + (size_t)row * batch_stride;

  for (int k = tid; k < in_dim; k += kThreads) in_s[k] = x_in[(size_t)row * x_stride + k];
  for (int d = tid; d < D; d += kThreads) rep_s[d] = rep[(size_t)row * rep_stride + d];
  __syncthreads();

  // ---- embed the position's input, GELU, LN0
  matvec(in_s, in_dim, wts + L.embed_w, D, wts + L.embed_b, nullptr, true, D, t_s, red_s);
  layer_norm(t_s, wts + L.ln0, wts + L.ln0 + D, D, x_s);

  for (int b = 0; b < nb; ++b) {
    const float* w1 = wts + L.qkvp1_w + (size_t)b * D * 4 * D;
    const float* b1 = wts + L.qkvp1_b + (size_t)b * 4 * D;
    const float* w2 = wts + L.qkvp2_w + (size_t)b * D * 4 * D;
    const float* b2 = wts + L.qkvp2_b + (size_t)b * 4 * D;
    const float* lns = wts + L.lns + (size_t)b * 6 * D;
    float* k1 = crow + (size_t)(b * 4 + 0) * cache_stride;
    float* v1 = crow + (size_t)(b * 4 + 1) * cache_stride;
    float* k2 = crow + (size_t)(b * 4 + 2) * cache_stride;
    float* v2 = crow + (size_t)(b * 4 + 3) * cache_stride;
    const size_t at = (size_t)i * pos_stride;

    // ---- causal self-attention over the action stream
    matvec(x_s, D, w1, 4 * D, b1, nullptr, false, 3 * D, qkv_s, red_s);
    for (int d = tid; d < D; d += kThreads) {
      k1[at + d] = qkv_s[D + d];
      v1[at + d] = qkv_s[2 * D + d];
    }
    __syncthreads();
    attend(qkv_s, k1, v1, pos_stride, i + 1, D, H, scale, p_s, red_s, y_s);
    matvec(y_s, D, w1 + 3 * D, 4 * D, b1 + 3 * D, x_s, false, D, t_s, red_s);
    layer_norm(t_s, lns, lns + D, D, h_s);

    // ---- cross-attention: query from the encoder rep, K/V from h
    matvec(rep_s, D, w2, 4 * D, b2, nullptr, false, D, qkv_s, red_s);
    matvec(h_s, D, w2 + D, 4 * D, b2 + D, nullptr, false, 2 * D, qkv_s + D, red_s);
    for (int d = tid; d < D; d += kThreads) {
      k2[at + d] = qkv_s[D + d];
      v2[at + d] = qkv_s[2 * D + d];
    }
    __syncthreads();
    attend(qkv_s, k2, v2, pos_stride, i + 1, D, H, scale, p_s, red_s, y_s);
    matvec(y_s, D, w2 + 3 * D, 4 * D, b2 + 3 * D, rep_s, false, D, t_s, red_s);
    layer_norm(t_s, lns + 2 * D, lns + 3 * D, D, h_s);

    // ---- MLP and the block's output
    matvec(h_s, D, wts + L.mlp_w1 + (size_t)b * D * D, D, wts + L.mlp_b1 + (size_t)b * D,
           nullptr, true, D, y_s, red_s);
    matvec(y_s, D, wts + L.mlp_w2 + (size_t)b * D * D, D, wts + L.mlp_b2 + (size_t)b * D,
           h_s, false, D, t_s, red_s);
    layer_norm(t_s, lns + 4 * D, lns + 5 * D, D, x_s);
  }

  // ---- the f32 head, logits straight to device memory
  matvec(x_s, D, wts + L.head_w1, D, wts + L.head_b1, nullptr, true, D, t_s, red_s);
  layer_norm(t_s, wts + L.head_ln, wts + L.head_ln + D, D, y_s);
  matvec(y_s, D, wts + L.head_w2, adim, wts + L.head_b2, nullptr, false, adim,
         logits + (size_t)row * adim, red_s);
}

}  // namespace

// x_in (B, in_dim) with row stride x_stride, rep (B, D) with row stride
// rep_stride, weights: the flat DecodeStepWeights, cache: the 4 nb caches of
// L positions (strides in floats as above), logits (B, adim) contiguous; all
// f32, each row's innermost dim contiguous.
extern "C" cudaError_t mat_decode_step(const void* x_in, long long x_stride, const void* rep,
                                       long long rep_stride, const void* weights, void* cache,
                                       long long cache_stride, long long pos_stride,
                                       long long batch_stride, void* logits, int B, int L,
                                       int in_dim, int D, int H, int nb, int adim, int i,
                                       void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || i < 0 || i >= L || D < 1 || D > kMaxD || H < 1 ||
      H > kMaxHeads || D % H != 0 || nb < 1 || in_dim < 1 || in_dim > kMaxIn || adim < 1 ||
      adim > kMaxAdim) {
    return cudaErrorInvalidValue;
  }
  decode_step_kernel<<<(unsigned)B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_in), x_stride, static_cast<const float*>(rep), rep_stride,
      static_cast<const float*>(weights), static_cast<float*>(cache), cache_stride, pos_stride,
      batch_stride, static_cast<float*>(logits), in_dim, D, H, nb, adim, i);
  return cudaGetLastError();
}

// The number of f32 values in the flat weight buffer, and the limits the
// wrapper checks against, so the two sides cannot drift apart.
extern "C" long long mat_decode_step_weight_count(int in_dim, int D, int nb, int adim) {
  return weight_layout(in_dim, D, nb, adim).total;
}
extern "C" int mat_decode_step_max_d() { return kMaxD; }
extern "C" int mat_decode_step_max_l() { return kMaxL; }
extern "C" int mat_decode_step_max_heads() { return kMaxHeads; }
extern "C" int mat_decode_step_max_in() { return kMaxIn; }
extern "C" int mat_decode_step_max_adim() { return kMaxAdim; }
