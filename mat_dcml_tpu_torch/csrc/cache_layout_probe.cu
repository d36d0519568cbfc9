// Probe kernels: what each K/V cache layout and row-softmax pattern of the
// per-position decode costs on Hopper (sm_90a).
//
// Counterpart of scripts/mosaic_probe.py (its pallas_calls at :105-108 and
// probe kernels k_store_*, k_q_*, k_w_*, k_sublane_softmax).  That script asks
// which Mosaic store, query and broadcast layouts compile for the TPU decode
// kernels; on this card every layout compiles, so the question is what each
// costs.  Three kernels, each timed by mat_dcml_tpu_torch/probes/cache_layout.py
// against a plain PyTorch computation:
//
//  - probe_store: a decode's per-position K/V writes, positions 0 .. L - 1 in
//    order, into a cache laid out position-major (L, B, D) or batch-major
//    (B, L, D) (pos_stride and batch_stride in floats);
//  - probe_attend: one query per position over keys 0 .. i read from either
//    layout (causal attention computed the decode's way: one block per batch
//    row, positions in order, scores and softmax in shared memory);
//  - probe_softmax: a row softmax with its max and sum reduced by warp
//    shuffles (one warp a row) or through shared memory (one block a row).
//
// What bounds them: bytes (each moves a few values per flop at most); at the
// decode's sizes (B <= 128, L = 101, D = 64) every one is far below a
// microsecond of bandwidth, so latency and access pattern set their times,
// which is what the probe reads.  Each launcher returns the launch's
// cudaError_t and neither allocates nor synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxD = 256;
constexpr int kMaxL = 256;
constexpr int kMaxHeads = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// cache[row, i] = src[i, row] for i = 0 .. L - 1 (src position-major (L, B, D)).
__global__ void store_kernel(const float* __restrict__ src, float* cache, int B, int L, int D,
                             long long ps, long long bs) {
  const int row = blockIdx.x;
  for (int i = 0; i < L; ++i) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      cache[(size_t)row * bs + (size_t)i * ps + d] = src[((size_t)i * B + row) * D + d];
    }
    __syncthreads();
  }
}

// out[row, i] = sum_j<=i softmax_j(scale q[row, i]_h . K[row, j]_h) V[row, j],
// positions in order, q and out (B, L, D) contiguous.
__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ q, const float* K, const float* V,
              float* __restrict__ out, int L, int D, int H, long long ps, long long bs) {
  __shared__ float q_s[kMaxD];
  __shared__ float p_s[kMaxHeads * kMaxL];
  const int row = blockIdx.x;
  const int Dh = D / H;
  const float scale = 1.f / sqrtf((float)Dh);
  const float* Kr = K + (size_t)row * bs;
  const float* Vr = V + (size_t)row * bs;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int i = 0; i < L; ++i) {
    const int n = i + 1;
    for (int d = threadIdx.x; d < D; d += kThreads) q_s[d] = q[((size_t)row * L + i) * D + d];
    __syncthreads();
    for (int t = threadIdx.x; t < H * n; t += kThreads) {
      const int h = t / n;
      const int j = t - h * n;
      const float* kj = Kr + (size_t)j * ps + h * Dh;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(q_s[h * Dh + d], kj[d], dot);
      p_s[h * kMaxL + j] = dot * scale;
    }
    __syncthreads();
    for (int h = warp; h < H; h += kThreads / kWarp) {
      float* ph = p_s + h * kMaxL;
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
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float* ph = p_s + (c / Dh) * kMaxL;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(ph[j], Vr[(size_t)j * ps + c], acc);
      out[((size_t)row * L + i) * D + c] = acc;
    }
    __syncthreads();
  }
}

// y = softmax(x) over each of R rows of n values: one warp a row, max and sum
// by shuffles.
__global__ void softmax_shuffle_kernel(const float* __restrict__ x, float* __restrict__ y,
                                       int R, int n) {
  const int r = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= R) return;
  const float* xr = x + (size_t)r * n;
  float m = -INFINITY;
  for (int j = lane; j < n; j += kWarp) m = fmaxf(m, xr[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < n; j += kWarp) sum += expf(xr[j] - m);
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += kWarp) y[(size_t)r * n + j] = expf(xr[j] - m) / sum;
}

// The same with one block of blockDim.x (a power of two) threads a row, max
// and sum by a tree reduction in shared memory.
__global__ void softmax_shared_kernel(const float* __restrict__ x, float* __restrict__ y,
                                      int n) {
  __shared__ float red[1024];
  const int r = blockIdx.x;
  const float* xr = x + (size_t)r * n;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, xr[j]);
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  m = red[0];
  __syncthreads();
  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) sum += expf(xr[j] - m);
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  sum = red[0];
  for (int j = threadIdx.x; j < n; j += blockDim.x) y[(size_t)r * n + j] = expf(xr[j] - m) / sum;
}

}  // namespace

extern "C" cudaError_t probe_store(const void* src, void* cache, int B, int L, int D,
                                   long long ps, long long bs, void* stream) {
  if (B < 1 || L < 1 || D < 1 || D > 1024) return cudaErrorInvalidValue;
  store_kernel<<<(unsigned)B, D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(cache), B, L, D, ps, bs);
  return cudaGetLastError();
}

extern "C" cudaError_t probe_attend(const void* q, const void* k, const void* v, void* out,
                                    int B, int L, int D, int H, long long ps, long long bs,
                                    void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || D < 1 || D > kMaxD || H < 1 || H > kMaxHeads || D % H) {
    return cudaErrorInvalidValue;
  }
  attend_kernel<<<(unsigned)B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), L, D, H, ps, bs);
  return cudaGetLastError();
}

// shuffle: 0 = shared-memory reduction (one block of 128 threads a row),
// 1 = warp shuffles (eight rows a block of 256 threads).
extern "C" cudaError_t probe_softmax(const void* x, void* y, int R, int n, int shuffle,
                                     void* stream) {
  if (R < 1 || n < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (shuffle) {
    softmax_shuffle_kernel<<<(unsigned)((R + 7) / 8), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), R, n);
  } else {
    softmax_shared_kernel<<<(unsigned)R, 128, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<float*>(y), n);
  }
  return cudaGetLastError();
}
