// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mat_dcml_tpu/ops/pallas_attention.py::_fwd_kernel,
// launched by the pallas_call in _fused_attention_fwd (entry
// fused_masked_attention).  Per flattened row n = b * H + h:
//
//   out[n] = softmax(mask(q[n] k[n]^T / sqrt(Dh))) v[n]
//
// with f32 scores, a causal tril and/or a kv mask (shared (Lk,) row or one
// row per batch b = n / H), masked scores set to -1e9 (not -inf, so a fully
// masked row gives the uniform softmax of the XLA path), and under bf16
// inputs the probabilities rounded to bf16 before P.V as the XLA path does.
//
// What bounds it.  A row n does 2 * Lq * Lk * Dh multiply-adds against
// (2 * Lk + 2 * Lq) * Dh values moved.  The cached decode (Lq = 1, 404 of
// the 406 launches of a serving dispatch) does about 1 flop a byte: bytes
// bound it.  The encoder (Lq = Lk = 101, Dh = 32) does 25 flops a byte in
// f32, just above the 20 at which f32 arithmetic outside the tensor cores
// (67 TFLOP/s against 3.35 TB/s) takes over.  So each input is read from
// device memory once and nothing but the output is written: scores and
// probabilities live in registers, one warp per query row, reduced with warp
// shuffles.
//
//  - attn_fwd_staged (Lq > 1: encoder self-attention, causal decoder): a
//    block owns row n and up to kRowsPerBlock query rows; K and V of row n
//    are staged once in shared memory as f32 (101 x 32 x 4 B = 12.9 KB each)
//    and every warp of the block reuses them.
//  - attn_fwd_rows (Lq = 1: every cached-decode step): a query row reuses
//    nothing, so each warp takes its own row n and reads K and V straight
//    from device memory; a block holds kWarps rows so it is not one warp.
//
// Limits: Lk <= kMaxLk (scores per lane in registers), Dh <= kMaxDh.
// The launcher returns the launch's cudaError_t; it neither allocates nor
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxLk = 128;
constexpr int kMaxDh = 128;
constexpr int kKeyTiles = kMaxLk / kWarp;   // scores held per lane
constexpr int kDimTiles = kMaxDh / kWarp;   // output dims held per lane
constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 32;           // staged path: query rows a block owns
constexpr float kNegInf = -1e9f;            // ops/attention.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The kv-mask row of flattened row n (nullptr when there is no mask).
__device__ __forceinline__ const unsigned char* mask_row(const unsigned char* mask,
                                                         int mask_mode, int n, int H,
                                                         int Lk) {
  if (mask_mode == 1) return mask;
  if (mask_mode == 2) return mask + (size_t)(n / H) * Lk;
  return nullptr;
}

// One warp computes one query row.  q_s holds the row as f32 in shared
// memory (read as a broadcast).  Lane l scores keys l, l + 32, ...; K is read
// as K[j * k_stride + d] and V as V[j * v_stride + d], from shared memory
// (KV = float) or device memory (KV = T).  All control flow that reaches a
// shuffle is uniform across the warp.
template <typename T, typename KV>
__device__ void attend_row(const float* q_s, const KV* K, int k_stride, const KV* V,
                           int v_stride, const unsigned char* mask, int Lk, int Dh,
                           int qrow, bool causal, float scale, T* out) {
  const int lane = threadIdx.x % kWarp;

  float s[kKeyTiles];
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    const int j = t * kWarp + lane;
    float x = -INFINITY;  // no key here: weight exactly 0
    if (j < Lk) {
      const KV* kj = K + (size_t)j * k_stride;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(q_s[d], to_f32(kj[d]), dot);
      x = dot * scale;
      if ((causal && j > qrow) || (mask != nullptr && mask[j] == 0)) x = kNegInf;
    }
    s[t] = x;
  }

  float m = s[0];
#pragma unroll
  for (int t = 1; t < kKeyTiles; ++t) m = fmaxf(m, s[t]);
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    s[t] = expf(s[t] - m);
    sum += s[t];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) s[t] = to_f32(from_f32<T>(s[t] / sum));

  float acc[kDimTiles];
#pragma unroll
  for (int c = 0; c < kDimTiles; ++c) acc[c] = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    if (t * kWarp < Lk) {
      const int n_src = min(kWarp, Lk - t * kWarp);
      for (int src = 0; src < n_src; ++src) {
        const float p = __shfl_sync(kFull, s[t], src);
        const KV* vj = V + (size_t)(t * kWarp + src) * v_stride;
#pragma unroll
        for (int c = 0; c < kDimTiles; ++c) {
          const int d = c * kWarp + lane;
          if (d < Dh) acc[c] = fmaf(p, to_f32(vj[d]), acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kDimTiles; ++c) {
    const int d = c * kWarp + lane;
    if (d < Dh) out[d] = from_f32<T>(acc[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
attn_fwd_staged(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const unsigned char* __restrict__ mask, T* __restrict__ out, int Lq, int Lk,
                int Dh, int H, int causal, int mask_mode) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int k_stride = Dh + 1;  // odd stride: lanes reading keys j..j+31 hit 32 banks
  float* k_s = smem;
  float* v_s = k_s + Lk * k_stride;
  float* q_s = v_s + Lk * Dh;

  const T* kn = k + (size_t)n * Lk * Dh;
  const T* vn = v + (size_t)n * Lk * Dh;
  for (int idx = threadIdx.x; idx < Lk * Dh; idx += blockDim.x) {
    k_s[(idx / Dh) * k_stride + idx % Dh] = to_f32(kn[idx]);
    v_s[idx] = to_f32(vn[idx]);
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* qw = q_s + warp * Dh;
  const unsigned char* m = mask_row(mask, mask_mode, n, H, Lk);
  const float scale = 1.f / sqrtf((float)Dh);
  const int row_end = min((int)(blockIdx.y + 1) * kRowsPerBlock, Lq);
  for (int r = blockIdx.y * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const size_t row = (size_t)n * Lq + r;
    for (int d = lane; d < Dh; d += kWarp) qw[d] = to_f32(q[row * Dh + d]);
    __syncwarp();
    attend_row<T, float>(qw, k_s, k_stride, v_s, Dh, m, Lk, Dh, r, causal != 0, scale,
                         out + row * Dh);
    __syncwarp();  // every lane is done with qw before the next row overwrites it
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
attn_fwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const unsigned char* __restrict__ mask, T* __restrict__ out, int N, int Lq,
              int Lk, int Dh, int H, int causal, int mask_mode) {
  __shared__ float q_s[kWarps][kMaxDh];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t row = (size_t)blockIdx.x * kWarps + warp;  // flattened (n, query row)
  if (row >= (size_t)N * Lq) return;                      // the whole warp leaves
  const int n = (int)(row / Lq);
  const int r = (int)(row % Lq);
  for (int d = lane; d < Dh; d += kWarp) q_s[warp][d] = to_f32(q[row * Dh + d]);
  __syncwarp();
  const size_t kv_off = (size_t)n * Lk * Dh;
  attend_row<T, T>(q_s[warp], k + kv_off, Dh, v + kv_off, Dh,
                   mask_row(mask, mask_mode, n, H, Lk), Lk, Dh, r, causal != 0,
                   1.f / sqrtf((float)Dh), out + row * Dh);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int N, int Lq, int Lk, int Dh, int H, int causal, int mask_mode,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const unsigned char* mt = static_cast<const unsigned char*>(mask);
  T* ot = static_cast<T*>(out);
  if (Lq == 1) {
    const long rows = (long)N * Lq;
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    attn_fwd_rows<T><<<blocks, kWarps * kWarp, 0, stream>>>(qt, kt, vt, mt, ot, N, Lq, Lk,
                                                             Dh, H, causal, mask_mode);
  } else {
    const size_t smem = sizeof(float) * ((size_t)Lk * (Dh + 1) + (size_t)Lk * Dh +
                                         (size_t)kWarps * Dh);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          attn_fwd_staged<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((unsigned)N, (unsigned)((Lq + kRowsPerBlock - 1) / kRowsPerBlock));
    attn_fwd_staged<T><<<grid, kWarps * kWarp, smem, stream>>>(qt, kt, vt, mt, ot, Lq, Lk,
                                                                Dh, H, causal, mask_mode);
  }
  return cudaGetLastError();
}

}  // namespace

// q (N, Lq, Dh), k and v (N, Lk, Dh), out (N, Lq, Dh), all contiguous and of
// one dtype (0 = f32, 1 = bf16).  mask_mode: 0 none, 1 one shared (Lk,) row,
// 2 one (Lk,) row per batch index n / H.  Mask bytes are 0 (masked) or not.
extern "C" cudaError_t mat_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int N, int Lq, int Lk,
                                         int Dh, int H, int causal, int mask_mode, int dtype,
                                         void* stream) {
  if (N < 1 || Lq < 1 || Lk < 1 || Lk > kMaxLk || Dh < 1 || Dh > kMaxDh || H < 1 ||
      mask_mode < 0 || mask_mode > 2 || (mask_mode != 0 && mask == nullptr) ||
      (causal && Lq != Lk)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, mask, out, N, Lq, Lk, Dh, H, causal, mask_mode, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, mask, out, N, Lq, Lk, Dh, H, causal, mask_mode, s);
  }
  return cudaErrorInvalidValue;
}

// The limits the wrapper checks against, so the two cannot drift apart.
extern "C" int mat_attention_fwd_max_lk() { return kMaxLk; }
extern "C" int mat_attention_fwd_max_dh() { return kMaxDh; }
