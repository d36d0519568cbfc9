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
// no gradient for the mask.  Like the TPU kernel it recomputes P from q and k
// instead of reading a saved copy.  Arithmetic is f32; under bf16 inputs the
// rounding follows autograd through ops/cuda_attention.py::attention_plain:
// P is rounded to bf16 where it meets dO (dv), dP is rounded to bf16 (it is
// the output of a bf16 product there), and the softmax backward uses P in f32.
//
// What bounds it.  A row does 5 products of L x L x Dh multiply-adds (S, dP,
// dq, dk, dv): 10 * Lq * Lk * Dh flops, against 7 tensors of L x Dh values
// moved (q, k, v, dO read; dq, dk, dv written).  At the PPO update's shape
// (200 rows, L = 101, Dh = 32, f32) that is 0.65 GFLOP against 18 MB: about
// 36 flops a byte, above the 20 at which f32 arithmetic outside the tensor
// cores (67 TFLOP/s against 3.35 TB/s) takes over, so operations bound it
// (about 9.7 us against 5.4 us for the bytes; half the flops under the
// causal mask, which the kernel still computes in full).  The design keeps every intermediate on chip and reads each
// input from device memory once:
//
//  - one block per row n; K and V staged in shared memory as f32 (odd stride
//    Dh + 1, so lanes reading keys j..j+31 hit 32 banks);
//  - a row pass, one warp per query row i with lane l holding keys l, l + 32,
//    ...: the scores, the softmax, dP, rowsum(dP o P) and dS in registers
//    (warp shuffles for the reductions), dq_i by broadcasting dS along the
//    warp as the forward broadcasts P; P and dS * scale go to shared memory;
//  - a column pass, one warp per key j with lane l holding dims l, l + 32,
//    ...: dv_j and dk_j summed over the query rows, with q and dO staged
//    (f32) in the shared memory that K and V held during the row pass.
//
// Shared memory: 2 * max(Lq, Lk) * (Dh + 1) + 2 * Lq * Lk + 2 * kWarps * Dh
// floats, 110 KB at the update's shape (two blocks fit on an SM).  Limits:
// Lk <= kMaxLk, Dh <= kMaxDh as the forward, and the shared memory for the
// shape within the card's opt-in maximum (mat_attention_bwd_smem_bytes; the
// wrapper raises beyond it).  The launcher returns the launch's cudaError_t;
// it neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxLk = 128;
constexpr int kMaxDh = 128;
constexpr int kKeyTiles = kMaxLk / kWarp;   // scores held per lane
constexpr int kDimTiles = kMaxDh / kWarp;   // head dims held per lane
constexpr int kWarps = 8;
constexpr float kNegInf = -1e9f;            // ops/attention.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the identity for f32, bf16 rounding for bf16.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ const unsigned char* mask_row(const unsigned char* mask,
                                                         int mask_mode, int n, int H,
                                                         int Lk) {
  if (mask_mode == 1) return mask;
  if (mask_mode == 2) return mask + (size_t)(n / H) * Lk;
  return nullptr;
}

__host__ __device__ inline size_t smem_floats(int Lq, int Lk, int Dh) {
  const int L = Lq > Lk ? Lq : Lk;
  return 2 * (size_t)L * (Dh + 1) + 2 * (size_t)Lq * Lk + 2 * (size_t)kWarps * Dh;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
attn_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const unsigned char* __restrict__ mask,
         T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk, int Dh,
         int H, int causal, int mask_mode) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int stride = Dh + 1;
  const int L = Lq > Lk ? Lq : Lk;
  float* a_s = smem;                          // K in the row pass, q in the column pass
  float* b_s = a_s + (size_t)L * stride;      // V in the row pass, dO in the column pass
  float* p_s = b_s + (size_t)L * stride;      // P (f32), (Lq, Lk)
  float* ds_s = p_s + (size_t)Lq * Lk;        // dS * scale, (Lq, Lk)
  float* qw = ds_s + (size_t)Lq * Lk + warp * 2 * Dh;   // this warp's q_i, dO_i
  float* dow = qw + Dh;

  const size_t q_off = (size_t)n * Lq * Dh;
  const size_t k_off = (size_t)n * Lk * Dh;
  for (int idx = threadIdx.x; idx < Lk * Dh; idx += blockDim.x) {
    const int r = idx / Dh, d = idx % Dh;
    a_s[r * stride + d] = to_f32(k[k_off + idx]);
    b_s[r * stride + d] = to_f32(v[k_off + idx]);
  }
  __syncthreads();

  // ---- row pass: one warp per query row
  const unsigned char* m = mask_row(mask, mask_mode, n, H, Lk);
  const float scale = 1.f / sqrtf((float)Dh);
  for (int i = warp; i < Lq; i += kWarps) {
    for (int d = lane; d < Dh; d += kWarp) {
      qw[d] = to_f32(q[q_off + (size_t)i * Dh + d]);
      dow[d] = to_f32(dout[q_off + (size_t)i * Dh + d]);
    }
    __syncwarp();

    float p[kKeyTiles], dp[kKeyTiles];
    bool live[kKeyTiles];  // a key of this row that no mask hides
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      const int j = t * kWarp + lane;
      float s = -INFINITY;  // no key here: weight exactly 0
      float g = 0.f;
      live[t] = false;
      if (j < Lk) {
        const float* kj = a_s + j * stride;
        const float* vj = b_s + j * stride;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) {
          dot = fmaf(qw[d], kj[d], dot);
          g = fmaf(dow[d], vj[d], g);
        }
        s = dot * scale;
        live[t] = !((causal && j > i) || (m != nullptr && m[j] == 0));
        if (!live[t]) s = kNegInf;
      }
      p[t] = s;
      dp[t] = round_to<T>(g);
    }
    float mx = p[0];
#pragma unroll
    for (int t = 1; t < kKeyTiles; ++t) mx = fmaxf(mx, p[t]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      p[t] = expf(p[t] - mx);
      sum += p[t];
    }
    sum = warp_sum(sum);
    float rowdot = 0.f;
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      p[t] = p[t] / sum;
      rowdot = fmaf(p[t], dp[t], rowdot);
    }
    rowdot = warp_sum(rowdot);

    float acc[kDimTiles];
#pragma unroll
    for (int c = 0; c < kDimTiles; ++c) acc[c] = 0.f;
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      const int j = t * kWarp + lane;
      // a masked score is a constant: its gradient is 0 (it is not exactly
      // 0 through the softmax when every key of the row is masked)
      const float dsc = live[t] ? p[t] * (dp[t] - rowdot) * scale : 0.f;
      if (j < Lk) {
        p_s[i * Lk + j] = p[t];
        ds_s[i * Lk + j] = dsc;
      }
      if (t * kWarp < Lk) {
        const int n_src = min(kWarp, Lk - t * kWarp);
        for (int src = 0; src < n_src; ++src) {
          const float w = __shfl_sync(kFull, dsc, src);
          const float* kj = a_s + (t * kWarp + src) * stride;
#pragma unroll
          for (int c = 0; c < kDimTiles; ++c) {
            const int d = c * kWarp + lane;
            if (d < Dh) acc[c] = fmaf(w, kj[d], acc[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kDimTiles; ++c) {
      const int d = c * kWarp + lane;
      if (d < Dh) dq[q_off + (size_t)i * Dh + d] = from_f32<T>(acc[c]);
    }
    __syncwarp();  // every lane is done with qw / dow before the next row
  }
  __syncthreads();  // K and V are no longer read: stage q and dO in their place

  for (int idx = threadIdx.x; idx < Lq * Dh; idx += blockDim.x) {
    const int r = idx / Dh, d = idx % Dh;
    a_s[r * stride + d] = to_f32(q[q_off + idx]);
    b_s[r * stride + d] = to_f32(dout[q_off + idx]);
  }
  __syncthreads();

  // ---- column pass: one warp per key
  for (int j = warp; j < Lk; j += kWarps) {
    float gv[kDimTiles], gk[kDimTiles];
#pragma unroll
    for (int c = 0; c < kDimTiles; ++c) gv[c] = gk[c] = 0.f;
    for (int i = 0; i < Lq; ++i) {
      const float pij = round_to<T>(p_s[i * Lk + j]);
      const float dsij = ds_s[i * Lk + j];
      const float* qi = a_s + i * stride;
      const float* doi = b_s + i * stride;
#pragma unroll
      for (int c = 0; c < kDimTiles; ++c) {
        const int d = c * kWarp + lane;
        if (d < Dh) {
          gv[c] = fmaf(pij, doi[d], gv[c]);
          gk[c] = fmaf(dsij, qi[d], gk[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kDimTiles; ++c) {
      const int d = c * kWarp + lane;
      if (d < Dh) {
        dv[k_off + (size_t)j * Dh + d] = from_f32<T>(gv[c]);
        dk[k_off + (size_t)j * Dh + d] = from_f32<T>(gk[c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* mask, void* dq, void* dk, void* dv, int N, int Lq, int Lk,
                   int Dh, int H, int causal, int mask_mode, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Lq, Lk, Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_bwd<T><<<(unsigned)N, kWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const unsigned char*>(mask), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, Dh, H, causal, mask_mode);
  return cudaGetLastError();
}

}  // namespace

// q and dout (N, Lq, Dh); k and v (N, Lk, Dh); dq, dk, dv shaped as q, k, v;
// all contiguous and of one dtype (0 = f32, 1 = bf16).  mask_mode: 0 none,
// 1 one shared (Lk,) row, 2 one (Lk,) row per batch index n / H.
extern "C" cudaError_t mat_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const void* mask, void* dq,
                                         void* dk, void* dv, int N, int Lq, int Lk, int Dh,
                                         int H, int causal, int mask_mode, int dtype,
                                         void* stream) {
  if (N < 1 || Lq < 1 || Lk < 1 || Lk > kMaxLk || Dh < 1 || Dh > kMaxDh || H < 1 ||
      mask_mode < 0 || mask_mode > 2 || (mask_mode != 0 && mask == nullptr) ||
      (causal && Lq != Lk)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, dout, mask, dq, dk, dv, N, Lq, Lk, Dh, H, causal, mask_mode, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, dout, mask, dq, dk, dv, N, Lq, Lk, Dh, H, causal,
                                 mask_mode, s);
  }
  return cudaErrorInvalidValue;
}

// The limits the wrapper checks against, so the two cannot drift apart.
extern "C" int mat_attention_bwd_max_lk() { return kMaxLk; }
extern "C" int mat_attention_bwd_max_dh() { return kMaxDh; }
extern "C" long long mat_attention_bwd_smem_bytes(int Lq, int Lk, int Dh) {
  return (long long)(sizeof(float) * smem_floats(Lq, Lk, Dh));
}
// The shared memory a block may opt in to on the current device, or -1.
extern "C" long long mat_attention_bwd_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}
