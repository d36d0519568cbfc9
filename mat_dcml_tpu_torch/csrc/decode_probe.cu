// A measurement, on no path: where the time of one decode position goes.
//
// ar_decode.cu compiled with DEC_PROBE, so that thread 0 of the launch's
// first CTA records a clock64 stamp as each step of the body ends
// (decode_common.cuh, DEC_MARK): products, attentions, LayerNorms, block
// and cluster barriers (on entry and on exit), the sampling.  Its
// mat_ar_decode computes what the unprobed kernel computes.  Beside it,
// a cluster of 4 CTAs of 256 threads timing cluster barriers alone, with
// nothing to wait for, and after each thread's store into every CTA's
// shared memory (distributed shared memory), as the body's exchanges do;
// it reads the SM clock and the global nanosecond timer together, so that
// the probe can turn cycles into time.  probes/decode_stages.py drives it.

#define DEC_PROBE 1
#include "ar_decode.cu"

namespace {

template <bool kStores>
__global__ void __launch_bounds__(dec::kThreads, 1) barrier_probe(int n, long long* out) {
  __shared__ float buf[dec::kCluster * dec::kThreads];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int rank = (int)cl.block_rank();
  float* peer[dec::kCluster];
  for (int q = 0; q < dec::kCluster; ++q) peer[q] = cl.map_shared_rank(buf, q);
  cl.sync();
  long long t0, g0, t1, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  t0 = clock64();
  for (int k = 0; k < n; ++k) {
    if (kStores) {
#pragma unroll
      for (int q = 0; q < dec::kCluster; ++q) peer[q][rank * dec::kThreads + threadIdx.x] = (float)k;
    }
    cl.sync();
  }
  t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (rank == 0 && threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = g1 - g0;
  }
}

}  // namespace

// Zero the stage clocks before a probed decode.
extern "C" cudaError_t mat_decode_probe_reset() {
  const int zero = 0;
  return cudaMemcpyToSymbol(dec::probe_count, &zero, sizeof(int));
}

// Copy the stage clocks of the last probed decode (at most `most`): returns
// their count, or -1 if the copy failed.
extern "C" int mat_decode_probe_read(long long* clocks, int* tags, int most) {
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, dec::probe_count, sizeof(int)) != cudaSuccess) return -1;
  n = n < most ? n : most;
  if (cudaMemcpyFromSymbol(clocks, dec::probe_clock, n * sizeof(long long)) != cudaSuccess ||
      cudaMemcpyFromSymbol(tags, dec::probe_tag, n * sizeof(int)) != cudaSuccess)
    return -1;
  return n;
}

// One cluster running n cluster barriers, with stores before each or not:
// out (device, 2 int64) gets the SM cycles and the nanoseconds of the loop.
extern "C" cudaError_t mat_decode_probe_barriers(int n, int stores, void* out, void* stream) {
  long long* o = static_cast<long long*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stores ? dec::launch_clusters(barrier_probe<true>, 1, 0, s, n, o)
                : dec::launch_clusters(barrier_probe<false>, 1, 0, s, n, o);
}
