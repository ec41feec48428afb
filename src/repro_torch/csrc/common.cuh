// Helpers shared by the port's CUDA sources: launch checking, the k-means
// argmin order and a single-block exclusive scan (used for CSR offsets and
// empty-cluster ranks).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_RETURN_IF_ERROR()                   \
  do {                                            \
    cudaError_t _e = cudaGetLastError();          \
    if (_e != cudaSuccess) return (int)_e;        \
  } while (0)

namespace repro {

constexpr int kScanThreads = 1024;

// The order of jnp.argmin / torch.argmin over (distance, index) pairs: a NaN
// comes before every number (the first NaN wins), then the smaller distance,
// then the lower index.  A total order, so a reduction over it gives the same
// winner in any combination order.
__device__ __forceinline__ bool argmin_before(float d1, int j1, float d2,
                                              int j2) {
  const bool n1 = isnan(d1), n2 = isnan(d2);
  if (n1 != n2) return n1;
  if (!n1 && d1 != d2) return d1 < d2;
  return j1 < j2;
}

// The k-means distance epilogue ||x||^2 - 2 x.c + ||c||^2 with explicit
// roundings, so that no compiler contraction can make two kernels differ,
// clamped at 0 in a way that keeps a NaN (as jnp.maximum does; fmaxf would
// turn it into 0).
__device__ __forceinline__ float kmeans_dist(float xn, float dot, float cn) {
  const float d = __fadd_rn(__fmaf_rn(-2.0f, dot, xn), cn);
  return d < 0.0f ? 0.0f : d;
}

// Exclusive scan of value(i) for i in [0, n) into out[0..n]; out[n] is the
// total.  Launch with ONE block of kScanThreads threads.  Thread t owns a
// contiguous chunk, so the sum order is fixed (integers anyway).
template <typename F>
__device__ void block_exclusive_scan(F value, int* __restrict__ out, int n) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x;
  const int chunk = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, t * chunk);
  const int hi = min(n, lo + chunk);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += value(i);
  part[t] = local;
  __syncthreads();
  // Hillis-Steele inclusive scan over the per-thread partial sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - local;
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += value(i);
  }
  if (t == kScanThreads - 1) out[n] = part[t];
}

}  // namespace repro
