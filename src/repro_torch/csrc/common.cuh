// Helpers shared by the port's CUDA sources: launch checking and a
// single-block exclusive scan (used for CSR offsets and empty-cluster ranks).
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
