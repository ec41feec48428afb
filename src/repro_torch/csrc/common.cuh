// Helpers shared by the port's CUDA sources: launch checking, the cp.async
// copies, the k-means argmin order, a single-block exclusive scan (used for
// CSR offsets and empty-cluster ranks) and a block's store of a run of
// floats.
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

// The dynamic shared memory a kernel may take without opting in: 48 KB
// less its static shared memory, which counts against the same limit.  A
// launch asking for more without cudaFuncAttributeMaxDynamicSharedMemorySize
// fails with cudaErrorInvalidValue.  0 when the attributes cannot be read
// (the caller then always opts in).
template <typename Kernel>
inline size_t default_dynamic_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return attr.sharedSizeBytes < 48 * 1024 ? 48 * 1024 - attr.sharedSizeBytes
                                          : 0;
}

// Asynchronous copies from device memory into shared memory: 16 bytes (both
// addresses 16-byte aligned; bypasses L1) or 4 bytes.  Each thread's copies
// are grouped by commit; wait<N> returns once at most N of its groups are
// still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// dst[j] = value(j) for j in [0, n), written by all threads of the block:
// 16-byte stores over the run's 16-byte-aligned interior (consecutive
// threads on consecutive addresses), 4-byte stores at its two edges.
template <typename F>
__device__ __forceinline__ void block_store_run(float* __restrict__ dst,
                                                int n, F value) {
  const int head =
      min(n, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  const int t = threadIdx.x;
  if (t < head) dst[t] = value(t);
  if (t < n - tail) dst[tail + t] = value(tail + t);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = t; i < body; i += blockDim.x) {
    const int j = head + 4 * i;
    d4[i] = make_float4(value(j), value(j + 1), value(j + 2), value(j + 3));
  }
}

}  // namespace repro
