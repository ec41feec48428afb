// K3: fused Lloyd M-step (centroid division + empty-cluster reseed).
//
// Replaces the Pallas kernel `kmeans_mstep` (body `_kernel`) of
// src/repro/kernels/kmeans_mstep.py:
//
//   new[k] = sums[k] / max(counts[k], 1)     counts[k] > 0
//          = reseed[rank(k)]                 counts[k] <= 0
//
// where rank(k) is the number of empty clusters before k.
//
// What bounds it on an H100: one read of sums and of (at most) as many reseed
// rows as there are empty clusters, one write of the (K, D) output and no
// arithmetic to speak of, so it is bound by bytes; at the build's shapes
// (K <= 8 inside the hierarchical splitter) it is bound by launch latency.
//
// What the design does about it: the TPU kernel computed the rank with a
// (K, K) triangular matmul and gathered reseed rows with a one-hot matmul,
// because the MXU was the cheap unit there.  Here a single block computes
// the exclusive count of empty clusters (a block scan over K flags), and a
// grid-stride elementwise pass writes the mean or the reseed row with
// coalesced loads.  The division is IEEE fp32, bit-equal to the plain
// version.
#include "common.cuh"

namespace {

struct EmptyAt {
  const float* counts;
  __device__ int operator()(int i) const { return counts[i] <= 0.0f ? 1 : 0; }
};

__global__ void empty_rank_kernel(const float* __restrict__ counts,
                                  int* __restrict__ rank, int K) {
  repro::block_exclusive_scan(EmptyAt{counts}, rank, K);
}

__global__ void mstep_kernel(const float* __restrict__ sums,
                             const float* __restrict__ counts,
                             const float* __restrict__ reseed,
                             const int* __restrict__ rank,
                             float* __restrict__ out, int K, int D) {
  const size_t total = (size_t)K * D;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(e / D);
    const int d = (int)(e - (size_t)k * D);
    const float cnt = counts[k];
    out[e] = cnt <= 0.0f ? reseed[(size_t)rank[k] * D + d]
                         : sums[e] / fmaxf(cnt, 1.0f);
  }
}

}  // namespace

extern "C" int kmeans_mstep_launch(const void* sums, const void* counts,
                                   const void* reseed, void* out, void* rank,
                                   int K, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  empty_rank_kernel<<<1, repro::kScanThreads, 0, st>>>((const float*)counts,
                                                       (int*)rank, K);
  REPRO_RETURN_IF_ERROR();
  const size_t total = (size_t)K * D;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  mstep_kernel<<<blocks, 256, 0, st>>>((const float*)sums,
                                       (const float*)counts,
                                       (const float*)reseed, (const int*)rank,
                                       (float*)out, K, D);
  return (int)cudaGetLastError();
}
