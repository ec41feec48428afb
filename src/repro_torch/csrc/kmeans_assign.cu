// K2: fused k-means assign-and-accumulate (one Lloyd E+M data pass).
//
// Replaces the Pallas kernel `kmeans_assign_update` (body `_kernel`) of
// src/repro/kernels/kmeans_assign.py.  Returns, for x (N, D) and centroids
// (K, D): assign (N,) = argmin_k ||x - c_k||^2 (first index on ties),
// min_dist (N,), per-centroid sums (K, D) and counts (K,).
//
// What bounds it on an H100: the distance tile is 2*N*K*D FMAs in fp32; at
// the largest call of the build (N = 1M points against K ~ 1.4e4 centroids
// in enforce_size_bound) that is ~3.7 TFLOP against 67 TFLOP/s of fp32 CUDA
// cores, while the bytes are only (N + K) * D * 4.  So it is bound by
// operations.  The many small calls of the hierarchical splitter (a few
// thousand points, K <= 8) are bound by launch latency instead.
//
// What the design does about it: the E-step is a tiled fp32 product
// (64 x 64 output tile per block, D staged through shared memory in chunks
// of 16, 4 x 4 register tile per thread, float4 shared-memory reads) fused
// with the running argmin, so the (N, K) distance matrix never leaves
// registers.  The M-step must be deterministic (the build's content hash is
// asserted equal across runs and resumes), so there are no float atomics:
// integer atomics count points per (segment of 2048 points, cluster), a
// column scan turns those into per-segment bases, a single-block scan gives
// CSR offsets, one warp per segment scatters point indices in index order
// (__match_any_sync ranks equal clusters inside a warp), and one block per
// cluster sums its members' rows in index order.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kAssignThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr unsigned kFull = 0xffffffffu;
static_assert(BM == BN, "the tile loader fills xs and cs in one loop");

// Squared norm of each row; one warp per row, fixed reduction order.
__global__ void row_norms_kernel(const float* __restrict__ a,
                                 float* __restrict__ out, int n, int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = a[(size_t)row * D + d];
    s = fmaf(v, v, s);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(kAssignThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              const float* __restrict__ x2, const float* __restrict__ c2,
              int* __restrict__ assign, float* __restrict__ min_dist, int N,
              int K, int D) {
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float cs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;

  float xn[TM], best_d[TM];
  int best_j[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    xn[i] = gm < N ? x2[gm] : 0.0f;
    best_d[i] = CUDART_INF_F;
    best_j[i] = 0x7fffffff;
  }

  for (int n0 = 0; n0 < K; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < BM * BK; e += kAssignThreads) {
        const int m = e / BK, k = e - (e / BK) * BK;
        const int gm = m0 + m, gk = k0 + k;
        xs[k][m] = (gm < N && gk < D) ? x[(size_t)gm * D + gk] : 0.0f;
        const int gn = n0 + m;
        cs[k][m] = (gn < K && gk < D) ? c[(size_t)gn * D + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
        const float4 bb = *reinterpret_cast<const float4*>(&cs[k][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // columns visited in increasing index: strict < keeps the first minimum
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx * TN + j;
      if (gj < K) {
        const float cn = c2[gj];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = fmaxf(xn[i] - 2.0f * acc[i][j] + cn, 0.0f);
          if (d < best_d[i]) {
            best_d[i] = d;
            best_j[i] = gj;
          }
        }
      }
    }
  }

  // combine the 16 threads of a row group: smaller distance, then lower index
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float d = best_d[i];
    int j = best_j[i];
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, off);
      const int oj = __shfl_xor_sync(kFull, j, off);
      if (od < d || (od == d && oj < j)) {
        d = od;
        j = oj;
      }
    }
    const int gm = m0 + ty * TM + i;
    if (tx == 0 && gm < N) {
      assign[gm] = j == 0x7fffffff ? 0 : j;
      min_dist[gm] = d;
    }
  }
}

// hist[s * K + k] = number of points of segment s assigned to cluster k
__global__ void segment_hist_kernel(const int* __restrict__ assign,
                                    int* __restrict__ hist, int N, int K,
                                    int seg) {
  const int s = blockIdx.x;
  const int hi = min(N, (s + 1) * seg);
  for (int i = s * seg + threadIdx.x; i < hi; i += blockDim.x)
    atomicAdd(&hist[(size_t)s * K + assign[i]], 1);
}

// hist -> exclusive per-segment base within each cluster; counts = totals
__global__ void column_scan_kernel(int* __restrict__ hist,
                                   int* __restrict__ counts, int n_seg,
                                   int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int run = 0;
  for (int s = 0; s < n_seg; ++s) {
    const int v = hist[(size_t)s * K + k];
    hist[(size_t)s * K + k] = run;
    run += v;
  }
  counts[k] = run;
}

struct CountAt {
  const int* counts;
  __device__ int operator()(int i) const { return counts[i]; }
};

__global__ void offsets_kernel(const int* __restrict__ counts,
                               int* __restrict__ offsets, int K) {
  repro::block_exclusive_scan(CountAt{counts}, offsets, K);
}

// One warp per segment: members[] receives point indices grouped by cluster,
// in increasing index order inside each cluster.
__global__ void scatter_kernel(const int* __restrict__ assign,
                               int* __restrict__ base,
                               const int* __restrict__ offsets,
                               int* __restrict__ members, int N, int K,
                               int seg) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int hi = min(N, (s + 1) * seg);
  const unsigned lt = (1u << lane) - 1u;
  for (int i0 = s * seg; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < hi;
    const int c = valid ? assign[i] : -1 - lane;   // unique key when invalid
    const unsigned peers = __match_any_sync(kFull, c);
    if (valid) {
      const int pos = offsets[c] + base[(size_t)s * K + c] + __popc(peers & lt);
      members[pos] = i;
    }
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      base[(size_t)s * K + c] += __popc(peers);
    __syncwarp();
  }
}

// sums[k, d] = sum of x[m, d] over the members of cluster k, in index order
__global__ void segment_sum_kernel(const float* __restrict__ x,
                                   const int* __restrict__ members,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ sums, int D) {
  const int k = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int lo = offsets[k], hi = offsets[k + 1];
  float s = 0.0f;
  int m = lo;
  for (; m + 4 <= hi; m += 4) {
    const float v0 = x[(size_t)members[m] * D + d];
    const float v1 = x[(size_t)members[m + 1] * D + d];
    const float v2 = x[(size_t)members[m + 2] * D + d];
    const float v3 = x[(size_t)members[m + 3] * D + d];
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; m < hi; ++m) s += x[(size_t)members[m] * D + d];
  sums[(size_t)k * D + d] = s;
}

}  // namespace

extern "C" int kmeans_assign_update_launch(
    const void* x, const void* cents, void* assign, void* min_dist, void* sums,
    void* counts, void* x2, void* c2, void* hist, void* offsets,
    void* members, int N, int K, int D, int seg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_seg = (N + seg - 1) / seg;
  row_norms_kernel<<<(N + 7) / 8, 256, 0, st>>>((const float*)x, (float*)x2,
                                                N, D);
  REPRO_RETURN_IF_ERROR();
  row_norms_kernel<<<(K + 7) / 8, 256, 0, st>>>((const float*)cents,
                                                (float*)c2, K, D);
  REPRO_RETURN_IF_ERROR();
  assign_kernel<<<(N + BM - 1) / BM, kAssignThreads, 0, st>>>(
      (const float*)x, (const float*)cents, (const float*)x2,
      (const float*)c2, (int*)assign, (float*)min_dist, N, K, D);
  REPRO_RETURN_IF_ERROR();
  cudaMemsetAsync(hist, 0, (size_t)n_seg * K * sizeof(int), st);
  REPRO_RETURN_IF_ERROR();
  segment_hist_kernel<<<n_seg, 256, 0, st>>>((const int*)assign, (int*)hist,
                                             N, K, seg);
  REPRO_RETURN_IF_ERROR();
  column_scan_kernel<<<(K + 255) / 256, 256, 0, st>>>((int*)hist,
                                                      (int*)counts, n_seg, K);
  REPRO_RETURN_IF_ERROR();
  offsets_kernel<<<1, repro::kScanThreads, 0, st>>>((const int*)counts,
                                                    (int*)offsets, K);
  REPRO_RETURN_IF_ERROR();
  scatter_kernel<<<n_seg, 32, 0, st>>>((const int*)assign, (int*)hist,
                                       (const int*)offsets, (int*)members, N,
                                       K, seg);
  REPRO_RETURN_IF_ERROR();
  dim3 grid(K, (D + 127) / 128);
  segment_sum_kernel<<<grid, 128, 0, st>>>((const float*)x,
                                           (const int*)members,
                                           (const int*)offsets, (float*)sums,
                                           D);
  return (int)cudaGetLastError();
}
