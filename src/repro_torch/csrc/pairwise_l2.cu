// B5: pairwise squared L2 distance tile.
//
// Replaces the Pallas kernel `pairwise_l2` (body `_kernel`) of
// src/repro/kernels/pairwise_l2.py.  For a (N, D) and b (M, D), f32:
//
//   out[i, j] = max(||a_i||^2 - 2 a_i . b_j + ||b_j||^2, 0)     (N, M) f32.
//
// It is the distance tile of the unfused k-means E-step
// (kernels/ops.kmeans_assign), whose argmin and min run outside the kernel.
//
// What bounds it on an H100: the product is 2 * N * M * D FLOPs in fp32 on
// CUDA cores (67 TFLOP/s); at the build's chunk (16,384 points against
// ~20,600 centroids, D = 128) that is 86 GFLOP, 1.3 ms, while writing the
// 1.35 GB output takes 0.4 ms at 3.35 TB/s.  Bound by operations, with the
// output write a large second term.
//
// What the design does about it: the same register-tiled fp32 product as
// K2's E-step (64 x 64 output tile per block, D staged through shared
// memory in chunks of 16, 4 x 4 outputs per thread), with the row norms
// computed once by a separate pass and added in the epilogue.  A thread's 4
// columns are 16 apart, so a half-warp stores 16 neighbouring floats of a
// row: the 1.35 GB output leaves in coalesced 64-byte pieces.  Output
// offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kTileThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr unsigned kFull = 0xffffffffu;

// Squared norm of each row; one warp per row, fixed reduction order.
__global__ void pw_row_norms_kernel(const float* __restrict__ a,
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

__global__ void __launch_bounds__(kTileThreads)
pairwise_l2_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ a2, const float* __restrict__ b2,
                   float* __restrict__ out, int N, int M, int D) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;        // rows of a
  const int n0 = blockIdx.y * BN;        // rows of b

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kTileThreads) {
      const int m = e / BK, k = e - (e / BK) * BK;
      const int gk = k0 + k;
      const int gm = m0 + m, gn = n0 + m;
      as[k][m] = (gm < N && gk < D) ? a[(size_t)gm * D + gk] : 0.0f;
      bs[k][m] = (gn < M && gk < D) ? b[(size_t)gn * D + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(&as[k][ty * TM]);
      const float av[TM] = {x.x, x.y, x.z, x.w};
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= N) continue;
    const float an = a2[gm];
    float* orow = out + (size_t)gm * M;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < M) orow[gn] = fmaxf(an - 2.0f * acc[i][j] + b2[gn], 0.0f);
    }
  }
}

}  // namespace

extern "C" int pairwise_l2_launch(const void* a, const void* b, void* a2,
                                  void* b2, void* out, int N, int M, int D,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  pw_row_norms_kernel<<<(N + 7) / 8, 256, 0, st>>>((const float*)a,
                                                   (float*)a2, N, D);
  REPRO_RETURN_IF_ERROR();
  pw_row_norms_kernel<<<(M + 7) / 8, 256, 0, st>>>((const float*)b,
                                                   (float*)b2, M, D);
  REPRO_RETURN_IF_ERROR();
  dim3 grid((N + BM - 1) / BM, (M + BN - 1) / BN);
  pairwise_l2_kernel<<<grid, kTileThreads, 0, st>>>(
      (const float*)a, (const float*)b, (const float*)a2, (const float*)b2,
      (float*)out, N, M, D);
  return (int)cudaGetLastError();
}
