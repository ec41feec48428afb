// K2: fused k-means assign-and-accumulate (one Lloyd E+M data pass).
//
// Replaces the Pallas kernel `kmeans_assign_update` (body `_kernel`) of
// src/repro/kernels/kmeans_assign.py.  Returns, for x (N, D) and centroids
// (K, D): assign (N,) = argmin_k ||x - c_k||^2 (first index on ties),
// min_dist (N,), per-centroid sums (K, D) and counts (K,).
//
// What bounds it on an H100: the distance tile is 2*N*K*D FMAs in fp32; at
// the largest call of the build (N = 1M points against K ~ 2e4 centroids
// in enforce_size_bound) that is ~5 TFLOP against 67 TFLOP/s of fp32 CUDA
// cores, while the bytes are only (N + K) * D * 4.  So it is bound by
// operations.  The hierarchical splitter's many small calls go to the
// batched kernel K23 (kmeans_batched.cu) instead, which repeats this
// kernel's arithmetic bit for bit: row norms (one warp per row, lane-strided
// fmaf, xor tree), the dot as sequential fmaf over d, repro::kmeans_dist and
// repro::argmin_before (a NaN distance wins, the first NaN first).
//
// What the design does about it: the E-step is a tiled fp32 product fused
// with the running argmin, so the (N, K) distance matrix never leaves
// registers.  A block owns 128 rows of x and sweeps every centroid:
//
//  * its rows stay in shared memory for the whole sweep (transposed, d-major,
//    128 x 128 floats = 66 KB at D <= 128; a wider D is staged in chunks of
//    128 columns, reloaded for each centroid tile);
//  * the centroids are first transposed once into a zero-padded (Dp, Kp)
//    scratch, so tiles of 128 centroids x 32 columns stream through a
//    2-stage ring of 16-byte cp.async copies (the next tile loads while the
//    current one is multiplied), each with its 128 centroid norms;
//  * each of 256 threads keeps an 8 x 8 register tile (rows ty*4 + {0..3}
//    and 64 + ty*4 + {0..3}, likewise the columns), fed by four float4
//    shared-memory reads per column of D: 64 FMAs per 4 loads.  At 103 KB of
//    shared memory and at most 128 registers a thread, two blocks share an
//    SM, so one block's barrier waits hide behind the other's FMAs;
//  * the argmin compares one integer key per distance (a NaN is -1, any
//    other distance, never negative after the clamp, its bits), with no
//    branch, and the 16 threads of a row combine (key, index) pairs.
//
// Each (row, centroid) dot is still one fmaf chain over d in increasing
// order from 0 (zero padding leaves it unchanged), and the key order is
// repro::argmin_before's, so the kernel gives the assignments and distances
// of the earlier 64 x 64 design bit for bit (a NaN min distance comes out as
// the canonical NaN); no split over D, no TF32, no tensor cores.
//
// The M-step must be deterministic (the build's content hash is asserted
// equal across runs and resumes), so there are no float atomics: integer
// atomics count points per (segment of 2048 points, cluster), a column scan
// turns those into per-segment bases, a single-block scan gives CSR
// offsets, one warp per segment scatters point indices in index order
// (__match_any_sync ranks equal clusters inside a warp), and one block per
// cluster sums its members' rows in index order.  The sums follow the
// reference's one-hot fold (onehot(assign)^T @ x, where 0 x NaN and 0 x inf
// are NaN): the row-norm pass counts the non-finite coordinates of each
// column, and sums[k, d] is NaN when column d holds one outside cluster k.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // block tile; D per ring stage
constexpr int DX = 128;                     // columns of x held at once
constexpr int STAGES = 2;
constexpr int XS_LD = BM + 4;               // xs[k][m] row stride
constexpr int CS_LD = BN + 4;               // cs[stage][k][n] row stride
constexpr int kAssignThreads = 256;         // 16 x 16 threads, 8 x 8 each
constexpr int kNoKey = 0x7fffffff;          // no centroid seen yet
constexpr unsigned kFull = 0xffffffffu;
static_assert(DX % BK == 0, "an x chunk holds whole ring stages");

__host__ __device__ constexpr size_t assign_smem_bytes() {
  return ((size_t)DX * XS_LD + (size_t)STAGES * BK * CS_LD +
          (size_t)STAGES * BN + BM) * 4;
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// Squared norm of each row; one warp per row, fixed reduction order.  With
// col_bad, also counts each column's non-finite entries (rare: one integer
// atomic each).
__global__ void row_norms_kernel(const float* __restrict__ a,
                                 float* __restrict__ out, int n, int D,
                                 int* __restrict__ col_bad) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = a[(size_t)row * D + d];
    s = fmaf(v, v, s);
    if (col_bad != nullptr && !isfinite(v)) atomicAdd(&col_bad[d], 1);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[row] = s;
}

// ct[d, n] = c[n, d] for d < Dp, n < Kp, zero outside (K, D)
__global__ void transpose_kernel(const float* __restrict__ c,
                                 float* __restrict__ ct, int K, int D,
                                 int kp) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;   // 32 x 8
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r, d = d0 + tx;
    tile[r][tx] = (n < K && d < D) ? c[(size_t)n * D + d] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8)
    ct[(size_t)(d0 + r) * kp + n0 + tx] = tile[tx][r];
}

// the argmin key: a NaN first, then the distance (>= +0, so its bits order
// as the value), as repro::argmin_before
__device__ __forceinline__ int dist_key(float d) {
  return isnan(d) ? -1 : __float_as_int(d);
}

__global__ void __launch_bounds__(kAssignThreads, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ ct,
              const float* __restrict__ x2, const float* __restrict__ c2,
              int* __restrict__ assign, float* __restrict__ min_dist, int N,
              int K, int D) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [DX][XS_LD]
  float* cs = xs + DX * XS_LD;               // [STAGES][BK][CS_LD]
  float* c2s = cs + STAGES * BK * CS_LD;     // [STAGES][BN], by tile
  float* xns = c2s + STAGES * BN;            // [BM]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int kp = round_up(K, BN);
  const int ks_n = (D + BK - 1) / BK;        // ring stages per centroid tile
  const int total = (kp / BN) * ks_n;
  const bool resident = D <= DX;

  // stage `step` of the sweep: centroids n0.., columns k0..k0+BK of ct, and
  // with a tile's first stage its centroid norms (ring slot tile % STAGES:
  // tile t + STAGES loads only after tile t's last stage was used)
  auto issue = [&](int step) {
    if (step < total) {
      const int nt = step / ks_n;
      const int n0 = nt * BN;
      const int k0 = (step - nt * ks_n) * BK;
      float* dst = cs + (step % STAGES) * BK * CS_LD;
      for (int e = tid; e < BK * BN / 4; e += kAssignThreads) {
        const int k = e / (BN / 4), n4 = e - k * (BN / 4);
        cp_async16(dst + k * CS_LD + 4 * n4,
                   ct + (size_t)(k0 + k) * kp + n0 + 4 * n4);
      }
      if (k0 == 0 && tid < BN / 4)
        cp_async16(c2s + (nt % STAGES) * BN + 4 * tid, c2 + n0 + 4 * tid);
    }
    cp_async_commit();                       // empty groups keep the count
  };
  // x columns dx0.. of the block's rows into xs, transposed, zero-padded
  auto load_x = [&](int dx0) {
    for (int e = tid; e < BM * DX; e += kAssignThreads) {
      const int m = e / DX, k = e - (e / DX) * DX;
      const int gm = m0 + m, gk = dx0 + k;
      xs[k * XS_LD + m] = (gm < N && gk < D) ? x[(size_t)gm * D + gk] : 0.0f;
    }
  };

  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  if (resident) load_x(0);
  if (tid < BM) xns[tid] = m0 + tid < N ? x2[m0 + tid] : 0.0f;

  int best_k[8], best_j[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_k[i] = kNoKey;
    best_j[i] = kNoKey;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // stage `step` landed; stage step - 1 is free
    issue(step + STAGES - 1);
    const int nt = step / ks_n;
    const int k0 = (step - nt * ks_n) * BK;
    if (!resident && k0 % DX == 0) {
      load_x(k0);
      __syncthreads();
    }
    const float* xk = xs + (k0 % DX) * XS_LD;
    const float* ck = cs + (step % STAGES) * BK * CS_LD;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* xr = xk + kk * XS_LD + ty * 4;
      const float* cr = ck + kk * CS_LD + tx * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(xr);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(cr);
      const float4 b1 = *reinterpret_cast<const float4*>(cr + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (k0 + BK >= D) {
      // the tile's dots are complete: each thread visits its columns in
      // increasing index and keeps the first least key
      const int n0 = nt * BN;
      const float* cn = c2s + (nt % STAGES) * BN;
      const float4 c0 = *reinterpret_cast<const float4*>(cn + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(cn + 64 + tx * 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float4 x0 = *reinterpret_cast<const float4*>(xns + ty * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(xns + 64 + ty * 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gj = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = repro::kmeans_dist(xv[i], acc[i][j], cv[j]);
          const int key = gj < K ? dist_key(d) : kNoKey;
          const bool take = key < best_k[i];
          best_k[i] = take ? key : best_k[i];
          best_j[i] = take ? gj : best_j[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();

  // combine the 16 threads of a row group: the least (key, index)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int key = best_k[i], j = best_j[i];
    for (int off = 8; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(kFull, key, off);
      const int oj = __shfl_xor_sync(kFull, j, off);
      if (ok < key || (ok == key && oj < j)) {
        key = ok;
        j = oj;
      }
    }
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (tx == 0 && gm < N) {
      assign[gm] = j == kNoKey ? 0 : j;
      min_dist[gm] = key == -1 ? CUDART_NAN_F : __int_as_float(key);
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

// sums[k, d] = sum of x[m, d] over the members of cluster k, in index order;
// NaN when column d holds a non-finite coordinate outside cluster k (the
// reference's one-hot fold: col_bad[d] counts them all, `own` k's share)
__global__ void segment_sum_kernel(const float* __restrict__ x,
                                   const int* __restrict__ members,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ col_bad,
                                   float* __restrict__ sums, int D) {
  const int k = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int lo = offsets[k], hi = offsets[k + 1];
  float s = 0.0f;
  int own = 0;
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
    own += !isfinite(v0) + !isfinite(v1) + !isfinite(v2) + !isfinite(v3);
  }
  for (; m < hi; ++m) {
    const float v = x[(size_t)members[m] * D + d];
    s += v;
    own += !isfinite(v);
  }
  sums[(size_t)k * D + d] = col_bad[d] > own ? CUDART_NAN_F : s;
}

}  // namespace

extern "C" int kmeans_assign_update_launch(
    const void* x, const void* cents, void* assign, void* min_dist, void* sums,
    void* counts, void* x2, void* c2, void* ct, void* hist, void* offsets,
    void* members, void* col_bad, int N, int K, int D, int seg,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_seg = (N + seg - 1) / seg;
  const int kp = round_up(K, BN), dp = round_up(D, BK);
  cudaMemsetAsync(col_bad, 0, (size_t)D * sizeof(int), st);
  REPRO_RETURN_IF_ERROR();
  row_norms_kernel<<<(N + 7) / 8, 256, 0, st>>>((const float*)x, (float*)x2,
                                                N, D, (int*)col_bad);
  REPRO_RETURN_IF_ERROR();
  cudaMemsetAsync(c2, 0, (size_t)kp * sizeof(float), st);
  REPRO_RETURN_IF_ERROR();
  row_norms_kernel<<<(K + 7) / 8, 256, 0, st>>>((const float*)cents,
                                                (float*)c2, K, D, nullptr);
  REPRO_RETURN_IF_ERROR();
  transpose_kernel<<<dim3(kp / 32, dp / 32), 256, 0, st>>>(
      (const float*)cents, (float*)ct, K, D, kp);
  REPRO_RETURN_IF_ERROR();
  cudaFuncSetAttribute(assign_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)assign_smem_bytes());
  REPRO_RETURN_IF_ERROR();
  assign_kernel<<<(N + BM - 1) / BM, kAssignThreads, assign_smem_bytes(),
                  st>>>((const float*)x, (const float*)ct, (const float*)x2,
                        (const float*)c2, (int*)assign, (float*)min_dist, N,
                        K, D);
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
  segment_sum_kernel<<<grid, 128, 0, st>>>(
      (const float*)x, (const int*)members, (const int*)offsets,
      (const int*)col_bad, (float*)sums, D);
  return (int)cudaGetLastError();
}
