// K23: batched Lloyd k-means, every iteration of many independent
// sub-problems in one launch.
//
// Stands in for the Pallas kernels `kmeans_assign_update` (body `_kernel`) of
// src/repro/kernels/kmeans_assign.py and `kmeans_mstep` (body `_kernel`) of
// src/repro/kernels/kmeans_mstep.py at the hierarchical splitter's shapes:
// there the reference runs, per tree node, `iters` rounds of assign-and-
// accumulate -> top-k worst-served -> M-step (repro/build/kmeans.py:kmeans).
// Sub-problem s is the rows pts[offs[s] .. offs[s+1]) of x, with k[s] <= 16
// centroids started at the local rows init[s, :k[s]].  Outputs: the last
// E-step's assignments and min distances (T,), the centroids after the last
// M-step (S, 16, D) and the last E-step's counts (S, 16); rows >= k are 0.
//
// What bounds it on an H100: a step must read its points once (T * D * 4
// bytes) and do 2 * T * k * D fp32 operations per iteration.  At a 1M
// build's largest step (100 chunks of 5000 x 128, k 8, 8 iterations) that is
// 0.08 ms of bytes against 0.12 ms of operations.  Each iteration re-reads
// the points, T * D * 4 bytes an iteration (0.6 ms in all there, from
// device memory once they outgrow L2), at k * 2 / 4 operations a byte, far
// under the card's 20: so the bytes of the points per iteration are what
// the design itself is bound by.  Before this kernel, each node's iteration
// was ten launches (K2's eight, K3's two) of microseconds of work plus a
// sort, a gather and host round trips, and a 1M build made 163,000 of them:
// the splitter was bound by launches.
//
// What the design does about it: one block per sub-problem, so the one
// launch of a step (100-200 sub-problems in a 1M build) fills the card, and
// the loop over iterations runs inside the block (the TPU's sequential grid
// becomes a loop).  The k centroids, their norms and the k x D sums stay in
// shared memory for the whole loop.  The block streams its points through
// two shared-memory tiles with cp.async (16 bytes a copy when D % 4 == 0),
// so the next tile's loads overlap the current tile's distances; each
// iteration re-reads the points from L2 / device memory.  The M-step and the
// reseed happen in the block, so nothing returns to the host between
// iterations.
//
// The arithmetic repeats K2 and K3 bit for bit, so a build hashes the same
// on either path: row norms one warp per row (lane-strided fmaf, xor tree),
// the dot as sequential fmaf over d, repro::kmeans_dist and
// repro::argmin_before; per-cluster sums in local row order from 0, as K2's
// segment_sum_kernel, with no float atomics, and its one-hot rule for a
// non-finite coordinate (a column that holds one outside cluster c makes
// c's sum NaN there; `owner` keeps, per column, the one cluster that holds
// its non-finite coordinates, or -2 for several); the n_empty worst-served
// points in descending min distance (a NaN first, the lower local index first
// among ties: torch.sort(descending=True, stable=True)); the mean as an
// IEEE division by max(count, 1), empty clusters taking the reseed rows in
// rank order, as K3.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;
constexpr int kTileBytes = 72 * 1024;  // both point tiles together
constexpr unsigned kFull = 0xffffffffu;

// Row stride of the shared point tiles and centroids: D rounded up to 4,
// plus 4, so a quarter-warp's float4 reads of 8 rows hit distinct banks.
__host__ __device__ inline int row_stride(int D) { return (D + 3) / 4 * 4 + 4; }

// Rows per point tile: the largest of 64, 32, 16, 8 whose two tiles fit.
__host__ inline int tile_rows(int D) {
  int tr = 64;
  while (tr > 8 && 2 * tr * row_stride(D) * 4 > kTileBytes) tr >>= 1;
  return tr;
}

__host__ inline size_t smem_bytes(int D, int TR) {
  const int LD = row_stride(D);
  const size_t floats = (size_t)kMaxK * LD + (size_t)kMaxK * D +
                        (size_t)2 * TR * LD + TR + kMaxK + kWarps;
  const size_t ints = (size_t)TR + 3 * kMaxK + kWarps + 4 + D;
  return floats * 4 + ints * 4;
}

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

// Descending min-distance order of the reseed: a NaN first, then the larger
// distance, then the lower index (torch.sort(descending=True, stable=True)).
__device__ __forceinline__ bool worst_before(float d1, int i1, float d2,
                                             int i2) {
  const bool n1 = isnan(d1), n2 = isnan(d2);
  if (n1 != n2) return n1;
  if (!n1 && d1 != d2) return d1 > d2;
  return i1 < i2;
}

// Squared norm of a shared-memory row by one warp, in row_norms_kernel's
// order (kmeans_assign.cu): lane-strided fmaf, then the xor tree.
__device__ __forceinline__ float warp_row_norm(const float* row, int D,
                                               int lane) {
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <int TR>
__global__ void __launch_bounds__(kThreads)
kmeans_batched_kernel(const float* __restrict__ x, const int* __restrict__ pts,
                      const int* __restrict__ offs, const int* __restrict__ ks,
                      const int* __restrict__ init, int iters, int D,
                      int* __restrict__ assign, float* __restrict__ min_dist,
                      float* __restrict__ cents_out,
                      int* __restrict__ counts_out) {
  constexpr int TPR = kThreads / TR;                 // threads per row
  constexpr int MAXJ = (kMaxK + TPR - 1) / TPR;      // centroids per thread
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads share a warp");
  extern __shared__ __align__(16) float smem[];
  const int LD = row_stride(D);
  float* cent = smem;                                // [16][LD]
  float* sums = cent + kMaxK * LD;                   // [16][D]
  float* tile = sums + kMaxK * D;                    // [2][TR][LD]
  float* xn = tile + 2 * TR * LD;                    // [TR]
  float* cn = xn + TR;                               // [16]
  float* red_d = cn + kMaxK;                         // [kWarps]
  int* ta = reinterpret_cast<int*>(red_d + kWarps);  // [TR]
  int* cnt = ta + TR;                                // [16]
  int* rank = cnt + kMaxK;                           // [16]
  int* wsel = rank + kMaxK;                          // [16]
  int* red_i = wsel + kMaxK;                         // [kWarps]
  int* n_empty = red_i + kWarps;                     // [4]
  int* owner = n_empty + 4;                          // [D]

  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int off = offs[s];
  const int n = offs[s + 1] - off;
  const int k = ks[s];
  const int* rows = pts + off;
  const int n_tiles = (n + TR - 1) / TR;
  const bool vec = (D & 3) == 0;
  const int D4 = D >> 2;

  // initial centroids and their norms
  for (int e = t; e < k * D; e += kThreads) {
    const int c = e / D, d = e - (e / D) * D;
    cent[c * LD + d] = x[(size_t)rows[init[s * kMaxK + c]] * D + d];
  }
  __syncthreads();
  for (int c = warp; c < k; c += kWarps) {
    const float v = warp_row_norm(cent + c * LD, D, lane);
    if (lane == 0) cn[c] = v;
  }

  auto load_tile = [&](int tix) {
    float* buf = tile + (tix & 1) * TR * LD;
    const int r0 = tix * TR;
    const int nr = min(TR, n - r0);
    if (vec) {
      for (int e = t; e < nr * D4; e += kThreads) {
        const int r = e / D4, q = e - (e / D4) * D4;
        cp_async16(buf + r * LD + 4 * q,
                   x + (size_t)rows[r0 + r] * D + 4 * q);
      }
    } else {
      for (int e = t; e < nr * D; e += kThreads) {
        const int r = e / D, d = e - (e / D) * D;
        cp_async4(buf + r * LD + d, x + (size_t)rows[r0 + r] * D + d);
      }
    }
    cp_async_commit();
  };

  const int G = min(kMaxK, max(1, kThreads / D));  // column groups of the sums
  const int last = max(1, iters) - 1;
  for (int it = 0; it <= last; ++it) {
    for (int e = t; e < kMaxK * D; e += kThreads) sums[e] = 0.0f;
    for (int e = t; e < D; e += kThreads) owner[e] = -1;
    if (t < kMaxK) cnt[t] = 0;
    __syncthreads();
    load_tile(0);
    for (int tix = 0; tix < n_tiles; ++tix) {
      if (tix + 1 < n_tiles) {
        load_tile(tix + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* buf = tile + (tix & 1) * TR * LD;
      const int r0 = tix * TR;
      const int nr = min(TR, n - r0);
      for (int r = warp; r < nr; r += kWarps) {
        const float v = warp_row_norm(buf + r * LD, D, lane);
        if (lane == 0) xn[r] = v;
      }
      __syncthreads();
      // E-step: thread (r, sub) takes centroids sub, sub + TPR, ...
      {
        const int r = t / TPR, sub = t - (t / TPR) * TPR;
        const float* xr = buf + r * LD;
        float acc[MAXJ];
#pragma unroll
        for (int m = 0; m < MAXJ; ++m) acc[m] = 0.0f;
        int d = 0;
        if (vec) {
          for (int q = 0; q < D4; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * q);
#pragma unroll
            for (int m = 0; m < MAXJ; ++m) {
              const int j = sub + m * TPR;
              if (j < k) {
                const float4 cv =
                    *reinterpret_cast<const float4*>(cent + j * LD + 4 * q);
                acc[m] = fmaf(xv.x, cv.x, acc[m]);
                acc[m] = fmaf(xv.y, cv.y, acc[m]);
                acc[m] = fmaf(xv.z, cv.z, acc[m]);
                acc[m] = fmaf(xv.w, cv.w, acc[m]);
              }
            }
          }
          d = D;
        }
        for (; d < D; ++d) {
          const float xv = xr[d];
#pragma unroll
          for (int m = 0; m < MAXJ; ++m) {
            const int j = sub + m * TPR;
            if (j < k) acc[m] = fmaf(xv, cent[j * LD + d], acc[m]);
          }
        }
        float bd = CUDART_INF_F;
        int bj = 0x7fffffff;
        const float xr2 = xn[r];
#pragma unroll
        for (int m = 0; m < MAXJ; ++m) {           // j ascending
          const int j = sub + m * TPR;
          if (j < k) {
            const float dd = repro::kmeans_dist(xr2, acc[m], cn[j]);
            if (isnan(dd) ? !isnan(bd) : dd < bd) {
              bd = dd;
              bj = j;
            }
          }
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) {
          const float od = __shfl_xor_sync(kFull, bd, o);
          const int oj = __shfl_xor_sync(kFull, bj, o);
          if (repro::argmin_before(od, oj, bd, bj)) {
            bd = od;
            bj = oj;
          }
        }
        if (sub == 0 && r < nr) {
          const int j = bj == 0x7fffffff ? 0 : bj;
          ta[r] = j;
          assign[off + r0 + r] = j;
          min_dist[off + r0 + r] = bd;
          atomicAdd(&cnt[j], 1);
        }
      }
      __syncthreads();
      // sums in local row order: thread (g, d) owns column d of the
      // clusters c with c % G == g
      for (int e = t; e < G * D; e += kThreads) {
        const int g = e / D, dcol = e - (e / D) * D;
        for (int r = 0; r < nr; ++r) {
          const int c = ta[r];
          if (c % G == g) {
            const float v = buf[r * LD + dcol];
            sums[c * D + dcol] += v;
            if (!isfinite(v)) {
              const int was = atomicCAS(&owner[dcol], -1, c);
              if (was != -1 && was != c) atomicExch(&owner[dcol], -2);
            }
          }
        }
      }
      __syncthreads();
    }

    // reseed: the n_empty worst-served points, in rank order
    if (t == 0) {
      int e = 0;
      for (int c = 0; c < k; ++c) {
        rank[c] = e;
        e += cnt[c] <= 0 ? 1 : 0;
      }
      *n_empty = e;
    }
    __syncthreads();
    const int ne = *n_empty;
    float pd = 0.0f;
    int pi = -1;
    for (int q = 0; q < ne; ++q) {
      float bd = 0.0f;
      int bi = -1;
      for (int i = t; i < n; i += kThreads) {
        const float v = min_dist[off + i];
        if ((pi < 0 || worst_before(pd, pi, v, i)) &&
            (bi < 0 || worst_before(v, i, bd, bi))) {
          bd = v;
          bi = i;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(kFull, bd, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (oi >= 0 && (bi < 0 || worst_before(od, oi, bd, bi))) {
          bd = od;
          bi = oi;
        }
      }
      if (lane == 0) {
        red_d[warp] = bd;
        red_i[warp] = bi;
      }
      __syncthreads();
      bd = red_d[0];
      bi = red_i[0];
      for (int w = 1; w < kWarps; ++w) {
        const float od = red_d[w];
        const int oi = red_i[w];
        if (oi >= 0 && (bi < 0 || worst_before(od, oi, bd, bi))) {
          bd = od;
          bi = oi;
        }
      }
      if (t == 0) wsel[q] = bi;
      pd = bd;
      pi = bi;
      __syncthreads();
    }

    // M-step, then the new centroids' norms
    for (int e = t; e < k * D; e += kThreads) {
      const int c = e / D, d = e - (e / D) * D;
      const int m = cnt[c];
      const int o = owner[d];
      const float sum = (o == -2 || (o >= 0 && o != c)) ? CUDART_NAN_F
                                                        : sums[c * D + d];
      cent[c * LD + d] = m <= 0 ? x[(size_t)rows[wsel[rank[c]]] * D + d]
                                : sum / fmaxf((float)m, 1.0f);
    }
    __syncthreads();
    for (int c = warp; c < k; c += kWarps) {
      const float v = warp_row_norm(cent + c * LD, D, lane);
      if (lane == 0) cn[c] = v;
    }
    __syncthreads();
  }

  for (int e = t; e < kMaxK * D; e += kThreads) {
    const int c = e / D, d = e - (e / D) * D;
    cents_out[(size_t)s * kMaxK * D + e] = c < k ? cent[c * LD + d] : 0.0f;
  }
  if (t < kMaxK) counts_out[s * kMaxK + t] = t < k ? cnt[t] : 0;
}

template <int TR>
int launch(const void* x, const void* pts, const void* offs, const void* ks,
           const void* init, int S, int iters, int D, void* assign,
           void* min_dist, void* cents, void* counts, cudaStream_t st) {
  const size_t smem = smem_bytes(D, TR);
  cudaFuncSetAttribute(kmeans_batched_kernel<TR>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  REPRO_RETURN_IF_ERROR();
  kmeans_batched_kernel<TR><<<S, kThreads, smem, st>>>(
      (const float*)x, (const int*)pts, (const int*)offs, (const int*)ks,
      (const int*)init, iters, D, (int*)assign, (float*)min_dist,
      (float*)cents, (int*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kmeans_batched_launch(const void* x, const void* pts,
                                     const void* offs, const void* ks,
                                     const void* init, void* assign,
                                     void* min_dist, void* cents,
                                     void* counts, int S, int iters, int D,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile_rows(D)) {
    case 64:
      return launch<64>(x, pts, offs, ks, init, S, iters, D, assign, min_dist,
                        cents, counts, st);
    case 32:
      return launch<32>(x, pts, offs, ks, init, S, iters, D, assign, min_dist,
                        cents, counts, st);
    case 16:
      return launch<16>(x, pts, offs, ks, init, S, iters, D, assign, min_dist,
                        cents, counts, st);
    default:
      return launch<8>(x, pts, offs, ks, init, S, iters, D, assign, min_dist,
                       cents, counts, st);
  }
}
