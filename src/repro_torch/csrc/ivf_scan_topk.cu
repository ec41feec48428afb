// B2: fused f32 posting scan with in-kernel dedup top-k2.
//
// Replaces the Pallas kernel `ivf_scan_topk` (body `_qtile_topk_kernel`) of
// src/repro/kernels/ivf_scan.py.  Queries are tiled in blocks of BQ = 8.  For
// every tile t the probe plan from plan_tile_probes lists S = BQ * P slots,
// sorted by cluster, with each cluster live in its first slot only; qsel
// says which queries of the tile probe that cluster.  For every live
// (query j, packed row r) pair the kernel computes
//
//   d = ||q||^2 - 2 q . p + ||p||^2,  clamped >= 0,
//
// masks slots whose id is < 0 (their payload may be uninitialised, even
// NaN: the mask is a select, so nothing of such a row reaches a
// comparison), and merges the row into query j's running top-k2, unique by
// id with the per-id minimum.  Output is ascending, padded (+inf, -1).
//
// What bounds it on an H100: at serving shapes (B = 32, P = 16, L = D = 128,
// k2 = 24) the union of probed rows is ~500 clusters x 64 KB = 32 MB of f32
// payload, 10 us at 3.35 TB/s, against 2*B*P*L*D ~ 17 MFLOP.  So the bound
// is bytes.  In practice it is latency: with one block per tile a batch of
// 32 queries runs on 4 SMs, and each block walks its ~120 clusters one after
// the other; the top-k2 merge is serial per candidate.
//
// What the design does about it: a cluster probed by several queries of the
// tile is read from device memory once (the point of the TPU design).  Its
// rows are staged in shared memory in chunks of LC rows (float4 loads,
// padded row stride D + 1 so each thread reads its own row without bank
// conflicts), and every thread computes one row's dot products with 4 of the
// tile's queries plus the row's norm in one pass.  The merge runs on one
// warp per query: a ballot keeps only candidates below the current worst, so
// after the buffer fills almost every candidate is rejected in one
// instruction.  Splitting a tile's clusters across blocks (with a second
// merge pass) is the next step once an end-to-end benchmark shows the scan
// on the critical path.
#include "common.cuh"

namespace {

constexpr int BQ = 8;                  // queries per tile (one warp each)
constexpr int QPG = 4;                 // queries per thread in the dot loop
constexpr int kThreads = 32 * BQ;
constexpr int kRowFloats = 24 * 1024;  // staged rows: LC * (D + 1) <= this
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int chunk_rows(int L, int D) {
  const int lc = kRowFloats / (D + 1);
  return lc < 1 ? 1 : (lc < L ? lc : L);
}

// Worst (largest distance) buffer slot; ties go to the highest slot index.
__device__ __forceinline__ void find_worst(const float* bd, int k2, int lane,
                                           float& worst, int& worst_pos) {
  float v = -1.0f;
  int p = -1;
  for (int j = lane; j < k2; j += 32) {
    float x = bd[j];
    if (x > v || (x == v && j > p)) { v = x; p = j; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFull, v, off);
    int op = __shfl_xor_sync(kFull, p, off);
    if (ov > v || (ov == v && op > p)) { v = ov; p = op; }
  }
  worst = v;
  worst_pos = p;
}

__global__ void __launch_bounds__(kThreads)
f32_topk_kernel(const float* __restrict__ post, const int* __restrict__ ids,
                const int* __restrict__ tile_cids,
                const int* __restrict__ qsel,
                const float* __restrict__ queries, float* __restrict__ out_d,
                int* __restrict__ out_i, int S, int L, int D, int k2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LC = chunk_rows(L, D);
  const int stride = D + 1;
  float* rows = reinterpret_cast<float*>(smem);           // LC x (D + 1)
  float* q = rows + (size_t)LC * stride;                   // BQ x D
  float* cd = q + BQ * D;                                  // BQ x LC
  int* ci = reinterpret_cast<int*>(cd + BQ * LC);          // LC
  float* bd = reinterpret_cast<float*>(ci + LC);           // BQ x k2
  int* bi = reinterpret_cast<int*>(bd + BQ * k2);          // BQ x k2
  __shared__ float q2[BQ];
  __shared__ int sel[BQ];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;             // the query this warp merges

  const float* qt = queries + (size_t)t * BQ * D;
  for (int e = tid; e < BQ * D; e += kThreads) q[e] = qt[e];
  for (int e = tid; e < BQ * k2; e += kThreads) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  __syncthreads();
  {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(q[warp * D + d], q[warp * D + d], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) q2[warp] = s;
  }
  float worst = CUDART_INF_F;          // of query `warp`'s buffer
  int worst_pos = k2 - 1;
  float* my_bd = bd + warp * k2;
  int* my_bi = bi + warp * k2;
  const int d4 = D / 4;

  for (int s = 0; s < S; ++s) {
    const int* qs = qsel + ((size_t)t * S + s) * BQ;
    __syncthreads();                     // previous slot's merge is done
    if (tid < BQ) sel[tid] = qs[tid];
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int j = 0; j < BQ; ++j) any |= sel[j] != 0;
    if (!any) continue;                  // uniform in the block
    const int r = tile_cids[(size_t)t * S + s];
    for (int l0 = 0; l0 < L; l0 += LC) {
      const int lc = min(LC, L - l0);
      const float4* src = reinterpret_cast<const float4*>(
          post + ((size_t)r * L + l0) * D);
      for (int w = tid; w < lc * d4; w += kThreads) {
        const int l = w / d4;
        const int c = (w - l * d4) * 4;
        const float4 v = src[w];
        float* dst = rows + l * stride + c;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      for (int l = tid; l < lc; l += kThreads)
        ci[l] = ids[(size_t)r * L + l0 + l];
      __syncthreads();

      for (int w = tid; w < lc * (BQ / QPG); w += kThreads) {
        const int l = w % lc;
        const int g = w / lc;
        const float* row = rows + l * stride;
        const float* qq = q + g * QPG * D;
        float dot[QPG];
#pragma unroll
        for (int j = 0; j < QPG; ++j) dot[j] = 0.0f;
        float pn = 0.0f;
        for (int c = 0; c < D; ++c) {
          const float p = row[c];
          pn = fmaf(p, p, pn);
#pragma unroll
          for (int j = 0; j < QPG; ++j) dot[j] = fmaf(qq[j * D + c], p, dot[j]);
        }
        const bool live = ci[l] >= 0;
#pragma unroll
        for (int j = 0; j < QPG; ++j) {
          const int qj = g * QPG + j;
          const float dist = fmaxf(q2[qj] - 2.0f * dot[j] + pn, 0.0f);
          cd[qj * LC + l] = (live && sel[qj] != 0) ? dist : CUDART_INF_F;
        }
      }
      __syncthreads();

      if (sel[warp] != 0) {
        // Sequential merge semantics, one candidate at a time: an id already
        // in the buffer keeps its smaller distance, a new id replaces the
        // current worst when strictly better.  Candidates not below the
        // worst at ballot time can never enter (the worst only decreases).
        const float* my_cd = cd + warp * LC;
        for (int base = 0; base < lc; base += 32) {
          const int l = base + lane;
          const float mine_d = l < lc ? my_cd[l] : CUDART_INF_F;
          const int mine_i = l < lc ? ci[l] : -1;
          unsigned m = __ballot_sync(kFull, mine_d < worst);
          while (m) {
            const int srcl = __ffs(m) - 1;
            m &= m - 1;
            const float dd = __shfl_sync(kFull, mine_d, srcl);
            const int id = __shfl_sync(kFull, mine_i, srcl);
            if (!(dd < worst)) continue;
            int hit = -1;
            for (int j = lane; j < k2; j += 32)
              if (my_bi[j] == id) hit = j;
            const unsigned hm = __ballot_sync(kFull, hit >= 0);
            if (hm) {
              const int pos = __shfl_sync(kFull, hit, __ffs(hm) - 1);
              if (lane == 0 && dd < my_bd[pos]) my_bd[pos] = dd;
            } else if (lane == 0) {
              my_bd[worst_pos] = dd;
              my_bi[worst_pos] = id;
            }
            __syncwarp();
            find_worst(my_bd, k2, lane, worst, worst_pos);
          }
        }
      }
      __syncthreads();                   // rows / cd / ci are reused
    }
  }
  __syncthreads();

  // ascending output: rank of (distance, slot) among the k2 buffer entries
  const size_t ob = ((size_t)t * BQ + warp) * k2;
  for (int j = lane; j < k2; j += 32) {
    const float v = my_bd[j];
    int rank = 0;
    for (int m = 0; m < k2; ++m) {
      const float u = my_bd[m];
      rank += (u < v) || (u == v && m < j);
    }
    const bool ok = v < CUDART_INF_F;
    out_d[ob + rank] = ok ? v : CUDART_INF_F;
    out_i[ob + rank] = ok ? my_bi[j] : -1;
  }
}

}  // namespace

extern "C" size_t ivf_scan_topk_smem_bytes(int L, int D, int k2) {
  const size_t lc = (size_t)chunk_rows(L, D);
  return lc * (D + 1) * 4 + (size_t)BQ * D * 4 + (size_t)BQ * lc * 4 +
         lc * 4 + (size_t)2 * BQ * k2 * 4;
}

extern "C" int ivf_scan_topk_launch(const void* post, const void* ids,
                                    const void* tile_cids, const void* qsel,
                                    const void* queries, void* out_d,
                                    void* out_i, int n_tiles, int S, int L,
                                    int D, int k2, void* stream) {
  const size_t smem = ivf_scan_topk_smem_bytes(L, D, k2);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(f32_topk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    REPRO_RETURN_IF_ERROR();
  }
  f32_topk_kernel<<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)post, (const int*)ids, (const int*)tile_cids,
      (const int*)qsel, (const float*)queries, (float*)out_d, (int*)out_i, S,
      L, D, k2);
  return (int)cudaGetLastError();
}
