// K1: fused int8-residual posting scan with in-kernel dedup top-k2.
//
// Replaces the Pallas kernel `ivf_scan_q8_topk` (body `_qtile_topk_q8_kernel`)
// of src/repro/kernels/ivf_scan_q8.py.  Per query b it walks the deduped,
// sorted probe plan from plan_tile_probes (tile_cids / qsel with one query
// per tile) and, for every live packed row r, computes
//
//   d = ||q - c_r||^2 - 2 s_r (q - c_r) . r8 + s_r^2 ||r8||^2,
//
// clamped at 0 (a NaN stays NaN, as jnp.maximum keeps it), masks slots whose
// id is < 0, and merges the row into a running top-k2 that is unique by id
// (per-id minimum).  Output is ascending, padded (+inf, -1).  A NaN distance
// of a live row empties the buffer at that slot, as the reference's
// _extract_topk does (jnp.min gives NaN, so it emits (+inf, -1) k2 times and
// kills nothing): only later slots refill it.  The port plans one query a
// tile; its slots come in ascending cluster order, the order in which the
// reference's tiles of 8 visit that query's clusters, so the wipes agree.
//
// What bounds it on an H100: at serving shapes (B = 32 queries, ~16 probes,
// L = D = 128, k2 = 24) the bytes are tiny (a few MB of codes, mostly L2
// hits) and the FMAs are 2*B*P*L*D ~ 17 MFLOP, so the kernel is bound by
// latency: one block walks its probes one after the other and the top-k2
// merge is serial per candidate.  The roofline bound is the union's bytes
// over 3.35 TB/s.
//
// What the design does about it: one block per query, so a batch of B queries
// fills B SMs; the (L, D) int8 block is staged into shared memory with
// coalesced 4-byte loads and a padded row stride (D/4 + 1 words) so that each
// thread reads its own slot's row without bank conflicts; q - c is kept in
// shared memory and read as a broadcast.  Distances are computed in fp32 on
// CUDA cores (bf16 would break the 1e-3 candidate tolerance).  The merge runs
// on one warp: a ballot keeps only candidates below the current worst, so
// after the buffer fills almost every slot is rejected in one instruction.
// Multi-query tiles (one code block feeding several queries) are the next
// step once batches grow.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

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
q8_topk_kernel(const int8_t* __restrict__ q8, const float* __restrict__ scale,
               const float* __restrict__ norm2, const float* __restrict__ cent,
               const int* __restrict__ ids, const int* __restrict__ tile_cids,
               const int* __restrict__ qsel, const float* __restrict__ queries,
               float* __restrict__ out_d, int* __restrict__ out_i,
               int P, int L, int D, int k2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpr = D / 4;                 // code words per slot row
  const int row_words = wpr + 1;         // padded stride: conflict-free reads
  int* blk = reinterpret_cast<int*>(smem);
  float* q = reinterpret_cast<float*>(blk + (size_t)L * row_words);
  float* qc = q + D;
  float* cd = qc + D;
  int* ci = reinterpret_cast<int*>(cd + L);
  float* bd = reinterpret_cast<float*>(ci + L);
  int* bi = reinterpret_cast<int*>(bd + k2);
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int d = tid; d < D; d += kThreads) q[d] = queries[(size_t)b * D + d];
  for (int j = tid; j < k2; j += kThreads) {
    bd[j] = CUDART_INF_F;
    bi[j] = -1;
  }
  float worst = CUDART_INF_F;            // meaningful in warp 0 only
  int worst_pos = k2 - 1;
  __syncthreads();

  for (int s = 0; s < P; ++s) {
    if (qsel[(size_t)b * P + s] == 0) continue;   // uniform in the block
    const int r = tile_cids[(size_t)b * P + s];
    const int* src = reinterpret_cast<const int*>(q8 + (size_t)r * L * D);
    for (int w = tid; w < L * wpr; w += kThreads) {
      const int l = w / wpr;
      blk[l * row_words + (w - l * wpr)] = src[w];
    }
    float part = 0.0f;
    for (int d = tid; d < D; d += kThreads) {
      const float v = q[d] - cent[(size_t)r * D + d];
      qc[d] = v;
      part = fmaf(v, v, part);
    }
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float qcn = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) qcn += red[w];
    const float sc = scale[r];

    bool nan_here = false;
    for (int l = tid; l < L; l += kThreads) {
      const int* row = blk + l * row_words;
      float cross = 0.0f;
      for (int c = 0; c < wpr; ++c) {
        const int word = row[c];
        const float* qq = qc + 4 * c;
        cross = fmaf(qq[0], (float)(int8_t)(word & 0xff), cross);
        cross = fmaf(qq[1], (float)(int8_t)((word >> 8) & 0xff), cross);
        cross = fmaf(qq[2], (float)(int8_t)((word >> 16) & 0xff), cross);
        cross = fmaf(qq[3], (float)(int8_t)((word >> 24) & 0xff), cross);
      }
      float dist = qcn - 2.0f * sc * cross + norm2[(size_t)r * L + l];
      dist = dist < 0.0f ? 0.0f : dist;
      const int id = ids[(size_t)r * L + l];
      nan_here |= id >= 0 && isnan(dist);
      cd[l] = id >= 0 ? dist : CUDART_INF_F;
      ci[l] = id;
    }
    if (__syncthreads_or(nan_here)) {
      // the reference's wipe: nothing of this slot or before survives
      for (int j = tid; j < k2; j += kThreads) {
        bd[j] = CUDART_INF_F;
        bi[j] = -1;
      }
      worst = CUDART_INF_F;
      worst_pos = k2 - 1;
    } else if (warp == 0) {
      // Sequential merge semantics, one candidate at a time: an id already
      // in the buffer keeps its smaller distance, a new id replaces the
      // current worst when strictly better.  Candidates not below the worst
      // at ballot time can never enter (the worst only decreases).
      for (int base = 0; base < L; base += 32) {
        const int l = base + lane;
        const float mine_d = l < L ? cd[l] : CUDART_INF_F;
        const int mine_i = l < L ? ci[l] : -1;
        unsigned m = __ballot_sync(kFull, mine_d < worst);
        while (m) {
          const int srcl = __ffs(m) - 1;
          m &= m - 1;
          const float dd = __shfl_sync(kFull, mine_d, srcl);
          const int id = __shfl_sync(kFull, mine_i, srcl);
          if (!(dd < worst)) continue;
          int hit = -1;
          for (int j = lane; j < k2; j += 32)
            if (bi[j] == id) hit = j;
          const unsigned hm = __ballot_sync(kFull, hit >= 0);
          if (hm) {
            const int pos = __shfl_sync(kFull, hit, __ffs(hm) - 1);
            if (lane == 0 && dd < bd[pos]) bd[pos] = dd;
          } else if (lane == 0) {
            bd[worst_pos] = dd;
            bi[worst_pos] = id;
          }
          __syncwarp();
          find_worst(bd, k2, lane, worst, worst_pos);
        }
      }
    }
    __syncthreads();
  }

  // ascending output: rank of (distance, slot) among the k2 buffer entries
  for (int j = tid; j < k2; j += kThreads) {
    const float v = bd[j];
    int rank = 0;
    for (int m = 0; m < k2; ++m) {
      const float u = bd[m];
      rank += (u < v) || (u == v && m < j);
    }
    const bool ok = v < CUDART_INF_F;
    out_d[(size_t)b * k2 + rank] = ok ? v : CUDART_INF_F;
    out_i[(size_t)b * k2 + rank] = ok ? bi[j] : -1;
  }
}

}  // namespace

extern "C" size_t ivf_scan_q8_topk_smem_bytes(int L, int D, int k2) {
  return (size_t)L * (D / 4 + 1) * 4 + (size_t)2 * D * 4 + (size_t)2 * L * 4 +
         (size_t)2 * k2 * 4;
}

extern "C" int ivf_scan_q8_topk_launch(
    const void* q8, const void* scale, const void* norm2, const void* cent,
    const void* ids, const void* tile_cids, const void* qsel,
    const void* queries, void* out_d, void* out_i, int B, int P, int L, int D,
    int k2, void* stream) {
  const size_t smem = ivf_scan_q8_topk_smem_bytes(L, D, k2);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(q8_topk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    REPRO_RETURN_IF_ERROR();
  }
  q8_topk_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const float*)scale, (const float*)norm2,
      (const float*)cent, (const int*)ids, (const int*)tile_cids,
      (const int*)qsel, (const float*)queries, (float*)out_d, (int*)out_i, P,
      L, D, k2);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
