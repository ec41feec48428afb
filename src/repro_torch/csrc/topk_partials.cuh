// Pieces shared by the two fused scans, B2 (ivf_scan_topk.cu) and K1
// (ivf_scan_q8.cu): the cp.async helpers, a warp's unique-by-id top-k2
// buffer (sorted in the warp's registers at k2 <= 32, else in shared
// memory), and the kernel that merges a query's partial top-k2s, one per
// block (or warp) of its split plan.  Everything here has internal linkage,
// so each source that includes it gets its own copy.
#pragma once

#include "common.cuh"

namespace {

constexpr int kHeads = 4;              // partials per lane in the merge
constexpr int kMaxChunks = 32 * kHeads;  // partials a query may have
constexpr int kMergeThreads = 128;
constexpr int kMaxPartials = 12 * 1024;  // partials x k2 staged by the merge
constexpr unsigned kFull = 0xffffffffu;

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

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

// Insert (dd, id), dd below the buffer's worst, into a warp's sorted
// register buffer: lane j < k2 holds the j-th smallest entry, empty entries
// are (+inf, -1), unique by id with the per-id minimum.  An entry of the
// same id at lane h is dropped (unless it is not above dd: then dd is), else
// the worst one; dd goes in after the entries not above it, and the entries
// between move up a lane.  Two ballots and a shift, no search of the buffer.
__device__ __forceinline__ void reg_insert(float dd, int id, int k2, int lane,
                                           float& rd, int& ri, float& worst) {
  const unsigned hm = __ballot_sync(kFull, lane < k2 && ri == id);
  int h = k2 - 1;
  if (hm) {
    h = __ffs(hm) - 1;
    if (!(dd < __shfl_sync(kFull, rd, h))) return;
  }
  const int pos = __popc(__ballot_sync(kFull, lane < k2 && rd <= dd));
  const float ud = __shfl_up_sync(kFull, rd, 1);
  const int ui = __shfl_up_sync(kFull, ri, 1);
  if (lane == pos) {
    rd = dd;
    ri = id;
  } else if (lane > pos && lane <= h) {
    rd = ud;
    ri = ui;
  }
  worst = __shfl_sync(kFull, rd, k2 - 1);
}

// Lexicographic (distance, chunk) order of the merge's heads.
__device__ __forceinline__ bool head_before(float d1, int c1, float d2,
                                            int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

// One block per query: stage its partials in shared memory while warp 0
// finds the last chunk that wiped (c0), then one warp merges the chunks
// from c0 on into the top-k2, unique by id.  Lane l owns chunks l, l + 32,
// ...; each round the warp takes the least head in (distance, chunk)
// order, emits it unless its id was emitted already (the first, smallest,
// entry of an id wins), and its owner advances.
__global__ void __launch_bounds__(kMergeThreads)
f32_topk_merge_kernel(const float* __restrict__ part_d,
                      const int* __restrict__ part_i,
                      const int* __restrict__ part_nan,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int k2, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = k2 | 1;                  // odd stride: lanes hit all banks
  float* sd = reinterpret_cast<float*>(smem);          // n_chunks x ld
  int* si = reinterpret_cast<int*>(sd + n_chunks * ld);  // n_chunks x ld
  int* ob_i = si + n_chunks * ld;                      // k2
  float* ob_d = reinterpret_cast<float*>(ob_i + k2);   // k2
  __shared__ int first;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t gq = blockIdx.x;

  const size_t base = gq * n_chunks * k2;
  for (int e = tid; e < n_chunks * k2; e += kMergeThreads) {
    const int c = e / k2, p = e - (e / k2) * k2;  // all in flight at once
    cp_async4(sd + c * ld + p, part_d + base + e);
    cp_async4(si + c * ld + p, part_i + base + e);
  }
  cp_async_commit();
  if (tid < 32) {                        // n_chunks <= 32 * kHeads
    int c0 = 0;
#pragma unroll
    for (int m = 0; m < kHeads; ++m) {
      const int c = lane + 32 * m;
      if (c < n_chunks && part_nan[gq * n_chunks + c]) c0 = c;
    }
    for (int off = 16; off > 0; off >>= 1)
      c0 = max(c0, __shfl_xor_sync(kFull, c0, off));
    if (lane == 0) first = c0;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid >= 32) return;
  const int c0 = first;

  // Each lane keeps the heads of its chunks (lane + 32 m) from c0 on in
  // registers; only the owner of the head taken reloads it.
  int pos[kHeads];
  float hd[kHeads];
  int hid[kHeads];
#pragma unroll
  for (int m = 0; m < kHeads; ++m) {
    const int c = lane + 32 * m;
    const bool ok = c0 <= c && c < n_chunks;
    pos[m] = 0;
    hd[m] = ok ? sd[c * ld] : CUDART_INF_F;
    hid[m] = ok ? si[c * ld] : -1;
  }
  int n_out = 0;
  while (n_out < k2) {
    float bd = CUDART_INF_F;             // this lane's least head
    int bc = 0x7fffffff, bid = -1;
#pragma unroll
    for (int m = 0; m < kHeads; ++m) {
      const int c = lane + 32 * m;
      if (hd[m] < CUDART_INF_F && head_before(hd[m], c, bd, bc)) {
        bd = hd[m];
        bc = c;
        bid = hid[m];
      }
    }
    // The warp's least head: the least distance (a distance is >= 0, so
    // its bits order as it does once -0 counts as 0), then the least chunk
    // among the heads at that distance.  Its owner holds its id.
    const unsigned kd = __float_as_uint(bd) & 0x7fffffffu;
    const unsigned md = __reduce_min_sync(kFull, kd);
    if (md >= 0x7f800000u) break;        // every partial is exhausted
    const int wc = (int)__reduce_min_sync(
        kFull, kd == md ? (unsigned)bc : 0xffffffffu);
    const float wd = __shfl_sync(kFull, bd, wc & 31);
    const int wid = __shfl_sync(kFull, bid, wc & 31);
    bool dup = false;
    for (int j = lane; j < n_out; j += 32) dup |= ob_i[j] == wid;
    if (!__any_sync(kFull, dup)) {
      if (lane == 0) {
        ob_d[n_out] = wd;
        ob_i[n_out] = wid;
      }
      ++n_out;
    }
#pragma unroll
    for (int m = 0; m < kHeads; ++m) {   // the owner of chunk wc advances
      const int c = lane + 32 * m;
      if (c == wc) {
        const int p = ++pos[m];
        hd[m] = p < k2 ? sd[c * ld + p] : CUDART_INF_F;
        hid[m] = p < k2 ? si[c * ld + p] : -1;
      }
    }
    __syncwarp();
  }
  for (int j = lane; j < k2; j += 32) {
    out_d[gq * k2 + j] = j < n_out ? ob_d[j] : CUDART_INF_F;
    out_i[gq * k2 + j] = j < n_out ? ob_i[j] : -1;
  }
}

// Launch the merge over n_queries queries of n_chunks partials of k2
// entries each (1 <= n_chunks <= kMaxChunks, n_chunks * k2 <=
// kMaxPartials); returns cudaGetLastError().
inline int launch_topk_merge(const float* part_d, const int* part_i,
                             const int* part_nan, float* out_d, int* out_i,
                             int n_queries, int k2, int n_chunks,
                             cudaStream_t st) {
  const size_t msmem = ((size_t)2 * n_chunks * (k2 | 1) + 2 * k2) * 4;
  static const size_t room =
      repro::default_dynamic_smem(f32_topk_merge_kernel);
  if (msmem > room) {
    cudaFuncSetAttribute(f32_topk_merge_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)msmem);
    REPRO_RETURN_IF_ERROR();
  }
  f32_topk_merge_kernel<<<n_queries, kMergeThreads, msmem, st>>>(
      part_d, part_i, part_nan, out_d, out_i, k2, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace
