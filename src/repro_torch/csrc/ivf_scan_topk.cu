// B2: fused f32 posting scan with in-kernel dedup top-k2.
//
// Replaces the Pallas kernel `ivf_scan_topk` (body `_qtile_topk_kernel`) of
// src/repro/kernels/ivf_scan.py.  Queries are tiled in blocks of BQ = 8.  For
// every tile t the probe plan from plan_tile_probes lists S = BQ * P slots,
// sorted by cluster, with each cluster live in its first slot only; qsel
// says which queries of the tile probe that cluster.  For every live
// (query j, packed row r) pair the kernel computes
//
//   d = ||q||^2 - 2 q . p + ||p||^2,  clamped at 0 (a NaN stays NaN),
//
// masks slots whose id is < 0 (their payload may be uninitialised, even
// NaN: the mask is a select, so nothing of such a row reaches a
// comparison), and merges the row into query j's running top-k2, unique by
// id with the per-id minimum.  Output is ascending, padded (+inf, -1).
//
// A NaN distance of a live row follows the reference: its _extract_topk
// gets a NaN from jnp.min, emits (+inf, -1) k2 times and kills nothing, so
// the query's buffer is empty after that slot and only later slots refill
// it.  Here a query's buffer is wiped at the end of any slot in which one
// of its live rows gave a NaN.
//
// What bounds it on an H100: at serving shapes (B = 32, P = 16, L = D = 128,
// k2 = 24) the union of probed rows is ~460 clusters x 64 KB = 30 MB of f32
// payload, 9 us at 3.35 TB/s, against 2*B*P*L*D ~ 17 MFLOP.  So the bound
// is bytes, and reaching it needs most SMs loading at once.
//
// What the design does about it: a cluster probed by several queries of the
// tile is read from device memory once (the point of the TPU design), and a
// tile's sorted slots are split into n_chunks contiguous chunks, one block
// per (tile, chunk), so a batch of 32 queries (4 tiles) runs on hundreds of
// blocks instead of 4.  A block streams its live slots' rows through two
// shared-memory buffers of LC rows with cp.async (the next chunk of rows
// loads while the current one is scored), each thread scoring one row
// against 4 of the tile's queries with float4 reads (row stride D + 4, so a
// quarter-warp's rows fall in distinct banks).  The merge runs on one warp
// per query: a ballot keeps only candidates below the current worst, so
// after the buffer fills almost every candidate is rejected in one
// instruction; at k2 <= 32 the buffer is kept sorted in the warp's
// registers.  Each block writes its queries' partial top-k2 (sorted,
// unique by id) and whether it wiped them for a NaN; a second kernel merges
// a query's partials, staged in shared memory, with one warp: the chunks
// before the last one that wiped are dropped (that chunk's partial holds
// only rows after its NaN), the rest are merged in (distance, chunk, rank)
// order, keeping each id's first (smallest) entry.  The order depends only
// on the data, never on which block finished first.  The result is exact:
// an id of the global top-k2 is in the top-k2 of the chunk that holds its
// minimum.
#include "common.cuh"

namespace {

constexpr int BQ = 8;                  // queries per tile (one warp each)
constexpr int QPG = 4;                 // queries per thread in the dot loop
constexpr int kThreads = 32 * BQ;
constexpr int kBufFloats = 64 * 132;   // one row buffer: LC * (D + 4) <= this
constexpr int kHeads = 4;              // chunks per lane in the merge
constexpr int kMaxChunks = 32 * kHeads;
constexpr int kMergeThreads = 128;
constexpr int kMaxPartials = 12 * 1024;  // chunks x k2 staged by the merge
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int row_stride(int D) { return D + 4; }

__host__ __device__ inline int chunk_rows(int L, int D) {
  const int lc = kBufFloats / row_stride(D);
  return lc < 1 ? 1 : (lc < L ? lc : L);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async4(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Does any query of tile t probe slot s?  (8 ints, two 16-byte loads.)
__device__ __forceinline__ bool slot_live(const int* __restrict__ qsel,
                                          int t, int S, int s) {
  const int4* p =
      reinterpret_cast<const int4*>(qsel + ((size_t)t * S + s) * BQ);
  const int4 a = p[0], b = p[1];
  return (a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) != 0;
}

__device__ __forceinline__ int next_live(const int* __restrict__ qsel, int t,
                                         int S, int s, int s_hi) {
  while (s < s_hi && !slot_live(qsel, t, S, s)) ++s;
  return s;
}

// SMALL (k2 <= 32): each query's buffer lives in its warp's registers,
// lane j holding the j-th smallest entry, so an insertion is two ballots
// and a shift (shfl_up) instead of a search of the buffer and a rescan for
// its worst entry.  Otherwise the buffer lives in shared memory.
template <bool SMALL>
__global__ void __launch_bounds__(kThreads)
f32_topk_kernel(const float* __restrict__ post, const int* __restrict__ ids,
                const int* __restrict__ tile_cids,
                const int* __restrict__ qsel,
                const float* __restrict__ queries, float* __restrict__ out_d,
                int* __restrict__ out_i, float* __restrict__ part_d,
                int* __restrict__ part_i, int* __restrict__ part_nan, int S,
                int L, int D, int k2, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LC = chunk_rows(L, D);
  const int stride = row_stride(D);
  float* rows = reinterpret_cast<float*>(smem);            // 2 x kBufFloats
  float* q = rows + 2 * kBufFloats;                        // BQ x D
  float* cd = q + BQ * D;                                  // BQ x LC
  int* ci = reinterpret_cast<int*>(cd + BQ * LC);          // LC
  float* bd = reinterpret_cast<float*>(ci + LC);           // BQ x k2
  int* bi = reinterpret_cast<int*>(bd + BQ * k2);          // BQ x k2
  __shared__ float q2[BQ];
  __shared__ int sel[BQ];
  __shared__ int nanq[BQ];

  const int t = blockIdx.x;
  const int ch = blockIdx.y;
  const int s_lo = (int)((long long)ch * S / n_chunks);
  const int s_hi = (int)((long long)(ch + 1) * S / n_chunks);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;             // the query this warp merges
  const int d4 = D / 4;

  auto issue = [&](int s, int l0, float* buf) {
    const int r = tile_cids[(size_t)t * S + s];
    const int lc = min(LC, L - l0);
    const float* src = post + ((size_t)r * L + l0) * D;
    for (int w = tid; w < lc * d4; w += kThreads) {
      const int l = w / d4;
      const int c = w - l * d4;
      cp_async16(buf + l * stride + 4 * c, src + (size_t)l * D + 4 * c);
    }
    cp_async_commit();
  };

  int s = next_live(qsel, t, S, s_lo, s_hi);
  if (s < s_hi) issue(s, 0, rows);

  const float* qt = queries + (size_t)t * BQ * D;
  for (int e = tid; e < BQ * D; e += kThreads) q[e] = qt[e];
  for (int e = tid; e < BQ * k2; e += kThreads) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  if (tid < BQ) nanq[tid] = 0;
  __syncthreads();
  {
    float a = 0.0f;
    for (int d = lane; d < D; d += 32)
      a = fmaf(q[warp * D + d], q[warp * D + d], a);
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    if (lane == 0) q2[warp] = a;
  }
  float worst = CUDART_INF_F;          // of query `warp`'s buffer
  int worst_pos = k2 - 1;
  float rd = CUDART_INF_F;             // SMALL: this lane's buffer entry
  int ri = -1;
  bool wiped = false;
  float* my_bd = bd + warp * k2;
  int* my_bi = bi + warp * k2;

  int l0 = 0, cur = 0;
  while (s < s_hi) {
    int ns = s, nl0 = l0 + LC;
    const bool slot_end = nl0 >= L;
    if (slot_end) {
      ns = next_live(qsel, t, S, s + 1, s_hi);
      nl0 = 0;
    }
    if (ns < s_hi) {
      issue(ns, nl0, rows + (cur ^ 1) * kBufFloats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid < BQ) sel[tid] = qsel[((size_t)t * S + s) * BQ + tid];
    __syncthreads();                     // rows of (s, l0) and sel visible

    const float* buf = rows + cur * kBufFloats;
    const int r = tile_cids[(size_t)t * S + s];
    const int lc = min(LC, L - l0);
    for (int w = tid; w < lc * (BQ / QPG); w += kThreads) {
      const int l = w % lc;
      const int g = w / lc;
      const float4* row = reinterpret_cast<const float4*>(buf + l * stride);
      const float4* qq = reinterpret_cast<const float4*>(q + g * QPG * D);
      float dot[QPG];
#pragma unroll
      for (int j = 0; j < QPG; ++j) dot[j] = 0.0f;
      float pn = 0.0f;
      for (int c = 0; c < d4; ++c) {
        const float4 p = row[c];
        pn = fmaf(p.x, p.x, pn);
        pn = fmaf(p.y, p.y, pn);
        pn = fmaf(p.z, p.z, pn);
        pn = fmaf(p.w, p.w, pn);
#pragma unroll
        for (int j = 0; j < QPG; ++j) {
          const float4 v = qq[j * d4 + c];
          dot[j] = fmaf(v.x, p.x, dot[j]);
          dot[j] = fmaf(v.y, p.y, dot[j]);
          dot[j] = fmaf(v.z, p.z, dot[j]);
          dot[j] = fmaf(v.w, p.w, dot[j]);
        }
      }
      const int id = ids[(size_t)r * L + l0 + l];
      if (g == 0) ci[l] = id;
#pragma unroll
      for (int j = 0; j < QPG; ++j) {
        const int qj = g * QPG + j;
        const float d = q2[qj] - 2.0f * dot[j] + pn;
        const float dist = d < 0.0f ? 0.0f : d;
        const bool take = id >= 0 && sel[qj] != 0;
        if (take && isnan(dist)) nanq[qj] = 1;
        cd[qj * LC + l] = take ? dist : CUDART_INF_F;
      }
    }
    __syncthreads();

    if (sel[warp] != 0) {
      // Sequential merge semantics, one candidate at a time: an id already
      // in the buffer keeps its smaller distance, a new id replaces the
      // current worst when strictly better.  Candidates not below the worst
      // at ballot time can never enter (the worst only decreases); a NaN is
      // never below it.
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
          if constexpr (SMALL) {
            reg_insert(dd, id, k2, lane, rd, ri, worst);
          } else {
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
      if (slot_end && nanq[warp]) {
        // the reference's wipe: nothing of this slot or before survives
        for (int j = lane; j < k2; j += 32) {
          my_bd[j] = CUDART_INF_F;
          my_bi[j] = -1;
        }
        rd = CUDART_INF_F;
        ri = -1;
        worst = CUDART_INF_F;
        worst_pos = k2 - 1;
        wiped = true;
        __syncwarp();
        if (lane == 0) nanq[warp] = 0;
      }
    }
    __syncthreads();                     // rows / cd / ci / sel are reused
    s = ns;
    l0 = nl0;
    cur ^= 1;
  }

  // ascending output: SMALL's buffer is sorted; otherwise the rank of
  // (distance, slot) among the k2 buffer entries
  const size_t gq = (size_t)t * BQ + warp;
  const size_t pofs = (gq * n_chunks + ch) * k2;
  float* od = n_chunks == 1 ? out_d + gq * k2 : part_d + pofs;
  int* oi = n_chunks == 1 ? out_i + gq * k2 : part_i + pofs;
  if constexpr (SMALL) {
    if (lane < k2) {
      const bool ok = rd < CUDART_INF_F;
      od[lane] = ok ? rd : CUDART_INF_F;
      oi[lane] = ok ? ri : -1;
    }
  }
  for (int j = lane; !SMALL && j < k2; j += 32) {
    const float v = my_bd[j];
    int rank = 0;
    for (int m = 0; m < k2; ++m) {
      const float u = my_bd[m];
      rank += (u < v) || (u == v && m < j);
    }
    const bool ok = v < CUDART_INF_F;
    od[rank] = ok ? v : CUDART_INF_F;
    oi[rank] = ok ? my_bi[j] : -1;
  }
  if (n_chunks > 1 && lane == 0) part_nan[gq * n_chunks + ch] = wiped ? 1 : 0;
}

// Lexicographic (distance, chunk) order of the merge's heads.
__device__ __forceinline__ bool head_before(float d1, int c1, float d2,
                                            int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

// One block per query: stage its partials from the chunks it keeps (the
// last one that wiped and those after it) in shared memory, then one warp
// merges them into the top-k2, unique by id.  Lane l owns chunks c0 + l,
// c0 + l + 32, ...; each round the warp takes the least head in (distance,
// chunk) order, emits it unless its id was emitted already (the first,
// smallest, entry of an id wins), and its owner advances.
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

  if (tid < 32) {
    int c0 = 0;
    for (int c = lane; c < n_chunks; c += 32)
      if (part_nan[gq * n_chunks + c]) c0 = c;
    for (int off = 16; off > 0; off >>= 1)
      c0 = max(c0, __shfl_xor_sync(kFull, c0, off));
    if (lane == 0) first = c0;
  }
  __syncthreads();
  const int c0 = first;
  const size_t base = (gq * n_chunks + c0) * k2;
  for (int e = tid; e < (n_chunks - c0) * k2; e += kMergeThreads) {
    const int c = e / k2, p = e - (e / k2) * k2;  // all in flight at once
    cp_async4(sd + c * ld + p, part_d + base + e);
    cp_async4(si + c * ld + p, part_i + base + e);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid >= 32) return;

  int pos[kHeads];
#pragma unroll
  for (int m = 0; m < kHeads; ++m) pos[m] = 0;
  auto head = [&](int m, float& d, int& id) {
    const int c = lane + 32 * m;         // relative to c0
    const bool ok = c0 + c < n_chunks && pos[m] < k2;
    d = ok ? sd[c * ld + pos[m]] : CUDART_INF_F;
    id = ok ? si[c * ld + pos[m]] : -1;
  };
  int n_out = 0;
  while (n_out < k2) {
    float bd = CUDART_INF_F;
    int bc = 0x7fffffff, bid = -1;
#pragma unroll
    for (int m = 0; m < kHeads; ++m) {
      float d;
      int id;
      head(m, d, id);
      const int c = lane + 32 * m;
      if (d < CUDART_INF_F && head_before(d, c, bd, bc)) {
        bd = d;
        bc = c;
        bid = id;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, off);
      const int oc = __shfl_xor_sync(kFull, bc, off);
      const int oid = __shfl_xor_sync(kFull, bid, off);
      if (head_before(od, oc, bd, bc)) {
        bd = od;
        bc = oc;
        bid = oid;
      }
    }
    if (!(bd < CUDART_INF_F)) break;     // every partial is exhausted
    bool dup = false;
    for (int j = lane; j < n_out; j += 32) dup |= ob_i[j] == bid;
    if (!__any_sync(kFull, dup)) {
      if (lane == 0) {
        ob_d[n_out] = bd;
        ob_i[n_out] = bid;
      }
      ++n_out;
    }
    if ((bc & 31) == lane) {             // the owner of chunk bc advances
#pragma unroll
      for (int m = 0; m < kHeads; ++m) pos[m] += m == (bc >> 5);
    }
    __syncwarp();
  }
  for (int j = lane; j < k2; j += 32) {
    out_d[gq * k2 + j] = j < n_out ? ob_d[j] : CUDART_INF_F;
    out_i[gq * k2 + j] = j < n_out ? ob_i[j] : -1;
  }
}

}  // namespace

extern "C" size_t ivf_scan_topk_smem_bytes(int L, int D, int k2) {
  const size_t lc = (size_t)chunk_rows(L, D);
  return (size_t)2 * kBufFloats * 4 + (size_t)BQ * D * 4 +
         (size_t)BQ * lc * 4 + lc * 4 + (size_t)2 * BQ * k2 * 4;
}

// The most blocks a tile may take: at least one slot a block, at most the
// merge's kMaxChunks lanes' worth, and at most the kMaxPartials entries its
// shared memory stages (one block a tile stages none).
extern "C" int ivf_scan_topk_max_chunks(int S, int k2) {
  const int top = min(kMaxChunks, max(S, 1));
  return k2 > 0 ? min(top, max(1, kMaxPartials / k2)) : top;
}

extern "C" int ivf_scan_topk_launch(const void* post, const void* ids,
                                    const void* tile_cids, const void* qsel,
                                    const void* queries, void* out_d,
                                    void* out_i, void* part_d, void* part_i,
                                    void* part_nan, int n_tiles, int S, int L,
                                    int D, int k2, int n_chunks,
                                    void* stream) {
  if (n_chunks < 1 || n_chunks > ivf_scan_topk_max_chunks(S, k2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ivf_scan_topk_smem_bytes(L, D, k2);
  auto kernel = k2 <= 32 ? f32_topk_kernel<true> : f32_topk_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  REPRO_RETURN_IF_ERROR();
  kernel<<<dim3(n_tiles, n_chunks), kThreads, smem, st>>>(
      (const float*)post, (const int*)ids, (const int*)tile_cids,
      (const int*)qsel, (const float*)queries, (float*)out_d, (int*)out_i,
      (float*)part_d, (int*)part_i, (int*)part_nan, S, L, D, k2, n_chunks);
  REPRO_RETURN_IF_ERROR();
  if (n_chunks > 1) {
    const size_t msmem = ((size_t)2 * n_chunks * (k2 | 1) + 2 * k2) * 4;
    cudaFuncSetAttribute(f32_topk_merge_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)msmem);
    REPRO_RETURN_IF_ERROR();
    f32_topk_merge_kernel<<<n_tiles * BQ, kMergeThreads, msmem, st>>>(
        (const float*)part_d, (const int*)part_i, (const int*)part_nan,
        (float*)out_d, (int*)out_i, k2, n_chunks);
  }
  return (int)cudaGetLastError();
}
