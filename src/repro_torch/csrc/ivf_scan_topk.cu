// B2: fused f32 posting scan with in-kernel dedup top-k2, in two designs.
//
// Replaces the Pallas kernel `ivf_scan_topk` (body `_qtile_topk_kernel`) of
// src/repro/kernels/ivf_scan.py.  For every live (query j, probed row r)
// pair it computes
//
//   d = ||q||^2 - 2 q . p + ||p||^2,  clamped at 0 (a NaN stays NaN),
//
// masks rows whose id is < 0 (their payload may be uninitialised, even NaN:
// the mask is a select, so nothing of such a row reaches a comparison), and
// keeps each query's top-k2, unique by id with the per-id minimum.  Output
// is ascending, padded (+inf, -1).  A query's slots are its distinct live
// clusters in ascending id order (plan_tile_probes' order; a pair probed
// twice is scanned once).  A NaN distance of a live row follows the
// reference: its _extract_topk gets a NaN from jnp.min, emits (+inf, -1) k2
// times and kills nothing, so the query's candidates are empty after that
// slot and only later slots refill them.
//
// Both designs compute each dot as one fmaf chain over D in order, each row
// norm likewise and each query norm as 32 lane-strided chains and a
// butterfly, so they give the same bits.  FP32 on the CUDA cores, never the
// tensor cores: the index promises exact f32 L2, TF32 (10-bit mantissa)
// moved the benchmark's dist_gap to 4.29e-3 against its 2e-4 limit, and
// 3xTF32 or bf16 splits would not give these bits either.
//
// BY TILE (f32_topk_kernel): queries in tiles of BQ = 8, each tile's S =
// 8 P slots from plan_tile_probes (sorted by cluster, each cluster live in
// its first slot, qsel naming the tile's queries that probe it).  Made for
// serving shapes (B = 32, P = 16, L = D = 128, k2 = 24): the union is ~460
// clusters x 64 KB = 30 MB, 9 us at 3.35 TB/s, against 2 B P L D ~ 17
// MFLOP, so bytes bound it and most SMs must be loading.  A tile's slots
// are split into n_chunks runs, one block per (tile, chunk), hundreds of
// blocks at B = 32; a block streams its live slots' rows through two
// shared-memory buffers of LC rows by cp.async, each thread scoring a row
// against 4 of the tile's queries (row stride D + 4: a quarter-warp's rows
// in distinct banks); one warp per query merges, a ballot rejecting what is
// not below its worst (the buffer sorted in the warp's registers at k2 <=
// 32).  Each block writes its queries' partial top-k2 and whether it wiped
// them for a NaN; f32_topk_merge_kernel (topk_partials.cuh, shared with K1)
// drops the chunks before the last wiped one and merges the rest in
// (distance, chunk, rank) order.  At wide D it starves: LC = 8448 / (D + 4)
// is 8 rows at D 960, so 16 of 256 threads do the dots, and a cluster is
// read once per tile, not once per batch.
//
// BY CLUSTER (f32_topk_kernel_by_cluster + f32_topk_merge_kernel_by_
// cluster): the batch's plan inverted on the device (ivf_scan.py
// plan_cluster_probes, torch ops on the scan stream): the live (query,
// cluster) pairs sorted by (cluster, query), each with its slot, each
// cluster's run of queries cut into work items of at most kG = 32 queries.
// Made for the GIST bulk shape (B 4,096, P 256 at 143 probes a query, L
// 128, D 960, k2 24, ~29k clusters): 577k live pairs x 128 rows x 2 D is
// ~142 GFLOP (2.1 ms at 67 TFLOP/s), and the union, ~29k clusters x 492 KB
// = 14 GB, read once is 4.3 ms at 3.35 TB/s, so bytes bound it, with the
// FP32 pipes close behind.  One block per work item: it streams the
// cluster's rows once for all its queries, in tiles of kRT = 128 rows and
// slices of kDS = 32 dimensions, rows and the item's query slices together,
// through a 3-stage cp.async ring (rows at an odd float4 pitch: a
// quarter-warp's rows in distinct banks; query reads are warp-wide
// broadcasts).  Warp w owns queries 4w..4w+3 of the item and lane l rows
// l + 32 i: a 4 x 4 register tile of fmaf chains, 64 FMAs for 8 16-byte
// shared loads, and warps past the item's queries skip the dots, leaving
// the SM to the other resident block.  The row norms come from the same
// slices.  Each warp then offers its queries' rows, straight from its
// registers, to a top-k2 buffer per query (the by-tile merge's ballot and
// buffer), and writes one partial per (query, slot) with a NaN flag.  The
// merge (one warp per query, up to P = 256 partials read from L2) drops
// the partials at or before the last flagged slot and merges the rest in
// (distance, slot, rank) order, keeping each id's first entry.  Exact: an
// id of the global top-k2 is in the top-k2 of the slot that holds its
// minimum; and the order depends only on the data.  Every pair costs its
// own dots, no more: the by-tile design computed all 8 queries of a tile
// against every row it read.
//
// The wrapper (ivf_scan.py b2_design) picks the design from the shapes.
#include "topk_partials.cuh"

namespace {

// ---- one query's running top-k2 in a warp, shared by both designs --------

// The sequential merge, one candidate at a time, of the warp's 32 offers
// (lane order): an id already in the buffer keeps its smaller distance, a
// new id replaces the current worst when strictly better.  Candidates not
// below the worst at ballot time can never enter (the worst only
// decreases); a NaN is never below it.  SMALL (k2 <= 32): the buffer is
// sorted in the warp's registers (rd, ri at lane j: the j-th smallest);
// otherwise it lives in shared memory (my_bd, my_bi).
template <bool SMALL>
__device__ __forceinline__ void offer(float mine_d, int mine_i, int k2,
                                      int lane, float& rd, int& ri,
                                      float& worst, int& worst_pos,
                                      float* my_bd, int* my_bi) {
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

// The buffer, ascending, to od/oi: SMALL's is sorted; otherwise each entry
// goes to its rank by (distance, buffer slot).
template <bool SMALL>
__device__ __forceinline__ void write_topk(float* od, int* oi, int k2,
                                           int lane, float rd, int ri,
                                           const float* my_bd,
                                           const int* my_bi) {
  if constexpr (SMALL) {
    if (lane < k2) {
      const bool ok = rd < CUDART_INF_F;
      od[lane] = ok ? rd : CUDART_INF_F;
      oi[lane] = ok ? ri : -1;
    }
  } else {
    for (int j = lane; j < k2; j += 32) {
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
  }
}

// ---- by tile ---------------------------------------------------------------

constexpr int BQ = 8;                  // queries per tile (one warp each)
constexpr int QPG = 4;                 // queries per thread in the dot loop
constexpr int kThreads = 32 * BQ;
constexpr int kBufFloats = 64 * 132;   // one row buffer: LC * (D + 4) <= this

__host__ __device__ inline int row_stride(int D) { return D + 4; }

__host__ __device__ inline int chunk_rows(int L, int D) {
  const int lc = kBufFloats / row_stride(D);
  return lc < 1 ? 1 : (lc < L ? lc : L);
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
      const float* my_cd = cd + warp * LC;
      for (int base = 0; base < lc; base += 32) {
        const int l = base + lane;
        offer<SMALL>(l < lc ? my_cd[l] : CUDART_INF_F, l < lc ? ci[l] : -1,
                     k2, lane, rd, ri, worst, worst_pos, my_bd, my_bi);
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

  const size_t gq = (size_t)t * BQ + warp;
  const size_t pofs = (gq * n_chunks + ch) * k2;
  write_topk<SMALL>(n_chunks == 1 ? out_d + gq * k2 : part_d + pofs,
                    n_chunks == 1 ? out_i + gq * k2 : part_i + pofs, k2,
                    lane, rd, ri, my_bd, my_bi);
  if (n_chunks > 1 && lane == 0) part_nan[gq * n_chunks + ch] = wiped ? 1 : 0;
}

// ---- by cluster ------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kG = 32;                 // queries a work item
constexpr int kQW = kG / kCWarps;      // queries a warp (4)
constexpr int kRT = 128;               // rows a tile: lane l holds l + 32 i
constexpr int kRI = kRT / 32;          // rows a lane (4)
constexpr int kDS = 32;                // dimensions a ring stage
constexpr int kDS4 = kDS / 4;
constexpr int kRP4 = kDS4 + 1;         // row pitch in float4: odd
constexpr int kStages = 3;
constexpr int kStageFloats = kRT * kRP4 * 4 + kG * kDS;
constexpr int kMaxSlots = 256;         // slots (P) a query may have
constexpr int kMHeads = kMaxSlots / 32;  // partials a lane in the merge
constexpr int kMWarps = 4;             // queries a merge block
constexpr int kMaxK2 = 256;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One block per work item: items[blockIdx.x] is the first of its pairs in
// the (cluster, query)-sorted list, the item the next <= kG pairs of that
// cluster.  Blocks past *n_items exit (the grid is the host's bound).  Each
// (query, slot) gets its partial top-k2 (ascending, unique by id, padded)
// at part_[(q * P + slot) * k2] and part_nan[q * P + slot] = 1 if a live
// row of that slot gave a NaN.
template <bool SMALL>
__global__ void __launch_bounds__(kCThreads, 2)
f32_topk_kernel_by_cluster(
    const float* __restrict__ post, const int* __restrict__ ids,
    const float* __restrict__ queries, const int* __restrict__ pair_c,
    const int* __restrict__ pair_q, const int* __restrict__ pair_slot,
    const int* __restrict__ items, const int* __restrict__ n_items,
    float* __restrict__ part_d, int* __restrict__ part_i,
    int* __restrict__ part_nan, int n_pairs, int L, int D, int P, int k2) {
  if ((int)blockIdx.x >= *n_items) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);       // kStages stages
  float* bd = ring + kStages * kStageFloats;          // !SMALL: kG x k2
  int* bi = reinterpret_cast<int*>(bd + kG * k2);     // !SMALL: kG x k2
  __shared__ int s_q[kG], s_slot[kG], s_ids[kRT];
  __shared__ float s_q2[kG], s_rn[kRT];
  __shared__ int s_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = items[blockIdx.x];
  const int c = pair_c[start];
  if (warp == 0) {                       // the item's pairs: one run
    const int e = start + lane;
    const bool in = e < n_pairs && pair_c[e] == c;
    const unsigned m = __ballot_sync(kFull, in);
    if (in) {
      s_q[lane] = pair_q[e];
      s_slot[lane] = pair_slot[e];
    }
    if (lane == 0) s_n = __popc(m);
  }
  __syncthreads();
  const int n = s_n;
  const int nsl = (D + kDS - 1) / kDS;
  const int steps = (L + kRT - 1) / kRT * nsl;        // (row tile, slice)
  const float* blk = post + (size_t)c * L * D;
  const int jq = warp * kQW;             // this warp's first query
  const bool active = jq < n;            // warp-uniform

  // stage it: the row tile's rows and the item's queries at its slice;
  // rows past L and queries past n keep stale values, which only reach
  // distances that are masked (id -1) or never offered
  const auto issue = [&](int it) {
    if (it < steps) {
      const int l0 = it / nsl * kRT, d0 = (it % nsl) * kDS;
      const int nr = min(kRT, L - l0), w4 = min(kDS, D - d0) / 4;
      float* st = ring + (it % kStages) * kStageFloats;
      for (int e = tid; e < nr * kDS4; e += kCThreads) {
        const int r = e / kDS4, x = e % kDS4;
        if (x < w4)
          cp_async16(st + 4 * (r * kRP4 + x),
                     blk + (size_t)(l0 + r) * D + d0 + 4 * x);
      }
      float* sq = st + kRT * kRP4 * 4;
      for (int e = tid; e < n * kDS4; e += kCThreads) {
        const int j = e / kDS4, x = e % kDS4;
        if (x < w4)
          cp_async16(sq + j * kDS + 4 * x,
                     queries + (size_t)s_q[j] * D + d0 + 4 * x);
      }
    }
    cp_async_commit();                   // empty groups keep the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // query norms in the by-tile kernel's order: 32 lane-strided fmaf chains
  // and a butterfly
  for (int j = warp; j < n; j += kCWarps) {
    const float* qv = queries + (size_t)s_q[j] * D;
    float a = 0.0f;
    for (int d = lane; d < D; d += 32) a = fmaf(qv[d], qv[d], a);
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    if (lane == 0) s_q2[j] = a;
  }

  float rd[kQW], worst[kQW];             // each query's buffer (SMALL: this
  int ri[kQW], wpos[kQW];                // lane's entry) and worst
  bool nanq[kQW];
#pragma unroll
  for (int jj = 0; jj < kQW; ++jj) {
    rd[jj] = CUDART_INF_F;
    ri[jj] = -1;
    worst[jj] = CUDART_INF_F;
    wpos[jj] = k2 - 1;
    nanq[jj] = false;
  }
  if (!SMALL && active) {
    for (int e = lane; e < kQW * k2; e += 32) {
      bd[jq * k2 + e] = CUDART_INF_F;
      bi[jq * k2 + e] = -1;
    }
  }

  float acc[kRI][kQW];
  float pn = 0.0f;                       // thread tid < kRT: row tid's norm
  for (int it = 0; it < steps; ++it) {
    const int s = it % nsl;
    const int l0 = it / nsl * kRT;
    const int w4 = min(kDS, D - s * kDS) / 4;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int jj = 0; jj < kQW; ++jj) acc[i][jj] = 0.0f;
      pn = 0.0f;
      if (tid < kRT) s_ids[tid] = l0 + tid < L ? ids[(size_t)c * L + l0 + tid]
                                               : -1;
    }
    cp_async_wait<kStages - 2>();        // stage it has landed
    __syncthreads();                     // ... for every thread; stage
    issue(it + kStages - 1);             // it - 1 is free again
    const float4* r4 =
        reinterpret_cast<const float4*>(ring + (it % kStages) * kStageFloats);
    const float4* q4 = r4 + kRT * kRP4;
    if (tid < kRT) {
      for (int x = 0; x < w4; ++x) {
        const float4 p = r4[tid * kRP4 + x];
        pn = fmaf(p.x, p.x, pn);
        pn = fmaf(p.y, p.y, pn);
        pn = fmaf(p.z, p.z, pn);
        pn = fmaf(p.w, p.w, pn);
      }
    }
    if (active) {
#pragma unroll 2
      for (int x = 0; x < w4; ++x) {
        float4 p[kRI], q[kQW];
#pragma unroll
        for (int i = 0; i < kRI; ++i) p[i] = r4[(lane + 32 * i) * kRP4 + x];
#pragma unroll
        for (int jj = 0; jj < kQW; ++jj) q[jj] = q4[(jq + jj) * kDS4 + x];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int jj = 0; jj < kQW; ++jj)
            acc[i][jj] = dot4(q[jj], p[i], acc[i][jj]);
      }
    }
    if (s < nsl - 1) continue;

    // the row tile's distances, offered row by row to each query's buffer
    if (tid < kRT) s_rn[tid] = pn;
    __syncthreads();
    if (active) {
#pragma unroll
      for (int jj = 0; jj < kQW; ++jj) {
        const int j = jq + jj;
        if (j < n) {
          const float qn = s_q2[j];
#pragma unroll
          for (int i = 0; i < kRI; ++i) {
            const int row = lane + 32 * i;
            const int id = s_ids[row];
            const float d = qn - 2.0f * acc[i][jj] + s_rn[row];
            const float dist = d < 0.0f ? 0.0f : d;
            const bool take = id >= 0;
            nanq[jj] |= take && isnan(dist);
            offer<SMALL>(take ? dist : CUDART_INF_F, id, k2, lane, rd[jj],
                         ri[jj], worst[jj], wpos[jj], bd + j * k2,
                         bi + j * k2);
          }
        }
      }
    }
    __syncthreads();                     // s_ids and s_rn are rewritten
  }

  if (active) {
#pragma unroll
    for (int jj = 0; jj < kQW; ++jj) {
      const int j = jq + jj;
      if (j < n) {
        const bool wiped = __any_sync(kFull, nanq[jj]);
        const size_t pp = (size_t)s_q[j] * P + s_slot[j];
        write_topk<SMALL>(part_d + pp * k2, part_i + pp * k2, k2, lane,
                          rd[jj], ri[jj], bd + j * k2, bi + j * k2);
        if (lane == 0) part_nan[pp] = wiped ? 1 : 0;
      }
    }
  }
  cp_async_wait<0>();
}

// One warp per query: its n_slots[q] partials, from the one after the last
// wiped slot on, merged in (distance, slot, rank) order into the top-k2,
// each id's first (smallest) entry kept.  Lane l owns slots l, l + 32, ...
// and keeps their heads in registers; the heads are read from device memory
// (the partials were just written: L2, then L1 for a partial's next
// entries).  Each round the warp takes the least head, emits it unless its
// id was emitted already, and its owner advances.
__global__ void __launch_bounds__(32 * kMWarps)
f32_topk_merge_kernel_by_cluster(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i,
                                 const int* __restrict__ part_nan,
                                 const int* __restrict__ n_slots,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i, int B, int P,
                                 int k2) {
  __shared__ int s_out[kMWarps][kMaxK2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMWarps + warp;
  if (q >= B) return;                    // warp-uniform; no block barrier
  int* ob_i = s_out[warp];
  const int n = n_slots[q];
  const size_t base = (size_t)q * P;
  int c0 = 0;                            // the first slot merged
#pragma unroll
  for (int m = 0; m < kMHeads; ++m) {
    const int c = lane + 32 * m;
    if (c < n && part_nan[base + c]) c0 = c + 1;
  }
  for (int off = 16; off > 0; off >>= 1)
    c0 = max(c0, __shfl_xor_sync(kFull, c0, off));

  int pos[kMHeads];
  float hd[kMHeads];
  int hid[kMHeads];
#pragma unroll
  for (int m = 0; m < kMHeads; ++m) {
    const int c = lane + 32 * m;
    const bool ok = c0 <= c && c < n;
    pos[m] = 0;
    hd[m] = ok ? part_d[(base + c) * k2] : CUDART_INF_F;
    hid[m] = ok ? part_i[(base + c) * k2] : -1;
  }
  float* od = out_d + (size_t)q * k2;
  int* oi = out_i + (size_t)q * k2;
  int n_out = 0;
  while (n_out < k2) {
    float bd = CUDART_INF_F;             // this lane's least head
    int bc = 0x7fffffff, bid = -1;
#pragma unroll
    for (int m = 0; m < kMHeads; ++m) {
      const int c = lane + 32 * m;
      if (hd[m] < CUDART_INF_F && head_before(hd[m], c, bd, bc)) {
        bd = hd[m];
        bc = c;
        bid = hid[m];
      }
    }
    // the warp's least head, as in f32_topk_merge_kernel: the least
    // distance (-0 counts as 0), then the least slot; its owner holds it
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
        od[n_out] = wd;
        oi[n_out] = wid;
        ob_i[n_out] = wid;
      }
      ++n_out;
    }
#pragma unroll
    for (int m = 0; m < kMHeads; ++m) {  // the owner of slot wc advances
      const int c = lane + 32 * m;
      if (c == wc) {
        const int p = ++pos[m];
        hd[m] = p < k2 ? part_d[(base + c) * k2 + p] : CUDART_INF_F;
        hid[m] = p < k2 ? part_i[(base + c) * k2 + p] : -1;
      }
    }
    __syncwarp();
  }
  for (int j = n_out + lane; j < k2; j += 32) {
    od[j] = CUDART_INF_F;
    oi[j] = -1;
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
  if (n_chunks > 1)
    return launch_topk_merge((const float*)part_d, (const int*)part_i,
                             (const int*)part_nan, (float*)out_d,
                             (int*)out_i, n_tiles * BQ, k2, n_chunks, st);
  return (int)cudaGetLastError();
}

extern "C" size_t ivf_scan_topk_by_cluster_smem_bytes(int k2) {
  return (size_t)kStages * kStageFloats * 4 +
         (k2 <= 32 ? 0 : (size_t)2 * kG * k2 * 4);
}

// The by-cluster design on a plan from plan_cluster_probes: n_grid blocks
// (at least the plan's work items), n_pairs = B * P entries of pair_c,
// pair_q and pair_slot, partials (B, P, k2) and part_nan (B, P) as scratch,
// the top-k2 (B, k2) to out_d / out_i.  P <= 256, 1 <= k2 <= 256, queries
// and postings 16-byte aligned with D % 4 == 0.
extern "C" int ivf_scan_topk_by_cluster_launch(
    const void* post, const void* ids, const void* queries,
    const void* pair_c, const void* pair_q, const void* pair_slot,
    const void* items, const void* n_items, const void* n_slots,
    void* part_d, void* part_i, void* part_nan, void* out_d, void* out_i,
    int n_grid, int n_pairs, int B, int L, int D, int P, int k2,
    void* stream) {
  if (n_grid < 1 || B < 1 || P < 1 || P > kMaxSlots || k2 < 1 ||
      k2 > kMaxK2 || D % 4 != 0 || (uintptr_t)post % 16 != 0 ||
      (uintptr_t)queries % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ivf_scan_topk_by_cluster_smem_bytes(k2);
  auto kernel = k2 <= 32 ? f32_topk_kernel_by_cluster<true>
                         : f32_topk_kernel_by_cluster<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  REPRO_RETURN_IF_ERROR();
  kernel<<<n_grid, kCThreads, smem, st>>>(
      (const float*)post, (const int*)ids, (const float*)queries,
      (const int*)pair_c, (const int*)pair_q, (const int*)pair_slot,
      (const int*)items, (const int*)n_items, (float*)part_d, (int*)part_i,
      (int*)part_nan, n_pairs, L, D, P, k2);
  REPRO_RETURN_IF_ERROR();
  f32_topk_merge_kernel_by_cluster<<<(B + kMWarps - 1) / kMWarps,
                                     32 * kMWarps, 0, st>>>(
      (const float*)part_d, (const int*)part_i, (const int*)part_nan,
      (const int*)n_slots, (float*)out_d, (int*)out_i, B, P, k2);
  return (int)cudaGetLastError();
}
