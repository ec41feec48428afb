// B6b: cluster-major legacy f32 posting scan.
//
// Replaces the Pallas kernel `ivf_scan_clustermajor` (body `_cmajor_kernel`)
// of src/repro/kernels/ivf_scan.py.  For every active cluster a (the union of
// a batch's probed clusters) it writes the distances of all L rows of cluster
// c = clamp(active[a], 0, C - 1) to every query of the batch:
//
//   out[a, l, b] = clamp0(||p_l||^2 - 2 p_l . q_b + ||q_b||^2)
//
// where qsel[a, b] is true, and +inf where it is false (even when the row
// holds a NaN, as the reference's jnp.where(sel, d, inf) gives).  clamp0(d)
// is `d < 0 ? 0 : d`, which keeps a NaN as jnp.maximum(d, 0.0) does.
//
// What bounds it on an H100: A * L * D * 4 bytes of rows read (a cluster
// that no query selects need not be read) and A * L * B * 4 written; the
// operations are 2 * D for each selected (row, query) pair.  At the resident
// serving union (A ~ 458, L 128, D 128, B 32) that is 30 MB read and 7.5 MB
// written, 0.011 ms at 3.35 TB/s; at most 512 of the ~14,656 (cluster,
// query) pairs are selected, so the selected work is 0.03 GFLOP, and even
// with every pair selected (0.48 GFLOP, 0.0072 ms at 67 TFLOP/s) bytes bound
// it.
//
// What the design does about it:
// - one block of 128 threads per (cluster, chunk of 32 queries): 458 blocks
//   at the serving union, four an SM, so the whole union is one wave, as
//   B6a's 512 blocks are.  Each block streams its cluster's rows through a
//   2-stage ring of 32-row chunks by 16-byte cp.async (4-byte copies into
//   zero-padded rows when D % 4 != 0 or a base is not 16-byte aligned), so
//   the next chunk loads while this one is scored and stored;
// - the block lists its selected queries (a ballot and a prefix count over
//   its qsel columns), stages them once (once a slice of 128 dimensions
//   when D > 128) and computes distances for those alone; a cluster with
//   none writes its +inf slab without reading its rows;
// - a thread owns a 4-row by 4-query tile of dot products from shared
//   memory (16-byte reads); the S selected queries are spread over QG
//   groups of threads and D over 16 / QG lanes that shuffle their partial
//   sums together, so one selected query keeps all 128 threads busy and 32
//   fill the tile.  The query rows sit at a pitch that sends a
//   quarter-warp's reads to distinct banks;
// - each row's norm is taken once, by the lanes of its row group (in the
//   tile loop itself when S <= 4, the serving case, whose lanes also skip
//   their unused query slots), and each selected query's norm once a
//   block; no TF32 or tensor cores: the f32 tolerance would not hold;
// - a chunk's (32 rows x columns) results, +inf where unselected, are
//   staged in shared memory in the output's own layout; when the block
//   spans all B columns they are one contiguous run of out and leave as
//   16-byte stores (64-bit offsets throughout).
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRC = 32;                      // rows a ring chunk
constexpr int kTR = 4, kTQ = 4;              // a thread's tile
constexpr int kRG = kRC / kTR;               // 8 row groups
constexpr int kLanes = kThreads / kRG;       // 16 threads a row group
constexpr int kMaxQG = kLanes / 2;           // query groups (KG >= 2)
constexpr int kBC = kTQ * kMaxQG;            // 32 query columns a block
constexpr int kDS = 128;                     // dimensions staged a slice
constexpr int kDS4 = kDS / 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;             // launch-side attribute flags

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

// Query row pitch in float4 when D is spread over kg lanes: congruent to kg
// mod 8, so the 8 (qg, k) lanes of a quarter-warp read distinct banks.
__host__ __device__ constexpr int query_pitch4(int kg) {
  return kDS4 + (kg % 8 - kDS4 % 8 + 8) % 8;
}

// Float4 of one query buffer: the most (rows x pitch) over the query
// group counts, 4 * QG rows at KG = kLanes / QG.
__host__ __device__ constexpr int query_float4(int qg = 1) {
  return qg > kMaxQG ? 0
      : (4 * qg * query_pitch4(kLanes / qg) > query_float4(2 * qg)
             ? 4 * qg * query_pitch4(kLanes / qg)
             : query_float4(2 * qg));
}

// the ring, the query buffer (two when D > 128: a slice with each chunk),
// a chunk's results, its row norms, the query norms and selected columns
constexpr size_t smem_bytes(int slices) {
  return ((size_t)2 * kRC * kDS +
          (size_t)(slices > 1 ? 2 : 1) * query_float4() * 4 +
          (size_t)kRC * kBC + kRC + kBC) * 4 + kBC * 4;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Stages n rows of w floats, row i from src(i), into dst (row pitch 4 * p4
// floats), zero-padding each row to a whole float4.
template <typename F>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int p4,
                                           F src, int n, int w, bool vec,
                                           int tid) {
  const int w4 = (w + 3) / 4;
  if (vec) {                                 // w % 4 == 0, aligned
    for (int e = tid; e < n * w4; e += kThreads) {
      const int i = e / w4, x = e - i * w4;
      cp_async16(dst + 4 * (i * p4 + x), src(i) + 4 * x);
    }
  } else {
    for (int e = tid; e < n * w4 * 4; e += kThreads) {
      const int i = e / (w4 * 4), x = e - i * (w4 * 4);
      float* d = dst + 4 * i * p4 + x;
      if (x < w)
        cp_async4(d, src(i) + x);
      else
        *d = 0.0f;
    }
  }
}

// out[i] (+)= ||row i||^2 over the staged slice (row pitch p4 float4) for
// i < n; the kLanes lanes of row group rg share a row.  Every lane of a
// warp takes each round's shuffles.
__device__ __forceinline__ void norms(float* __restrict__ out,
                                      const float* __restrict__ rows, int p4,
                                      int n, int w4, bool add, int rg,
                                      int sub) {
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  for (int i0 = 0; i0 < n; i0 += kRG) {
    const int i = i0 + rg;
    float p = 0.0f;
    if (i < n) {
      for (int x = sub; x < w4; x += kLanes) {
        const float4 v = r4[i * p4 + x];
        p = dot4(v, v, p);
      }
    }
    for (int off = 1; off < kLanes; off <<= 1)
      p += __shfl_xor_sync(kFull, p, off);
    if (sub == 0 && i < n) out[i] = (add ? out[i] : 0.0f) + p;
  }
}

// The (rows x bcw) block of out at o (row pitch B) from value(j), j the
// index in the (rows x bcw) staging layout.
template <typename F>
__device__ __forceinline__ void store_slab(float* __restrict__ o, int rows,
                                           int bcw, int B, F value) {
  if (bcw == B) {                            // one contiguous run
    repro::block_store_run(o, rows * B, value);
  } else {
    for (int i = 0; i < rows; ++i)
      repro::block_store_run(o + (size_t)i * B, bcw,
                             [&](int j) { return value(i * bcw + j); });
  }
}

__global__ void __launch_bounds__(kThreads)
ivf_scan_clustermajor_kernel(const float* __restrict__ post,
                             const int* __restrict__ active,
                             const unsigned char* __restrict__ qsel,
                             const float* __restrict__ queries,
                             float* __restrict__ out, int C, int L, int B,
                             int D, int vec) {
  extern __shared__ __align__(16) float sm[];
  const int nsl = (D + kDS - 1) / kDS;
  float* ring = sm;                              // [2][kRC][kDS]
  float* sqb = ring + 2 * kRC * kDS;             // [1 or 2][query_float4]
  float* sres = sqb + (nsl > 1 ? 2 : 1) * query_float4() * 4;
  float* rn = sres + kRC * kBC;                  // [kRC]
  float* qn = rn + kRC;                          // [kBC]
  int* sel = reinterpret_cast<int*>(qn + kBC);   // [kBC]
  __shared__ int cnt;
  const int a = blockIdx.x;
  const int b0 = blockIdx.y * kBC;
  const int bcw = min(kBC, B - b0);
  const int tid = threadIdx.x;
  const int c = min(max(active[a], 0), C - 1);
  float* o = out + (size_t)a * L * B + b0;

  // the block's selected columns, in order: a ballot over its <= 32
  // columns and a prefix count
  const bool mine = tid < bcw && qsel[(size_t)a * B + b0 + tid] != 0;
  if (tid < 32) {                                // warp 0
    const unsigned m = __ballot_sync(kFull, mine);
    if (mine) sel[__popc(m & ((1u << tid) - 1u))] = tid;
    if (tid == 0) cnt = __popc(m);
  }
  for (int i = tid; i < kRC * bcw; i += kThreads) sres[i] = CUDART_INF_F;
  __syncthreads();
  const int S = cnt;
  if (S == 0) {                                  // its rows are not read
    store_slab(o, L, bcw, B, [](int) { return CUDART_INF_F; });
    return;
  }

  const int QG = S <= 4 ? 1 : S <= 8 ? 2 : S <= 16 ? 4 : 8;
  const int KG = kLanes / QG;
  const int rg = tid / kLanes, sub = tid - rg * kLanes;
  const int qg = sub / KG, k = sub - qg * KG;
  const int sq4 = query_pitch4(KG);
  const int items = (L + kRC - 1) / kRC * nsl;   // (row chunk, slice)
  const float* blk = post + (size_t)c * L * D;
  const auto query_src = [&](int d0) {
    return [=](int j) { return queries + (size_t)(b0 + sel[j]) * D + d0; };
  };
  const auto issue = [&](int it) {
    if (it < items) {
      const int rc = it / nsl, d0 = (it - rc * nsl) * kDS;
      const int l0 = rc * kRC;
      stage_rows(ring + (it & 1) * kRC * kDS, kDS4,
                 [=](int i) { return blk + (size_t)(l0 + i) * D + d0; },
                 min(kRC, L - l0), min(kDS, D - d0), vec, tid);
      if (nsl > 1)
        stage_rows(sqb + (it & 1) * query_float4() * 4, sq4, query_src(d0),
                   S, min(kDS, D - d0), vec, tid);
    }
    cp_async_commit();                           // empty groups keep count
  };
  if (nsl == 1) stage_rows(sqb, sq4, query_src(0), S, D, vec, tid);
  issue(0);                                      // with the queries
  issue(1);

  // S <= 4 (QG 1, kFold): a lane skips the loads and sums of its unused
  // query slots, and the row norms come from the tile's own reads, reduced
  // with its sums, in place of the norms pass.  Otherwise every slot is
  // computed (the extra sums are dropped).  Every lane takes every
  // shuffle: a shuffle under a condition costs the warp a reconvergence.
  const auto scan = [&](auto fold) {
    constexpr bool kFold = decltype(fold)::value;
    const int nj = kFold ? S : kTQ;              // slots in use
    float acc[kTR][kTQ], pn[kTR];
    for (int it = 0; it < items; ++it) {
      const int rc = it / nsl, s = it - rc * nsl;
      const int l0 = rc * kRC, nr = min(kRC, L - l0);
      const int w4 = (min(kDS, D - s * kDS) + 3) / 4;
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          pn[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < kTQ; ++j) acc[i][j] = 0.0f;
        }
      }
      cp_async_wait<1>();                        // chunk it has landed
      __syncthreads();
      const float* rows = ring + (it & 1) * kRC * kDS;
      const float* sq = sqb + (nsl > 1 ? (it & 1) * query_float4() * 4 : 0);
      if (rc == 0) norms(qn, sq, sq4, S, w4, s > 0, rg, sub);
      if (!kFold) norms(rn, rows, kDS4, nr, w4, s > 0, rg, sub);
      // the tile: rows rg * 4 + i, queries qg + QG * j, dims k + KG * x
      const float4* r4 =
          reinterpret_cast<const float4*>(rows) + rg * kTR * kDS4;
      const float4* q4 = reinterpret_cast<const float4*>(sq) + qg * sq4;
      for (int x = k; x < w4; x += KG) {
        float4 p[kTR], q[kTQ];
#pragma unroll
        for (int i = 0; i < kTR; ++i) p[i] = r4[i * kDS4 + x];
#pragma unroll
        for (int j = 0; j < kTQ; ++j)
          if (j < nj) q[j] = q4[j * QG * sq4 + x];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          if (kFold) pn[i] = dot4(p[i], p[i], pn[i]);
#pragma unroll
          for (int j = 0; j < kTQ; ++j)
            if (j < nj) acc[i][j] = dot4(p[i], q[j], acc[i][j]);
        }
      }
      __syncthreads();                           // stage it & 1 is free
      issue(it + 2);
      if (s < nsl - 1) continue;
      // the chunk's distances: reduce over the KG lanes, stage, store
      for (int off = 1; off < KG; off <<= 1) {
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          if (kFold) pn[i] += __shfl_xor_sync(kFull, pn[i], off);
#pragma unroll
          for (int j = 0; j < kTQ; ++j)
            acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], off);
        }
      }
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int row = rg * kTR + i;
          if (row >= nr) continue;
          const float pr = kFold ? pn[i] : rn[row];
#pragma unroll
          for (int j = 0; j < kTQ; ++j) {
            const int qi = qg + QG * j;
            if (qi < S) {
              const float d = pr - 2.0f * acc[i][j] + qn[qi];
              sres[row * bcw + sel[qi]] = d < 0.0f ? 0.0f : d;
            }
          }
        }
      }
      __syncthreads();
      // each entry is read once and set back to +inf for the next chunk
      store_slab(o + (size_t)l0 * B, nr, bcw, B, [&](int j) {
        const float v = sres[j];
        sres[j] = CUDART_INF_F;
        return v;
      });
    }
  };
  if (QG == 1)
    scan(std::true_type{});
  else
    scan(std::false_type{});
  cp_async_wait<0>();
}

}  // namespace

extern "C" int ivf_scan_clustermajor_launch(const void* post,
                                            const void* active,
                                            const void* qsel,
                                            const void* queries, void* out,
                                            int A, int C, int L, int B, int D,
                                            void* stream) {
  const size_t smem = smem_bytes((D + kDS - 1) / kDS);
  static_assert(smem_bytes(2) <= 232448, "shared memory of one block");
  // Every D needs more than 48 KB, so the limit is raised once a device, to
  // the most any D takes, and not on every launch.
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  REPRO_RETURN_IF_ERROR();
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (!known || !raised[dev].load(std::memory_order_relaxed)) {
    cudaFuncSetAttribute(ivf_scan_clustermajor_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_bytes(2));
    REPRO_RETURN_IF_ERROR();
    if (known) raised[dev].store(true, std::memory_order_relaxed);
  }
  // 16-byte copies when every row and query slice is 16-byte aligned
  const int vec = D % 4 == 0 && (uintptr_t)post % 16 == 0 &&
                  (uintptr_t)queries % 16 == 0;
  dim3 grid(A, (B + kBC - 1) / kBC);
  ivf_scan_clustermajor_kernel<<<grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const float*)post, (const int*)active, (const unsigned char*)qsel,
      (const float*)queries, (float*)out, C, L, B, D, vec);
  return (int)cudaGetLastError();
}
