// K1: fused int8-residual posting scan with in-kernel dedup top-k2.
//
// Replaces the Pallas kernel `ivf_scan_q8_topk` (body `_qtile_topk_q8_kernel`)
// of src/repro/kernels/ivf_scan_q8.py.  Per query b it builds the deduped,
// sorted probe plan that plan_tile_probes(cids, mask, 1, R) gives (clamped
// cluster ids, masked or negative probes dead and sorted last, each cluster
// live in its first slot only) and, for every live packed row r of every
// live slot, computes
//
//   d = ||q - c_r||^2 - 2 s_r (q - c_r) . r8 + s_r^2 ||r8||^2,
//
// clamped at 0 (a NaN stays NaN, as jnp.maximum keeps it), masks rows whose
// id is < 0, and keeps a top-k2 that is unique by id (per-id minimum).
// Output is ascending, padded (+inf, -1).  A NaN distance of a live row
// empties the query's candidates at that slot, as the reference's
// _extract_topk does (jnp.min gives NaN, so it emits (+inf, -1) k2 times and
// kills nothing): only later slots refill them.  The slots come in ascending
// cluster order, the order in which the reference's tiles of 8 visit that
// query's clusters, so the wipes agree.
//
// What bounds it on an H100: at serving shapes (B = 32 queries, P = 16
// probes, L = D = 128, k2 = 24) the used rows' codes, norms and ids are
// about 8 MB (458 rows x ~17.9 KB, 2.5 us at 3.35 TB/s) and the FMAs
// 2*B*P*L*D ~ 17 MFLOP (0.25 us at the fp32 peak).  So the kernel is bound
// by latency and by how many SMs it keeps busy, not by bytes or FLOPs.
//
// What the design does about it:
// - the plan is built in shared memory by each block (a rank sort by
//   counting over the query's P <= 256 probes), so the host issues no plan
//   ops and the launch needs nothing but the raw (B, P) cids and mask;
// - a query's live slots are split into n_chunks contiguous runs, one block
//   per (query, chunk): a batch of 32 queries at P = 16 runs on up to 512
//   blocks of one slot each, about four an SM, instead of 32 blocks;
// - a slot's (L, D) int8 codes, its norms, ids and centroid reach shared
//   memory through 16-byte cp.async into two buffers, so the next stage
//   loads while this one is scored; rows sit at an odd multiple of 16 bytes,
//   so a quarter-warp's 16-byte row reads hit distinct banks;
// - each thread scores one row in fp32 on CUDA cores (a matrix-vector
//   product: tensor cores bring nothing at one query a block), bytes turned
//   into floats exactly with a byte permute and one subtraction (cheaper
//   than I2F), four partial sums a row;
// - each warp keeps its own top-k2 of its rows (sorted in registers at
//   k2 <= 32, in shared memory above), rejecting candidates not below its
//   worst with one ballot; a NaN is flagged block-wide by the barrier that
//   ends each slot anyway, so the wipe costs no extra barrier;
// - every warp writes a partial (sorted, unique by id); the block's first
//   partial carries the flag that it was wiped, and the merge kernel of
//   topk_partials.cuh, shared with B2, drops the partials before the last
//   flagged one and merges the rest in (distance, partial, rank) order, so
//   the result does not depend on which block finished first.  It is exact:
//   an id of the global top-k2 is in the top-k2 of the warp that saw its
//   minimum.
#include "topk_partials.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 256;              // probes a query may have
constexpr int kBufBytes = 128 * 144;    // one code buffer: LC rows x stride

// Bytes between staged code rows: an odd number of 16-byte units, so eight
// threads reading 16 bytes of eight consecutive rows hit distinct banks.
__host__ __device__ inline int code_stride(int D) {
  return 16 * (((D + 15) / 16) | 1);
}

// Rows of one slot staged at a time.
__host__ __device__ inline int chunk_rows(int L, int D) {
  const int lc = kBufBytes / code_stride(D);
  return lc < 1 ? 1 : (lc < L ? lc : L);
}

// Signed byte k of w as a float, exactly: 0x4B000000 | (byte ^ 0x80) is
// 2^23 + byte + 128 as a float.
template <int K>
__device__ __forceinline__ float s8f(unsigned w) {
  return __int_as_float((int)__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                         0x7540u | K)) - 8388736.0f;
}

// (q - c) . r8 over one staged row of n16 16-byte units; qc is zero past D.
__device__ __forceinline__ float row_dot(const int4* __restrict__ row,
                                         const float4* __restrict__ qc,
                                         int n16) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int c = 0; c < n16; ++c) {
    const int4 w = row[c];
    const float4 x = qc[4 * c], y = qc[4 * c + 1], z = qc[4 * c + 2],
                 v = qc[4 * c + 3];
    const unsigned wx = (unsigned)w.x, wy = (unsigned)w.y,
                   wz = (unsigned)w.z, ww = (unsigned)w.w;
    a0 = fmaf(x.x, s8f<0>(wx), a0);
    a0 = fmaf(x.y, s8f<1>(wx), a0);
    a0 = fmaf(x.z, s8f<2>(wx), a0);
    a0 = fmaf(x.w, s8f<3>(wx), a0);
    a1 = fmaf(y.x, s8f<0>(wy), a1);
    a1 = fmaf(y.y, s8f<1>(wy), a1);
    a1 = fmaf(y.z, s8f<2>(wy), a1);
    a1 = fmaf(y.w, s8f<3>(wy), a1);
    a2 = fmaf(z.x, s8f<0>(wz), a2);
    a2 = fmaf(z.y, s8f<1>(wz), a2);
    a2 = fmaf(z.z, s8f<2>(wz), a2);
    a2 = fmaf(z.w, s8f<3>(wz), a2);
    a3 = fmaf(v.x, s8f<0>(ww), a3);
    a3 = fmaf(v.y, s8f<1>(ww), a3);
    a3 = fmaf(v.z, s8f<2>(ww), a3);
    a3 = fmaf(v.w, s8f<3>(ww), a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// SMALL (k2 <= 32): each warp's buffer lives in its registers, lane j
// holding the j-th smallest entry; otherwise in shared memory.
template <bool SMALL>
__global__ void __launch_bounds__(kThreads, 4)
q8_topk_chunk_kernel(const int8_t* __restrict__ q8,
                     const float* __restrict__ scale,
                     const float* __restrict__ norm2,
                     const float* __restrict__ cent,
                     const int* __restrict__ ids,
                     const int* __restrict__ cids,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ queries,
                     float* __restrict__ part_d, int* __restrict__ part_i,
                     int* __restrict__ part_nan, int R, int P, int L, int D,
                     int k2, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LC = chunk_rows(L, D);
  const int stride = code_stride(D);
  const int n16 = (D + 15) / 16;
  unsigned char* codes = smem;                                // 2 x kBufBytes
  float* cs = reinterpret_cast<float*>(codes + 2 * kBufBytes);  // 2 x D
  float* qc = cs + 2 * D;                                     // 16 * n16
  float* q = qc + 16 * n16;                                   // D
  float* n2s = q + D;                                         // 2 x LC
  int* ids_s = reinterpret_cast<int*>(n2s + 2 * LC);          // 2 x LC
  float* bd = reinterpret_cast<float*>(ids_s + 2 * LC);  // kWarps x k2
  int* bi = reinterpret_cast<int*>(bd + kWarps * k2);    // kWarps x k2
  __shared__ int key[kMaxP];
  __shared__ int uniq[kMaxP];
  __shared__ unsigned char first[kMaxP];
  __shared__ float red[kWarps];
  __shared__ int n_live;

  const int b = blockIdx.x;
  const int ch = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // -- the plan: plan_tile_probes(cids, mask, 1, R) for query b ------------
  if (tid == 0) n_live = 0;
  for (int i = tid; i < P; i += kThreads) {
    const int c = cids[(size_t)b * P + i];
    const bool live = mask[(size_t)b * P + i] != 0 && c >= 0;
    key[i] = live ? (c < R ? c : R - 1) : R;   // R: dead, sorts last
  }
  for (int d = tid; d < D; d += kThreads) q[d] = queries[(size_t)b * D + d];
  for (int d = D + tid; d < 16 * n16; d += kThreads) qc[d] = 0.0f;
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    const int k = key[i];
    bool f = k < R;
    for (int j = 0; j < i && f; ++j) f = key[j] != k;
    first[i] = f;
  }
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    if (!first[i]) continue;
    const int k = key[i];
    int pos = 0;
    for (int j = 0; j < P; ++j) pos += first[j] && key[j] < k;
    uniq[pos] = k;                       // the pos-th live slot of the plan
    atomicAdd(&n_live, 1);
  }
  __syncthreads();
  const int lo = (int)((long long)ch * n_live / n_chunks);
  const int hi = (int)((long long)(ch + 1) * n_live / n_chunks);

  // -- stage (slot i, rows l0 ..) into buffer buf --------------------------
  auto issue = [&](int i, int l0, int buf) {
    const int r = uniq[i];
    const int lc = min(LC, L - l0);
    const int8_t* src = q8 + ((size_t)r * L + l0) * D;
    unsigned char* dst = codes + buf * kBufBytes;
    if (D % 16 == 0) {
      const int per = D / 16;
      for (int w = tid; w < lc * per; w += kThreads) {
        const int l = w / per;
        const int c = w - l * per;
        cp_async16(dst + l * stride + 16 * c, src + (size_t)l * D + 16 * c);
      }
    } else {
      const int per = D / 4;
      for (int w = tid; w < lc * per; w += kThreads) {
        const int l = w / per;
        const int c = w - l * per;
        cp_async4(reinterpret_cast<int*>(dst + l * stride + 4 * c),
                  reinterpret_cast<const int*>(src + (size_t)l * D + 4 * c));
      }
    }
    for (int l = tid; l < lc; l += kThreads) {
      cp_async4(n2s + buf * LC + l, norm2 + (size_t)r * L + l0 + l);
      cp_async4(ids_s + buf * LC + l, ids + (size_t)r * L + l0 + l);
    }
    if (l0 == 0)
      for (int c = tid; c < D / 4; c += kThreads)
        cp_async16(cs + buf * D + 4 * c, cent + (size_t)r * D + 4 * c);
    cp_async_commit();
  };

  if (lo < hi) issue(lo, 0, 0);
  float* my_bd = bd + warp * k2;
  int* my_bi = bi + warp * k2;
  if constexpr (!SMALL) {
    for (int j = lane; j < k2; j += 32) {
      my_bd[j] = CUDART_INF_F;
      my_bi[j] = -1;
    }
    __syncwarp();
  }
  float worst = CUDART_INF_F;            // of this warp's buffer
  int worst_pos = k2 - 1;
  float rd = CUDART_INF_F;               // SMALL: this lane's buffer entry
  int ri = -1;
  bool wiped = false;
  bool nan_here = false;
  float qcn = 0.0f, sc = 0.0f;

  int i = lo, l0 = 0, cur = 0;
  while (i < hi) {
    int ni = i, nl0 = l0 + LC;
    const bool slot_end = nl0 >= L;
    if (slot_end) {
      ni = i + 1;
      nl0 = 0;
    }
    if (ni < hi) {
      issue(ni, nl0, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // stage (i, l0) visible
    const int r = uniq[i];
    if (l0 == 0) {                       // a new slot: q - c and its norm
      float part = 0.0f;
      for (int d = tid; d < D; d += kThreads) {
        const float v = q[d] - cs[cur * D + d];
        qc[d] = v;
        part = fmaf(v, v, part);
      }
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      qcn = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) qcn += red[w];
      sc = scale[r];
    }

    const unsigned char* buf = codes + cur * kBufBytes;
    const int lc = min(LC, L - l0);
    for (int base = 0; base < lc; base += kThreads) {
      const int l = base + tid;
      float cand = CUDART_INF_F;
      int cid = -1;
      if (l < lc) {
        const float cross = row_dot(
            reinterpret_cast<const int4*>(buf + (size_t)l * stride),
            reinterpret_cast<const float4*>(qc), n16);
        float dist = qcn - 2.0f * sc * cross + n2s[cur * LC + l];
        dist = dist < 0.0f ? 0.0f : dist;
        cid = ids_s[cur * LC + l];
        const bool live = cid >= 0;
        nan_here |= live && isnan(dist);
        cand = live ? dist : CUDART_INF_F;
      }
      // Sequential merge semantics, one candidate at a time: an id already
      // in the buffer keeps its smaller distance, a new id replaces the
      // current worst when strictly better.  Candidates not below the worst
      // at ballot time can never enter (the worst only decreases); a NaN is
      // never below it.
      unsigned m = __ballot_sync(kFull, cand < worst);
      while (m) {
        const int srcl = __ffs(m) - 1;
        m &= m - 1;
        const float dd = __shfl_sync(kFull, cand, srcl);
        const int id = __shfl_sync(kFull, cid, srcl);
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
    // the barrier that frees this stage's buffers; at a slot's end it also
    // tells every warp whether a live row of the slot gave a NaN
    if (slot_end) {
      if (__syncthreads_or(nan_here)) {
        // the reference's wipe: nothing of this slot or before survives
        if constexpr (!SMALL) {
          for (int j = lane; j < k2; j += 32) {
            my_bd[j] = CUDART_INF_F;
            my_bi[j] = -1;
          }
          __syncwarp();
        }
        rd = CUDART_INF_F;
        ri = -1;
        worst = CUDART_INF_F;
        worst_pos = k2 - 1;
        wiped = true;
      }
      nan_here = false;
    } else {
      __syncthreads();
    }
    i = ni;
    l0 = nl0;
    cur ^= 1;
  }

  // this warp's partial, ascending: SMALL's buffer is sorted; otherwise the
  // rank of (distance, slot) among the k2 buffer entries
  const int n_parts = n_chunks * kWarps;
  const size_t gp = (size_t)b * n_parts + ch * kWarps + warp;
  float* od = part_d + gp * k2;
  int* oi = part_i + gp * k2;
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
  // the block's first partial says whether the block wiped: the merge then
  // keeps it and every partial after it (this block's other warps' too)
  if (lane == 0) part_nan[gp] = warp == 0 && wiped ? 1 : 0;
}

}  // namespace

extern "C" size_t ivf_scan_q8_topk_smem_bytes(int L, int D, int k2) {
  const size_t lc = (size_t)chunk_rows(L, D);
  const size_t n16 = (size_t)(D + 15) / 16;
  return (size_t)2 * kBufBytes + (size_t)2 * D * 4 + n16 * 16 * 4 +
         (size_t)D * 4 + lc * 2 * 8 +
         (k2 > 32 ? (size_t)2 * kWarps * k2 * 4 : 0);
}

// The most blocks a query may take: at most one a probe, and at most as
// many as the merge's kMaxChunks lanes and kMaxPartials staged entries
// allow, at kWarps partials a block.
extern "C" int ivf_scan_q8_topk_max_chunks(int P, int k2) {
  const int top = min(kMaxChunks / kWarps, max(P, 1));
  return k2 > 0 ? max(1, min(top, kMaxPartials / (kWarps * k2))) : top;
}

extern "C" int ivf_scan_q8_topk_launch(
    const void* q8, const void* scale, const void* norm2, const void* cent,
    const void* ids, const void* cids, const void* mask, const void* queries,
    void* out_d, void* out_i, void* part_d, void* part_i, void* part_nan,
    int B, int R, int P, int L, int D, int k2, int n_chunks, void* stream) {
  if (P < 1 || P > kMaxP || k2 < 1 || D % 4 != 0 || n_chunks < 1 ||
      n_chunks > ivf_scan_q8_topk_max_chunks(P, k2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ivf_scan_q8_topk_smem_bytes(L, D, k2);
  auto kernel =
      k2 <= 32 ? q8_topk_chunk_kernel<true> : q8_topk_chunk_kernel<false>;
  // the plan's static arrays share the 48 KB with the dynamic buffer
  static const size_t room_reg =
      repro::default_dynamic_smem(q8_topk_chunk_kernel<true>);
  static const size_t room_smem =
      repro::default_dynamic_smem(q8_topk_chunk_kernel<false>);
  if (smem > (k2 <= 32 ? room_reg : room_smem)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    REPRO_RETURN_IF_ERROR();
  }
  kernel<<<dim3(B, n_chunks), kThreads, smem, st>>>(
      (const int8_t*)q8, (const float*)scale, (const float*)norm2,
      (const float*)cent, (const int*)ids, (const int*)cids,
      (const unsigned char*)mask, (const float*)queries, (float*)part_d,
      (int*)part_i, (int*)part_nan, R, P, L, D, k2, n_chunks);
  REPRO_RETURN_IF_ERROR();
  return launch_topk_merge((const float*)part_d, (const int*)part_i,
                           (const int*)part_nan, (float*)out_d, (int*)out_i,
                           B, k2, n_chunks * kWarps, st);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
