// B6a: legacy full-distance f32 posting scan.
//
// Replaces the Pallas kernel `ivf_scan` (body `_qmajor_kernel`) of
// src/repro/kernels/ivf_scan.py.  For every (query b, probe p) it writes the
// L distances of query b to the rows of cluster clamp(cids[b, p], 0, C - 1):
//
//   out[b, p, l] = clamp0(||q||^2 - 2 q . p_l + ||p_l||^2),
//
// or +inf for all L when mask[b, p] is false; clamp0(d) is `d < 0 ? 0 : d`,
// which keeps a NaN as jnp.maximum(d, 0.0) does.  Pad ids are not looked at:
// the caller masks them, as the reference's caller does.
//
// What bounds it on an H100: every (b, p) reads its (L, D) block, so a batch
// reads B * P * L * D * 4 bytes (32 x 16 x 64 KB = 32 MB at the serving
// shape, 10 us at 3.35 TB/s; repeats hit L2) and writes B * P * L * 4; the
// FLOPs are 2 * B * P * L * D, 4 operations per 4 bytes read.  Bound by
// bytes, so what matters is how many bytes are in flight.
//
// What the design does about it: one block of 128 threads per (b, p), so
// the grid has B * P blocks and at about 37 KB of shared memory each, the
// serving batch's 512 blocks are all resident at once.  A block streams its
// cluster's rows into shared memory with 16-byte cp.async copies, RC rows a
// chunk, through a 2-stage ring: two chunks are in flight while the block
// computes on neither, then one while it computes on the other.  A group of
// G threads (G a power of two, so that each thread has about 8 float4 of a
// row) owns a row's dot and norm: each thread one pass over its float4s of
// the row and of the query, both from shared memory, then log2(G) xor
// shuffles combine the group (2 at D = 128, none at G = 1), and the group's
// first thread writes the distance.  The row stride is padded to G mod 8
// float4, so that the 8 threads of a quarter-warp read distinct banks.  The
// query's norm is taken the same way, once a block.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 20 * 1024;   // a chunk of rows; 2 chunks + the
                                         // query stay under 48 KB
constexpr unsigned kFull = 0xffffffffu;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// row stride in float4 of a chunk whose rows are read by groups of g
// threads: at least d4, and congruent to g mod 8 (0 for g >= 8)
__host__ inline int row_stride4(int d4, int g) {
  return d4 + ((g % 8) - d4 % 8 + 8) % 8;
}

// threads a row: the largest power of two up to 32 that leaves each thread
// at least 8 float4 of the row, raised until a chunk fits kStageBytes
__host__ inline int group_size(int d4) {
  int g = 1;
  while (g < 32 && 16 * g <= d4) g <<= 1;
  while (g < 32 && (kThreads / g) * row_stride4(d4, g) * 16 > kStageBytes)
    g <<= 1;
  return g;
}

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ post, const int* __restrict__ cids,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ queries, float* __restrict__ out,
                int C, int P, int L, int D, int G, int SF4) {
  extern __shared__ __align__(16) float4 sm4[];
  const int d4 = D / 4;
  const int rc = kThreads / G;                // rows a chunk
  float4* q4 = sm4;                           // [d4]
  float4* ring = sm4 + d4;                    // [2][rc * SF4]
  const int bp = blockIdx.x;
  const int b = bp / P;
  const int tid = threadIdx.x;
  float* o = out + (size_t)bp * L;
  if (mask[bp] == 0) {                   // uniform in the block
    for (int l = tid; l < L; l += kThreads) o[l] = CUDART_INF_F;
    return;
  }
  const int c = min(max(cids[bp], 0), C - 1);
  const float4* blk =
      reinterpret_cast<const float4*>(post) + (size_t)c * L * d4;
  const int nch = (L + rc - 1) / rc;
  auto issue = [&](int ch) {
    if (ch < nch) {
      const int l0 = ch * rc;
      const int n = min(rc, L - l0) * d4;
      float4* dst = ring + (ch & 1) * rc * SF4;
      for (int e = tid; e < n; e += kThreads) {
        const int r = e / d4, k = e - r * d4;
        cp_async16(dst + r * SF4 + k, blk + (size_t)(l0 + r) * d4 + k);
      }
    }
    cp_async_commit();                   // empty groups keep the count
  };
  issue(0);
  issue(1);
  float* qs = reinterpret_cast<float*>(q4);   // any alignment of queries
  for (int e = tid; e < D; e += kThreads) qs[e] = queries[(size_t)b * D + e];

  const int r = tid / G, g = tid & (G - 1);
  float q2 = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<1>();
    __syncthreads();                     // chunk ch (and the query) landed
    if (ch == 0) {
      for (int k = g; k < d4; k += G) {
        const float4 x = q4[k];
        q2 = fmaf(x.x, x.x, q2);
        q2 = fmaf(x.y, x.y, q2);
        q2 = fmaf(x.z, x.z, q2);
        q2 = fmaf(x.w, x.w, q2);
      }
      for (int off = 1; off < G; off <<= 1)
        q2 += __shfl_xor_sync(kFull, q2, off);
    }
    const int l = ch * rc + r;
    const float4* row = ring + (ch & 1) * rc * SF4 + r * SF4;
    float dot = 0.0f, pn = 0.0f;
    if (l < L) {
      for (int k = g; k < d4; k += G) {
        const float4 p = row[k];
        const float4 x = q4[k];
        dot = fmaf(x.x, p.x, dot);
        dot = fmaf(x.y, p.y, dot);
        dot = fmaf(x.z, p.z, dot);
        dot = fmaf(x.w, p.w, dot);
        pn = fmaf(p.x, p.x, pn);
        pn = fmaf(p.y, p.y, pn);
        pn = fmaf(p.z, p.z, pn);
        pn = fmaf(p.w, p.w, pn);
      }
    }
    for (int off = 1; off < G; off <<= 1) {
      dot += __shfl_xor_sync(kFull, dot, off);
      pn += __shfl_xor_sync(kFull, pn, off);
    }
    if (g == 0 && l < L) {
      const float d = q2 - 2.0f * dot + pn;
      o[l] = d < 0.0f ? 0.0f : d;        // keeps NaN, as jnp.maximum does
    }
    __syncthreads();                     // every thread is done with chunk ch
    issue(ch + 2);
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int ivf_scan_launch(const void* post, const void* cids,
                               const void* mask, const void* queries,
                               void* out, int B, int C, int P, int L, int D,
                               void* stream) {
  const int d4 = D / 4;
  const int g = group_size(d4);
  const int sf4 = row_stride4(d4, g);
  const size_t smem = ((size_t)d4 + 2 * (size_t)(kThreads / g) * sf4) * 16;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  ivf_scan_kernel<<<B * P, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)post, (const int*)cids, (const unsigned char*)mask,
      (const float*)queries, (float*)out, C, P, L, D, g, sf4);
  return (int)cudaGetLastError();
}
