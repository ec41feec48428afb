// B6b: cluster-major legacy f32 posting scan.
//
// Replaces the Pallas kernel `ivf_scan_clustermajor` (body `_cmajor_kernel`)
// of src/repro/kernels/ivf_scan.py.  For every active cluster a (the union of
// a batch's probed clusters) it writes the distances of all L rows of cluster
// c = clamp(active[a], 0, C - 1) to every query of the batch:
//
//   out[a, l, b] = clamp0(||p_l||^2 - 2 p_l . q_b + ||q_b||^2)
//
// or +inf where qsel[a, b] is false.  clamp0(d) is `d < 0 ? 0 : d`, which
// keeps a NaN as jnp.maximum(d, 0.0) does (fmaxf would turn it into 0).
//
// What bounds it on an H100: the work is A * L * B dot products of length D
// (2 * A * L * B * D operations) against A * L * D * 4 bytes of rows read and
// A * L * B * 4 bytes written.  At the serving shape (A ~ 458, L 128, D 128,
// B 32) that is 30 MB read, 7.5 MB written and 0.48 GFLOP: 0.011 ms of bytes
// against 0.007 ms of fp32 operations.  Bound by bytes.
//
// What the design does about it: one block of 256 threads per (cluster, chunk
// of 32 rows, chunk of 32 queries), so the grid has A * ceil(L / 32) *
// ceil(B / 32) blocks and every row is read from device memory once per
// query chunk.  The block stages its 32 rows and its 32 queries in shared
// memory one slice of D at a time, with coalesced loads; the queries are kept
// transposed with a padded stride so a warp's 32 lanes read 32 banks.  A warp
// owns 4 rows, a lane one query: the lane reads the warp's row value once
// (a broadcast) and its query value once, accumulating the dot and both norms
// in registers.  Consecutive lanes store consecutive b, so the (A, L, B)
// writes are coalesced; output offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 32;                      // queries per block (one warp)
constexpr int kRowsPerWarp = 4;
constexpr int kRB = (kThreads / 32) * kRowsPerWarp;   // 32 rows per block
constexpr int kDC = 128;                     // D slice staged per pass

__global__ void __launch_bounds__(kThreads)
ivf_scan_clustermajor_kernel(const float* __restrict__ post,
                             const int* __restrict__ active,
                             const unsigned char* __restrict__ qsel,
                             const float* __restrict__ queries,
                             float* __restrict__ out, int C, int L, int B,
                             int D) {
  __shared__ float rows[kRB * kDC];            // rows[r * kDC + d]
  __shared__ float qt[kDC * (kQB + 1)];        // qt[d * (kQB + 1) + b]
  const int a = blockIdx.x;
  const int l0 = blockIdx.y * kRB;
  const int b0 = blockIdx.z * kQB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = min(max(active[a], 0), C - 1);
  const float* blk = post + (size_t)c * L * D;

  float dot[kRowsPerWarp], pn[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = pn[i] = 0.0f;
  float qn = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDC) {
    const int dc = min(kDC, D - d0);
    for (int i = tid; i < kRB * kDC; i += kThreads) {
      const int r = i / kDC, dd = i % kDC;
      const int l = l0 + r;
      rows[i] = (l < L && dd < dc) ? blk[(size_t)l * D + d0 + dd] : 0.0f;
    }
    for (int i = tid; i < kQB * kDC; i += kThreads) {
      const int bb = i / kDC, dd = i % kDC;
      const int b = b0 + bb;
      qt[dd * (kQB + 1) + bb] =
          (b < B && dd < dc) ? queries[(size_t)b * D + d0 + dd] : 0.0f;
    }
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      const float q = qt[dd * (kQB + 1) + lane];
      qn = fmaf(q, q, qn);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = rows[(warp * kRowsPerWarp + i) * kDC + dd];
        dot[i] = fmaf(p, q, dot[i]);
        pn[i] = fmaf(p, p, pn[i]);
      }
    }
    __syncthreads();
  }

  const int b = b0 + lane;
  if (b >= B) return;
  const bool sel = qsel[(size_t)a * B + b] != 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int l = l0 + warp * kRowsPerWarp + i;
    if (l >= L) continue;
    const float d = pn[i] - 2.0f * dot[i] + qn;
    out[((size_t)a * L + l) * B + b] =
        sel ? (d < 0.0f ? 0.0f : d) : CUDART_INF_F;
  }
}

}  // namespace

extern "C" int ivf_scan_clustermajor_launch(const void* post,
                                            const void* active,
                                            const void* qsel,
                                            const void* queries, void* out,
                                            int A, int C, int L, int B, int D,
                                            void* stream) {
  dim3 grid(A, (L + kRB - 1) / kRB, (B + kQB - 1) / kQB);
  ivf_scan_clustermajor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)post, (const int*)active, (const unsigned char*)qsel,
      (const float*)queries, (float*)out, C, L, B, D);
  return (int)cudaGetLastError();
}
