// B6a: legacy full-distance f32 posting scan.
//
// Replaces the Pallas kernel `ivf_scan` (body `_qmajor_kernel`) of
// src/repro/kernels/ivf_scan.py.  For every (query b, probe p) it writes the
// L distances of query b to the rows of cluster clamp(cids[b, p], 0, C - 1):
//
//   out[b, p, l] = max(||q||^2 - 2 q . p_l + ||p_l||^2, 0),
//
// or +inf for all L when mask[b, p] is false.  Pad ids are not looked at:
// the caller masks them, as the reference's caller does.
//
// What bounds it on an H100: every (b, p) reads its (L, D) block, so a batch
// reads B * P * L * D * 4 bytes (32 x 16 x 64 KB = 32 MB at the serving
// shape, 10 us at 3.35 TB/s; repeats hit L2) and writes B * P * L * 4; the
// FLOPs are 2 * B * P * L * D, 4 operations per 4 bytes read.  Bound by
// bytes.
//
// What the design does about it: one block of 4 warps per (b, p), so the
// grid has B * P blocks and fills the card at serving batch sizes.  A warp
// walks its rows with coalesced float4 loads (a row of D = 128 floats is one
// 512-byte read by the warp), computes the dot and the row norm together,
// and reduces them with shuffles; the query stays in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ post, const int* __restrict__ cids,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ queries, float* __restrict__ out,
                int C, int P, int L, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  __shared__ float red[kThreads / 32];
  const int bp = blockIdx.x;
  const int b = bp / P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* o = out + (size_t)bp * L;
  if (mask[bp] == 0) {                   // uniform in the block
    for (int l = tid; l < L; l += kThreads) o[l] = CUDART_INF_F;
    return;
  }
  const int c = min(max(cids[bp], 0), C - 1);
  float part = 0.0f;
  for (int d = tid; d < D; d += kThreads) {
    const float v = queries[(size_t)b * D + d];
    q[d] = v;
    part = fmaf(v, v, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float q2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) q2 += red[w];

  const float4* blk = reinterpret_cast<const float4*>(post + (size_t)c * L * D);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const int d4 = D / 4;
  for (int l = warp; l < L; l += kThreads / 32) {
    float dot = 0.0f, pn = 0.0f;
    for (int e = lane; e < d4; e += 32) {
      const float4 p = blk[(size_t)l * d4 + e];
      const float4 x = q4[e];
      dot = fmaf(x.x, p.x, dot);
      dot = fmaf(x.y, p.y, dot);
      dot = fmaf(x.z, p.z, dot);
      dot = fmaf(x.w, p.w, dot);
      pn = fmaf(p.x, p.x, pn);
      pn = fmaf(p.y, p.y, pn);
      pn = fmaf(p.z, p.z, pn);
      pn = fmaf(p.w, p.w, pn);
    }
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(kFull, dot, off);
      pn += __shfl_xor_sync(kFull, pn, off);
    }
    if (lane == 0) o[l] = fmaxf(q2 - 2.0f * dot + pn, 0.0f);
  }
}

}  // namespace

extern "C" int ivf_scan_launch(const void* post, const void* cids,
                               const void* mask, const void* queries,
                               void* out, int B, int C, int P, int L, int D,
                               void* stream) {
  const size_t smem = (size_t)D * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ivf_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    REPRO_RETURN_IF_ERROR();
  }
  ivf_scan_kernel<<<B * P, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)post, (const int*)cids, (const unsigned char*)mask,
      (const float*)queries, (float*)out, C, P, L, D);
  return (int)cudaGetLastError();
}
