// B7: legacy int8-residual posting scan, full (B, P, L) distances.
//
// Replaces the Pallas kernel `ivf_scan_q8` (body `_kernel`) of
// src/repro/kernels/ivf_scan_q8.py.  For every (query b, probe p), with
// c = clamp(cids[b, p], 0, C - 1) and qc = q_b - centroid[c], it writes the
// L residual-form distances
//
//   out[b, p, l] = clamp0(||qc||^2 - 2 s_c (qc . r8[c, l]) + norm2[c, l]),
//
// or +inf for all L when mask[b, p] is false.  clamp0(d) is
// `d < 0 ? 0 : d`, which keeps a NaN as jnp.maximum(d, 0.0) does.  Ids are
// not looked at: the reference kernel takes none, and a dead slot (zero code,
// zero norm) reads ||qc||^2.
//
// What bounds it on an H100: each live (b, p) reads its (L, D) int8 block,
// L norms and one centroid row, and writes L floats; the operations are
// 2 * L * D per live probe.  At the resident serving shape (B 32, P 16,
// L 128, D 128) the blocks are 8.4 MB of codes: 0.0026 ms of bytes at
// 3.35 TB/s against 0.00025 ms of fp32 operations.  Bound by bytes.
//
// What the design does about it: one block of 4 warps per (b, p), as B6a,
// so B * P blocks fill the card at serving batch sizes.  The block forms qc
// and ||qc||^2 once in shared memory; a warp walks its rows with coalesced
// 4-byte loads (a row of D = 128 codes is one 128-byte read by the warp),
// dequantises in registers, and reduces the dot with shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ivf_scan_q8_legacy_kernel(const signed char* __restrict__ q8,
                          const float* __restrict__ scale,
                          const float* __restrict__ norm2,
                          const float* __restrict__ cents,
                          const int* __restrict__ cids,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ queries,
                          float* __restrict__ out, int C, int P, int L,
                          int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qc = reinterpret_cast<float*>(smem);
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
    const float v = queries[(size_t)b * D + d] - cents[(size_t)c * D + d];
    qc[d] = v;
    part = fmaf(v, v, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float qc2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) qc2 += red[w];
  const float s = scale[c];

  const char4* blk = reinterpret_cast<const char4*>(q8 + (size_t)c * L * D);
  const float4* q4 = reinterpret_cast<const float4*>(qc);
  const float* n2 = norm2 + (size_t)c * L;
  const int d4 = D / 4;
  for (int l = warp; l < L; l += kThreads / 32) {
    float cross = 0.0f;
    for (int e = lane; e < d4; e += 32) {
      const char4 r = blk[(size_t)l * d4 + e];
      const float4 x = q4[e];
      cross = fmaf(x.x, (float)r.x, cross);
      cross = fmaf(x.y, (float)r.y, cross);
      cross = fmaf(x.z, (float)r.z, cross);
      cross = fmaf(x.w, (float)r.w, cross);
    }
    for (int off = 16; off > 0; off >>= 1)
      cross += __shfl_xor_sync(kFull, cross, off);
    if (lane == 0) {
      const float d = qc2 - 2.0f * s * cross + n2[l];
      o[l] = d < 0.0f ? 0.0f : d;
    }
  }
}

}  // namespace

extern "C" int ivf_scan_q8_legacy_launch(const void* q8, const void* scale,
                                         const void* norm2, const void* cents,
                                         const void* cids, const void* mask,
                                         const void* queries, void* out,
                                         int B, int C, int P, int L, int D,
                                         void* stream) {
  const size_t smem = (size_t)D * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ivf_scan_q8_legacy_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    REPRO_RETURN_IF_ERROR();
  }
  ivf_scan_q8_legacy_kernel<<<B * P, kThreads, smem, (cudaStream_t)stream>>>(
      (const signed char*)q8, (const float*)scale, (const float*)norm2,
      (const float*)cents, (const int*)cids, (const unsigned char*)mask,
      (const float*)queries, (float*)out, C, P, L, D);
  return (int)cudaGetLastError();
}
