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
// L 128, D 128) the distinct blocks are 8.25 MB: 0.0025 ms of bytes at
// 3.35 TB/s against 0.00025 ms of fp32 operations.  Bound by bytes, and at
// one wave of 512 blocks by how much of each block is in flight at once.
//
// What the design does about it: one block of 128 threads per (b, p) (512
// blocks at the serving batch, all resident at once).  A group of G threads
// owns a row (G a power of two up to 32, each thread E loads of W bytes of
// the row), and every thread issues all its loads for a batch of rows
// before any arithmetic waits on them: 8 loads of 16 bytes a thread, the
// whole 16 KB block at L = D = 128, issued before qc is even formed.  The
// thread's slice of qc stays in registers for every row it owns; bytes
// become floats exactly by a byte permute and one subtraction (as in K1);
// the group reduces in log2(G) xor shuffles.  The batch's L norms reach
// shared memory by cp.async beside the codes, the distances are staged in
// shared memory and leave as 16-byte stores (a masked probe writes its
// +inf row the same way), and the next batch's loads are issued before
// this batch's stores.
//
// Two variants, chosen by the wrapper from (D, the base's alignment) with
// ivf_scan_q8_variant: "vec16" loads 16 bytes (D % 16 == 0 and q8 16-byte
// aligned), "vec4" loads 4 bytes (any D % 4 == 0, q8 4-byte aligned).  Both
// take any L and D up to 1024: a batch is at most 1024 rows, and a thread
// takes E = 2 (vec16) or up to 8 (vec4) loads of a row when D is wide.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWords = 32;          // 32-bit words of codes a thread holds
constexpr int kMaxBatch = 1024;     // rows a batch
constexpr unsigned kFull = 0xffffffffu;

using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

// Signed byte k of w as a float, exactly: 0x4B000000 | (byte ^ 0x80) is
// 2^23 + byte + 128 as a float.
template <int K>
__device__ __forceinline__ float s8f(unsigned w) {
  return __int_as_float((int)__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                         0x7540u | K)) - 8388736.0f;
}

// W bytes of codes: a load that is issued where it stands (volatile, so
// the compiler does not sink it to its first use, past the qc barrier) and
// bypasses L1, and its 32-bit words.
template <int W>
struct Load;
template <>
struct Load<16> {
  using T = uint4;
  __device__ static T issue(const T* p) {
    T v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  }
  __device__ static void words(const T& v, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <>
struct Load<4> {
  using T = unsigned;
  __device__ static T issue(const T* p) {
    T v;
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p));
    return v;
  }
  __device__ static void words(const T& v, unsigned* w) { w[0] = v; }
};

__host__ __device__ inline int pow2_at_least(int n) {
  int g = 1;
  while (g < n) g <<= 1;
  return g;
}

// threads a row: units of W bytes a row, rounded up to a power of two,
// at most a warp
__host__ inline int group_threads(int units) {
  const int g = pow2_at_least(units);
  return g < 32 ? g : 32;
}

// At most 80 registers for the 16-byte variant (six blocks an SM: more rows
// in flight when a batch is several waves) and 128 for the 4-byte ones.
template <int W, int E>
__global__ void __launch_bounds__(kThreads, W == 16 ? 6 : 4)
q8_legacy_kernel(const signed char* __restrict__ q8,
                 const float* __restrict__ scale,
                 const float* __restrict__ norm2,
                 const float* __restrict__ cents,
                 const int* __restrict__ cids,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ queries, float* __restrict__ out,
                 int C, int P, int L, int D, int G, int UR) {
  using T = typename Load<W>::T;
  constexpr int NW = W / 4;                  // words a load
  constexpr int NL = kWords / NW;            // loads a thread a batch
  constexpr int U = NL / E;                  // rows a thread a batch
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kThreads / 32];
  const int R = kThreads / G;                // rows a pass of the block
  const int NB = UR * R;                     // rows a batch
  float* sqc = sm;                           // [D]
  float* sres = sm + D;                      // [NB]
  float* sn2 = sres + NB;                    // [2][NB]
  const int bp = blockIdx.x;
  const int b = bp / P;
  const int tid = threadIdx.x;
  float* o = out + (size_t)bp * L;
  const int cid = cids[bp];                  // in flight with the mask
  if (mask[bp] == 0) {                       // uniform in the block
    repro::block_store_run(o, L, [](int) { return CUDART_INF_F; });
    return;
  }
  const int c = min(max(cid, 0), C - 1);
  const int units = D / W;
  const int r = tid / G, g = tid - r * G;
  const T* blk = reinterpret_cast<const T*>(q8 + (size_t)c * L * D);
  const float* n2 = norm2 + (size_t)c * L;

  T v[NL];
  auto load = [&](int base) {
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      const int k = s / E, e = s - (s / E) * E;
      const int l = base + k * R + r, u = g + e * G;
      if (k < UR && l < L && u < units)
        v[s] = Load<W>::issue(blk + (size_t)l * units + u);
      else
        v[s] = T{};
    }
  };
  auto issue_n2 = [&](int base, int buf) {
    const int n = min(NB, L - base);
    for (int j = tid; j < n; j += kThreads)
      cp_async4(sn2 + buf * NB + j, n2 + base + j);
    cp_async_commit();                       // empty groups keep the count
  };
  load(0);
  issue_n2(0, 0);

  // qc and ||qc||^2 while the first batch is in flight
  float part = 0.0f;
  for (int d = tid; d < D; d += kThreads) {
    const float x = queries[(size_t)b * D + d] - cents[(size_t)c * D + d];
    sqc[d] = x;
    part = fmaf(x, x, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  float qc2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) qc2 += red[w];
  const float s2 = 2.0f * scale[c];
  float qr[E * W];                           // this thread's slice of qc
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int u = g + e * G;
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 x = u < units
          ? *reinterpret_cast<const float4*>(sqc + u * W + i)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      qr[e * W + i] = x.x;
      qr[e * W + i + 1] = x.y;
      qr[e * W + i + 2] = x.z;
      qr[e * W + i + 3] = x.w;
    }
  }

  for (int base = 0, it = 0; base < L; base += NB, ++it) {
    float acc[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      float a = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        unsigned w[NW];
        Load<W>::words(v[k * E + e], w);
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const float* x = qr + e * W + 4 * i;
          a = fmaf(x[0], s8f<0>(w[i]), a);
          a = fmaf(x[1], s8f<1>(w[i]), a);
          a = fmaf(x[2], s8f<2>(w[i]), a);
          a = fmaf(x[3], s8f<3>(w[i]), a);
        }
      }
      acc[k] = a;
    }
    const int next = base + NB;
    if (next < L) load(next);                // in flight during the stores
    issue_n2(next < L ? next : L, (it + 1) & 1);
#pragma unroll
    for (int k = 0; k < U; ++k)
      for (int off = 1; off < G; off <<= 1)
        acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int j = k * R + r;
        if (k < UR && base + j < L) sres[j] = acc[k];
      }
    }
    cp_async_wait<1>();                      // this batch's norms landed
    __syncthreads();
    const float* bn2 = sn2 + (it & 1) * NB;
    repro::block_store_run(o + base, min(NB, L - base), [&](int j) {
      const float d = qc2 - s2 * sres[j] + bn2[j];
      return d < 0.0f ? 0.0f : d;            // keeps NaN, as jnp.maximum
    });
    __syncthreads();                         // sres and this buffer reused
  }
  cp_async_wait<0>();
}

template <int W, int E>
int launch(const void* q8, const void* scale, const void* norm2,
           const void* cents, const void* cids, const void* mask,
           const void* queries, void* out, int B, int C, int P, int L, int D,
           int G, cudaStream_t stream) {
  constexpr int U = kWords / (W / 4) / E;
  const int R = kThreads / G;
  int ur = kMaxBatch / R;
  ur = ur < U ? ur : U;
  const size_t smem = ((size_t)D + 3 * (size_t)ur * R) * 4;
  q8_legacy_kernel<W, E><<<B * P, kThreads, smem, stream>>>(
      (const signed char*)q8, (const float*)scale, (const float*)norm2,
      (const float*)cents, (const int*)cids, (const unsigned char*)mask,
      (const float*)queries, (float*)out, C, P, L, D, G, ur);
  return (int)cudaGetLastError();
}

}  // namespace

// vec16: 1 (16-byte loads, needs D % 16 == 0 and a 16-byte aligned q8),
// 0 (4-byte loads, D % 4 == 0).  D <= 1024.
extern "C" int ivf_scan_q8_legacy_launch(const void* q8, const void* scale,
                                         const void* norm2, const void* cents,
                                         const void* cids, const void* mask,
                                         const void* queries, void* out,
                                         int B, int C, int P, int L, int D,
                                         int vec16, void* stream) {
  const int w = vec16 ? 16 : 4;
  if (D % w != 0 || D > 1024 || ((uintptr_t)q8 % w) != 0)
    return (int)cudaErrorInvalidValue;
  const int units = D / w;
  const int g = group_threads(units);
  const int e = pow2_at_least((units + g - 1) / g);
  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto fn) {
    return fn(q8, scale, norm2, cents, cids, mask, queries, out, B, C, P, L,
              D, g, s);
  };
  if (vec16) return e == 1 ? args(&launch<16, 1>) : args(&launch<16, 2>);
  switch (e) {
    case 1: return args(&launch<4, 1>);
    case 2: return args(&launch<4, 2>);
    case 4: return args(&launch<4, 4>);
    default: return args(&launch<4, 8>);
  }
}
