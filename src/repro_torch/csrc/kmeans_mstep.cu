// K3: fused Lloyd M-step (centroid division + empty-cluster reseed).
//
// Replaces the Pallas kernel `kmeans_mstep` (body `_kernel`) of
// src/repro/kernels/kmeans_mstep.py:
//
//   new[k] = sums[k] / max(counts[k], 1)     counts[k] > 0
//          = reseed[rank(k)]                 counts[k] <= 0
//
// where rank(k) is the number of empty clusters before k, and counts are
// taken as f32 (an int32 count is rounded to nearest, as Tensor.to(f32)).
//
// What bounds it on an H100: one read of sums (and of one reseed row per
// empty cluster), one write of the (K, D) output, no arithmetic to speak
// of: bytes.  At the splitter's shapes (K <= 8, 4 KB) nothing but launch
// latency and one DRAM round trip remain.
//
// What the design does about it: the TPU kernel computed the rank with a
// (K, K) triangular matmul and gathered reseed rows with a one-hot matmul,
// because the MXU was the cheap unit there.  Here it is ONE launch with no
// scratch: each block takes a contiguous run of rows, counts the empty
// clusters before its first row itself (warp ballots and __popc over the
// flags, many loads in flight a thread), ranks its own rows the same way,
// then writes means or reseed rows.  The first batch of sums loads is
// issued before any flag is read (sums never depend on a flag), so a
// one-block launch costs one round trip.  Rows move as 16-byte words when
// D % 4 == 0 and every pointer is 16-byte aligned (the host picks, see
// kernels/kmeans_mstep.py `kmeans_mstep_variant`), else as 4-byte words;
// a thread's column is fixed and its row steps by a constant, so there is
// no per-element division.  The division is IEEE fp32 (__fdiv_rn),
// bit-equal to the plain version.  The host sizes the grid so that the
// flag reads of all blocks stay under the output's bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // row words a thread has in flight
constexpr int kFlagUnroll = 8;     // flags a thread has in flight

__device__ __forceinline__ float count_f32(int c) { return __int2float_rn(c); }
__device__ __forceinline__ float count_f32(float c) { return c; }

template <bool V16>
struct Word;
template <>
struct Word<true> {
  using T = float4;
  static constexpr int kWidth = 4;
  __device__ static T div(T s, float c) {
    return make_float4(__fdiv_rn(s.x, c), __fdiv_rn(s.y, c),
                       __fdiv_rn(s.z, c), __fdiv_rn(s.w, c));
  }
  __device__ static T nan() {
    return make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                       CUDART_NAN_F);
  }
};
template <>
struct Word<false> {
  using T = float;
  static constexpr int kWidth = 1;
  __device__ static T div(T s, float c) { return __fdiv_rn(s, c); }
  __device__ static T nan() { return CUDART_NAN_F; }
};

// Rows [row0, row0 + rows) of K; each row is DU words of W.  The thread's
// words are (r, c) = (t / DU, t % DU) stepped by kThreads words at a time,
// i.e. by (kThreads / DU rows, kThreads % DU words) with a carry.
template <typename C, bool V16>
__global__ void __launch_bounds__(kThreads)
mstep_kernel(const float* __restrict__ sums, const C* __restrict__ counts,
             const float* __restrict__ reseed, float* __restrict__ out,
             int K, int Kr, int D, int rows_per_block) {
  using W = Word<V16>;
  using T = typename W::T;
  const T* S = reinterpret_cast<const T*>(sums);
  const T* R = reinterpret_cast<const T*>(reseed);
  T* O = reinterpret_cast<T*>(out);
  const int DU = D / W::kWidth;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(K, row0 + rows_per_block);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int step_r = kThreads / DU, step_c = kThreads % DU;
  const int t_r = t / DU, t_c = t % DU;

  __shared__ int s_warp[kWarps];
  __shared__ int s_rank[kThreads];     // the tile row's rank, -1 if not empty
  __shared__ float s_den[kThreads];    // max(count, 1), NaN kept

  // 1. the first batch of sums words, before any flag is read
  T pre[kUnroll];
  {
    const int nr = min(row1 - row0, kThreads);
    int r = t_r, c = t_c;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (r < nr) pre[j] = S[(size_t)(row0 + r) * DU + c];
      r += step_r;
      c += step_c;
      if (c >= DU) { c -= DU; ++r; }
    }
  }

  // 2. the empty clusters before row0: ballots over many flags in flight
  int before = 0;
  for (int base = 0; base < row0; base += kThreads * kFlagUnroll) {
    bool f[kFlagUnroll];
#pragma unroll
    for (int j = 0; j < kFlagUnroll; ++j) {
      const int i = base + j * kThreads + t;
      f[j] = i < row0 && count_f32(counts[i]) <= 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kFlagUnroll; ++j)
      before += __popc(__ballot_sync(0xffffffffu, f[j]));
  }
  if (lane == 0) s_warp[warp] = before;
  __syncthreads();
  before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += s_warp[w];

  // 3. the block's rows, a tile of kThreads rows at a time
  bool first = true;
  for (int tile0 = row0; tile0 < row1; tile0 += kThreads) {
    const int nr = min(row1 - tile0, kThreads);
    float cnt = 0.0f;
    bool empty = false;
    if (t < nr) {
      cnt = count_f32(counts[tile0 + t]);
      empty = cnt <= 0.0f;
    }
    const unsigned m = __ballot_sync(0xffffffffu, empty);
    __syncthreads();                   // s_warp's last readers are done
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int in_tile = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_warp[w];
      total += v;
      in_tile += w < warp ? v : 0;
    }
    s_rank[t] = empty ? before + in_tile + __popc(m & ((1u << lane) - 1u))
                      : -1;
    s_den[t] = cnt < 1.0f ? 1.0f : cnt;   // jnp.maximum: a NaN count stays
    __syncthreads();

    int r = t_r, c = t_c;
    while (r < nr) {
      T v[kUnroll];
      int rr[kUnroll], cc[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        rr[j] = r;
        cc[j] = c;
        if (!first && r < nr) v[j] = S[(size_t)(tile0 + r) * DU + c];
        r += step_r;
        c += step_c;
        if (c >= DU) { c -= DU; ++r; }
      }
      if (first) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) v[j] = pre[j];
        first = false;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (rr[j] >= nr) continue;
        const int rank = s_rank[rr[j]];
        T o;
        if (rank < 0)
          o = W::div(v[j], s_den[rr[j]]);
        else if (rank < Kr)
          o = R[(size_t)rank * DU + cc[j]];
        else
          o = W::nan();                // fewer reseed rows than empties
        O[(size_t)(tile0 + rr[j]) * DU + cc[j]] = o;
      }
    }
    first = false;
    before += total;
  }
}

template <typename C>
int launch_typed(const void* sums, const void* counts, const void* reseed,
                 void* out, int K, int Kr, int D, int rows_per_block,
                 int vec16, cudaStream_t st) {
  const int blocks = (K + rows_per_block - 1) / rows_per_block;
  if (vec16)
    mstep_kernel<C, true><<<blocks, kThreads, 0, st>>>(
        (const float*)sums, (const C*)counts, (const float*)reseed,
        (float*)out, K, Kr, D, rows_per_block);
  else
    mstep_kernel<C, false><<<blocks, kThreads, 0, st>>>(
        (const float*)sums, (const C*)counts, (const float*)reseed,
        (float*)out, K, Kr, D, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// counts_int: 1 for int32 counts, 0 for f32; vec16: 1 for 16-byte words
// (D % 4 == 0, every pointer 16-byte aligned), 0 for 4-byte words.
extern "C" int kmeans_mstep_launch(const void* sums, const void* counts,
                                   const void* reseed, void* out, int K,
                                   int Kr, int D, int rows_per_block,
                                   int counts_int, int vec16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || D < 1 || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  if (vec16 && D % 4 != 0) return (int)cudaErrorInvalidValue;
  return counts_int ? launch_typed<int>(sums, counts, reseed, out, K, Kr, D,
                                        rows_per_block, vec16, st)
                    : launch_typed<float>(sums, counts, reseed, out, K, Kr, D,
                                          rows_per_block, vec16, st);
}
