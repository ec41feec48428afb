// B5: pairwise squared L2 distance tile.
//
// Replaces the Pallas kernel `pairwise_l2` (body `_kernel`) of
// src/repro/kernels/pairwise_l2.py.  For a (N, D) and b (M, D), f32:
//
//   out[i, j] = clamp0(||a_i||^2 - 2 a_i . b_j + ||b_j||^2)     (N, M) f32,
//
// clamp0(d) = `d < 0 ? 0 : d`, which keeps a NaN as jnp.maximum(d, 0.0) does.
//
// It is the distance tile of the unfused k-means E-step
// (kernels/ops.kmeans_assign), whose argmin and min run outside the kernel.
//
// What bounds it on an H100: the product is 2 * N * M * D FLOPs in fp32 on
// CUDA cores (67 TFLOP/s); at the build's chunk (16,384 points against
// ~20,600 centroids, D = 128) that is 86 GFLOP, 1.3 ms, while writing the
// 1.35 GB output takes 0.4 ms at 3.35 TB/s.  Bound by operations, with the
// output write a large second term.  The unfused build, though, launches it
// thousands of times at a few hundred points against 2 to 8 centroids,
// where the bound is nanoseconds and launches and allocations are the cost.
//
// The arithmetic is K2's E-step (kmeans_assign.cu) bit for bit, in both
// variants below: row norms one warp per row (lane-strided fmaf from 0,
// then an xor tree), each dot one fmaf chain over d in increasing order
// from 0 (zero padding adds exact zeros), and repro::kmeans_dist.  So the
// argmin and min of this kernel's output are K2's assign and min_dist, and
// the unfused build hashes as before.  No split over D, no TF32.
//
// What the design does about it, by shape (the wrapper chooses):
//
//  * narrow (small M): one launch and no scratch.  A block stages all of b
//    and up to R rows of a in shared memory by cp.async (row stride an odd
//    number of float4, so a quarter-warp's float4 reads of 8 rows hit
//    distinct banks), computes every staged row's norm there, one warp a
//    row, then gives each thread (row, centroid) pairs, two at a time, each
//    a sequential fmaf chain over float4s of shared memory.  Consecutive
//    threads hold consecutive outputs, so the stores coalesce.
//  * wide: K2's product with the argmin replaced by stores.  A prep launch
//    computes both inputs' row norms and b transposed into a zero-padded
//    (Dp, Mp) scratch.  The product gives each block 128 rows of a,
//    resident in shared memory d-major, and a run of 128-column tiles of b
//    streamed with their norms through a 2-stage ring of 16-byte cp.async
//    copies; 256 threads each hold an 8 x 8 register tile (four float4
//    shared reads per column of D: 64 FMAs per 4 loads), two blocks an SM.
//    When a tile's dots are complete, each thread writes its 8 rows x 2 runs
//    of 4 columns with 16-byte streaming stores, which drain while the next
//    tile's FMAs run.  So that every row is 16-byte aligned, the output's rows are M
//    rounded up to 4 floats apart, and the wrapper returns the (N, M) view
//    of it (scalar stores into rows of M % 4 != 0 floats cost the product
//    about 10% at the build's shapes).  The column tiles are split over
//    enough blocks to give the card two blocks an SM at the build's chunk.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;

// ---------------------------------------------------------------- narrow
constexpr int kNarrowThreads = 256;
constexpr int kNarrowSmem = 48 * 1024;   // static limit: no attribute call
constexpr int kNarrowPairs = 512;        // (row, centroid) pairs a block

// row stride of the staged rows in float4: ceil(D / 4), made odd
__host__ __device__ inline int narrow_ld4(int D) { return ((D + 3) / 4) | 1; }

// rows of a a block stages beside all of b (0: b does not fit); the
// wrapper's pairwise_l2.narrow_rows is the same formula
__host__ inline int narrow_rows(int M, int D) {
  const int fit = kNarrowSmem / (narrow_ld4(D) * 16 + 4) - M;
  const int want = (kNarrowPairs + M - 1) / M;
  return fit < 1 ? 0 : (fit < want ? fit : want);
}

__global__ void __launch_bounds__(kNarrowThreads)
pw_narrow_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int N, int M, int D, int R,
                 bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ld4 = narrow_ld4(D);
  const int ld = 4 * ld4;
  const int dp4 = (D + 3) / 4;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, N - r0);
  const int staged = M + rows;       // row t: b's row t, then a's r0 + t - M
  float* an = smem + (size_t)(M + R) * ld;   // [M] b's norms, then [R] a's
  auto src = [&](int t) {
    return t < M ? b + (size_t)t * D : a + (size_t)(r0 + t - M) * D;
  };
  if (vec) {                         // D % 4 == 0, a and b 16-byte aligned
    for (int e = tid; e < staged * dp4; e += kNarrowThreads) {
      const int t = e / dp4, k = e - t * dp4;
      cp_async16(smem + t * ld + 4 * k, src(t) + 4 * k);
    }
  } else {
    for (int e = tid; e < staged * D; e += kNarrowThreads) {
      const int t = e / D, k = e - t * D;
      cp_async4(smem + t * ld + k, src(t) + k);
    }
    const int pad = 4 * dp4 - D;     // columns the float4 reads also see
    for (int e = tid; e < staged * pad; e += kNarrowThreads) {
      const int t = e / pad;
      smem[t * ld + D + (e - t * pad)] = 0.0f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // row norms, one warp a staged row, as K2's row_norms_kernel; a warp
  // takes four rows at a time so that their chains interleave
  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = 4 * warp; t0 < staged; t0 += 4 * (kNarrowThreads / 32)) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = lane; d < D; d += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = smem[min(t0 + i, staged - 1) * ld + d];
        s[i] = fmaf(v, v, s[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += __shfl_xor_sync(kFull, s[i], off);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t0 + i < staged) an[t0 + i] = s[i];
    }
  }
  __syncthreads();

  // (row, centroid) pairs p and p + kNarrowThreads side by side, so that a
  // thread's two fmaf chains interleave
  const float4* bs4 = reinterpret_cast<const float4*>(smem);
  const float4* as4 = bs4 + (size_t)M * ld4;
  float* orow = out + (size_t)r0 * M;
  const int pairs = rows * M;
  for (int p = tid; p < pairs; p += 2 * kNarrowThreads) {
    const int q = min(p + kNarrowThreads, pairs - 1);
    const int r = p / M, j = p - r * M;
    const int r2 = q / M, j2 = q - r2 * M;
    const float4 *xr = as4 + r * ld4, *yr = bs4 + j * ld4;
    const float4 *xr2 = as4 + r2 * ld4, *yr2 = bs4 + j2 * ld4;
    float acc = 0.0f, acc2 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < dp4; ++k) {
      const float4 x = xr[k], y = yr[k], x2 = xr2[k], y2 = yr2[k];
      acc = fmaf(x.x, y.x, acc);
      acc2 = fmaf(x2.x, y2.x, acc2);
      acc = fmaf(x.y, y.y, acc);
      acc2 = fmaf(x2.y, y2.y, acc2);
      acc = fmaf(x.z, y.z, acc);
      acc2 = fmaf(x2.z, y2.z, acc2);
      acc = fmaf(x.w, y.w, acc);
      acc2 = fmaf(x2.w, y2.w, acc2);
    }
    __stcs(orow + p, repro::kmeans_dist(an[M + r], acc, an[j]));
    if (p + kNarrowThreads < pairs)
      __stcs(orow + q, repro::kmeans_dist(an[M + r2], acc2, an[j2]));
  }
}

// ------------------------------------------------------------------ wide
constexpr int BM = 128, BN = 128, BK = 32;  // block tile; D per ring stage
constexpr int DX = 128;                     // columns of a held at once
constexpr int STAGES = 2;
constexpr int XS_LD = BM + 4;               // xs[k][m] row stride
constexpr int CS_LD = BN + 4;               // cs[stage][k][n] row stride
constexpr int kWideThreads = 256;           // 16 x 16 threads, 8 x 8 each
constexpr int kPrepThreads = 256;
static_assert(DX % BK == 0, "an a chunk holds whole ring stages");

__host__ __device__ constexpr size_t wide_smem_bytes() {
  return ((size_t)DX * XS_LD + (size_t)STAGES * BK * CS_LD +
          (size_t)STAGES * BN + BM) * 4;
}

// Blocks [0, nb_a): a's squared row norms, one warp a row.  Blocks after:
// 32 rows of b each, transposed into bt[d, n] (zero outside (M, D)) through
// a 32 x 32 tile, with their norms: lane l of a row's warp meets d = l,
// l + 32, ... in that order, as a lane of K2's row_norms_kernel does (the
// padding adds exact zeros), then the same xor tree.
__global__ void __launch_bounds__(kPrepThreads)
pw_prep_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ a2, float* __restrict__ b2,
               float* __restrict__ bt, int N, int M, int D, int kp, int dp,
               int nb_a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < nb_a) {
    const int row = blockIdx.x * (kPrepThreads / 32) + warp;
    if (row >= N) return;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = a[(size_t)row * D + d];
      s = fmaf(v, v, s);
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) a2[row] = s;
    return;
  }
  __shared__ float tile[32][33];
  const int n0 = (blockIdx.x - nb_a) * 32;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};    // rows warp + 8 i
  for (int d0 = 0; d0 < dp; d0 += 32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i, n = n0 + r, d = d0 + lane;
      const float v = (n < M && d < D) ? b[(size_t)n * D + d] : 0.0f;
      tile[r][lane] = v;
      s[i] = fmaf(v, v, s[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      bt[(size_t)(d0 + r) * kp + n0 + lane] = tile[lane][r];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = s[i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) b2[n0 + warp + 8 * i] = v;
  }
}

// Block (bx, by): rows bx * 128.. of a against column tiles
// [by * per, (by + 1) * per) of bt; as K2's assign_kernel up to a tile's
// last ring stage, where it stores the clamped distances into out, whose
// rows are ldo floats apart (ldo = M rounded up to 4: every row 16-byte
// aligned; columns M..ldo - 1 take whatever the last quad holds).
__global__ void __launch_bounds__(kWideThreads, 2)
pw_wide_kernel(const float* __restrict__ x, const float* __restrict__ ct,
               const float* __restrict__ x2, const float* __restrict__ c2,
               float* __restrict__ out, int N, int M, int D, int kp,
               int ldo, int per) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [DX][XS_LD]
  float* cs = xs + DX * XS_LD;               // [STAGES][BK][CS_LD]
  float* c2s = cs + STAGES * BK * CS_LD;     // [STAGES][BN], by tile
  float* xns = c2s + STAGES * BN;            // [BM]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int nt0 = blockIdx.y * per;
  const int ntiles = min(per, kp / BN - nt0);
  const int ks_n = (D + BK - 1) / BK;        // ring stages per column tile
  const int total = ntiles * ks_n;
  const bool resident = D <= DX;

  // stage `step`: columns of tile nt0 + step / ks_n, d rows k0..k0+BK of
  // ct, and with a tile's first stage its norms (ring slot: the block's
  // tile count % STAGES, free once that tile's last stage was used)
  auto issue = [&](int step) {
    if (step < total) {
      const int lt = step / ks_n;
      const int n0 = (nt0 + lt) * BN;
      const int k0 = (step - lt * ks_n) * BK;
      float* dst = cs + (step % STAGES) * BK * CS_LD;
      for (int e = tid; e < BK * BN / 4; e += kWideThreads) {
        const int k = e / (BN / 4), n4 = e - k * (BN / 4);
        cp_async16(dst + k * CS_LD + 4 * n4,
                   ct + (size_t)(k0 + k) * kp + n0 + 4 * n4);
      }
      if (k0 == 0 && tid < BN / 4)
        cp_async16(c2s + (lt % STAGES) * BN + 4 * tid, c2 + n0 + 4 * tid);
    }
    cp_async_commit();                       // empty groups keep the count
  };
  // a's columns dx0.. of the block's rows into xs, transposed, zero-padded
  auto load_x = [&](int dx0) {
    for (int e = tid; e < BM * DX; e += kWideThreads) {
      const int m = e / DX, k = e - (e / DX) * DX;
      const int gm = m0 + m, gk = dx0 + k;
      xs[k * XS_LD + m] = (gm < N && gk < D) ? x[(size_t)gm * D + gk] : 0.0f;
    }
  };

  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  if (resident) load_x(0);
  if (tid < BM) xns[tid] = m0 + tid < N ? x2[m0 + tid] : 0.0f;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // stage `step` landed; stage step - 1 is free
    issue(step + STAGES - 1);
    const int lt = step / ks_n;
    const int n0 = (nt0 + lt) * BN;
    const int k0 = (step - lt * ks_n) * BK;
    if (!resident && k0 % DX == 0) {
      load_x(k0);
      __syncthreads();
    }
    const float* xk = xs + (k0 % DX) * XS_LD;
    const float* ck = cs + (step % STAGES) * BK * CS_LD;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* xr = xk + kk * XS_LD + ty * 4;
      const float* cr = ck + kk * CS_LD + tx * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(xr);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(cr);
      const float4 b1 = *reinterpret_cast<const float4*>(cr + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (k0 + BK >= D) {
      // the tile's dots are complete: store its distances
      const float* cn = c2s + (lt % STAGES) * BN;
      const float4 c0 = *reinterpret_cast<const float4*>(cn + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(cn + 64 + tx * 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float4 x0 = *reinterpret_cast<const float4*>(xns + ty * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(xns + 64 + ty * 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (gm < N) {
          float* orow = out + (size_t)gm * ldo;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gj = n0 + 64 * h + tx * 4;
            if (gj < M)                      // ldo covers the whole quad
              __stcs(reinterpret_cast<float4*>(orow + gj),
                     make_float4(
                         repro::kmeans_dist(xv[i], acc[i][4 * h], cv[4 * h]),
                         repro::kmeans_dist(xv[i], acc[i][4 * h + 1],
                                            cv[4 * h + 1]),
                         repro::kmeans_dist(xv[i], acc[i][4 * h + 2],
                                            cv[4 * h + 2]),
                         repro::kmeans_dist(xv[i], acc[i][4 * h + 3],
                                            cv[4 * h + 3])));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// out's rows are ldo floats apart.  variant 0: narrow, one launch, ldo = M,
// scratch unused (may be null).  variant 1: wide, ldo = M rounded up to 4,
// scratch holds bt (Dp * Mp floats), b's norms (Mp) and a's (N), with Mp =
// M rounded up to 128 and Dp = D rounded up to 32.
extern "C" int pairwise_l2_launch(const void* a, const void* b, void* scratch,
                                  void* out, int N, int M, int D, int ldo,
                                  int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    const int rmax = narrow_rows(M, D);
    if (rmax < 1 || ldo != M) return (int)cudaErrorInvalidValue;
    const int R = rmax < N ? rmax : N;
    const size_t smem = (size_t)(M + R) * (narrow_ld4(D) * 16 + 4);
    const bool vec = (D & 3) == 0 && (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
    pw_narrow_kernel<<<(N + R - 1) / R, kNarrowThreads, smem, st>>>(
        (const float*)a, (const float*)b, (float*)out, N, M, D, R, vec);
    return (int)cudaGetLastError();
  }
  if (variant != 1 || scratch == nullptr || ldo != round_up(M, 4) ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int kp = round_up(M, BN), dp = round_up(D, BK);
  float* bt = (float*)scratch;
  float* b2 = bt + (size_t)dp * kp;
  float* a2 = b2 + kp;
  // the product takes a's norms from its resident rows when D <= DX
  const int nb_a = (N + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  pw_prep_kernel<<<nb_a + kp / 32, kPrepThreads, 0, st>>>(
      (const float*)a, (const float*)b, a2, b2, bt, N, M, D, kp, dp, nb_a);
  REPRO_RETURN_IF_ERROR();
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  REPRO_RETURN_IF_ERROR();
  // split the column tiles so that the grid has about two blocks an SM
  const int row_tiles = (N + BM - 1) / BM, col_tiles = kp / BN;
  int groups = 2 * sms / row_tiles;
  groups = groups < 1 ? 1 : (groups > col_tiles ? col_tiles : groups);
  const int per = (col_tiles + groups - 1) / groups;
  cudaFuncSetAttribute(pw_wide_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)wide_smem_bytes());
  REPRO_RETURN_IF_ERROR();
  pw_wide_kernel<<<dim3(row_tiles, (col_tiles + per - 1) / per),
                   kWideThreads, wide_smem_bytes(), st>>>(
      (const float*)a, bt, a2, b2, (float*)out, N, M, D, kp, ldo, per);
  return (int)cudaGetLastError();
}
