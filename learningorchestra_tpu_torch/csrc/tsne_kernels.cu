// Exact t-SNE repulsion for Hopper (sm_90a), bound to Python with ctypes
// (learningorchestra_tpu_torch/ops/tsne_kernels.py builds and loads this
// file). The entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after each launch so a refused
// launch surfaces in the wrapper instead of silently not running.
//
// K4  tsne_repulsion   replaces learningorchestra_tpu/ops/pallas_kernels.py
//                      _repulsion_kernel (tsne_repulsion_rows and
//                      tsne_repulsion).
//     Computes, for the query rows i of Yq (global ids offset + i) against
//     every column j of Y, with q_ij = 1 / (1 + |y_i - y_j|^2) and pairs
//     masked where either side is invalid or i and j are the same global
//     row:  Z = sum_ij q_ij  and  F_i = sum_j q_ij^2 (y_i - y_j).
//     What bounds it: operations. Each pair costs 14 float operations (two
//     differences, the squared distance as two FMAs, the reciprocal, the
//     column mask, q^2, the Z sum and two force FMAs) on 16 bytes of column
//     data that every query row reuses, so a 60,416-row embedding is
//     3.65e9 pairs and 5.1e10 operations per call against 1 MB of
//     coordinates. The TPU kernel streamed (1, tile) column blocks past
//     resident (tile, 1) row blocks and carried the sums across its
//     sequential grid. Here the sums live in registers instead: each
//     thread owns kRowsPerThread query rows (their coordinates and three
//     running sums), a block stages tiles of (x, y, valid) columns in
//     shared memory where every thread reads the same column at once (a
//     broadcast), and each column read serves kRowsPerThread pairs. The
//     reciprocal is the approximate hardware one (__fdividef, about two
//     ulp). The distance and the force use the direct differences already
//     in registers: the TPU kernel's y_i * sum q^2 - sum q^2 y_j is the
//     same sum, but it cancels when |y_i| is large against the force, as
//     it is for the outer rows of a late embedding. Only
//     the one tile per block that can hold a row's own column pays for the
//     diagonal test (a block-uniform branch). Blocks run in parallel over
//     (row block, column chunk); each writes its F partial and its Z
//     partial, and a second kernel sums them in a fixed order, so Z and F
//     are the same from run to run. Column chunks depend on n only, so a
//     call over a row range at a multiple of kRowsPerBlock reproduces the
//     whole call's per-row sums bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
// Columns staged in shared memory per pass (8 KiB of float4), and the
// columns one block sweeps.
constexpr int kTile = 512;
constexpr int kColChunk = 8 * kTile;
constexpr int kFinishThreads = 256;

template <bool kDiagonal>
__device__ __forceinline__ void sweep_tile(
    const float4* __restrict__ cols, int width, int col0,
    const float (&xi)[kRowsPerThread], const float (&yi)[kRowsPerThread],
    const int (&rid)[kRowsPerThread], float (&fx)[kRowsPerThread],
    float (&fy)[kRowsPerThread], float (&z)[kRowsPerThread]) {
#pragma unroll 4
  for (int c = 0; c < width; ++c) {
    const float4 p = cols[c];  // x, y, valid
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const float dx = xi[k] - p.x;
      const float dy = yi[k] - p.y;
      float q = p.z * __fdividef(1.0f, fmaf(dx, dx, fmaf(dy, dy, 1.0f)));
      // The self pair adds nothing to F (dx = dy = 0), only to Z.
      if (kDiagonal && col0 + c == rid[k]) q = 0.0f;
      const float q2 = q * q;
      z[k] += q;
      fx[k] = fmaf(q2, dx, fx[k]);
      fy[k] = fmaf(q2, dy, fy[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) repulsion_partial_kernel(
    const float* __restrict__ yq, const float* __restrict__ vq,
    const float* __restrict__ y, const float* __restrict__ v, int nq, int n,
    int offset, float* __restrict__ fpart, float* __restrict__ zpart) {
  __shared__ float4 tile[kTile];
  __shared__ float zwarp[kThreads / 32];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int chunk = blockIdx.y;
  const int c_begin = chunk * kColChunk;
  const int c_end = min(n, c_begin + kColChunk);

  float xi[kRowsPerThread], yi[kRowsPerThread], vi[kRowsPerThread];
  int rid[kRowsPerThread];
  float fx[kRowsPerThread], fy[kRowsPerThread], z[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    // Strided rows: neighbouring threads load neighbouring rows.
    const int r = row0 + k * kThreads + threadIdx.x;
    const bool in = r < nq;
    const float2 p = in ? reinterpret_cast<const float2*>(yq)[r]
                        : make_float2(0.0f, 0.0f);
    xi[k] = p.x;
    yi[k] = p.y;
    vi[k] = in ? vq[r] : 0.0f;
    rid[k] = offset + r;
    fx[k] = fy[k] = z[k] = 0.0f;
  }
  // Global rows [g_lo, g_hi) of this block, for the diagonal test.
  const long long g_lo = (long long)offset + row0;
  const long long g_hi = g_lo + kRowsPerBlock;

  for (int t0 = c_begin; t0 < c_end; t0 += kTile) {
    const int width = min(kTile, c_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < width; c += kThreads) {
      const float2 p = reinterpret_cast<const float2*>(y)[t0 + c];
      tile[c] = make_float4(p.x, p.y, v[t0 + c], 0.0f);
    }
    __syncthreads();
    if (g_hi > t0 && g_lo < t0 + width) {
      sweep_tile<true>(tile, width, t0, xi, yi, rid, fx, fy, z);
    } else {
      sweep_tile<false>(tile, width, t0, xi, yi, rid, fx, fy, z);
    }
  }

  // Invalid query rows are masked here, once, instead of per pair.
  float zt = 0.0f;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + k * kThreads + threadIdx.x;
    if (r < nq) {
      float2 f;
      f.x = vi[k] * fx[k];
      f.y = vi[k] * fy[k];
      reinterpret_cast<float2*>(fpart)[(long long)chunk * nq + r] = f;
    }
    zt += vi[k] * z[k];
  }
  // Fixed-order block sum: a shuffle tree per warp, then warps in order.
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) zt += __shfl_xor_sync(0xffffffffu, zt, w);
  if ((threadIdx.x & 31) == 0) zwarp[threadIdx.x >> 5] = zt;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) b += zwarp[w];
    zpart[(long long)chunk * gridDim.x + blockIdx.x] = b;
  }
}

// F = sum over column chunks of the F partials (chunk order); the last
// block sums the Z partials in a fixed tree.
__global__ void __launch_bounds__(kFinishThreads) repulsion_finish_kernel(
    const float* __restrict__ fpart, const float* __restrict__ zpart,
    int nq, int n_chunks, int n_zpart, float* __restrict__ F,
    float* __restrict__ Z) {
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float red[kFinishThreads];
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n_zpart; i += kFinishThreads)
      acc += zpart[i];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = kFinishThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) *Z = red[0];
    return;
  }
  const long long total = 2LL * nq;
  const long long i = (long long)blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) acc += fpart[(long long)c * total + i];
  F[i] = acc;
}

}  // namespace

extern "C" {

// Row blocks and column chunks of a call, for the wrapper's scratch.
int lo_tsne_rows_per_block() { return kRowsPerBlock; }
int lo_tsne_cols_per_chunk() { return kColChunk; }

// K4: Yq (nq, 2), validq (nq,), Y (n, 2), valid (n,) f32; global id of
// query row i is offset + i -> F (nq, 2) f32, Z (1,) f32.
// fpart: (ceil(n / kColChunk), nq, 2) f32 scratch; zpart:
// (ceil(n / kColChunk) * ceil(nq / kRowsPerBlock),) f32 scratch.
int lo_tsne_repulsion(const void* yq, const void* vq, const void* y,
                      const void* v, int nq, int n, int offset, void* fpart,
                      void* zpart, void* F, void* Z, void* stream) {
  const int row_blocks = (nq + kRowsPerBlock - 1) / kRowsPerBlock;
  const int n_chunks = (n + kColChunk - 1) / kColChunk;
  cudaStream_t st = (cudaStream_t)stream;
  repulsion_partial_kernel<<<dim3(row_blocks, n_chunks), kThreads, 0, st>>>(
      (const float*)yq, (const float*)vq, (const float*)y, (const float*)v,
      nq, n, offset, (float*)fpart, (float*)zpart);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const long long total = 2LL * nq;
  const int f_blocks = (int)((total + kFinishThreads - 1) / kFinishThreads);
  repulsion_finish_kernel<<<f_blocks + 1, kFinishThreads, 0, st>>>(
      (const float*)fpart, (const float*)zpart, nq, n_chunks,
      row_blocks * n_chunks, (float*)F, (float*)Z);
  return (int)cudaGetLastError();
}

}  // extern "C"
