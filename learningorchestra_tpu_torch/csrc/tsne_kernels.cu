// Exact t-SNE repulsion for Hopper (sm_90a), bound to Python with ctypes
// (learningorchestra_tpu_torch/ops/tsne_kernels.py builds and loads this
// file). Each entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after each launch so a refused
// launch surfaces in the wrapper instead of silently not running.
//
// K4  tsne_repulsion   replaces learningorchestra_tpu/ops/pallas_kernels.py
//                      _repulsion_kernel (tsne_repulsion_rows and
//                      tsne_repulsion).
//     With q_ij = 1 / (1 + |y_i - y_j|^2), pairs masked where either side
//     is invalid or i and j are the same global row:
//       Z = sum_ij q_ij  and  F_i = sum_j q_ij^2 (y_i - y_j).
//
//   Whole embedding (lo_tsne_repulsion_sym; tsne_repulsion, the call each
//   descent step makes). q_ij = q_ji and the force of j on i is minus the
//   force of i on j, so each unordered pair is evaluated once and credited
//   to both sides: F_i += q^2 d, F_j -= q^2 d, Z += 2q. Per unordered pair
//   that is 17 float operations counting an FMA as two (two differences,
//   the squared distance as two FMAs, the reciprocal, q^2, the Z add and
//   four force FMAs): 3.1e10 for a 60,416-row embedding, and half the
//   reciprocals of the ordered-pair form. What bounds it: operations,
//   specifically instruction throughput (about 11 instructions per
//   unordered pair: 10 on the FP32 pipe and one special-function
//   reciprocal, whose unit runs 16 lanes a clock an SM against the FP32
//   pipe's 128 and, with the pairs halved, no longer sets the pace).
//   Design:
//   - Square tiles of kSymTile = 1024 rows; one block per tile pair
//     (I, J >= I), numbered over the upper triangle so no block idles.
//     Each of the 4 warps owns 256 rows of tile I, 8 per lane in registers
//     with their (fx, fy, z) sums; tile J's coordinates sit in shared
//     memory.
//   - Column sums without a reduction tree: a warp takes tile J 32
//     columns at a time, lane l on column (l + s) mod 32 at step s, and
//     passes the two column accumulators one lane down after each step
//     (a ring). After 32 steps every column's accumulator has visited all
//     32 lanes once, in a fixed order, and lane l holds column l. That is
//     two shuffles and one shared load per 8 pairs; the four warps' column
//     sums are added in warp order through shared memory.
//   - No mask on all-valid tiles: whether both tiles hold only valid rows
//     is block-uniform (__syncthreads_and), and only tile pairs touching
//     an invalid row (the padded tail, a ragged last tile, or invalid rows
//     anywhere) multiply q by the two valid flags. Invalid rows may sit at
//     any coordinates (the descent parks them at 0, among valid rows).
//   - A diagonal tile (I == J) evaluates its ordered pairs in the direct
//     form below (rows only, the self pair masked by index), so no pair is
//     credited twice; it is 1/59 of the blocks at 60,416 rows.
//   - Fixed-order sums: block (I, J) writes its row sums to slot (I, J)
//     and its column sums to slot (J, I) of an (nt, nt, kSymTile) scratch
//     the wrapper allocates (28.5 MB at 60,416 rows, written and read once:
//     about 2% of the call), and its Z to its own slot. A second kernel
//     adds each row's nt slots and the Z slots in a fixed order, so Z and
//     F are the same on every run.
//   - The reciprocal is rcp.approx.ftz.f32 (one MUFU instruction, about one
//     ulp; the squared distance is >= 1, so flushing denormals changes
//     nothing). Forces use the differences already in registers: the TPU
//     kernel's y_i * sum q^2 - sum q^2 y_j is the same sum, but it cancels
//     when |y_i| is large against the force, as for the outer rows of a
//     late embedding.
//
//   Row range (lo_tsne_repulsion; tsne_repulsion_rows: query rows Yq with
//   global ids offset + i against every column of Y, for the row-sharded
//   mesh embed). The direct form: each query row's sum over all columns,
//   14 float operations per ordered pair. Each thread owns kRowsPerThread
//   query rows and their sums in registers, a block stages tiles of
//   (x, y, valid) columns in shared memory where every thread reads the
//   same column at once (a broadcast), and only the one tile per block
//   that can hold a row's own column pays for the diagonal test. Blocks
//   run over (row block, column chunk) and a second kernel sums their F
//   and Z partials in a fixed order. Its sums are grouped differently
//   from the whole-embedding kernel's, so a row range agrees with the
//   whole call to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------------------
// Whole embedding: each unordered pair once.
// ---------------------------------------------------------------------------

constexpr int kSymWarps = 4;
constexpr int kSymThreads = 32 * kSymWarps;
constexpr int kSymRows = 8;  // rows per lane
constexpr int kSymWarpRows = 32 * kSymRows;
constexpr int kSymTile = kSymWarps * kSymWarpRows;
constexpr int kFinishThreads = 256;

struct SymRows {
  float x[kSymRows], y[kSymRows], v[kSymRows];
  float fx[kSymRows], fy[kSymRows], z[kSymRows];
};

// Tile pair I < J: rows of I against columns of J, both sides credited.
template <bool kMasked>
__device__ __forceinline__ void sym_offdiag(SymRows& r,
                                            const float2* __restrict__ cxy,
                                            const float* __restrict__ cv,
                                            float2* __restrict__ cacc,
                                            int lane) {
  const int next = (lane + 1) & 31;
  for (int ch = 0; ch < kSymTile; ch += 32) {
    float cfx = 0.0f, cfy = 0.0f;
#pragma unroll 8
    for (int s = 0; s < 32; ++s) {
      const int c = ch + ((lane + s) & 31);
      const float2 p = cxy[c];
      const float vc = kMasked ? cv[c] : 1.0f;
#pragma unroll
      for (int k = 0; k < kSymRows; ++k) {
        const float dx = r.x[k] - p.x;
        const float dy = r.y[k] - p.y;
        float q = rcp_approx(fmaf(dx, dx, fmaf(dy, dy, 1.0f)));
        if (kMasked) q *= r.v[k] * vc;
        const float q2 = q * q;
        r.z[k] += q;
        r.fx[k] = fmaf(q2, dx, r.fx[k]);
        r.fy[k] = fmaf(q2, dy, r.fy[k]);
        cfx = fmaf(-q2, dx, cfx);
        cfy = fmaf(-q2, dy, cfy);
      }
      // Hand the column accumulators to the lane that takes their column
      // next step.
      cfx = __shfl_sync(0xffffffffu, cfx, next);
      cfy = __shfl_sync(0xffffffffu, cfy, next);
    }
    cacc[ch + lane] = make_float2(cfx, cfy);  // lane l holds column l
  }
}

// Diagonal tile: every ordered pair, rows only, the self pair masked.
__device__ __forceinline__ void sym_diag(SymRows& r,
                                         const float2* __restrict__ cxy,
                                         const float* __restrict__ cv,
                                         int row0) {
#pragma unroll 4
  for (int c = 0; c < kSymTile; ++c) {
    const float2 p = cxy[c];
    const float vc = cv[c];
#pragma unroll
    for (int k = 0; k < kSymRows; ++k) {
      const float dx = r.x[k] - p.x;
      const float dy = r.y[k] - p.y;
      float q = rcp_approx(fmaf(dx, dx, fmaf(dy, dy, 1.0f))) * (r.v[k] * vc);
      if (c == row0 + 32 * k) q = 0.0f;
      const float q2 = q * q;
      r.z[k] += q;
      r.fx[k] = fmaf(q2, dx, r.fx[k]);
      r.fy[k] = fmaf(q2, dy, r.fy[k]);
    }
  }
}

__global__ void __launch_bounds__(kSymThreads) repulsion_sym_kernel(
    const float2* __restrict__ y, const float* __restrict__ v, int n, int nt,
    float2* __restrict__ part, float* __restrict__ zpart) {
  __shared__ float2 cxy[kSymTile];
  __shared__ float cv[kSymTile];
  __shared__ float2 cacc[kSymWarps][kSymTile];
  __shared__ float zwarp[kSymWarps];

  // Tile pair (I, J >= I) of this block, row-major over the triangle.
  int I = 0, J = blockIdx.x, len = nt;
  while (J >= len) {
    J -= len;
    --len;
    ++I;
  }
  J += I;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Local row of this lane's k-th row: row0 + 32 k (neighbouring lanes,
  // neighbouring rows, so loads and stores coalesce).
  const int row0 = warp * kSymWarpRows + lane;
  SymRows r;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kSymRows; ++k) {
    const int g = I * kSymTile + row0 + 32 * k;
    const bool in = g < n;
    const float2 p = in ? y[g] : make_float2(0.0f, 0.0f);
    r.x[k] = p.x;
    r.y[k] = p.y;
    r.v[k] = in ? v[g] : 0.0f;
    ok = ok && r.v[k] == 1.0f;
    r.fx[k] = r.fy[k] = r.z[k] = 0.0f;
  }
  for (int c = threadIdx.x; c < kSymTile; c += kSymThreads) {
    const int g = J * kSymTile + c;
    const bool in = g < n;
    cxy[c] = in ? y[g] : make_float2(0.0f, 0.0f);
    cv[c] = in ? v[g] : 0.0f;
    ok = ok && cv[c] == 1.0f;
  }
  const bool all_valid = __syncthreads_and(ok);

  if (I == J) {
    sym_diag(r, cxy, cv, row0);
  } else {
    if (all_valid) {
      sym_offdiag<false>(r, cxy, cv, cacc[warp], lane);
    } else {
      sym_offdiag<true>(r, cxy, cv, cacc[warp], lane);
    }
    __syncthreads();
    float2* out = part + ((long long)J * nt + I) * kSymTile;
    for (int c = threadIdx.x; c < kSymTile; c += kSymThreads) {
      float2 a = cacc[0][c];
#pragma unroll
      for (int w = 1; w < kSymWarps; ++w) {
        a.x += cacc[w][c].x;
        a.y += cacc[w][c].y;
      }
      out[c] = a;
    }
  }

  float2* out = part + ((long long)I * nt + J) * kSymTile;
  float zt = 0.0f;
#pragma unroll
  for (int k = 0; k < kSymRows; ++k) {
    out[row0 + 32 * k] = make_float2(r.fx[k], r.fy[k]);
    zt += r.z[k];
  }
  // Fixed-order block sum: a shuffle tree per warp, then warps in order.
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) zt += __shfl_xor_sync(0xffffffffu, zt, w);
  if (lane == 0) zwarp[warp] = zt;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
    for (int w = 0; w < kSymWarps; ++w) b += zwarp[w];
    // An off-diagonal pair stands for both of its ordered pairs.
    zpart[blockIdx.x] = I == J ? b : 2.0f * b;
  }
}

// Z = the Z slots summed in a fixed tree (the last block).
__device__ void sum_z(const float* __restrict__ zpart, int n_zpart,
                      float* __restrict__ Z) {
  __shared__ float red[kFinishThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_zpart; i += kFinishThreads) acc += zpart[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kFinishThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *Z = red[0];
}

// F_i = row i's nt slots in slot order.
__global__ void __launch_bounds__(kFinishThreads) repulsion_sym_finish_kernel(
    const float2* __restrict__ part, const float* __restrict__ zpart, int n,
    int nt, int n_zpart, float2* __restrict__ F, float* __restrict__ Z) {
  if (blockIdx.x == gridDim.x - 1) {
    sum_z(zpart, n_zpart, Z);
    return;
  }
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= n) return;
  const int t = i / kSymTile, li = i % kSymTile;
  const float2* p = part + (long long)t * nt * kSymTile + li;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int s = 0; s < nt; ++s) {
    const float2 a = p[(long long)s * kSymTile];
    acc.x += a.x;
    acc.y += a.y;
  }
  F[i] = acc;
}

// ---------------------------------------------------------------------------
// Row range: the direct form over ordered pairs.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
// Columns staged in shared memory per pass (8 KiB of float4), and the
// columns one block sweeps.
constexpr int kTile = 512;
constexpr int kColChunk = 8 * kTile;

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
    sum_z(zpart, n_zpart, Z);
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

// Tile of the whole-embedding kernel, for the wrapper's scratch.
int lo_tsne_sym_tile() { return kSymTile; }

// K4, whole embedding: Y (n, 2), valid (n,) f32 -> F (n, 2) f32, Z (1,)
// f32. part: (nt, nt, kSymTile, 2) f32 scratch with nt = ceil(n /
// kSymTile); zpart: (nt (nt + 1) / 2,) f32 scratch.
int lo_tsne_repulsion_sym(const void* y, const void* v, int n, void* part,
                          void* zpart, void* F, void* Z, void* stream) {
  const int nt = (n + kSymTile - 1) / kSymTile;
  const int pairs = nt * (nt + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  repulsion_sym_kernel<<<pairs, kSymThreads, 0, st>>>(
      (const float2*)y, (const float*)v, n, nt, (float2*)part,
      (float*)zpart);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const int f_blocks = (n + kFinishThreads - 1) / kFinishThreads;
  repulsion_sym_finish_kernel<<<f_blocks + 1, kFinishThreads, 0, st>>>(
      (const float2*)part, (const float*)zpart, n, nt, pairs, (float2*)F,
      (float*)Z);
  return (int)cudaGetLastError();
}

// Row blocks and column chunks of a row-range call, for the wrapper's
// scratch.
int lo_tsne_rows_per_block() { return kRowsPerBlock; }
int lo_tsne_cols_per_chunk() { return kColChunk; }

// K4, row range: Yq (nq, 2), validq (nq,), Y (n, 2), valid (n,) f32;
// global id of query row i is offset + i -> F (nq, 2) f32, Z (1,) f32.
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
