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
//   Row range (lo_tsne_repulsion; tsne_repulsion_rows, the call each step
//   of the row-sharded mesh embed makes on every rank: query rows Y[offset,
//   offset + nq) against every row of Y). It replaces the Pallas
//   _repulsion_kernel as tsne_repulsion_rows launches it. The query rows
//   must be Y's own rows (the wrapper checks that Yq and validq are views
//   of Y and valid at offset), which splits the columns in two:
//   - foreign columns, outside [offset, offset + nq): each ordered pair is
//     this rank's alone, counted at 14 operations as the direct form was
//     (two differences, two distance FMAs, the reciprocal, q^2, the Z add,
//     two force FMAs and the flag multiply, which all-valid items skip);
//   - the own nq x nq block: each unordered pair once, credited to both
//     rows, 17 operations, as the whole-embedding kernel takes it.
//   What bounds it: instruction issue. A foreign pair is 8 FP32-pipe
//   instructions and one MUFU reciprocal, and the MUFU unit's 16 lanes a
//   clock against the FP32 pipe's 128 make the two pipes equally busy;
//   an own-block pair is 10 FP32 instructions and half a reciprocal a
//   side. At two ranks the own block is half of a rank's pairs, so taking
//   it once saves a quarter of the launch (1/(2D) at D ranks).
//   Design (the whole-embedding kernel's parts, one kernel):
//   - A work list built by the wrapper (ops/tsne_kernels.py
//     rows_geometry): query tile I (kSymTile rows, 8 a lane in registers,
//     as above) against a foreign range of kForeignCols columns, against
//     itself (sym_diag, the self pair masked by index), or against query
//     tile J > I (sym_offdiag: the column ring, both sides credited).
//     Foreign items run the direct form with no self-pair test (no
//     foreign column is a query row) and apply the query rows' flags
//     once at the end; columns sit in shared memory as float2 plus a
//     separate flag array, one broadcast load a column for 8 pairs.
//   - The column-flag multiply only on items whose staged columns (or,
//     for tile pairs, rows) hold an invalid row, a block-uniform test
//     (__syncthreads_and); items with no valid row or no valid column
//     (the padded tail) are skipped and write zeros.
//   - Persistent blocks, as many as the SMs hold at once (4 a SM at the
//     128-register budget), walk the list, heaviest items first (tile
//     pairs, diagonal tiles, then the half-size foreign items), taking
//     the next item from a global counter: the last wave is no longer a
//     whole grid row of equal blocks, and its ragged end is one foreign
//     item long.
//   - Fixed-order sums: every item writes its row partial to its own slot
//     of an (nt, slots, kSymTile) scratch (slots in global column order),
//     a tile pair also its column partial to query tile J's slot, and its
//     Z to its own slot; the whole form's finish kernel adds them in slot
//     order. Which block takes an item changes no bit, so two calls give
//     the same bits and every rank's step is the same. The sums are
//     grouped differently from the whole-embedding kernel's, so a row
//     range agrees with the whole call to float rounding, not bit for bit.

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

// F_i = row i's slots in slot order: part is (tiles, slots, kSymTile)
// float2, with slots = nt for the whole embedding. Both forms finish here.
__global__ void __launch_bounds__(kFinishThreads) repulsion_sym_finish_kernel(
    const float2* __restrict__ part, const float* __restrict__ zpart, int n,
    int slots, int n_zpart, float2* __restrict__ F, float* __restrict__ Z) {
  if (blockIdx.x == gridDim.x - 1) {
    sum_z(zpart, n_zpart, Z);
    return;
  }
  const int i = blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= n) return;
  const int t = i / kSymTile, li = i % kSymTile;
  const float2* p = part + (long long)t * slots * kSymTile + li;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int s = 0; s < slots; ++s) {
    const float2 a = p[(long long)s * kSymTile];
    acc.x += a.x;
    acc.y += a.y;
  }
  F[i] = acc;
}

// ---------------------------------------------------------------------------
// Row range: foreign columns in the direct form, the own block once a pair.
// ---------------------------------------------------------------------------

// Columns of a foreign item, and the item kinds and record length of the
// work list (ops/tsne_kernels.py rows_geometry builds it).
constexpr int kForeignCols = 512;
constexpr int kForeign = 0, kOwnDiag = 1, kOwnPair = 2;
constexpr int kItemInts = 6;
// Blocks a persistent launch keeps on each SM (a register budget of 128).
constexpr int kRowsMinBlocks = 4;

// Rows of the item against kForeignCols staged columns, every ordered
// pair; no column is a query row, so there is no self pair to mask.
// Query rows' flags are applied once, at the end.
template <bool kMasked>
__device__ __forceinline__ void rows_direct(SymRows& r,
                                            const float2* __restrict__ cxy,
                                            const float* __restrict__ cv) {
#pragma unroll 4
  for (int c = 0; c < kForeignCols; ++c) {
    const float2 p = cxy[c];
    const float vc = kMasked ? cv[c] : 1.0f;
#pragma unroll
    for (int k = 0; k < kSymRows; ++k) {
      const float dx = r.x[k] - p.x;
      const float dy = r.y[k] - p.y;
      float q = rcp_approx(fmaf(dx, dx, fmaf(dy, dy, 1.0f)));
      if (kMasked) q *= vc;
      const float q2 = q * q;
      r.z[k] += q;
      r.fx[k] = fmaf(q2, dx, r.fx[k]);
      r.fy[k] = fmaf(q2, dy, r.fy[k]);
    }
  }
}

// One persistent block walks the work list: item blockIdx.x first, then
// the next unclaimed one (a global counter). Every item writes its own
// slots, so which block takes an item changes no bit of the result.
__global__ void __launch_bounds__(kSymThreads, kRowsMinBlocks)
repulsion_rows_kernel(const float2* __restrict__ y,
                      const float* __restrict__ v, int nq, int offset,
                      const int* __restrict__ items, int n_items, int slots,
                      int* __restrict__ next, float2* __restrict__ part,
                      float* __restrict__ zpart) {
  __shared__ float2 cxy[kSymTile];
  __shared__ float cv[kSymTile];
  __shared__ float2 cacc[kSymWarps][kSymTile];
  __shared__ float zwarp[kSymWarps];
  __shared__ int s_next;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kSymWarpRows + lane;
  const int q_end = offset + nq;  // query rows are global [offset, q_end)
  for (int it = blockIdx.x; it < n_items;) {
    const int* w = items + (long long)kItemInts * it;
    const int kind = w[0], I = w[1], a = w[2], b = w[3];
    const int row_slot = w[4], col_slot = w[5];

    // Rows: query tile I, 8 a lane.
    SymRows r;
    bool rows_all = true, rows_any = false;
#pragma unroll
    for (int k = 0; k < kSymRows; ++k) {
      const int g = offset + I * kSymTile + row0 + 32 * k;
      const bool in = g < q_end;
      const float2 p = in ? y[g] : make_float2(0.0f, 0.0f);
      r.x[k] = p.x;
      r.y[k] = p.y;
      r.v[k] = in ? v[g] : 0.0f;
      rows_all = rows_all && r.v[k] == 1.0f;
      rows_any = rows_any || r.v[k] != 0.0f;
      r.fx[k] = r.fy[k] = r.z[k] = 0.0f;
    }
    // Columns: [a, b) for a foreign item, query tile a for the own block;
    // past the range, invalid zeros.
    const int c0 = kind == kForeign ? a : offset + a * kSymTile;
    const int width = kind == kForeign ? b - a : min(kSymTile, q_end - c0);
    const int cap = kind == kForeign ? kForeignCols : kSymTile;
    bool cols_all = true, cols_any = false;
    for (int c = threadIdx.x; c < cap; c += kSymThreads) {
      const bool in = c < width;
      cxy[c] = in ? y[c0 + c] : make_float2(0.0f, 0.0f);
      cv[c] = in ? v[c0 + c] : 0.0f;
      cols_all = cols_all && cv[c] == 1.0f;
      cols_any = cols_any || cv[c] != 0.0f;
    }
    // Block-uniform flags: skip an item with no valid row or column, and
    // mask only items that touch an invalid row or column.
    const bool live_rows = __syncthreads_or(rows_any);
    const bool live_cols = __syncthreads_or(cols_any);
    const bool valid_cols = __syncthreads_and(cols_all);
    const bool valid_all = __syncthreads_and(rows_all) && valid_cols;
    const bool live = live_rows && live_cols;

    if (live) {
      if (kind == kForeign) {
        if (valid_cols) {
          rows_direct<false>(r, cxy, cv);
        } else {
          rows_direct<true>(r, cxy, cv);
        }
      } else if (kind == kOwnDiag) {
        sym_diag(r, cxy, cv, row0);
      } else if (valid_all) {
        sym_offdiag<false>(r, cxy, cv, cacc[warp], lane);
      } else {
        sym_offdiag<true>(r, cxy, cv, cacc[warp], lane);
      }
    }
    if (kind == kOwnPair) {
      // Column sums of query tile a, the four warps in order.
      __syncthreads();
      float2* out = part + ((long long)a * slots + col_slot) * kSymTile;
      for (int c = threadIdx.x; c < kSymTile; c += kSymThreads) {
        float2 s = make_float2(0.0f, 0.0f);
        if (live) {
          s = cacc[0][c];
#pragma unroll
          for (int w2 = 1; w2 < kSymWarps; ++w2) {
            s.x += cacc[w2][c].x;
            s.y += cacc[w2][c].y;
          }
        }
        out[c] = s;
      }
    }

    float2* out = part + ((long long)I * slots + row_slot) * kSymTile;
    float zt = 0.0f;
#pragma unroll
    for (int k = 0; k < kSymRows; ++k) {
      out[row0 + 32 * k] = make_float2(r.v[k] * r.fx[k], r.v[k] * r.fy[k]);
      zt += r.v[k] * r.z[k];
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) zt += __shfl_xor_sync(0xffffffffu, zt, s);
    if (lane == 0) zwarp[warp] = zt;
    __syncthreads();
    if (threadIdx.x == 0) {
      float bz = 0.0f;
      for (int w2 = 0; w2 < kSymWarps; ++w2) bz += zwarp[w2];
      // An own-block pair stands for both of its ordered pairs.
      zpart[it] = kind == kOwnPair ? 2.0f * bz : bz;
      s_next = gridDim.x + atomicAdd(next, 1);
    }
    __syncthreads();  // shared tiles consumed, s_next visible
    it = s_next;
  }
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

// Geometry of the row form, for the wrapper: columns of a foreign item,
// and the blocks of repulsion_rows_kernel one SM holds at once.
int lo_tsne_foreign_cols() { return kForeignCols; }
int lo_tsne_rows_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, repulsion_rows_kernel, kSymThreads, 0))
    return 0;
  return blocks;
}

// K4, row range: Y (n, 2), valid (n,) f32, the query rows being Y's rows
// [offset, offset + nq) -> F (nq, 2) f32, Z (1,) f32. items: (n_items,
// kItemInts) int32 work list; next: one zeroed int32; part: (ceil(nq /
// kSymTile), slots, kSymTile, 2) f32 scratch, every slot written;
// zpart: (n_items,) f32 scratch. grid: persistent blocks (at most
// n_items).
int lo_tsne_repulsion(const void* y, const void* v, int nq, int offset,
                      const void* items, int n_items, int slots, int grid,
                      void* next, void* part, void* zpart, void* F, void* Z,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  repulsion_rows_kernel<<<grid, kSymThreads, 0, st>>>(
      (const float2*)y, (const float*)v, nq, offset, (const int*)items,
      n_items, slots, (int*)next, (float2*)part, (float*)zpart);
  int e = (int)cudaGetLastError();
  if (e) return e;
  // Row i's slots in slot order (global column order), Z's in item order.
  const int f_blocks = (nq + kFinishThreads - 1) / kFinishThreads;
  repulsion_sym_finish_kernel<<<f_blocks + 1, kFinishThreads, 0, st>>>(
      (const float2*)part, (const float*)zpart, nq, slots, n_items,
      (float2*)F, (float*)Z);
  return (int)cudaGetLastError();
}

}  // extern "C"
