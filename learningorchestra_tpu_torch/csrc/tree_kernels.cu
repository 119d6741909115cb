// Tree-fitting kernels for Hopper (sm_90a), bound to Python with ctypes
// (learningorchestra_tpu_torch/ops/tree_kernels.py builds and loads this
// file). Every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch surfaces
// in the wrapper instead of silently not running.
//
// K1  tree_hist        replaces learningorchestra_tpu/ops/pallas_kernels.py
//                      _tree_hist_kernel / _hist_call (tree_histogram and
//                      tree_leaf_stats).
//     What bounds it: memory. Per tree level it reads every row's d bin
//     codes, S stats, node id and active flag once (about 41 B a row at
//     d=28, S=2) and does S adds per (row, feature) — far below the
//     card's operation rate. The TPU kernel built a (tile, d*n_bins)
//     one-hot in VMEM and fed the MXU; on this card the same sums are a
//     scatter, so the design is a privatised histogram in shared memory:
//     each block owns a row range and one (node group x column group)
//     slice of the (n_nodes, d*n_bins, S) accumulator, sized to the
//     shared-memory budget; one thread per row adds the row's stats with
//     shared atomics, and the block writes its slice to a per-block
//     partial. A second pass sums the partials in a fixed order, so only
//     the order of the shared adds inside a block varies between runs,
//     which leaves integer-valued stats exact. Codes, stats and node ids
//     are read once per slice: at the HIGGS shape (16 nodes x 28 features
//     x 32 bins x 2 stats = 112 KiB) there is one slice, so one read of the
//     rows, by one wave of blocks (as many as the SMs' shared memory holds
//     at once), so per-block set-up and partials stay small.
//
// K2  tree_route       replaces _tree_route_kernel (tree_route_level).
// K3  tree_descend     replaces _tree_descend_kernel (tree_descend).
//     What bounds them: memory — one byte of codes per level (a gather
//     within the row's d bytes) plus 4-13 B of node ids per row. The TPU
//     kernels emulated the per-row table lookups with one-hot masked
//     sums; here one thread owns a row, the node tables sit in shared
//     memory (up to 3 x 8191 int32 = 96 KiB for K3 at depth 12), and all
//     arithmetic is integer, so results are bit-identical to the plain
//     versions. K3 takes a leading tree axis (grid.y) so one launch
//     serves a whole forest predict.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kDefaultSmem = 48 * 1024;

template <typename CodeT>
__global__ void hist_slice_kernel(
    const CodeT* __restrict__ codes, const float* __restrict__ stats,
    const int32_t* __restrict__ rel, const uint8_t* __restrict__ active,
    float* __restrict__ partial, int n, int d, int n_bins, int S,
    int n_nodes, int NG, int CG, int n_cgroups, int rows_per_chunk) {
  extern __shared__ float acc[];
  const int DC = d * n_bins;
  const int g = blockIdx.y / n_cgroups;
  const int cg = blockIdx.y % n_cgroups;
  const int g0 = g * NG;
  const int c0 = cg * CG;
  const int c1 = min(c0 + CG, DC);
  const int cw = c1 - c0;
  const int f_lo = c0 / n_bins;
  const int f_hi = (c1 - 1) / n_bins;
  const int slice = NG * cw * S;

  for (int i = threadIdx.x; i < slice; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // One thread per row: its node id and stats load once (neighbouring
  // threads, neighbouring rows: coalesced), then one shared add per
  // (feature, stat). The row's code bytes are reloaded per stat from L1.
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min((long long)n, r0 + rows_per_chunk);
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const bool act = active == nullptr || active[row] != 0;
    const int nl = (rel != nullptr ? rel[row] : 0) - g0;
    if (!act || nl < 0 || nl >= NG || g0 + nl >= n_nodes) continue;
    const CodeT* crow = codes + row * d;
    float* a = acc + (long long)nl * cw * S;
    for (int s = 0; s < S; ++s) {
      const float v = stats[(long long)s * n + row];
      for (int f = f_lo; f <= f_hi; ++f) {
        const int code = (int)crow[f];
        if (code < 0 || code >= n_bins) continue;
        const int col = f * n_bins + code;
        if (col < c0 || col >= c1) continue;
        atomicAdd(a + (col - c0) * S + s, v);
      }
    }
  }
  __syncthreads();

  // Write the slice into this row chunk's partial, in the public
  // (node, d*n_bins, S) layout; the innermost run (columns x stats) is
  // contiguous in both, so the stores coalesce.
  const long long total = (long long)n_nodes * DC * S;
  float* out = partial + (long long)blockIdx.x * total;
  const int run = cw * S;
  for (int i = threadIdx.x; i < slice; i += blockDim.x) {
    const int nl = i / run;
    const int rem = i % run;
    if (g0 + nl >= n_nodes) continue;
    out[((long long)(g0 + nl) * DC + c0) * S + rem] = acc[i];
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, long long total,
                                    int R) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += partial[(long long)r * total + i];
    out[i] = s;
  }
}

__global__ void route_kernel(const uint8_t* __restrict__ codes,
                             const int32_t* __restrict__ rel,
                             const uint8_t* __restrict__ active,
                             const int32_t* __restrict__ assign,
                             const int32_t* __restrict__ tbl,
                             int32_t* __restrict__ out, int n, int d,
                             int NL) {
  extern __shared__ int32_t s_tbl[];  // [feat | thr | split], NL each
  for (int i = threadIdx.x; i < 3 * NL; i += blockDim.x) s_tbl[i] = tbl[i];
  __syncthreads();
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += (long long)gridDim.x * blockDim.x) {
    const int a = assign[row];
    const int r = rel[row];
    int next = a;
    if (active[row] && r >= 0 && r < NL && s_tbl[2 * NL + r] != 0) {
      const int f = s_tbl[r];
      const int v = (f >= 0 && f < d) ? (int)codes[row * d + f] : 0;
      next = 2 * a + 1 + (v > s_tbl[NL + r] ? 1 : 0);
    }
    out[row] = next;
  }
}

__global__ void descend_kernel(const uint8_t* __restrict__ codes,
                               const int32_t* __restrict__ tbl,
                               int32_t* __restrict__ out, int n, int d,
                               int M, int max_depth) {
  extern __shared__ int32_t s_tbl[];  // [feat | thr | internal], M each
  const int32_t* t = tbl + (long long)blockIdx.y * 3 * M;
  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) s_tbl[i] = t[i];
  __syncthreads();
  int32_t* o = out + (long long)blockIdx.y * n;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += (long long)gridDim.x * blockDim.x) {
    int a = 0;
    for (int l = 0; l < max_depth; ++l) {
      // A leaf keeps its id for the remaining levels, as in the
      // fixed-depth reference loop.
      if (a >= M || s_tbl[2 * M + a] == 0) break;
      const int f = s_tbl[a];
      const int v = (f >= 0 && f < d) ? (int)codes[row * d + f] : 0;
      a = 2 * a + 1 + (v > s_tbl[M + a] ? 1 : 0);
    }
    o[row] = a;
  }
}

template <typename K>
int prepare_smem(K kernel, size_t smem) {
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename CodeT>
int launch_hist(const CodeT* codes, const float* stats, const int32_t* rel,
                const uint8_t* active, float* out, float* partial, int n,
                int d, int n_bins, int S, int n_nodes, int NG, int CG,
                int R, int rows_per_chunk, cudaStream_t stream) {
  const int DC = d * n_bins;
  const int n_cgroups = (DC + CG - 1) / CG;
  const int n_ngroups = (n_nodes + NG - 1) / NG;
  const size_t smem = (size_t)NG * CG * S * sizeof(float);
  int e = prepare_smem(hist_slice_kernel<CodeT>, smem);
  if (e) return e;
  dim3 grid(R, n_ngroups * n_cgroups);
  float* dst = R == 1 ? out : partial;
  hist_slice_kernel<CodeT><<<grid, kThreads, smem, stream>>>(
      codes, stats, rel, active, dst, n, d, n_bins, S, n_nodes, NG, CG,
      n_cgroups, rows_per_chunk);
  e = (int)cudaGetLastError();
  if (e || R == 1) return e;
  const long long total = (long long)n_nodes * DC * S;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  sum_partials_kernel<<<(int)blocks, kThreads, 0, stream>>>(partial, out,
                                                            total, R);
  return (int)cudaGetLastError();
}

int row_blocks(long long n, int cap) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" {

// K1, histogram form: codes (n, d) uint8, stats (S, n) f32, rel (n,)
// int32, active (n,) bool -> out (n_nodes, d, n_bins, S) f32.
// partial: (R, n_nodes*d*n_bins*S) f32 scratch, unused when R == 1.
int lo_tree_hist_u8(const void* codes, const void* stats, const void* rel,
                    const void* active, void* out, void* partial, int n,
                    int d, int n_bins, int S, int n_nodes, int NG, int CG,
                    int R, int rows_per_chunk, void* stream) {
  return launch_hist<uint8_t>(
      (const uint8_t*)codes, (const float*)stats, (const int32_t*)rel,
      (const uint8_t*)active, (float*)out, (float*)partial, n, d, n_bins, S,
      n_nodes, NG, CG, R, rows_per_chunk, (cudaStream_t)stream);
}

// K1, leaf form: the row's node id is its only "feature" code and every
// row is active in the single node group: assign (n,) int32, stats (S, n)
// -> out (n_leaf_ids, S) f32 (the caller transposes to (S, M)).
int lo_tree_leaf_i32(const void* assign, const void* stats, void* out,
                     void* partial, int n, int n_ids, int S, int CG, int R,
                     int rows_per_chunk, void* stream) {
  return launch_hist<int32_t>(
      (const int32_t*)assign, (const float*)stats, nullptr, nullptr,
      (float*)out, (float*)partial, n, 1, n_ids, S, 1, 1, CG, R,
      rows_per_chunk, (cudaStream_t)stream);
}

// K2: codes (n, d) uint8, rel/assign (n,) int32, active (n,) bool,
// tbl (3, NL) int32 [feat; thr; split] -> out (n,) int32.
int lo_tree_route(const void* codes, const void* rel, const void* active,
                  const void* assign, const void* tbl, void* out, int n,
                  int d, int NL, int grid_cap, void* stream) {
  const size_t smem = (size_t)3 * NL * sizeof(int32_t);
  int e = prepare_smem(route_kernel, smem);
  if (e) return e;
  route_kernel<<<row_blocks(n, grid_cap), kThreads, smem,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)rel, (const uint8_t*)active,
      (const int32_t*)assign, (const int32_t*)tbl, (int32_t*)out, n, d, NL);
  return (int)cudaGetLastError();
}

// K3: codes (n, d) uint8, tbl (T, 3, M) int32 [feat; thr; internal]
// -> out (T, n) int32 leaf ids.
int lo_tree_descend(const void* codes, const void* tbl, void* out, int n,
                    int d, int M, int T, int max_depth, int grid_cap,
                    void* stream) {
  const size_t smem = (size_t)3 * M * sizeof(int32_t);
  int e = prepare_smem(descend_kernel, smem);
  if (e) return e;
  dim3 grid(row_blocks(n, grid_cap), T);
  descend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)tbl, (int32_t*)out, n, d, M,
      max_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
