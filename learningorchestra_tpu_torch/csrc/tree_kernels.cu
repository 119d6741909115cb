// Tree-fitting kernels for Hopper (sm_90a), bound to Python with ctypes
// (learningorchestra_tpu_torch/ops/tree_kernels.py builds and loads this
// file). Every entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch surfaces
// in the wrapper instead of silently not running.
//
// K1  tree_hist        replaces learningorchestra_tpu/ops/pallas_kernels.py
//                      _tree_hist_kernel / _hist_call (tree_histogram and
//                      tree_leaf_stats).
//     What bounds it: memory, in principle. Per tree level it reads every
//     row's d bin codes, S stats, node id and active flag once (about 41 B
//     a row at d=28, S=2) and does S adds per (row, feature), far below
//     the card's operation rate. The TPU kernel built a (tile, d*n_bins)
//     one-hot in VMEM and fed the MXU; on this card the same sums are a
//     scatter, so the design is a privatised histogram in shared memory:
//     each block owns a row range and one (node group x column group)
//     slice of the (n_nodes, d*n_bins, S) accumulator, sized to the
//     shared-memory budget; one thread per row adds the row's stats with
//     shared atomics, and the block writes its slice to a per-block
//     partial that a second pass sums in a fixed order.
//     In practice the shared atomics bound it. A shared float atomicAdd
//     compiles on sm_90a to an ATOMS.CAST.SPIN compare-and-swap loop, about
//     one add per clock per SM (20x the byte bound at the HIGGS shape), so
//     the adds are integers, which ATOMS.ADD does natively:
//     - Fixed point per stat row s: x = rint(v * 2^k_s), with
//       k_s = 27 - ceil(log2 max|stats[s]|) so |x| <= 2^27 (k_s = 0 for an
//       all-zero row). The wrapper passes max|stats[s]| on the device (no
//       host sync); the caller computes it once per tree, since a tree's
//       stats do not change across its levels. Integer-valued stats up to
//       2^27 scale exactly (up to 2^13, as the dt/rf class counts are, with
//       a zero low word below); a float stat (gb's gradients) is rounded
//       to within max|v| * 2^-27 a value.
//     - Two 32-bit words a slot: hi = x >> 14 (signed, |hi| <= 2^13) and
//       lo = x & 0x3FFF (unsigned), each added with a native 32-bit shared
//       atomic. A row adds to a slot at most once and a block takes at
//       most 2^17 rows, so neither word's sum can overflow (|sum hi| <=
//       2^17 * 2^13 = 2^30, sum lo < 2^17 * 2^14 = 2^31). A 64-bit
//       shared atomicAdd is itself a compare-and-swap loop on this card,
//       so two native words are the cheaper slot (chip_smoke.py's build
//       line counts the ATOMS forms each kernel compiled to).
//     - Zero words are skipped: for integer stats lo is always 0 in every
//       lane, and a warp-uniform branch then takes a loop with no low-word
//       atomics (predicated off, they would still cost instruction slots); a
//       one-hot class stat's zero classes and rf's zero bootstrap weights
//       add nothing.
//     - With the adds integer, what remains is the atomics' bank
//       conflicts (a warp's 32 rows land on bins at random) and latency:
//       the block is 1024 threads (one block an SM holds the HIGGS slice),
//       a row's loads are all started before any is used, its uint8 codes
//       are held four to a register, and the high- and low-word atomics
//       are interleaved feature by feature.
//     - Each block writes its slice as exact int64 sums (hi * 2^14 + lo);
//       the second pass adds them in int64 and converts once,
//       (float)((double)total * 2^-k_s). Integer sums do not depend on
//       their order, so every histogram, float stats included, is the
//       same on every run, and integer-valued stats are bit-identical to
//       the float index_add_ of the plain version.
//     Codes, stats and node ids are read once per slice: at the HIGGS
//     shape (16 nodes x 28 features x 32 bins x 2 stats x 8 B = 224 KiB)
//     there is one slice, so one read of the rows by one wave of blocks.
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
// Fixed-point histogram words (see K1 above).
constexpr int kValueBits = 27;
constexpr int kLoBits = 14;
constexpr int kMaxRowsPerChunk = 1 << 17;
// The histogram kernel's block size: one block an SM holds the HIGGS
// slice, so the block is as large as the SM's warps allow.
constexpr int kHistThreads = 1024;
// Stats a histogram thread holds in registers (more are loaded per use).
constexpr int kRegStats = 2;

// The codes a histogram thread holds for one row, a group of features at
// a time: uint8 codes packed four to a 32-bit register (a HIGGS row's 28
// codes in 7 registers), int32 codes one to a register.
template <typename CodeT>
struct CodeGroup {
  static constexpr int kPer = sizeof(CodeT) == 1 ? 4 : 1;
  static constexpr int kWords = sizeof(CodeT) == 1 ? 8 : 4;
  static constexpr int kSize = kPer * kWords;  // features
  uint32_t w[kWords];

  // Codes of features [f0, fe): whole 32-bit words where the row is
  // word-aligned (uint8 codes, d a multiple of 4, f0 a multiple of 4),
  // else one load each. Codes past fe are garbage, which callers skip.
  __device__ __forceinline__ void load(const CodeT* __restrict__ crow,
                                       int f0, int fe, bool words) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int f = f0 + k * kPer;
      if (f >= fe) break;
      if constexpr (kPer == 4) {
        if (words) {
          w[k] = *reinterpret_cast<const uint32_t*>(crow + f);
          continue;
        }
        uint32_t p = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (f + t < fe) p |= (uint32_t)crow[f + t] << (8 * t);
        w[k] = p;
      } else {
        w[k] = (uint32_t)crow[f];
      }
    }
  }

  __device__ __forceinline__ int code(int j) const {
    if constexpr (kPer == 4) return (w[j >> 2] >> (8 * (j & 3))) & 0xFF;
    return (int)w[j];
  }
};

// k_s of a stat row from its max |value|: x = rint(v * 2^k) has |x| <=
// 2^kValueBits. Capped so that 2^k is a normal float.
__device__ __forceinline__ int stat_exponent(float max_abs) {
  if (!(max_abs > 0.0f)) return 0;
  int e;
  const float m = frexpf(max_abs, &e);  // max_abs = m 2^e, m in [0.5, 1)
  return min(kValueBits - (m == 0.5f ? e - 1 : e), 126);
}

// The adds of one (row, stat) over a group of codes: the high word, and
// with kLo the low word, each where it is nonzero. The two words' atomics
// are interleaved, one feature at a time, which the card runs faster than
// one word's atomics after the other's.
template <bool kLo, typename CodeT>
__device__ __forceinline__ void add_words(int hi, uint32_t lo,
                                          const CodeGroup<CodeT>& grp,
                                          int f0, int fe, int n_bins, int c0,
                                          int c1, int32_t* hi_run,
                                          uint32_t* lo_run) {
#pragma unroll
  for (int j = 0; j < CodeGroup<CodeT>::kSize; ++j) {
    if (f0 + j >= fe) break;
    const int code = grp.code(j);
    const int col = (f0 + j) * n_bins + code;
    const bool in = (unsigned)code < (unsigned)n_bins && col >= c0 &&
                    col < c1;
    if (in && hi != 0) atomicAdd(hi_run + col, hi);
    if (kLo && in && lo != 0) atomicAdd(lo_run + col, lo);
  }
}

// One stat value (already scaled) of one row into the columns its codes
// select: x = rint(v), split into the two words. Where the low word is
// zero in every lane of the warp (always, for an integer-valued stat), a
// uniform branch takes the loop without its atomics: predicated off, they
// would still cost instruction slots. hi_run and lo_run point at this
// (node, stat)'s run of columns, offset so that column c0 of the slice is
// index c0.
template <typename CodeT>
__device__ __forceinline__ void add_stat(float scaled,
                                         const CodeGroup<CodeT>& grp, int f0,
                                         int fe, int n_bins, int c0, int c1,
                                         int32_t* hi_run, uint32_t* lo_run) {
  const int x = __float2int_rn(scaled);
  const int hi = x >> kLoBits;
  const uint32_t lo = (uint32_t)x & ((1u << kLoBits) - 1u);
  if (__any_sync(__activemask(), lo != 0)) {
    add_words<true>(hi, lo, grp, f0, fe, n_bins, c0, c1, hi_run, lo_run);
  } else {
    add_words<false>(hi, lo, grp, f0, fe, n_bins, c0, c1, hi_run, lo_run);
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(kHistThreads) hist_slice_kernel(
    const CodeT* __restrict__ codes, const float* __restrict__ stats,
    const float* __restrict__ max_abs, const int32_t* __restrict__ rel,
    const uint8_t* __restrict__ active, long long* __restrict__ partial,
    int n, int d, int n_bins, int S, int n_nodes, int NG, int CG,
    int n_cgroups, int rows_per_chunk) {
  constexpr int kGroup = CodeGroup<CodeT>::kSize;
  extern __shared__ int32_t smem[];
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
  int32_t* acc_hi = smem;
  uint32_t* acc_lo = reinterpret_cast<uint32_t*>(smem + slice);
  float* scale = reinterpret_cast<float*>(smem + 2 * slice);

  for (int i = threadIdx.x; i < 2 * slice; i += blockDim.x) smem[i] = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    scale[s] = __int_as_float((stat_exponent(max_abs[s]) + 127) << 23);
  __syncthreads();

  // One thread per row. All of a row's loads (flag, node id, up to
  // kRegStats stats, its first group of codes) are started before any is
  // used, so a row waits for memory once; codes load as 32-bit words where
  // rows are word-aligned (uint8 codes, d a multiple of 4): a HIGGS row's
  // 28 codes are 7 loads. Neighbouring threads take neighbouring rows, so
  // flags, ids and stats coalesce. Then up to two shared integer adds per
  // (feature, stat), predicated on the word being nonzero.
  const bool words = sizeof(CodeT) == 1 && d % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const int f_start = words ? f_lo & ~3 : f_lo;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min((long long)n, r0 + rows_per_chunk);
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const bool act = active == nullptr || active[row] != 0;
    const int nl = (rel != nullptr ? rel[row] : 0) - g0;
    float v[kRegStats];
#pragma unroll
    for (int s = 0; s < kRegStats; ++s)
      v[s] = s < S ? stats[(long long)s * n + row] : 0.0f;
    const CodeT* crow = codes + row * d;
    CodeGroup<CodeT> grp;
    grp.load(crow, f_start, min(f_start + kGroup, f_hi + 1), words);
    if (!act || nl < 0 || nl >= NG || g0 + nl >= n_nodes) continue;
    const int node = nl * S * cw - c0;
    for (int f0 = f_start; f0 <= f_hi; f0 += kGroup) {
      const int fe = min(f0 + kGroup, f_hi + 1);
      if (f0 != f_start) grp.load(crow, f0, fe, words);
#pragma unroll
      for (int s = 0; s < kRegStats; ++s) {
        if (s >= S) break;
        add_stat(v[s] * scale[s], grp, f0, fe, n_bins, c0, c1,
                 acc_hi + node + s * cw, acc_lo + node + s * cw);
      }
      for (int s = kRegStats; s < S; ++s)
        add_stat(stats[(long long)s * n + row] * scale[s], grp, f0, fe,
                 n_bins, c0, c1, acc_hi + node + s * cw,
                 acc_lo + node + s * cw);
    }
  }
  __syncthreads();

  // Write the slice, laid out (node, stat, column) in shared memory so
  // that the lanes of one add spread over the banks by bin, into this row
  // chunk's partial in the public (node, d*n_bins, S) layout.
  const long long total = (long long)n_nodes * DC * S;
  long long* out = partial + (long long)blockIdx.x * total;
  for (int i = threadIdx.x; i < slice; i += blockDim.x) {
    const int nl = i / (S * cw);
    const int s = i / cw % S;
    const int c = i % cw;
    if (g0 + nl >= n_nodes) continue;
    out[((long long)(g0 + nl) * DC + c0 + c) * S + s] =
        (long long)acc_hi[i] * (1LL << kLoBits) + (long long)acc_lo[i];
  }
}

// out[i] = the R row chunks' exact sums, converted once: total * 2^-k_s.
__global__ void sum_partials_kernel(const long long* __restrict__ partial,
                                    const float* __restrict__ max_abs,
                                    float* __restrict__ out, long long total,
                                    int R, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long t = 0;
    for (int r = 0; r < R; ++r) t += partial[(long long)r * total + i];
    const int k = stat_exponent(max_abs[i % S]);
    out[i] = (float)((double)t * __longlong_as_double((1023LL - k) << 52));
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
int launch_hist(const CodeT* codes, const float* stats, const float* max_abs,
                const int32_t* rel, const uint8_t* active, float* out,
                long long* partial, int n, int d, int n_bins, int S,
                int n_nodes, int NG, int CG, int R, int rows_per_chunk,
                cudaStream_t stream) {
  if (rows_per_chunk > kMaxRowsPerChunk) return (int)cudaErrorInvalidValue;
  const int DC = d * n_bins;
  const int n_cgroups = (DC + CG - 1) / CG;
  const int n_ngroups = (n_nodes + NG - 1) / NG;
  const size_t smem = (size_t)NG * CG * S * 2 * sizeof(int32_t) +
                      (size_t)S * sizeof(float);
  int e = prepare_smem(hist_slice_kernel<CodeT>, smem);
  if (e) return e;
  dim3 grid(R, n_ngroups * n_cgroups);
  hist_slice_kernel<CodeT><<<grid, kHistThreads, smem, stream>>>(
      codes, stats, max_abs, rel, active, partial, n, d, n_bins, S, n_nodes,
      NG, CG, n_cgroups, rows_per_chunk);
  e = (int)cudaGetLastError();
  if (e) return e;
  const long long total = (long long)n_nodes * DC * S;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  sum_partials_kernel<<<(int)blocks, kThreads, 0, stream>>>(
      partial, max_abs, out, total, R, S);
  return (int)cudaGetLastError();
}

int row_blocks(long long n, int cap) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" {

// K1, histogram form: codes (n, d) uint8, stats (S, n) f32, max_abs (S,)
// f32 = max |stats[s]|, rel (n,) int32, active (n,) bool -> out (n_nodes,
// d, n_bins, S) f32. partial: (R, n_nodes*d*n_bins*S) int64 scratch; R row
// chunks of at most 2^17 rows.
int lo_tree_hist_u8(const void* codes, const void* stats, const void* max_abs,
                    const void* rel, const void* active, void* out,
                    void* partial, int n, int d, int n_bins, int S,
                    int n_nodes, int NG, int CG, int R, int rows_per_chunk,
                    void* stream) {
  return launch_hist<uint8_t>(
      (const uint8_t*)codes, (const float*)stats, (const float*)max_abs,
      (const int32_t*)rel, (const uint8_t*)active, (float*)out,
      (long long*)partial, n, d, n_bins, S, n_nodes, NG, CG, R,
      rows_per_chunk, (cudaStream_t)stream);
}

// K1, leaf form: the row's node id is its only "feature" code and every
// row is active in the single node group: assign (n,) int32, stats (S, n),
// max_abs (S,) -> out (n_leaf_ids, S) f32 (the caller transposes to
// (S, M)).
int lo_tree_leaf_i32(const void* assign, const void* stats,
                     const void* max_abs, void* out, void* partial, int n,
                     int n_ids, int S, int CG, int R, int rows_per_chunk,
                     void* stream) {
  return launch_hist<int32_t>(
      (const int32_t*)assign, (const float*)stats, (const float*)max_abs,
      nullptr, nullptr, (float*)out, (long long*)partial, n, 1, n_ids, S, 1,
      1, CG, R, rows_per_chunk, (cudaStream_t)stream);
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
