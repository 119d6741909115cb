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
// The slice axis (K1, K1 leaf form, K2, K3). One launch serves G slices:
// the trees of a population fit (models/tune.py) at one level, each with its
// own stats, node ids and node tables, over one of P bin matrices stacked
// (P, n, d) and named by the slice's entry of code_idx (members that share
// n_bins share a matrix, so the codes are held once per matrix). The grid's
// last dimension is the slice; every slice's pointers are offset at the top
// of the kernel, and its arithmetic is the one-slice launch's: K1's sums are
// exact int64 fixed point at the slice's own scale, K2 and K3 are integer,
// so each slice's output is bit-identical to a launch of that slice alone.
// A single-tree call is the one-slice case (G = 1). The codes are read once
// per slice, not once per matrix: slices that share a matrix walk different
// trees, so a level's reads differ.
//
// K2 and K3 pack their node tables as each block loads them into shared
// memory, so the wrapper spends no tensor operations on them, and a
// lookup is one 32-bit shared-memory load. A split compares code[f] with
// tt = thr + 1 clamped to [0, 256], what a uint8 code can meet (code >
// thr iff code >= tt); a split on a feature outside [0, d) compares code
// 0, as the Pallas kernels' one-hot select does, so it is packed as
// feature 0 with a fixed side (split_tt). All arithmetic is integer, so
// node ids are bit-identical to the plain versions.
// - Node word (pack_node; K2, and K3's direct path): bit 31 set keeps
//   the row where it is (a node that does not split, a leaf); bits 30..9
//   hold f (the wrapper refuses d > 2^22); bits 8..0 hold tt.
// - Staged entry (pack_step; K3's staged path): (key << 9) | f with key
//   = ((2a + 1) << 8) + 256 - tt, so a level is a' = (key + code[f]) >> 8
//   with no branch: the key's low 9 bits plus the code carry into bit 8
//   iff code >= tt. A node that keeps its rows has key a << 8.
//
// K2  tree_route       replaces learningorchestra_tpu/ops/pallas_kernels.py
//                      _tree_route_kernel (:321, tree_route_level :342).
//     The bound counts 13 B of node ids a row (rel, assign, out 4 B each,
//     the active flag 1 B) and one code byte for each row that moves.
//     What the layout forces: read from the row-major (n, d) codes, a
//     warp's 32 rows span 32 * d bytes (28 sectors at d = 28), and rows
//     at random features fetch nearly all of them, so d bytes a row: 41 B
//     a row at the HIGGS shape, 3x the bound. The design reads codes
//     from a feature-major (d, n) copy, codes_T, made once per bin matrix
//     by the fits (models/trees.py; feature_major_kernel below) and shared
//     by every level of every tree: a warp's rows that read feature f
//     read one contiguous run, so a sector is fetched once per distinct
//     feature among its rows' nodes (1 at level 0, about 8-9 at the
//     deepest HIGGS level, never d), and rows that do not move read none.
//     Each thread takes four consecutive rows: rel and assign as one 16-B
//     load each, the four flags as one word, four independent code loads
//     in flight, one 16-B store.
//
// K3  tree_descend     replaces _tree_descend_kernel (:372, tree_descend
//                      :470).
//     The bound counts one code byte per internal node a row passes and
//     4 B of leaf id a row and tree. What the layout forces: a row's
//     codes are d contiguous bytes and a walk touches up to depth of them
//     at data-dependent places, so a warp fetches the row's whole span:
//     d bytes a row, once per launch at best. A kernel with one thread a
//     row, codes read from device memory at each level and one grid.y a
//     tree pays five dependent loads a row and reads the codes again for
//     every tree of a forest. The design, staged path: a block streams
//     tiles of consecutive rows (one contiguous span of rows * d bytes)
//     into shared memory with 16-B cp.async copies, double-buffered so
//     the next tile's copy overlaps this tile's walk, and walks every
//     tree of its chunk over the staged tile, so device memory sees
//     exactly d bytes a row once per launch plus the leaf ids written.
//     The trees' tables sit beside the two tiles; where all T do not fit
//     (depth 12: 4,095 entries a tree), trees go in chunks, one grid.y
//     each, and each chunk reads the codes once. A forest's walks are
//     bound by shared memory, not device memory: a level is two
//     dependent shared loads (entry, code) and about six integer
//     instructions, so each thread walks its tile rows (up to four) at
//     once, four independent chains; the root's entry is read once per
//     tree and thread. Banks: lanes of a warp read rows d bytes apart, so
//     where they share a feature (the root, always) the code loads are
//     conflict-free where d <= 4 or d is 4 times an odd number (d = 28:
//     7 words), 2-way at d = 6 and the other small d, and gcd(d / 4,
//     32)-way where d is a multiple of 8 (8-way at d = 32); deeper levels
//     add conflicts between lanes on different features (about 3-way at
//     the HIGGS shape's fourth level). Direct path: where d exceeds 32 B
//     (a sector) times the depth, staging a row costs more bytes than a
//     walk can touch (a 784-column one-hot design), so each thread walks
//     its row's codes in device memory over node words in shared memory.
//     ops/tree_kernels.py descend_plan chooses the path by shape.

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

// Grid (R row chunks, node groups x column groups, G slices). Slice z reads
// matrix code_idx[z] (slice z itself where code_idx is null: the leaf form's
// per-slice node ids) and its own stats, scales, node ids and flags.
template <typename CodeT>
__global__ void __launch_bounds__(kHistThreads) hist_slice_kernel(
    const CodeT* __restrict__ codes, const int32_t* __restrict__ code_idx,
    const float* __restrict__ stats, const float* __restrict__ max_abs,
    const int32_t* __restrict__ rel, const uint8_t* __restrict__ active,
    long long* __restrict__ partial, int n, int d, int n_bins, int S,
    int n_nodes, int NG, int CG, int n_cgroups, int rows_per_chunk) {
  constexpr int kGroup = CodeGroup<CodeT>::kSize;
  extern __shared__ int32_t smem[];
  // Slice z's rows start zn entries into its (G, n) arrays and cbase
  // rows into the stacked codes. The loop indexes from the parameters
  // rather than from offset pointers, each of which would hold two
  // registers through the row loop of a kernel capped at 64.
  const int z = blockIdx.z;
  const long long zn = (long long)z * n;
  const long long cbase =
      (long long)(code_idx != nullptr ? code_idx[z] : z) * n;
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
    scale[s] =
        __int_as_float((stat_exponent(max_abs[z * S + s]) + 127) << 23);
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
  const float* zstats = stats + zn * S;
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const bool act = active == nullptr || active[zn + row] != 0;
    const int nl = (rel != nullptr ? rel[zn + row] : 0) - g0;
    float v[kRegStats];
#pragma unroll
    for (int s = 0; s < kRegStats; ++s)
      v[s] = s < S ? zstats[(long long)s * n + row] : 0.0f;
    const CodeT* crow = codes + (cbase + row) * d;
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
        add_stat(zstats[(long long)s * n + row] * scale[s], grp, f0, fe,
                 n_bins, c0, c1, acc_hi + node + s * cw,
                 acc_lo + node + s * cw);
    }
  }
  __syncthreads();

  // Write the slice, laid out (node, stat, column) in shared memory so
  // that the lanes of one add spread over the banks by bin, into this row
  // chunk's partial of slice z, laid out (R, G, n_nodes * d*n_bins * S)
  // with each slice in the public (node, d*n_bins, S) layout.
  const long long total = (long long)n_nodes * DC * S;
  long long* out =
      partial + ((long long)blockIdx.x * gridDim.z + z) * total;
  for (int i = threadIdx.x; i < slice; i += blockDim.x) {
    const int nl = i / (S * cw);
    const int s = i / cw % S;
    const int c = i % cw;
    if (g0 + nl >= n_nodes) continue;
    out[((long long)(g0 + nl) * DC + c0 + c) * S + s] =
        (long long)acc_hi[i] * (1LL << kLoBits) + (long long)acc_lo[i];
  }
}

// out[i] = the R row chunks' exact sums, converted once at the scale of
// the slice's stat: total * 2^-k_s. `all` = G slices of `total` values.
__global__ void sum_partials_kernel(const long long* __restrict__ partial,
                                    const float* __restrict__ max_abs,
                                    float* __restrict__ out, long long total,
                                    long long all, int R, int S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < all; i += (long long)gridDim.x * blockDim.x) {
    long long t = 0;
    for (int r = 0; r < R; ++r) t += partial[(long long)r * all + i];
    const int k = stat_exponent(max_abs[i / total * S + i % S]);
    out[i] = (float)((double)t * __longlong_as_double((1023LL - k) << 52));
  }
}

// The packed node word (see K2 and K3 above): the feature and the
// threshold field; a word < 0 keeps the row where it is.
constexpr int kTtBits = 9;
constexpr uint32_t kFeatMask = (1u << 22) - 1u;
constexpr int32_t kStay = (int32_t)(0x80000000u | 256u);

// A split's feature and tt: the row goes right iff code[f] >= tt. A
// feature outside [0, d) reads code 0, so it becomes feature 0 with a
// fixed side.
__device__ __forceinline__ int split_tt(int& f, int thr, int d) {
  if (f >= 0 && f < d) return thr < 0 ? 0 : thr > 255 ? 256 : thr + 1;
  f = 0;
  return thr < 0 ? 0 : 256;
}

__device__ __forceinline__ int32_t pack_node(int f, int thr, bool go,
                                             int d) {
  if (!go) return kStay;
  const int tt = split_tt(f, thr, d);
  return (int32_t)(((uint32_t)f << kTtBits) | (uint32_t)tt);
}

__device__ __forceinline__ int node_feat(int32_t w) {
  return (int)(((uint32_t)w >> kTtBits) & kFeatMask);
}

__device__ __forceinline__ int node_tt(int32_t w) {
  return w & ((1 << kTtBits) - 1);
}

// Rows a routing thread takes: one 16-B load of rel and of assign.
constexpr int kRouteRows = 4;

// Grid (row blocks, G slices): slice y routes its own rows over its own
// level table, reading matrix code_idx[y] of the (P, d, n) feature-major
// stack.
__global__ void __launch_bounds__(kThreads) route_kernel(
    const uint8_t* __restrict__ codes_T, const int32_t* __restrict__ code_idx,
    const int32_t* __restrict__ rel, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ assign, const int32_t* __restrict__ best_f,
    const int32_t* __restrict__ best_t, const uint8_t* __restrict__ split,
    int32_t* __restrict__ out, int n, int d, int NL, bool vec) {
  extern __shared__ int32_t s_node[];  // NL packed node words
  const long long y = blockIdx.y;
  codes_T += (long long)code_idx[y] * d * n;
  rel += y * n;
  active += y * n;
  assign += y * n;
  out += y * n;
  best_f += y * NL;
  best_t += y * NL;
  split += y * NL;
  for (int i = threadIdx.x; i < NL; i += blockDim.x)
    s_node[i] = pack_node(best_f[i], best_t[i], split[i] != 0, d);
  __syncthreads();
  const long long groups = ((long long)n + kRouteRows - 1) / kRouteRows;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += (long long)gridDim.x * blockDim.x) {
    const long long r0 = gi * kRouteRows;
    const bool whole = vec && r0 + kRouteRows <= n;
    int a[kRouteRows], r[kRouteRows];
    uint32_t act = 0;
    if (whole) {
      const int4 av = *reinterpret_cast<const int4*>(assign + r0);
      const int4 rv = *reinterpret_cast<const int4*>(rel + r0);
      act = *reinterpret_cast<const uint32_t*>(active + r0);
      a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
      r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
    } else {
#pragma unroll
      for (int k = 0; k < kRouteRows; ++k) {
        const bool in = r0 + k < n;
        a[k] = in ? assign[r0 + k] : 0;
        r[k] = in ? rel[r0 + k] : -1;
        act |= (in ? (uint32_t)active[r0 + k] : 0u) << (8 * k);
      }
    }
    // Every row's node word first, then its code load, so a thread has
    // its four code loads in flight together.
    int32_t w[kRouteRows];
#pragma unroll
    for (int k = 0; k < kRouteRows; ++k)
      w[k] = ((act >> (8 * k)) & 0xFFu) != 0 && (unsigned)r[k] < (unsigned)NL
                 ? s_node[r[k]]
                 : -1;
    int next[kRouteRows];
#pragma unroll
    for (int k = 0; k < kRouteRows; ++k) {
      next[k] = a[k];
      if (w[k] >= 0) {
        const int v = codes_T[(long long)node_feat(w[k]) * n + r0 + k];
        next[k] = 2 * a[k] + 1 + (v >= node_tt(w[k]) ? 1 : 0);
      }
    }
    if (whole) {
      *reinterpret_cast<int4*>(out + r0) =
          make_int4(next[0], next[1], next[2], next[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kRouteRows; ++k)
        if (r0 + k < n) out[r0 + k] = next[k];
    }
  }
}

// Threads of a descent block (DESCEND_THREADS in ops/tree_kernels.py).
constexpr int kDescendThreads = 256;

// Tiles of the feature-major copy: rows (a multiple of 4) x features.
constexpr int kTransRows = 1024;
constexpr int kTransFeats = 32;

// codes (n, d) -> out (d, n), one tile of rows x features a block: each
// warp reads whole rows' feature slices (consecutive lanes on consecutive
// bytes), then each thread writes four rows of one feature as one word
// (consecutive lanes on consecutive words). The tile's row stride in
// shared memory is odd, so the write phase's lanes, four rows apart,
// fall on distinct banks.
__global__ void __launch_bounds__(kDescendThreads) feature_major_kernel(
    const uint8_t* __restrict__ codes, uint8_t* __restrict__ out, int n,
    int d, bool words) {
  __shared__ uint8_t s_tile[kTransRows * (kTransFeats + 1)];
  const long long r0 = (long long)blockIdx.x * kTransRows;
  const int f0 = blockIdx.y * kTransFeats;
  const int F = min(kTransFeats, d - f0);
  const int S = F | 1;
  const int R = (int)min((long long)kTransRows, (long long)n - r0);
  const int lane = threadIdx.x % 32;
  // Unrolled so that a warp has several rows' loads in flight.
#pragma unroll 8
  for (int r = threadIdx.x / 32; r < R; r += blockDim.x / 32)
    if (lane < F) s_tile[r * S + lane] = codes[(r0 + r) * d + f0 + lane];
  __syncthreads();
  constexpr int kQuads = kTransRows / 4;
  for (int e = threadIdx.x; e < F * kQuads; e += blockDim.x) {
    const int f = e / kQuads;
    const int r = 4 * (e % kQuads);
    if (r >= R) continue;
    const uint8_t* src = s_tile + r * S + f;
    uint8_t* dst = out + (long long)(f0 + f) * n + r0 + r;
    if (words && r + 4 <= R) {
      *reinterpret_cast<uint32_t*>(dst) =
          (uint32_t)src[0] | (uint32_t)src[S] << 8 |
          (uint32_t)src[2 * S] << 16 | (uint32_t)src[3 * S] << 24;
    } else {
      for (int k = 0; k < 4 && r + k < R; ++k) dst[k] = src[k * S];
    }
  }
}

// K3's staged entry of node a, one 32-bit word: e = (key << 9) | f, so
// that a level of the walk is a' = (e + (code[f] << 9)) >> 17 = (key +
// code[f]) >> 8, branch-free. A split has key = ((2a + 1) << 8) + 256 -
// tt: its low 9 bits plus a uint8 code carry into bit 8 iff code >= tt.
// A node that keeps its rows (a leaf, or an id past the table's M nodes)
// has key = a << 8 and f = 0, so every later level leaves a where it is,
// as the fixed-depth reference loop does. f < 512 and key + code < 2^23
// hold for d <= 448 and depth <= 14, the staged path's shapes.
__device__ __forceinline__ uint32_t pack_step(int a, int f, int thr,
                                              bool go, int d) {
  if (!go) return (uint32_t)a << 17;
  const int tt = split_tt(f, thr, d);
  return (uint32_t)(((2 * a + 1) << 8) + 256 - tt) << 9 | (uint32_t)f;
}

// One level of a walk over staged entries: entry e, the row's codes.
__device__ __forceinline__ uint32_t step(uint32_t e, const uint8_t* row) {
  return (e + ((uint32_t)row[e & 511u] << 9)) >> 17;
}


// One row's walk over node words (pack_node: any d), the direct path's
// table: a leaf keeps its id for the remaining levels.
__device__ __forceinline__ int walk_words(const int32_t* __restrict__ node,
                                          const uint8_t* row, int depth) {
  int a = 0;
  for (int l = 0; l < depth; ++l) {
    const int32_t w = node[a];
    if (w < 0) break;
    a = 2 * a + 1 + (row[node_feat(w)] >= node_tt(w) ? 1 : 0);
  }
  return a;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  // Copies src_bytes (1..16) and zero-fills the rest of the 16 bytes.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage bytes [b0, b1) of codes (n * d bytes at codes) into dst, as the
// 16-B aligned chunks that cover them: byte b lands at dst[(codes + b) -
// align16(codes + b0)]. Chunks that start inside the buffer are cp.async
// copies (the buffer's last chunk reads only its own bytes, zero-filling
// the rest); a chunk that starts before an unaligned buffer is copied
// byte by byte, since the bytes before the buffer are not its own.
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const uint8_t* codes,
                                           long long total, long long b0,
                                           long long b1) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t end = base + (uintptr_t)total;
  const uintptr_t g0 = (base + (uintptr_t)b0) & ~(uintptr_t)15;
  const uintptr_t g1 = (base + (uintptr_t)b1 + 15) & ~(uintptr_t)15;
  const int chunks = (int)((g1 - g0) / 16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const uintptr_t g = g0 + 16 * (uintptr_t)c;
    uint8_t* s = dst + 16 * c;
    if (g >= base) {
      const uintptr_t left = end - g;
      cp_async16(s, reinterpret_cast<const void*>(g),
                 left < 16 ? (int)left : 16);
    } else {
      for (int i = 0; i < 16; ++i) {
        const uintptr_t p = g + i;
        s[i] = p >= base && p < end ? *reinterpret_cast<const uint8_t*>(p)
                                    : 0;
      }
    }
  }
}

// The (T, M) node tables of the trees of this block's chunk, as W
// entries a tree in shared memory (staged entries, or node words):
// nodes past M keep their rows, as ids past the table do in the Pallas
// kernel.
struct Trees {
  const int32_t* feat;
  const int32_t* thr;
  const uint8_t* internal;
  int M, W, T;
};

template <bool kSteps>
__device__ __forceinline__ int load_chunk(uint32_t* s_tbl, Trees tr, int d,
                                          int trees_per_chunk) {
  const int t0 = blockIdx.y * trees_per_chunk;
  const int nt = min(trees_per_chunk, tr.T - t0);
  for (int i = threadIdx.x; i < nt * tr.W; i += blockDim.x) {
    const int a = i % tr.W;
    const long long j = (long long)(t0 + i / tr.W) * tr.M + a;
    const bool in = a < tr.M;
    const int f = in ? tr.feat[j] : 0;
    const int thr = in ? tr.thr[j] : 0;
    const bool go = in && tr.internal[j] != 0;
    s_tbl[i] = kSteps ? pack_step(a, f, thr, go, d)
                      : (uint32_t)pack_node(f, thr, go, d);
  }
  return nt;
}

// Slice z of a launch (grid.z) walks its own (T, M) tables; its codes are
// matrix code_idx[z] of the stack, and its leaf ids its own (T, n) block.
__device__ __forceinline__ void slice_tables(Trees& tr, long long z) {
  tr.feat += z * tr.T * tr.M;
  tr.thr += z * tr.T * tr.M;
  tr.internal += z * tr.T * tr.M;
}

// Staged path: grid (tile blocks, chunks, slices). Shared memory: two
// tile buffers of tile_bytes, then the chunk's tables. A tile has kRows
// rows a thread (rows_per_tile = kRows * blockDim.x), which each thread
// walks at once: kRows independent chains of dependent shared-memory
// loads, interleaved to hide their latency.
template <int kRows>
__global__ void __launch_bounds__(kDescendThreads) descend_staged_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ code_idx,
    long long code_stride, Trees tr, int32_t* __restrict__ out, int n, int d,
    int depth, int trees_per_chunk, int tile_bytes) {
  // Named apart from the histogram kernel's int32_t smem: extern shared
  // arrays of one name must share a type.
  extern __shared__ __align__(16) uint8_t s_bytes[];
  codes += (long long)code_idx[blockIdx.z] * code_stride;
  out += (long long)blockIdx.z * tr.T * n;
  slice_tables(tr, blockIdx.z);
  uint32_t* s_tbl = reinterpret_cast<uint32_t*>(s_bytes + 2 * tile_bytes);
  const int W = tr.W;
  const int nt = load_chunk<true>(s_tbl, tr, d, trees_per_chunk);
  const int t0 = blockIdx.y * trees_per_chunk;
  const int rows_per_tile = kRows * blockDim.x;
  const long long total = (long long)n * d;
  const long long n_tiles = ((long long)n + rows_per_tile - 1) /
                            rows_per_tile;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  // This block's k-th tile is tile blockIdx.x + k * gridDim.x, staged in
  // buffer k % 2; a group is committed per tile, empty past the last.
  auto stage = [&](long long k) {
    const long long tile = blockIdx.x + k * gridDim.x;
    if (tile < n_tiles) {
      const long long r0 = tile * rows_per_tile;
      const long long r1 = min((long long)n, r0 + rows_per_tile);
      stage_rows(s_bytes + (k % 2) * tile_bytes, codes, total, r0 * d,
                 r1 * d);
    }
    cp_async_commit();
  };
  stage(0);
  for (long long k = 0; blockIdx.x + k * gridDim.x < n_tiles; ++k) {
    // The next tile's copy is in flight while this one is walked; its
    // buffer was walked at k - 1 (synced below).
    stage(k + 1);
    cp_async_wait_one();
    __syncthreads();
    const long long r0 = (blockIdx.x + k * gridDim.x) * rows_per_tile;
    const int rows = (int)min((long long)rows_per_tile, n - r0);
    const uint8_t* rows0 = s_bytes + (k % 2) * tile_bytes +
                           ((base + (uintptr_t)(r0 * d)) & 15);
    // Thread rows r + j * blockDim.x; one past the tile's end walks the
    // tile's last row instead, unstored. Lookups stay below 2^depth - 1
    // entries, the table's size.
    const int r = threadIdx.x;
    const uint8_t* row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      row[j] = rows0 + min(r + j * (int)blockDim.x, rows - 1) * d;
    for (int t = 0; t < nt; ++t) {
      const uint32_t* node = s_tbl + t * W;
      const uint32_t e0 = node[0];
      uint32_t a[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) a[j] = depth > 0 ? step(e0, row[j]) : 0u;
      for (int l = 1; l < depth; ++l) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) a[j] = step(node[a[j]], row[j]);
      }
      int32_t* o = out + (long long)(t0 + t) * n + r0;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r + j * (int)blockDim.x < rows) o[r + j * blockDim.x] = (int)a[j];
    }
    // Every thread is done with this buffer before it is staged again.
    __syncthreads();
  }
}

// Direct path: grid (row blocks, chunks, slices); each thread walks its
// row's codes in device memory. Shared memory: the chunk's tables.
__global__ void __launch_bounds__(kDescendThreads) descend_direct_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ code_idx,
    long long code_stride, Trees tr, int32_t* __restrict__ out, int n, int d,
    int depth, int trees_per_chunk) {
  extern __shared__ uint32_t s_word[];
  codes += (long long)code_idx[blockIdx.z] * code_stride;
  out += (long long)blockIdx.z * tr.T * n;
  slice_tables(tr, blockIdx.z);
  const int W = tr.W;
  const int nt = load_chunk<false>(s_word, tr, d, trees_per_chunk);
  const int t0 = blockIdx.y * trees_per_chunk;
  __syncthreads();
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += (long long)gridDim.x * blockDim.x) {
    const uint8_t* crow = codes + row * d;
    for (int t = 0; t < nt; ++t)
      out[(long long)(t0 + t) * n + row] = walk_words(
          reinterpret_cast<const int32_t*>(s_word) + t * W, crow, depth);
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
int launch_hist(const CodeT* codes, const int32_t* code_idx,
                const float* stats, const float* max_abs, const int32_t* rel,
                const uint8_t* active, float* out, long long* partial, int n,
                int d, int n_bins, int S, int n_nodes, int NG, int CG, int R,
                int rows_per_chunk, int G, cudaStream_t stream) {
  if (rows_per_chunk > kMaxRowsPerChunk || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int DC = d * n_bins;
  const int n_cgroups = (DC + CG - 1) / CG;
  const int n_ngroups = (n_nodes + NG - 1) / NG;
  const size_t smem = (size_t)NG * CG * S * 2 * sizeof(int32_t) +
                      (size_t)S * sizeof(float);
  int e = prepare_smem(hist_slice_kernel<CodeT>, smem);
  if (e) return e;
  dim3 grid(R, n_ngroups * n_cgroups, G);
  hist_slice_kernel<CodeT><<<grid, kHistThreads, smem, stream>>>(
      codes, code_idx, stats, max_abs, rel, active, partial, n, d, n_bins, S,
      n_nodes, NG, CG, n_cgroups, rows_per_chunk);
  e = (int)cudaGetLastError();
  if (e) return e;
  const long long total = (long long)n_nodes * DC * S;
  const long long all = total * G;
  long long blocks = (all + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  sum_partials_kernel<<<(int)blocks, kThreads, 0, stream>>>(
      partial, max_abs, out, total, all, R, S);
  return (int)cudaGetLastError();
}

int row_blocks(long long n, int cap) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" {

// K1, histogram form, G slices: codes (P, n, d) uint8, code_idx (G,) int32
// in [0, P), stats (G, S, n) f32, max_abs (G, S) f32 = max |stats[g, s]|,
// rel (G, n) int32, active (G, n) bool -> out (G, n_nodes, d, n_bins, S)
// f32. partial: (R, G, n_nodes*d*n_bins*S) int64 scratch; R row chunks of
// at most 2^17 rows.
int lo_tree_hist_u8(const void* codes, const void* code_idx,
                    const void* stats, const void* max_abs, const void* rel,
                    const void* active, void* out, void* partial, int n,
                    int d, int n_bins, int S, int n_nodes, int NG, int CG,
                    int R, int rows_per_chunk, int G, void* stream) {
  return launch_hist<uint8_t>(
      (const uint8_t*)codes, (const int32_t*)code_idx, (const float*)stats,
      (const float*)max_abs, (const int32_t*)rel, (const uint8_t*)active,
      (float*)out, (long long*)partial, n, d, n_bins, S, n_nodes, NG, CG, R,
      rows_per_chunk, G, (cudaStream_t)stream);
}

// K1, leaf form, G slices: the row's node id is its only "feature" code
// and every row is active in the single node group: assign (G, n) int32,
// stats (G, S, n), max_abs (G, S) -> out (G, n_leaf_ids, S) f32 (the caller
// transposes to (G, S, M)).
int lo_tree_leaf_i32(const void* assign, const void* stats,
                     const void* max_abs, void* out, void* partial, int n,
                     int n_ids, int S, int CG, int R, int rows_per_chunk,
                     int G, void* stream) {
  return launch_hist<int32_t>(
      (const int32_t*)assign, nullptr, (const float*)stats,
      (const float*)max_abs, nullptr, nullptr, (float*)out,
      (long long*)partial, n, 1, n_ids, S, 1, 1, CG, R, rows_per_chunk, G,
      (cudaStream_t)stream);
}

// K2, G slices: codes_T (P, d, n) uint8, code_idx (G,) int32 in [0, P),
// rel/assign (G, n) int32, active (G, n) bool, best_f/best_t (G, NL) int32,
// split (G, NL) bool -> out (G, n) int32. grid_cap bounds the row blocks of
// the whole launch.
int lo_tree_route(const void* codes_T, const void* code_idx, const void* rel,
                  const void* active, const void* assign, const void* best_f,
                  const void* best_t, const void* split, void* out, int n,
                  int d, int NL, int G, int grid_cap, void* stream) {
  if (G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NL * sizeof(int32_t);
  int e = prepare_smem(route_kernel, smem);
  if (e) return e;
  // Four rows a thread as 16-B vectors where every slice's id arrays
  // allow it (slices start n rows apart).
  const bool vec = reinterpret_cast<uintptr_t>(rel) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(assign) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(active) % 4 == 0 &&
                   (G == 1 || n % kRouteRows == 0);
  const long long groups = ((long long)n + kRouteRows - 1) / kRouteRows;
  const int cap = grid_cap / G > 0 ? grid_cap / G : 1;
  const dim3 grid(row_blocks(groups, cap), G);
  route_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes_T, (const int32_t*)code_idx, (const int32_t*)rel,
      (const uint8_t*)active, (const int32_t*)assign,
      (const int32_t*)best_f, (const int32_t*)best_t, (const uint8_t*)split,
      (int32_t*)out, n, d, NL, vec);
  return (int)cudaGetLastError();
}

// codes (n, d) uint8 -> out (d, n) uint8, K2's feature-major codes.
int lo_feature_major(const void* codes, void* out, int n, int d,
                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const bool words = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((n + kTransRows - 1) / kTransRows,
                  (d + kTransFeats - 1) / kTransFeats);
  feature_major_kernel<<<grid, kDescendThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (uint8_t*)out, n, d, words);
  return (int)cudaGetLastError();
}

// K3, G slices: codes, P matrices of (n, d) uint8 rows code_stride bytes
// apart, code_idx (G,) int32 in [0, P), feat/thr (G, T, M) int32, internal
// (G, T, M) bool -> out (G, T, n) int32 leaf ids, walking `depth` levels
// over tables of W = 2^depth - 1 entries. The plan (ops/tree_kernels.py
// descend_plan): the direct path (rows_per_tile 0) or the staged one with
// tiles of rows_per_tile = 1, 2 or 4 rows a thread and buffers of
// tile_bytes; trees a chunk (one grid.y each) and blocks a chunk and slice.
int lo_tree_descend(const void* codes, const void* code_idx,
                    long long code_stride, const void* feat, const void* thr,
                    const void* internal, void* out, int n, int d, int M,
                    int W, int T, int depth, int rows_per_tile,
                    int tile_bytes, int trees_per_chunk, int blocks, int G,
                    void* stream) {
  if (G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const Trees tr{(const int32_t*)feat, (const int32_t*)thr,
                 (const uint8_t*)internal, M, W, T};
  const int chunks =
      T > 0 ? (T + trees_per_chunk - 1) / trees_per_chunk : 1;
  const size_t tables = (size_t)trees_per_chunk * W * sizeof(uint32_t);
  const dim3 grid(blocks, chunks, G);
  int e;
  if (rows_per_tile) {
    const int per_thread = rows_per_tile / kDescendThreads;
    // A tile's rows * d bytes start anywhere in a 16-B chunk: their
    // chunks span at most (rows * d + 30) / 16 of them. The second
    // buffer stays 16-B aligned for cp.async.
    if (rows_per_tile % kDescendThreads ||
        (per_thread != 1 && per_thread != 2 && per_thread != 4) ||
        tile_bytes % 16 ||
        ((long long)rows_per_tile * d + 30) / 16 * 16 > tile_bytes)
      return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)tile_bytes + tables;
    auto kernel = per_thread == 4   ? descend_staged_kernel<4>
                  : per_thread == 2 ? descend_staged_kernel<2>
                                    : descend_staged_kernel<1>;
    e = prepare_smem(kernel, smem);
    if (e) return e;
    kernel<<<grid, kDescendThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)code_idx, code_stride, tr,
        (int32_t*)out, n, d, depth, trees_per_chunk, tile_bytes);
  } else {
    e = prepare_smem(descend_direct_kernel, tables);
    if (e) return e;
    descend_direct_kernel<<<grid, kDescendThreads, tables,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)code_idx, code_stride, tr,
        (int32_t*)out, n, d, depth, trees_per_chunk);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
