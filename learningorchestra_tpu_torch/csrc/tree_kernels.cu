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
//     - For integer stats lo is always 0 in every lane, and a warp-uniform
//       branch then takes a loop with no low-word atomics.
//     - With the adds integer, what remains is the atomics' bank
//       conflicts (a warp's 32 rows land on bins at random) and latency:
//       the block is 1024 threads (one block an SM holds the HIGGS slice),
//       a row's loads are all started before any is used, its uint8 codes
//       are held four to a register, and the high- and low-word atomics
//       are interleaved feature by feature.
//     - Each block flushes its slice as exact int64 sums (hi * 2^14 + lo)
//       into int64 partials; the second pass adds them in int64 and
//       converts once, (float)((double)total * 2^-k_s). Integer sums do not
//       depend on their order, so every histogram, float stats included,
//       is the same on every run, and integer-valued stats are
//       bit-identical to the float index_add_ of the plain version.
//     - Live nodes: at level l of a tree only its 2^l nodes hold rows, but
//       a population grows every level at the deepest width (NL = 32 at
//       depth 6). The caller names the live nodes [0, n_live); the slice,
//       its node groups and the partials cover those alone, and the
//       second pass writes 0 for the rest. At depth 6, levels 0-4 are one
//       node group of 1-16 nodes, not two of 16 whose second adds nothing.
//     - Persistent blocks: a stream is one (slice, node group, column
//       group); its B blocks (ops/tree_kernels.py hist_grid: whole waves
//       of the card, each at least 95% busy) walk its row chunks in turn,
//       and a block flushes after each chunk: a plain load-add-store into
//       its own int64 partial slot of the stream, then the words
//       re-zeroed. A chunk holds at most 2^17 rows a copy (below), the
//       overflow bound above. The partials scale with the blocks a stream
//       holds, not with n / 2^17 (84 chunks a slice at 11M rows).
//     - Bank-spread copies: a narrow level's slice leaves shared memory
//       free, which goes to copies of the slice (hist_replicas), lane l
//       adding to copy l % R with the copy in the low bits of a slot's word
//       address: lanes of different copies never share a bank, so a warp's
//       random bins collide only within a copy's lanes; the flush sums the
//       copies. A copy takes one row in R of a chunk, so chunks may be R
//       times as long. Copies pay where rows add two words a stat (float
//       stats) and 8 or more fit; the plan gives them only there.
//     - Every add is made, a zero word included, and a code outside the
//       slice's columns adds to the lane's spare word: a condition on an
//       add makes the compiler branch around it, which doubled the
//       instructions of the loop the adds bound.
//     The shared atomics and the instructions around them remain what
//     binds it; chip_smoke.py's atomics probe gives the card's ATOMS.ADD
//     rate, conflict-free and into random bins, and K1's atomics floor
//     (its adds at that rate).
//
// The slice axis (K1, K1 leaf form, K2, K3). One launch serves G slices:
// the trees of a population fit (models/tune.py) at one level, each with its
// own stats, node ids and node tables, over one of P bin matrices stacked
// (P, n, d) and named by the slice's entry of code_idx (members that share
// n_bins share a matrix, so the codes are held once per matrix). Every
// slice's arithmetic is the one-slice launch's: K1's sums are exact int64
// fixed point at the slice's own scale, K2 and K3 are integer, so each
// slice's output is bit-identical to a launch of that slice alone. A
// single-tree call is the one-slice case (G = 1). K1 and K2 read a
// matrix's codes once per slice (slices route different rows to different
// nodes); K3's staged path groups the slices by matrix and walks all their
// trees over one staged tile, so it reads each matrix once.
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
//     A slice launch groups its slices by bin matrix: grid.z is the
//     matrix, and a chunk holds (slice, tree) pairs of that matrix, so the
//     slices of one matrix are walked as the trees of one forest and the
//     matrix is staged once (not once per slice: gb's 18 tune slices share
//     one matrix). The tables sit beside the two tiles; where all pairs
//     do not fit (depth 12: 4,095 entries a tree), they go in chunks, one
//     grid.y each, and each chunk reads the codes once. A forest's walks
//     are bound by shared memory, not device memory: a level is two
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
//     its row's codes in device memory over node words in shared memory,
//     one grid.z a slice.
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
// A histogram block's spare words, one a lane (HIST_SPARE_BYTES in
// ops/tree_kernels.py).
constexpr int kSpareBytes = 32 * sizeof(uint32_t);

// The codes a histogram thread holds for one row, a group of features at
// a time: uint8 codes packed four to a 32-bit register (a HIGGS row's 28
// codes in 7 registers), int32 codes one to a register.
template <typename CodeT>
struct CodeGroup {
  static constexpr int kPer = sizeof(CodeT) == 1 ? 4 : 1;
  static constexpr int kWords = sizeof(CodeT) == 1 ? 8 : 4;
  static constexpr int kSize = kPer * kWords;  // features
  uint32_t w[kWords];

  // Codes of features [f0, f0 + count): whole 32-bit words where the row
  // is word-aligned (uint8 codes, d a multiple of 4, f0 a multiple of 4),
  // else one load each. Codes past count are garbage, which callers skip.
  // The bounds are tested against count alone, so that no per-feature
  // bound is held (or spilled) through a row loop.
  __device__ __forceinline__ void load(const CodeT* __restrict__ crow,
                                       int f0, int count, bool words) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (k * kPer >= count) break;
      const CodeT* p = crow + f0 + k * kPer;
      if constexpr (kPer == 4) {
        if (words) {
          w[k] = *reinterpret_cast<const uint32_t*>(p);
          continue;
        }
        uint32_t packed = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k * 4 + t < count) packed |= (uint32_t)p[t] << (8 * t);
        w[k] = packed;
      } else {
        w[k] = (uint32_t)*p;
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

// The adds of one (row, stat) over a group of `count` codes, the first
// feature's code 0 at column col0: the high word, and with kLo the low
// word. The two words' atomics are interleaved, one feature at a time,
// which the card runs faster than one word's atomics after the other's.
// Every add is made, a zero word included: a condition on an add makes
// the compiler branch around it (a convergence barrier, a branch, the add
// and the barrier's end: twice the instructions of the add in a loop the
// adds bound). A code outside the slice's columns adds to the lane's own
// spare word instead. The column steps by n_bins a feature, so no
// per-feature offset is held through the row loop.
template <bool kLo, int kRep, typename CodeT>
__device__ __forceinline__ void add_words(int hi, uint32_t lo,
                                          const CodeGroup<CodeT>& grp,
                                          int count, int col0, int n_bins,
                                          int c0, int cw, int32_t* hi_run,
                                          uint32_t* lo_run, uint32_t* spare) {
  int col_f = col0;
#pragma unroll
  for (int j = 0; j < CodeGroup<CodeT>::kSize; ++j) {
    if (j >= count) break;
    const int code = grp.code(j);
    const int col = col_f + code;
    const bool in = (unsigned)code < (unsigned)n_bins &&
                    (unsigned)(col - c0) < (unsigned)cw;
    atomicAdd(in ? reinterpret_cast<uint32_t*>(hi_run) + col * kRep : spare,
              (uint32_t)hi);
    if (kLo) atomicAdd(in ? lo_run + col * kRep : spare, lo);
    col_f += n_bins;
  }
}

// One stat value (already scaled) of one row into the columns its codes
// select: x = rint(v), split into the two words. Where the low word is
// zero in every lane of the warp (always, for an integer-valued stat), a
// uniform branch takes the loop without its atomics. hi_run and lo_run point at this
// (node, stat)'s run of columns and the thread's copy, offset so that
// column c0 of the slice is index c0 * kRep.
template <int kRep, typename CodeT>
__device__ __forceinline__ void add_stat(float scaled,
                                         const CodeGroup<CodeT>& grp,
                                         int count, int col0, int n_bins,
                                         int c0, int cw, int32_t* hi_run,
                                         uint32_t* lo_run, uint32_t* spare) {
  const int x = __float2int_rn(scaled);
  const int hi = x >> kLoBits;
  const uint32_t lo = (uint32_t)x & ((1u << kLoBits) - 1u);
  if (__any_sync(__activemask(), lo != 0)) {
    add_words<true, kRep>(hi, lo, grp, count, col0, n_bins, c0, cw, hi_run,
                          lo_run, spare);
  } else {
    add_words<false, kRep>(hi, lo, grp, count, col0, n_bins, c0, cw, hi_run,
                           lo_run, spare);
  }
}

// Grid (B blocks a stream, node groups x column groups, G slices): a
// stream is one (slice, node group, column group), and its B blocks are
// persistent: block x walks the stream's row chunks x, x + B, x + 2B, ...
// of at most kMaxRowsPerChunk rows a copy (the overflow bound above: a
// chunk's rows go to the copies in turn, lane by lane). After each
// chunk it flushes its shared slice — kRep bank-spread copies of it (lane
// l adds to copy l % kRep, the copy index in the low bits of a slot's word
// address), each slot's copies summed to an exact int64 — into its own
// int64 partial slot x of the stream: a store at its first chunk, a plain
// load-add-store (the slot is the block's own) at the others; the words
// are re-zeroed. Only the n_live nodes [0, n_live) may hold active rows
// at this level; the slice, the node groups and the partials cover those
// alone. Slice z reads matrix code_idx[z] (slice z itself where code_idx
// is null: the leaf form's per-slice node ids) and its own stats, scales,
// node ids and flags. The leaf form (int32 codes) is held to 32 registers,
// so that an SM holds two of its blocks.
template <typename CodeT, int kRep>
__global__ void __launch_bounds__(kHistThreads, sizeof(CodeT) == 4 ? 2 : 1)
    hist_slice_kernel(const CodeT* __restrict__ codes,
                      const int32_t* __restrict__ code_idx,
                      const float* __restrict__ stats,
                      const float* __restrict__ max_abs,
                      const int32_t* __restrict__ rel,
                      const uint8_t* __restrict__ active,
                      long long* __restrict__ partial, int n, int d,
                      int n_bins, int S, int n_live, int NG, int CG,
                      int n_cgroups, int rows_per_chunk) {
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
  const int g0 = blockIdx.y / n_cgroups * NG;
  const int c0 = blockIdx.y % n_cgroups * CG;
  const int c1 = min(c0 + CG, DC);
  const int cw = c1 - c0;
  const int f_lo = c0 / n_bins;
  const int f_hi = (c1 - 1) / n_bins;
  const int words = NG * cw * S * kRep;
  int32_t* acc_hi = smem;
  uint32_t* acc_lo = reinterpret_cast<uint32_t*>(smem + words);
  float* scale = reinterpret_cast<float*>(smem + 2 * words);
  // Each lane's spare word, for the adds of codes outside the slice.
  uint32_t* spare = reinterpret_cast<uint32_t*>(scale + S) + threadIdx.x % 32;
  const int rep = (int)(threadIdx.x % kRep);

  for (int i = threadIdx.x; i < 2 * words; i += blockDim.x) smem[i] = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    scale[s] =
        __int_as_float((stat_exponent(max_abs[z * S + s]) + 127) << 23);

  // One thread per row. All of a row's loads (flag, node id, up to
  // kRegStats stats, its first group of codes) are started before any is
  // used, so a row waits for memory once; codes load as 32-bit words where
  // rows are word-aligned (uint8 codes, d a multiple of 4): a HIGGS row's
  // 28 codes are 7 loads. Neighbouring threads take neighbouring rows, so
  // flags, ids and stats coalesce. Then up to two shared integer adds per
  // (feature, stat), predicated on the word being nonzero.
  const bool words_ok = sizeof(CodeT) == 1 && d % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const int f_start = words_ok ? f_lo & ~3 : f_lo;
  const float* zstats = stats + zn * S;
  // Chunk k of this block is chunk blockIdx.x + k * gridDim.x of the
  // stream; the loop runs once at least, so the block's partial slot is
  // stored even where its first chunk lies past the rows. Only k is
  // carried through the row loop: the rest is recomputed from it.
  for (int k = 0;; ++k) {
    const long long r0 =
        ((long long)k * gridDim.x + blockIdx.x) * rows_per_chunk;
    if (k > 0 && r0 >= n) break;
    // The last chunk's flush (its re-zeroing) is done before these adds.
    __syncthreads();
    const long long r1 = min((long long)n, r0 + rows_per_chunk);
    for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
      const bool act = active == nullptr || active[zn + row] != 0;
      const int nl = (rel != nullptr ? rel[zn + row] : 0) - g0;
      float v[kRegStats];
#pragma unroll
      for (int s = 0; s < kRegStats; ++s)
        v[s] = s < S ? zstats[(long long)s * n + row] : 0.0f;
      const CodeT* crow = codes + (cbase + row) * d;
      CodeGroup<CodeT> grp;
      grp.load(crow, f_start, min(kGroup, f_hi + 1 - f_start), words_ok);
      if (!act || nl < 0 || nl >= NG || g0 + nl >= n_live) continue;
      const int node = nl * S * cw - c0;
      for (int f0 = f_start; f0 <= f_hi; f0 += kGroup) {
        const int count = min(kGroup, f_hi + 1 - f0);
        if (f0 != f_start) grp.load(crow, f0, count, words_ok);
#pragma unroll
        for (int s = 0; s < kRegStats; ++s) {
          if (s >= S) break;
          add_stat<kRep>(v[s] * scale[s], grp, count, f0 * n_bins, n_bins,
                         c0, cw, acc_hi + (node + s * cw) * kRep + rep,
                         acc_lo + (node + s * cw) * kRep + rep, spare);
        }
        for (int s = kRegStats; s < S; ++s)
          add_stat<kRep>(zstats[(long long)s * n + row] * scale[s], grp,
                         count, f0 * n_bins, n_bins, c0, cw,
                         acc_hi + (node + s * cw) * kRep + rep,
                         acc_lo + (node + s * cw) * kRep + rep, spare);
      }
    }
    __syncthreads();

    // Flush the slice, laid out (node, stat, column, copy) in shared
    // memory so that the lanes of one add spread over the banks by bin
    // and copy, into this block's partial slot of slice z: partials are
    // laid out (B, G, n_live * d*n_bins * S), each slice in the public
    // (node, d*n_bins, S) layout. Consecutive threads read (and re-zero)
    // consecutive words, a slot's kRep copies in kRep consecutive lanes,
    // summed with shuffles.
    const long long live_total = (long long)n_live * DC * S;
    long long* out =
        partial + ((long long)blockIdx.x * gridDim.z + z) * live_total;
    for (int w0 = 0; w0 < words; w0 += blockDim.x) {
      const int w = w0 + threadIdx.x;
      long long t = 0;
      if (w < words) {
        t = (long long)acc_hi[w] * (1LL << kLoBits) + (long long)acc_lo[w];
        acc_hi[w] = 0;
        acc_lo[w] = 0;
      }
#pragma unroll
      for (int o = kRep / 2; o > 0; o /= 2)
        t += __shfl_down_sync(0xFFFFFFFFu, t, o, kRep);
      const int i = w / kRep;
      const int nl = i / (S * cw);
      if (w >= words || w % kRep != 0 || g0 + nl >= n_live) continue;
      long long* o =
          out + ((long long)(g0 + nl) * DC + c0 + i % cw) * S + i / cw % S;
      *o = k == 0 ? t : *o + t;
    }
  }
}

// The second pass's block; the most threads it gives one output, and the
// threads (about what the card holds at once) past which it gives one.
constexpr int kSumThreads = 512;
constexpr int kSumMaxSlices = 16;
constexpr long long kSumFill = 1LL << 18;

// out[i] = the B partial slots' exact sums of each slot of the public
// (G, n_nodes, d*n_bins, S) layout, converted once at the scale of the
// slice's stat (total * 2^-k_s), or with out_i64 left as integers: the
// totals a pod adds across ranks before the one conversion
// (models/trees.py). Nodes n_live.. are 0: no row adds there. A block is
// (C outputs, Y threads an output), C * Y = kSumThreads: thread (c, y)
// of block x sums slots y, y + Y, ... of output C x + c (a row of
// threads loads consecutive outputs, coalesced), and row 0 adds the
// rows' sums. A thread thus waits on B / Y loads, not B: the leaf form's
// B = 264 slots of 126 outputs, one thread an output, were a chain of
// loads that their latency bound (one build of that loop kept only two
// in flight). Y is the largest power of two up to min(B, kSumMaxSlices)
// that keeps all outputs' threads within kSumFill: where the outputs
// alone fill the card (a population's histograms), Y = 1, a thread an
// output, with no shared-memory step.
__global__ void __launch_bounds__(kSumThreads) sum_partials_kernel(
    const long long* __restrict__ partial, const float* __restrict__ max_abs,
    float* __restrict__ out_f32, long long* __restrict__ out_i64,
    long long total, long long live_total, int G, int S, int B) {
  __shared__ long long s_sum[kSumThreads];
  const int C = blockDim.x;
  const int Y = blockDim.y;
  const long long all = total * G;
  const long long i = (long long)blockIdx.x * C + threadIdx.x;
  long long t = 0, g = 0, j = 0;
  if (i < all) {
    g = i / total;
    j = i % total;
    if (j < live_total) {
      const long long* p =
          partial + ((long long)threadIdx.y * G + g) * live_total + j;
      const long long step = (long long)Y * G * live_total;
      for (int r = threadIdx.y; r < B; r += Y, p += step) t += *p;
    }
  }
  if (Y > 1) {
    s_sum[threadIdx.y * C + threadIdx.x] = t;
    __syncthreads();
    if (threadIdx.y != 0) return;
    for (int y = 1; y < Y; ++y) t += s_sum[y * C + threadIdx.x];
  }
  if (i >= all) return;
  if (out_i64 != nullptr) {
    out_i64[i] = t;
  } else {
    const int k = stat_exponent(max_abs[g * S + j % S]);
    out_f32[i] = (float)((double)t * __longlong_as_double((1023LL - k) << 52));
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
// align16(codes + b0)], or with pad = 1 chunk c (counted from the first)
// at chunk c + c / pitch, a 16-B pad after every pitch chunks (the
// feature-major copy's layout). Chunks that start inside the buffer are
// cp.async copies (the buffer's last chunk reads only its own bytes,
// zero-filling the rest); a chunk that starts before an unaligned buffer
// is copied byte by byte, since the bytes before the buffer are not its
// own.
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const uint8_t* codes,
                                           long long total, long long b0,
                                           long long b1, int pitch = 1,
                                           int pad = 0) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t end = base + (uintptr_t)total;
  const uintptr_t g0 = (base + (uintptr_t)b0) & ~(uintptr_t)15;
  const uintptr_t g1 = (base + (uintptr_t)b1 + 15) & ~(uintptr_t)15;
  const int chunks = (int)((g1 - g0) / 16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const uintptr_t g = g0 + 16 * (uintptr_t)c;
    uint8_t* s = dst + 16 * (c + (pad ? c / pitch : 0));
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

// Copies `bytes` (1..v) of a v-byte cp.async (v = 4 or 8), zero-filling
// the rest; v-aligned source and destination.
template <int v>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem,
                                            int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(v), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The feature-major copy (codes_T, K2's layout; see K2 above): (P, n, d)
// uint8 codes -> (P, d, n). A plain transpose: it reads and writes n * d
// bytes a matrix and computes nothing, so memory bounds it (2 n d bytes
// at 3.35 TB/s: 0.18 ms at the HIGGS sweep's 11M x 28). The design, for
// each of the three phases of a tile of kTransRows rows x up to
// kTransFeats features:
// - Load. Where one feature tile covers the row (d <= kTransFeats: the
//   HIGGS sweep, tune and pod shapes), a tile is one contiguous span of
//   rows * d bytes, copied into shared memory as the 16-B aligned chunks
//   that cover it, each a 16-B cp.async (the span's head before an
//   unaligned matrix base byte by byte, its tail past the matrix end
//   zero-filled: stage_rows). Wider rows are strided: each row's slice
//   of the tile's features is copied with the widest cp.async (16, 8 or
//   4 B) that the base and the row stride d allow, else byte by byte.
//   All of a block's copies are issued before any is waited for: 28 KB a
//   block at d = 28, several blocks an SM (kTransThreads threads each),
//   which keeps well over the ~25 KB an SM that 3.35 TB/s x ~1 us of
//   latency over 132 SMs asks in flight.
// - Transpose. A thread takes a unit of 16 rows x 4 features: it reads
//   each row's 4 features as one 32-bit shared word (two words and a
//   funnel shift where the staged rows are not word-aligned: d not a
//   multiple of 4, or a base off a 4-B boundary), and turns each 4 x 4
//   byte block into 4 words of 4 rows of one feature with 8 byte permutes
//   (PRMT). No byte is read from shared memory on its own. A warp's
//   lanes take 32 consecutive 16-row groups of one feature group. Staged
//   rows are pitch bytes apart (d on the span path, kTransFeats strided),
//   so a 16-row group is pitch chunks whatever the base's alignment; a
//   16-B pad after every group where pitch is even puts the groups an
//   odd number of chunks (pitch + pad) apart, so any 8 consecutive
//   lanes read 8 different 16-B bank quads: 4-way bank conflicts, the
//   least a layout placed chunk by chunk gives 32 lanes' word reads.
// - Store. One 16-B store a lane, 16 consecutive rows of one feature:
//   a warp writes 512 contiguous bytes. Where a feature's output row is
//   not 16-B aligned (n not a multiple of 16), the 16-B aligned blocks
//   straddle two lanes' groups, so each lane takes the next lane's 16
//   bytes by shuffle and stores the aligned block that starts in its own
//   group; only the bytes before a warp's first block and after its last,
//   and a ragged last group, are stored a byte at a time.
// One launch serves a stack of P matrices (grid.z a matrix), so a
// population's bin matrices (models/tune.py) take one launch and no
// stacking copy.
constexpr int kTransThreads = 256;
constexpr int kTransRows = 1024;
constexpr int kTransFeats = 32;
// Rows of a unit (one 16-B store a feature; a unit's 4 features are one
// shared word), and units of a tile's feature group.
constexpr int kTransGroup = 16;
constexpr int kTransGroups = kTransRows / kTransGroup;

// Bytes a staged row takes, and the 16-B pads after each 16-row group.
__device__ __host__ __forceinline__ int trans_pitch(int d) {
  return d <= kTransFeats ? d : kTransFeats;
}

__device__ __host__ __forceinline__ int trans_pad(int pitch) {
  return (pitch & 1) ^ 1;
}

// Shared bytes of a tile: every chunk a tile's rows can reach (its head
// offset, a second word past its last row) and the pads between them.
__host__ __forceinline__ long long trans_tile_bytes(int d) {
  const int pitch = trans_pitch(d);
  return 16LL * (((long long)kTransRows * pitch + 32 + 15) / 16 +
                 trans_pad(pitch) * (kTransGroups + 3));
}

// Stage rows [r0, r0 + rows) of a strided tile, features [f0, f0 + F) of
// each, row r at byte r * kTransFeats + 16 * (r / 16) of dst (pitch
// kTransFeats, one pad a group), with v-byte copies.
template <int v>
__device__ __forceinline__ void stage_strided(uint8_t* dst,
                                              const uint8_t* codes,
                                              long long r0, int rows, int d,
                                              int f0, int F) {
  const int per_row = (F + v - 1) / v;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int j = (c - r * per_row) * v;
    const uint8_t* src = codes + (r0 + r) * d + f0 + j;
    uint8_t* s = dst + r * kTransFeats + 16 * (r / kTransGroup) + j;
    const int bytes = min(v, F - j);
    if constexpr (v == 16) {
      cp_async16(s, src, bytes);
    } else if constexpr (v >= 4) {
      cp_async_ca<v>(s, src, bytes);
    } else {
      *s = *src;
    }
  }
}

// The staged word of a 16-row group at local byte position u (counted
// from the group's first chunk; u % 4 == 0): chunks past the group's
// pitch chunks lie beyond its pad.
__device__ __forceinline__ uint32_t group_word(const uint8_t* grp, int u,
                                               int pitch, int pad) {
  const int t = u >> 4;
  const int e = (t >= pitch) + (t >= 2 * pitch);
  return *reinterpret_cast<const uint32_t*>(grp + u + 16 * pad * e);
}

// Bytes [p0, p1) of a 16-row group (y: its four words, row 4i in byte 0
// of word i), each stored on its own.
__device__ __forceinline__ void store_group_bytes(uint8_t* dst,
                                                  const uint32_t (&y)[4],
                                                  int p0, int p1) {
#pragma unroll
  for (int p = 0; p < kTransGroup; ++p)
    if (p >= p0 && p < p1) dst[p] = (uint8_t)(y[p >> 2] >> (8 * (p & 3)));
}

// Grid (row tiles x feature tiles, 1, P matrices): block x is row tile x /
// feat_tiles and feature tile x % feat_tiles of matrix blockIdx.z, whose
// codes start code_stride bytes after the previous matrix's and whose
// output is out + z * d * n. Dynamic shared memory: trans_tile_bytes(d).
__global__ void __launch_bounds__(kTransThreads) feature_major_kernel(
    const uint8_t* __restrict__ codes, long long code_stride,
    uint8_t* __restrict__ out, int n, int d, int feat_tiles) {
  extern __shared__ __align__(16) uint8_t s_trans[];
  const int ft = blockIdx.x % feat_tiles;
  const long long r0 = (long long)(blockIdx.x / feat_tiles) * kTransRows;
  const int rows = (int)min((long long)kTransRows, (long long)n - r0);
  codes += (long long)blockIdx.z * code_stride;
  out += (long long)blockIdx.z * d * n;
  const int f0 = ft * kTransFeats;
  const int F = min(kTransFeats, d - f0);
  const int pitch = trans_pitch(d);
  const int pad = trans_pad(pitch);
  // Byte offset of the tile's first row in its first staged chunk.
  int off = 0;
  if (d <= kTransFeats) {
    off = (int)((reinterpret_cast<uintptr_t>(codes) + r0 * d) & 15);
    stage_rows(s_trans, codes, (long long)n * d, r0 * d, (r0 + rows) * d,
               pitch, pad);
  } else {
    const int a = (int)((reinterpret_cast<uintptr_t>(codes) + f0) | d);
    if ((a & 15) == 0) {
      stage_strided<16>(s_trans, codes, r0, rows, d, f0, F);
    } else if ((a & 7) == 0) {
      stage_strided<8>(s_trans, codes, r0, rows, d, f0, F);
    } else if ((a & 3) == 0) {
      stage_strided<4>(s_trans, codes, r0, rows, d, f0, F);
    } else {
      stage_strided<1>(s_trans, codes, r0, rows, d, f0, F);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Unit (q, g): features f0 + 4q .. + 3, rows r0 + 16g .. + 15; a warp's
  // lanes share q and take consecutive g.
  const bool aligned = (off & 3) == 0 && (pitch & 3) == 0;
  const int units = kTransGroups * ((F + 3) / 4);
  for (int unit = threadIdx.x; unit < units; unit += blockDim.x) {
    const int q = unit / kTransGroups;
    const int g = unit % kTransGroups;
    // A warp's lanes take groups g - lane .. g - lane + 31: the warp skips
    // them together, so that every lane takes part in the shuffles below.
    const int lane = threadIdx.x & 31;
    if ((g - lane) * kTransGroup >= rows) continue;
    const uint8_t* grp = s_trans + 16 * (pitch + pad) * g;
    // o[j][i]: feature 4q + j of rows 4i .. 4i + 3 (row 4i in byte 0).
    uint32_t o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w[4];  // rows 4i + k, features 4q .. 4q + 3 (byte = feature)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = off + (4 * i + k) * pitch + 4 * q;
        if (aligned) {
          w[k] = group_word(grp, u, pitch, pad);
        } else {
          const int v = u & ~3;
          w[k] = __funnelshift_r(group_word(grp, v, pitch, pad),
                                 group_word(grp, v + 4, pitch, pad),
                                 8 * (u & 3));
        }
      }
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      o[0][i] = __byte_perm(t0, t2, 0x5410);
      o[1][i] = __byte_perm(t0, t2, 0x7632);
      o[2][i] = __byte_perm(t1, t3, 0x5410);
      o[3][i] = __byte_perm(t1, t3, 0x7632);
    }
    // Rows of this lane's group, of the next lane's (every group before
    // this one is whole).
    const int mine = min(max(rows - g * kTransGroup, 0), kTransGroup);
    const int next = min(max(rows - (g + 1) * kTransGroup, 0), kTransGroup);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * q + j >= F) break;
      uint8_t* dst = out + (long long)(f0 + 4 * q + j) * n + r0 +
                     g * kTransGroup;
      const int m = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
      if (m == 0) {
        if (mine == kTransGroup)
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
        else
          store_group_bytes(dst, o[j], 0, mine);
        continue;
      }
      // Shifted: the aligned 16 B at dst + s are this group's bytes s..15
      // and the next lane's 0..s-1.
      const int s = kTransGroup - m;
      uint32_t x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = o[j][i];
        x[4 + i] = __shfl_down_sync(0xFFFFFFFFu, o[j][i], 1);
      }
      const bool own_block = lane < 31 && mine == kTransGroup && next >= s;
      const bool prev_block = lane > 0 && rows >= g * kTransGroup &&
                              mine >= s;
      if (own_block) {
        const int a = s >> 2;
        uint32_t z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = a == 0   ? x[i]
                              : a == 1 ? x[i + 1]
                              : a == 2 ? x[i + 2]
                                       : x[i + 3];
          const uint32_t hi = a == 0   ? x[i + 1]
                              : a == 1 ? x[i + 2]
                              : a == 2 ? x[i + 3]
                                       : x[i + 4];
          z[i] = __funnelshift_r(lo, hi, 8 * (s & 3));
        }
        *reinterpret_cast<uint4*>(dst + s) =
            make_uint4(z[0], z[1], z[2], z[3]);
      }
      // What no aligned block took: a warp's two ends, a ragged tail.
      store_group_bytes(dst, o[j], prev_block ? s : 0,
                        own_block ? s : mine);
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

// The direct path's chunk: trees t0 .. t0 + nt - 1 of the slice, as node
// words.
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
    s_tbl[i] = (uint32_t)pack_node(f, thr, go, d);
  }
  return nt;
}

// Slice z of a direct launch (grid.z) walks its own (T, M) tables; its
// codes are matrix code_idx[z] of the stack, and its leaf ids its own
// (T, n) block.
__device__ __forceinline__ void slice_tables(Trees& tr, long long z) {
  tr.feat += z * tr.T * tr.M;
  tr.thr += z * tr.T * tr.M;
  tr.internal += z * tr.T * tr.M;
}

// The tables of a staged chunk, as staged entries: its (slice, tree)
// pairs q = c0 .. c0 + nt - 1 of one matrix, pair q being tree q % T of
// slice order[s0 + q / T].
__device__ __forceinline__ void load_pairs(uint32_t* s_tbl, Trees tr,
                                           const int32_t* __restrict__ order,
                                           int s0, int c0, int nt, int d) {
  for (int i = threadIdx.x; i < nt * tr.W; i += blockDim.x) {
    const int a = i % tr.W;
    const int q = c0 + i / tr.W;
    const long long table = (long long)order[s0 + q / tr.T] * tr.T + q % tr.T;
    const long long j = table * tr.M + a;
    const bool in = a < tr.M;
    s_tbl[i] = pack_step(a, in ? tr.feat[j] : 0, in ? tr.thr[j] : 0,
                         in && tr.internal[j] != 0, d);
  }
}

// Staged path: grid (tile blocks, chunks, P bin matrices). The slices of
// matrix p = blockIdx.z are order[first[p] .. first[p + 1]) (the wrapper
// groups them by matrix), and its (slice, tree) pairs go in chunks of
// pairs_per_chunk, one grid.y each: to this kernel the slices of one
// matrix are the trees of one forest. A block stages each tile of matrix
// p's rows once and walks every pair of its chunk over it, each pair's
// leaf ids into its slice's own (T, n) block. Shared memory: two tile
// buffers of tile_bytes, then the chunk's tables. A tile has kRows rows a
// thread (rows_per_tile = kRows * blockDim.x), which each thread walks at
// once: kRows independent chains of dependent shared-memory loads,
// interleaved to hide their latency.
template <int kRows>
__global__ void __launch_bounds__(kDescendThreads) descend_staged_kernel(
    const uint8_t* __restrict__ codes, long long code_stride,
    const int32_t* __restrict__ order, const int32_t* __restrict__ first,
    Trees tr, int32_t* __restrict__ out, int n, int d, int depth,
    int pairs_per_chunk, int tile_bytes) {
  // Named apart from the histogram kernel's int32_t smem: extern shared
  // arrays of one name must share a type.
  extern __shared__ __align__(16) uint8_t s_bytes[];
  const int s0 = first[blockIdx.z];
  const int pairs = (first[blockIdx.z + 1] - s0) * tr.T;
  const int c0 = blockIdx.y * pairs_per_chunk;
  if (c0 >= pairs) return;
  const int nt = min(pairs_per_chunk, pairs - c0);
  codes += (long long)blockIdx.z * code_stride;
  uint32_t* s_tbl = reinterpret_cast<uint32_t*>(s_bytes + 2 * tile_bytes);
  const int W = tr.W;
  load_pairs(s_tbl, tr, order, s0, c0, nt, d);
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
    // Pair q's slice and tree, stepped along with q.
    int t = c0 % tr.T;
    int si = s0 + c0 / tr.T;
    for (int p = 0; p < nt; ++p) {
      const uint32_t* node = s_tbl + p * W;
      const uint32_t e0 = node[0];
      uint32_t a[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) a[j] = depth > 0 ? step(e0, row[j]) : 0u;
      for (int l = 1; l < depth; ++l) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) a[j] = step(node[a[j]], row[j]);
      }
      int32_t* o = out + ((long long)order[si] * tr.T + t) * n + r0;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r + j * (int)blockDim.x < rows) o[r + j * blockDim.x] = (int)a[j];
      if (++t == tr.T) {
        t = 0;
        ++si;
      }
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
  const int nt = load_chunk(s_word, tr, d, trees_per_chunk);
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

// Lets `kernel` launch with `smem` bytes of dynamic shared memory. The cap
// it sets is the most the card allows beside the kernel's static shared
// memory, the same for every launch, never this launch's size: host threads
// launch one kernel at different sizes at once (concurrent fits), and a cap
// lowered by one thread between another's set and launch would refuse that
// launch (cudaErrorInvalidValue).
template <typename K>
int prepare_smem(K kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return 0;
  int dev, optin;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  const int cap = optin - (int)attr.sharedSizeBytes;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
}

template <typename CodeT, int kRep>
int launch_hist_kernel(size_t smem, dim3 grid, cudaStream_t stream,
                       const CodeT* codes, const int32_t* code_idx,
                       const float* stats, const float* max_abs,
                       const int32_t* rel, const uint8_t* active,
                       long long* partial, int n, int d, int n_bins, int S,
                       int n_live, int NG, int CG, int n_cgroups,
                       int rows_per_chunk) {
  int e = prepare_smem(hist_slice_kernel<CodeT, kRep>, smem);
  if (e) return e;
  hist_slice_kernel<CodeT, kRep><<<grid, kHistThreads, smem, stream>>>(
      codes, code_idx, stats, max_abs, rel, active, partial, n, d, n_bins, S,
      n_live, NG, CG, n_cgroups, rows_per_chunk);
  return (int)cudaGetLastError();
}

// out is float (G, ...) sums, or with `fixed` the int64 fixed-point totals.
// partial: (B, G, n_live * d*n_bins * S) int64 scratch, B = blocks a
// stream.
template <typename CodeT>
int launch_hist(const CodeT* codes, const int32_t* code_idx,
                const float* stats, const float* max_abs, const int32_t* rel,
                const uint8_t* active, void* out, bool fixed,
                long long* partial, int n, int d, int n_bins, int S,
                int n_nodes, int n_live, int NG, int CG, int rows_per_chunk,
                int B, int replicas, int G, cudaStream_t stream) {
  // A copy takes one row in `replicas` of a chunk: at most
  // kMaxRowsPerChunk of them between flushes.
  if (replicas < 1 ||
      (long long)rows_per_chunk > (long long)kMaxRowsPerChunk * replicas ||
      rows_per_chunk < 1 || G < 1 || G > 65535 || n_live < 1 ||
      n_live > n_nodes || NG < 1 || CG < 1 || B < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int DC = d * n_bins;
  const int n_cgroups = (DC + CG - 1) / CG;
  const long long groups = (long long)(n_live + NG - 1) / NG * n_cgroups;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (unsigned)groups, G);
  const size_t smem = (size_t)NG * CG * S * 2 * sizeof(int32_t) * replicas +
                      (size_t)S * sizeof(float) + kSpareBytes;
  int e;
#define LO_HIST_CASE(R)                                                     \
  case R:                                                                   \
    e = launch_hist_kernel<CodeT, R>(smem, grid, stream, codes, code_idx,   \
                                     stats, max_abs, rel, active, partial,  \
                                     n, d, n_bins, S, n_live, NG, CG,       \
                                     n_cgroups, rows_per_chunk);            \
    break;
  switch (replicas) {
    LO_HIST_CASE(1)
    LO_HIST_CASE(2)
    LO_HIST_CASE(4)
    LO_HIST_CASE(8)
    LO_HIST_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LO_HIST_CASE
  if (e) return e;
  const long long total = (long long)n_nodes * DC * S;
  int Y = 1;
  while (2 * Y <= B && 2 * Y <= kSumMaxSlices &&
         total * G * 2 * Y <= kSumFill)
    Y *= 2;
  const int C = kSumThreads / Y;
  long long tiles = (total * G + C - 1) / C;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (tiles < 1) tiles = 1;
  sum_partials_kernel<<<(unsigned)tiles, dim3(C, Y), 0, stream>>>(
      partial, max_abs, fixed ? nullptr : (float*)out,
      fixed ? (long long*)out : nullptr, total, (long long)n_live * DC * S,
      G, S, B);
  return (int)cudaGetLastError();
}

// The shared-atomic probe, K1's atomics floor (not a kernel of the port's
// paths): each thread adds to 32-bit shared words with ATOMS.ADD, 32 adds
// a round, add u of a round into word (u << 5) + bin of a 1,024-word run
// (32 consecutive words, one a bank). kRandom: a pseudo-random bin in
// [0, 32) per lane and add, K1's pattern (a warp's rows land on random
// bins); else bin = lane, one bank a lane, conflict-free. The adds take
// the word address as a register plus a constant, so the loop is the
// atomics and a few integer instructions a round; the value added is not
// a constant 1, so the compiler keeps ATOMS.ADD.
template <bool kRandom>
__global__ void __launch_bounds__(kHistThreads) atoms_probe_kernel(
    int rounds, uint32_t* __restrict__ sink) {
  __shared__ uint32_t acc[32 * 32];
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t v = lane | 2u;
  uint32_t x = 2654435761u * (blockIdx.x * blockDim.x + threadIdx.x) + 1u;
  for (int r = 0; r < rounds; ++r) {
    uint32_t b[8];
    if (kRandom) {
      x ^= x << 13;
      x ^= x >> 17;
      x ^= x << 5;
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = (x >> (3 * j)) & 31u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = lane;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) atomicAdd(&acc[(u << 5) + b[u & 7]], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x)
    if (acc[i] == 0xFFFFFFFFu) sink[0] = (uint32_t)i;
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
// rel (G, n) int32 in [0, n_live) for every active row, active (G, n)
// bool -> out (G, n_nodes, d, n_bins, S) f32. The plan (ops/tree_kernels.py
// hist_plan and hist_grid): node groups of NG of the n_live nodes, column
// groups of CG, row chunks of rows_per_chunk <= 2^17 rows, B persistent
// blocks a stream, `replicas` copies of the shared slice; partial:
// (B, G, n_live*d*n_bins*S) int64 scratch.
int lo_tree_hist_u8(const void* codes, const void* code_idx,
                    const void* stats, const void* max_abs, const void* rel,
                    const void* active, void* out, void* partial, int n,
                    int d, int n_bins, int S, int n_nodes, int n_live, int NG,
                    int CG, int rows_per_chunk, int B, int replicas, int G,
                    void* stream) {
  return launch_hist<uint8_t>(
      (const uint8_t*)codes, (const int32_t*)code_idx, (const float*)stats,
      (const float*)max_abs, (const int32_t*)rel, (const uint8_t*)active,
      out, false, (long long*)partial, n, d, n_bins, S, n_nodes, n_live, NG,
      CG, rows_per_chunk, B, replicas, G, (cudaStream_t)stream);
}

// lo_tree_hist_u8 with out (G, n_nodes, d, n_bins, S) int64: each stat's
// fixed-point total at the scale of max_abs, before the conversion.
int lo_tree_hist_u8_fixed(const void* codes, const void* code_idx,
                          const void* stats, const void* max_abs,
                          const void* rel, const void* active, void* out,
                          void* partial, int n, int d, int n_bins, int S,
                          int n_nodes, int n_live, int NG, int CG,
                          int rows_per_chunk, int B, int replicas, int G,
                          void* stream) {
  return launch_hist<uint8_t>(
      (const uint8_t*)codes, (const int32_t*)code_idx, (const float*)stats,
      (const float*)max_abs, (const int32_t*)rel, (const uint8_t*)active,
      out, true, (long long*)partial, n, d, n_bins, S, n_nodes, n_live, NG,
      CG, rows_per_chunk, B, replicas, G, (cudaStream_t)stream);
}

// K1, leaf form, G slices: the row's node id is its only "feature" code
// and every row is active in the single node group: assign (G, n) int32,
// stats (G, S, n), max_abs (G, S) -> out (G, n_leaf_ids, S) f32 (the caller
// transposes to (G, S, M)).
int lo_tree_leaf_i32(const void* assign, const void* stats,
                     const void* max_abs, void* out, void* partial, int n,
                     int n_ids, int S, int CG, int rows_per_chunk, int B,
                     int replicas, int G, void* stream) {
  return launch_hist<int32_t>(
      (const int32_t*)assign, nullptr, (const float*)stats,
      (const float*)max_abs, nullptr, nullptr, out, false,
      (long long*)partial, n, 1, n_ids, S, 1, 1, 1, CG, rows_per_chunk, B,
      replicas, G, (cudaStream_t)stream);
}

// lo_tree_leaf_i32 with out (G, n_leaf_ids, S) int64 fixed-point totals.
int lo_tree_leaf_i32_fixed(const void* assign, const void* stats,
                           const void* max_abs, void* out, void* partial,
                           int n, int n_ids, int S, int CG,
                           int rows_per_chunk, int B, int replicas, int G,
                           void* stream) {
  return launch_hist<int32_t>(
      (const int32_t*)assign, nullptr, (const float*)stats,
      (const float*)max_abs, nullptr, nullptr, out, true,
      (long long*)partial, n, 1, n_ids, S, 1, 1, 1, CG, rows_per_chunk, B,
      replicas, G, (cudaStream_t)stream);
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

// codes, P matrices of (n, d) uint8 rows (d bytes apart, the matrices
// code_stride bytes apart) -> out (P, d, n) uint8, K2's feature-major
// codes, in one launch. The plan (ops/tree_kernels.py
// feature_major_plan): feat_tiles feature tiles of kTransFeats,
// row_tiles of kTransRows rows, and smem_bytes of dynamic shared memory
// a block.
int lo_feature_major(const void* codes, long long code_stride, void* out,
                     int n, int d, int P, int feat_tiles, int row_tiles,
                     int smem_bytes, void* stream) {
  if (n < 1 || d < 1 || P < 1 || P > 65535 ||
      feat_tiles != (d + kTransFeats - 1) / kTransFeats ||
      row_tiles != (n + kTransRows - 1) / kTransRows ||
      (long long)feat_tiles * row_tiles > 0x7FFFFFFFLL ||
      smem_bytes < trans_tile_bytes(d) || smem_bytes > kDefaultSmem)
    return (int)cudaErrorInvalidValue;
  feature_major_kernel<<<dim3(feat_tiles * row_tiles, 1, P), kTransThreads,
                         smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, code_stride, (uint8_t*)out, n, d, feat_tiles);
  return (int)cudaGetLastError();
}

// K3, G slices: codes, P matrices of (n, d) uint8 rows code_stride bytes
// apart, code_idx (G,) int32 in [0, P), feat/thr (G, T, M) int32, internal
// (G, T, M) bool -> out (G, T, n) int32 leaf ids, walking `depth` levels
// over tables of W = 2^depth - 1 entries. The plan (ops/tree_kernels.py
// descend_plan): the direct path (rows_per_tile 0; grid (blocks, chunks of
// a slice's trees, G)) or the staged one (grid (blocks, chunks of a
// matrix's (slice, tree) pairs, P), the slices grouped by matrix: order
// (G,) the slices sorted by matrix, first (P + 1,) where each matrix's
// start) with tiles of rows_per_tile = 1, 2 or 4 rows a thread and
// buffers of tile_bytes; per_chunk trees (direct) or pairs (staged) a
// chunk, and blocks a chunk.
int lo_tree_descend(const void* codes, const void* code_idx,
                    const void* order, const void* first,
                    long long code_stride, const void* feat, const void* thr,
                    const void* internal, void* out, int n, int d, int M,
                    int W, int T, int depth, int rows_per_tile,
                    int tile_bytes, int per_chunk, int chunks, int blocks,
                    int G, int P, void* stream) {
  if (G < 1 || G > 65535 || P < 1 || P > 65535 || chunks < 1 ||
      chunks > 65535 || per_chunk < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Trees tr{(const int32_t*)feat, (const int32_t*)thr,
                 (const uint8_t*)internal, M, W, T};
  const size_t tables = (size_t)per_chunk * W * sizeof(uint32_t);
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
    kernel<<<dim3(blocks, chunks, P), kDescendThreads, smem,
             (cudaStream_t)stream>>>(
        (const uint8_t*)codes, code_stride, (const int32_t*)order,
        (const int32_t*)first, tr, (int32_t*)out, n, d, depth, per_chunk,
        tile_bytes);
  } else {
    e = prepare_smem(descend_direct_kernel, tables);
    if (e) return e;
    descend_direct_kernel<<<dim3(blocks, chunks, G), kDescendThreads,
                            tables, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int32_t*)code_idx, code_stride, tr,
        (int32_t*)out, n, d, depth, per_chunk);
  }
  return (int)cudaGetLastError();
}

// The shared-atomic probe: `blocks` blocks of kHistThreads threads, each
// thread 32 * rounds adds; random_bins picks K1's random-bin pattern over
// the conflict-free one. sink: one uint32 the kernel may write.
int lo_atoms_probe(int rounds, int random_bins, int blocks, void* sink,
                   void* stream) {
  if (random_bins) {
    atoms_probe_kernel<true><<<blocks, kHistThreads, 0,
                               (cudaStream_t)stream>>>(rounds,
                                                       (uint32_t*)sink);
  } else {
    atoms_probe_kernel<false><<<blocks, kHistThreads, 0,
                                (cudaStream_t)stream>>>(rounds,
                                                        (uint32_t*)sink);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
