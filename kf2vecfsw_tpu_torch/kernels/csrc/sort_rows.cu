// Row sort with a gathered payload, for Hopper (sm_90a).
//
// Stands in for the JAX package's row sorts:
//   kf2vecfsw_tpu/kernels/sort.py  _bitonic_kernel via sort_rows (B3, Pallas)
//   kf2vecfsw_tpu/models/fsw.py:65,75,120,131  the lax.sort calls of the FSW
//   embedding, which sort (projections, weights[, iota]) rows by the keys.
// B3 carries every payload operand through each compare-exchange stage
// with lane rotations. Here the sort moves one 32-bit key and one 16-bit
// tile index per element, whatever the number of payloads, and the payload
// is gathered once at the end by index. A payload row is shared by
// `rows / payload_rows` consecutive key rows (the FSW path sorts 512 slices
// per genome against one weight row), so it is read, not broadcast.
//
// Function: for each row r of keys (rows, n) f32, with g = rows / payload_rows,
//   perm[r, :]          = the columns of keys[r] in ascending key order,
//   sorted_keys[r, j]    = keys[r, perm[r, j]],
//   sorted_payload[r, j] = payload[r / g, perm[r, j]].
// The order is that of f2i_keys (models/fsw.py): float bits mapped to a
// monotone integer, so -0.0 < +0.0. Equal keys come out in index order (the
// sort is stable), so perm is fully determined, ties included.
//
// Bound on an H100 SXM: memory. The least traffic per element is 4 B of key
// read plus 4 B key + 4 B payload + 4 B perm written, and the payload read
// (4 B per element of the payload_rows rows) is negligible when
// payload_rows << rows: about 16 B per element over 3.35 TB/s, 0.32 ms for
// 8,192 rows of 8,192 and 1.29 ms for 8,192 rows of 32,896. The operations
// (about n log2 n compares a row, or a few tens of integer instructions per
// element and radix pass) over the card's 16.7 T integer operations/s stay
// below that.
//
// Design:
// - n <= kTile (16,384): one block of the smallest power of two >= 32 of
//   threads with threads * kItems >= n (512 at n = 8,192) sorts one row in
//   shared memory with an LSD radix sort of the 32-bit ordered keys, 4
//   passes of 8-bit digits. A thread holds kItems keys in registers, in a
//   warp-striped order (item i of lane l of warp w is element
//   (w * kItems + i) * 32 + l), so the first load is coalesced. Each pass:
//   every warp counts its items' digits into its own 256-bin row in shared
//   memory, and each item learns its order among the items of its warp
//   with its digit; one exclusive scan over (digit, warp) turns the counts
//   into offsets; keys and 16-bit tile indices scatter to their ranks and
//   the keys are read back in the same striped order. The pass keeps the
//   order of equal digits, so the sort is stable. Per row the passes move
//   a few tens of bytes of shared memory per element, against 91 x 16 B
//   for a bitonic network at n = 8,192; what bounds them is the shared
//   memory pipe, through the bank conflicts of random digits in the
//   counting and the scatter. The last pass leaves the sorted row in
//   shared memory; the payload row is staged in the key buffer and
//   gathered from there.
// - kTile < n <= kClusterElems (131,072: the k = 8 and k = 9 point sets and
//   the shared-vocab sorts at V = 32,896 and 131,072): one row per thread
//   block cluster of C = ceil(n / 17,408) blocks of 1024 threads (1 to 8,
//   8 the portable cluster size), sorted in distributed shared memory. This path stands in
//   for the same B3 sort at long rows: one SM's 227 KB of shared memory
//   does not hold such a row with its indices, a cluster's does. Block b
//   holds columns [b cap, (b + 1) cap) of the row, cap = 1024 threads times
//   the fewest items a thread (9 to 17) with C cap >= n (at V = 32,896: 2
//   blocks of 17,408), so only the last block holds padding (largest key,
//   index >= n), fewer than C * 1024 elements. The same LSD radix sort runs
//   across the cluster: each block counts its digits per warp as the tile
//   path does and publishes its 256 digit totals; after a cluster barrier
//   every block reads the C totals through distributed shared memory and
//   knows the offset of each of its (digit, warp) groups in the whole row
//   (blocks in column order, so the pass stays stable); each item is stored,
//   key and 32-bit index, straight into the shared memory of the block that
//   owns its rank; after a second barrier each block reads its ranks back.
//   The row is read once and the outputs written once: the 16 B an element of
//   the bound, no scratch and no pass through device memory. What is left, by
//   the clock64 breakdown of profile_sort_rows.py on an H100 at 8,192 rows of
//   32,896: the warp-private counting (with the read-back) and the scatter of
//   the pairs about a third of the time each, the output a fifth, the two
//   cluster barriers a tenth. The scatter costs per store, alike into a peer
//   and into the block itself: it is the shared memory pipe, through the bank
//   conflicts of random ranks, as in the tile path. Fewer, fuller blocks are
//   faster: one 8-byte pair a store beats a key and an index stored apart,
//   1024 threads beat 768 (more warps, less padding), and 2 blocks of 17
//   items beat 3 of 11 at V = 32,896 (less of the row crosses to a peer, and
//   the card holds 66 two-block clusters on all 132 SMs against 39
//   three-block ones on 117), though at 64 registers a thread more items
//   spill more.
//   Staging a block's items in digit order so that warps store runs,
//   explicit st.shared::cluster stores, 512-thread blocks two to an SM and
//   __match_any_sync in place of the lane masks gained nothing or lost.
// - n > kClusterElems (per-genome point sets at k >= 10 only): an LSD radix
//   sort through device memory, the same 4 passes of 8-bit digits over
//   tiles of kRadixTile (8,192) elements of a row, in 6 launches (Adinets
//   and Merrill's Onesweep, 2022). A histogram launch reads the f32 keys
//   once and counts all four digits of every row; a scan launch turns each
//   row's counts into where each digit's run starts in the sorted row, a
//   pass at a time; then one downsweep a pass. A downsweep block takes the
//   next tile of its row from a counter, loads it, ranks its items stably by
//   digit with the tile path's block machinery (warp_digit_ranks,
//   scan_digit_warp at 512 threads), publishes the tile's digit counts,
//   stages the items in digit order in shared memory, and finds where its
//   run of each digit starts by a decoupled look-back over the row's earlier
//   tiles: each tile publishes its counts (A) and, once it knows the sum
//   over every earlier tile, that inclusive sum (P), and a tile adds its
//   predecessors' entries back to the first P. The counter hands a row's
//   tiles out in the order their blocks start, so every tile a block waits
//   on is held by a running block, and the look-back always ends. Each
//   digit's run (about 32 elements) is stored contiguously from its start.
//   The first pass reads the f32 keys (the column is the index), the last
//   writes the outputs and gathers the payload; between them the passes
//   alternate between a scratch of 32-bit keys and columns (rows, n) and the
//   outputs' own storage. No padding: the last tile's items past n rank
//   after the rest and are not stored. Each pass keeps the order of equal
//   digits and the first pass's order is the column, so perm is the tile
//   path's. A downsweep block of 512 threads needs 100 KB of shared memory,
//   so two run on every SM, each with its own tile in flight.
//   Traffic: 4 B an element for the histogram, 12 in the first pass, 16 in
//   the middle two, 20 in the last: 68 in all, 4.25x the 16 B of the bound
//   (6.7 ms at 512 rows of 646,000 at 3.35 TB/s; the sort takes 12.8 ms
//   there on an H100, its downsweeps about 2.1 TB/s in the middle passes
//   and 1.4 TB/s in the last, whose payload gather reads a 32 B sector of
//   L2 for each 4 B). Per block and tile of a middle pass, by clock64
//   marks: the load and the ranking 31%, the staging with the columns'
//   loads 34%, the stores 16%, the look-back 11%.
//   Measured and left (512 x 646,000, against 16.0 ms for 12 launches over
//   tiles of 16,384, one block an SM): the same 12 launches at tiles of
//   8,192, two blocks an SM, 15.8 ms (the two blocks load, rank and store
//   in step; staggering their start changes nothing); persistent blocks,
//   one an SM, that take tiles two ahead and prefetch them, 29.5 ms (a
//   tile waits for tiles that blocks have taken but not started); a block
//   that walks a run of a row's tiles with running offsets and no
//   look-back, 18.9 ms with one block of 1,024 threads an SM and the next
//   tile in flight, 22.7 ms with two blocks of 512 (probably because a
//   digit's run and its neighbour in the next tile are then stored far
//   apart in time, too late for L2 to merge their partial sectors; in this
//   design neighbouring tiles run at once); the columns copied ahead with
//   cp.async, the look-back started before the other warps finish staging
//   and 8 entries a step, 13.0 ms (no gain); the last pass's gathers issued
//   before its stores, 14.1 ms.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kItems = 16;                        // keys a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kTile = kMaxThreads * kItems;       // 16,384: a row a block sorts
constexpr int kMaxCluster = 8;                    // the portable cluster size
constexpr int kClusterThreads = 1024;             // threads of a cluster's block
constexpr int kClusterItems = 17;                 // the most keys such a thread holds
constexpr int kClusterElems = kMaxCluster * kTile;  // 131,072: a row a cluster sorts
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kRadixPasses = 32 / kRadixBits;
constexpr int kRadixThreads = 512;                // threads of a radix downsweep block
constexpr int kRadixTile = kRadixThreads * kItems;  // 8,192: a tile a downsweep block ranks
constexpr int kHistThreads = 256;                 // threads of a radix histogram block
constexpr int kHistUnroll = 8;                    // keys each of them loads before counting
constexpr int64_t kHistTiles = 16;                // tiles a radix histogram block counts
constexpr int kScanThreads = kRadixPasses * kRadix;  // a radix scan block: a thread a (pass, digit)
constexpr int kLookBack = 4;                      // earlier tiles' entries a look-back step reads
constexpr uint32_t kValueMask = (1u << 30) - 1;   // a look-back entry: 2 bits of state, 30 of count
constexpr int64_t kMaxN = int64_t(1) << 30;      // columns and perm are int32
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Shared memory of a block of kThreads threads: the keys of kCap elements,
// a 256-bin counter row and a 256-bin lane-mask row per warp, the digit
// sums of the scan (kGroups threads share a digit), skewed by one word in
// 32 so that the scanning warp reads them without bank conflicts, and two
// buffers of tile indices, which a pass reads from one and scatters into
// the other.
template <int kThreads>
struct Layout {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCap = kThreads * kItems;
  static constexpr int kGroups = kThreads >= kRadix ? kThreads / kRadix : 1;
  static constexpr int kGroupWarps = kWarps / kGroups;
  static constexpr int kDigitsPerThread = kThreads >= kRadix ? 1 : kRadix / kThreads;
  static constexpr int kSums = kRadix * kGroups;
  static constexpr int kBytes =
      kCap * 4 + 2 * kWarps * kRadix * 4 + (kSums + kSums / 32) * 4 + kCap * 4;
  uint32_t* keys;
  uint32_t* counts;
  uint32_t* masks;
  uint32_t* sums;
  uint16_t* index;  // the sorted row's tile indices, once sorted
  uint16_t* spare;
  __device__ explicit Layout(void* raw)
      : keys(static_cast<uint32_t*>(raw)),
        counts(keys + kCap),
        masks(counts + kWarps * kRadix),
        sums(masks + kWarps * kRadix),
        index(reinterpret_cast<uint16_t*>(sums + kSums + kSums / 32)),
        spare(index + kCap) {}
  __device__ static int skew(int i) { return i + (i >> 5); }
};

// This thread's items of a row of kThreads * kItems elements, of which
// those at or past n_valid are padding (largest key), in the warp-striped
// order: item i of lane l of warp w is element (w * kItems + i) * 32 + l.
template <int kThreads>
__device__ __forceinline__ void load_items(const float* __restrict__ row, int n_valid,
                                           uint32_t (&key)[kItems]) {
  const int first = (threadIdx.x >> 5) * 32 * kItems + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + 32 * i;
    key[i] = j < n_valid ? ordered(__ldcs(row + j)) : 0xFFFFFFFFu;
  }
}

// The rank of each of this thread's kIt items (in the warp-striped order)
// among the items of its warp with its digit (key >> shift) & 255, in the
// half i % 2 of rank[i / 2], and the warp's digit counts in wcount. The
// lanes with one digit find each other through a shared-memory mask (an
// atomicOr each; faster here than __match_any_sync or one ballot per digit
// bit); the lowest of them adds their number to the count, clears the mask
// and hands the count before the add to the others. A warp zeroes, fills
// and reads back its own counter row, so it waits for no other warp;
// wmask is zero between items.
template <int kIt>
__device__ __forceinline__ void warp_digit_ranks(const uint32_t (&key)[kIt], int shift,
                                                 uint32_t* wcount, uint32_t* wmask,
                                                 uint32_t (&rank)[(kIt + 1) / 2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t lt = lanemask_lt();
#pragma unroll
  for (int c = lane; c < kRadix; c += 32) wcount[c] = 0;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const uint32_t d = (key[i] >> shift) & (kRadix - 1);
    atomicOr(&wmask[d], 1u << lane);
    __syncwarp();
    const uint32_t peers = wmask[d];
    __syncwarp();
    const uint32_t before = __popc(peers & lt);
    uint32_t seen = 0;
    if (before == 0) {
      seen = atomicAdd(&wcount[d], __popc(peers));
      wmask[d] = 0;
    }
    seen = __shfl_sync(kFull, seen, __ffs(peers) - 1);
    __syncwarp();
    rank[i / 2] = i % 2 ? rank[i / 2] | ((seen + before) << 16) : seen + before;
  }
}

// Exclusive scan of the warps' digit counts in (digit, warp) order, in
// place: s.counts[w * 256 + d] becomes the first position of warp w's items
// with digit d in the block's stable order by digit (so warp 0's row holds
// where each digit starts). Each thread scans the counts of kGroupWarps
// warps for its digits, one warp scans the (digit, group) sums, and each
// thread adds its sum's offset. Every thread of the block calls it after
// warp_digit_ranks (it synchronises before and after).
template <int kThreads>
__device__ __forceinline__ void scan_digit_warp(const Layout<kThreads>& s) {
  using L = Layout<kThreads>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the digits and warp group whose counts this thread scans
  const int group = kThreads >= kRadix ? threadIdx.x / kRadix : 0;
  const int digit0 = kThreads >= kRadix ? threadIdx.x % kRadix : threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < L::kDigitsPerThread; ++q) {
    const int d = digit0 + q * kThreads;
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < L::kGroupWarps; ++w) {
      uint32_t* c = &s.counts[(group * L::kGroupWarps + w) * kRadix + d];
      const uint32_t v = *c;
      *c = sum;  // the count of this group's earlier warps
      sum += v;
    }
    s.sums[L::skew(d * L::kGroups + group)] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kPerLane = L::kSums / 32;
    uint32_t v[kPerLane];
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      v[q] = s.sums[L::skew(lane * kPerLane + q)];
      sum += v[q];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    uint32_t run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      s.sums[L::skew(lane * kPerLane + q)] = run;
      run += v[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < L::kDigitsPerThread; ++q) {
    const int d = digit0 + q * kThreads;
    const uint32_t base = s.sums[L::skew(d * L::kGroups + group)];
#pragma unroll
    for (int w = 0; w < L::kGroupWarps; ++w) {
      s.counts[(group * L::kGroupWarps + w) * kRadix + d] += base;
    }
  }
  __syncthreads();
}

// Sorts the items load_items gave stably by key; item i of this thread is
// element first + 32 i of the tile. On return s.keys[j] and s.index[j] hold
// the key and the tile index at sorted position j. Every thread of the
// block calls it (it synchronises). The keys stay in registers between
// passes; the tile indices and the ranks mostly stay out of them (a pass
// reads the indices from shared memory where it scatters them; two 16-bit
// ranks share a register): at 64 registers a thread, two blocks of 512
// threads fit on an SM, and more registers would cost that second block.
template <int kThreads>
__device__ __forceinline__ void block_radix_sort(uint32_t (&key)[kItems], const Layout<kThreads>& s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = warp * 32 * kItems + lane;  // item i is element first + 32 i
  uint32_t* wcount = s.counts + warp * kRadix;
  uint32_t* wmask = s.masks + warp * kRadix;  // zero between items
  for (int c = lane; c < kRadix; c += 32) wmask[c] = 0;
  // the rank of item i among the items of its warp with its digit, in the
  // half i % 2 of rank[i / 2]
  uint32_t rank[kItems / 2];

#pragma unroll 1
  for (int shift = 0; shift < 32; shift += kRadixBits) {
    // pass p reads the indices of its items from `in` (pass 0: their
    // positions) and scatters them into `out`; the last pass into s.index
    const uint16_t* in = shift & kRadixBits ? s.spare : s.index;
    uint16_t* out = shift & kRadixBits ? s.index : s.spare;
    warp_digit_ranks<kItems>(key, shift, wcount, wmask, rank);
    scan_digit_warp<kThreads>(s);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = first + 32 * i;
      const uint32_t d = (key[i] >> shift) & (kRadix - 1);
      const uint32_t at = wcount[d] + ((rank[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
      s.keys[at] = key[i];
      out[at] = shift == 0 ? static_cast<uint16_t>(j) : in[j];
    }
    __syncthreads();
    if (shift + kRadixBits < 32) {  // the last pass leaves the sorted row in shared memory
#pragma unroll
      for (int i = 0; i < kItems; ++i) key[i] = s.keys[first + 32 * i];
    }
  }
}

// Writes row `row` of the outputs from the sorted row in shared memory,
// staging its payload row in the key buffer. Every thread of the block calls
// it (it synchronises).
template <int kThreads>
__device__ __forceinline__ void write_row(const Layout<kThreads>& s, int64_t row, int n,
                                          int64_t group, const float* __restrict__ payload,
                                          float* __restrict__ out_keys,
                                          float* __restrict__ out_payload,
                                          int32_t* __restrict__ perm) {
  uint32_t key[kItems];
  uint16_t idx[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = threadIdx.x + m * kThreads;
    key[m] = j < n ? s.keys[j] : 0u;
    idx[m] = j < n ? s.index[j] : 0;
  }
  __syncthreads();
  const float* prow = payload + (row / group) * n;
  float* staged = reinterpret_cast<float*>(s.keys);
  for (int j = threadIdx.x; j < n; j += kThreads) staged[j] = prow[j];
  __syncthreads();
  const int64_t out0 = row * n;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = threadIdx.x + m * kThreads;
    if (j < n) {
      __stcs(out_keys + out0 + j, unordered(key[m]));
      __stcs(perm + out0 + j, static_cast<int32_t>(idx[m]));
      __stcs(out_payload + out0 + j, staged[idx[m]]);
    }
  }
}

// n <= kTile: block r sorts row r (kThreads * kItems >= n).
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kMaxThreads / kThreads)
sort_rows_tile_kernel(const float* __restrict__ keys, const float* __restrict__ payload,
                      float* __restrict__ out_keys, float* __restrict__ out_payload,
                      int32_t* __restrict__ perm, int n, int64_t group) {
  extern __shared__ uint4 smem_raw[];
  const Layout<kThreads> s(smem_raw);
  const int64_t row = blockIdx.x;
  uint32_t key[kItems];
  load_items<kThreads>(keys + row * n, n, key);
  block_radix_sort<kThreads>(key, s);
  write_row<kThreads>(s, row, n, group, payload, out_keys, out_payload, perm);
}

// The radix path's scratch of 32-bit words of one row, after the scratch
// keys and columns: the look-back status, a word a (tile, digit); the
// histogram's partial counts, (block, pass, digit); the digit starts,
// (pass, digit); and the passes' tile counters.
struct RadixShape {
  int64_t n;
  int64_t n_tiles;      // tiles of kRadixTile in a row
  int64_t hist_blocks;  // histogram blocks a row
  int64_t hist_span;    // elements a histogram block counts (whole tiles)
  int64_t words;        // words of a row's scratch
  __host__ __device__ int64_t partials() const { return n_tiles * kRadix; }
  __host__ __device__ int64_t starts() const { return partials() + hist_blocks * kScanThreads; }
  __host__ __device__ int64_t counters() const { return starts() + kScanThreads; }
};

RadixShape radix_shape(int64_t n) {
  RadixShape sh{};
  sh.n = n;
  sh.n_tiles = (n + kRadixTile - 1) / kRadixTile;
  sh.hist_blocks = (sh.n_tiles + kHistTiles - 1) / kHistTiles;
  sh.hist_span = kHistTiles * kRadixTile;
  sh.words = sh.counters() + kRadixPasses;
  return sh;
}

// n > kClusterElems, launch 1: block (row, b) counts the four digits of the
// ordered() f32 keys of its span of row `row` into the row's partial counts
// (b, pass, digit), one shared-memory counter row of 4 x 256 a warp.
__global__ void __launch_bounds__(kHistThreads)
radix_upsweep_kernel_digits(const float* __restrict__ keys, uint32_t* __restrict__ counts,
                            RadixShape sh) {
  constexpr int kWarps = kHistThreads / 32;
  constexpr int kBins = kRadixPasses * kRadix;
  __shared__ uint32_t hist[kWarps * kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kHistThreads) hist[i] = 0;
  __syncthreads();
  const int64_t row = blockIdx.x / sh.hist_blocks;
  const int64_t b = blockIdx.x - row * sh.hist_blocks;
  const int64_t lo = b * sh.hist_span;
  const int64_t hi = lo + sh.hist_span < sh.n ? lo + sh.hist_span : sh.n;
  const float* in = keys + row * sh.n;
  uint32_t* whist = hist + (threadIdx.x >> 5) * kBins;
  for (int64_t j0 = lo + threadIdx.x; j0 < hi; j0 += kHistThreads * kHistUnroll) {
    uint32_t v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t j = j0 + u * kHistThreads;
      v[u] = j < hi ? ordered(__ldg(in + j)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (j0 + u * kHistThreads < hi) {
#pragma unroll
        for (int p = 0; p < kRadixPasses; ++p) {
          atomicAdd(&whist[p * kRadix + ((v[u] >> (p * kRadixBits)) & (kRadix - 1))], 1u);
        }
      }
    }
  }
  __syncthreads();
  uint32_t* out = counts + row * sh.words + sh.partials() + b * kBins;
  for (int q = threadIdx.x; q < kBins; q += kHistThreads) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hist[w * kBins + q];
    out[q] = sum;
  }
}

// n > kClusterElems, launch 2: block `row` sums the row's partial counts
// into each pass's digit totals and turns them into where each digit's run
// starts in the sorted row (exclusive prefix sums over the 256 digits of a
// pass: 8 warps a pass); it clears the row's look-back status and tile
// counters for the downsweeps.
__global__ void __launch_bounds__(kScanThreads)
radix_scan_kernel(uint32_t* __restrict__ counts, RadixShape sh) {
  __shared__ uint32_t wsum[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* c = counts + blockIdx.x * sh.words;
  uint32_t sum = 0;
  for (int64_t b = 0; b < sh.hist_blocks; ++b) {
    sum += c[sh.partials() + b * kScanThreads + threadIdx.x];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // the warp totals, exclusive within each pass's 8 warps
    constexpr int kPassWarps = kRadix / 32;
    const uint32_t w = wsum[lane];
    uint32_t winc = w;
#pragma unroll
    for (int o = 1; o < kPassWarps; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, winc, o, kPassWarps);
      if ((lane & (kPassWarps - 1)) >= o) winc += y;
    }
    wsum[lane] = winc - w;
  }
  __syncthreads();
  c[sh.starts() + threadIdx.x] = wsum[warp] + incl - sum;
  for (int64_t i = threadIdx.x; i < sh.partials(); i += kScanThreads) c[i] = 0;
  if (threadIdx.x < kRadixPasses) c[sh.counters() + threadIdx.x] = 0;
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The state bits of a look-back entry of pass `pass`: A (the tile's own
// count) or P (the sum over the row's tiles up to this one). Every tile
// writes P in every pass, so the codes alternate between even and odd passes
// and a pass's entries need no clearing: zero (the scan's) and the even
// passes' P read as not yet published in an even pass, the odd passes' P
// in an odd one. A P entry that a later tile reads counts at most the
// kRadixTile (t + 1) < n <= 2^30 elements up to it, so 30 bits hold it.
__device__ __forceinline__ uint32_t code_a(int pass) { return (pass & 1 ? 3u : 1u) << 30; }
__device__ __forceinline__ uint32_t code_p(int pass) { return (pass & 1 ? 0u : 2u) << 30; }

// This thread's digit's count in the row's tiles before `tile` (> 0):
// status + t * kRadix is tile t's entry of the digit. Reads kLookBack
// entries at a time, adds them from the nearest back to the first P, and
// reads again from the first that is not yet published.
__device__ __forceinline__ uint32_t look_back(const uint32_t* status, int64_t tile, int pass) {
  const uint32_t a = code_a(pass);
  const uint32_t p = code_p(pass);
  uint32_t sum = 0;
  int64_t t = tile - 1;
  for (;;) {
    uint32_t v[kLookBack];
#pragma unroll
    for (int i = 0; i < kLookBack; ++i) v[i] = t >= i ? load_status(status + (t - i) * kRadix) : p;
    int used = 0;
#pragma unroll
    for (int i = 0; i < kLookBack; ++i) {
      const uint32_t code = v[i] & ~kValueMask;
      if (code != a && code != p) break;
      sum += v[i] & kValueMask;
      if (code == p) return sum;
      ++used;
    }
    t -= used;
  }
}

// n > kClusterElems, launch 3 + pass: block b of row b / n_tiles takes the
// row's next tile from the pass's counter, ranks the tile's items stably by
// digit in shared memory (one pass of block_radix_sort over 32-bit
// columns), publishes the tile's digit counts, stages the items in that
// order, finds by a look-back where its run of each digit starts in the
// row, and stores each run contiguously from there. Items past n are
// padding (largest key), which ranks after every item of the tile. On the
// first pass the keys are the f32 keys, as ordered(), and the columns
// implicit; a middle pass writes the ordered keys and their columns to
// out_keys and out_index; the last (kLast) writes the function's outputs:
// out_keys as floats, out_index as perm, and the payload row (row / group)
// gathered by column.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kRadixThreads, 2)
radix_downsweep_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ index,
                       uint32_t* __restrict__ counts, uint32_t* __restrict__ out_keys,
                       uint32_t* __restrict__ out_index, const float* __restrict__ payload,
                       float* __restrict__ out_payload, RadixShape sh, int pass, int64_t group) {
  using L = Layout<kRadixThreads>;
  extern __shared__ uint4 smem_raw[];
  __shared__ uint32_t taken;
  const L s(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shift = pass * kRadixBits;
  const int64_t row = blockIdx.x / sh.n_tiles;
  uint32_t* status = counts + row * sh.words;  // (tile, digit)
  if (threadIdx.x == 0) taken = atomicAdd(status + sh.counters() + pass, 1u);
  __syncthreads();
  const int64_t tile = taken;
  const int64_t base = tile * kRadixTile;
  const int n_valid = sh.n - base < kRadixTile ? static_cast<int>(sh.n - base) : kRadixTile;
  const int64_t in0 = row * sh.n + base;
  const int first = warp * 32 * kItems + lane;  // item i is element first + 32 i
  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + 32 * i;
    const uint32_t v = j < n_valid ? keys[in0 + j] : 0u;
    key[i] = j >= n_valid ? 0xFFFFFFFFu : kFirst ? ordered(__uint_as_float(v)) : v;
  }
  uint32_t* wcount = s.counts + warp * kRadix;
  uint32_t* wmask = s.masks + warp * kRadix;
  for (int c = lane; c < kRadix; c += 32) wmask[c] = 0;
  uint32_t rank[kItems / 2];
  warp_digit_ranks<kItems>(key, shift, wcount, wmask, rank);
  scan_digit_warp<kRadixThreads>(s);
  // a thread a digit: the digit's start and count in the tile, published
  const int digit = threadIdx.x;
  uint32_t start = 0;
  uint32_t count = 0;
  if (digit < kRadix) {
    start = s.counts[digit];
    count = (digit + 1 < kRadix ? s.counts[digit + 1] : static_cast<uint32_t>(n_valid)) - start;
    store_status(status + tile * kRadix + digit, (tile == 0 ? code_p(pass) : code_a(pass)) | count);
  }
  uint32_t* staged = reinterpret_cast<uint32_t*>(s.index);  // index and spare: kCap columns
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + 32 * i;
    const uint32_t d = (key[i] >> shift) & (kRadix - 1);
    const uint32_t at = wcount[d] + ((rank[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    s.keys[at] = key[i];
    staged[at] = kFirst ? static_cast<uint32_t>(base + j) : (j < n_valid ? index[in0 + j] : 0u);
  }
  // per digit: its run's start in the row less its start in the tile, in
  // the spent mask rows
  int32_t* to = reinterpret_cast<int32_t*>(s.masks);
  __syncthreads();
  if (digit < kRadix) {
    uint32_t before = 0;
    if (tile > 0) {
      before = look_back(status + digit, tile, pass);
      store_status(status + tile * kRadix + digit, code_p(pass) | ((before + count) & kValueMask));
    }
    const uint32_t row_start = status[sh.starts() + pass * kRadix + digit];
    to[digit] = static_cast<int32_t>(row_start + before) - static_cast<int32_t>(start);
  }
  __syncthreads();
  const int64_t out0 = row * sh.n;
  const float* prow = payload + (row / group) * sh.n;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = threadIdx.x + m * kRadixThreads;
    if (j < n_valid) {
      const uint32_t k = s.keys[j];
      const int64_t at = out0 + to[(k >> shift) & (kRadix - 1)] + j;
      const uint32_t idx = staged[j];
      if (kLast) {
        reinterpret_cast<float*>(out_keys)[at] = unordered(k);
        reinterpret_cast<int32_t*>(out_index)[at] = static_cast<int32_t>(idx);
        out_payload[at] = __ldg(prow + idx);
      } else {
        out_keys[at] = k;
        out_index[at] = idx;
      }
    }
  }
}

// Shared memory of one block of a cluster sort, kClusterThreads threads of
// kIt items each: the
// exchange buffer that the cluster's blocks scatter into ((key, 32-bit row
// index) pairs of kCap ranks, one 8-byte store each), a 256-bin counter row
// and a 256-bin lane-mask row per warp, the (digit, group) sums of the scan (kGroups groups of
// kGroupWarps warps, skewed as in Layout), this block's digit totals, which
// the other blocks read, its digits' offsets in the row and the warp totals
// of the scan over digits.
template <int kIt>
struct ClusterLayout {
  static constexpr int kThreads = kClusterThreads;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCap = kThreads * kIt;
  static constexpr int kGroups = kThreads / kRadix;
  static constexpr int kGroupWarps = kWarps / kGroups;
  static constexpr int kSums = kRadix * kGroups;
  static constexpr int kBytes = 2 * kCap * 4 + 2 * kWarps * kRadix * 4 + (kSums + kSums / 32) * 4 +
                                2 * kRadix * 4 + 32 * 4;
  uint2* pairs;
  uint32_t* counts;
  uint32_t* masks;
  uint32_t* sums;
  uint32_t* hist;
  uint32_t* base;
  uint32_t* wsum;
  __device__ explicit ClusterLayout(void* raw)
      : pairs(static_cast<uint2*>(raw)),
        counts(reinterpret_cast<uint32_t*>(pairs + kCap)),
        masks(counts + kWarps * kRadix),
        sums(masks + kWarps * kRadix),
        hist(sums + kSums + kSums / 32),
        base(hist + kRadix),
        wsum(base + kRadix) {}
  __device__ static int skew(int i) { return i + (i >> 5); }
};

// kTile < n <= kClusterElems: the cluster of blocks [row * C, (row + 1) * C)
// sorts row `row`; block b of the cluster starts with columns [b kCap,
// (b + 1) kCap) and ends with the ranks [b kCap, (b + 1) kCap), which it
// writes out. Every pass synchronises the cluster twice: once the digit
// totals are published (so every block has also read back the previous
// pass's ranks, and its exchange buffers may be written), and once every
// item is stored (so every block may read its ranks, and no block leaves
// while a peer still writes to it).
template <int kIt>
__global__ void __launch_bounds__(kClusterThreads, 1)
sort_rows_cluster_kernel(const float* __restrict__ keys, const float* __restrict__ payload,
                         float* __restrict__ out_keys, float* __restrict__ out_payload,
                         int32_t* __restrict__ perm, int n, int64_t group) {
  using L = ClusterLayout<kIt>;
  constexpr int kThreads = L::kThreads;
  extern __shared__ uint4 smem_raw[];
  const L s(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int64_t row = blockIdx.x / blocks;
  const int col0 = me * L::kCap;  // this block's first column
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = warp * 32 * kIt + lane;  // item i is element first + 32 i
  const uint32_t lt = lanemask_lt();
  uint32_t key[kIt];
  uint32_t idx[kIt];
  const float* in = keys + row * n + col0;
  const int valid = n - col0 < L::kCap ? n - col0 : L::kCap;  // the last block's pads after
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int j = first + 32 * i;
    key[i] = j < valid ? ordered(__ldcs(in + j)) : 0xFFFFFFFFu;
    idx[i] = static_cast<uint32_t>(col0 + j);
  }

  uint32_t* wcount = s.counts + warp * kRadix;
  uint32_t* wmask = s.masks + warp * kRadix;  // zero between items
  for (int c = lane; c < kRadix; c += 32) wmask[c] = 0;
  // the digit and warp group whose counts this thread scans
  const int digit = threadIdx.x % kRadix;
  const int grp = threadIdx.x / kRadix;
  // the rank of item i among the items of its warp with its digit, in the
  // half i % 2 of rank[i / 2]
  uint32_t rank[(kIt + 1) / 2];

#pragma unroll 1
  for (int shift = 0; shift < 32; shift += kRadixBits) {
    // warp-private counts and ranks, as in block_radix_sort
#pragma unroll
    for (int c = lane; c < kRadix; c += 32) wcount[c] = 0;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const uint32_t d = (key[i] >> shift) & (kRadix - 1);
      atomicOr(&wmask[d], 1u << lane);
      __syncwarp();
      const uint32_t peers = wmask[d];
      __syncwarp();
      const uint32_t before = __popc(peers & lt);
      uint32_t seen = 0;
      if (before == 0) {
        seen = atomicAdd(&wcount[d], __popc(peers));
        wmask[d] = 0;
      }
      seen = __shfl_sync(kFull, seen, __ffs(peers) - 1);
      __syncwarp();
      rank[i / 2] = i % 2 ? rank[i / 2] | ((seen + before) << 16) : seen + before;
    }
    __syncthreads();
    // each thread: the counts of its group's warps for its digit, exclusive
    // in place, and the group's sum
    {
      uint32_t sum = 0;
#pragma unroll
      for (int w = 0; w < L::kGroupWarps; ++w) {
        uint32_t* c = &s.counts[(grp * L::kGroupWarps + w) * kRadix + digit];
        const uint32_t v = *c;
        *c = sum;
        sum += v;
      }
      s.sums[L::skew(digit * L::kGroups + grp)] = sum;
    }
    __syncthreads();
    // a thread per digit: the groups' sums exclusive in place, and the
    // block's total of the digit published to the cluster
    if (threadIdx.x < kRadix) {
      uint32_t run = 0;
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        uint32_t* c = &s.sums[L::skew(threadIdx.x * L::kGroups + g)];
        const uint32_t v = *c;
        *c = run;
        run += v;
      }
      s.hist[threadIdx.x] = run;
    }
    cluster.sync();
    // a thread per digit: the digit's count in the whole row and in the
    // blocks before this one, then the exclusive scan of the row's counts
    // over the digits (8 warps, their totals through s.wsum)
    uint32_t offset = 0;
    if (threadIdx.x < kRadix) {
      uint32_t total = 0;
      uint32_t earlier = 0;
      for (int b = 0; b < blocks; ++b) {
        const uint32_t v = *cluster.map_shared_rank(s.hist + threadIdx.x, b);
        total += v;
        earlier += b < me ? v : 0;
      }
      uint32_t incl = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) s.wsum[warp] = incl;
      offset = incl - total + earlier;
    }
    __syncthreads();
    if (threadIdx.x < kRadix) {
      for (int w = 0; w < warp; ++w) offset += s.wsum[w];
      s.base[threadIdx.x] = offset;  // not s.hist: a peer may still be reading it
    }
    __syncthreads();
    // each thread: its digit's offset in the row and its group's in the
    // block, added to its group's warp rows
    {
      const uint32_t add = s.base[digit] + s.sums[L::skew(digit * L::kGroups + grp)];
#pragma unroll
      for (int w = 0; w < L::kGroupWarps; ++w) {
        s.counts[(grp * L::kGroupWarps + w) * kRadix + digit] += add;
      }
    }
    __syncthreads();
    // each item to its rank, in the shared memory of the block that owns it
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const uint32_t d = (key[i] >> shift) & (kRadix - 1);
      const uint32_t at = wcount[d] + ((rank[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
      const uint32_t owner = at / L::kCap;
      const uint32_t local = at - owner * L::kCap;
      *cluster.map_shared_rank(s.pairs + local, owner) = make_uint2(key[i], idx[i]);
    }
    cluster.sync();
    if (shift + kRadixBits < 32) {  // the last pass leaves the ranks in shared memory
#pragma unroll
      for (int i = 0; i < kIt; ++i) {
        const uint2 v = s.pairs[first + 32 * i];
        key[i] = v.x;
        idx[i] = v.y;
      }
    }
  }

  const float* prow = payload + (row / group) * n;
  const int64_t out0 = row * n;
#pragma unroll
  for (int m = 0; m < kIt; ++m) {
    const int j = threadIdx.x + m * kThreads;
    if (col0 + j < n) {
      const uint2 v = s.pairs[j];
      __stcs(out_keys + out0 + col0 + j, unordered(v.x));
      __stcs(perm + out0 + col0 + j, static_cast<int32_t>(v.y));
      __stcs(out_payload + out0 + col0 + j, __ldg(prow + v.y));
    }
  }
}

template <int kThreads>
cudaError_t launch_tile(const float* k, const float* p, float* ok, float* op, int32_t* pm,
                        int64_t rows, int n, int64_t group, cudaStream_t s) {
  constexpr int smem = Layout<kThreads>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      sort_rows_tile_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sort_rows_tile_kernel<kThreads><<<static_cast<unsigned>(rows), kThreads, smem, s>>>(
      k, p, ok, op, pm, n, group);
  return cudaGetLastError();
}

// The launch of a cluster sort of `rows` rows of n, kIt items a thread and
// `blocks` blocks a cluster (its grid, shared memory and cluster shape),
// after the attribute that admits its shared memory.
template <int kIt>
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t prepare(int64_t rows, int blocks, cudaStream_t s) {
    constexpr int smem = ClusterLayout<kIt>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(sort_rows_cluster_kernel<kIt>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(static_cast<unsigned>(rows * blocks));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }
  cudaError_t active_clusters(int* active) {
    void (*kernel)(const float*, const float*, float*, float*, int32_t*, int, int64_t) =
        sort_rows_cluster_kernel<kIt>;
    return cudaOccupancyMaxActiveClusters(active, (const void*)kernel, &cfg);
  }
};

template <int kIt>
cudaError_t cluster_occupancy(int blocks, int* active, int64_t* smem_bytes) {
  ClusterLaunch<kIt> launch;
  *smem_bytes = ClusterLayout<kIt>::kBytes;
  const cudaError_t err = launch.prepare(1, blocks, nullptr);
  return err == cudaSuccess ? launch.active_clusters(active) : err;
}

// Launches after checking that the card holds one such cluster at a time.
template <int kIt>
cudaError_t launch_cluster(const float* k, const float* p, float* ok, float* op, int32_t* pm,
                           int64_t rows, int n, int blocks, int64_t group, cudaStream_t s) {
  ClusterLaunch<kIt> launch;
  cudaError_t err = launch.prepare(rows, blocks, s);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = launch.active_clusters(&active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&launch.cfg, sort_rows_cluster_kernel<kIt>, k, p, ok, op, pm, n,
                           group);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster shape of a row of kTile < n <= kClusterElems: the fewest
// blocks of kClusterThreads threads of at most kClusterItems items that
// hold n (1 to 8), each thread with the fewest items that hold n (9 to
// kClusterItems), so the padding stays under C * kClusterThreads.
int cluster_blocks(int64_t n) {
  constexpr int64_t cap = int64_t(kClusterThreads) * kClusterItems;
  return static_cast<int>((n + cap - 1) / cap);
}

int cluster_items(int64_t n) {
  const int64_t per_block = (n + cluster_blocks(n) - 1) / cluster_blocks(n);
  return static_cast<int>((per_block + kClusterThreads - 1) / kClusterThreads);
}

// f(std::integral_constant<int, items>{}) for items = cluster_items(n).
template <typename F>
cudaError_t with_cluster_items(int64_t n, F f) {
  switch (cluster_items(n)) {
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 13: return f(std::integral_constant<int, 13>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 15: return f(std::integral_constant<int, 15>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 17: return f(std::integral_constant<int, 17>{});
    default: return cudaErrorInvalidValue;
  }
}

// The radix path's buffers: the keys, payload and outputs of
// sort_rows_launch, the scratch keys and columns, (rows, n) each, and the
// rest of its scratch, (rows, sh.words) 32-bit words.
struct RadixArgs {
  const float* keys;
  const float* payload;
  float* out_keys;
  float* out_payload;
  int32_t* perm;
  uint32_t* scratch_keys;
  uint32_t* scratch_index;
  uint32_t* counts;
  int64_t rows, group;
  RadixShape sh;
};

constexpr int kRadixSteps = 2 + kRadixPasses;

// Launch `step` of the radix path: 0 the histogram, 1 the scan, 2 + p the
// downsweep of pass p (digit 8 p from the lowest). The passes alternate
// between the scratch and the outputs' storage (out_keys' bits, perm): pass
// 0 reads the f32 keys and writes the scratch, pass 1 the outputs' storage,
// pass 2 the scratch, and pass 3 the outputs themselves.
cudaError_t radix_step(const RadixArgs& a, int step, cudaStream_t s) {
  if (step == 0) {
    radix_upsweep_kernel_digits<<<static_cast<unsigned>(a.rows * a.sh.hist_blocks), kHistThreads, 0,
                                  s>>>(a.keys, a.counts, a.sh);
    return cudaGetLastError();
  }
  if (step == 1) {
    radix_scan_kernel<<<static_cast<unsigned>(a.rows), kScanThreads, 0, s>>>(a.counts, a.sh);
    return cudaGetLastError();
  }
  const int pass = step - 2;
  uint32_t* out_bits = reinterpret_cast<uint32_t*>(a.out_keys);
  uint32_t* perm_bits = reinterpret_cast<uint32_t*>(a.perm);
  const uint32_t* in_keys = pass == 0 ? reinterpret_cast<const uint32_t*>(a.keys)
                            : pass == 2 ? out_bits : a.scratch_keys;
  const uint32_t* in_index = pass == 2 ? perm_bits : a.scratch_index;
  uint32_t* to_keys = pass % 2 ? out_bits : a.scratch_keys;
  uint32_t* to_index = pass % 2 ? perm_bits : a.scratch_index;
  const unsigned blocks = static_cast<unsigned>(a.rows * a.sh.n_tiles);
  constexpr int smem = Layout<kRadixThreads>::kBytes;
  if (pass == 0) {
    radix_downsweep_kernel<true, false><<<blocks, kRadixThreads, smem, s>>>(
        in_keys, nullptr, a.counts, to_keys, to_index, a.payload, a.out_payload, a.sh, pass,
        a.group);
  } else if (pass < kRadixPasses - 1) {
    radix_downsweep_kernel<false, false><<<blocks, kRadixThreads, smem, s>>>(
        in_keys, in_index, a.counts, to_keys, to_index, a.payload, a.out_payload, a.sh, pass,
        a.group);
  } else {
    radix_downsweep_kernel<false, true><<<blocks, kRadixThreads, smem, s>>>(
        in_keys, in_index, a.counts, to_keys, to_index, a.payload, a.out_payload, a.sh, pass,
        a.group);
  }
  return cudaGetLastError();
}

// Checks the radix path's arguments and admits the downsweep's shared memory.
cudaError_t radix_prepare(const RadixArgs& a) {
  if (a.scratch_keys == nullptr || a.scratch_index == nullptr || a.counts == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (a.rows > INT_MAX / a.sh.n_tiles || a.rows > INT_MAX / a.sh.hist_blocks) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Layout<kRadixThreads>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(radix_downsweep_kernel<true, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(radix_downsweep_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(radix_downsweep_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return err;
}

// n > kClusterElems through device memory: the radix path's 6 launches.
cudaError_t launch_radix(const RadixArgs& a, cudaStream_t s) {
  cudaError_t err = radix_prepare(a);
  for (int step = 0; step < kRadixSteps && err == cudaSuccess; ++step) err = radix_step(a, step, s);
  return err;
}

RadixArgs radix_args(const void* keys, const void* payload, void* out_keys, void* out_payload,
                     void* perm, void* scratch_keys, void* scratch_index, void* counts,
                     int64_t rows, int64_t n, int64_t payload_rows) {
  return RadixArgs{static_cast<const float*>(keys), static_cast<const float*>(payload),
                   static_cast<float*>(out_keys), static_cast<float*>(out_payload),
                   static_cast<int32_t*>(perm), static_cast<uint32_t*>(scratch_keys),
                   static_cast<uint32_t*>(scratch_index), static_cast<uint32_t*>(counts), rows,
                   rows / payload_rows, radix_shape(n)};
}

bool valid_shape(int64_t rows, int64_t n, int64_t payload_rows) {
  return rows >= 1 && n >= 1 && n <= kMaxN && payload_rows >= 1 && rows % payload_rows == 0;
}

}  // namespace

extern "C" {

// Elements a block sorts in shared memory: rows longer than this take the
// cluster path (the seam the tests place lengths around).
int64_t sort_rows_tile_elems() { return kTile; }

// Elements a cluster sorts in distributed shared memory: rows longer than
// this take the radix path through device memory.
int64_t sort_rows_cluster_elems() { return kClusterElems; }

// Keys each thread of the tile path holds: a row of n <= kTile elements is
// sorted by the smallest power-of-two block of at least 32 threads with
// threads * sort_rows_items_per_thread() >= n (block seams at 512 * 2^j).
int64_t sort_rows_items_per_thread() { return kItems; }

const char* sort_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The cluster path's shape for rows of n (kTile < n <= kClusterElems) on the
// current device: blocks a cluster, threads a block, items a thread, shared
// memory bytes a block and the clusters the card holds at a time; returns 0,
// or the CUDA error of the attribute or the occupancy query.
int sort_rows_cluster_shape(int64_t n, int64_t* blocks, int64_t* threads, int64_t* items,
                            int64_t* smem_bytes, int64_t* active) {
  if (n <= kTile || n > kClusterElems) return static_cast<int>(cudaErrorInvalidValue);
  const int b = cluster_blocks(n);
  int clusters = 0;
  const cudaError_t err = with_cluster_items(n, [&](auto items) {
    return cluster_occupancy<decltype(items)::value>(b, &clusters, smem_bytes);
  });
  *blocks = b;
  *threads = kClusterThreads;
  *items = cluster_items(n);
  *active = clusters;
  return static_cast<int>(err);
}

// Launches on `stream` without synchronising; returns the first error of
// cudaFuncSetAttribute, the cluster occupancy query or a launch
// (cudaGetLastError()), cudaErrorLaunchOutOfResources if the card holds no
// cluster of the row's shape, 0 on success.
// keys: f32 (rows, n); payload: f32 (payload_rows, n) with rows % payload_rows
// == 0; out_keys, out_payload: f32 (rows, n); perm: int32 (rows, n);
// scratch_keys, scratch_index: 32-bit (rows, n) and counts: 32-bit (rows,
// sort_rows_radix_counts_words(rows, n)), needed only when n > kClusterElems.
int sort_rows_launch(const void* keys, const void* payload, void* out_keys, void* out_payload,
                     void* perm, void* scratch_keys, void* scratch_index, void* counts,
                     int64_t rows, int64_t n, int64_t payload_rows, void* stream) {
  if (!valid_shape(rows, n, payload_rows)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t group = rows / payload_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(keys);
  const float* p = static_cast<const float*>(payload);
  float* ok = static_cast<float*>(out_keys);
  float* op = static_cast<float*>(out_payload);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaError_t err;

  if (n <= kTile) {
    if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int m = static_cast<int>(n);
    if (n <= 32 * kItems) err = launch_tile<32>(k, p, ok, op, pm, rows, m, group, s);
    else if (n <= 64 * kItems) err = launch_tile<64>(k, p, ok, op, pm, rows, m, group, s);
    else if (n <= 128 * kItems) err = launch_tile<128>(k, p, ok, op, pm, rows, m, group, s);
    else if (n <= 256 * kItems) err = launch_tile<256>(k, p, ok, op, pm, rows, m, group, s);
    else if (n <= 512 * kItems) err = launch_tile<512>(k, p, ok, op, pm, rows, m, group, s);
    else err = launch_tile<1024>(k, p, ok, op, pm, rows, m, group, s);
    return static_cast<int>(err);
  }

  if (n <= kClusterElems) {
    const int b = cluster_blocks(n);
    if (rows > INT_MAX / b) return static_cast<int>(cudaErrorInvalidValue);
    const int m = static_cast<int>(n);
    return static_cast<int>(with_cluster_items(n, [&](auto items) {
      return launch_cluster<decltype(items)::value>(k, p, ok, op, pm, rows, m, b, group, s);
    }));
  }

  return static_cast<int>(launch_radix(radix_args(keys, payload, out_keys, out_payload, perm,
                                                  scratch_keys, scratch_index, counts, rows, n,
                                                  payload_rows),
                                       s));
}

// One launch of the radix path (n > kClusterElems) alone: launch `step` (0
// the histogram, 1 the scan, 2 to 5 the downsweeps of passes 0 to 3), so
// that a timing can put events between the 6 launches sort_rows_launch
// makes. Called in that order on the same buffers it computes what
// sort_rows_launch does. Arguments as sort_rows_launch's.
int sort_rows_radix_step(const void* keys, const void* payload, void* out_keys, void* out_payload,
                         void* perm, void* scratch_keys, void* scratch_index, void* counts,
                         int64_t rows, int64_t n, int64_t payload_rows, int step, void* stream) {
  if (!valid_shape(rows, n, payload_rows) || n <= kClusterElems || step < 0 ||
      step >= kRadixSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RadixArgs a = radix_args(keys, payload, out_keys, out_payload, perm, scratch_keys,
                                 scratch_index, counts, rows, n, payload_rows);
  cudaError_t err = radix_prepare(a);
  if (err == cudaSuccess) err = radix_step(a, step, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// 32-bit words of the radix path's counts buffer a row of n (> kClusterElems):
// the look-back status, the histogram's partial counts, the digit starts
// and the tile counters.
int64_t sort_rows_radix_counts_words(int64_t n) { return radix_shape(n).words; }

}  // extern "C"
