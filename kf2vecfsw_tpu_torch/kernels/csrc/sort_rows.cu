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
//   tiles of kTile elements of a row, each pass three launches over the
//   (row, tile) grid: an upsweep counts each tile's digits into (rows, 256,
//   tiles) counts; a scan turns each row's counts, digit-major, into the
//   start of every (digit, tile) run in the sorted row; a downsweep reloads
//   the tile, ranks its items stably by digit with the tile path's block
//   machinery (warp_digit_ranks, scan_digit_warp), stages them in digit
//   order in shared memory and stores each digit's run contiguously (about
//   64 elements a run) from its start. The first pass reads the f32 keys (the
//   column is the index), the last writes the outputs and gathers the
//   payload, so no launch of its own converts the keys or writes the outputs;
//   between them the passes alternate between a scratch of 32-bit keys and
//   columns (rows, n) and the outputs' own storage. No padding: the last
//   tile's items past n rank after the rest and are not stored. Each pass
//   keeps the order of equal digits and the first pass's order is the column,
//   so perm is the tile path's. Traffic: 16 B an element in the first pass,
//   20 in the middle two, 24 in the last (80 in all, 5x the 16 B of the
//   bound).

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
constexpr int kUpThreads = 512;                   // threads of a radix upsweep block
constexpr int kUpItems = kTile / kUpThreads;      // keys each of them counts
constexpr int kScanThreads = 1024;                // threads of a radix scan block
constexpr int kRadixPasses = 32 / kRadixBits;
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

// n > kClusterElems, step 1 of a radix pass: block (row, tile) counts the
// digits (key >> shift) & 255 of the tile's keys (on the first pass the
// f32 keys as ordered()) into counts[row][digit][tile], one shared-memory
// counter row per warp. Every key is loaded before any is counted.
template <bool kFirst>
__global__ void __launch_bounds__(kUpThreads)
radix_upsweep_kernel(const uint32_t* __restrict__ keys, uint32_t* __restrict__ counts, int64_t n,
                     int64_t n_tiles, int shift) {
  constexpr int kWarps = kUpThreads / 32;
  __shared__ uint32_t hist[kWarps * kRadix];
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kUpThreads) hist[i] = 0;
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t tile = blockIdx.x - row * n_tiles;
  const int64_t base = tile * kTile;
  const int n_valid = n - base < kTile ? static_cast<int>(n - base) : kTile;
  const uint32_t* in = keys + row * n + base;
  uint32_t v[kUpItems];
#pragma unroll
  for (int m = 0; m < kUpItems; ++m) {
    const int j = threadIdx.x + m * kUpThreads;
    v[m] = j < n_valid ? __ldg(in + j) : 0u;
  }
  __syncthreads();
  uint32_t* whist = hist + (threadIdx.x >> 5) * kRadix;
#pragma unroll
  for (int m = 0; m < kUpItems; ++m) {
    if (threadIdx.x + m * kUpThreads < n_valid) {
      const uint32_t k = kFirst ? ordered(__uint_as_float(v[m])) : v[m];
      atomicAdd(&whist[(k >> shift) & (kRadix - 1)], 1u);
    }
  }
  __syncthreads();
  if (threadIdx.x < kRadix) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hist[w * kRadix + threadIdx.x];
    counts[(row * kRadix + threadIdx.x) * n_tiles + tile] = sum;
  }
}

// n > kClusterElems, step 2 of a radix pass: block r turns row r's `len`
// counts, (digit, tile) in digit-major order, into their exclusive prefix
// sums in place: where tile t's run of digit d starts in the sorted row.
// Each thread sums a stretch of them, the block scans the threads' sums.
__global__ void __launch_bounds__(kScanThreads)
radix_scan_kernel(uint32_t* __restrict__ counts, int64_t len) {
  __shared__ uint32_t wsum[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* c = counts + blockIdx.x * len;
  const int64_t per = (len + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per < len ? threadIdx.x * per : len;
  const int64_t hi = lo + per < len ? lo + per : len;
  uint32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += c[i];
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = wsum[lane];
    uint32_t winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc += y;
    }
    wsum[lane] = winc - w;
  }
  __syncthreads();
  uint32_t run = wsum[warp] + incl - sum;
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t v = c[i];
    c[i] = run;
    run += v;
  }
}

// n > kClusterElems, step 3 of a radix pass: block (row, tile) ranks the
// tile's items stably by digit in shared memory (one pass of
// block_radix_sort over 32-bit columns), stages them in that order and
// stores each digit's run, contiguous, from where the scan placed it in
// the row. Items past n are padding (largest key), which ranks after every
// item of the tile. On the first pass the keys are the f32 keys, as
// ordered(), and the columns implicit; a middle pass writes the ordered
// keys and their columns to out_keys and out_index; the last (kLast)
// writes the function's outputs: out_keys as floats, out_index as perm, and
// the payload row (row / group) gathered by column.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kMaxThreads, 1)
radix_downsweep_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ index,
                       const uint32_t* __restrict__ offsets, uint32_t* __restrict__ out_keys,
                       uint32_t* __restrict__ out_index, const float* __restrict__ payload,
                       float* __restrict__ out_payload, int64_t n, int64_t n_tiles, int shift,
                       int64_t group) {
  using L = Layout<kMaxThreads>;
  extern __shared__ uint4 smem_raw[];
  const L s(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t tile = blockIdx.x - row * n_tiles;
  const int64_t base = tile * kTile;
  const int n_valid = n - base < kTile ? static_cast<int>(n - base) : kTile;
  const int64_t in0 = row * n + base;
  const int first = warp * 32 * kItems + lane;  // item i is element first + 32 i
  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + 32 * i;
    const uint32_t v = j < n_valid ? __ldcs(keys + in0 + j) : 0u;
    key[i] = j >= n_valid ? 0xFFFFFFFFu : kFirst ? ordered(__uint_as_float(v)) : v;
  }
  uint32_t* wcount = s.counts + warp * kRadix;
  uint32_t* wmask = s.masks + warp * kRadix;
  for (int c = lane; c < kRadix; c += 32) wmask[c] = 0;
  uint32_t rank[kItems / 2];
  warp_digit_ranks<kItems>(key, shift, wcount, wmask, rank);
  scan_digit_warp<kMaxThreads>(s);
  // per digit: its run's start in the row less its start in the tile (warp
  // 0's offset), in the spent mask rows
  int32_t* to = reinterpret_cast<int32_t*>(s.masks);
  if (threadIdx.x < kRadix) {
    to[threadIdx.x] = static_cast<int32_t>(offsets[(row * kRadix + threadIdx.x) * n_tiles + tile]) -
                      static_cast<int32_t>(s.counts[threadIdx.x]);
  }
  uint32_t* staged = reinterpret_cast<uint32_t*>(s.index);  // index and spare: kCap columns
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = first + 32 * i;
    const uint32_t d = (key[i] >> shift) & (kRadix - 1);
    const uint32_t at = wcount[d] + ((rank[i / 2] >> (16 * (i % 2))) & 0xFFFFu);
    s.keys[at] = key[i];
    staged[at] = kFirst ? static_cast<uint32_t>(base + j) : (j < n_valid ? __ldcs(index + in0 + j) : 0u);
  }
  __syncthreads();
  const int64_t out0 = row * n;
  const float* prow = payload + (row / group) * n;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = threadIdx.x + m * kMaxThreads;
    if (j < n_valid) {
      const uint32_t k = s.keys[j];
      const int64_t at = out0 + to[(k >> shift) & (kRadix - 1)] + j;
      const uint32_t idx = staged[j];
      if (kLast) {
        __stcs(reinterpret_cast<float*>(out_keys) + at, unordered(k));
        __stcs(reinterpret_cast<int32_t*>(out_index) + at, static_cast<int32_t>(idx));
        __stcs(out_payload + at, __ldg(prow + idx));
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
// sort_rows_launch, and the scratch keys and columns, (rows, n) each, and
// the digit counts, (rows, 256, n_tiles).
struct RadixArgs {
  const float* keys;
  const float* payload;
  float* out_keys;
  float* out_payload;
  int32_t* perm;
  uint32_t* scratch_keys;
  uint32_t* scratch_index;
  uint32_t* counts;
  int64_t rows, n, group, n_tiles;
};

// Step `step` (0 upsweep, 1 scan, 2 downsweep) of radix pass `pass` (0 to 3,
// digit 8 pass from the lowest). The passes alternate between the scratch
// and the outputs' storage (out_keys' bits, perm): pass 0 reads the f32
// keys and writes the scratch, pass 1 the outputs' storage, pass 2 the
// scratch, and pass 3 the outputs themselves.
cudaError_t radix_step(const RadixArgs& a, int pass, int step, cudaStream_t s) {
  const int shift = pass * kRadixBits;
  uint32_t* out_bits = reinterpret_cast<uint32_t*>(a.out_keys);
  uint32_t* perm_bits = reinterpret_cast<uint32_t*>(a.perm);
  const uint32_t* in_keys = pass == 0 ? reinterpret_cast<const uint32_t*>(a.keys)
                            : pass == 2 ? out_bits : a.scratch_keys;
  const uint32_t* in_index = pass == 2 ? perm_bits : a.scratch_index;
  uint32_t* to_keys = pass % 2 ? out_bits : a.scratch_keys;
  uint32_t* to_index = pass % 2 ? perm_bits : a.scratch_index;
  const unsigned blocks = static_cast<unsigned>(a.rows * a.n_tiles);
  constexpr int smem = Layout<kMaxThreads>::kBytes;
  if (step == 0) {
    if (pass == 0) {
      radix_upsweep_kernel<true><<<blocks, kUpThreads, 0, s>>>(in_keys, a.counts, a.n, a.n_tiles,
                                                               shift);
    } else {
      radix_upsweep_kernel<false><<<blocks, kUpThreads, 0, s>>>(in_keys, a.counts, a.n, a.n_tiles,
                                                                shift);
    }
  } else if (step == 1) {
    radix_scan_kernel<<<static_cast<unsigned>(a.rows), kScanThreads, 0, s>>>(a.counts,
                                                                          kRadix * a.n_tiles);
  } else if (pass == 0) {
    radix_downsweep_kernel<true, false><<<blocks, kMaxThreads, smem, s>>>(
        in_keys, nullptr, a.counts, to_keys, to_index, a.payload, a.out_payload, a.n, a.n_tiles,
        shift, a.group);
  } else if (pass < kRadixPasses - 1) {
    radix_downsweep_kernel<false, false><<<blocks, kMaxThreads, smem, s>>>(
        in_keys, in_index, a.counts, to_keys, to_index, a.payload, a.out_payload, a.n, a.n_tiles,
        shift, a.group);
  } else {
    radix_downsweep_kernel<false, true><<<blocks, kMaxThreads, smem, s>>>(
        in_keys, in_index, a.counts, to_keys, to_index, a.payload, a.out_payload, a.n, a.n_tiles,
        shift, a.group);
  }
  return cudaGetLastError();
}

// Checks the radix path's arguments and admits the downsweep's shared memory.
cudaError_t radix_prepare(RadixArgs& a) {
  if (a.scratch_keys == nullptr || a.scratch_index == nullptr || a.counts == nullptr) {
    return cudaErrorInvalidValue;
  }
  a.n_tiles = (a.n + kTile - 1) / kTile;
  if (a.rows > INT_MAX / a.n_tiles) return cudaErrorInvalidValue;
  constexpr int smem = Layout<kMaxThreads>::kBytes;
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

// n > kClusterElems through device memory: the radix passes' 12 launches.
cudaError_t launch_radix(RadixArgs a, cudaStream_t s) {
  cudaError_t err = radix_prepare(a);
  for (int pass = 0; pass < kRadixPasses && err == cudaSuccess; ++pass) {
    for (int step = 0; step < 3 && err == cudaSuccess; ++step) err = radix_step(a, pass, step, s);
  }
  return err;
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
// 256 * ceil(n / kTile)), needed only when n > kClusterElems.
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

  return static_cast<int>(launch_radix(
      RadixArgs{k, p, ok, op, pm, static_cast<uint32_t*>(scratch_keys),
                static_cast<uint32_t*>(scratch_index), static_cast<uint32_t*>(counts), rows, n,
                group, 0},
      s));
}

// One step of the radix path (n > kClusterElems) alone: step `step` (0
// upsweep, 1 scan, 2 downsweep) of pass `pass` (0 to 3), so that a timing
// can put events between the 12 launches sort_rows_launch makes. Called in
// that order on the same buffers it computes what sort_rows_launch does.
// Arguments as sort_rows_launch's.
int sort_rows_radix_step(const void* keys, const void* payload, void* out_keys, void* out_payload,
                         void* perm, void* scratch_keys, void* scratch_index, void* counts,
                         int64_t rows, int64_t n, int64_t payload_rows, int pass, int step,
                         void* stream) {
  if (!valid_shape(rows, n, payload_rows) || n <= kClusterElems || pass < 0 ||
      pass >= kRadixPasses || step < 0 || step > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RadixArgs a{static_cast<const float*>(keys), static_cast<const float*>(payload),
              static_cast<float*>(out_keys), static_cast<float*>(out_payload),
              static_cast<int32_t*>(perm), static_cast<uint32_t*>(scratch_keys),
              static_cast<uint32_t*>(scratch_index), static_cast<uint32_t*>(counts), rows, n,
              rows / payload_rows, 0};
  cudaError_t err = radix_prepare(a);
  if (err == cudaSuccess) err = radix_step(a, pass, step, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
