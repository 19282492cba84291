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
// 8,192 rows of 8,192. The operations (about n log2 n compares a row, or a
// few tens of integer instructions per element and radix pass) over the
// card's 16.7 T integer operations/s stay below that.
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
// - n > kTile (k = 8 and 9 query point sets, n up to 131,072): the row is
//   padded to the next power of two n_pad with (largest key, index >= n),
//   which sorts after every real element. One block per tile radix-sorts
//   its tile and stores 64-bit (key, global index) pairs to a scratch row
//   in device memory, even tiles ascending and odd tiles descending; then,
//   for each bitonic merge size above kTile, one device-memory pass per
//   stride >= kTile and one shared-memory pass per tile for the strides
//   below it. The last tile pass writes the outputs. The pairs are unique
//   and the tiles hold them in index order on ties, so this path gives the
//   same permutation as the tile path.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 16;                        // keys a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kTile = kMaxThreads * kItems;       // 16,384: a row a block sorts
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxGlobalBlocks = int64_t(1) << 20;
constexpr int64_t kMaxN = int64_t(1) << 30;      // n_pad and indices stay below 2^31
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
  using L = Layout<kThreads>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = warp * 32 * kItems + lane;  // item i is element first + 32 i
  const uint32_t lt = lanemask_lt();
  uint32_t* wcount = s.counts + warp * kRadix;
  uint32_t* wmask = s.masks + warp * kRadix;  // zero between items
  for (int c = lane; c < kRadix; c += 32) wmask[c] = 0;
  // the digits and warp group whose counts this thread scans
  const int group = kThreads >= kRadix ? threadIdx.x / kRadix : 0;
  const int digit0 = kThreads >= kRadix ? threadIdx.x % kRadix : threadIdx.x;
  // the rank of item i among the items of its warp with its digit, in the
  // half i % 2 of rank[i / 2]
  uint32_t rank[kItems / 2];

#pragma unroll 1
  for (int shift = 0; shift < 32; shift += kRadixBits) {
    // pass p reads the indices of its items from `in` (pass 0: their
    // positions) and scatters them into `out`; the last pass into s.index
    const uint16_t* in = shift & kRadixBits ? s.spare : s.index;
    uint16_t* out = shift & kRadixBits ? s.index : s.spare;
    // a warp zeroes, fills and reads back its own counter row until the
    // scan, so it waits for no other warp here
#pragma unroll
    for (int c = lane; c < kRadix; c += 32) wcount[c] = 0;
    __syncwarp();
    // warp-private counts, in item order: each item learns how many items of
    // its warp with its digit come before it. The lanes with one digit find
    // each other through a shared-memory mask (an atomicOr each; faster here
    // than __match_any_sync or one ballot per digit bit); the lowest of them
    // adds their number to the count, clears the mask and hands the count
    // before the add to the others.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
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
    // exclusive scan of the counts in (digit, warp) order: each thread scans
    // the counts of kGroupWarps warps for its digits in place, one warp scans
    // the (digit, group) sums, and each thread adds its sum's offset
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

// n > kTile, step 1: block (row, tile) radix-sorts its tile (blockDim.x ==
// kMaxThreads) and stores (key, global index) pairs to scratch (rows, n_pad),
// descending on odd tiles, as the first bitonic merge above kTile expects.
__global__ void __launch_bounds__(kMaxThreads)
presort_tiles_kernel(const float* __restrict__ keys, uint64_t* __restrict__ scratch, int64_t n,
                     int64_t n_pad, int64_t n_tiles) {
  extern __shared__ uint4 smem_raw[];
  const Layout<kMaxThreads> s(smem_raw);
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t tile = blockIdx.x % n_tiles;
  const int64_t base = tile * kTile;
  const int64_t left = n - base;
  const int n_valid = left <= 0 ? 0 : (left >= kTile ? kTile : static_cast<int>(left));
  uint32_t key[kItems];
  load_items<kMaxThreads>(keys + row * n + (n_valid > 0 ? base : 0), n_valid, key);
  block_radix_sort<kMaxThreads>(key, s);
  uint64_t* out = scratch + row * n_pad + base;
  const bool descending = tile & 1;
  for (int j = threadIdx.x; j < kTile; j += kMaxThreads) {
    const uint64_t pair = (static_cast<uint64_t>(s.keys[j]) << 32) |
                          static_cast<uint64_t>(base + s.index[j]);
    out[descending ? kTile - 1 - j : j] = pair;
  }
}

// The compare-exchange stages of merge size `size`, strides stride0 down to
// 1, on the tile s[0, n) whose first element is element `base` of the padded
// row. Every thread of the block calls it (it synchronises).
__device__ void merge_in_tile(uint64_t* s, int n, int64_t base, int64_t size, int stride0) {
  for (int stride = stride0; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      const int i = 2 * t - (t & (stride - 1));
      const int j = i + stride;
      const bool ascending = ((base + i) & size) == 0;
      const uint64_t a = s[i];
      const uint64_t b = s[j];
      if ((a > b) == ascending) {
        s[i] = b;
        s[j] = a;
      }
    }
    __syncthreads();
  }
}

// n > kTile: one compare-exchange stage (size, stride >= kTile) over
// every row, in device memory.
__global__ void __launch_bounds__(kGlobalThreads)
merge_global_kernel(uint64_t* __restrict__ scratch, int64_t n_pad, int64_t size, int64_t stride,
                    int64_t n_pairs) {
  const int64_t half = n_pad / 2;
  for (int64_t p = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; p < n_pairs;
       p += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = p / half;
    const int64_t t = p - row * half;
    const int64_t i = 2 * t - (t & (stride - 1));
    uint64_t* r = scratch + row * n_pad;
    const bool ascending = (i & size) == 0;
    const uint64_t a = r[i];
    const uint64_t b = r[i + stride];
    if ((a > b) == ascending) {
      r[i] = b;
      r[i + stride] = a;
    }
  }
}

// n > kTile: the strides below kTile of merge size `size`, per tile in
// shared memory; the last merge (size == n_pad) writes the outputs.
__global__ void __launch_bounds__(kMaxThreads)
merge_tiles_kernel(uint64_t* __restrict__ scratch, const float* __restrict__ payload,
                   float* __restrict__ out_keys, float* __restrict__ out_payload,
                   int32_t* __restrict__ perm, int64_t n, int64_t n_pad, int64_t n_tiles,
                   int64_t size, int64_t group) {
  extern __shared__ uint64_t smem[];
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t base = (blockIdx.x % n_tiles) * kTile;
  uint64_t* buf = scratch + row * n_pad + base;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) smem[i] = buf[i];
  __syncthreads();
  merge_in_tile(smem, kTile, base, size, kTile / 2);
  if (size != n_pad) {
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) buf[i] = smem[i];
    return;
  }
  const float* prow = payload + (row / group) * n;
  const int64_t out0 = row * n;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int64_t j = base + i;
    if (j >= n) break;
    const uint64_t c = smem[i];
    const uint32_t idx = static_cast<uint32_t>(c);
    out_keys[out0 + j] = unordered(static_cast<uint32_t>(c >> 32));
    perm[out0 + j] = static_cast<int32_t>(idx);
    out_payload[out0 + j] = prow[idx];
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

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Elements a block sorts in shared memory: rows longer than this take the
// global-merge path (the seam the tests place lengths around).
int64_t sort_rows_tile_elems() { return kTile; }

// Keys each thread of the tile path holds: a row of n <= kTile elements is
// sorted by the smallest power-of-two block of at least 32 threads with
// threads * sort_rows_items_per_thread() >= n (block seams at 512 * 2^j).
int64_t sort_rows_items_per_thread() { return kItems; }

const char* sort_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the first error of
// cudaFuncSetAttribute or a launch (cudaGetLastError()), 0 on success.
// keys: f32 (rows, n); payload: f32 (payload_rows, n) with rows % payload_rows
// == 0; out_keys, out_payload: f32 (rows, n); perm: int32 (rows, n);
// scratch: (rows, next_pow2(n)) 64-bit, needed only when n > kTile.
int sort_rows_launch(const void* keys, const void* payload, void* out_keys, void* out_payload,
                     void* perm, void* scratch, int64_t rows, int64_t n, int64_t payload_rows,
                     void* stream) {
  if (rows < 1 || n < 1 || n > kMaxN || payload_rows < 1 || rows % payload_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_pad = next_pow2(n);
  const int64_t n_tiles = n_pad / kTile;
  if (rows > INT_MAX / n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tile_blocks = static_cast<unsigned>(rows * n_tiles);
  const int presort_smem = Layout<kMaxThreads>::kBytes;
  const int merge_smem = static_cast<int>(kTile * sizeof(uint64_t));
  uint64_t* sc = static_cast<uint64_t*>(scratch);
  err = cudaFuncSetAttribute(presort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             presort_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             merge_smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  presort_tiles_kernel<<<tile_blocks, kMaxThreads, presort_smem, s>>>(k, sc, n, n_pad, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_pairs = rows * (n_pad / 2);
  int64_t global_blocks = (n_pairs + kGlobalThreads - 1) / kGlobalThreads;
  if (global_blocks > kMaxGlobalBlocks) global_blocks = kMaxGlobalBlocks;
  for (int64_t size = 2 * int64_t(kTile); size <= n_pad; size <<= 1) {
    for (int64_t stride = size / 2; stride >= kTile; stride >>= 1) {
      merge_global_kernel<<<static_cast<unsigned>(global_blocks), kGlobalThreads, 0, s>>>(
          sc, n_pad, size, stride, n_pairs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    merge_tiles_kernel<<<tile_blocks, kMaxThreads, merge_smem, s>>>(
        sc, p, ok, op, pm, n, n_pad, n_tiles, size, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
