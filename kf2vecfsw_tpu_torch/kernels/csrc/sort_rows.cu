// Row sort with a gathered payload, for Hopper (sm_90a).
//
// Stands in for the JAX package's row sorts:
//   kf2vecfsw_tpu/kernels/sort.py  _bitonic_kernel via sort_rows (B3, Pallas)
//   kf2vecfsw_tpu/models/fsw.py:65,75,120,131  the lax.sort calls of the FSW
//   embedding, which sort (projections, weights[, iota]) rows by the keys.
// B3 carries every payload operand through each compare-exchange stage
// with lane rotations. Here each element is one 64-bit (key, index) pair:
// the network moves 8 bytes per element whatever the number of payloads,
// and the payload is gathered once at the end by index. A payload row is
// shared by `rows / payload_rows` consecutive key rows (the FSW path sorts
// 512 slices per genome against one weight row), so it is read, not
// broadcast.
//
// Function: for each row r of keys (rows, n) f32, with g = rows / payload_rows,
//   perm[r, :]          = the columns of keys[r] in ascending key order,
//   sorted_keys[r, j]    = keys[r, perm[r, j]],
//   sorted_payload[r, j] = payload[r / g, perm[r, j]].
// The order is that of f2i_keys (models/fsw.py): float bits mapped to a
// monotone integer, so -0.0 < +0.0. The pair (key, index) is unique, so the
// network sees no ties; equal keys come out in index order, which is one of
// the orders an unstable sort may give.
//
// Any n >= 1: a row is padded to the next power of two n_pad with pairs
// (largest key, index >= n), which sort after every real element, and only
// the first n are written.
//
// Bound on an H100 SXM: memory. The least traffic per element is 4 B of key
// read plus 4 B key + 4 B payload + 4 B perm written, and the payload read
// (4 B per element of the payload_rows rows) is negligible when
// payload_rows << rows: about 16 B per element over 3.35 TB/s, 0.32 ms for
// 8,192 rows of 8,192. A bitonic network in shared memory instead moves
// log2(n_pad) * (log2(n_pad) + 1) / 2 stages x 16 B (8 B read and written per
// element per stage) of shared-memory traffic per element: 91 stages at
// n_pad = 8,192, about 1.5 KB per element, and that traffic, with a
// __syncthreads per stage, is what this first version is limited by.
//
// Design:
// - n_pad <= kTile (16,384 pairs = 128 KiB of dynamic shared memory): one
//   block sorts one row in shared memory and writes the outputs.
// - n_pad > kTile (k = 8 and 9 query point sets, n up to 131,072): one block
//   per tile presorts its tile (merge sizes up to kTile, directions from the
//   global index) into a scratch row of pairs in device memory; then, for
//   each merge size above kTile, one global-memory pass per stride >= kTile
//   and one shared-memory pass per tile for the strides below it. The last
//   tile pass writes the outputs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16384;          // pairs a block sorts in shared memory
constexpr int kTileThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int64_t kMaxGlobalBlocks = int64_t(1) << 20;
constexpr int64_t kMaxN = int64_t(1) << 30;  // n_pad and indices stay below 2^31

__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// (key, index) of element i of a row of n keys; i >= n is padding
__device__ __forceinline__ uint64_t load_pair(const float* __restrict__ row, int64_t n, int64_t i) {
  const uint32_t key = i < n ? ordered(row[i]) : 0xFFFFFFFFu;
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(i);
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

__device__ void sort_tile(uint64_t* s, int n, int64_t base) {
  for (int size = 2; size <= n; size <<= 1) merge_in_tile(s, n, base, size, size / 2);
}

// Elements [base, base + n_tile) of the sorted padded row `row`, those below n.
__device__ void write_out(const uint64_t* s, int n_tile, int64_t base, int64_t n, int64_t row,
                          int64_t group, const float* __restrict__ payload,
                          float* __restrict__ out_keys, float* __restrict__ out_payload,
                          int32_t* __restrict__ perm) {
  const float* prow = payload + (row / group) * n;
  const int64_t out0 = row * n;
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const int64_t j = base + i;
    if (j >= n) break;
    const uint64_t c = s[i];
    const uint32_t idx = static_cast<uint32_t>(c);
    out_keys[out0 + j] = unordered(static_cast<uint32_t>(c >> 32));
    perm[out0 + j] = static_cast<int32_t>(idx);
    out_payload[out0 + j] = prow[idx];
  }
}

// n_pad <= kTile: block r sorts row r.
__global__ void __launch_bounds__(kTileThreads)
sort_rows_tile_kernel(const float* __restrict__ keys, const float* __restrict__ payload,
                      float* __restrict__ out_keys, float* __restrict__ out_payload,
                      int32_t* __restrict__ perm, int64_t n, int n_pad, int64_t group) {
  extern __shared__ uint64_t smem[];
  const int64_t row = blockIdx.x;
  const float* krow = keys + row * n;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) smem[i] = load_pair(krow, n, i);
  __syncthreads();
  sort_tile(smem, n_pad, 0);
  write_out(smem, n_pad, 0, n, row, group, payload, out_keys, out_payload, perm);
}

// n_pad > kTile, step 1: block (row, tile) runs merge sizes 2..kTile on its
// tile and stores the pairs to scratch (rows, n_pad).
__global__ void __launch_bounds__(kTileThreads)
presort_tiles_kernel(const float* __restrict__ keys, uint64_t* __restrict__ scratch, int64_t n,
                     int64_t n_pad, int64_t n_tiles) {
  extern __shared__ uint64_t smem[];
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t base = (blockIdx.x % n_tiles) * kTile;
  const float* krow = keys + row * n;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) smem[i] = load_pair(krow, n, base + i);
  __syncthreads();
  sort_tile(smem, kTile, base);
  uint64_t* out = scratch + row * n_pad + base;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) out[i] = smem[i];
}

// n_pad > kTile: one compare-exchange stage (size, stride >= kTile) over
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

// n_pad > kTile: the strides below kTile of merge size `size`, per tile in
// shared memory; the last merge (size == n_pad) writes the outputs.
__global__ void __launch_bounds__(kTileThreads)
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
  if (size == n_pad) {
    write_out(smem, kTile, base, n, row, group, payload, out_keys, out_payload, perm);
  } else {
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) buf[i] = smem[i];
  }
}

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Pairs a block sorts in shared memory: rows longer than this take the
// global-merge path (the seam the tests place lengths around).
int64_t sort_rows_tile_elems() { return kTile; }

const char* sort_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the first error of
// cudaFuncSetAttribute or a launch (cudaGetLastError()), 0 on success.
// keys: f32 (rows, n); payload: f32 (payload_rows, n) with rows % payload_rows
// == 0; out_keys, out_payload: f32 (rows, n); perm: int32 (rows, n);
// scratch: (rows, next_pow2(n)) 64-bit, needed only when next_pow2(n) > kTile.
int sort_rows_launch(const void* keys, const void* payload, void* out_keys, void* out_payload,
                     void* perm, void* scratch, int64_t rows, int64_t n, int64_t payload_rows,
                     void* stream) {
  if (rows < 1 || n < 1 || n > kMaxN || payload_rows < 1 || rows % payload_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_pad = next_pow2(n);
  const int64_t group = rows / payload_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(keys);
  const float* p = static_cast<const float*>(payload);
  float* ok = static_cast<float*>(out_keys);
  float* op = static_cast<float*>(out_payload);
  int32_t* pm = static_cast<int32_t*>(perm);
  cudaError_t err;

  if (n_pad <= kTile) {
    if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(n_pad * sizeof(uint64_t));
    const int threads = static_cast<int>(n_pad / 2 < 32 ? 32 : (n_pad / 2 > kTileThreads ? kTileThreads : n_pad / 2));
    err = cudaFuncSetAttribute(sort_rows_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_rows_tile_kernel<<<static_cast<unsigned>(rows), threads, smem, s>>>(
        k, p, ok, op, pm, n, static_cast<int>(n_pad), group);
    return static_cast<int>(cudaGetLastError());
  }

  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = n_pad / kTile;
  if (rows > INT_MAX / n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tile_blocks = static_cast<unsigned>(rows * n_tiles);
  const int smem = static_cast<int>(kTile * sizeof(uint64_t));
  uint64_t* sc = static_cast<uint64_t*>(scratch);
  err = cudaFuncSetAttribute(presort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  presort_tiles_kernel<<<tile_blocks, kTileThreads, smem, s>>>(k, sc, n, n_pad, n_tiles);
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
    merge_tiles_kernel<<<tile_blocks, kTileThreads, smem, s>>>(
        sc, p, ok, op, pm, n, n_pad, n_tiles, size, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
