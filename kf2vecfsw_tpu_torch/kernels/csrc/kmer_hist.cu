// Canonical k-mer histogram for a batch of genomes, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   kf2vecfsw_tpu/kernels/histogram.py  _hist_kernel_batch (B1, batched genomes)
//   kf2vecfsw_tpu/kernels/histogram.py  _hist_kernel       (B2, one long genome)
// Both turn the scatter into dual one-hot matmuls because scatters are slow
// on the TPU, and cap each call at 2^23 windows because they accumulate in
// f32. Neither constraint exists here: this kernel fuses window coding and
// counting in one pass over the uint8 bases and adds with integer atomics,
// which are order-independent, so the result is exact and deterministic
// with no per-call cap below 2^31 windows per genome.
//
// Function: counts[g, c] = number of windows i of genome g whose k bases
// (bases[offsets[g] + i .. + k - 1]) are all < 4 and whose canonical code
// min(fwd, revcomp) is c, with the digit convention of window_codes_xla
// (first base most significant in fwd, least significant in revcomp).
//
// Bound on an H100 SXM: memory. The least work is reading N_total bytes of
// bases and writing G * 4^k * 4 bytes of counts, over 3.35 TB/s (about
// 0.024 ms for 16 genomes of 5 Mb at k=7). What a first version actually hits
// is shared-memory atomic throughput, one atomic per window, and contention
// when many windows of a warp land in one bin: low-complexity repeats
// (homopolymers, dinucleotide runs) serialise the warp's atomics.
//
// Design:
// - grid (tiles_per_genome, G); a block strides over the tiles of genome
//   blockIdx.y, tile = kTileWindows windows, and a tile must read
//   kTileWindows + k - 1 bases: its last k - 1 bases are the next tile's
//   first (the "seam"; no window is lost or counted twice across it).
// - a thread walks kWindowsPerThread consecutive windows with a rolling
//   forward / reverse-complement code and a run length of valid bases, so
//   each base is read once per thread and INVALID (4) bases break windows.
// - k <= 7: a private 4^k int32 histogram per block in dynamic shared memory
//   (64 KiB at k=7), flushed to counts[g] with one global atomicAdd per
//   non-zero bin. k in 8..13: atomics straight into counts[g].
// The caller zeroes counts; the kernel only adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWindowsPerThread = 128;
constexpr int64_t kTileWindows = int64_t(kThreads) * kWindowsPerThread;  // 65,536
constexpr int kMaxSharedK = 7;  // 4^7 int32 bins = 64 KiB of shared memory
constexpr int kMaxK = 13;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
kmer_hist_kernel(const uint8_t* __restrict__ bases, const int64_t* __restrict__ offsets,
                 int32_t* __restrict__ counts, int k) {
  extern __shared__ int32_t hist[];
  const int g = blockIdx.y;
  const int64_t start = offsets[g];
  const int64_t n_windows = offsets[g + 1] - start - k + 1;
  const int64_t n_tiles = n_windows > 0 ? (n_windows + kTileWindows - 1) / kTileWindows : 0;
  if (static_cast<int64_t>(blockIdx.x) >= n_tiles) return;  // whole block leaves together

  const uint32_t n_bins = 1u << (2 * k);
  const uint32_t mask = n_bins - 1;
  const int rc_shift = 2 * (k - 1);
  int32_t* out = counts + static_cast<int64_t>(g) * n_bins;
  const uint8_t* seq = bases + start;

  if constexpr (kShared) {
    for (uint32_t i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t w0 = tile * kTileWindows + static_cast<int64_t>(threadIdx.x) * kWindowsPerThread;
    const int64_t w_end = w0 + kWindowsPerThread;
    const int64_t w1 = w_end < n_windows ? w_end : n_windows;
    if (w0 >= w1) continue;
    uint32_t fwd = 0, rc = 0;
    int run = 0;  // valid bases in a row ending at p, counted from w0
    // windows w0 .. w1-1 end at bases w0+k-1 .. w1+k-2; run >= k only once
    // the whole window lies at or after w0, so no window is counted twice
    for (int64_t p = w0; p < w1 + k - 1; ++p) {
      uint32_t b = seq[p];
      if (b < 4) {
        ++run;
      } else {
        run = 0;
        b = 0;  // the code is garbage until k valid bases refill it
      }
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | ((3u - b) << rc_shift);
      if (run >= k) {
        const uint32_t canon = fwd < rc ? fwd : rc;
        if constexpr (kShared) {
          atomicAdd(&hist[canon], 1);
        } else {
          atomicAdd(&out[canon], 1);
        }
      }
    }
  }

  if constexpr (kShared) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < n_bins; i += blockDim.x) {
      const int32_t v = hist[i];
      if (v) atomicAdd(&out[i], v);
    }
  }
}

}  // namespace

extern "C" {

// Windows per tile: the seam the tests place genome lengths around.
int64_t kmer_hist_tile_windows() { return kTileWindows; }

const char* kmer_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// bases: uint8 (n_total,); offsets: int64 (n_genomes + 1,) from 0 to n_total,
// non-decreasing; counts: int32 (n_genomes, 4^k), zeroed by the caller.
int kmer_hist_launch(const void* bases, const void* offsets, void* counts, int n_genomes,
                     int k, int64_t n_total, void* stream) {
  if (n_genomes <= 0 || n_genomes > 65535 || k < 2 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles_total = (n_total + kTileWindows - 1) / kTileWindows;
  int64_t grid_x = (tiles_total + n_genomes - 1) / n_genomes;  // tiles of an average genome
  if (grid_x < 1) grid_x = 1;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(n_genomes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bases);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  int32_t* c = static_cast<int32_t*>(counts);
  if (k <= kMaxSharedK) {
    const int smem = static_cast<int>(sizeof(int32_t)) << (2 * k);
    cudaError_t err = cudaFuncSetAttribute(kmer_hist_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kmer_hist_kernel<true><<<grid, kThreads, smem, s>>>(b, o, c, k);
  } else {
    kmer_hist_kernel<false><<<grid, kThreads, 0, s>>>(b, o, c, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
