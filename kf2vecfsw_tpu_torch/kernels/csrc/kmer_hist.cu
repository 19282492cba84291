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
// Bound on an H100 SXM: integer operations. The least work is reading
// N_total bytes of bases and writing G * 4^k * 4 bytes of counts over
// 3.35 TB/s (about 0.024 ms for 16 genomes of 5 Mb at k=7), and about 10
// integer operations per window (the rolling forward and reverse-complement
// codes, the min, the validity test, the bin add) over the card's integer
// rate, 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s (about 0.048 ms at
// that shape). What a window costs in practice is its shared-memory atomic
// and the dependent integer steps of the rolling code (PERF.md has the
// measured share of the bound).
//
// Design:
// - a persistent grid of kBlocksPerSM blocks per SM. The concatenated
//   stream of window starts [0, n_total) is cut into equal spans, each a
//   whole number of tiles, one per block, so a long genome is spread over
//   as many SMs as its share of the bases and the grid has no ragged last
//   wave. A block walks the pieces of the genomes its span meets; a window
//   belongs to the genome its first base is in.
// - tiles of kTileWindows window starts on a lattice fixed in the stream
//   (a tile is cut where a genome begins or ends). A tile's bases (plus the
//   k - 1 bases past its end, the "seam": no window is lost or counted
//   twice) are brought into shared memory with 16-byte loads, neighbouring
//   lanes on neighbouring addresses, and from there each thread walks
//   kRunWindows consecutive windows with a rolling forward /
//   reverse-complement code and a run length of valid bases, so INVALID (4)
//   bases break windows. kRunWindows is 17 words, an odd number, so the 32
//   lanes of a warp read 32 different banks.
// - k <= 7 and a piece of at least 4^k windows: a private 4^k int32
//   histogram per block in dynamic shared memory (64 KiB at k=7), zeroed
//   per piece and flushed to counts[g] with one global atomic per non-zero
//   bin. Otherwise (k in 8..13, or a short piece): atomics straight into
//   counts[g].
// - low-complexity repeats (homopolymers, dinucleotide runs) send many
//   lanes of a warp to one bin. Hopper's shared-memory atomics take that
//   without a loss: at 16 x 5 Mb, k=7, a batch of homopolymers or of
//   dinucleotide repeats counts as fast as random bases (chip_smoke.py
//   phase 5), and grouping equal bins with __match_any_sync first made all
//   three slower, so each window adds its own 1.
// The caller zeroes counts; the kernel only adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 2;
constexpr int kRunWindows = 68;  // 17 words
constexpr int64_t kTileWindows = int64_t(kThreads) * kRunWindows;  // 34,816
constexpr int kMaxSharedK = 7;  // 4^7 int32 bins = 64 KiB of shared memory
constexpr int kMaxK = 13;
// a tile's bases, aligned down and up to 16 bytes at both ends
constexpr int kStageChunks = (kTileWindows + kMaxK - 1 + 30) / 16 + 1;
constexpr int kStageBytes = kStageChunks * 16;

// Counts the windows starting at [w_lo, w_hi) (stream positions, all of one
// genome, every one of them ending inside it) into bins, a histogram in
// shared memory or the genome's row of counts. Every thread of the block
// calls it (it synchronises). Inlined at each call, so that the atomics
// into the shared histogram compile to shared-memory atomics.
__device__ __forceinline__ void count_piece(const uint8_t* __restrict__ bases, int64_t n_total,
                                            int64_t w_lo, int64_t w_hi, int k, uint8_t* stage,
                                            int32_t* bins) {
  const uint32_t mask = (1u << (2 * k)) - 1;
  const int rc_shift = 2 * (k - 1);
  const uintptr_t batch0 = reinterpret_cast<uintptr_t>(bases);
  const uintptr_t batch1 = batch0 + n_total;
  for (int64_t t0 = w_lo; t0 < w_hi;) {
    const int64_t q0 = (t0 / kTileWindows) * kTileWindows;  // the tile's lattice start
    const int64_t t1 = q0 + kTileWindows < w_hi ? q0 + kTileWindows : w_hi;
    // bases [t0, t1 + k - 1) in whole 16-byte chunks; a chunk that reaches
    // outside the batch (only at its two ends) is read byte by byte
    const uintptr_t a0 = (batch0 + t0) & ~uintptr_t(15);
    const uintptr_t a1 = (batch0 + t1 + k - 1 + 15) & ~uintptr_t(15);
    const int n_chunks = static_cast<int>((a1 - a0) / 16);
    for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
      const uintptr_t at = a0 + 16 * uintptr_t(c);
      if (at >= batch0 && at + 16 <= batch1) {
        reinterpret_cast<uint4*>(stage)[c] = __ldcs(reinterpret_cast<const uint4*>(at));
      } else {
        for (int j = 0; j < 16; ++j) {
          const uintptr_t a = at + j;
          stage[16 * c + j] = a >= batch0 && a < batch1 ? *reinterpret_cast<const uint8_t*>(a) : 4;
        }
      }
    }
    __syncthreads();
    // this thread's windows [from, p1)
    const int64_t p0 = q0 + int64_t(threadIdx.x) * kRunWindows;
    const int64_t from = p0 > t0 ? p0 : t0;
    const int64_t p1 = p0 + kRunWindows < t1 ? p0 + kRunWindows : t1;
    const int len = from < p1 ? static_cast<int>(p1 - from) + k - 1 : 0;  // bases to read
    const uint8_t* s = stage + (batch0 + from - a0);
    uint32_t fwd = 0, rc = 0;
    int run = 0;  // valid bases in a row ending here, counted from `from`
    for (int i = 0; i < len; ++i) {
      uint32_t b = s[i];
      if (b < 4) {
        ++run;
      } else {
        run = 0;
        b = 0;  // the code is garbage until k valid bases refill it
      }
      fwd = ((fwd << 2) | b) & mask;
      rc = (rc >> 2) | ((3u - b) << rc_shift);
      // windows from .. p1-1 end at bases from+k-1 .. p1+k-2; run >= k only
      // once the whole window lies at or after `from`
      if (run >= k) atomicAdd(&bins[fwd < rc ? fwd : rc], 1);
    }
    __syncthreads();
    t0 = t1;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
kmer_hist_kernel(const uint8_t* __restrict__ bases, const int64_t* __restrict__ offsets,
                 int32_t* __restrict__ counts, int n_genomes, int k, int64_t n_total,
                 int64_t span) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* stage = reinterpret_cast<uint8_t*>(smem_raw);
  int32_t* hist = reinterpret_cast<int32_t*>(stage + kStageBytes);
  const int64_t lo = int64_t(blockIdx.x) * span;
  const int64_t hi = lo + span < n_total ? lo + span : n_total;
  if (lo >= hi) return;  // whole block leaves together
  const int n_bins = 1 << (2 * k);

  // the genome that holds position lo: the last g with offsets[g] <= lo
  int g_lo = 0, g_hi = n_genomes - 1;
  while (g_lo < g_hi) {
    const int mid = (g_lo + g_hi + 1) / 2;
    if (offsets[mid] <= lo) {
      g_lo = mid;
    } else {
      g_hi = mid - 1;
    }
  }
  for (int g = g_lo; g < n_genomes; ++g) {
    const int64_t g0 = offsets[g];
    const int64_t g1 = offsets[g + 1];
    if (g0 >= hi) break;
    const int64_t w_lo = lo > g0 ? lo : g0;
    const int64_t w_end = g1 - k + 1;  // windows must end inside the genome
    const int64_t w_hi = hi < w_end ? hi : w_end;
    if (w_lo >= w_hi) continue;
    int32_t* out = counts + int64_t(g) * n_bins;
    const bool shared = kShared && w_hi - w_lo >= n_bins;  // the same in every thread
    if (shared) {
      for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;
      __syncthreads();
    }
    if (shared) {
      count_piece(bases, n_total, w_lo, w_hi, k, stage, hist);
    } else {
      count_piece(bases, n_total, w_lo, w_hi, k, stage, out);
    }
    if (shared) {
      for (int i = threadIdx.x; i < n_bins; i += kThreads) {
        const int32_t v = hist[i];
        if (v) atomicAdd(&out[i], v);
      }
      __syncthreads();
    }
  }
}

// Window starts per block: a whole number of tiles, so that every block
// of a batch of n_total bases but the last has the same share.
int64_t span_windows(int64_t n_total, int sms) {
  const int64_t blocks = int64_t(sms) * kBlocksPerSM;
  const int64_t tiles = (n_total + kTileWindows - 1) / kTileWindows;
  const int64_t tiles_per_block = (tiles + blocks - 1) / blocks;
  return (tiles_per_block > 0 ? tiles_per_block : 1) * kTileWindows;
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Windows per tile and per thread block span: the seams the tests place
// genome lengths around. The span depends on the batch's size and the
// card's SM count; it is -1 if the card cannot be queried.
int64_t kmer_hist_tile_windows() { return kTileWindows; }

int64_t kmer_hist_span_windows(int64_t n_total) {
  int sms = 0;
  if (device_sms(&sms) != 0) return -1;
  return span_windows(n_total, sms);
}

const char* kmer_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns the first error of a
// device query, cudaFuncSetAttribute or the launch, 0 on success.
// bases: uint8 (n_total,); offsets: int64 (n_genomes + 1,) from 0 to n_total,
// non-decreasing; counts: int32 (n_genomes, 4^k), zeroed by the caller.
int kmer_hist_launch(const void* bases, const void* offsets, void* counts, int n_genomes,
                     int k, int64_t n_total, void* stream) {
  if (n_genomes <= 0 || k < 2 || k > kMaxK || n_total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_total == 0) return 0;
  int sms = 0;
  int err = device_sms(&sms);
  if (err != 0) return err;
  const int64_t span = span_windows(n_total, sms);
  const unsigned grid = static_cast<unsigned>((n_total + span - 1) / span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bases);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  int32_t* c = static_cast<int32_t*>(counts);
  if (k <= kMaxSharedK) {
    const int smem = kStageBytes + (static_cast<int>(sizeof(int32_t)) << (2 * k));
    cudaError_t e = cudaFuncSetAttribute(kmer_hist_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kmer_hist_kernel<true><<<grid, kThreads, smem, s>>>(b, o, c, n_genomes, k, n_total, span);
  } else {
    const int smem = kStageBytes;
    kmer_hist_kernel<false><<<grid, kThreads, smem, s>>>(b, o, c, n_genomes, k, n_total, span);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
