// The lazy refresh's planes, for Hopper (sm_90a): the shared route's
// (lazy_refresh_launch) and the per-genome route's
// (lazy_refresh_pergenome_launch, described after the shared one). The two
// share the coefficient's device function, sinc_and_slope.
//
// THE SHARED ROUTE. Replaces no Pallas kernel. The JAX package computes the
// shared-vocab lazy refresh with XLA ops (kf2vecfsw_tpu/models/fsw.py:337,
// fsw_lazy_refresh),
// and the port ran it as plain torch (kernels/refresh.py,
// refresh_planes_reference): per group of G items a gather of the sorted
// weights (G, C, V), a jvp of the cos/sinc coefficients in about 50
// elementwise passes, a row sum, an unsort and a product with the one-hot
// digit matrix, each pass a round trip of (G, C, V) f32 through device
// memory. On an H100 that took 0.51 s a refresh at 850 items, 512 slices and
// V = 8,192, most of a lazy training window, and held 2.1 GB. This kernel
// computes the same planes in one walk that keeps every per-position value
// in registers and writes only the planes.
//
// Function: for item i < n, slice c < C and the sorted order p = 0..V-1 of
// slice c (perm, the stable sort of the shared projections; ps the sorted
// projections), with w_p = wn[i, perm[c, p]] and xi = freqs[c]:
//   cbar_p  = sum_{q <= p} w_q - w_p / 2,   u = xi w_p / 2,
//   delta_p = sqrt2 w_p cos(pi xi cbar_p) sinc(u),
//   ddelta_p = d delta_p / d xi
//           = sqrt2 w_p [-pi cbar_p sin(pi xi cbar_p) sinc(u)
//                        + cos(pi xi cbar_p) sinc'(u) w_p / 2],
//   g2[i, c]      = sum_p ps[c, p] ddelta_p,
//   S[i, c, j, a] = sum_p delta_p [digit j of vocab entry perm[c, p] == a],
// with sinc the normalised sinc and sinc'(u) = (cos(pi u) - sinc(u)) / u, both
// from their series for |u| < kSmallU. S is (n, C, k, 4) and g2 (n, C), f32.
//
// Bound on an H100 SXM: operations, not bytes. A refresh evaluates n C V
// coefficients (3.57e9 at the training cell's 850 x 512 x 8,192), each a
// sincospif of the phase, the sinc and its slope, a dozen products and
// 3k + 1 fused multiply-adds into the segment sums, and the compensated
// prefix: about 85 instructions, 3.0e11 lane instructions against the
// card's 3.3e13 a second (132 SMs x 128 lanes x 1.98 GHz), about 9 ms (a
// count of 120 a coefficient gives 12.8 ms; the kernel takes 17.3 ms on an
// H100 SXM at 700 W). The bytes are small beside that: the weights (n V
// f32) are read once per slice tile and the sorted records (12 B a
// position of C V) once per item group, both mostly from L2.
//
// Design:
// - A records pass writes, for each slice, the sorted column, projection
//   and packed digits (2 bits a base, k <= 9) in the order in which the main
//   kernel's lanes read them, so every read of the walk is coalesced and the
//   digits are gathered once a slice rather than once an item.
// - A block carries kItems = 4 items. Where their weight rows fit in shared
//   memory (16 B a vocab entry, V <= 14,527 on an H100: k <= 7), it stages
//   them interleaved, one float4 an entry, so a position's four weights are
//   one 128-bit shared load; past that it gathers them from device memory.
// - A warp walks one slice at a time. Lane l takes positions
//   [l R, (l + 1) R), R = ceil(V / 32). A first walk sums the lane's weights
//   (unrolled, so its loads are in flight together), a warp scan turns the
//   sums into each lane's starting prefix, both in double, and the second
//   walk computes the coefficients with the prefix carried in two registers
//   and compensated (Kahan): summed serially in float, a lane's R weights
//   would round the prefix by up to R/2 ulps where torch's scan rounds it by
//   a few, and the phase multiplies that by up to 511 pi. A position's digit
//   masks serve the four items. Each item keeps 3k + 1 segment sums (the
//   total and the sums over the positions whose digit has bit 0, bit 1,
//   both) and g2 in registers, reduced across the warp once per (item,
//   slice); no (item, slice, position) value reaches memory.
// - One launch of each kernel covers every item and slice. The main grid
//   runs over item groups (fastest) and slice tiles, so the blocks that run
//   together read one tile's records from L2.
// Numerics: float32 throughout, but for the compensated prefix, and no
// fast-math intrinsics (the phase reaches 511 pi); sincospif folds pi in and
// reduces the range exactly. The
// prefix sums and the segment sums run in another order than the plain
// version's, so the two agree to float32 rounding, not bit for bit.
//
// THE PER-GENOME ROUTE. Replaces no Pallas kernel either: the JAX package
// computes it with XLA ops (kf2vecfsw_tpu/models/fsw.py:468,
// fsw_lazy_refresh_pergenome), and the port ran it as plain torch
// (kernels/refresh.py, pergenome_planes_reference): a jvp of the
// coefficients in 49 elementwise launches, a row sum, an unsort and a
// product with each item's one-hot digit matrix, 16 f32 buffers of
// (G C, N). On an H100 that took 45.8 ms of an item's 63.3 ms refresh at
// 512 slices and N = 646,000 (k = 10) and held 21.2 GB. Here each item
// owns its points, so the rows are few and long: the sort of G items' C
// slice rows gives, for row g C + c, the sorted projections ps, weights ws
// and columns perm; with xi = freqs[c] and the coefficients as above over
// that row's order,
//   g2[g, c]      = sum_p ps[row, p] ddelta_p,
//   S[g, c, j, a] = sum_p delta_p [digits[g, perm[row, p], j] == a].
// Bound on an H100 SXM: bytes. At 512 x 646,000 with 503,934 real points
// (the k = 10 cell's group) ps, ws and perm read once are 4.0 GB, 1.2 ms at
// 3.35 TB/s (the tile sums read ws once more: 1.6 ms with it), against 0.9
// ms of lane work (120 instructions a coefficient on the 2.6e8 real
// positions); the codes' gather by perm is one 32-byte L2 sector a
// position.
// Design:
// - A pre-pass packs each point's k <= 31 bases into a 64-bit code (G N 8
//   B, 5.2 MB an item at N = 646,000: it stays in L2), so a sorted position
//   gathers one word by perm rather than k int64 digits.
// - Each row is cut into tiles of kPgTile = 4,096 positions, one warp a
//   tile (about 8e4 tiles at one item, enough to fill 132 SMs at G = 1).
//   Step r of a warp takes positions 64 r + 2 lane and the one after it,
//   so the reads of ps, ws and perm are coalesced, a lane's two
//   coefficients are independent work and one warp scan serves 64
//   positions; the reads of the next two steps are in flight while a step
//   computes.
// - A first kernel sums each tile's weights in double; the walk starts
//   from the sum of the row's earlier tiles (in double, a fixed order),
//   carries the prefix in two floats compensated (Kahan; the phase
//   multiplies prefix error by up to 511 pi, and a row here is 79 times
//   longer than at k = 7) and adds a step's weights by a warp scan. A step
//   whose weights are all zero (padding sorts together) adds nothing and
//   is skipped.
// - g2 and the 3k + 1 segment sums stay in registers, a base's bits
//   masking delta's. (On an H100 the masks alone made the launch 1.08x
//   faster than selects, and with two positions a lane 1.17x faster than
//   one.) A warp writes its tile's sums once, and a last kernel reduces
//   each row's tiles in double in tile order into S and g2. No float
//   atomics: two launches give the same bits. Nothing of size (G C, N) is
//   written.
// - The main kernel is built for k <= 10, <= 16 and <= 31, masking the
//   bases past k, not once a k: the build counts in set-up.
// Numerics as the shared route's: float32 but for the prefix and the tile
// reductions, no fast-math.
//
// THE EXACT FORWARDS' COEFFICIENTS (lazy_refresh_exact_rows_launch,
// lazy_refresh_exact_shared_launch). Replace no Pallas kernel either: the
// JAX package's exact forwards (kf2vecfsw_tpu/models/fsw.py, fsw_embed and
// fsw_embed_shared) and the port's plain chain (models/fsw.py on the CPU,
// quantile_coefficients times ps, a row sum, and autograd's backward) run
// the cumsum, the cos/sinc coefficients and their gradients as about 20
// elementwise passes forward and more backward, each a round trip of a
// (B c, N) f32 buffer. These kernels take the sort's outputs (the sort and
// the unsort stay sort_rows.cu's and a scatter) and, for row r (item b,
// slice c), its sorted ps and ws, xi = freqs[c] and the cotangent gE[b, c],
// compute with delta and ddelta = d delta / d xi as above
//   forward:  E[b, c] = sum_p ps[r, p] delta_p,
//   backward: d_ps[r, p] = gE[b, c] delta_p,
//             d xi[c] = sum_b gE[b, c] sum_p ps[r, p] ddelta_p;
// the weights get no gradient.
// - Per genome (rows of N, each item its own weights): the per-genome
//   planes' walk. tile_sums_kernel sums each tile's weights in double (the
//   forward's pass; the backward reuses its output); a warp walks a tile of
//   kPgTile from the earlier tiles' sum, the prefix compensated, zero-weight
//   steps skipped (their delta and d_ps are 0); the forward writes a float a
//   tile, the backward d_ps once and a float a tile; exact_rows_reduce_kernel
//   sums a row's tiles in double in a fixed order, into E or, over the B
//   rows of a slice weighted by gE, into d xi. Bound: bytes. The forward
//   reads ps and ws once and ws once more for the tile sums (12 B a
//   position), the backward ws and ps and writes d_ps (12 B): at
//   fsw_k10.train_exact's chunk of 16 x 32 rows of 646,000, 1.2 ms each at
//   3.35 TB/s, against 0.6 and 0.9 ms of lane work on its 78% real points.
// - Shared vocab (C rows of V, every item's weights over one order): one
//   block a slice row, cut into tiles of kExTile = 512, one warp a tile,
//   the items in groups of kItems. The block stages a group's weight rows
//   interleaved in shared memory where they fit and every tile has its own
//   warp (V <= 8,192 on an H100: k <= 7), reading wn[i, perm[c, p]] from
//   there, from device memory otherwise. A tile's weights per item, in
//   double, give each warp its starting prefix (in shared memory when
//   staged, in an (n, C, tiles) scratch otherwise); the walk carries it
//   compensated. The forward takes a block an item group and sums ps delta
//   over the block's warps in double; the backward takes a block every
//   group, sums gE delta over the batch in registers, writes d_ps (C, V)
//   once and d xi[c] from the warps' sums in double: nothing of size (B, C,
//   V) is gathered or written. Bound: lane work, the B C V coefficients
//   (6.7e7 at fsw_k7.train_exact): about 0.12 ms forward at 60 lane
//   instructions a coefficient (delta alone) and 0.24 ms backward at 120
//   (delta and its xi-derivative), as PERF.md and the benchmark's
//   exact_coefficients_roofline.train count them.
// No float atomics anywhere: two launches give the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 4;  // items of a block: one float4 of weights a position
constexpr int kWarps = 12;  // 3 a scheduler: 8 or 16 warps ran 14-15% slower on an H100
constexpr int kLanes = 32;
constexpr int kThreads = kWarps * kLanes;
constexpr int kRecordThreads = 256;
constexpr int kMaxK = 9;  // 2 bits a base in a 32-bit code; the shared route's k <= 9
constexpr int64_t kMaxVocab = int64_t(1) << 18;  // models/fsw.py FSW_SHARED_VOCAB_MAX
constexpr float kPi = 3.14159265358979323846f;
constexpr float kSqrt2 = 1.41421356237309504880f;
// Below it sinc and sinc' come from their series (through (pi u)^8: the next
// terms are under 3e-9 relative at pi u = pi / 4); above it from sincospif,
// where cos(pi u) - sinc(u) loses under 1e-6 of its value to cancellation.
constexpr float kSmallU = 0.25f;

__device__ __forceinline__ void sinc_and_slope(float u, float& s, float& ds) {
  const float pu = kPi * u;
  if (fabsf(u) < kSmallU) {
    const float z = pu * pu;
    s = 1.f - z * (1.f / 6.f) *
                  (1.f - z * (1.f / 20.f) * (1.f - z * (1.f / 42.f) * (1.f - z * (1.f / 72.f))));
    ds = -(kPi * pu * (1.f / 3.f)) *
         (1.f - z * (1.f / 10.f - z * (1.f / 280.f - z * (1.f / 15120.f - z * (1.f / 1330560.f)))));
  } else {
    float sn, cs;
    sincospif(u, &sn, &cs);
    const float inv = 1.f / pu;
    s = sn * inv;
    ds = (cs - s) * (kPi * inv);
  }
}

// Records of slice c in lane order: entry q = r * 32 + l holds position
// p = l R + r of the sorted row (column, projection, digits of the column's
// vocab entry); positions p >= V hold column V, projection 0 and digits 0,
// and read a zero weight.
__global__ void __launch_bounds__(kRecordThreads)
records_kernel(const int32_t* __restrict__ perm, const float* __restrict__ ps,
               const int64_t* __restrict__ digits, int32_t* __restrict__ rec_col,
               float* __restrict__ rec_ps, int32_t* __restrict__ rec_code, int64_t c_total,
               int64_t v, int64_t r_len, int k) {
  const int64_t vp = kLanes * r_len;
  const int64_t t = int64_t(blockIdx.x) * kRecordThreads + threadIdx.x;
  if (t >= c_total * vp) return;
  const int64_t c = t / vp, q = t - c * vp;
  const int64_t p = (q % kLanes) * r_len + q / kLanes;
  int32_t col = static_cast<int32_t>(v), code = 0;
  float x = 0.f;
  if (p < v) {
    col = perm[c * v + p];
    x = ps[c * v + p];
    const int64_t* d = digits + int64_t(col) * k;
    for (int j = 0; j < k; ++j) code |= static_cast<int32_t>(d[j] & 3) << (2 * j);
  }
  rec_col[t] = col;
  rec_ps[t] = x;
  rec_code[t] = code;
}

template <bool kStaged>
__device__ __forceinline__ float4 item_weights(const float4* w_smem, const float* __restrict__ wn,
                                               int64_t i0, int64_t n, int64_t v, int32_t col) {
  if (kStaged) return w_smem[col];
  float e[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    e[it] = (col < v && i0 + it < n) ? __ldg(wn + (i0 + it) * v + col) : 0.f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <int K, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
planes_kernel(const float* __restrict__ wn, const int32_t* __restrict__ rec_col,
              const float* __restrict__ rec_ps, const int32_t* __restrict__ rec_code,
              const float* __restrict__ freqs, float* __restrict__ s_out,
              float* __restrict__ g2_out, int64_t n, int64_t c_total, int64_t v, int r_len,
              int64_t slices_per_block) {
  constexpr int kSums = 3 * K + 1;  // the total, then per base j: bit 0, bit 1, both
  extern __shared__ float4 w_smem[];  // kStaged: V + 1 entries, the last one zero
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int64_t i0 = int64_t(blockIdx.x) * kItems;
  if (kStaged) {
    for (int64_t col = threadIdx.x; col <= v; col += kThreads) {
      float e[kItems];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        e[it] = (col < v && i0 + it < n) ? wn[(i0 + it) * v + col] : 0.f;
      }
      w_smem[col] = make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
  }
  const int64_t vp = int64_t(kLanes) * r_len;
  const int64_t c_begin = int64_t(blockIdx.y) * slices_per_block;
  const int64_t c_end = c_begin + slices_per_block < c_total ? c_begin + slices_per_block : c_total;
  for (int64_t c = c_begin + warp; c < c_end; c += kWarps) {
    const float xi = freqs[c], half_xi = 0.5f * xi;
    const int32_t* cols = rec_col + c * vp + lane;
    const float* pss = rec_ps + c * vp + lane;
    const int32_t* codes = rec_code + c * vp + lane;

    // first walk: the lane's sums and each lane's starting prefix, in
    // double; the prefix enters the second walk as hi + lo
    double run[kItems] = {};
#pragma unroll 16
    for (int r = 0; r < r_len; ++r) {
      const float4 w = item_weights<kStaged>(w_smem, wn, i0, n, v, cols[r * kLanes]);
      run[0] += w.x;
      run[1] += w.y;
      run[2] += w.z;
      run[3] += w.w;
    }
    float hi[kItems], lo[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      double incl = run[it];
#pragma unroll
      for (int d = 1; d < kLanes; d *= 2) {
        const double up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const double before = __shfl_up_sync(0xffffffffu, incl, 1);
      const double start = lane == 0 ? 0.0 : before;
      hi[it] = static_cast<float>(start);
      lo[it] = static_cast<float>(start - static_cast<double>(hi[it]));
    }

    // second walk: the coefficients, g2 and the segment sums
    float sums[kItems][kSums] = {};
    float g2[kItems] = {};
    int32_t col = cols[0], code = codes[0];
    float proj = pss[0];
#pragma unroll 1
    for (int r = 0; r < r_len; ++r) {
      const int next = r + 1 < r_len ? r + 1 : r;
      const int32_t col_next = cols[next * kLanes], code_next = codes[next * kLanes];
      const float proj_next = pss[next * kLanes];
      const float4 w4 = item_weights<kStaged>(w_smem, wn, i0, n, v, col);
      const float ws[kItems] = {w4.x, w4.y, w4.z, w4.w};
      float mask[3 * K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int d = (code >> (2 * j)) & 3;
        mask[3 * j] = (d & 1) ? 1.f : 0.f;
        mask[3 * j + 1] = (d & 2) ? 1.f : 0.f;
        mask[3 * j + 2] = d == 3 ? 1.f : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const float w = ws[it];
        // the prefix hi + lo, compensated (Kahan): a lane adds R weights in
        // a row, whose rounding the phase would multiply by up to 511 pi
        const float y = w + lo[it], t = hi[it] + y;
        lo[it] = y - (t - hi[it]);
        hi[it] = t;
        const float cbar = fmaf(-0.5f, w, hi[it]) + lo[it];
        float sa, ca;
        sincospif(xi * cbar, &sa, &ca);
        float sn, dsn;
        sinc_and_slope(half_xi * w, sn, dsn);
        const float sw = kSqrt2 * w;
        const float delta = sw * ca * sn;
        const float ddelta = sw * fmaf(-kPi * cbar * sa, sn, ca * dsn * (0.5f * w));
        g2[it] = fmaf(proj, ddelta, g2[it]);
        sums[it][0] += delta;
#pragma unroll
        for (int m = 0; m < 3 * K; ++m) sums[it][m + 1] = fmaf(delta, mask[m], sums[it][m + 1]);
      }
      col = col_next;
      code = code_next;
      proj = proj_next;
    }

    // the warp's sums, then lane `it` writes item it's planes
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
#pragma unroll
      for (int d = kLanes / 2; d > 0; d /= 2) {
        g2[it] += __shfl_xor_sync(0xffffffffu, g2[it], d);
#pragma unroll
        for (int m = 0; m < kSums; ++m) sums[it][m] += __shfl_xor_sync(0xffffffffu, sums[it][m], d);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (lane != it || i0 + it >= n) continue;
      float4* s = reinterpret_cast<float4*>(s_out + ((i0 + it) * c_total + c) * (4 * K));
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float total = sums[it][0], b0 = sums[it][3 * j + 1], b1 = sums[it][3 * j + 2],
                    both = sums[it][3 * j + 3];
        s[j] = make_float4((total - b0) - (b1 - both), b0 - both, b1 - both, both);
      }
      g2_out[(i0 + it) * c_total + c] = g2[it];
    }
  }
}

int device_attribute(cudaDeviceAttr attr, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, attr, dev);
  return static_cast<int>(err);
}

int64_t record_len(int64_t v) { return kLanes * ((v + kLanes - 1) / kLanes); }

template <int K>
cudaError_t launch_planes(bool staged, dim3 grid, cudaStream_t s, const float* wn,
                          const int32_t* rec_col, const float* rec_ps, const int32_t* rec_code,
                          const float* freqs, float* s_out, float* g2_out, int64_t n,
                          int64_t c_total, int64_t v, int r_len, int64_t slices_per_block) {
  if (staged) {
    const int smem = static_cast<int>((v + 1) * sizeof(float4));
    cudaError_t err = cudaFuncSetAttribute(planes_kernel<K, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    planes_kernel<K, true><<<grid, kThreads, smem, s>>>(wn, rec_col, rec_ps, rec_code, freqs, s_out,
                                                        g2_out, n, c_total, v, r_len,
                                                        slices_per_block);
  } else {
    planes_kernel<K, false><<<grid, kThreads, 0, s>>>(wn, rec_col, rec_ps, rec_code, freqs, s_out,
                                                      g2_out, n, c_total, v, r_len,
                                                      slices_per_block);
  }
  return cudaGetLastError();
}

// ---- the per-genome route ----------------------------------------------------

constexpr int kPgWarps = 8;  // tiles of a block, one a warp
constexpr int kPgThreads = kPgWarps * kLanes;
constexpr int64_t kPgTile = 4096;  // positions of a tile, one warp's
constexpr int kPgMaxK = 31;  // 2 bits a base in a 64-bit code: defaults.py MAX_K_LEN
constexpr int kCodeThreads = 256;
constexpr int kReduceThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;  // a butterfly: every lane adds the same pairs, so every lane holds the same sum
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// codes[i] = sum_j (digits[i, j] & 3) << 2j: a point's k bases in one word
__global__ void __launch_bounds__(kCodeThreads)
codes_kernel(const int64_t* __restrict__ digits, uint64_t* __restrict__ codes, int64_t points,
             int k) {
  const int64_t i = int64_t(blockIdx.x) * kCodeThreads + threadIdx.x;
  if (i >= points) return;
  const int64_t* d = digits + i * k;
  uint64_t code = 0;
  for (int j = 0; j < k; ++j) code |= static_cast<uint64_t>(d[j] & 3) << (2 * j);
  codes[i] = code;
}

// tile_sums[row * tiles_per_row + t]: the weights of tile t of the row, in double
__global__ void __launch_bounds__(kPgThreads)
tile_sums_kernel(const float* __restrict__ ws, double* __restrict__ tile_sums, int64_t tiles,
                 int64_t n, int64_t tiles_per_row) {
  const int lane = threadIdx.x % kLanes;
  const int64_t tile = int64_t(blockIdx.x) * kPgWarps + threadIdx.x / kLanes;
  if (tile >= tiles) return;  // the whole warp
  const int64_t row = tile / tiles_per_row, t = tile - row * tiles_per_row;
  const float* w = ws + row * n;
  const int64_t p0 = t * kPgTile + lane;
  double sum = 0.0;
#pragma unroll 8
  for (int64_t q = 0; q < kPgTile; q += kLanes) {
    if (p0 + q < n) sum += w[p0 + q];
  }
  sum = warp_sum(sum);
  if (lane == 0) tile_sums[tile] = sum;
}

__device__ __forceinline__ void coefficient(float w, float cbar, float xi, float half_xi,
                                            float& delta, float& ddelta) {
  float sa, ca;
  sincospif(xi * cbar, &sa, &ca);
  float sn, dsn;
  sinc_and_slope(half_xi * w, sn, dsn);
  const float sw = kSqrt2 * w;
  delta = sw * ca * sn;
  ddelta = sw * fmaf(-kPi * cbar * sa, sn, ca * dsn * (0.5f * w));
}

// sums[0] += delta; for each base j < k, sums[1 + 3j + (0, 1, 2)] += delta
// where the base has bit 0, bit 1, both: delta's bits masked, no branch
template <int KB>
__device__ __forceinline__ void add_to_planes(float delta, uint64_t code, int k, float* sums) {
  sums[0] += delta;
  const unsigned bits = __float_as_uint(delta);
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j < k) {
      const unsigned d = static_cast<unsigned>(code >> (2 * j));
      const unsigned b0 = bits & (0u - (d & 1u)), b1 = bits & (0u - ((d >> 1) & 1u));
      sums[3 * j + 1] += __uint_as_float(b0);
      sums[3 * j + 2] += __uint_as_float(b1);
      sums[3 * j + 3] += __uint_as_float(b0 & b1);
    }
  }
}

// One warp a tile of kPgTile positions of one (item, slice) row; step r
// takes positions t kPgTile + 64 r + 2 lane and the one after it, so the
// reads of ps, ws and perm are coalesced and a lane's two coefficients are
// independent work. Writes the tile's g2 and 3k + 1 segment sums to
// partials[tile * (3k + 2) + m]: m = 0 g2, 1 the total, 2 + 3j + (0, 1, 2)
// the sums over the positions whose base j has bit 0, bit 1, both.
template <int KB>
__global__ void __launch_bounds__(kPgThreads)
pergenome_planes_kernel(const float* __restrict__ ps, const float* __restrict__ ws,
                        const int32_t* __restrict__ perm, const uint64_t* __restrict__ codes,
                        const double* __restrict__ tile_sums, const float* __restrict__ freqs,
                        float* __restrict__ partials, int64_t tiles, int64_t c_total, int64_t n,
                        int64_t tiles_per_row, int k) {
  constexpr int kSums = 3 * KB + 1;  // the total, then per base j: bit 0, bit 1, both
  constexpr int kStep = 2 * kLanes;  // positions of a step
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % kLanes;
  const int64_t tile = int64_t(blockIdx.x) * kPgWarps + threadIdx.x / kLanes;
  if (tile >= tiles) return;  // the whole warp
  const int64_t row = tile / tiles_per_row, t = tile - row * tiles_per_row;
  const int64_t g = row / c_total, c = row - g * c_total;
  const float xi = freqs[c], half_xi = 0.5f * xi;

  // the tile's starting prefix, the row's earlier tiles summed in double, enters
  // the walk as hi + lo
  double start = 0.0;
  for (int64_t u = lane; u < t; u += kLanes) start += tile_sums[row * tiles_per_row + u];
  start = warp_sum(start);
  float hi = static_cast<float>(start);
  float lo = static_cast<float>(start - static_cast<double>(hi));

  const int64_t begin = t * kPgTile;
  const int64_t end = begin + kPgTile < n ? begin + kPgTile : n;
  const int steps = static_cast<int>((end - begin + kStep - 1) / kStep);
  const float* ps_row = ps + row * n;
  const float* ws_row = ws + row * n;
  const int32_t* perm_row = perm + row * n;
  const uint64_t* item_codes = codes + g * n;
  // a lane's two positions: weight, projection and column two steps ahead,
  // the codes one step ahead, so their reads are in flight while a step
  // computes
  auto load = [&](int64_t p, float& w, float& x, int32_t& col) {
    const bool in = p < end;
    w = in ? ws_row[p] : 0.f;
    x = in ? ps_row[p] : 0.f;
    col = in ? perm_row[p] : 0;
  };
  int64_t p = begin + 2 * lane;
  float wa0, xa0, wb0, xb0, wa1, xa1, wb1, xb1;
  int32_t ca0, cb0, ca1, cb1;
  load(p, wa0, xa0, ca0);
  load(p + 1, wb0, xb0, cb0);
  load(p + kStep, wa1, xa1, ca1);
  load(p + kStep + 1, wb1, xb1, cb1);
  uint64_t codea0 = p < end ? item_codes[ca0] : 0;
  uint64_t codeb0 = p + 1 < end ? item_codes[cb0] : 0;

  float sums[kSums] = {};
  float g2 = 0.f;
#pragma unroll 1
  for (int r = 0; r < steps; ++r, p += kStep) {
    float wa2, xa2, wb2, xb2;
    int32_t ca2, cb2;
    load(p + 2 * kStep, wa2, xa2, ca2);
    load(p + 2 * kStep + 1, wb2, xb2, cb2);
    const uint64_t codea1 = p + kStep < end ? item_codes[ca1] : 0;
    const uint64_t codeb1 = p + kStep + 1 < end ? item_codes[cb1] : 0;
    // a step of zero weights (padding, past the row's end) adds nothing
    if (__any_sync(full, wa0 != 0.f || wb0 != 0.f)) {
      const float pair = wa0 + wb0;
      float incl = pair;  // the step's inclusive prefix of the lanes' pairs
#pragma unroll
      for (int d = 1; d < kLanes; d *= 2) {
        const float up = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += up;
      }
      const float total = __shfl_sync(full, incl, kLanes - 1);
      float before = __shfl_up_sync(full, incl, 1);
      if (lane == 0) before = 0.f;
      const float cbar_a = hi + (fmaf(0.5f, wa0, before) + lo);
      const float cbar_b = hi + ((before + fmaf(0.5f, wb0, wa0)) + lo);
      // the prefix hi + lo, compensated (Kahan): a row adds up to N weights,
      // whose rounding the phase would multiply by up to 511 pi
      const float y = total + lo, sum = hi + y;
      lo = y - (sum - hi);
      hi = sum;
      float da, dda, db, ddb;
      coefficient(wa0, cbar_a, xi, half_xi, da, dda);
      coefficient(wb0, cbar_b, xi, half_xi, db, ddb);
      g2 = fmaf(xa0, dda, g2);
      g2 = fmaf(xb0, ddb, g2);
      add_to_planes<KB>(da, codea0, k, sums);
      add_to_planes<KB>(db, codeb0, k, sums);
    }
    wa0 = wa1;
    xa0 = xa1;
    wb0 = wb1;
    xb0 = xb1;
    codea0 = codea1;
    codeb0 = codeb1;
    wa1 = wa2;
    xa1 = xa2;
    wb1 = wb2;
    xb1 = xb2;
    ca1 = ca2;
    cb1 = cb2;
  }

  g2 = warp_sum(g2);
#pragma unroll
  for (int m = 0; m < kSums; ++m) {
    if (m < 3 * k + 1) sums[m] = warp_sum(sums[m]);
  }
  if (lane == 0) {
    float* out = partials + tile * (3 * k + 2);
    out[0] = g2;
#pragma unroll
    for (int m = 0; m < kSums; ++m) {
      if (m < 3 * k + 1) out[m + 1] = sums[m];
    }
  }
}

// S[row, j, :] (j < k) and g2[row] (j == k): the row's tile partials summed
// in double in tile order, so two launches give the same bits
__global__ void __launch_bounds__(kReduceThreads)
pergenome_reduce_kernel(const float* __restrict__ partials, float* __restrict__ s_out,
                        float* __restrict__ g2_out, int64_t rows, int64_t tiles_per_row, int k) {
  const int64_t i = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= rows * (k + 1)) return;
  const int64_t row = i / (k + 1);
  const int j = static_cast<int>(i - row * (k + 1));
  const int width = 3 * k + 2;
  const float* part = partials + row * tiles_per_row * width;
  if (j == k) {
    double g2 = 0.0;
    for (int64_t t = 0; t < tiles_per_row; ++t) g2 += part[t * width];
    g2_out[row] = static_cast<float>(g2);
    return;
  }
  double total = 0.0, b0 = 0.0, b1 = 0.0, both = 0.0;
  for (int64_t t = 0; t < tiles_per_row; ++t) {
    const float* q = part + t * width;
    total += q[1];
    b0 += q[2 + 3 * j];
    b1 += q[3 + 3 * j];
    both += q[4 + 3 * j];
  }
  reinterpret_cast<float4*>(s_out)[row * k + j] = make_float4(
      static_cast<float>((total - b0) - (b1 - both)), static_cast<float>(b0 - both),
      static_cast<float>(b1 - both), static_cast<float>(both));
}

template <int KB>
cudaError_t launch_pergenome_planes(unsigned blocks, cudaStream_t s, const float* ps,
                                    const float* ws, const int32_t* perm, const uint64_t* codes,
                                    const double* tile_sums, const float* freqs, float* partials,
                                    int64_t tiles, int64_t c_total, int64_t n,
                                    int64_t tiles_per_row, int k) {
  pergenome_planes_kernel<KB><<<blocks, kPgThreads, 0, s>>>(
      ps, ws, perm, codes, tile_sums, freqs, partials, tiles, c_total, n, tiles_per_row, k);
  return cudaGetLastError();
}

// ---- the exact forwards' coefficients ------------------------------------------

constexpr int kExWarps = 16;  // a shared-route block: one slice row, a tile a warp
constexpr int kExThreads = kExWarps * kLanes;
constexpr int kExSteps = 8;  // steps of 64 positions a shared-route tile
constexpr int64_t kExTile = kExSteps * 2 * kLanes;  // 512 positions
constexpr int kExReduceWarps = 4;

// delta alone, as `coefficient` computes it (the forward needs no slope)
__device__ __forceinline__ float coefficient_value(float w, float cbar, float xi,
                                                   float half_xi) {
  float sn, dsn;
  sinc_and_slope(half_xi * w, sn, dsn);
  const float sw = kSqrt2 * w;
  return sw * cospif(xi * cbar) * sn;
}

// A step of a warp's walk: lane l's pair of weights (wa, wb) at positions
// 2 l and 2 l + 1 of the step. Gives each position's cbar and adds the
// step's weights to the prefix hi + lo, compensated (Kahan), as
// pergenome_planes_kernel does.
__device__ __forceinline__ void pair_prefix(float wa, float wb, int lane, float& hi, float& lo,
                                            float& cbar_a, float& cbar_b) {
  const unsigned full = 0xffffffffu;
  float incl = wa + wb;  // the step's inclusive prefix of the lanes' pairs
#pragma unroll
  for (int d = 1; d < kLanes; d *= 2) {
    const float up = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += up;
  }
  const float total = __shfl_sync(full, incl, kLanes - 1);
  float before = __shfl_up_sync(full, incl, 1);
  if (lane == 0) before = 0.f;
  cbar_a = hi + (fmaf(0.5f, wa, before) + lo);
  cbar_b = hi + ((before + fmaf(0.5f, wb, wa)) + lo);
  const float y = total + lo, sum = hi + y;
  lo = y - (sum - hi);
  hi = sum;
}

// The exact per-genome route: one warp a tile of kPgTile positions of one
// row (row b C + c: item b, slice c), walked as pergenome_planes_kernel
// walks it, from the row's earlier tiles' weights (tile_sums). Forward:
// partials[tile] = sum_p ps_p delta_p. Backward (kGrad): d_ps[row, p] =
// grad[row] delta_p at every position of the tile, zero-weight steps
// included, and partials[tile] = sum_p ps_p ddelta_p.
template <bool kGrad>
__global__ void __launch_bounds__(kPgThreads)
exact_rows_kernel(const float* __restrict__ ps, const float* __restrict__ ws,
                  const double* __restrict__ tile_sums, const float* __restrict__ freqs,
                  const float* __restrict__ grad, float* __restrict__ d_ps,
                  float* __restrict__ partials, int64_t tiles, int64_t c_total, int64_t n,
                  int64_t tiles_per_row) {
  constexpr int kStep = 2 * kLanes;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % kLanes;
  const int64_t tile = int64_t(blockIdx.x) * kPgWarps + threadIdx.x / kLanes;
  if (tile >= tiles) return;  // the whole warp
  const int64_t row = tile / tiles_per_row, t = tile - row * tiles_per_row;
  const float xi = freqs[row % c_total], half_xi = 0.5f * xi;
  const float g = kGrad ? grad[row] : 0.f;

  double start = 0.0;
  for (int64_t u = lane; u < t; u += kLanes) start += tile_sums[row * tiles_per_row + u];
  start = warp_sum(start);
  float hi = static_cast<float>(start);
  float lo = static_cast<float>(start - static_cast<double>(hi));

  const int64_t begin = t * kPgTile;
  const int64_t end = begin + kPgTile < n ? begin + kPgTile : n;
  const int steps = static_cast<int>((end - begin + kStep - 1) / kStep);
  const float* ps_row = ps + row * n;
  const float* ws_row = ws + row * n;
  float* dps_row = kGrad ? d_ps + row * n : nullptr;
  // a lane's two positions' weight and projection two steps ahead
  auto load = [&](int64_t p, float& w, float& x) {
    const bool in = p < end;
    w = in ? ws_row[p] : 0.f;
    x = in ? ps_row[p] : 0.f;
  };
  int64_t p = begin + 2 * lane;
  float wa0, xa0, wb0, xb0, wa1, xa1, wb1, xb1;
  load(p, wa0, xa0);
  load(p + 1, wb0, xb0);
  load(p + kStep, wa1, xa1);
  load(p + kStep + 1, wb1, xb1);
  float acc = 0.f;
#pragma unroll 1
  for (int r = 0; r < steps; ++r, p += kStep) {
    float wa2, xa2, wb2, xb2;
    load(p + 2 * kStep, wa2, xa2);
    load(p + 2 * kStep + 1, wb2, xb2);
    float da = 0.f, db = 0.f;
    // a step of zero weights (padding, past the row's end) adds nothing
    if (__any_sync(full, wa0 != 0.f || wb0 != 0.f)) {
      float cbar_a, cbar_b;
      pair_prefix(wa0, wb0, lane, hi, lo, cbar_a, cbar_b);
      if (kGrad) {
        float dda, ddb;
        coefficient(wa0, cbar_a, xi, half_xi, da, dda);
        coefficient(wb0, cbar_b, xi, half_xi, db, ddb);
        acc = fmaf(xa0, dda, acc);
        acc = fmaf(xb0, ddb, acc);
      } else {
        da = coefficient_value(wa0, cbar_a, xi, half_xi);
        db = coefficient_value(wb0, cbar_b, xi, half_xi);
        acc = fmaf(xa0, da, acc);
        acc = fmaf(xb0, db, acc);
      }
    }
    if (kGrad) {
      if (p < end) dps_row[p] = g * da;
      if (p + 1 < end) dps_row[p + 1] = g * db;
    }
    wa0 = wa1;
    xa0 = xa1;
    wb0 = wb1;
    xb0 = xb1;
    wa1 = wa2;
    xa1 = xa2;
    wb1 = wb2;
    xb1 = xb2;
  }
  acc = warp_sum(acc);
  if (lane == 0) partials[tile] = acc;
}

// out[o] = sum_{b < nb} scale_b sum_t partials[row, t], row = b c_total + o,
// scale_b = grad[row] (1 without grad): one warp an output, a row's tiles
// summed in double in a fixed order (lane l takes tiles l, l + 32, ..., then
// a butterfly) and the rows in b order, so two launches give the same bits.
// The forward takes nb = 1 and c_total = rows (out = E); the backward nb =
// B (out = d xi).
__global__ void __launch_bounds__(kExReduceWarps * kLanes)
exact_rows_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ grad,
                         float* __restrict__ out, int64_t outs, int64_t nb, int64_t c_total,
                         int64_t tiles_per_row) {
  const int lane = threadIdx.x % kLanes;
  const int64_t o = int64_t(blockIdx.x) * kExReduceWarps + threadIdx.x / kLanes;
  if (o >= outs) return;  // the whole warp
  double acc = 0.0;
  for (int64_t b = 0; b < nb; ++b) {
    const int64_t row = b * c_total + o;
    double s = 0.0;
    for (int64_t t = lane; t < tiles_per_row; t += kLanes) s += partials[row * tiles_per_row + t];
    s = warp_sum(s);
    acc += grad ? static_cast<double>(grad[row]) * s : s;
  }
  if (lane == 0) out[o] = static_cast<float>(acc);
}

// The exact shared route: one block a slice row c of V sorted positions,
// cut into tiles of kExTile, tile t walked by warp t mod kExWarps; the
// items in groups of kItems, a group's weights wn[i, perm[c, p]] read from
// shared memory where the block stages them (kStaged: every tile its own
// warp's, and V + 1 float4 entries fit), from device memory otherwise.
// Forward (a block an item group, blockIdx.y): out[i, c] = sum_p ps[c, p]
// delta_{i, p}. Backward (kGrad, a block every group): d_ps[c, p] = sum_i
// grad[i, c] delta_{i, p}, summed over the batch in registers and written
// once a tile; out[c] = d xi_c = sum_i grad[i, c] sum_p ps[c, p]
// ddelta_{i, p}. Unstaged, tsum (n, C, tiles) holds each tile's weights of
// each item in double; staged, the group's tile sums stay in shared memory.
template <bool kGrad, bool kStaged>
__global__ void __launch_bounds__(kExThreads, 1)
exact_shared_kernel(const float* __restrict__ ps, const int32_t* __restrict__ perm,
                    const float* __restrict__ wn, const float* __restrict__ freqs,
                    const float* __restrict__ grad, double* __restrict__ tsum,
                    float* __restrict__ out, float* __restrict__ d_ps, int64_t n,
                    int64_t c_total, int64_t v, int64_t tiles_per_row) {
  constexpr int kStep = 2 * kLanes;
  const unsigned full = 0xffffffffu;
  extern __shared__ float4 ex_smem[];
  float4* w_smem = ex_smem;  // kStaged: V + 1 entries, the last one zero
  const float* w_items = reinterpret_cast<const float*>(ex_smem);
  double* tile_s = reinterpret_cast<double*>(ex_smem + (kStaged ? v + 1 : 0));  // [warp][item]
  double* part_s = tile_s + kExWarps * kItems;  // forward [warp][item], backward [warp]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int64_t c = blockIdx.x;
  const float xi = freqs[c], half_xi = 0.5f * xi;
  const float* ps_row = ps + c * v;
  const int32_t* perm_row = perm + c * v;
  const int64_t groups = (n + kItems - 1) / kItems;
  const int64_t g_begin = kGrad ? 0 : blockIdx.y, g_end = kGrad ? groups : g_begin + 1;
  const int64_t sweeps = (tiles_per_row + kExWarps - 1) / kExWarps;  // 1 when staged
  // weight of item i0 + it at column col (col == V past the row's end: 0)
  auto weight = [&](int64_t i0, int it, int32_t col) -> float {
    if (kStaged) return w_items[4 * int64_t(col) + it];
    return (col < v && i0 + it < n) ? __ldg(wn + (i0 + it) * v + col) : 0.f;
  };
  if (lane == 0) {
    for (int it = 0; it < kItems; ++it) part_s[warp * kItems + it] = 0.0;
  }

  if (!kStaged) {
    // every tile's weights of the block's items, in double
    for (int64_t t = warp; t < tiles_per_row; t += kExWarps) {
      for (int64_t gr = g_begin; gr < g_end; ++gr) {
        const int64_t i0 = gr * kItems;
        for (int it = 0; it < kItems && i0 + it < n; ++it) {
          double s = 0.0;
          for (int64_t q = lane; q < kExTile; q += kLanes) {
            const int64_t p = t * kExTile + q;
            if (p < v) s += weight(i0, it, perm_row[p]);
          }
          s = warp_sum(s);
          if (lane == 0) tsum[((i0 + it) * c_total + c) * tiles_per_row + t] = s;
        }
      }
    }
    __syncthreads();
  }

  float gx = 0.f;
  for (int64_t sw = 0; sw < sweeps; ++sw) {
    const int64_t t = sw * kExWarps + warp;
    const bool active = t < tiles_per_row;
    // the tile's columns and projections: step s, lane l at positions
    // t kExTile + 64 s + 2 l + h; past V column V (weight 0), projection 0
    int32_t col[kExSteps][2];
    float x[kExSteps][2], dps[kExSteps][2];
#pragma unroll
    for (int s = 0; s < kExSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t p = t * kExTile + s * kStep + 2 * lane + h;
        const bool in = active && p < v;
        col[s][h] = in ? perm_row[p] : static_cast<int32_t>(v);
        x[s][h] = in ? ps_row[p] : 0.f;
        dps[s][h] = 0.f;
      }
    }
    for (int64_t gr = g_begin; gr < g_end; ++gr) {
      const int64_t i0 = gr * kItems;
      if (kStaged) {
        __syncthreads();  // the previous group's weights and sums are spent
        for (int64_t cl = threadIdx.x; cl <= v; cl += kExThreads) {
          float e[kItems];
#pragma unroll
          for (int it = 0; it < kItems; ++it) {
            e[it] = (cl < v && i0 + it < n) ? wn[(i0 + it) * v + cl] : 0.f;
          }
          w_smem[cl] = make_float4(e[0], e[1], e[2], e[3]);
        }
        __syncthreads();
        double s[kItems] = {};
#pragma unroll
        for (int st = 0; st < kExSteps; ++st) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 w4 = w_smem[col[st][h]];
            s[0] += w4.x;
            s[1] += w4.y;
            s[2] += w4.z;
            s[3] += w4.w;
          }
        }
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          s[it] = warp_sum(s[it]);
          if (lane == 0) tile_s[warp * kItems + it] = s[it];
        }
        __syncthreads();
      }
      if (!active) continue;
#pragma unroll 1
      for (int it = 0; it < kItems; ++it) {
        const int64_t i = i0 + it;
        if (i >= n) break;
        // the tile's starting prefix, the row's earlier tiles summed in
        // double in a fixed order, enters the walk as hi + lo
        double start = 0.0;
        if (kStaged) {
          for (int u = 0; u < warp; ++u) start += tile_s[u * kItems + it];
        } else {
          for (int64_t u = lane; u < t; u += kLanes) {
            start += tsum[(i * c_total + c) * tiles_per_row + u];
          }
          start = warp_sum(start);
        }
        float hi = static_cast<float>(start);
        float lo = static_cast<float>(start - static_cast<double>(hi));
        const float gi = kGrad ? grad[i * c_total + c] : 0.f;
        float acc = 0.f;
#pragma unroll
        for (int st = 0; st < kExSteps; ++st) {
          const float wa = weight(i0, it, col[st][0]), wb = weight(i0, it, col[st][1]);
          if (__any_sync(full, wa != 0.f || wb != 0.f)) {
            float cbar_a, cbar_b;
            pair_prefix(wa, wb, lane, hi, lo, cbar_a, cbar_b);
            if (kGrad) {
              float da, dda, db, ddb;
              coefficient(wa, cbar_a, xi, half_xi, da, dda);
              coefficient(wb, cbar_b, xi, half_xi, db, ddb);
              dps[st][0] = fmaf(gi, da, dps[st][0]);
              dps[st][1] = fmaf(gi, db, dps[st][1]);
              acc = fmaf(x[st][0], dda, acc);
              acc = fmaf(x[st][1], ddb, acc);
            } else {
              acc = fmaf(x[st][0], coefficient_value(wa, cbar_a, xi, half_xi), acc);
              acc = fmaf(x[st][1], coefficient_value(wb, cbar_b, xi, half_xi), acc);
            }
          }
        }
        if (kGrad) {
          gx = fmaf(gi, acc, gx);
        } else {
          acc = warp_sum(acc);
          if (lane == 0) part_s[warp * kItems + it] += acc;
        }
      }
    }
    if (kGrad && active) {
#pragma unroll
      for (int s = 0; s < kExSteps; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t p = t * kExTile + s * kStep + 2 * lane + h;
          if (p < v) d_ps[c * v + p] = dps[s][h];
        }
      }
    }
  }

  // the warps' sums, in warp order, in double
  if (kGrad) {
    gx = warp_sum(gx);
    if (lane == 0) part_s[warp * kItems] = gx;
  }
  __syncthreads();
  if (kGrad) {
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int w = 0; w < kExWarps; ++w) s += part_s[w * kItems];
      out[c] = static_cast<float>(s);
    }
  } else if (threadIdx.x < kItems) {
    const int64_t i = g_begin * kItems + threadIdx.x;
    if (i < n) {
      double s = 0.0;
      for (int w = 0; w < kExWarps; ++w) s += part_s[w * kItems + threadIdx.x];
      out[i * c_total + c] = static_cast<float>(s);
    }
  }
}

// shared memory of a shared-route block: the staged weights, then the
// tile sums and the warps' sums
int64_t exact_shared_smem(bool staged, int64_t v) {
  return (staged ? (v + 1) * int64_t(sizeof(float4)) : 0) +
         2 * kExWarps * kItems * int64_t(sizeof(double));
}

// whether a shared-route block stages its weights: every tile its own warp's
// and the entries fit; -1 if the card cannot be queried
int exact_shared_staged(int64_t v) {
  int smem = 0;
  if (device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &smem) != 0) return -1;
  const int64_t tiles = (v + kExTile - 1) / kExTile;
  return tiles <= kExWarps && exact_shared_smem(true, v) <= smem ? 1 : 0;
}

template <bool kGrad, bool kStaged>
cudaError_t launch_exact_shared(dim3 grid, cudaStream_t s, const float* ps, const int32_t* perm,
                                const float* wn, const float* freqs, const float* grad,
                                double* tsum, float* out, float* d_ps, int64_t n,
                                int64_t c_total, int64_t v, int64_t tiles_per_row) {
  const int smem = static_cast<int>(exact_shared_smem(kStaged, v));
  cudaError_t err = cudaFuncSetAttribute(exact_shared_kernel<kGrad, kStaged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  exact_shared_kernel<kGrad, kStaged><<<grid, kExThreads, smem, s>>>(
      ps, perm, wn, freqs, grad, tsum, out, d_ps, n, c_total, v, tiles_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lazy_refresh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest V whose weight rows a block stages in shared memory on the
// current card (16 B an entry and one zero entry); -1 if the card cannot be
// queried.
int64_t lazy_refresh_staged_vocab_max() {
  int smem = 0;
  if (device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &smem) != 0) return -1;
  return int64_t(smem) / int64_t(sizeof(float4)) - 1;
}

// Launches the records pass and the planes kernel on `stream` without
// synchronising; returns the first error of a device query,
// cudaFuncSetAttribute or a launch, 0 on success.
// wn: f32 (n, V) normalised weight rows; ps: f32 (C, V) sorted projections;
// perm: int32 (C, V), a permutation of [0, V) in every row; digits: int64
// (V, k) bases in 0..3; freqs: f32 (C,); records: int32 (3, C, rec_len)
// scratch, rec_len = V rounded up to a multiple of 32; s_out: f32
// (n, C, k, 4); g2_out: f32 (n, C). Every row is contiguous.
int lazy_refresh_launch(const void* wn, const void* ps, const void* perm, const void* digits,
                        const void* freqs, void* records, void* s_out, void* g2_out, int64_t n,
                        int64_t c_total, int64_t v, int k, int64_t rec_len, void* stream) {
  if (n < 1 || c_total < 1 || v < 1 || v > kMaxVocab || k < 1 || k > kMaxK ||
      rec_len != record_len(v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, smem_max = 0;
  int err = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (err == 0) err = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &smem_max);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* rec_col = static_cast<int32_t*>(records);
  float* rec_ps = reinterpret_cast<float*>(rec_col + c_total * rec_len);
  int32_t* rec_code = rec_col + 2 * c_total * rec_len;
  const int64_t r_len = rec_len / kLanes;

  const int64_t entries = c_total * rec_len;
  records_kernel<<<static_cast<unsigned>((entries + kRecordThreads - 1) / kRecordThreads),
                   kRecordThreads, 0, s>>>(
      static_cast<const int32_t*>(perm), static_cast<const float*>(ps),
      static_cast<const int64_t*>(digits), rec_col, rec_ps, rec_code, c_total, v, r_len, k);
  cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);

  // slices a block: 4 a warp where that leaves at least 4 blocks an SM,
  // fewer for small problems so that every SM gets work
  const int64_t groups = (n + kItems - 1) / kItems;
  int64_t per_warp = 4;
  while (per_warp > 1 && groups * ((c_total + kWarps * per_warp - 1) / (kWarps * per_warp)) <
                             4 * int64_t(sms)) {
    per_warp /= 2;
  }
  const int64_t slices_per_block = kWarps * per_warp;
  const int64_t tiles = (c_total + slices_per_block - 1) / slices_per_block;
  if (groups > 0x7fffffff || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(tiles));
  const bool staged = (v + 1) * int64_t(sizeof(float4)) <= smem_max;
  const float* w = static_cast<const float*>(wn);
  const float* f = static_cast<const float*>(freqs);
  float* so = static_cast<float*>(s_out);
  float* go = static_cast<float*>(g2_out);
  const int r = static_cast<int>(r_len);
  switch (k) {
#define LAZY_REFRESH_CASE(K)                                                                   \
  case K:                                                                                      \
    launch = launch_planes<K>(staged, grid, s, w, rec_col, rec_ps, rec_code, f, so, go, n,      \
                              c_total, v, r, slices_per_block);                                \
    break;
    LAZY_REFRESH_CASE(1)
    LAZY_REFRESH_CASE(2)
    LAZY_REFRESH_CASE(3)
    LAZY_REFRESH_CASE(4)
    LAZY_REFRESH_CASE(5)
    LAZY_REFRESH_CASE(6)
    LAZY_REFRESH_CASE(7)
    LAZY_REFRESH_CASE(8)
    LAZY_REFRESH_CASE(9)
#undef LAZY_REFRESH_CASE
  }
  return static_cast<int>(launch);
}

// Positions of a tile of the per-genome route: a row of N positions takes
// ceil(N / tile) tiles.
int64_t lazy_refresh_pergenome_tile() { return kPgTile; }

// Launches the per-genome route's four kernels on `stream` without
// synchronising; returns the first error of a launch, 0 on success.
// ps, ws: f32 (G C, N) sorted projections and weights of the G items' C
// slices (row g C + c); perm: int32 (G C, N), each row's columns in sorted
// order; digits: int64 (G, N, k) bases in 0..3; freqs: f32 (C,); codes:
// uint64 (G, N), tile_sums: f64 (G C, tiles_per_row) and partials: f32
// (G C, tiles_per_row, 3k + 2) scratch, tiles_per_row = ceil(N / tile);
// s_out: f32 (G, C, k, 4); g2_out: f32 (G, C). Every row is contiguous.
int lazy_refresh_pergenome_launch(const void* ps, const void* ws, const void* perm,
                                  const void* digits, const void* freqs, void* codes,
                                  void* tile_sums, void* partials, void* s_out, void* g2_out,
                                  int64_t g, int64_t c_total, int64_t n, int k,
                                  int64_t tiles_per_row, void* stream) {
  if (g < 1 || c_total < 1 || n < 1 || n > INT32_MAX || k < 1 || k > kPgMaxK ||
      tiles_per_row != (n + kPgTile - 1) / kPgTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = g * c_total, tiles = rows * tiles_per_row;
  const int64_t tile_blocks = (tiles + kPgWarps - 1) / kPgWarps;
  const int64_t code_blocks = (g * n + kCodeThreads - 1) / kCodeThreads;
  const int64_t reduce_blocks = (rows * (k + 1) + kReduceThreads - 1) / kReduceThreads;
  if (tile_blocks > INT32_MAX || code_blocks > INT32_MAX || reduce_blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* code = static_cast<uint64_t*>(codes);
  double* sums = static_cast<double*>(tile_sums);
  float* part = static_cast<float*>(partials);
  const float* p = static_cast<const float*>(ps);
  const float* w = static_cast<const float*>(ws);
  const int32_t* col = static_cast<const int32_t*>(perm);
  const float* f = static_cast<const float*>(freqs);

  codes_kernel<<<static_cast<unsigned>(code_blocks), kCodeThreads, 0, s>>>(
      static_cast<const int64_t*>(digits), code, g * n, k);
  cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);
  tile_sums_kernel<<<static_cast<unsigned>(tile_blocks), kPgThreads, 0, s>>>(w, sums, tiles, n,
                                                                             tiles_per_row);
  launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);
  // a few bucket widths of k, not one template a k: the build counts in set-up
  const unsigned blocks = static_cast<unsigned>(tile_blocks);
  if (k <= 10) {
    launch = launch_pergenome_planes<10>(blocks, s, p, w, col, code, sums, f, part, tiles,
                                         c_total, n, tiles_per_row, k);
  } else if (k <= 16) {
    launch = launch_pergenome_planes<16>(blocks, s, p, w, col, code, sums, f, part, tiles,
                                         c_total, n, tiles_per_row, k);
  } else {
    launch = launch_pergenome_planes<kPgMaxK>(blocks, s, p, w, col, code, sums, f, part, tiles,
                                              c_total, n, tiles_per_row, k);
  }
  if (launch != cudaSuccess) return static_cast<int>(launch);
  pergenome_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, s>>>(
      part, static_cast<float*>(s_out), static_cast<float*>(g2_out), rows, tiles_per_row, k);
  return static_cast<int>(cudaGetLastError());
}

// Launches the exact per-genome route's coefficients on `stream` without
// synchronising; returns the first error of a launch, 0 on success.
// ps, ws: f32 (R, N) sorted projections and weights, row b C + c for item b
// and slice c (R = B C); freqs: f32 (C,); tile_sums: f64 (R, tiles_per_row)
// and partials: f32 (R, tiles_per_row), tiles_per_row = ceil(N / tile).
// Forward (grad null): writes tile_sums and out = E, f32 (R,). Backward:
// reads the forward's tile_sums and grad, f32 (R,), and writes d_ps, f32
// (R, N), and out = d xi, f32 (C,). Every row is contiguous.
int lazy_refresh_exact_rows_launch(const void* ps, const void* ws, const void* freqs,
                                   const void* grad, void* tile_sums, void* partials, void* d_ps,
                                   void* out, int64_t rows, int64_t c_total, int64_t n,
                                   int64_t tiles_per_row, void* stream) {
  if (rows < 1 || c_total < 1 || rows % c_total != 0 || n < 1 || n > INT32_MAX ||
      tiles_per_row != (n + kPgTile - 1) / kPgTile || (grad != nullptr && d_ps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = rows * tiles_per_row;
  const int64_t tile_blocks = (tiles + kPgWarps - 1) / kPgWarps;
  const int64_t outs = grad ? c_total : rows;
  const int64_t reduce_blocks = (outs + kExReduceWarps - 1) / kExReduceWarps;
  if (tile_blocks > INT32_MAX || reduce_blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(ps);
  const float* w = static_cast<const float*>(ws);
  const float* f = static_cast<const float*>(freqs);
  const float* g = static_cast<const float*>(grad);
  double* sums = static_cast<double*>(tile_sums);
  float* part = static_cast<float*>(partials);
  const unsigned blocks = static_cast<unsigned>(tile_blocks);
  cudaError_t launch;
  if (g == nullptr) {
    tile_sums_kernel<<<blocks, kPgThreads, 0, s>>>(w, sums, tiles, n, tiles_per_row);
    launch = cudaGetLastError();
    if (launch != cudaSuccess) return static_cast<int>(launch);
    exact_rows_kernel<false><<<blocks, kPgThreads, 0, s>>>(p, w, sums, f, nullptr, nullptr, part,
                                                           tiles, c_total, n, tiles_per_row);
  } else {
    exact_rows_kernel<true><<<blocks, kPgThreads, 0, s>>>(
        p, w, sums, f, g, static_cast<float*>(d_ps), part, tiles, c_total, n, tiles_per_row);
  }
  launch = cudaGetLastError();
  if (launch != cudaSuccess) return static_cast<int>(launch);
  // forward: E[row] over each row's tiles; backward: d xi[c] over the B rows of slice c
  exact_rows_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kExReduceWarps * kLanes, 0,
                             s>>>(part, g, static_cast<float*>(out), outs,
                                  g ? rows / c_total : 1, g ? c_total : rows, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

// Positions of a tile of the exact shared route.
int64_t lazy_refresh_exact_shared_tile() { return kExTile; }

// Doubles of device scratch a launch of the exact shared route takes for n
// items, C slices and V entries: 0 where its blocks stage the weights,
// n C ceil(V / tile) otherwise; -1 if the card cannot be queried.
int64_t lazy_refresh_exact_shared_scratch(int64_t n, int64_t c_total, int64_t v) {
  const int staged = exact_shared_staged(v);
  if (staged < 0) return -1;
  return staged ? 0 : n * c_total * ((v + kExTile - 1) / kExTile);
}

// Launches the exact shared route's coefficients on `stream` without
// synchronising; returns the first error of a device query,
// cudaFuncSetAttribute or the launch, 0 on success.
// ps: f32 (C, V) sorted projections; perm: int32 (C, V), a permutation of
// [0, V) in every row; wn: f32 (n, V) normalised weight rows; freqs: f32
// (C,); scratch: f64, scratch_len = lazy_refresh_exact_shared_scratch(n, C,
// V) entries (null when 0). Forward (grad null): out = E, f32 (n, C).
// Backward: grad f32 (n, C); writes d_ps, f32 (C, V), and out = d xi, f32
// (C,). Every row is contiguous.
int lazy_refresh_exact_shared_launch(const void* ps, const void* perm, const void* wn,
                                     const void* freqs, const void* grad, void* scratch,
                                     void* d_ps, void* out, int64_t n, int64_t c_total,
                                     int64_t v, int64_t scratch_len, void* stream) {
  if (n < 1 || c_total < 1 || c_total > INT32_MAX || v < 1 || v > INT32_MAX - 1 ||
      (grad != nullptr && d_ps == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int staged = exact_shared_staged(v);
  if (staged < 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t tiles_per_row = (v + kExTile - 1) / kExTile;
  const int64_t groups = (n + kItems - 1) / kItems;
  if (scratch_len != (staged ? 0 : n * c_total * tiles_per_row) ||
      (!staged && scratch == nullptr) || (grad == nullptr && groups > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(ps);
  const int32_t* col = static_cast<const int32_t*>(perm);
  const float* w = static_cast<const float*>(wn);
  const float* f = static_cast<const float*>(freqs);
  const float* g = static_cast<const float*>(grad);
  double* ts = static_cast<double*>(scratch);
  float* o = static_cast<float*>(out);
  float* dp = static_cast<float*>(d_ps);
  const dim3 grid(static_cast<unsigned>(c_total), g ? 1u : static_cast<unsigned>(groups));
  cudaError_t launch;
  if (g == nullptr) {
    launch = staged ? launch_exact_shared<false, true>(grid, s, p, col, w, f, g, ts, o, dp, n,
                                                       c_total, v, tiles_per_row)
                    : launch_exact_shared<false, false>(grid, s, p, col, w, f, g, ts, o, dp, n,
                                                        c_total, v, tiles_per_row);
  } else {
    launch = staged ? launch_exact_shared<true, true>(grid, s, p, col, w, f, g, ts, o, dp, n,
                                                      c_total, v, tiles_per_row)
                    : launch_exact_shared<true, false>(grid, s, p, col, w, f, g, ts, o, dp, n,
                                                       c_total, v, tiles_per_row);
  }
  return static_cast<int>(launch);
}

}  // extern "C"
