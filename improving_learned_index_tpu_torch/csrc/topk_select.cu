// Device-resident exact selection for the exact top-k over integer-valued
// scores: each row's k-th score from one value histogram, and the per-256-doc
// block counts that the selection rank is built from.  No host read.
//
// Replaces: no Pallas kernel.  The JAX package's top-k
// (improving_learned_index_tpu/ops/exact_topk.py) leaves its selection to XLA
// and finds the k-th score by an n-ary search whose every pass is a host read
// of the convergence flag.  On this card those reads, one a pass, kept the
// host waiting for the whole batch's device work, and eager PyTorch's block
// counts (a padded copy, bool compares, int64 casts and sums) took ~12 ms a
// [64, 8.85M] batch.  These kernels take both away where the caller bounds
// the scores below kBins.
//
// Bound on this card: bytes.  Two reads of the [Q, N] fp32 matrix at most
// (Q x N x 4 B each at 3.35 TB/s: 1.35 ms at [64, 8,847,360]); the block
// counts read only the 256-doc blocks whose maximum reaches the row's k-th
// score, so in practice the bound is about one read.
//
// Design:
// - ili_topk_histogram: a grid of as many blocks as the card holds at once
//   walks the matrix as one row-major list of 256-doc selection blocks, each
//   block a contiguous share of it (every block the same work, one wave).  A
//   warp reads one selection block with two 16-byte streaming loads a lane
//   (scalar loads where the row is not 16-byte aligned, or at the ragged
//   end), adds each value v >= 1 to a shared [kBins] int32 histogram with a
//   shared-memory atomic, and writes the selection block's maximum bin.
//   (Warp-aggregated atomics, __match_any_sync over a warp's bins, measured
//   5.8x slower at [64, 8,847,360]: 4.366 ms against 0.748; the values of a
//   warp rarely share a bin.)
//   Where its share crosses into the next row, the block adds its non-zero
//   bins into the row's [kBins] histogram in device memory with one global
//   atomic each (the wrapper zeroes it) and clears them.  The row stride lets
//   it read a sliced view of a wider matrix without a copy.
// - ili_topk_kth: one block a row.  A block-wide scan of the histogram from
//   the top gives |{v >= s}| for every s; the row's k-th score s_k is the
//   number of s in [1, kBins) whose count reaches k, or 1 if none does.
// - ili_topk_block_counts: a warp owns 32 selection blocks of one row.  It
//   reads their maxima (when given), reads in turn each block whose maximum
//   reaches s_k, counts > s_k and == s_k with warp reductions, and writes the
//   two counts of all 32 blocks (0 for a skipped block) into [Q, nb] int32
//   tables.  Without maxima it reads every block.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 8192;      // values 0..8191: 32 KB of shared int32
constexpr int kBlockDocs = 256;  // selection block: one warp-wide read
constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kKthThreads = 1024;
constexpr int kKthPer = kBins / kKthThreads;
constexpr int kCountThreads = 256;
constexpr int kCountWarps = kCountThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The 256 docs of selection block b of a row: lane holds docs
// b * 256 + lane * 4 + {0..3} in v[0..3] and those 128 further in v[4..7];
// docs at or past n read 0.
template <bool kVec>
__device__ __forceinline__ void load_block(const float* __restrict__ row, long long n, long long b,
                                           int lane, float (&v)[8]) {
  const long long d0 = b * kBlockDocs + lane * 4;
  if (kVec && b * kBlockDocs + kBlockDocs <= n) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(row + d0));
    const float4 y = __ldcs(reinterpret_cast<const float4*>(row + d0 + 128));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = d0 + j < n ? __ldcs(row + d0 + j) : 0.f;
      v[4 + j] = d0 + 128 + j < n ? __ldcs(row + d0 + 128 + j) : 0.f;
    }
  }
}

// Adds a warp's 256 values into the shared histogram; returns the largest
// bin among them, in every lane.
__device__ __forceinline__ int add_block(int* h, const float (&v)[8]) {
  int m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bin = min(static_cast<int>(v[j]), kBins - 1);
    m = max(m, bin);
    if (bin > 0) atomicAdd(h + bin, 1);
  }
  return __reduce_max_sync(kFull, m);
}

template <bool kVec>
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const float* __restrict__ scores, long long n, long long ld, long long nb,
                 long long total, int* __restrict__ hist, int* __restrict__ block_max) {
  __shared__ int h[kBins];
  for (int i = threadIdx.x; i < kBins; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long t = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;
  while (t < t_end) {  // one pass a row segment of this block's share
    const long long row = t / nb;
    const long long lo = t - row * nb;
    const long long hi = min(t_end, (row + 1) * nb) - row * nb;
    const float* base = scores + row * ld;
    int* bmax = block_max + row * nb;
    for (long long b = lo + warp; b < hi; b += 2 * kHistWarps) {
      const long long b2 = b + kHistWarps;
      float v[8], w[8];
      load_block<kVec>(base, n, b, lane, v);
      if (b2 < hi) load_block<kVec>(base, n, b2, lane, w);
      const int m = add_block(h, v);
      if (lane == 0) bmax[b] = m;
      if (b2 < hi) {
        const int m2 = add_block(h, w);
        if (lane == 0) bmax[b2] = m2;
      }
    }
    __syncthreads();
    int* out = hist + row * kBins;
    for (int i = threadIdx.x; i < kBins; i += kHistThreads) {
      const int c = h[i];
      if (c) {
        atomicAdd(out + i, c);
        h[i] = 0;
      }
    }
    __syncthreads();
    t = row * nb + hi;
  }
}

__global__ void __launch_bounds__(kKthThreads)
kth_kernel(const int* __restrict__ hist, float* __restrict__ s_k, int k) {
  __shared__ int warp_sum[kKthThreads / 32];
  __shared__ int warp_cnt[kKthThreads / 32];
  const int* h = hist + static_cast<long long>(blockIdx.x) * kBins;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int c[kKthPer];
  int tot = 0;
#pragma unroll
  for (int j = 0; j < kKthPer; ++j) {
    const int s = tid * kKthPer + j;
    c[j] = s > 0 ? h[s] : 0;  // zero is never selected
    tot += c[j];
  }
  // inclusive prefix sum of the threads' totals over the block
  int x = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int incl = x + (warp > 0 ? warp_sum[warp - 1] : 0);
  int run = warp_sum[kKthThreads / 32 - 1] - incl;  // values in the bins above this thread's
  int cnt = 0;
#pragma unroll
  for (int j = kKthPer - 1; j >= 0; --j) {
    run += c[j];  // |{v >= tid * kKthPer + j}|
    cnt += (tid * kKthPer + j > 0 && run >= k) ? 1 : 0;
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < kKthThreads / 32; ++w) sum += warp_cnt[w];
    s_k[blockIdx.x] = static_cast<float>(max(sum, 1));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kCountThreads)
block_count_kernel(const float* __restrict__ scores, long long n, long long ld, long long nb,
                   const float* __restrict__ s_k, const int* __restrict__ block_max,
                   int* __restrict__ gt, int* __restrict__ eq) {
  const long long row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long g = (static_cast<long long>(blockIdx.x) * kCountWarps + (threadIdx.x >> 5)) * 32;
  if (g >= nb) return;  // the whole warp
  const float s = s_k[row];
  const float* base = scores + row * ld;
  const long long b = g + lane;
  const bool in = b < nb;
  const bool need = in && (block_max == nullptr || static_cast<float>(block_max[row * nb + b]) >= s);
  unsigned todo = __ballot_sync(kFull, need);
  int my_gt = 0, my_eq = 0;
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    float v[8];
    load_block<kVec>(base, n, g + j, lane, v);
    int cg = 0, ce = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cg += v[i] > s ? 1 : 0;
      ce += v[i] == s ? 1 : 0;
    }
    cg = __reduce_add_sync(kFull, cg);
    ce = __reduce_add_sync(kFull, ce);
    if (lane == j) {
      my_gt = cg;
      my_eq = ce;
    }
  }
  if (in) {
    gt[row * nb + b] = my_gt;
    eq[row * nb + b] = my_eq;
  }
}

// Blocks of the histogram kernel the card holds at once (cached a variant).
template <bool kVec>
long long histogram_grid() {
  static long long grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, histogram_kernel<kVec>, kHistThreads, 0);
    grid = static_cast<long long>(sms) * (per > 0 ? per : 1);
  }
  return grid;
}

template <bool kVec>
int launch_histogram(const float* scores, int q, long long n, long long ld, int* hist, int* block_max,
                     cudaStream_t s) {
  const long long nb = (n + kBlockDocs - 1) / kBlockDocs;
  const long long total = static_cast<long long>(q) * nb;
  const long long grid = histogram_grid<kVec>();
  histogram_kernel<kVec><<<static_cast<unsigned>(grid < total ? grid : total), kHistThreads, 0, s>>>(
      scores, n, ld, nb, total, hist, block_max);
  return static_cast<int>(cudaGetLastError());
}

bool vectorizable(const float* scores, long long ld) {
  return reinterpret_cast<unsigned long long>(scores) % 16 == 0 && ld % 4 == 0;
}

}  // namespace

// scores: [q, n] fp32 with row stride ld (elements), unit column stride;
// hist: [q, kBins] int32, zeroed; block_max: [q, ceil(n / 256)] int32.
extern "C" int ili_topk_histogram(const float* scores, int q, long long n, long long ld, int* hist,
                                  int* block_max, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vectorizable(scores, ld) ? launch_histogram<true>(scores, q, n, ld, hist, block_max, s)
                                  : launch_histogram<false>(scores, q, n, ld, hist, block_max, s);
}

// hist: [q, kBins] int32; s_k: [q] fp32, the k-th score of each row.
extern "C" int ili_topk_kth(const int* hist, float* s_k, int q, int k, void* stream) {
  kth_kernel<<<q, kKthThreads, 0, static_cast<cudaStream_t>(stream)>>>(hist, s_k, k);
  return static_cast<int>(cudaGetLastError());
}

// scores as ili_topk_histogram; s_k: [q] fp32; block_max: [q, nb] int32 or
// null (read every block); gt, eq: [q, nb] int32, every entry written.
extern "C" int ili_topk_block_counts(const float* scores, int q, long long n, long long ld, const float* s_k,
                                     const int* block_max, int* gt, int* eq, void* stream) {
  const long long nb = (n + kBlockDocs - 1) / kBlockDocs;
  const dim3 grid(static_cast<unsigned>((nb + 32LL * kCountWarps - 1) / (32LL * kCountWarps)),
                  static_cast<unsigned>(q));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorizable(scores, ld)) {
    block_count_kernel<true><<<grid, kCountThreads, 0, s>>>(scores, n, ld, nb, s_k, block_max, gt, eq);
  } else {
    block_count_kernel<false><<<grid, kCountThreads, 0, s>>>(scores, n, ld, nb, s_k, block_max, gt, eq);
  }
  return static_cast<int>(cudaGetLastError());
}
