// Development variants of csrc/scatter_scores.cu, built only by
// tools/scatter_sweep.py.  The main one: the tail updates binned by score-matrix region with
// a counting sort, then applied in region order.  Measured slower than the
// shipped one-pass kernel at every region width (PERF.md), so it is kept
// here, as the record of that measurement, and not on any path.
//
// A region is kRegionDocs docs of one query row; one C call launches four
// passes on the caller's stream:
//   1. count: each live update adds one to its region's count (one atomic a
//      warp and region, lanes grouped by __match_any_sync);
//   2. scan: one block turns the counts into exclusive offsets in place and
//      writes the live total after them;
//   3. bin: each live update is written to its region's range through the
//      offsets, used as cursors, as one 8-byte word (cell offset, fp32 value
//      bits), so the cell must fit 32 bits;
//   4. apply: the binned words are streamed in update order, one fp32 atomic
//      add with its result unused each.
// Scratch (the counts and the binned words) comes from the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegionLog2 = 14;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanPerThread = 16;
constexpr unsigned kFull = 0xffffffffu;

struct FlatSource {
  const int* d;
  const float* v;
  const int* r;
  long long e;

  __host__ __device__ __forceinline__ long long size() const { return e; }
  __device__ __forceinline__ bool live(long long i, int& doc, int& row) const {
    if (__ldg(v + i) == 0.f) return false;
    doc = __ldg(d + i);
    row = __ldg(r + i);
    return true;
  }
  __device__ __forceinline__ float value(long long i) const { return __ldg(v + i); }
};

struct ChunkSource {
  const int* docs;
  const float* vals;
  const int* starts;
  const int* lengths;
  const int* rows;
  long long n_chunks;
  int chunk;

  __host__ __device__ __forceinline__ long long size() const { return n_chunks * chunk; }
  __device__ __forceinline__ long long pos(long long i) const {
    const long long c = i / chunk;
    return static_cast<long long>(__ldg(starts + c)) + (i - c * chunk);
  }
  __device__ __forceinline__ bool live(long long i, int& doc, int& row) const {
    const long long c = i / chunk;
    const int lane = static_cast<int>(i - c * chunk);
    if (lane >= __ldg(lengths + c)) return false;
    doc = __ldg(docs + static_cast<long long>(__ldg(starts + c)) + lane);
    row = __ldg(rows + c);
    return doc >= 0;
  }
  __device__ __forceinline__ float value(long long i) const { return __ldg(vals + pos(i)); }
};

struct Shape {
  int nq;
  long long n_pad;
  int regions_per_row;
};

// The region and cell of update i, or false if it is padding or lies outside
// the matrix.
template <class Src>
__device__ __forceinline__ bool locate(const Src& src, long long i, const Shape& s,
                                       int& region, uint32_t& cell) {
  int doc, row;
  if (!src.live(i, doc, row)) return false;
  if (static_cast<unsigned long long>(doc) >= static_cast<unsigned long long>(s.n_pad) ||
      static_cast<unsigned>(row) >= static_cast<unsigned>(s.nq)) {
    return false;
  }
  region = row * s.regions_per_row + (doc >> kRegionLog2);
  cell = static_cast<uint32_t>(static_cast<long long>(row) * s.n_pad + doc);
  return true;
}

// Warp-uniform grid-stride loop over the updates: each warp takes 32
// consecutive updates a step, so __ballot_sync and __match_any_sync see the
// whole warp.
template <class Src>
__global__ void __launch_bounds__(kThreads)
scatter_count(Src src, Shape s, int* counts) {
  const int lane = threadIdx.x & 31;
  const long long n = src.size();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    int region = 0;
    uint32_t cell;
    const bool ok = i < n && locate(src, i, s, region, cell);
    const unsigned live = __ballot_sync(kFull, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(live, region);
      if (lane == __ffs(peers) - 1) atomicAdd(counts + region, __popc(peers));
    }
  }
}

// counts[0, nb) -> exclusive offsets in place; counts[nb] = the live total.
// One block, tiles of kScanThreads * kScanPerThread counts.
__global__ void __launch_bounds__(kScanThreads) scatter_scan(int* counts, int nb) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int t0 = 0; t0 < nb; t0 += kScanThreads * kScanPerThread) {
    const int b0 = t0 + threadIdx.x * kScanPerThread;
    int x[kScanPerThread];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPerThread; ++k) {
      x[k] = b0 + k < nb ? counts[b0 + k] : 0;
      sum += x[k];
    }
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    int at = carry + (warp ? warp_sums[warp - 1] : 0) + inc - sum;
#pragma unroll
    for (int k = 0; k < kScanPerThread; ++k) {
      if (b0 + k < nb) counts[b0 + k] = at;
      at += x[k];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[nb] = carry;
}

template <class Src>
__global__ void __launch_bounds__(kThreads)
scatter_bin(Src src, Shape s, int* cursors, unsigned long long* binned) {
  const int lane = threadIdx.x & 31;
  const long long n = src.size();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    int region = 0;
    uint32_t cell = 0;
    const bool ok = i < n && locate(src, i, s, region, cell);
    const unsigned live = __ballot_sync(kFull, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(live, region);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(cursors + region, __popc(peers));
      at = __shfl_sync(live, at, leader) + __popc(peers & ((1u << lane) - 1));
      binned[at] = (static_cast<unsigned long long>(__float_as_uint(src.value(i))) << 32) | cell;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_apply(float* __restrict__ scores, const unsigned long long* __restrict__ binned,
              const int* __restrict__ total) {
  const long long n = *total;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long w = __ldg(binned + i);
    atomicAdd(scores + static_cast<uint32_t>(w), __uint_as_float(static_cast<uint32_t>(w >> 32)));
  }
}

// One thread per update, as the shipped kernel, plus an exact +0 to one cell
// of every other 32-byte sector of the update's aligned kSectors * 32-byte
// block, so that the whole block is dirty when L2 writes it back.
template <int kSectors>
__global__ void __launch_bounds__(kThreads)
scatter_padded(float* __restrict__ scores, const int* __restrict__ d,
               const float* __restrict__ v, const int* __restrict__ r, long long e, int nq,
               long long n_pad) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(scores);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(scores + static_cast<long long>(nq) * n_pad);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < e;
       i += stride) {
    const float val = __ldg(v + i);
    if (val == 0.f) continue;
    const int doc = __ldg(d + i), row = __ldg(r + i);
    if (static_cast<unsigned long long>(doc) >= static_cast<unsigned long long>(n_pad) ||
        static_cast<unsigned>(row) >= static_cast<unsigned>(nq)) {
      continue;
    }
    float* cell = scores + static_cast<long long>(row) * n_pad + doc;
    atomicAdd(cell, val);
    const uintptr_t a = reinterpret_cast<uintptr_t>(cell);
    const uintptr_t blk = a & ~static_cast<uintptr_t>(kSectors * 32 - 1);
#pragma unroll
    for (int k = 0; k < kSectors; ++k) {
      const uintptr_t sec = blk + 32 * k;
      if (sec != (a & ~static_cast<uintptr_t>(31)) && sec >= lo && sec < hi) {
        atomicAdd(reinterpret_cast<float*>(sec), 0.f);
      }
    }
  }
}

template <class Src>
int launch(const Src& src, float* scores, int nq, long long n_pad, int* counts,
           unsigned long long* binned, cudaStream_t stream) {
  const Shape s{nq, n_pad, static_cast<int>((n_pad + (1LL << kRegionLog2) - 1) >> kRegionLog2)};
  const int nb = nq * s.regions_per_row;
  long long blocks = (src.size() + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  const unsigned grid = static_cast<unsigned>(blocks);
  scatter_count<Src><<<grid, kThreads, 0, stream>>>(src, s, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_scan<<<1, kScanThreads, 0, stream>>>(counts, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_bin<Src><<<grid, kThreads, 0, stream>>>(src, s, counts, binned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_apply<<<grid, kThreads, 0, stream>>>(scores, binned, counts + nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Docs per region: the caller sizes the counts as nq * ceil(n_pad / this) + 1.
extern "C" int ili_scatter_region_docs() { return 1 << kRegionLog2; }

// Sets the device's L2 fetch granularity (bytes > 0) and returns the value
// in force afterwards.
extern "C" int ili_l2_fetch_granularity(int bytes) {
  if (bytes > 0) cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes);
  size_t now = 0;
  cudaDeviceGetLimit(&now, cudaLimitMaxL2FetchGranularity);
  return static_cast<int>(now);
}

// The padded one-pass kernel: sectors = 1 (no padding), 2 or 4.
extern "C" int ili_scatter_padded(float* scores, const int* d, const float* v, const int* r,
                                  long long e, int nq, long long n_pad, int sectors,
                                  void* stream) {
  long long blocks = (e + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sectors == 4) {
    scatter_padded<4><<<grid, kThreads, 0, st>>>(scores, d, v, r, e, nq, n_pad);
  } else if (sectors == 2) {
    scatter_padded<2><<<grid, kThreads, 0, st>>>(scores, d, v, r, e, nq, n_pad);
  } else {
    scatter_padded<1><<<grid, kThreads, 0, st>>>(scores, d, v, r, e, nq, n_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts: zeroed int32 [regions + 1]; binned: 8-byte words, one per update.
extern "C" int ili_scatter_scores(float* scores, const int* d, const float* v, const int* r,
                                  long long e, int nq, long long n_pad, int* counts,
                                  unsigned long long* binned, void* stream) {
  return launch(FlatSource{d, v, r, e}, scores, nq, n_pad, counts, binned,
                static_cast<cudaStream_t>(stream));
}

// counts as above; binned: one word per chunk slot (n_chunks * chunk).
extern "C" int ili_scatter_chunks(float* scores, const int* docs, const float* vals,
                                  const int* starts, const int* lengths, const int* rows,
                                  long long n_chunks, int chunk, int nq, long long n_pad,
                                  int* counts, unsigned long long* binned, void* stream) {
  return launch(ChunkSource{docs, vals, starts, lengths, rows, n_chunks, chunk}, scores, nq,
                n_pad, counts, binned, static_cast<cudaStream_t>(stream));
}
