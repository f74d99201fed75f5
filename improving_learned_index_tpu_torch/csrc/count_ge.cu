// Multi-threshold row count on Hopper: counts[q, a] = |{scores[q, :] >= t[q, a]}|
// for up to 128 thresholds a row; the per-pass count of the exact top-k's
// n-ary threshold search.
//
// Replaces: improving_learned_index_tpu/ops/count_ge.py::_count_kernel (TPU
// Pallas, wrapper count_ge).  The TPU kernel streams [Q, 16384] score tiles
// through VMEM along a sequential grid and accumulates one [Q, 128] count
// block in place across the grid steps.  Hopper has no sequential grid, so
// the reduction across the doc axis is split over blocks and finished with
// atomics.
//
// Bound on this card: bytes.  One read of the [Q, N] fp32 matrix (Q x N x 4 B
// at 3.35 TB/s); the T compares an element (7 in the search) are far below the
// fp32 rate.
//
// Design: grid (doc slice, row, threshold group of 8).  Each thread holds its
// group's 8 thresholds and 8 counts in registers and reads its part of the
// slice with 16-byte float4 loads when the row base is 16-byte aligned
// (base pointer and row stride), scalar loads otherwise.  Each value is
// compared against all 8 thresholds; a count is a float in registers (exact:
// at most 64 per thread per block), reduced in the warp as an int, then one
// int32 atomicAdd per (block, threshold) lands in an output the wrapper
// zeroes.  Integer counts are exact in any order.  The row stride lets the
// kernel read a sliced (non-contiguous) view of a wider score matrix without
// a copy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;   // thresholds a block counts, held in registers
constexpr int kIters = 16;  // float4 loads a thread makes in one block
constexpr long long kSlice = static_cast<long long>(kThreads) * 4 * kIters;  // docs a block

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const float* __restrict__ scores, const float* __restrict__ thresholds,
                int* __restrict__ out, long long n, long long ld, int n_thresh) {
  const int row = blockIdx.y;
  const int g0 = blockIdx.z * kGroup;
  float t[kGroup];
  float c[kGroup];
#pragma unroll
  for (int a = 0; a < kGroup; ++a) {
    const int ta = min(g0 + a, n_thresh - 1);  // past T: a copy, never written
    t[a] = __ldg(thresholds + static_cast<long long>(row) * n_thresh + ta);
    c[a] = 0.f;
  }
  const float* base = scores + static_cast<long long>(row) * ld;
  const long long start = static_cast<long long>(blockIdx.x) * kSlice;
  const long long end = min(start + kSlice, n);

  long long scalar_from = start;
  if (kVec) {
    const long long vend = start + ((end - start) & ~3LL);
    const float4* p = reinterpret_cast<const float4*>(base);
#pragma unroll 4
    for (long long i = start / 4 + threadIdx.x; i < vend / 4; i += kThreads) {
      const float4 v = __ldcs(p + i);  // streamed once: keep it out of L1/L2
#pragma unroll
      for (int a = 0; a < kGroup; ++a) {
        c[a] += (v.x >= t[a] ? 1.f : 0.f) + (v.y >= t[a] ? 1.f : 0.f) +
                (v.z >= t[a] ? 1.f : 0.f) + (v.w >= t[a] ? 1.f : 0.f);
      }
    }
    scalar_from = vend;
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    const float v = __ldcs(base + i);
#pragma unroll
    for (int a = 0; a < kGroup; ++a) c[a] += v >= t[a] ? 1.f : 0.f;
  }

  __shared__ int part[kThreads / 32][kGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kGroup; ++a) {
    int x = static_cast<int>(c[a]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][a] = x;
  }
  __syncthreads();
  if (threadIdx.x < kGroup && g0 + static_cast<int>(threadIdx.x) < n_thresh) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += part[w][threadIdx.x];
    if (s) atomicAdd(out + static_cast<long long>(row) * n_thresh + g0 + threadIdx.x, s);
  }
}

}  // namespace

// scores: [q, n] fp32 with row stride ld (elements), unit column stride;
// thresholds: [q, n_thresh] fp32 contiguous; out: [q, n_thresh] int32, zeroed.
extern "C" int ili_count_ge(const float* scores, const float* thresholds, int* out, int q,
                            long long n, long long ld, int n_thresh, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kSlice - 1) / kSlice), static_cast<unsigned>(q),
                  static_cast<unsigned>((n_thresh + kGroup - 1) / kGroup));
  const bool vec = reinterpret_cast<unsigned long long>(scores) % 16 == 0 && ld % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    count_ge_kernel<true><<<grid, kThreads, 0, s>>>(scores, thresholds, out, n, ld, n_thresh);
  } else {
    count_ge_kernel<false><<<grid, kThreads, 0, s>>>(scores, thresholds, out, n, ld, n_thresh);
  }
  return static_cast<int>(cudaGetLastError());
}
