// Blocked term-at-a-time scoring on Hopper: for each (8-query group,
// 4096-doc block) cell, the sum of the impacts of the cell's posting windows
// into an [8, 4096] fp32 score tile.
//
// Replaces: improving_learned_index_tpu/ops/pallas_scoring.py::_score_kernel
// (TPU Pallas, wrapper _hybrid_scores_topk / PallasBlockedEngine).  The TPU
// kernel double-buffers 1024-posting windows into VMEM by DMA, driven by
// scalar-prefetched chunk tables, and turns each window into a one-hot
// [256, 4096] x impact product on the MXU, because the TPU has no fast
// scattered read-modify-write.  Hopper has one in shared memory, so no
// one-hot carries over: each posting is one shared-memory atomicAdd.
//
// Bound on this card: bytes.  Each cell reads its windows' [lo, hi) postings
// (int32 doc + fp32 impact, 8 B a posting) and writes its tile once
// (128 KB); the adds are one per posting.
//
// Design: one block of 1024 threads per cell; the [8, 4096] fp32 accumulator
// (128 KB) lives in dynamic shared memory.  The block zeroes it, then each
// warp takes one chunk of the cell's range at a time: its lanes read the
// chunk's [lo, hi) doc ids and impacts with coalesced loads, four postings
// a lane in flight, skip padding (doc < 0) and docs outside the cell's block,
// and add the impact into acc[qi][doc - block_base].  Impacts are integers
// 1..255 and cell sums stay far below 2^24, so the fp32 sums are exact in
// any order.  Then the block writes its tile with 16-byte stores.  Chunk
// table format as the JAX package's: cell_off [cells + 1] (cell = group x
// num_blocks + block), 128-aligned window starts, and
// meta = (qi << 28) | (lo << 14) | hi.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 4096;  // docs a block
constexpr int kQg = 8;      // queries a group
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // postings a lane loads before it adds
constexpr int kSmemBytes = kQg * kBlk * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kThreads, 1)
blocked_scoring_kernel(const int* __restrict__ cell_off, const int* __restrict__ cstart,
                       const int* __restrict__ cmeta, const int* __restrict__ docs,
                       const float* __restrict__ vals, float* __restrict__ out,
                       int num_blocks) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int b = blockIdx.x;
  const int qg = blockIdx.y;
  for (int i = threadIdx.x; i < kQg * kBlk / 4; i += kThreads) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const long long cell = static_cast<long long>(qg) * num_blocks + b;
  const int c0 = __ldg(cell_off + cell);
  const int c1 = __ldg(cell_off + cell + 1);
  const int lane = threadIdx.x & 31;
  const int block_base = b * kBlk;
  for (int c = c0 + (threadIdx.x >> 5); c < c1; c += kWarps) {
    const int start = __ldg(cstart + c);
    const int meta = __ldg(cmeta + c);
    const int qi = meta >> 28;
    const int lo = (meta >> 14) & 0x3FFF;
    const int hi = meta & 0x3FFF;
    if (qi >= kQg) continue;
    float* row = acc + qi * kBlk;
    const int* dp = docs + start;
    const float* vp = vals + start;
    for (int j = lo + lane; j < hi; j += 32 * kUnroll) {
      int d[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + 32 * u;
        d[u] = jj < hi ? __ldg(dp + jj) : -1;
        v[u] = jj < hi ? __ldg(vp + jj) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int local = d[u] - block_base;
        if (d[u] >= 0 && static_cast<unsigned>(local) < static_cast<unsigned>(kBlk)) {
          atomicAdd(row + local, v[u]);
        }
      }
    }
  }
  __syncthreads();

  const long long ncols = static_cast<long long>(num_blocks) * kBlk;
  for (int i = threadIdx.x; i < kQg * kBlk / 4; i += kThreads) {
    const int r = i / (kBlk / 4);
    const int c4 = i % (kBlk / 4);
    reinterpret_cast<float4*>(out + (static_cast<long long>(qg) * kQg + r) * ncols +
                              block_base)[c4] = acc4[i];
  }
}

}  // namespace

// out: [n_groups * 8, num_blocks * 4096] fp32, every element written.
extern "C" int ili_blocked_scoring(const int* cell_off, const int* cstart, const int* cmeta,
                                   const int* docs, const float* vals, float* out,
                                   int n_groups, int num_blocks, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blocked_scoring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(num_blocks), static_cast<unsigned>(n_groups));
  blocked_scoring_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      cell_off, cstart, cmeta, docs, vals, out, num_blocks);
  return static_cast<int>(cudaGetLastError());
}
