// Tail stage of the query engines on Hopper: scores[r_i, d_i] += v_i for a
// stream of (doc, impact, query row) updates, given either as flat arrays
// (v == 0 marks padding) or as a chunk table read in place: chunk c covers
// postings starts[c] .. starts[c] + min(lengths[c], chunk) of (docs, vals),
// all in query row rows[c]; docs < 0 marks padding.
//
// Replaces: improving_learned_index_tpu/ops/scatter_scores.py::_tail_kernel
// (TPU Pallas, wrapper apply_tail_updates).  The TPU kernel sorts the updates
// by doc, packs them into (8, 128) pages and applies each page as one-hot MXU
// products over VMEM-resident 65536-doc tiles, because the TPU has no fast
// scattered read-modify-write.  Hopper has one: fp32 atomic adds resolved in
// L2.  So no pages and no tiles carry over.
//
// Bound on this card: bytes.  The [nq, n_pad] fp32 matrix is far larger than
// the 50 MB L2 (2.26 GB at 64 queries over 8.85M docs), and nearly every
// update lands in a 32-byte sector of its own, which is read from device
// memory and written back.  The sort does not carry over either: the same
// updates applied in address order, so that a region's updates from every
// term of its row reach L2 together, take nearly as long as in chunk-table
// order, and a counting sort by matrix region costs more than the order
// saves (tools/scatter_sweep.py; PERF.md).  The scattered sectors, not their
// order, set the time.
//
// Design: one thread per update, one fp32 atomic add with its result unused
// (red.global.add) each, padding skipped before any score memory is touched.
// The chunk entry reads the table and the posting arrays where they lie, so
// no flat update array is materialized: a block takes one chunk at a time
// (grid-stride over chunks) and its threads stride over the chunk's lanes.
//
// Impacts are integers 1..255 and every score stays far below 2^24, so fp32
// atomic sums are exact in any order: the result is deterministic and can be
// compared for equality.  An update whose doc or row lies outside the score
// matrix is not applied (the JAX scatter drops such updates too).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride covers the rest

__device__ __forceinline__ void add(float* scores, int doc, int row, float val, int nq,
                                    long long n_pad) {
  if (static_cast<unsigned long long>(doc) >= static_cast<unsigned long long>(n_pad) ||
      static_cast<unsigned>(row) >= static_cast<unsigned>(nq)) {
    return;
  }
  atomicAdd(scores + static_cast<long long>(row) * n_pad + doc, val);
}

__global__ void __launch_bounds__(kThreads)
scatter_flat(float* __restrict__ scores, const int* __restrict__ d,
             const float* __restrict__ v, const int* __restrict__ r, long long e, int nq,
             long long n_pad) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < e;
       i += stride) {
    const float val = __ldg(v + i);
    if (val == 0.f) continue;
    add(scores, __ldg(d + i), __ldg(r + i), val, nq, n_pad);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_chunks(float* __restrict__ scores, const int* __restrict__ docs,
               const float* __restrict__ vals, const int* __restrict__ starts,
               const int* __restrict__ lengths, const int* __restrict__ rows,
               long long n_chunks, int chunk, int nq, long long n_pad) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int row = __ldg(rows + c);
    const int len = min(__ldg(lengths + c), chunk);
    const long long s = __ldg(starts + c);
    for (int lane = threadIdx.x; lane < len; lane += kThreads) {
      const int doc = __ldg(docs + s + lane);
      if (doc < 0) continue;
      add(scores, doc, row, __ldg(vals + s + lane), nq, n_pad);
    }
  }
}

unsigned grid_for(long long items) {
  return static_cast<unsigned>(items < kMaxBlocks ? items : kMaxBlocks);
}

}  // namespace

extern "C" int ili_scatter_scores(float* scores, const int* d, const float* v, const int* r,
                                  long long e, int nq, long long n_pad, void* stream) {
  scatter_flat<<<grid_for((e + kThreads - 1) / kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(scores, d, v, r, e, nq, n_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ili_scatter_chunks(float* scores, const int* docs, const float* vals,
                                  const int* starts, const int* lengths, const int* rows,
                                  long long n_chunks, int chunk, int nq, long long n_pad,
                                  void* stream) {
  scatter_chunks<<<grid_for(n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, docs, vals, starts, lengths, rows, n_chunks, chunk, nq, n_pad);
  return static_cast<int>(cudaGetLastError());
}
