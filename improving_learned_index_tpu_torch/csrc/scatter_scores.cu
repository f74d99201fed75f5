// Tail stage of the hybrid engine on Hopper: scores[r_i, d_i] += v_i for a
// flat stream of (doc, impact, query row) updates; v == 0 marks padding.
//
// Replaces: improving_learned_index_tpu/ops/scatter_scores.py::_tail_kernel
// (TPU Pallas, wrapper apply_tail_updates).  The TPU kernel sorts the updates
// by doc, packs them into (8, 128) pages and applies each page as one-hot MXU
// products over VMEM-resident 65536-doc tiles, because the TPU has no fast
// scattered read-modify-write.  Hopper has one: fp32 atomic adds resolved in
// L2.  So no sort, no pages and no tiles carry over.
//
// Bound on this card: bytes.  Each update reads 12 B (doc, impact, row) and
// read-modify-writes one 4-byte score; the least traffic is E x 12 B plus
// 8 B per distinct touched score cell.  The adds themselves are negligible.
//
// Design: one thread per update (grid-stride), one atomicAdd each, padding
// skipped before any score memory is touched.  Impacts are integers 1..255
// and every score stays far below 2^24, so fp32 atomic sums are exact in any
// order: the result is deterministic and can be compared for equality.  An
// update whose doc or row lies outside the score matrix is not applied (the
// JAX scatter drops such updates too).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_scores_kernel(float* __restrict__ scores, const int* __restrict__ d,
                      const float* __restrict__ v, const int* __restrict__ r,
                      long long e, int nq, long long n_pad) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < e; i += stride) {
    const float val = __ldg(v + i);
    if (val == 0.f) continue;
    const int doc = __ldg(d + i);
    const int row = __ldg(r + i);
    if (static_cast<unsigned long long>(doc) >= static_cast<unsigned long long>(n_pad) ||
        static_cast<unsigned>(row) >= static_cast<unsigned>(nq)) {
      continue;
    }
    atomicAdd(scores + static_cast<long long>(row) * n_pad + doc, val);
  }
}

}  // namespace

extern "C" int ili_scatter_scores(float* scores, const int* d, const float* v,
                                  const int* r, long long e, int nq,
                                  long long n_pad, void* stream) {
  long long blocks = (e + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  scatter_scores_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(scores, d, v, r, e, nq,
                                                               n_pad);
  return static_cast<int>(cudaGetLastError());
}
