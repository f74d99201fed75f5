// Heavy-term stage of the hybrid engine on Hopper: out[q] = sum of the dense
// heavy rows that query q subscribes to, accumulated in fp32.
//
// Replaces: improving_learned_index_tpu/ops/gather_rows.py::_gather_kernel
// (TPU Pallas, wrapper accumulate_rows).  The TPU kernel DMAs (8, 128)-tiled
// pages of each hit row into VMEM and adds them on the VPU; none of that
// tiling carries over.
//
// Bound on this card: bytes.  The kernel reads each (query, row) incidence's
// strip of dense cells (bf16 or fp32) and writes the [nq, n_pad] fp32 output
// once; there is one add per cell read, far below the card's arithmetic rate.
// The least traffic is hit_rows x n_pad x sizeof(T) read + nq x n_pad x 4 B
// written.
//
// Design:
// - One block owns one query and one strip of kThreads x kVec docs; each
//   thread owns kVec consecutive docs and loads them as one 16-byte vector
//   (8 bf16 or 4 fp32 cells), so a warp reads 512 contiguous bytes.
// - The block loops over the query's incidence pairs and accumulates in
//   registers, then writes its out strip once: no atomics, no shared memory,
//   and the sum order is fixed, so the result is deterministic.
// - blockIdx.x is the query, so the nq blocks of one strip are scheduled
//   together and a hit row shared by several queries is read from HBM about
//   once and then from L2.
// - fp32 sums of integer cells are exact while every sum stays below 2^24.
//
// Inputs (all device pointers, the engine's layout):
//   dense [t_heavy, n_pad] T row-major, n_pad % kVec == 0, 16-byte aligned
//   rows  [n_pairs] int32 dense row of each incidence pair, grouped by query
//   qptr  [nq + 1] int32 pair range of each query: rows[qptr[q]:qptr[q+1]]
//   out   [nq, n_pad] fp32, fully written
// A row outside [0, t_heavy) is skipped, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Cells;

template <>
struct Cells<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void add(const uint4& raw, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <>
struct Cells<float> {
  static constexpr int kVec = 4;
  __device__ static void add(const uint4& raw, float* acc) {
    acc[0] += __uint_as_float(raw.x);
    acc[1] += __uint_as_float(raw.y);
    acc[2] += __uint_as_float(raw.z);
    acc[3] += __uint_as_float(raw.w);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ dense, const int* __restrict__ rows,
                   const int* __restrict__ qptr, float* __restrict__ out,
                   int t_heavy, long long n_pad) {
  constexpr int kVec = Cells<T>::kVec;
  const int q = blockIdx.x;
  const long long doc0 =
      (static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x) * kVec;
  if (doc0 >= n_pad) return;

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  const int p1 = qptr[q + 1];
#pragma unroll 4
  for (int p = qptr[q]; p < p1; ++p) {
    const int row = __ldg(rows + p);
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(t_heavy)) continue;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        dense + static_cast<long long>(row) * n_pad + doc0));
    Cells<T>::add(raw, acc);
  }

  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(q) * n_pad + doc0);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <typename T>
int launch(const void* dense, const int* rows, const int* qptr, float* out, int nq,
           int t_heavy, long long n_pad, void* stream) {
  constexpr int kDocsPerBlock = kThreads * Cells<T>::kVec;
  const dim3 grid(nq, static_cast<unsigned>((n_pad + kDocsPerBlock - 1) / kDocsPerBlock));
  gather_rows_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dense), rows, qptr, out, t_heavy, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The strip count (gridDim.y) must not exceed 65535; the wrapper checks.
int ili_gather_rows_bf16(const void* dense, const int* rows, const int* qptr,
                         float* out, int nq, int t_heavy, long long n_pad,
                         void* stream) {
  return launch<__nv_bfloat16>(dense, rows, qptr, out, nq, t_heavy, n_pad, stream);
}

int ili_gather_rows_f32(const void* dense, const int* rows, const int* qptr,
                        float* out, int nq, int t_heavy, long long n_pad,
                        void* stream) {
  return launch<float>(dense, rows, qptr, out, nq, t_heavy, n_pad, stream);
}

}  // extern "C"
