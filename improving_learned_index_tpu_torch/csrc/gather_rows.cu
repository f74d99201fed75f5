// Heavy-term stage of the hybrid engine on Hopper: out[q] = sum of the dense
// heavy rows that query q subscribes to, accumulated in fp32.
//
// Replaces: improving_learned_index_tpu/ops/gather_rows.py::_gather_kernel
// (TPU Pallas, wrapper accumulate_rows).  The TPU kernel DMAs each unique hit
// row's page of a 65,536-doc strip into VMEM once and adds it into the output
// page of every query that hits it.  This kernel keeps that idea, re-thought
// for 227 KB of shared memory and 132 SMs.
//
// Bound on this card: bytes.  The least traffic is each unique hit row read
// once (H x n_pad x sizeof(T)) and the [nq, n_pad] fp32 output written once;
// there is one add per (pair, doc), far below the card's arithmetic rate.
//
// Design:
// - A work unit is one tile of kTile = 256 docs (a row's segment is 512
//   bytes in bf16, 1 KB in fp32) for a group of up to kGroup = 64 queries.
//   Persistent blocks, one an SM, walk the units (tile-major, so the groups
//   of one tile run side by side and share its rows in L2).
// - One producer warp copies the unit's hit-row segments into a ring of
//   kStages = 6 shared-memory stages of kRowsPerStage = 32 rows, with 1-D bulk
//   asynchronous copies (cp.async.bulk, one a row, issued by the lanes
//   together) completed on the stage's mbarrier.  The ring runs across units,
//   so the next tile's rows load while this tile's sums run.  The hit rows of
//   a tile are staged in chunks of kRowsPerStage: any H fits, and each hit
//   row's segment crosses from global memory to the SM once per unit instead
//   of once per (query, row) pair.  More than 64 queries are tiled into
//   groups; each group stages the tile's rows again (from L2).
// - kConsumerWarps consumer warps take the group's queries, kQueriesPerWarp
//   each, and keep their sums in registers across the chunks: lane l owns
//   docs 4l..4l+3 of each 128-doc half of the tile, so a warp's store of a
//   half is 512 contiguous bytes.  A query's pairs are read in table order
//   (ascending slot) with one cursor a query, so the order of the sums is
//   fixed and the result is deterministic; integer cells stay exact while
//   every sum is below 2^24.  Each query's output segment is written once,
//   with streaming stores (__stcs) so that the output does not push the hit
//   rows out of L2.
// - Measured (tools/gather_sweep.py, PERF.md): the stage runs at ~91% of the
//   card's own copy rate at the query path's shape; deeper rings and more
//   or fewer consumer warps did not move it.
// - A slot outside [0, H) and a hit row outside [0, t_heavy) are skipped,
//   never read; a query with no pair writes zeros; the last tile may be
//   ragged (n_pad % (16 / sizeof(T)) == 0 is all the kernel needs).
//
// The table (int32, one array, built on the host by ops/gather_rows.py
// group_pairs, or on the card by pair_tables):
//   [0]                     H, the number of hit rows
//   [1, nq + 2)             qptr: query q's pairs are slots[qptr[q], qptr[q+1])
//   [nq + 2, nq + 2 + H)    hits: the dense row of each slot
//   [nq + 2 + H, len)       slots: each pair's slot in hits, grouped by query,
//                           ascending within a query (entries past qptr[nq]
//                           are ignored)
// Inputs: dense [t_heavy, n_pad] T row-major, 16-byte aligned; out [nq,
// n_pad] fp32, fully written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;         // docs a unit: two 128-doc parts
constexpr int kRowsPerStage = 32;  // one warp's ballot covers a stage's rows
constexpr int kStages = 6;
constexpr int kConsumerWarps = 16;
constexpr int kQueriesPerWarp = 4;
constexpr int kGroup = kConsumerWarps * kQueriesPerWarp;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kNoSlot = 0x7fffffff;

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kRowsPerStage * kTile * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T>() + 2 * kStages * 8;
}

// Four consecutive cells of a staged row segment, as fp32.
template <typename T>
__device__ float4 load4(const unsigned char* p);

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const unsigned char* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <>
__device__ __forceinline__ float4 load4<float>(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.  A wait of ~2^35
// cycles (~17 s) means a copy that never lands: trap, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Bit i set: row c0 + i of the chunk is a hit row inside the dense matrix.
__device__ __forceinline__ uint32_t chunk_rows(const int* hits, int c0, int n, int t_heavy,
                                               int lane, int* row) {
  *row = lane < n ? __ldg(hits + c0 + lane) : -1;
  return __ballot_sync(0xffffffffu, static_cast<unsigned>(*row) < static_cast<unsigned>(t_heavy));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gather_grouped_kernel(const T* __restrict__ dense, const int* __restrict__ table,
                      long long table_len, float* __restrict__ out, int nq, int t_heavy,
                      long long n_pad) {
  constexpr int kSeg = kTile * sizeof(T), kStage = stage_bytes<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kStages * kStage, empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the table's regions; lengths clamped to the table
  const long long body = table_len - nq - 2;
  const int H = static_cast<int>(min(max(static_cast<long long>(__ldg(table)), 0LL), body));
  const int n_slots = static_cast<int>(body - H);
  const int* qptr = table + 1;
  const int* hits = table + nq + 2;
  const int* slots = hits + H;

  const long long tiles = (n_pad + kTile - 1) / kTile;
  const int groups = (nq + kGroup - 1) / kGroup;
  const long long units = tiles * groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;

  if (warp == kConsumerWarps) {
    // producer warp: each chunk's hit-row segments into the next stage
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const long long doc0 = (u / groups) * kTile;
      const uint32_t bytes = static_cast<uint32_t>(min(static_cast<long long>(kTile), n_pad - doc0) * sizeof(T));
      for (int c0 = 0; c0 < H; c0 += kRowsPerStage) {
        int row;
        const uint32_t ok = chunk_rows(hits, c0, min(kRowsPerStage, H - c0), t_heavy, lane, &row);
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (lane == 0) mbar_expect_tx(full + 8 * stage, __popc(ok) * bytes);
        __syncwarp();
        if (ok >> lane & 1)
          bulk_load(ring + stage * kStage + lane * kSeg,
                    dense + static_cast<long long>(row) * n_pad + doc0, bytes, full + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warps: queries group * kGroup + j * kConsumerWarps + warp
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int group = static_cast<int>(u % groups);
    const long long doc0 = (u / groups) * kTile;
    const int width = static_cast<int>(min(static_cast<long long>(kTile), n_pad - doc0));
    int cur[kQueriesPerWarp], end[kQueriesPerWarp], next[kQueriesPerWarp];
    float acc[kQueriesPerWarp][8];
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int q = group * kGroup + j * kConsumerWarps + warp;
      cur[j] = end[j] = 0;
      if (q < nq) {
        cur[j] = min(max(__ldg(qptr + q), 0), n_slots);
        end[j] = min(max(__ldg(qptr + q + 1), 0), n_slots);
      }
      next[j] = cur[j] < end[j] ? __ldg(slots + cur[j]) : kNoSlot;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
    }
    for (int c0 = 0; c0 < H; c0 += kRowsPerStage) {
      const int n = min(kRowsPerStage, H - c0);
      int row;
      const uint32_t ok = chunk_rows(hits, c0, n, t_heavy, lane, &row);
      mbar_wait(full + 8 * stage, phase);
      const unsigned char* st = smem + stage * kStage;
#pragma unroll
      for (int j = 0; j < kQueriesPerWarp; ++j) {
        int s = next[j];
        while (s < c0 + n) {
          const int p = ++cur[j];
          const int s_next = p < end[j] ? __ldg(slots + p) : kNoSlot;
          const unsigned r = static_cast<unsigned>(s - c0);
          if (r < kRowsPerStage && (ok >> r & 1)) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 v = load4<T>(st + r * kSeg + (h * 128 + 4 * lane) * sizeof(T));
              acc[j][4 * h] += v.x;
              acc[j][4 * h + 1] += v.y;
              acc[j][4 * h + 2] += v.z;
              acc[j][4 * h + 3] += v.w;
            }
          }
          s = s_next;
        }
        next[j] = s;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int q = group * kGroup + j * kConsumerWarps + warp;
      if (q >= nq) continue;
      float* dst = out + static_cast<long long>(q) * n_pad + doc0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = h * 128 + 4 * lane;
        if (d < width)
          __stcs(reinterpret_cast<float4*>(dst + d),
                 make_float4(acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2], acc[j][4 * h + 3]));
      }
    }
  }
}

template <typename T>
int launch(const void* dense, const int* table, long long table_len, float* out, int nq,
           int t_heavy, long long n_pad, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_grouped_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long units = (n_pad + kTile - 1) / kTile * ((nq + kGroup - 1) / kGroup);
  if (units == 0) return static_cast<int>(cudaSuccess);
  const int grid = static_cast<int>(units < sms ? units : sms);
  gather_grouped_kernel<T><<<grid, kThreads, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dense), table, table_len, out, nq, t_heavy, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ili_gather_grouped_bf16(const void* dense, const int* table, long long table_len,
                            float* out, int nq, int t_heavy, long long n_pad, void* stream) {
  return launch<__nv_bfloat16>(dense, table, table_len, out, nq, t_heavy, n_pad, stream);
}

int ili_gather_grouped_f32(const void* dense, const int* table, long long table_len,
                           float* out, int nq, int t_heavy, long long n_pad, void* stream) {
  return launch<float>(dense, table, table_len, out, nq, t_heavy, n_pad, stream);
}

}  // extern "C"
