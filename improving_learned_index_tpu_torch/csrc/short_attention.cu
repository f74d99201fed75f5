// Short-sequence attention on Hopper: softmax(q k^T * sm_scale + mask) v for
// S in {128, 256}, D in {16, 32, 64, 128}.
//
// Replaces: improving_learned_index_tpu/ops/short_attention.py::_attn_kernel
// (TPU Pallas, wrapper short_attention).  The TPU kernel runs one grid step
// per batch element and batches all heads into one pair of MXU products over
// VMEM-resident [H, S, S] logits.  Hopper has neither the VMEM nor the
// sequential grid; here the logits of one 64-query tile sit in registers and
// K and V of one (batch, head) in shared memory.
//
// Numerics are the TPU kernel's: q, k and v in bf16; fp32 logits (wgmma bf16
// with fp32 accumulation), multiplied by sm_scale, then -1e9 added where the
// mask forbids (key padding seg == 0, or, packed, a key of another segment:
// padding attends to padding); fp32 max-subtracted softmax (expf) normalized
// by one IEEE reciprocal of the row sum and a multiply; the probabilities
// rounded to bf16 before P @ V, accumulated in fp32 and stored once in the
// output's type.  Multiply and add are kept apart (__fmul_rn, __fadd_rn) so
// nvcc does not contract them into an FMA the plain version does not have,
// except where sm_scale is a power of two (1/8 at D=64): x*sm_scale is then
// exact and one fused multiply-add rounds as the two steps do.  Only the
// order of the fp32 sums differs from the plain version.
//
// Bound on this card: bytes.  At B=512, H=12, S=256, D=64 the function reads
// q, k, v and writes the output, 4 x 201 MB, ~0.24 ms at 3.35 TB/s; its
// 4*B*H*S*S*D = 103 GFLOP take ~0.10 ms at 989 TFLOP/s bf16.  But the
// softmax's ~16 fp32 instructions per logit (half of them expf) on the CUDA
// cores come close to the byte time, so the design moves each byte once,
// keeps copies in flight and keeps the CUDA cores issuing:
//
// - Persistent blocks, one an SM, walk the B*H (batch, head) items in the
//   order b*H + h.  Q, K and V of an item are read from device memory once.
// - One thread of a producer warpgroup loads the next item's Q, K and V (TMA,
//   cp.async.bulk.tensor, 4-D maps over the tensors' own strides, so the
//   encoder's [B, S, H, D] projections are read in place) and its segment
//   ids (cp.async.bulk) into a ring of shared-memory stages while the
//   consumers compute the current one; mbarriers signal full and empty.  Two
//   stages where they fit (S=256, D=64: 97 KB a stage), one at S=256, D=128.
//   TMA writes the tiles in the 32/64/128-byte swizzle (a row of min(D, 64)
//   bf16) that wgmma reads.
// - Three consumer warpgroups (two at S=256, D=128) take the block's 64-query
//   tiles in turn.  Q K^T: wgmma m64n128k16 with A = the Q tile and B = K
//   from shared memory (K-major), the fp32 logits in 64-128 registers a
//   thread; the rows' max and sum run as four partial chains, then two quad
//   shuffles.  P @ V: wgmma m64nDk16 with the bf16 probabilities as the
//   register A operand (the logits' accumulator layout is the A fragment
//   layout) and B = V in its natural [S, D] layout through the transposed
//   (MN-major) descriptor: no transposed copy of V.  setmaxnreg moves
//   registers from the producer to the consumers.
// - The output goes from the accumulators straight into the caller's
//   strides: fp32 as 8-byte pairs (a quad writes a whole 32-byte sector),
//   bf16 as 4-byte pairs (two neighbouring column chunks fill a sector).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;                     // per block on the H100

struct Strides {
  long long b, h, s;  // elements; the last (head-dim) stride is 1
};

// Position (1..3) of the head and batch axes in a tensor map whose axes 1..3
// (head, sequence, batch) are sorted by stride; the sequence axis always
// starts at 0.
struct Axes {
  int h, b;
};

template <int S, int D>
struct Layout {
  static constexpr int DB = D < 64 ? D : 64;  // head-dim columns of one region
  static constexpr int NR = D / DB;           // regions (2 at D=128)
  static constexpr int RB = DB * 2;           // bytes a row = the swizzle width
  static constexpr int TILE = S * RB;         // one region of one [S, D] tensor
  static constexpr int MAT = NR * TILE;       // one [S, D] tensor
  static constexpr int STAGE = 3 * MAT + 1024;  // q, k, v, segment ids
  static constexpr int NST = 2 * STAGE + 2048 <= kSmemLimit ? 2 : 1;
  static constexpr int SMEM = NST * STAGE + 2048;  // + barriers + alignment
  static constexpr uint32_t TX = 3 * S * D * 2 + S * 4;  // bytes a stage
  static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // wgmma swizzle code
  // Consumer warpgroups (running wgmma) beside the producer warpgroup: three
  // in 160 registers a thread, two in 232 where the logits and a [64, 128]
  // output tile need them (S=256, D=128).  setmaxnreg balances: the entry
  // count ptxas gives 512 threads is 128, 384 threads 168.
  static constexpr int NC = S == 256 && D == 128 ? 2 : 3;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int PREGS = NC == 3 ? 24 : 40;
  static constexpr int CREGS = NC == 3 ? 160 : 232;
};

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle code in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (the asm statements above do not name them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ILI_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ILI_F16(i) ILI_F4(i), ILI_F4(i + 4), ILI_F4(i + 8), ILI_F4(i + 12)

// d[64] += A[64 x 16] (shared, K-major) * B[16 x 128] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ILI_F16(0), ILI_F16(16), ILI_F16(32), ILI_F16(48)
      : "l"(da), "l"(db), "r"(1));
}

// d[N/2] += A[64 x 16] (registers, bf16 pairs) * B[16 x N] (shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ILI_F4(0), ILI_F4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ILI_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ILI_F16(0), ILI_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ILI_F16
#undef ILI_F4

// Two floats to a bf16 pair, round to nearest even; ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// The stage at shared address ``st`` holds an item's Q, K and V (swizzled
// regions of min(D, 64) columns).  Each function below is run by one
// consumer warpgroup on one 64-query tile.

// Logits of the tile: acc[nh][c*4 + e] holds row g (e < 2) or g + 8 (e >= 2)
// of this warp's 16 rows, key nh*128 + c*8 + 2t + (e & 1).
template <int S, int D>
__device__ __forceinline__ void qk(float (&acc)[S / 128][64], uint32_t st, int tile) {
  using L = Layout<S, D>;
  constexpr int SBO = 8 * L::RB;  // bytes between 8-row groups
#pragma unroll
  for (int nh = 0; nh < S / 128; ++nh) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nh][i] = 0.f;
    fence_regs(acc[nh]);
  }
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int r = kd * 16 / L::DB, ks = kd % (L::DB / 16);
    const uint64_t da = desc(st + r * L::TILE + tile * 64 * L::RB + ks * 32, 16, SBO, L::LAYOUT);
#pragma unroll
    for (int nh = 0; nh < S / 128; ++nh) {
      const uint32_t kb = st + L::MAT + r * L::TILE + nh * 128 * L::RB + ks * 32;
      wgmma_ss_n128(acc[nh], da, desc(kb, 16, SBO, L::LAYOUT));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int nh = 0; nh < S / 128; ++nh) fence_regs(acc[nh]);
}

// Scale, mask, softmax; the bf16 probabilities as the A operand of P @ V:
// keys kt*16 .. kt*16 + 15 are accumulator chunks 2kt and 2kt + 1 (the A
// fragment of rows g, g + 8).  The padding mask depends on the key alone, so
// it is one select for both rows.
template <int S, bool PACKED, bool POW2>
__device__ __forceinline__ void softmax(float (&acc)[S / 128][64], uint32_t (&pa)[S / 16][4],
                                        const int* seg_s, int tile, float sm_scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row0 = tile * 64 + (threadIdx.x / 32) % 4 * 16 + g;  // rows row0, row0 + 8
  const int sq0 = seg_s[row0], sq1 = seg_s[row0 + 8];
  // four partial maxima and sums a row, so the chains run side by side
  float m0[4], m1[4], s0[4], s1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m0[i] = m1[i] = -INFINITY, s0[i] = s1[i] = 0.f;
#pragma unroll
  for (int nh = 0; nh < S / 128; ++nh) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int2 sk = *reinterpret_cast<const int2*>(seg_s + nh * 128 + c * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kseg = e ? sk.y : sk.x;
        const float bias0 = (PACKED ? kseg != sq0 : kseg == 0) ? -1e9f : 0.f;
        const float bias1 = PACKED ? (kseg != sq1 ? -1e9f : 0.f) : bias0;
        float& x0 = acc[nh][c * 4 + e];
        float& x1 = acc[nh][c * 4 + 2 + e];
        // a power-of-two scale makes x*sm_scale exact, and the fused
        // multiply-add then rounds once, as the multiply and add do
        x0 = POW2 ? __fmaf_rn(x0, sm_scale, bias0) : __fadd_rn(__fmul_rn(x0, sm_scale), bias0);
        x1 = POW2 ? __fmaf_rn(x1, sm_scale, bias1) : __fadd_rn(__fmul_rn(x1, sm_scale), bias1);
        m0[c % 4] = fmaxf(m0[c % 4], x0);
        m1[c % 4] = fmaxf(m1[c % 4], x1);
      }
    }
  }
  float r0 = fmaxf(fmaxf(m0[0], m0[1]), fmaxf(m0[2], m0[3]));
  float r1 = fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3]));
  // a row lives in the 4 threads of a quad
  r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
  r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
  r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
  r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
#pragma unroll
  for (int nh = 0; nh < S / 128; ++nh) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[nh][c * 4 + e] = expf(__fsub_rn(acc[nh][c * 4 + e], r0));
        acc[nh][c * 4 + 2 + e] = expf(__fsub_rn(acc[nh][c * 4 + 2 + e], r1));
        s0[c % 4] += acc[nh][c * 4 + e];
        s1[c % 4] += acc[nh][c * 4 + 2 + e];
      }
    }
  }
  float u0 = (s0[0] + s0[1]) + (s0[2] + s0[3]);
  float u1 = (s1[0] + s1[1]) + (s1[2] + s1[3]);
  u0 += __shfl_xor_sync(0xffffffffu, u0, 1);
  u0 += __shfl_xor_sync(0xffffffffu, u0, 2);
  u1 += __shfl_xor_sync(0xffffffffu, u1, 1);
  u1 += __shfl_xor_sync(0xffffffffu, u1, 2);
  const float i0 = __frcp_rn(u0), i1 = __frcp_rn(u1);
#pragma unroll
  for (int kt = 0; kt < S / 16; ++kt) {
    const float* a = acc[kt / 8] + (2 * kt % 16) * 4;
    pa[kt][0] = pack_bf16(__fmul_rn(a[0], i0), __fmul_rn(a[1], i0));
    pa[kt][1] = pack_bf16(__fmul_rn(a[2], i1), __fmul_rn(a[3], i1));
    pa[kt][2] = pack_bf16(__fmul_rn(a[4], i0), __fmul_rn(a[5], i0));
    pa[kt][3] = pack_bf16(__fmul_rn(a[6], i1), __fmul_rn(a[7], i1));
  }
}

// P @ V into fp32 registers, then one store of each value into the caller's
// strides (``ob`` is the item's [S, D] output, row stride ``os_s``).
template <int S, int D, typename OutT>
__device__ __forceinline__ void pv_store(const uint32_t (&pa)[S / 16][4], uint32_t st, OutT* ob,
                                         long long os_s, int tile) {
  using L = Layout<S, D>;
  float o[L::NR][L::DB / 2];
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
#pragma unroll
    for (int i = 0; i < L::DB / 2; ++i) o[r][i] = 0.f;
    fence_regs(o[r]);
  }
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < S / 16; ++kt) {
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
      // V rows kt*16 .. kt*16 + 15 of region r, MN-major (head dim contiguous)
      const uint32_t vb = st + 2 * L::MAT + r * L::TILE + kt * 16 * L::RB;
      wgmma_rs<L::DB>(o[r], pa[kt], desc(vb, L::TILE, 8 * L::RB, L::LAYOUT));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int r = 0; r < L::NR; ++r) fence_regs(o[r]);

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int row0 = tile * 64 + (threadIdx.x / 32) % 4 * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
#pragma unroll
    for (int c = 0; c < L::DB / 8; ++c) {
      const int col = r * 64 + c * 8 + 2 * t;
      store_pair(ob + row0 * os_s + col, o[r][c * 4], o[r][c * 4 + 1]);
      store_pair(ob + (row0 + 8) * os_s + col, o[r][c * 4 + 2], o[r][c * 4 + 3]);
    }
  }
}

template <int S, int D, typename OutT, bool POW2>
__global__ void __launch_bounds__(Layout<S, D>::THREADS, 1)
short_attention_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, Axes aq, Axes ak, Axes av,
                       const int* __restrict__ seg, OutT* __restrict__ out, Strides os,
                       int items, int heads, float sm_scale, int packed) {
  using L = Layout<S, D>;
  extern __shared__ unsigned char smem_raw[];
  // stage s at base + s*STAGE: q, k, v ([S, D] each, regions of 64 columns)
  // and S segment ids; then full[NST] and empty[NST] barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t full = base + L::NST * L::STAGE, empty = full + 8 * L::NST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, L::NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == L::NC) {
    // producer warpgroup, one thread of it: the next items' tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PREGS) : "memory");
    if (threadIdx.x == L::NC * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / heads, h = item % heads;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage, st = base + stage * L::STAGE;
        mbar_expect_tx(bar, L::TX);
        const CUtensorMap* maps[3] = {&mq, &mk, &mv};
        const Axes axes[3] = {aq, ak, av};
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const Axes a = axes[m];
          const int c1 = a.h == 1 ? h : a.b == 1 ? b : 0;
          const int c2 = a.h == 2 ? h : a.b == 2 ? b : 0;
          const int c3 = a.h == 3 ? h : a.b == 3 ? b : 0;
#pragma unroll
          for (int r = 0; r < L::NR; ++r)
            tma_load_4d(st + m * L::MAT + r * L::TILE, maps[m], bar, r * 64, c1, c2, c3);
        }
        bulk_load(st + 3 * L::MAT, seg + static_cast<long long>(b) * S, S * 4, bar);
        if (++stage == L::NST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: the block's 64-query tiles in turn, warpgroup wg
    // taking tiles wg, wg + NC, ... of the sequence (item 0's S/64 tiles,
    // then item 1's, ...).  A warpgroup holds an item's stage from its wait
    // on full to its arrival on empty, which it makes on leaving the item;
    // it also waits and arrives for an item whose tiles all went to others,
    // so every empty barrier counts all NC warpgroups once a phase.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CREGS) : "memory");
    constexpr int T = S / 64;
    const int wg = threadIdx.x / 128;
    int held = -1;  // the block's item (0, 1, ...) whose stage this warpgroup holds
    for (int g = wg;; g += L::NC) {
      const int li = g / T, tile = g % T;
      const int item = blockIdx.x + li * gridDim.x;
      if (item >= items) break;
      for (; held < li; ++held) {
        if (held >= 0) mbar_arrive(empty + 8 * (held % L::NST));
        mbar_wait(full + 8 * ((held + 1) % L::NST), ((held + 1) / L::NST) & 1);
      }
      const uint32_t st = base + (li % L::NST) * L::STAGE;
      const int* seg_s = reinterpret_cast<const int*>(base_ptr + (li % L::NST) * L::STAGE + 3 * L::MAT);
      float acc[S / 128][64];
      qk<S, D>(acc, st, tile);
      uint32_t pa[S / 16][4];
      if (packed)
        softmax<S, true, POW2>(acc, pa, seg_s, tile, sm_scale);
      else
        softmax<S, false, POW2>(acc, pa, seg_s, tile, sm_scale);
      const int b = item / heads, h = item % heads;
      pv_store<S, D, OutT>(pa, st, out + b * os.b + h * os.h, os.s, tile);
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map (D, then head, sequence and batch sorted by stride) over a
// [B, H, S, D] tensor with element strides ``st``; its box is one item's
// [S, min(D, 64)] region.  ``axes`` says where head and batch went.
template <int S, int D>
cudaError_t make_map(CUtensorMap* map, Axes* axes, const void* ptr, Strides st, int batch,
                     int heads) {
  using L = Layout<S, D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long stride[3] = {st.h, st.s, st.b};
  const cuuint64_t size[3] = {static_cast<cuuint64_t>(heads), S, static_cast<cuuint64_t>(batch)};
  const cuuint32_t box_of[3] = {1, S, 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {D}, strides[3];
  cuuint32_t box[4] = {L::DB}, elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = size[order[i]];
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
    box[i + 1] = box_of[order[i]];
    pos[order[i]] = i + 1;
  }
  *axes = Axes{pos[0], pos[2]};
  const CUtensorMapSwizzle swizzle = L::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int S, int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   const Strides* st, int batch, int heads, float sm_scale, int packed,
                   cudaStream_t stream) {
  using L = Layout<S, D>;
  static_assert(L::SMEM <= kSmemLimit, "stages exceed shared memory");
  const int items = batch * heads;
  if (items == 0) return cudaSuccess;
  CUtensorMap maps[3];
  Axes axes[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map<S, D>(&maps[i], &axes[i], ptrs[i], st[i], batch, heads);
    if (err != cudaSuccess) return err;
  }
  int exponent;
  const bool pow2 = sm_scale > 0.f && frexpf(sm_scale, &exponent) == 0.5f;
  auto kernel = pow2 ? short_attention_kernel<S, D, OutT, true> : short_attention_kernel<S, D, OutT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  // setmaxnreg.inc waits for registers the block does not hold: refuse a
  // build whose entry count would leave the consumers waiting for ever
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if (L::NC * (L::CREGS - attr.numRegs) > attr.numRegs - L::PREGS)
    return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  kernel<<<items < sms ? items : sms, L::THREADS, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], axes[0], axes[1], axes[2], seg, static_cast<OutT*>(out), st[3],
      items, heads, sm_scale, packed);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* seg, void* out,
                     const Strides* st, int batch, int heads, int seq, int dim, float sm_scale,
                     int packed, cudaStream_t stream) {
#define ILI_SA_CASE(S_, D_)                                                   \
  if (seq == S_ && dim == D_)                                                 \
    return launch<S_, D_, OutT>(q, k, v, seg, out, st, batch, heads, sm_scale, \
                                packed, stream);
  ILI_SA_CASE(128, 16)
  ILI_SA_CASE(128, 32)
  ILI_SA_CASE(128, 64)
  ILI_SA_CASE(128, 128)
  ILI_SA_CASE(256, 16)
  ILI_SA_CASE(256, 32)
  ILI_SA_CASE(256, 64)
  ILI_SA_CASE(256, 128)
#undef ILI_SA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: bf16 [B, H, S, D] with strides (b, h, s, 1), each a multiple of 8
// elements, 16-byte aligned; seg: int32 [B, S] contiguous; out: bf16 or fp32
// (out_f32) with its own strides.  ``strides`` holds 12 element strides:
// (b, h, s) of q, k, v and out.
extern "C" int ili_short_attention(const void* q, const void* k, const void* v,
                                   const int* seg, void* out,
                                   const long long* strides, int batch, int heads,
                                   int seq, int dim, float sm_scale, int packed,
                                   int out_f32, void* stream) {
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_f32 ? dispatch<float>(q, k, v, seg, out, st, batch, heads, seq, dim, sm_scale, packed, s)
              : dispatch<__nv_bfloat16>(q, k, v, seg, out, st, batch, heads, seq, dim, sm_scale,
                                        packed, s);
  return static_cast<int>(err);
}
