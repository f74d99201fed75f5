// Flash attention for Hopper (sm_90a): a forward kernel, and a backward of
// one kernel per key tile after a small pre-pass.
//
// Replaces: the JAX library's Pallas TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), its forward
// pallas_call (:758) and the backward's dk/dv (:1121) and dq (:1456) calls.
// The TPU kernels walk a sequential grid with VMEM scratch carrying the
// running sums; here blocks run in parallel, the sums live in registers, and
// dq, which many key tiles add to, is summed in fp32 by atomic adds.
//
// The function: softmax(sm_scale * q k^T + mask) v over q [B, H, S, D] and
// k, v [B, Hkv, S, D] (query head h reads kv head h / (H / Hkv)).  A key is
// allowed where the segment ids are equal (when given) and, causal, where
// key <= query.  A forbidden logit is the library's finite MASK_VALUE =
// -0.7 * FLT_MAX (sm_scale * x + MASK_VALUE rounds to MASK_VALUE in fp32),
// so a row whose keys are all forbidden so far holds p = 1 on them until an
// allowed key rescales them to 0, and a padding row (segment 0) attends the
// padding keys, never NaN.
//
// Numerics (the library's): q k^T, p v, and the backward's products on bf16
// operands with fp32 accumulation (wgmma); the scale and the mask in fp32;
// an fp32 online softmax; p rounded to bf16 for p v; the fp32 log-sum-exp
// kept for the backward, which recomputes p = exp(logit - lse), takes
// di = rowsum(o * do) in fp32, ds = p (dp - di) sm_scale, and rounds p and
// ds to bf16 for dv = p^T do, dk = ds^T q and dq = ds k.  exp is exp2f with
// log2(e) folded into the scale (sm_scale * log2(e) * x - m); a forbidden
// logit stays MASK_VALUE in that base-2 domain (it only has to be far below
// every real one), and a row with no allowed key at all gets the library's
// log-sum-exp MASK_VALUE + log(l).
//
// Bound on this card.  At the 7B fine-tune's [1, 32, 2048, 128], causal with
// a padded tail, operations: 4 d a (query, key) pair the mask allows forward
// and 10 d backward (5 products), 0.027 + 0.068 ms at 989 TFLOP/s bf16; at
// the encoder's packed [64, 12, 512, 64], bytes (q, k, v, o, do read or
// written once), 0.061 + 0.121 ms at 3.35 TB/s.  So the design keeps the
// tensor cores fed and computes only tiles the mask needs:
//
// - Forward: a block per 128-row query tile and batch row, for one head or,
//   past 4 blocks an SM, a group of heads walked one after another; the
//   causal grid runs the longest query tiles first.  One thread of a
//   producer warpgroup loads each head's Q tile into one of two buffers and
//   K, V of 128-key tiles into a ring of shared-memory stages (TMA,
//   cp.async.bulk.tensor, 4-D maps over the tensors' own strides, so
//   [B, S, H, D] projections are read in place; 128-byte swizzle), full and
//   empty mbarriers, so the next head's loads run beside this one's stores.  Two consumer warpgroups own
//   64 query rows each: S = Q K^T is wgmma m64n128k16 from shared memory;
//   scale, mask and the online softmax run in registers; P V is wgmma with P
//   as the register A operand (the logits' accumulator layout is the A
//   fragment layout) and V through the MN-major descriptor in its natural
//   [S, D] layout, never transposed by hand.  o goes from the accumulators
//   straight into the caller's strides in its dtype, the log-sum-exp in fp32.
// - Backward pre-pass (flash_bwd_prep_kernel): di = rowsum(o * do) from o and
//   do read once in their dtypes, and the fp32 dq accumulator zeroed.
// - Backward (flash_bwd_kernel): a block per 128-key tile and batch row, for
//   one kv head or a group of them as the forward groups heads (the next
//   head's K and V load beside this one's stores), the causal grid longest
//   first.  K and V stay in
//   shared memory; q, do, lse, di and segment ids of 64-row query tiles of
//   every query head of the kv head's group stream through a TMA ring.  Two consumer warpgroups own 64 keys
//   each: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared
//   memory), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
//   (register A operand, MN-major B); dS^T also goes to shared memory
//   (bf16, swizzled, two buffers), where after a named barrier each
//   warpgroup takes half of D of dQ = dS K (both operands MN-major) and adds
//   it to the fp32 accumulator with atomic adds: 5 products a pair, the
//   function's count, and only the order of the fp32 sums differs from the
//   twin's.  dk and dv are written once, in k's dtype.
// - Tiles with no allowed pair are neither loaded nor computed (the ids do
//   not depend on the head, so neither does the choice).  Each block first
//   summarises the segment ids of every 64-row tile it needs, while the
//   first head's diagonal tile, which every block computes (it holds its
//   rows' own keys), and Q or K, V already load; the diagonal is walked
//   first, the other tiles in order.  A summary is a 64-bit mask of
//   its ids modulo 64 (equal ids give equal bits, so disjoint masks mean no
//   pair is allowed) and its least and largest id.  A (64-row, 128-key) pair
//   of tiles is computed when a causal pair can exist and the masks meet;
//   where every pair is allowed (below the diagonal, one id on both sides)
//   the per-element mask is skipped.  Dropping a tile with no allowed pair is
//   exact: its p are exp(MASK + x - m) = 0 in fp32 once a row's max is a real
//   logit, and every row has an allowed key, its own (seg_q is seg_kv).  The
//   caller passes skip = 0 when the two segment-id tensors differ, and every
//   tile is then computed.  Tiles past the first 256 (S > 16384) are not
//   summarised and are always computed.
//
// Plain C interface (loaded with ctypes); each function returns the
// cudaError_t of its launch.  q/k/v/do are bf16 read through (batch, head,
// row) strides with the head dim contiguous; every stride a multiple of 8
// elements, the bases 16-byte aligned (TMA's rules).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // per block on the H100
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAXT = 256;  // 64-row tiles summarised in shared memory
constexpr int RB = 128;    // bytes of a swizzled row: 64 bf16 columns
// Consumer warpgroups beside the producer warpgroup, and setmaxnreg's
// split: ptxas gives 384 threads 168 registers at entry; the producer gives
// back 144 a thread, which the consumers take (2 x (240 - 168) = 168 - 24).
constexpr int THREADS = 384;
constexpr int PREGS = 24;
constexpr int CREGS = 240;

struct Strides {
  long long b, h, s;  // elements; the last (head-dim) stride is 1
};

// Position (1..3) of the head, sequence and batch axes in a tensor map whose
// axes 1..3 are sorted by stride.
struct Axes {
  int h, s, b;
};

// The segment ids of the 64-row tiles of one side: a mask of the ids modulo
// 64, the least and the largest id.
struct TileIds {
  unsigned long long bits[MAXT];
  int lo[MAXT], hi[MAXT];
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

// Rows [row, row + box) of region ``col / 64`` of head ``h``, batch ``b``.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, Axes a, uint32_t bar,
                                         int col, int h, int row, int b) {
  const int c1 = a.h == 1 ? h : a.s == 1 ? row : b;
  const int c2 = a.h == 2 ? h : a.s == 2 ? row : b;
  const int c3 = a.h == 3 ? h : a.s == 3 ? row : b;
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle (code 1 in bits 62-63).
// Every operand here is rows of 128 bytes in 1024-byte swizzle atoms: the
// stride between 8-row groups is 1024 bytes; the leading offset is the
// stride between 64-column regions of an MN-major operand.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
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

// d[N/2] (+)= A[64 x 16] (shared) * B[16 x N] (shared); TA / TB: the operand
// is MN-major (transposed); acc = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : ILI_F16(0), ILI_F16(16), ILI_F16(32), ILI_F16(48)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : ILI_F16(0), ILI_F16(16)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : ILI_F16(0)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[32] += A[64 x 16] (registers, bf16 pairs) * B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// 2^x (MUFU, subnormal results flushed to 0: a p that small adds nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments (16 x 16 bf16 blocks, k = 16 columns each) of a 64 x N
// accumulator tile: block kt is accumulator chunks 2kt and 2kt + 1.
template <int KT>
__device__ __forceinline__ void to_a(uint32_t (&a)[KT][4], const float* x) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const float* c = x + kt * 8;
    a[kt][0] = pack_bf16(c[0], c[1]);
    a[kt][1] = pack_bf16(c[2], c[3]);
    a[kt][2] = pack_bf16(c[4], c[5]);
    a[kt][3] = pack_bf16(c[6], c[7]);
  }
}

// ---------------------------------------------------------------- the tile rule

// Summarise tiles [first, first + count) of ``seg`` (one batch row's ids;
// all 0 without segment ids), one warp a tile; every thread of the block
// calls it.
__device__ void summarise(TileIds* ids, const int* seg, int first, int count, int has_seg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int end = min(first + count, MAXT);
  for (int j = first + warp; j < end; j += warps) {
    int a = 0, c = 0;
    if (has_seg) {
      a = seg[j * 64 + lane];
      c = seg[j * 64 + 32 + lane];
    }
    const unsigned long long bit = (1ull << (a & 63)) | (1ull << (c & 63));
    const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(bit));
    const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(bit >> 32));
    const int mn = __reduce_min_sync(0xffffffffu, min(a, c));
    const int mx = __reduce_max_sync(0xffffffffu, max(a, c));
    if (lane == 0) {
      ids->bits[j] = static_cast<unsigned long long>(hi) << 32 | lo;
      ids->lo[j] = mn;
      ids->hi[j] = mx;
    }
  }
}

// May query tile qa and key tile ka (64 rows each) hold an allowed pair?
__device__ __forceinline__ bool may64(const TileIds& q, const TileIds& k, int qa, int ka, int causal,
                                      int skip) {
  if (!skip) return true;
  if (causal && ka > qa) return false;
  if (qa >= MAXT || ka >= MAXT) return true;
  return (q.bits[qa] & k.bits[ka]) != 0;
}

// Is every pair of query tile qa and key tile ka allowed?
__device__ __forceinline__ bool full64(const TileIds& q, const TileIds& k, int qa, int ka, int causal,
                                       int has_seg) {
  if (causal && ka >= qa) return false;
  if (!has_seg) return true;
  if (qa >= MAXT || ka >= MAXT) return false;
  return q.lo[qa] == q.hi[qa] && k.lo[ka] == k.hi[ka] && q.lo[qa] == k.lo[ka];
}

// ---------------------------------------------------------------- forward

template <int D>
struct Fwd {
  static constexpr int NR = D / 64;                // 64-column regions
  static constexpr int REG = 128 * RB;             // a region of a 128-row tile
  static constexpr int TILE = NR * REG;            // Q, K or V of 128 rows
  static constexpr int STAGE = 2 * TILE + 1024;    // K, V, the keys' ids (512 B)
  static constexpr int NST = D == 64 ? 3 : 2;
  static constexpr int NQB = 2;                    // Q buffers: the next head's load overlaps
  static constexpr int IDS = 2 * sizeof(TileIds);
  static constexpr int SMEM = 1024 + NQB * TILE + NST * STAGE + IDS + 8 * (2 * NQB + 2 * NST);
};

template <int D, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, Axes aq, Axes ak, Axes av,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_kv, OutT* __restrict__ out,
                 float* __restrict__ lse, Strides os, int B, int H, int rep, int S, int hpb, float scale2,
                 int causal, int has_seg, int skip, unsigned long long* __restrict__ tiles) {
  using L = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  // NQB Q buffers [128, D], then NST stages of K, V [128, D] and 128 key
  // ids, the tile summaries of both sides, the barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t ring = base + L::NQB * L::TILE;
  TileIds* idq = reinterpret_cast<TileIds*>(base_ptr + L::NQB * L::TILE + L::NST * L::STAGE);
  TileIds* idk = idq + 1;
  const uint32_t qfull = ring + L::NST * L::STAGE + L::IDS, qempty = qfull + 8 * L::NQB;
  const uint32_t full = qempty + 8 * L::NQB, empty = full + 8 * L::NST;

  // the block: query tile qt (the causal grid's longest first) of batch row
  // b, heads h0 .. h0 + nh - 1 one after another; the ids, and so the tiles
  // computed, are the same for every head
  const int T = S / 128, groups = (H + hpb - 1) / hpb, per_tile = B * groups;
  const int blk = static_cast<int>(blockIdx.x);
  const int qt = causal ? T - 1 - blk / per_tile : blk / per_tile;
  const int b = blk % per_tile / groups, h0 = blk % groups * hpb, nh = min(hpb, H - h0);
  const int* sq = seg_q + static_cast<long long>(b) * S;
  const int* sk = seg_kv + static_cast<long long>(b) * S;

  // the key tiles in the order they are walked: the diagonal tile qt first
  // (every row's own key is in it, so it is always computed), then the
  // others in order
  const int nk = causal && skip ? qt + 1 : T;
  auto key_tile = [&](int n) { return n == 0 ? qt : n <= qt ? n - 1 : n; };
  auto load_kv = [&](int j, int stage, int hk) {
    const uint32_t bar = full + 8 * stage, st = ring + stage * L::STAGE;
    mbar_expect_tx(bar, 2 * L::TILE + (has_seg ? 512 : 0));
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
      tma_rows(st + r * L::REG, &mk, ak, bar, r * 64, hk, j * 128, b);
      tma_rows(st + L::TILE + r * L::REG, &mv, av, bar, r * 64, hk, j * 128, b);
    }
    if (has_seg) bulk_load(st + 2 * L::TILE, sk + j * 128, 512, bar);
  };
  auto load_q = [&](int h, int qb) {
    mbar_expect_tx(qfull + 8 * qb, L::TILE);
#pragma unroll
    for (int r = 0; r < L::NR; ++r)
      tma_rows(base + qb * L::TILE + r * L::REG, &mq, aq, qfull + 8 * qb, r * 64, h, qt * 128, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::NQB; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 256);
    }
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first head's Q and diagonal tile need no summary: load them now
    load_q(h0, 0);
    load_kv(qt, 0, h0 / rep);
  }
  summarise(idq, sq, 2 * qt, 2, has_seg);
  summarise(idk, sk, 0, S / 64, has_seg);
  __syncthreads();

  // key tile j against the 64 query rows of tile qa (a warpgroup's rows)
  auto wg_may = [&](int qa, int j) {
    return may64(*idq, *idk, qa, 2 * j, causal, skip) || may64(*idq, *idk, qa, 2 * j + 1, causal, skip);
  };
  auto block_may = [&](int j) { return wg_may(2 * qt, j) || wg_may(2 * qt + 1, j); };

  if (threadIdx.x >= 256) {
    // producer warpgroup, one thread of it: each head's Q tile into the
    // next of NQB buffers, then K, V and ids of its key tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS) : "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nh; ++i) {
        const int h = h0 + i, qb = i % L::NQB;
        if (i > 0) {
          mbar_wait(qempty + 8 * qb, ((i / L::NQB) & 1) ^ 1);
          load_q(h, qb);
        }
        for (int n = 0; n < nk; ++n) {
          const int j = key_tile(n);
          if (!block_may(j)) continue;
          if (i > 0 || n > 0) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            load_kv(j, stage, h / rep);
          }
          if (++stage == L::NST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows qt*128 + wg*64 .. + 63 of each head
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS) : "memory");
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qa = 2 * qt + wg;
  const int row0 = qa * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int sq0 = has_seg ? sq[row0] : 0, sq1 = has_seg ? sq[row0 + 8] : 0;
  int stage = 0;
  uint32_t phase = 0;
  unsigned long long computed = 0;  // (64-row, 128-key) tile pairs
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i, qb = i % L::NQB;
    float o[L::NR][32];
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o[r][x] = 0.f;
    }
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(qfull + 8 * qb, (i / L::NQB) & 1);
    const uint32_t qs = base + qb * L::TILE;
    for (int n = 0; n < nk; ++n) {
      const int j = key_tile(n);
      if (!block_may(j)) continue;
      mbar_wait(full + 8 * stage, phase);
      if (wg_may(qa, j)) {
        ++computed;
        const uint32_t st = ring + stage * L::STAGE;
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int r = kd / 4, ks = kd % 4;
          wgmma_ss128<0, 0>(s, desc(qs + r * L::REG + wg * 64 * RB + ks * 32, 16),
                            desc(st + r * L::REG + ks * 32, 16), kd > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        // a tile whose pairs are all allowed keeps the raw logits, scaled
        // inside the exponent (a positive scale keeps the max); any other
        // gets the scale and the mask here, and a scale of 1 below
        const bool all = scale2 > 0.f && full64(*idq, *idk, qa, 2 * j, causal, has_seg) &&
                         full64(*idq, *idk, qa, 2 * j + 1, causal, has_seg);
        float sc = scale2;
        if (!all) {
          sc = 1.f;
          const int* segk = reinterpret_cast<const int*>(base_ptr + (st - base) + 2 * L::TILE);
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const int col = c * 8 + 2 * t, key = j * 128 + col;
            const int2 ks = has_seg ? *reinterpret_cast<const int2*>(segk + col) : make_int2(0, 0);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kseg = e ? ks.y : ks.x;
              const bool ok0 = kseg == sq0 && (!causal || key + e <= row0);
              const bool ok1 = kseg == sq1 && (!causal || key + e <= row0 + 8);
              s[c * 4 + e] = ok0 ? s[c * 4 + e] * scale2 : MASK_VALUE;
              s[c * 4 + 2 + e] = ok1 ? s[c * 4 + 2 + e] * scale2 : MASK_VALUE;
            }
          }
        }
        // online softmax over the tile's 128 keys: rows row0 (e < 2), row0 + 8
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          x0 = fmaxf(x0, fmaxf(s[c * 4], s[c * 4 + 1]));
          x1 = fmaxf(x1, fmaxf(s[c * 4 + 2], s[c * 4 + 3]));
        }
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
        const float n0 = fmaxf(m0, x0 * sc), n1 = fmaxf(m1, x1 * sc);
        const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
        m0 = n0;
        m1 = n1;
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          s[c * 4] = ex2(fmaf(s[c * 4], sc, -n0));
          s[c * 4 + 1] = ex2(fmaf(s[c * 4 + 1], sc, -n0));
          s[c * 4 + 2] = ex2(fmaf(s[c * 4 + 2], sc, -n1));
          s[c * 4 + 3] = ex2(fmaf(s[c * 4 + 3], sc, -n1));
          p0 += s[c * 4] + s[c * 4 + 1];
          p1 += s[c * 4 + 2] + s[c * 4 + 3];
        }
        l0 = l0 * a0 + p0;
        l1 = l1 * a1 + p1;
#pragma unroll
        for (int r = 0; r < L::NR; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            o[r][c * 4] *= a0;
            o[r][c * 4 + 1] *= a0;
            o[r][c * 4 + 2] *= a1;
            o[r][c * 4 + 3] *= a1;
          }
        }
        uint32_t pa[8][4];
        to_a<8>(pa, s);
        // O += P V: V rows kt*16 .. + 15 of region r, MN-major
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
          for (int r = 0; r < L::NR; ++r)
            wgmma_rs64(o[r], pa[kt], desc(st + L::TILE + r * L::REG + kt * 16 * RB, L::REG));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int r = 0; r < L::NR; ++r) fence_regs(o[r]);
      }
      mbar_arrive(empty + 8 * stage);
      if (++stage == L::NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the Q buffer is free for head i + NQB; the stores below overlap the
    // producer's loads of the next head's tiles
    mbar_arrive(qempty + 8 * qb);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    OutT* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = r * 64 + c * 8 + 2 * t;
        store_pair(ob + row0 * os.s + col, o[r][c * 4] * i0, o[r][c * 4 + 1] * i0);
        store_pair(ob + (row0 + 8) * os.s + col, o[r][c * 4 + 2] * i1, o[r][c * 4 + 3] * i1);
      }
    }
    if (t == 0) {
      // base 2 back to e; a row with no allowed key: the library's MASK + log(l)
      float* lb = lse + (static_cast<long long>(b) * H + h) * S;
      lb[row0] = m0 == MASK_VALUE ? MASK_VALUE + logf(l0) : (m0 + log2f(l0)) * LN2;
      lb[row0 + 8] = m1 == MASK_VALUE ? MASK_VALUE + logf(l1) : (m1 + log2f(l1)) * LN2;
    }
  }
  if (tiles != nullptr && threadIdx.x % 128 == 0) atomicAdd(tiles, computed);
}

// ---------------------------------------------------------------- backward pre-pass

// di = rowsum(o * do) in fp32, one warp a (batch, head, row); the row's fp32
// dq accumulator zeroed.
template <int D, typename OT, typename DT>
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(const OT* __restrict__ o,
                                                            const DT* __restrict__ dout, Strides so,
                                                            Strides sd, float* __restrict__ di,
                                                            float* __restrict__ dq_acc, int H, int S,
                                                            long long rows) {
  constexpr int E = D / 32;
  const long long row = blockIdx.x * 8LL + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / S;
  const int s = static_cast<int>(row % S), h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const OT* op = o + b * so.b + h * so.h + s * so.s + lane * E;
  const DT* dp = dout + b * sd.b + h * sd.h + s * sd.s + lane * E;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc += to_f32(op[e]) * to_f32(dp[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
  float* z = dq_acc + row * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; e += 2) *reinterpret_cast<float2*>(z + e) = make_float2(0.f, 0.f);
}

// ---------------------------------------------------------------- backward

template <int D>
struct Bwd {
  static constexpr int NR = D / 64;
  static constexpr int KREG = 128 * RB;          // a region of the 128-key tile
  static constexpr int KV = NR * KREG;           // K or V
  static constexpr int QREG = 64 * RB;           // a region of a 64-row query tile
  static constexpr int QT = NR * QREG;           // q or do of one query tile
  static constexpr int STAGE = 2 * QT + 1024;    // q, do, lse, di, ids (256 B each)
  static constexpr int NST = D == 64 ? 3 : 2;
  static constexpr int DS = 128 * RB;            // dS^T: 128 keys x 64 queries, bf16
  static constexpr int IDS = 2 * sizeof(TileIds);
  static constexpr int NQ = D / 2;               // dq columns a warpgroup adds
  static constexpr int SMEM = 1024 + 2 * KV + NST * STAGE + 2 * DS + IDS + 8 * (2 + 2 * NST);
};

template <int D, typename KT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                 Axes aq, Axes ak, Axes av, Axes ado, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, const float* __restrict__ lse,
                 const float* __restrict__ di, float* __restrict__ dq_acc, KT* __restrict__ dk,
                 KT* __restrict__ dv, int B, int H, int Hkv, int rep, int S, int hpb, float scale,
                 float scale2, int causal, int has_seg, int skip, unsigned long long* __restrict__ tiles) {
  using L = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  // K, V [128, D]; NST stages of q, do [64, D], lse, di and ids [64]; two
  // dS^T buffers; the tile summaries; the barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t ring = base + 2 * L::KV;
  const uint32_t dsbase = ring + L::NST * L::STAGE;
  TileIds* idq = reinterpret_cast<TileIds*>(base_ptr + (dsbase - base) + 2 * L::DS);
  TileIds* idk = idq + 1;
  const uint32_t kvfull = dsbase + 2 * L::DS + L::IDS, kvempty = kvfull + 8;
  const uint32_t full = kvempty + 8, empty = full + 8 * L::NST;

  // the block: key tile kt (the causal grid's longest, the first, first) of
  // batch row b, kv heads hk0 .. hk0 + nh - 1 one after another; the ids,
  // and so the tiles computed, are the same for every head
  const int groups = (Hkv + hpb - 1) / hpb, per_tile = B * groups;
  const int blk = static_cast<int>(blockIdx.x);
  const int kt = blk / per_tile, b = blk % per_tile / groups, hk0 = blk % groups * hpb;
  const int nh = min(hpb, Hkv - hk0);
  const int* sq = seg_q + static_cast<long long>(b) * S;
  const int* sk = seg_kv + static_cast<long long>(b) * S;

  // the query tiles in the order they are walked: the diagonal tile 2kt
  // first (the block's keys are its rows' own, so it is always computed),
  // then the others in order
  const int q_first = causal && skip ? 2 * kt : 0, nq = S / 64 - q_first;
  auto query_tile = [&](int n) {
    const int x = q_first + n - 1;
    return n == 0 ? 2 * kt : x >= 2 * kt ? x + 1 : x;
  };
  auto load_kv = [&](int hk) {
    mbar_expect_tx(kvfull, 2 * L::KV);
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
      tma_rows(base + r * L::KREG, &mk, ak, kvfull, r * 64, hk, kt * 128, b);
      tma_rows(base + L::KV + r * L::KREG, &mv, av, kvfull, r * 64, hk, kt * 128, b);
    }
  };
  auto load_q = [&](int hq, int qa, int stage) {
    const long long rb = (static_cast<long long>(b) * H + hq) * S;
    const uint32_t bar = full + 8 * stage, st = ring + stage * L::STAGE;
    mbar_expect_tx(bar, 2 * L::QT + 512 + (has_seg ? 256 : 0));
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
      tma_rows(st + r * L::QREG, &mq, aq, bar, r * 64, hq, qa * 64, b);
      tma_rows(st + L::QT + r * L::QREG, &mdo, ado, bar, r * 64, hq, qa * 64, b);
    }
    bulk_load(st + 2 * L::QT, lse + rb + qa * 64, 256, bar);
    bulk_load(st + 2 * L::QT + 256, di + rb + qa * 64, 256, bar);
    if (has_seg) bulk_load(st + 2 * L::QT + 512, sq + qa * 64, 256, bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, 256);
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first head's K, V and diagonal query tile need no summary: load
    // them now
    load_kv(hk0);
    load_q(hk0 * rep, 2 * kt, 0);
  }
  summarise(idq, sq, 0, S / 64, has_seg);
  summarise(idk, sk, 2 * kt, 2, has_seg);
  __syncthreads();

  auto block_may = [&](int qa) {
    return may64(*idq, *idk, qa, 2 * kt, causal, skip) || may64(*idq, *idk, qa, 2 * kt + 1, causal, skip);
  };

  if (threadIdx.x >= 256) {
    // producer warpgroup, one thread of it: each kv head's K and V, then the
    // query tiles of every query head of its group that the block's keys
    // may attend
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS) : "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nh; ++i) {
        const int hk = hk0 + i;
        if (i > 0) {
          mbar_wait(kvempty, (i & 1) ^ 1);
          load_kv(hk);
        }
        for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
          for (int n = 0; n < nq; ++n) {
            const int qa = query_tile(n);
            if (!block_may(qa)) continue;
            if (i > 0 || hq > hk * rep || n > 0) {
              mbar_wait(empty + 8 * stage, phase ^ 1);
              load_q(hq, qa, stage);
            }
            if (++stage == L::NST) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: keys kt*128 + wg*64 .. + 63 of each kv head
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS) : "memory");
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ka = 2 * kt + wg;
  const int key0 = ka * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const int sk0 = has_seg ? sk[key0] : 0, sk1 = has_seg ? sk[key0 + 8] : 0;
  int stage = 0, it = 0;  // it: (64-row, 128-key) tile pairs computed
  uint32_t phase = 0;
  for (int i = 0; i < nh; ++i) {
    const int hk = hk0 + i;
    const uint32_t kb_ = base, vb_ = base + L::KV;
    float adv[L::NR][32], adk[L::NR][32];
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
#pragma unroll
      for (int x = 0; x < 32; ++x) adv[r][x] = adk[r][x] = 0.f;
    }
    mbar_wait(kvfull, i & 1);
    for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
      for (int n = 0; n < nq; ++n) {
        const int qa = query_tile(n);
        if (!block_may(qa)) continue;
        mbar_wait(full + 8 * stage, phase);
        const uint32_t st = ring + stage * L::STAGE;
        const unsigned char* sp = base_ptr + (st - base) + 2 * L::QT;
        const float* lse_s = reinterpret_cast<const float*>(sp);
        const float* di_s = lse_s + 64;
        const int* seg_s = reinterpret_cast<const int*>(sp + 512);

        // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int r = kd / 4, ks = kd % 4;
          wgmma_ss64<0, 0>(s, desc(kb_ + r * L::KREG + wg * 64 * RB + ks * 32, 16),
                           desc(st + r * L::QREG + ks * 32, 16), kd > 0);
        }
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int r = kd / 4, ks = kd % 4;
          wgmma_ss64<0, 0>(dp, desc(vb_ + r * L::KREG + wg * 64 * RB + ks * 32, 16),
                           desc(st + L::QT + r * L::QREG + ks * 32, 16), kd > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // p and ds; a column is a query: col = c*8 + 2t + (e & 1)
        const bool all = full64(*idq, *idk, qa, ka, causal, has_seg);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = c * 8 + 2 * t;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 dd = *reinterpret_cast<const float2*>(di_s + col);
          const int2 qs = has_seg ? *reinterpret_cast<const int2*>(seg_s + col) : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = e & 1, key = e < 2 ? key0 : key0 + 8, q = qa * 64 + col + x;
            const float l = x ? ls.y : ls.x;
            float p = ex2(fmaf(s[c * 4 + e], scale2, -l * LOG2E));
            if (!all) {
              const bool ok = (x ? qs.y : qs.x) == (e < 2 ? sk0 : sk1) && (!causal || key <= q);
              // forbidden: exp(MASK - lse), 0 unless the row has no allowed key
              if (!ok) p = __expf(MASK_VALUE - l);
            }
            s[c * 4 + e] = p;
            dp[c * 4 + e] = (dp[c * 4 + e] - (x ? dd.y : dd.x)) * p * scale;
          }
        }
        uint32_t pa[4][4], da[4][4];
        to_a<4>(pa, s);
        to_a<4>(da, dp);
        // dS^T (keys x queries) into buffer it % 2, rows of 128 bytes in the
        // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8))
        const uint32_t dsb = dsbase + (it & 1) * L::DS;
        {
          unsigned char* dsp = base_ptr + (dsb - base);
          const int r0 = wg * 64 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            *reinterpret_cast<uint32_t*>(dsp + r0 * RB + ((c ^ (r0 & 7)) << 4) + 4 * t) = da[c / 2][(c % 2) * 2];
            *reinterpret_cast<uint32_t*>(dsp + r1 * RB + ((c ^ (r1 & 7)) << 4) + 4 * t) =
                da[c / 2][(c % 2) * 2 + 1];
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // dV += P^T dO, dK += dS^T Q: query rows kq*16 .. + 15, MN-major
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
          for (int r = 0; r < L::NR; ++r) {
            wgmma_rs64(adv[r], pa[kq], desc(st + L::QT + r * L::QREG + kq * 16 * RB, L::QREG));
            wgmma_rs64(adk[r], da[kq], desc(st + r * L::QREG + kq * 16 * RB, L::QREG));
          }
        }
        wgmma_commit();
        // both warpgroups' dS^T are in shared memory
        named_barrier_sync(1, 256);
        // dQ[:, wg*NQ .. + NQ) = dS K over the 128 keys: A = dS^T (MN-major),
        // B = K (MN-major); at D = 64 the 32 columns start 64 bytes into a row
        float dq[L::NQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t a = desc(dsb + kk * 16 * RB, L::DS);
          if constexpr (D == 128) {
            wgmma_ss64<1, 1>(dq, a, desc(kb_ + wg * L::KREG + kk * 16 * RB, L::KREG), kk > 0);
          } else {
            wgmma_ss32<1, 1>(dq, a, desc(kb_ + wg * 64 + kk * 16 * RB, L::KREG), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int r = 0; r < L::NR; ++r) {
          fence_regs(adv[r]);
          fence_regs(adk[r]);
        }
        fence_regs(dq);
        mbar_arrive(empty + 8 * stage);
        // rows: queries warp*16 + g (+ 8); columns wg*NQ + c*8 + 2t (+ 1)
        float* dqb = dq_acc + ((static_cast<long long>(b) * H + hq) * S + qa * 64 + warp * 16 + g) * D +
                     wg * L::NQ + 2 * t;
#pragma unroll
        for (int c = 0; c < L::NQ / 8; ++c) {
          atomicAdd(reinterpret_cast<float2*>(dqb + c * 8), make_float2(dq[c * 4], dq[c * 4 + 1]));
          atomicAdd(reinterpret_cast<float2*>(dqb + 8 * D + c * 8), make_float2(dq[c * 4 + 2], dq[c * 4 + 3]));
        }
        ++it;
        if (++stage == L::NST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // K and V of this head are read (dQ's last wgmma has been waited for):
    // the buffer may take the next head while these stores run
    mbar_arrive(kvempty);
    const long long ob = ((static_cast<long long>(b) * Hkv + hk) * S + key0) * D;
#pragma unroll
    for (int r = 0; r < L::NR; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = r * 64 + c * 8 + 2 * t;
        store_pair(dk + ob + col, adk[r][c * 4], adk[r][c * 4 + 1]);
        store_pair(dk + ob + 8 * D + col, adk[r][c * 4 + 2], adk[r][c * 4 + 3]);
        store_pair(dv + ob + col, adv[r][c * 4], adv[r][c * 4 + 1]);
        store_pair(dv + ob + 8 * D + col, adv[r][c * 4 + 2], adv[r][c * 4 + 3]);
      }
    }
  }
  if (tiles != nullptr && threadIdx.x == 0) atomicAdd(tiles, static_cast<unsigned long long>(it));
}

// ---------------------------------------------------------------- host side

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
// [B, heads, S, D] tensor with element strides ``st``; its box is ``rows``
// rows of one 64-column region, written in the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, Axes* axes, const void* ptr, Strides st, int batch, int heads,
                     int seq, int dim, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long stride[3] = {st.h, st.s, st.b};
  const cuuint64_t size[3] = {static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint32_t box_of[3] = {1, static_cast<cuuint32_t>(rows), 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim)}, strides[3];
  cuuint32_t box[4] = {64}, elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = size[order[i]];
    strides[i] = static_cast<cuuint64_t>(stride[order[i]]) * 2;
    box[i + 1] = box_of[order[i]];
    pos[order[i]] = i + 1;
  }
  *axes = Axes{pos[0], pos[1], pos[2]};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory above 48 KB, and setmaxnreg's guard: setmaxnreg.inc waits
// for registers the block does not hold, so refuse a build whose entry
// count would leave the consumers waiting for ever.
template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if (2 * (CREGS - attr.numRegs) > attr.numRegs - PREGS) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

// Heads a block walks, of ``heads``: one while the card has at most 4
// blocks an SM; past that, equal groups of heads, so a block's next loads
// run while it finishes a head.  ``blocks``: one a head.
cudaError_t heads_per_block(long long blocks, int heads, int* hpb) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const long long want = blocks / (4LL * sms);
  const int n = want < 1 ? 1 : want < heads ? static_cast<int>(want) : heads;
  const int groups = (heads + n - 1) / n;
  *hpb = (heads + groups - 1) / groups;
  return cudaSuccess;
}

template <int D, typename OutT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                       void* o, float* lse, const long long* st, int B, int H, int Hkv, int S,
                       float sm_scale, int causal, int has_seg, int skip, unsigned long long* tiles,
                       cudaStream_t stream) {
  using L = Fwd<D>;
  static_assert(L::SMEM <= kSmemLimit, "stages exceed shared memory");
  const long long blocks = static_cast<long long>(S / 128) * H * B;
  if (blocks == 0) return cudaSuccess;
  CUtensorMap maps[3];
  Axes axes[3];
  const void* ptrs[3] = {q, k, v};
  const int heads[3] = {H, Hkv, Hkv};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map(&maps[i], &axes[i], ptrs[i], strides_at(st, i), B, heads[i], S, D, 128);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_fwd_kernel<D, OutT>;
  cudaError_t err = prepare(kernel, L::SMEM);
  if (err != cudaSuccess) return err;
  int hpb = 1;
  if ((err = heads_per_block(blocks, H, &hpb)) != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks / H * ((H + hpb - 1) / hpb)), THREADS, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], axes[0], axes[1], axes[2], seg_q, seg_kv, static_cast<OutT*>(o), lse,
      strides_at(st, 3), B, H, H / Hkv, S, hpb, sm_scale * LOG2E, causal, has_seg, skip, tiles);
  return cudaGetLastError();
}

template <int D, typename OT, typename DT>
cudaError_t launch_prep(const void* o, const void* dout, const long long* st, float* di, float* dq_acc,
                        int B, int H, int S, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  if (rows == 0) return cudaSuccess;
  flash_bwd_prep_kernel<D, OT, DT><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const OT*>(o), static_cast<const DT*>(dout), strides_at(st, 0), strides_at(st, 1), di,
      dq_acc, H, S, rows);
  return cudaGetLastError();
}

template <int D, typename KT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                       const void* dout, const float* lse, const float* di, float* dq_acc, void* dk,
                       void* dv, const long long* st, int B, int H, int Hkv, int S, float sm_scale,
                       int causal, int has_seg, int skip, unsigned long long* tiles, cudaStream_t stream) {
  using L = Bwd<D>;
  static_assert(L::SMEM <= kSmemLimit, "stages exceed shared memory");
  const long long blocks = static_cast<long long>(S / 128) * Hkv * B;
  if (blocks == 0) return cudaSuccess;
  CUtensorMap maps[4];
  Axes axes[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int heads[4] = {H, Hkv, Hkv, H}, rows[4] = {64, 128, 128, 64};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        make_map(&maps[i], &axes[i], ptrs[i], strides_at(st, i), B, heads[i], S, D, rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_kernel<D, KT>;
  cudaError_t err = prepare(kernel, L::SMEM);
  if (err != cudaSuccess) return err;
  int hpb = 1;
  if ((err = heads_per_block(blocks, Hkv, &hpb)) != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks / Hkv * ((Hkv + hpb - 1) / hpb)), THREADS, L::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], axes[0], axes[1], axes[2], axes[3], seg_q, seg_kv, lse, di,
      dq_acc, static_cast<KT*>(dk), static_cast<KT*>(dv), B, H, Hkv, H / Hkv, S, hpb, sm_scale,
      sm_scale * LOG2E, causal, has_seg, skip, tiles);
  return cudaGetLastError();
}

bool shape_ok(int H, int Hkv, int S, int D) {
  return H > 0 && Hkv > 0 && H % Hkv == 0 && S > 0 && S % 128 == 0 && (D == 64 || D == 128);
}

}  // namespace

extern "C" {

// strides: q, k, v, o as (batch, head, row) element strides, 12 values; o is
// bf16 or fp32 (out_f32); lse fp32 [B, H, S] contiguous.  skip: tiles with
// no allowed pair may be dropped (seg_q and seg_kv are one tensor).  tiles:
// null, or a counter to which the (64-row, 128-key) tile pairs computed,
// over every head and batch row, are added.
int ili_flash_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv, void* o,
                  float* lse, const long long* strides, int B, int H, int Hkv, int S, int D, float sm_scale,
                  int causal, int has_seg, int skip, int out_f32, unsigned long long* tiles, void* stream) {
  if (!shape_ok(H, Hkv, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ILI_FWD(D_, T_) \
  launch_fwd<D_, T_>(q, k, v, seg_q, seg_kv, o, lse, strides, B, H, Hkv, S, sm_scale, causal, has_seg, skip, \
                     tiles, st)
  cudaError_t err = D == 64 ? (out_f32 ? ILI_FWD(64, float) : ILI_FWD(64, __nv_bfloat16))
                            : (out_f32 ? ILI_FWD(128, float) : ILI_FWD(128, __nv_bfloat16));
#undef ILI_FWD
  return static_cast<int>(err);
}

// strides: o, do (6 values); o and do bf16 or fp32 (o_f32, do_f32).  Writes
// di fp32 [B, H, S] and zeroes dq_acc fp32 [B, H, S, D], both contiguous.
int ili_flash_bwd_prep(const void* o, const void* dout, float* di, float* dq_acc, const long long* strides,
                       int B, int H, int S, int D, int o_f32, int do_f32, void* stream) {
  if (!shape_ok(H, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ILI_PREP(D_, O_, G_) launch_prep<D_, O_, G_>(o, dout, strides, di, dq_acc, B, H, S, st)
#define ILI_PREP_D(D_)                                                                    \
  (o_f32 ? (do_f32 ? ILI_PREP(D_, float, float) : ILI_PREP(D_, float, __nv_bfloat16))    \
         : (do_f32 ? ILI_PREP(D_, __nv_bfloat16, float) : ILI_PREP(D_, __nv_bfloat16, __nv_bfloat16)))
  cudaError_t err = D == 64 ? ILI_PREP_D(64) : ILI_PREP_D(128);
#undef ILI_PREP_D
#undef ILI_PREP
  return static_cast<int>(err);
}

// strides: q, k, v, do (12 values); do bf16.  Adds dq into dq_acc (fp32
// [B, H, S, D] contiguous, zeroed by ili_flash_bwd_prep); writes dk, dv
// [B, Hkv, S, D] contiguous, bf16 or fp32 (kv_f32).  tiles as the forward's.
int ili_flash_bwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                  const void* dout, const float* lse, const float* di, float* dq_acc, void* dk, void* dv,
                  const long long* strides, int B, int H, int Hkv, int S, int D, float sm_scale, int causal,
                  int has_seg, int skip, int kv_f32, unsigned long long* tiles, void* stream) {
  if (!shape_ok(H, Hkv, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ILI_BWD(D_, T_)                                                                                \
  launch_bwd<D_, T_>(q, k, v, seg_q, seg_kv, dout, lse, di, dq_acc, dk, dv, strides, B, H, Hkv, S, sm_scale, \
                     causal, has_seg, skip, tiles, st)
  cudaError_t err = D == 64 ? (kv_f32 ? ILI_BWD(64, float) : ILI_BWD(64, __nv_bfloat16))
                            : (kv_f32 ? ILI_BWD(128, float) : ILI_BWD(128, __nv_bfloat16));
#undef ILI_BWD
  return static_cast<int>(err);
}

}  // extern "C"
