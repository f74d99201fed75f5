// The encoder FFN's first product with its bias and GELU in one kernel, on
// the inference route: out = gelu(bf16(bf16(x W^T) + bf16(b))), x [T, K]
// and W [N, K] bf16 (nn.Linear's layout), b [N] fp32, out [T, N] bf16.
//
// Replaces: no Pallas kernel.  In the JAX package XLA runs the product and
// fuses the bias add and the GELU after it (improving_learned_index_tpu/
// models/encoder.py, flax Dense then gelu).  The port ran a library GEMM
// whose bias-free product went to device memory, then ili_bias_gelu
// (encoder_epilogue.cu) read it back: 16 bytes an element of the product
// moved only to add a bias and take a GELU.  Here the product never leaves
// the SM.
//
// Rounding points are ili_bias_gelu's: the fp32 accumulator is rounded to
// bf16 (the product as a GEMM stores it), the bias is rounded to bf16 and
// added with one more bf16 rounding, and the exact (erf) GELU runs in fp32
// on that sum, rounded to bf16.  Only the order in which the fp32
// accumulator sums over K differs from the library's.
//
// Bound on this card: operations.  At the encode cells' [32768, 768] x
// [768, 3072] a launch is 154.6 GFLOP, 0.156 ms at 989 TFLOP/s bf16,
// against 0.076 ms for x, W and out once at 3.35 TB/s.  K = 768 is only 12
// k-tiles of 64, so a tile's epilogue (the erf alone is ~25 fp32
// instructions an element) is a large share of its tensor-core time and
// has to run beside the products, not after them.  The design:
//
// - A persistent grid, one block an SM, walks 128 x 192 output tiles in
//   row-band order (a band's 16 tiles share its rows of x in L2).
// - 16 warps with their own roles: two MMA consumer warpgroups, 7 epilogue
//   warps and a producer warp.  ptxas gives each thread the same 128
//   registers (setmaxnreg cannot raise what it allocates): a consumer's 96
//   accumulators fit, a 256-wide tile's 128 would not.
// - The producer keeps a ring of 4 stages, each x [128, 64] and W [192, 64]
//   in the 128-byte swizzle (TMA; rows past T are filled with zeros), with
//   full and empty mbarriers; each consumer warp's first lane releases a
//   stage, 8 arrivals, not 256.
// - Each consumer owns 64 rows of the tile: wgmma m64n192k16 from shared
//   memory, both operands K-major, one commit group in flight while the
//   next stage's products issue.  A finished tile's accumulators are
//   rounded to bf16 into a staging tile in shared memory (rows padded by 16
//   bytes: conflict-free stores), and the consumers go on to the next
//   tile's products.
// - The epilogue warps take the staging tile in 16-byte vectors, a thread
//   every 224th (3 columns of 8 a thread, their biases held in registers),
//   add the bias, take the GELU and write the vectors of the rows below T,
//   while the consumers compute the next tile.  The GELU comes from a table
//   of every bf16 input in shared memory (filled at start with the same
//   formula), the formula only outside it: a lookup is a few instructions
//   where the erf is ~25.
//
// On an H100 at 700 W, at [32768, 768] x [768, 3072]: 0.28 ms, against
// 0.22 for cuBLAS's product alone and 0.37 for it with ili_bias_gelu.  The
// main loop alone (no GELU, no store) takes 0.21 ms; the table's lookups,
// whose random addresses conflict in the banks beside the wgmma operand
// reads and the TMA writes, cost ~0.06 ms of the rest.
//
// Plain C interface (loaded with ctypes); the function returns the
// cudaError_t of its launch.  What it takes: K % 64 == 0, N % 8 == 0,
// contiguous operands with 16-byte aligned bases (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // per block on the H100
constexpr int BM = 128, BN = 192, BK = 64;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;               // x rows of a stage
constexpr int B_BYTES = BN * BK * 2;               // W rows of a stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int PITCH = BN * 2 + 16;                 // a staging row, padded
constexpr int OUT_BYTES = BM * PITCH;
// The GELU of every bf16 value y with 2^-25 <= |y| < 8, indexed by y's bits
// rotated left by one (the sign in bit 0) less LUT_LO: the rotated bits of
// 2^-25 (bf16 0x3300).  Below 2^-25, 1 + erf rounds to 1 (gelu is y / 2);
// from 8 up, erf rounds to +-1 (gelu is y or -0): those take the formula.
constexpr int LUT_LO = 0x6600, LUT_N = 28 * 128 * 2;
constexpr int LUT_BYTES = LUT_N * 2;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + LUT_BYTES + 8 * (2 * STAGES + 2);
constexpr int EPI = 224;                           // epilogue threads: 7 warps
constexpr int THREADS = 256 + EPI + 32;            // 8 consumer warps, the epilogue's, 1 producer
constexpr int ACC = BN / 2;                        // a consumer thread's accumulators
constexpr int ROW_VECS = BN / 8;                   // 16-byte vectors of a tile row
constexpr int TILE_VECS = BM * ROW_VECS;
// the epilogue's threads take vectors e, e + EPI, ...: a thread's columns
// repeat every NB of them
constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }
constexpr int NB = ROW_VECS / gcd(ROW_VECS, EPI);
constexpr float kSqrtHalf = 0.70710678118654752440f;  // M_SQRT1_2, as PyTorch's GELU takes it

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a K-major operand in 128-byte
// rows: start address, 1024 bytes between 8-row groups, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d (+)= A[64 x 16] (shared) * B[16 x N] (shared), both K-major, N = 2 x
// d's length; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_n(float (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : ILI_F16(0), ILI_F16(16), ILI_F16(32), ILI_F16(48), ILI_F16(64), ILI_F16(80)
      : "l"(da), "l"(db), "r"(acc));
}

#undef ILI_F16
#undef ILI_F4

// Two floats to a bf16 pair, round to nearest even; ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack(const float f[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// The GELU as ili_bias_gelu computes it, on a bf16 value in fp32.
__device__ __forceinline__ float gelu(float y) { return y * 0.5f * (1.0f + erff(y * kSqrtHalf)); }

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  const __nv_bfloat162 s = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&s);
}

// Do all eight bf16 values of h lie where the table holds their GELU?
__device__ __forceinline__ bool in_table(const uint4& h) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&h);
  __nv_bfloat162 hi = __habs2(v[0]), lo = hi;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    hi = __hmax2(hi, __habs2(v[i]));
    lo = __hmin2(lo, __habs2(v[i]));
  }
  return __hblt2(hi, __float2bfloat162_rn(8.0f)) && __hbge2(lo, __float2bfloat162_rn(0x1p-25f));
}

// The GELU of eight bf16 values of the table's range, by table.
__device__ __forceinline__ uint4 gelu_table(const uint4& h, const unsigned short* lut) {
  uint32_t w[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t rot = ((w[i] << 1) & 0xFFFEFFFEu) | ((w[i] >> 15) & 0x00010001u);
    w[i] = static_cast<uint32_t>(lut[(rot & 0xFFFFu) - LUT_LO]) |
           static_cast<uint32_t>(lut[(rot >> 16) - LUT_LO]) << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The GELU of eight bf16 values by the formula.
__device__ __noinline__ uint4 gelu_formula(const uint4& h) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&h);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(v[i]);
    f[2 * i] = gelu(y.x);
    f[2 * i + 1] = gelu(y.y);
  }
  return pack(f);
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
linear_gelu_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T, int N, int K,
                   int tiles_n, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // STAGES stages of x [BM, 64] and W [BN, 64], the staging tile
  // [BM, PITCH bytes], the barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* staging = smem_raw + (base - raw) + STAGES * STAGE_BYTES;
  unsigned short* lut = reinterpret_cast<unsigned short*>(staging + OUT_BYTES);
  const uint32_t staging_s = base + STAGES * STAGE_BYTES;
  const uint32_t full = base + STAGES * STAGE_BYTES + OUT_BYTES + LUT_BYTES, empty = full + 8 * STAGES;
  const uint32_t out_full = empty + 8 * STAGES, out_empty = out_full + 8;
  const int kt_n = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_init(out_full, 256);
    mbar_init(out_empty, EPI);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256 + EPI) {
    // producer, one thread: x and W k-tiles of every tile into the ring
    if (threadIdx.x == 256 + EPI) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < kt_n; ++kt) {
          const uint32_t bar = full + 8 * stage, st = base + stage * STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(st, &mx, bar, kt * BK, m0);
          tma_load_2d(st + A_BYTES, &mw, bar, kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (threadIdx.x >= 256) {
    // epilogue: thread e takes the tile's 16-byte vectors e, e + EPI, ...
    // (row-major, ROW_VECS a row); its columns repeat every NB steps
    const int e = threadIdx.x - 256;
    for (int i = e; i < LUT_N; i += EPI) {
      const int rot = i + LUT_LO;
      const float y = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>((rot & 1) << 15 | rot >> 1)));
      lut[i] = __bfloat16_as_ushort(__float2bfloat16_rn(gelu(y)));
    }
    named_barrier_sync(1, EPI);
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      uint32_t b[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // a column vector past N (the last tile of an N that BN does not
        // divide) is neither read nor written
        const int col = n0 + 8 * ((e + EPI * j) % ROW_VECS);
        const float4* p = reinterpret_cast<const float4*>(bias + min(col, N - 8));
        const float4 lo = __ldg(p), hi = __ldg(p + 1);
        b[j][0] = pack_bf16(lo.x, lo.y);
        b[j][1] = pack_bf16(lo.z, lo.w);
        b[j][2] = pack_bf16(hi.x, hi.y);
        b[j][3] = pack_bf16(hi.z, hi.w);
      }
      const int rows = min(BM, T - m0), cols = min(BN, N - n0);
      mbar_wait(out_full, phase);
      for (int step = 0; step * EPI < TILE_VECS; step += NB) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int v = e + EPI * (step + j), r = v / ROW_VECS, c = v % ROW_VECS;
          if (v >= TILE_VECS) break;
          // bf16(h + bf16(b)): one rounding of the exact sum, as
          // bf16(float(h) + float(bf16(b))) gives it
          uint4 h = lds128(staging_s + r * PITCH + c * 16);
          h = make_uint4(bf16x2_add(h.x, b[j][0]), bf16x2_add(h.y, b[j][1]), bf16x2_add(h.z, b[j][2]),
                         bf16x2_add(h.w, b[j][3]));
          const uint4 o = in_table(h) ? gelu_table(h, lut) : gelu_formula(h);
          if (r < rows && c * 8 < cols)
            *reinterpret_cast<uint4*>(out + static_cast<long long>(m0 + r) * N + n0 + c * 8) = o;
        }
      }
      mbar_arrive(out_empty);
      phase ^= 1;
    }
    return;
  }

  // consumer warpgroup wg: rows wg * 64 .. + 63 of each tile
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's staging rows: the accumulator's rows g and g + 8 of the
  // warp's 16, columns 8 c + 2 t and 8 c + 2 t + 1
  const int srow = (wg * 64 + warp * 16 + g) * PITCH / 4 + t;
  int stage = 0;
  uint32_t phase = 0, out_phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float d[ACC];
    int prev = 0;
    for (int kt = 0; kt < kt_n; ++kt) {
      const uint32_t st = base + stage * STAGE_BYTES;
      mbar_wait(full + 8 * stage, phase);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_n(d, desc(st + wg * 64 * 128 + ks * 32), desc(st + A_BYTES + ks * 32), kt > 0 || ks > 0);
      wgmma_commit();
      fence_regs(d);
      if (kt > 0) {
        // the previous stage's products are done: the warp releases it
        wgmma_wait<1>();
        fence_regs(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    // the product, rounded to bf16, into the staging tile once the epilogue
    // has read the last one
    mbar_wait(out_empty, out_phase ^ 1);
    uint32_t* s = reinterpret_cast<uint32_t*>(staging) + srow;
#pragma unroll
    for (int c = 0; c < ROW_VECS; ++c) {
      s[4 * c] = pack_bf16(d[4 * c], d[4 * c + 1]);
      s[4 * c + 2 * PITCH] = pack_bf16(d[4 * c + 2], d[4 * c + 3]);
    }
    mbar_arrive(out_full);
    out_phase ^= 1;
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

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

// A 2-D bf16 map over a row-major [rows, cols] matrix; its box is ``box_rows``
// rows of 64 columns, written in the 128-byte swizzle.  Rows past ``rows``
// load as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)}, elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory above 48 KB.
cudaError_t prepare() {
  static_assert(SMEM <= kSmemLimit, "stages exceed shared memory");
  return cudaFuncSetAttribute(linear_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

}  // namespace

// x [T, K], w [N, K], out [T, N] bf16 row-major; bias [N] fp32.  K % 64 == 0,
// N % 8 == 0, T >= 0; returns cudaErrorInvalidValue for other widths.
extern "C" int ili_linear_gelu(const void* x, const void* w, const float* bias, void* out, long long T, int N,
                               int K, void* stream) {
  if (K <= 0 || K % BK || N <= 0 || N % 8 || T < 0 || T > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap mx, mw;
  cudaError_t err = make_map(&mx, x, T, K, BM);
  if (err == cudaSuccess) err = make_map(&mw, w, N, K, BN);
  if (err == cudaSuccess) err = prepare();
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (T + BM - 1) / BM * tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  linear_gelu_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, bias, static_cast<__nv_bfloat16*>(out), static_cast<int>(T), N, K, tiles_n,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
