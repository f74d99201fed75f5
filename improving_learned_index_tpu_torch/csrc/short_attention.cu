// Short-sequence attention on Hopper: softmax(q k^T * sm_scale + mask) v for
// S <= 256, one (batch, head) at a time, the whole [S, S] score matrix of a
// 64-query tile held in registers.
//
// Replaces: improving_learned_index_tpu/ops/short_attention.py::_attn_kernel
// (TPU Pallas, wrapper short_attention).  The TPU kernel runs one grid step
// per batch element and batches all heads into one pair of MXU products over
// VMEM-resident [H, S, S] logits.  Hopper has neither the VMEM nor the
// sequential grid: here one block of 4 warps takes one (batch, head,
// 64-query tile), each warp 16 query rows.
//
// Numerics are the TPU kernel's: q, k and v in bf16; fp32 logits
// (mma.sync bf16 with fp32 accumulation), multiplied by sm_scale, then -1e9
// added where the mask forbids (key padding seg == 0, or, packed, a key of
// another segment: padding attends to padding); fp32 max-subtracted softmax
// normalized by one IEEE reciprocal of the row sum and a multiply (a
// division per probability took twice as long at the shape below); the
// probabilities rounded to bf16 before P @ V, accumulated in
// fp32 and stored once in the output's type.  Multiply and add are kept
// apart (__fmul_rn, __fadd_rn) so nvcc does not contract them into an FMA
// the plain version does not have.
//
// Bound on this card: bytes.  At B=512, H=12, S=256, D=64 the function reads
// q, k, v and writes the output, 4 x 201 MB, ~0.24 ms at 3.35 TB/s; its
// 4*B*H*S*S*D = 103 GFLOP take ~0.10 ms at 989 TFLOP/s bf16.  The design
// keeps the fp32 logits out of device memory (they would be 1.6 GB per
// layer): K and V^T for the (b, h) sit in shared memory (2 x ~34 KB at
// S=256, D=64, rows padded by 8 bf16 so fragment loads hit 32 distinct
// banks), Q fragments in registers, logits and probabilities in registers
// as mma accumulators, reused as the A operand of P @ V without a trip
// through shared memory.  Strided inputs are read in place (the encoder's
// [B, S, H, D] projections seen as [B, H, S, D]); the output strides are the
// caller's, so the encoder gets [B, S, H, D] memory with no transpose.
// wgmma, TMA and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = kWarps * 16;  // query rows per block

struct Strides {
  long long b, h, s;  // elements; the last (head-dim) stride is 1
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair, round to nearest even; ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <int S, int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (S * (D + 8) + D * (S + 8)) + sizeof(int) * S;
}

template <int S, int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
short_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ seg, OutT* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float sm_scale, int packed) {
  constexpr int KSTR = D + 8;  // K row stride in shared memory
  constexpr int VSTR = S + 8;  // V^T row stride
  constexpr int NT = S / 8;    // key tiles of the logits (mma n = 8)
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int VEC = 8;       // bf16 per 16-byte load

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [S][KSTR]
  __nv_bfloat16* vt_s = k_s + S * KSTR;                               // [D][VSTR]
  int* seg_s = reinterpret_cast<int*>(vt_s + D * VSTR);               // [S]

  const int b = blockIdx.z, h = blockIdx.y;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  for (int i = threadIdx.x; i < S * (D / VEC); i += kThreads) {
    const int n = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    *reinterpret_cast<uint4*>(k_s + n * KSTR + c) =
        *reinterpret_cast<const uint4*>(kb + n * ks.s + c);
    const uint4 vv = *reinterpret_cast<const uint4*>(vb + n * vs.s + c);
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) vt_s[(c + j) * VSTR + n] = ve[j];
  }
  for (int i = threadIdx.x; i < S; i += kThreads) seg_s[i] = seg[static_cast<long long>(b) * S + i];

  // mma fragment coordinates: g = row within the 8-row group, t = pair index
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kTileQ + warp * 16 + g;  // rows r0 and r0 + 8

  uint32_t qa[KD][4];
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const __nv_bfloat16* p0 = qb + r0 * qs.s + kd * 16 + t * 2;
    const __nv_bfloat16* p1 = p0 + 8 * qs.s;
    qa[kd][0] = ld32(p0);
    qa[kd][1] = ld32(p1);
    qa[kd][2] = ld32(p0 + 8);
    qa[kd][3] = ld32(p1 + 8);
  }
  __syncthreads();

  // logits: acc[nt] holds rows (r0, r0 + 8) x keys nt*8 + t*2 + (0, 1)
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const __nv_bfloat16* kp = k_s + (nt * 8 + g) * KSTR + kd * 16 + t * 2;
      mma_bf16(acc[nt], qa[kd], ld32(kp), ld32(kp + 8));
    }
  }

  const int sq0 = seg_s[r0], sq1 = seg_s[r0 + 8];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sk = seg_s[nt * 8 + t * 2 + j];
      const float bias0 = (packed ? sk != sq0 : sk == 0) ? -1e9f : 0.f;
      const float bias1 = (packed ? sk != sq1 : sk == 0) ? -1e9f : 0.f;
      acc[nt][j] = __fadd_rn(__fmul_rn(acc[nt][j], sm_scale), bias0);
      acc[nt][2 + j] = __fadd_rn(__fmul_rn(acc[nt][2 + j], sm_scale), bias1);
      m0 = fmaxf(m0, acc[nt][j]);
      m1 = fmaxf(m1, acc[nt][2 + j]);
    }
  }
  // a row lives in the 4 threads of a quad
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[nt][j] = expf(__fsub_rn(acc[nt][j], m0));
      acc[nt][2 + j] = expf(__fsub_rn(acc[nt][2 + j], m1));
      s0 += acc[nt][j];
      s1 += acc[nt][2 + j];
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float i0 = __frcp_rn(s0), i1 = __frcp_rn(s1);

  // P @ V: the logits' accumulator layout is the A fragment layout of the
  // next product, two key tiles per 16-key step
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < S / 16; ++kt) {
    uint32_t pa[4];
    pa[0] = pack_bf16(__fmul_rn(acc[2 * kt][0], i0), __fmul_rn(acc[2 * kt][1], i0));
    pa[1] = pack_bf16(__fmul_rn(acc[2 * kt][2], i1), __fmul_rn(acc[2 * kt][3], i1));
    pa[2] = pack_bf16(__fmul_rn(acc[2 * kt + 1][0], i0), __fmul_rn(acc[2 * kt + 1][1], i0));
    pa[3] = pack_bf16(__fmul_rn(acc[2 * kt + 1][2], i1), __fmul_rn(acc[2 * kt + 1][3], i1));
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* vp = vt_s + (dt * 8 + g) * VSTR + kt * 16 + t * 2;
      mma_bf16(o[dt], pa, ld32(vp), ld32(vp + 8));
    }
  }

  OutT* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    store_pair(ob + r0 * os.s + dt * 8 + t * 2, o[dt][0], o[dt][1]);
    store_pair(ob + (r0 + 8) * os.s + dt * 8 + t * 2, o[dt][2], o[dt][3]);
  }
}

template <int S, int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   void* out, const Strides* st, int batch, int heads,
                   float sm_scale, int packed, cudaStream_t stream) {
  auto kernel = short_attention_kernel<S, D, OutT>;
  constexpr size_t smem = smem_bytes<S, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(S / kTileQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, static_cast<OutT*>(out), st[0],
      st[1], st[2], st[3], sm_scale, packed);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* seg,
                     void* out, const Strides* st, int batch, int heads, int seq,
                     int dim, float sm_scale, int packed, cudaStream_t stream) {
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

// q, k, v: bf16 [B, H, S, D] with strides (b, h, s, 1); seg: int32 [B, S]
// contiguous; out: bf16 or fp32 (out_f32) with its own strides.  ``strides``
// holds 12 element strides: (b, h, s) of q, k, v and out.
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
