// The encoder layer's elementwise passes between its matrix products, on the
// inference route: the bias adds, the residual adds, both LayerNorms and the
// GELU of models/encoder.py, three kernels in place of ~15 PyTorch passes a
// layer.
//
// Replaces: no Pallas kernel.  In the JAX package XLA fuses these passes
// into the products' neighbours (improving_learned_index_tpu/models/encoder.py,
// flax Dense + LayerNorm + gelu).  Eager PyTorch launches each on its own:
// a broadcast bias add falls to the legacy elementwise kernel, and each
// LayerNorm reads and writes fp32 copies of the bf16 residual sum.
//
// Rounding points are the JAX package's, as the PyTorch ops have them: the
// bias is rounded to bf16 and added to the bf16 product with one more bf16
// rounding (flax's einsum, then its bias add); the residual sum is rounded
// to bf16; LayerNorm runs in fp32 on that sum with fp32 gamma and beta and
// its output is rounded to bf16; GELU is the exact (erf) one, in fp32 on
// the bf16 input, rounded to bf16.  Only the order of the LayerNorm's fp32
// reductions differs from PyTorch's (two passes over registers here,
// Welford there).
//
// Bound on this card: bytes.  A token row of a layer moves 40 H bytes in all
// (q, k, v bias 12 H; bias, residual and LayerNorm 6 H twice; bias and GELU
// 16 H) against ~108 H through the PyTorch passes; every kernel does a few
// fp32 operations an element, far below the card's rate.
//
// Design: bf16 x 8 (16-byte) loads and stores throughout; widths are a
// multiple of 8 and every pointer 16-byte aligned (the wrapper checks).
// - ili_bias_add: in place on three [rows, n] tensors (q, k and v in one
//   launch, one a gridDim.y index), one 16-byte vector a thread.
// - ili_bias_gelu: [rows, n] in, [rows, n] out, one vector a thread.
// - ili_bias_residual_layernorm: one warp a row; each lane keeps its
//   vectors of the residual sum in registers (kV = ceil(width / 256) of
//   them), so the row is read once and written once; warp shuffles give the
//   mean and then the variance about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrtHalf = 0.70710678118654752440f;  // M_SQRT1_2, as PyTorch's GELU takes it

__device__ __forceinline__ void unpack(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// The value a bf16 tensor holds after an op that computes x in fp32.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Eight fp32 values of a vector (bias, gamma, beta) at element 8 * c.
__device__ __forceinline__ void load8(const float* p, int c, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p) + 2 * c);
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 2 * c + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// bf16(y + bf16(b)) for the 8 values of a product vector: `out + bias.to(dt)`.
__device__ __forceinline__ void add_bias(float y[8], const float* bias, int c) {
  float b[8];
  load8(bias, c, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = round_bf16(y[i] + round_bf16(b[i]));
}

struct BiasAddArgs {
  uint4* y[3];
  const float* bias[3];
};

__global__ void __launch_bounds__(kThreads)
bias_add_kernel(BiasAddArgs args, unsigned vecs, unsigned row_vecs) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vecs) return;
  // selects, not an indexed parameter array, which would go through local memory
  const unsigned t = blockIdx.y;
  uint4* y = t == 0 ? args.y[0] : t == 1 ? args.y[1] : args.y[2];
  const float* bias = t == 0 ? args.bias[0] : t == 1 ? args.bias[1] : args.bias[2];
  float f[8];
  unpack(y[i], f);
  add_bias(f, bias, static_cast<int>(i % row_vecs));
  y[i] = pack(f);
}

__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const uint4* __restrict__ h, const float* __restrict__ bias, uint4* __restrict__ out,
                 unsigned vecs, unsigned row_vecs) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vecs) return;
  float f[8];
  unpack(__ldcs(h + i), f);
  add_bias(f, bias, static_cast<int>(i % row_vecs));
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = f[k] * 0.5f * (1.0f + erff(f[k] * kSqrtHalf));
  out[i] = pack(f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// out = LayerNorm(bf16(x + bf16(h + bf16(b)))) in fp32, rounded to bf16.
template <int kV>
__global__ void __launch_bounds__(kThreads)
bias_residual_layernorm_kernel(const uint4* __restrict__ h, const float* __restrict__ bias,
                               const uint4* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, uint4* __restrict__ out, long long rows,
                               int row_vecs, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * row_vecs;
  float s[kV][8];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int c = lane + 32 * v;
    if (c < row_vecs) {
      float r[8];
      unpack(__ldcs(h + base + c), s[v]);
      unpack(__ldcs(x + base + c), r);
      add_bias(s[v], bias, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[v][i] = round_bf16(r[i] + s[v][i]);
        sum += s[v][i];
      }
    }
  }
  const float width = static_cast<float>(row_vecs * 8);
  const float mean = warp_sum(sum) / width;
  float sq = 0.f;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (lane + 32 * v < row_vecs) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = s[v][i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / width + eps);
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int c = lane + 32 * v;
    if (c < row_vecs) {
      float g[8], b[8];
      load8(gamma, c, g);
      load8(beta, c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[v][i] = g[i] * (rstd * (s[v][i] - mean)) + b[i];
      out[base + c] = pack(s[v]);
    }
  }
}

template <int kV>
int launch_layernorm(const void* h, const float* bias, const void* x, const float* gamma, const float* beta,
                     void* out, long long rows, int row_vecs, float eps, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  bias_residual_layernorm_kernel<kV><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(h), bias, static_cast<const uint4*>(x), gamma, beta, static_cast<uint4*>(out),
      rows, row_vecs, eps);
  return static_cast<int>(cudaGetLastError());
}

unsigned blocks_for(unsigned vecs) { return (vecs + kThreads - 1) / kThreads; }

}  // namespace

// y0..y2: [rows, n] bf16, in place; b0..b2: [n] fp32.  n % 8 == 0 and
// rows * n / 8 < 2^31 (the wrapper checks).
extern "C" int ili_bias_add(void* y0, void* y1, void* y2, const float* b0, const float* b1, const float* b2,
                            long long rows, int n, void* stream) {
  BiasAddArgs args{{static_cast<uint4*>(y0), static_cast<uint4*>(y1), static_cast<uint4*>(y2)}, {b0, b1, b2}};
  const unsigned vecs = static_cast<unsigned>(rows * (n / 8));
  const dim3 grid(blocks_for(vecs), 3);
  bias_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args, vecs, n / 8);
  return static_cast<int>(cudaGetLastError());
}

// h, out: [rows, n] bf16; bias: [n] fp32; same conditions as ili_bias_add.
extern "C" int ili_bias_gelu(const void* h, const float* bias, void* out, long long rows, int n, void* stream) {
  const unsigned vecs = static_cast<unsigned>(rows * (n / 8));
  bias_gelu_kernel<<<blocks_for(vecs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(h), bias, static_cast<uint4*>(out), vecs, n / 8);
  return static_cast<int>(cudaGetLastError());
}

// h, x, out: [rows, n] bf16; bias, gamma, beta: [n] fp32; n % 8 == 0 and
// n <= 1024 (four vectors a lane).  Returns cudaErrorInvalidValue for
// another width.
extern "C" int ili_bias_residual_layernorm(const void* h, const float* bias, const void* x, const float* gamma,
                                           const float* beta, void* out, long long rows, int n, float eps,
                                           void* stream) {
  const int row_vecs = n / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((row_vecs + 31) / 32) {
    case 1: return launch_layernorm<1>(h, bias, x, gamma, beta, out, rows, row_vecs, eps, s);
    case 2: return launch_layernorm<2>(h, bias, x, gamma, beta, out, rows, row_vecs, eps, s);
    case 3: return launch_layernorm<3>(h, bias, x, gamma, beta, out, rows, row_vecs, eps, s);
    case 4: return launch_layernorm<4>(h, bias, x, gamma, beta, out, rows, row_vecs, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
