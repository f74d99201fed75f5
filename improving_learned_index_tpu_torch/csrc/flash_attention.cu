// Flash attention for Hopper (sm_90a): forward, and the backward split into a
// dk/dv kernel and a dq kernel, as the JAX library's Pallas TPU kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py) splits it.
//
// The function: softmax(sm_scale * q k^T + mask) v over q [B, H, S, D] and
// k, v [B, Hkv, S, D] (query head h reads kv head h / (H / Hkv), the same
// math as repeating the kv heads).  A key is allowed where the segment ids
// are equal (when given) and, causal, where key <= query.  A forbidden logit
// gets MASK_VALUE = -0.7 * FLT_MAX added, as the library adds it: finite, so
// a row whose keys are all forbidden so far holds p = 1 on them until an
// allowed key rescales them to 0, and a padding row (segment 0) attends the
// padding keys, never NaN.
//
// Numerics (the library's): q k^T and p v on bf16 operands with fp32
// accumulation (mma.sync m16n8k16), the scale and the mask in fp32, an fp32
// online softmax, p rounded to bf16 for p v; the backward's ds = p (dp - di)
// sm_scale, rounded to bf16 for dq = ds k and dk = ds^T q, and p^T rounded
// for dv = p^T do; di = rowsum(o * do) comes from the caller, as the library
// computes it outside its kernels.
//
// Forward: one block of 8 warps per (128-row query tile, head, batch row);
// each warp owns 16 query rows, holds its q fragments in registers, and
// walks 64-key tiles staged in shared memory (k row-major, v transposed).
// Causal: key tiles past the query tile's last row are never loaded, and a
// warp skips the tiles past its own last row.  It writes o in the output's
// dtype and the log-sum-exp m + log(l) in fp32 for the backward.
//
// Backward, dq: one block of 4 warps per (64-row query tile, head, batch
// row); a warp owns 16 query rows and walks 32-key tiles (k row-major and
// transposed, v row-major in shared memory): s, p = exp(s - lse), dp = do
// v^T, ds, dq += ds k.  dk/dv: one block of 4 warps per (64-key tile, kv
// head, batch row); a warp owns 16 keys and walks, for each query head of
// its group, the 32-row query tiles at or past its keys (causal): p^T,
// dv += p^T do, dp^T = v do^T, ds^T, dk += ds^T q.  dq, dk and dv are
// written in fp32.
//
// Plain C interface (loaded with ctypes); each function returns the
// cudaError_t of its launch.  q/k/v/do are bf16 read through (batch, head,
// row) strides with the head dim contiguous; every row 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, row-major) of rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a row-major bf16 matrix with row stride `ld` elements.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* base, long long ld, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* p0 = base + (long long)(r0 + g) * ld + c0 + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// The A fragment of a 16 x 16 block held as two C fragments (16 x 8 each,
// columns [0, 8) and [8, 16)), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Copy `rows` rows of `D` bf16 (16-byte vectors) from global (row stride
// `ld`) to shared memory (row stride `lds`); optionally also transposed into
// `dst_t` ([D][ldt]).
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int lds, __nv_bfloat16* dst_t, int ldt,
                                           const __nv_bfloat16* src, long long ld, int rows, int tid,
                                           int nthreads) {
  constexpr int VEC = D / 8;
  for (int i = tid; i < rows * VEC; i += nthreads) {
    int r = i / VEC, c = (i % VEC) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(src + (long long)r * ld + c);
    if (dst) *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
    if (dst_t) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * ldt + r] = e[j];
    }
  }
}

__device__ __forceinline__ bool allowed(int has_seg, int causal, int sq, int sk, int row, int col) {
  return (!has_seg || sq == sk) && (!causal || col <= row);
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(256) fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    void* __restrict__ o, float* __restrict__ lse, Strides sq_, Strides sk_, Strides sv_, Strides so_,
    int H, int rep, int S, float scale, int causal, int has_seg, int out_f32) {
  constexpr int BM = 128, BN = 64, KT = D / 16, NT = BN / 8, DT = D / 8;
  constexpr int LDK = D + 8, LDV = BN + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BN * LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[D * LDV];
  __shared__ int segk[BN];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * BM + warp * 16;  // this warp's first row
  const int row0 = r0 + g, row1 = r0 + g + 8;

  const __nv_bfloat16* qb = q + b * sq_.b + h * sq_.h;
  const __nv_bfloat16* kb = k + b * sk_.b + hk * sk_.h;
  const __nv_bfloat16* vb = v + b * sv_.b + hk * sv_.h;

  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) load_a(qa[kk], qb, sq_.s, r0, kk * 16, g, t);
  const int sg0 = has_seg ? seg_q[(long long)b * S + row0] : 0;
  const int sg1 = has_seg ? seg_q[(long long)b * S + row1] : 0;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = causal ? min(S / BN, (tile + 1) * BM / BN) : S / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    stage_rows<D>(ks, LDK, nullptr, 0, kb + k0 * sk_.s, sk_.s, BN, tid, 256);
    stage_rows<D>(nullptr, 0, vt, LDV, vb + k0 * sv_.s, sv_.s, BN, tid, 256);
    if (tid < BN) segk[tid] = has_seg ? seg_kv[(long long)b * S + k0 + tid] : 0;
    __syncthreads();
    if (causal && k0 > r0 + 15) continue;  // every key of the tile is past this warp's rows

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* p = ks + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
        mma(s[nt], qa[kk], ld32(p), ld32(p + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = allowed(has_seg, causal, e < 2 ? sg0 : sg1, segk[c], row, k0 + c);
        float x = s[nt][e] * scale;
        x = x + (ok ? 0.f : MASK_VALUE);
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = expf(m[0] - mn0), al1 = expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * al0 + ps0;
    l[1] = l[1] * al1 + ps1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        const __nv_bfloat16* p = vt + (nd * 8 + g) * LDV + kk * 16 + 2 * t;
        mma(acc[nd], pa, ld32(p), ld32(p + 8));
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffff, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffff, l[1], off);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  const long long ob0 = b * so_.b + h * so_.h + row0 * so_.s, ob1 = b * so_.b + h * so_.h + row1 * so_.s;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (out_f32) {
      float* of = static_cast<float*>(o);
      *reinterpret_cast<float2*>(of + ob0 + c) = make_float2(acc[nd][0] * inv0, acc[nd][1] * inv0);
      *reinterpret_cast<float2*>(of + ob1 + c) = make_float2(acc[nd][2] * inv1, acc[nd][3] * inv1);
    } else {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
      *reinterpret_cast<uint32_t*>(ob + ob0 + c) = pack_bf16(acc[nd][0] * inv0, acc[nd][1] * inv0);
      *reinterpret_cast<uint32_t*>(ob + ob1 + c) = pack_bf16(acc[nd][2] * inv1, acc[nd][3] * inv1);
    }
  }
  if (t == 0) {
    float* lb = lse + ((long long)b * H + h) * S;
    lb[row0] = m[0] + logf(l[0]);
    lb[row1] = m[1] + logf(l[1]);
  }
}

// ---------------------------------------------------------------- backward dq

template <int D>
__global__ void __launch_bounds__(128) bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, Strides sq_, Strides sk_, Strides sv_, Strides sd_, int H, int rep, int S,
    float scale, int causal, int has_seg) {
  constexpr int BM = 64, BN = 32, KT = D / 16, NT = BN / 8, DT = D / 8;
  constexpr int LDK = D + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][LDK]
  __nv_bfloat16* vs = ks + BN * LDK;                                // [BN][LDK]
  __nv_bfloat16* kt = vs + BN * LDK;                                // [D][LDT]
  int* segk = reinterpret_cast<int*>(kt + D * LDT);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * BM + warp * 16, row0 = r0 + g, row1 = r0 + g + 8;

  const __nv_bfloat16* qb = q + b * sq_.b + h * sq_.h;
  const __nv_bfloat16* db = dout + b * sd_.b + h * sd_.h;
  const __nv_bfloat16* kb = k + b * sk_.b + hk * sk_.h;
  const __nv_bfloat16* vb = v + b * sv_.b + hk * sv_.h;
  const long long rb = ((long long)b * H + h) * S;
  const float lse0 = lse[rb + row0], lse1 = lse[rb + row1];
  const float di0 = di[rb + row0], di1 = di[rb + row1];
  const int sg0 = has_seg ? seg_q[(long long)b * S + row0] : 0;
  const int sg1 = has_seg ? seg_q[(long long)b * S + row1] : 0;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = causal ? min(S / BN, (tile + 1) * BM / BN) : S / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    stage_rows<D>(ks, LDK, kt, LDT, kb + k0 * sk_.s, sk_.s, BN, tid, 128);
    stage_rows<D>(vs, LDK, nullptr, 0, vb + k0 * sv_.s, sv_.s, BN, tid, 128);
    if (tid < BN) segk[tid] = has_seg ? seg_kv[(long long)b * S + k0 + tid] : 0;
    __syncthreads();
    if (causal && k0 > r0 + 15) continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qb, sq_.s, r0, kk * 16, g, t);
      load_a(da, db, sd_.s, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* pk = ks + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
        const __nv_bfloat16* pv = vs + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
        mma(s[nt], qa, ld32(pk), ld32(pk + 8));
        mma(dp[nt], da, ld32(pv), ld32(pv + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = allowed(has_seg, causal, e < 2 ? sg0 : sg1, segk[c], row, k0 + c);
        float x = s[nt][e] * scale;
        x = x + (ok ? 0.f : MASK_VALUE);
        const float p = expf(x - (e < 2 ? lse0 : lse1));
        s[nt][e] = (dp[nt][e] - (e < 2 ? di0 : di1)) * p * scale;  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        const __nv_bfloat16* p = kt + (nd * 8 + g) * LDT + kk * 16 + 2 * t;
        mma(acc[nd], a, ld32(p), ld32(p + 8));
      }
    }
  }
  float* out = dq + (((long long)b * H + h) * S) * D;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    const int c = nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (long long)row0 * D + c) = make_float2(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<float2*>(out + (long long)row1 * D + c) = make_float2(acc[nd][2], acc[nd][3]);
  }
}

// ---------------------------------------------------------------- backward dk, dv

template <int D>
__global__ void __launch_bounds__(128) bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, Strides sq_, Strides sk_, Strides sv_, Strides sd_,
    int H, int Hkv, int rep, int S, float scale, int causal, int has_seg) {
  constexpr int BK = 64, BQ = 32, KT = D / 16, NT = BQ / 8, DT = D / 8;
  constexpr int LDK = D + 8, LDT = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LDK]
  __nv_bfloat16* vs = ks + BK * LDK;                                // [BK][LDK]
  __nv_bfloat16* qs = vs + BK * LDK;                                // [BQ][LDK]
  __nv_bfloat16* ds_ = qs + BQ * LDK;                               // [BQ][LDK] (do)
  __nv_bfloat16* qt = ds_ + BQ * LDK;                               // [D][LDT]
  __nv_bfloat16* dt = qt + D * LDT;                                 // [D][LDT] (do^T)
  float* lses = reinterpret_cast<float*>(dt + D * LDT);
  float* dis = lses + BQ;
  int* segq = reinterpret_cast<int*>(dis + BQ);

  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kb0 = tile * BK, w0 = warp * 16;  // the block's first key, the warp's first key in it
  const int key0 = kb0 + w0 + g, key1 = key0 + 8;

  stage_rows<D>(ks, LDK, nullptr, 0, k + b * sk_.b + hk * sk_.h + kb0 * sk_.s, sk_.s, BK, tid, 128);
  stage_rows<D>(vs, LDK, nullptr, 0, v + b * sv_.b + hk * sv_.h + kb0 * sv_.s, sv_.s, BK, tid, 128);
  const int sk0 = has_seg ? seg_kv[(long long)b * S + key0] : 0;
  const int sk1 = has_seg ? seg_kv[(long long)b * S + key1] : 0;

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;

  const int q_first = causal ? kb0 / BQ : 0;
  for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
    const __nv_bfloat16* qb = q + b * sq_.b + hq * sq_.h;
    const __nv_bfloat16* db = dout + b * sd_.b + hq * sd_.h;
    const long long rb = ((long long)b * H + hq) * S;
    for (int j = q_first; j < S / BQ; ++j) {
      const int q0 = j * BQ;
      __syncthreads();
      stage_rows<D>(qs, LDK, qt, LDT, qb + q0 * sq_.s, sq_.s, BQ, tid, 128);
      stage_rows<D>(ds_, LDK, dt, LDT, db + q0 * sd_.s, sd_.s, BQ, tid, 128);
      if (tid < BQ) {
        lses[tid] = lse[rb + q0 + tid];
        dis[tid] = di[rb + q0 + tid];
        segq[tid] = has_seg ? seg_q[(long long)b * S + q0 + tid] : 0;
      }
      __syncthreads();
      if (causal && q0 + BQ - 1 < kb0 + w0) continue;  // every query of the tile precedes this warp's keys

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, ks, LDK, w0, kk * 16, g, t);
        load_a(va, vs, LDK, w0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* pq = qs + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
          const __nv_bfloat16* pd = ds_ + (nt * 8 + g) * LDK + kk * 16 + 2 * t;
          mma(s[nt], ka, ld32(pq), ld32(pq + 8));   // s^T: keys x queries
          mma(dp[nt], va, ld32(pd), ld32(pd + 8));  // dp^T
        }
      }
      // s -> p^T, dp -> ds^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);  // query within the tile
          const int key = e < 2 ? key0 : key1;
          const bool ok = allowed(has_seg, causal, segq[c], e < 2 ? sk0 : sk1, q0 + c, key);
          float x = s[nt][e] * scale;
          x = x + (ok ? 0.f : MASK_VALUE);
          const float p = expf(x - lses[c]);
          s[nt][e] = p;
          dp[nt][e] = (dp[nt][e] - dis[c]) * p * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < DT; ++nd) {
          const __nv_bfloat16* pd = dt + (nd * 8 + g) * LDT + kk * 16 + 2 * t;
          const __nv_bfloat16* pq = qt + (nd * 8 + g) * LDT + kk * 16 + 2 * t;
          mma(adv[nd], pa, ld32(pd), ld32(pd + 8));
          mma(adk[nd], sa, ld32(pq), ld32(pq + 8));
        }
      }
    }
  }
  const long long ob = (((long long)b * Hkv + hk) * S) * D;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    const int c = nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(dk + ob + (long long)key0 * D + c) = make_float2(adk[nd][0], adk[nd][1]);
    *reinterpret_cast<float2*>(dk + ob + (long long)key1 * D + c) = make_float2(adk[nd][2], adk[nd][3]);
    *reinterpret_cast<float2*>(dv + ob + (long long)key0 * D + c) = make_float2(adv[nd][0], adv[nd][1]);
    *reinterpret_cast<float2*>(dv + ob + (long long)key1 * D + c) = make_float2(adv[nd][2], adv[nd][3]);
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <int D>
size_t dq_smem() {
  return (2 * 32 * (D + 8) + D * (32 + 8)) * sizeof(__nv_bfloat16) + 32 * sizeof(int);
}

template <int D>
size_t dkv_smem() {
  return (2 * 64 * (D + 8) + 2 * 32 * (D + 8) + 2 * D * (32 + 8)) * sizeof(__nv_bfloat16) +
         3 * 32 * sizeof(float);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv, void* o,
               float* lse, const long long* st, int B, int H, int Hkv, int S, float scale, int causal,
               int has_seg, int out_f32, cudaStream_t stream) {
  dim3 grid(S / 128, H, B);
  fwd_kernel<D><<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), H, H / Hkv, S, scale, causal, has_seg, out_f32);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
              const void* dout, const float* lse, const float* di, float* dq, const long long* st, int B,
              int H, int Hkv, int S, float scale, int causal, int has_seg, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / 64, H, B);
  bwd_dq_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv, static_cast<const __nv_bfloat16*>(dout), lse,
      di, dq, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), H, H / Hkv, S,
      scale, causal, has_seg);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
               const void* dout, const float* lse, const float* di, float* dk, float* dv,
               const long long* st, int B, int H, int Hkv, int S, float scale, int causal, int has_seg,
               cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / 64, Hkv, B);
  bwd_dkv_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg_q, seg_kv, static_cast<const __nv_bfloat16*>(dout), lse,
      di, dk, dv, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), H, Hkv,
      H / Hkv, S, scale, causal, has_seg);
  return (int)cudaGetLastError();
}

bool shape_ok(int H, int Hkv, int S, int D) {
  return H > 0 && Hkv > 0 && H % Hkv == 0 && S > 0 && S % 128 == 0 && (D == 64 || D == 128);
}

}  // namespace

extern "C" {

// strides: q, k, v, o as (batch, head, row) element strides, 12 values.
int ili_flash_fwd(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv, void* o,
                  float* lse, const long long* strides, int B, int H, int Hkv, int S, int D, float sm_scale,
                  int causal, int has_seg, int out_f32, void* stream) {
  if (!shape_ok(H, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, seg_q, seg_kv, o, lse, strides, B, H, Hkv, S, sm_scale, causal, has_seg,
                          out_f32, st);
  return launch_fwd<128>(q, k, v, seg_q, seg_kv, o, lse, strides, B, H, Hkv, S, sm_scale, causal, has_seg,
                         out_f32, st);
}

// strides: q, k, v, do (12 values); dq is contiguous fp32 [B, H, S, D].
int ili_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                     const void* dout, const float* lse, const float* di, float* dq, const long long* strides,
                     int B, int H, int Hkv, int S, int D, float sm_scale, int causal, int has_seg,
                     void* stream) {
  if (!shape_ok(H, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, seg_q, seg_kv, dout, lse, di, dq, strides, B, H, Hkv, S, sm_scale, causal,
                         has_seg, st);
  return launch_dq<128>(q, k, v, seg_q, seg_kv, dout, lse, di, dq, strides, B, H, Hkv, S, sm_scale, causal,
                        has_seg, st);
}

// strides: q, k, v, do (12 values); dk, dv are contiguous fp32 [B, Hkv, S, D].
int ili_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
                      const void* dout, const float* lse, const float* di, float* dk, float* dv,
                      const long long* strides, int B, int H, int Hkv, int S, int D, float sm_scale,
                      int causal, int has_seg, void* stream) {
  if (!shape_ok(H, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, seg_q, seg_kv, dout, lse, di, dk, dv, strides, B, H, Hkv, S, sm_scale,
                          causal, has_seg, st);
  return launch_dkv<128>(q, k, v, seg_q, seg_kv, dout, lse, di, dk, dv, strides, B, H, Hkv, S, sm_scale,
                         causal, has_seg, st);
}

}  // extern "C"
