// Row-wise pieces of the FFN half-layer kernels (K1 and K5 in ffn_block.cu,
// K7 in ffn_block_int8.cu): warp reductions, 8-wide bf16 vector packing, a
// 2-wide read-only load, the activation, the LayerNorm statistics of
// models/bert.LayerNorm, and the final LN2 pass. Every row pass gives one
// warp to one row, which it reads in 8-element vectors (H a multiple of 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rowwise {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

enum Act { kGelu = 0, kGeluTanh = 1, kRelu = 2 };

__device__ __forceinline__ float activation(float x, int act) {
  if (act == kGelu) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  if (act == kGeluTanh) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return fmaxf(x, 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(x[e]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  __align__(16) __nv_bfloat16 x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __float2bfloat16(f[e]);
  return *reinterpret_cast<const uint4*>(x);
}

// two bf16 values as float2 through the read-only path (__ldg): for GEMM
// epilogues that read an input beside their own stores
__device__ __forceinline__ float2 ldg_bf16x2(const __nv_bfloat16* p) {
  const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8_f32(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// LayerNorm statistics of a models/bert.LayerNorm: mean, then the mean of
// the squared centred values; a warp reads its row in 8-wide vectors.
template <class Load8>
__device__ __forceinline__ void row_stats(Load8 load8, int H, float eps,
                                          float* mean, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float m = warp_sum(s) / H;
  float v = 0.0f;
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) v += (f[e] - m) * (f[e] - m);
  }
  *mean = m;
  *rstd = rsqrtf(warp_sum(v) / H + eps);
}

// A row of at most kRowVec * 256 values held in registers, read once: the
// lane's 8-wide vectors at columns lane * 8 + 256 * i, the order in which
// row_stats reads them, so that the statistics come out the same.
constexpr int kRowVec = 4;  // H <= 1,024: bert-base and bert-large

template <class Load8>
__device__ __forceinline__ void load_row(Load8 load8, int H,
                                         float (&f)[kRowVec][8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowVec; ++i) {
    if (lane * 8 + 256 * i < H) load8(lane * 8 + 256 * i, f[i]);
  }
}

__device__ __forceinline__ void held_row_stats(const float (&f)[kRowVec][8],
                                               int H, float eps, float* mean,
                                               float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowVec; ++i) {
    if (lane * 8 + 256 * i < H) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[i][e];
    }
  }
  const float m = warp_sum(s) / H;
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowVec; ++i) {
    if (lane * 8 + 256 * i < H) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v += (f[i][e] - m) * (f[i][e] - m);
    }
  }
  *mean = m;
  *rstd = rsqrtf(warp_sum(v) / H + eps);
}

// dst[c..c+7] = bf16((f - m) * rs * scale + bias) for each of the lane's
// vectors, scale and bias float32 [H]
template <class Store8>
__device__ __forceinline__ void normalize_row(float (&f)[kRowVec][8], int H,
                                              float m, float rs,
                                              const float* scale,
                                              const float* bias,
                                              Store8 store8) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowVec; ++i) {
    const int c = lane * 8 + 256 * i;
    if (c < H) {
      float sc[8], bi[8];
      load8_f32(&scale[c], sc);
      load8_f32(&bias[c], bi);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[i][e] = (f[i][e] - m) * rs * sc[e] + bi[e];
      store8(c, f[i]);
    }
  }
}

// orow = bf16(LN2(z)) of one row, z read 8 values at a time by load8(c, f)
// (twice when the row does not fit in registers); the calling warp owns
// the row.
template <class Load8>
__device__ __forceinline__ void ln2_row(Load8 load8, __nv_bfloat16* orow,
                                        const float* s2, const float* c2,
                                        int H, float eps) {
  const int lane = threadIdx.x & 31;
  auto store8 = [&](int c, const float* f) {
    *reinterpret_cast<uint4*>(&orow[c]) = pack8(f);
  };
  float m, rs;
  if (H <= kRowVec * 256) {
    float f[kRowVec][8];
    load_row(load8, H, f);
    held_row_stats(f, H, eps, &m, &rs);
    normalize_row(f, H, m, rs, s2, c2, store8);
    return;
  }
  row_stats(load8, H, eps, &m, &rs);
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] - m) * rs * s2[c + e] + c2[c + e];
    store8(c, f);
  }
}

// out = bf16(LN2(z)), z [T, H] float32; one warp per row, held in
// registers when H <= kRowVec * 256. Static: each kernel source that
// includes this header has its own copy.
static __global__ void __launch_bounds__(kThreads)
ln2_kernel(const float* __restrict__ z, const float* __restrict__ s2,
           const float* __restrict__ c2, __nv_bfloat16* __restrict__ out,
           int T, int H, float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const float* row = z + static_cast<size_t>(t) * H;
  auto load8 = [&](int c, float* f) { load8_f32(&row[c], f); };
  ln2_row(load8, out + static_cast<size_t>(t) * H, s2, c2, H, eps);
}

inline int row_blocks(int T) { return (T + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace rowwise
