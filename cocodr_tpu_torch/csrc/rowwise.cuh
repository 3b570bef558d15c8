// Row-wise pieces of the FFN half-layer kernels (K1 in ffn_block.cu, K7 in
// ffn_block_int8.cu; attention.cu takes the warp reductions for its softmax
// rows): warp reductions, 8-wide bf16 vector packing, the
// activation, the LayerNorm statistics of models/bert.LayerNorm, and the
// final LN2 pass. Every row pass gives one warp to one row, which it reads
// in 8-element vectors (H a multiple of 8).
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

// out = bf16(LN2(z)), z [T, H] float32; one warp per row. Static: each
// kernel source that includes this header has its own copy.
static __global__ void __launch_bounds__(kThreads)
ln2_kernel(const float* __restrict__ z, const float* __restrict__ s2,
           const float* __restrict__ c2, __nv_bfloat16* __restrict__ out,
           int T, int H, float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const int lane = threadIdx.x & 31;
  const float* row = z + static_cast<size_t>(t) * H;
  auto load8 = [&](int c, float* f) { load8_f32(&row[c], f); };
  float m, rs;
  row_stats(load8, H, eps, &m, &rs);
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] - m) * rs * s2[c + e] + c2[c + e];
    *reinterpret_cast<uint4*>(&out[static_cast<size_t>(t) * H + c]) = pack8(f);
  }
}

inline int row_blocks(int T) { return (T + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace rowwise
