// K7: the W8A8 post-attention half-layer of a post-LN BERT block,
//   u32 = LN1(r) in float32;  (uq, su) = quantize_rows(u32)
//   h   = act(int32(uq . W1q^T) * (su * sw1) + b1)        float32
//   (hq, sh) = quantize_rows(h)
//   y   = int32(hq . W2q^T) * (sh * sw2)                  float32
//   z32 = (u32 + y) + b2;  out = bf16(LN2(z32))
// with r [T, H] bf16, W1q [F, H] and W2q [H, F] int8 in nn.Linear layout
// (per-output-channel scales sw1 [F], sw2 [H], one per weight row), biases
// and LayerNorm parameters float32. quantize_rows is the symmetric per-row
// recipe of ops/int8_matmul.py: s = max(max|x|, 1e-30) / 127,
// q = clip(rint(x / s), -127, 127), rounding half to even.
//
// Replaces cocodr_tpu/ops/pallas_ffn.py::_ffn_block_kernel_int8 (called
// through fused_ffn_block_int8; its quantizer is _quant_rows_f32). The TPU
// kernel holds a whole [256, F] float32 tile of h in VMEM, so it takes each
// token's max |h| before it quantizes; a Hopper block cannot hold that
// (3 MB at bert-base), and the row max of h is a reduction across the
// blocks of the up GEMM. Here the half-layer is five launches on one
// stream:
//   ln1:   a warp per row, the row held in registers: LN1 statistics
//          (kept, [T, 2]), u32's per-row scale su [T] and uq [T, H] int8;
//          zeroes the row's max |h|;
//   up:    int8 GEMM uq . W1q^T whose epilogue dequantizes, adds b1,
//          applies act, writes h [T, F] float32 and folds each row's max
//          |h| into hmax [T] with one atomicMax on the float bits per row
//          and block (|h| >= 0, so the integer order is the float order);
//   quant: a warp per row: sh [T] and hq [T, F] int8;
//   down:  int8 GEMM hq . W2q^T whose epilogue recomputes u32 from r and
//          the kept statistics and writes z32 [T, H] float32;
//   ln2:   a warp per row: out = bf16(LN2(z32)).
// Every float operation the plain version rounds on its own is rounded on
// its own here (__fmul_rn / __fadd_rn / __fdiv_rn: no fused multiply-add),
// so that a quantization point only moves where LN statistics, erf or the
// order of float sums differ.
//
// Bound on the H100: 4*T*H*F int8 operations (309 G at T = 32,768,
// bert-base) against ~100 MB of r, weights and out: the int8 tensor cores
// bound it (~0.156 ms at 1,979 TOP/s). So both GEMMs run on
// gemm_wgmma.cuh's int8 main loop: TMA loads of 128-column k-stages into a
// ring, two consumer warpgroups on wgmma m64nBNk32 with int32 accumulators
// in registers, and epilogues that work on those registers; the tile is
// picked per GEMM by waves over the SMs, as for K1. h goes through device
// memory in float32 (806 MB written and read at T = 32,768, bert-base; the
// quantize pass runs near the memory rate). The schedule that keeps it
// out, a second up GEMM whose epilogue recomputes h bit for bit (int8 sums
// are exact) and quantizes it with the final row scale, was slower on the
// H100 in development builds: the epilogue's activation, paid twice, costs
// about as much as a tile's int8 products, and a block's epilogue does not
// overlap its main loop, so the second GEMM took longer than the float32
// traffic it saves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"
#include "rowwise.cuh"

namespace {

using namespace rowwise;

// One element of models/bert.LayerNorm, ((x - mean) * rstd) * scale + bias,
// each operation rounded on its own.
__device__ __forceinline__ float ln_elem(float x, float m, float rs, float s,
                                         float c) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), rs), s), c);
}

__device__ __forceinline__ float row_scale(float maxabs) {
  return __fdiv_rn(fmaxf(maxabs, 1e-30f), 127.0f);
}

__device__ __forceinline__ uint2 quant8(const float* x, float s) {
  __align__(8) signed char q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = rintf(__fdiv_rn(x[e], s));  // half to even
    q[e] = static_cast<signed char>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  return *reinterpret_cast<const uint2*>(q);
}

// h = act(v * (su * sw1) + b1) of one output of the up GEMM
template <int Act>
__device__ __forceinline__ float up_h(int v, float su, float sw, float b) {
  return activation(__fadd_rn(__fmul_rn(__int2float_rn(v), __fmul_rn(su, sw)), b),
                    Act);
}

__global__ void __launch_bounds__(kThreads)
ln1_quant_kernel(const __nv_bfloat16* __restrict__ r,
                 const float* __restrict__ s1, const float* __restrict__ c1,
                 signed char* __restrict__ uq, float* __restrict__ stats,
                 float* __restrict__ su, int* __restrict__ hmax, int T, int H,
                 float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = r + static_cast<size_t>(t) * H;
  auto load8 = [&](int c, float* f) {
    unpack8(*reinterpret_cast<const uint4*>(&row[c]), f);
  };
  signed char* qrow = uq + static_cast<size_t>(t) * H;
  float m, rs, s;
  if (H <= kRowVec * 256) {  // the row in registers, read once
    float f[kRowVec][8];
    load_row(load8, H, f);
    held_row_stats(f, H, eps, &m, &rs);
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowVec; ++i) {
      const int c = lane * 8 + 256 * i;
      if (c < H) {
        float sc[8], bi[8];
        load8_f32(&s1[c], sc);
        load8_f32(&c1[c], bi);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          f[i][e] = ln_elem(f[i][e], m, rs, sc[e], bi[e]);
          amax = fmaxf(amax, fabsf(f[i][e]));
        }
      }
    }
    s = row_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < kRowVec; ++i) {
      const int c = lane * 8 + 256 * i;
      if (c < H) *reinterpret_cast<uint2*>(&qrow[c]) = quant8(f[i], s);
    }
  } else {
    row_stats(load8, H, eps, &m, &rs);
    float amax = 0.0f;
    for (int c = lane * 8; c < H; c += 256) {
      float f[8];
      load8(c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        amax = fmaxf(amax, fabsf(ln_elem(f[e], m, rs, s1[c + e], c1[c + e])));
    }
    s = row_scale(warp_max(amax));
    for (int c = lane * 8; c < H; c += 256) {
      float f[8];
      load8(c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = ln_elem(f[e], m, rs, s1[c + e], c1[c + e]);
      *reinterpret_cast<uint2*>(&qrow[c]) = quant8(f, s);
    }
  }
  if (lane == 0) {
    stats[2 * t] = m;
    stats[2 * t + 1] = rs;
    su[t] = s;
    hmax[t] = 0;  // the up GEMM's atomicMax starts from |h| = 0
  }
}

// The up GEMM's epilogue: h [T, F] float32, each row's max |h| over the
// block's columns reduced across the quad that holds the row and folded
// into hmax. Column parameters sw1, b1 staged by load_col; su read once per
// row.
template <int Act>
struct UpEpi {
  const float* su;
  const float* sw1;
  const float* b1;
  int* hmax;
  float* h;
  int F;
  __device__ void load_col(int f, float* p, int stride) const {
    p[0] = sw1[f];
    p[stride] = b1[f];
  }
  template <int BN>
  __device__ __forceinline__ void tile(const int (&d)[BN / 2], int row,
                                       int col, const float* p, int M) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row + 8 * half;
      const float st = __ldg(&su[t < M ? t : 0]);
      float* hrow = h + static_cast<size_t>(t < M ? t : 0) * F + col;
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float* q = p + 8 * j;
        const float h0 = up_h<Act>(d[4 * j + 2 * half], st, q[0], q[BN]);
        const float h1 =
            up_h<Act>(d[4 * j + 2 * half + 1], st, q[1], q[BN + 1]);
        amax = fmaxf(amax, fmaxf(fabsf(h0), fabsf(h1)));
        if (t < M) {
          *reinterpret_cast<float2*>(hrow + 8 * j) = make_float2(h0, h1);
        }
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      if (t < M && (threadIdx.x & 3) == 0) {
        atomicMax(&hmax[t], __float_as_int(amax));
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
quant_h_kernel(const float* __restrict__ h, const int* __restrict__ hmax,
               signed char* __restrict__ hq, float* __restrict__ sh, int T,
               int F) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const int lane = threadIdx.x & 31;
  const float s = row_scale(__int_as_float(hmax[t]));
  const float* row = h + static_cast<size_t>(t) * F;
  for (int c = lane * 8; c < F; c += 256) {
    float f[8];
    load8_f32(&row[c], f);
    *reinterpret_cast<uint2*>(&hq[static_cast<size_t>(t) * F + c]) =
        quant8(f, s);
  }
  if (lane == 0) sh[t] = s;
}

// The down GEMM's epilogue, pairwise: z32 = (u32 + y) + b2 with u32
// recomputed from r, LN1's statistics and sh (the row parameter); column
// parameters s1, c1, sw2, b2.
struct DownEpi {
  const __nv_bfloat16* r;
  const float* stats;
  const float* sh;
  const float* s1;
  const float* c1;
  const float* sw2;
  const float* b2;
  float* z;
  int H;
  __device__ void load_col(int c, float* p, int stride) const {
    p[0] = s1[c];
    p[stride] = c1[c];
    p[2 * stride] = sw2[c];
    p[3 * stride] = b2[c];
  }
  __device__ float4 row_param(int t) const {
    const float2 st = __ldg(reinterpret_cast<const float2*>(&stats[2 * t]));
    return make_float4(st.x, st.y, __ldg(&sh[t]), 0.0f);
  }
  __device__ void operator()(int t, int c, int v0, int v1, const float* p,
                             int stride, float4 rp) const {
    const size_t at = static_cast<size_t>(t) * H + c;
    const float2 x = ldg_bf16x2(&r[at]);
    float o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float u32 = ln_elem(e ? x.y : x.x, rp.x, rp.y, p[e], p[stride + e]);
      const float y = __fmul_rn(__int2float_rn(e ? v1 : v0),
                                __fmul_rn(rp.z, p[2 * stride + e]));
      o[e] = __fadd_rn(__fadd_rn(u32, y), p[3 * stride + e]);
    }
    *reinterpret_cast<float2*>(&z[at]) = make_float2(o[0], o[1]);
  }
};

// h, hmax and then hq, sh
template <int Act>
cudaError_t up_quant(const signed char* uq, const void* w1q, const float* su,
                     const float* sw1, const float* b1, int* hmax, float* h,
                     signed char* hq, float* sh, int T, int H, int F,
                     cudaStream_t s) {
  const cudaError_t e = wg::gemm_by_waves<wg::S8>(
      uq, w1q, T, F, H, UpEpi<Act>{su, sw1, b1, hmax, h, F}, s);
  if (e != cudaSuccess) return e;
  quant_h_kernel<<<row_blocks(T), kThreads, 0, s>>>(h, hmax, hq, sh, T, F);
  return cudaGetLastError();
}

}  // namespace

// r [T, H] bf16 -> out [T, H] bf16, through the scratch buffers uq [T, H]
// int8, stats [T, 2], su [T], hmax [T] (int), h [T, F] float32, hq [T, F]
// int8, sh [T] and z [T, H] float32. H % 128 == 0, F % 128 == 0, every
// pointer 16-byte aligned.
extern "C" int cocodr_ffn_block_int8(
    const void* r, const void* s1, const void* c1, const void* w1q,
    const void* sw1, const void* b1, const void* w2q, const void* sw2,
    const void* b2, const void* s2, const void* c2, void* uq, void* stats,
    void* su, void* hmax, void* h, void* hq, void* sh, void* z, void* out,
    int T, int H, int F, int act, float eps, void* stream) {
  if (T <= 0 || H <= 0 || H % 128 || F <= 0 || F % 128 || act < kGelu ||
      act > kRelu) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* c1f = static_cast<const float*>(c1);
  const auto* sw1f = static_cast<const float*>(sw1);
  const auto* b1f = static_cast<const float*>(b1);
  auto* uqi = static_cast<signed char*>(uq);
  auto* st = static_cast<float*>(stats);
  auto* suf = static_cast<float*>(su);
  auto* hm = static_cast<int*>(hmax);
  auto* hf = static_cast<float*>(h);
  auto* hqi = static_cast<signed char*>(hq);
  auto* shf = static_cast<float*>(sh);
  auto* zf = static_cast<float*>(z);
  const int rows = row_blocks(T);

  ln1_quant_kernel<<<rows, kThreads, 0, s>>>(rb, s1f, c1f, uqi, st, suf, hm, T,
                                             H, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (act == kGelu) {
    e = up_quant<kGelu>(uqi, w1q, suf, sw1f, b1f, hm, hf, hqi, shf, T, H, F,
                        s);
  } else if (act == kGeluTanh) {
    e = up_quant<kGeluTanh>(uqi, w1q, suf, sw1f, b1f, hm, hf, hqi, shf, T, H,
                            F, s);
  } else {
    e = up_quant<kRelu>(uqi, w1q, suf, sw1f, b1f, hm, hf, hqi, shf, T, H, F,
                        s);
  }
  if (e != cudaSuccess) return e;

  e = wg::gemm_by_waves<wg::S8>(
      hqi, w2q, T, H, F,
      wg::pairwise(DownEpi{rb, st, shf, s1f, c1f,
                           static_cast<const float*>(sw2),
                           static_cast<const float*>(b2), zf, H}),
      s);
  if (e != cudaSuccess) return e;

  ln2_kernel<<<rows, kThreads, 0, s>>>(zf, static_cast<const float*>(s2),
                                       static_cast<const float*>(c2),
                                       static_cast<__nv_bfloat16*>(out), T, H, eps);
  return cudaGetLastError();
}
