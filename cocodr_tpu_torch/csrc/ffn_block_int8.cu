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
//   ln1:   a warp per row: LN1 statistics (kept, [T, 2]), u32's per-row
//          scale su [T] and uq [T, H] int8; zeroes the row's max |h|;
//   up:    int8 GEMM uq . W1q^T (gemm_nt.cuh's int8 ring, int32 sums)
//          whose epilogue dequantizes, adds b1, applies act, writes h
//          [T, F] float32 and folds each row's max |h| in with atomicMax on
//          the float bits (|h| >= 0, so the integer order is the float
//          order);
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
// bound it (~0.156 ms at 1,979 TOP/s). The float32 h goes through device
// memory (4*T*F bytes written and read, 403 MB at T = 32,768, bert-base),
// and the GEMMs multiply with WMMA (mma.sync) fragments, not wgmma fed by
// TMA, so the kernel stays well short of that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_nt.cuh"
#include "rowwise.cuh"

namespace {

using namespace rowwise;

constexpr int kUpBM = 128, kUpBN = 128;
constexpr int kDownBM = 64, kDownBN = 128;
static_assert(kThreads == gemm::kThreads, "row and GEMM blocks share a size");

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
  float m, rs;
  row_stats(load8, H, eps, &m, &rs);
  float amax = 0.0f;
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      amax = fmaxf(amax, fabsf(ln_elem(f[e], m, rs, s1[c + e], c1[c + e])));
  }
  const float s = row_scale(warp_max(amax));
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = ln_elem(f[e], m, rs, s1[c + e], c1[c + e]);
    *reinterpret_cast<uint2*>(&uq[static_cast<size_t>(t) * H + c]) = quant8(f, s);
  }
  if (lane == 0) {
    stats[2 * t] = m;
    stats[2 * t + 1] = rs;
    su[t] = s;
    hmax[t] = 0;  // the up GEMM's atomicMax starts from |h| = 0
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ffn_up_int8_kernel(const signed char* __restrict__ uq,
                   const signed char* __restrict__ w1q,
                   const float* __restrict__ su, const float* __restrict__ sw1,
                   const float* __restrict__ b1, float* __restrict__ h,
                   int* __restrict__ hmax, int T, int H, int F, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = gemm::Tile<kUpBM, kUpBN, signed char>;
  const int m0 = blockIdx.y * kUpBM;
  const int n0 = blockIdx.x * kUpBN;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kUpBM, kUpBN>(acc, reinterpret_cast<signed char*>(smem), uq,
                               w1q, m0, n0, T, F, H);
  gemm::epilogue<kUpBM, kUpBN, signed char>(
      acc, smem, m0, n0, [&](int t, int f, int* v) {
        const bool live = t < T;
        const float st = live ? su[t] : 0.0f;
        float o[8];
        float amax = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __fmul_rn(__int2float_rn(v[e]), __fmul_rn(st, sw1[f + e]));
          o[e] = activation(__fadd_rn(x, b1[f + e]), act);
          amax = fmaxf(amax, fabsf(o[e]));
        }
        // lanes 2i and 2i+1 hold the two halves of one row's 16 columns
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        if (!live) return;
        store8_f32(&h[static_cast<size_t>(t) * F + f], o);
        if ((threadIdx.x & 1) == 0) atomicMax(&hmax[t], __float_as_int(amax));
      });
}

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
    *reinterpret_cast<uint2*>(&hq[static_cast<size_t>(t) * F + c]) = quant8(f, s);
  }
  if (lane == 0) sh[t] = s;
}

__global__ void __launch_bounds__(kThreads)
ffn_down_int8_kernel(const signed char* __restrict__ hq,
                     const signed char* __restrict__ w2q,
                     const float* __restrict__ sh, const float* __restrict__ sw2,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ stats,
                     const float* __restrict__ s1, const float* __restrict__ c1,
                     const float* __restrict__ b2, float* __restrict__ z, int T,
                     int H, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = gemm::Tile<kDownBM, kDownBN, signed char>;
  const int m0 = blockIdx.y * kDownBM;
  const int n0 = blockIdx.x * kDownBN;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kDownBM, kDownBN>(acc, reinterpret_cast<signed char*>(smem),
                                   hq, w2q, m0, n0, T, H, F);
  gemm::epilogue<kDownBM, kDownBN, signed char>(
      acc, smem, m0, n0, [&](int t, int c, int* v) {
        if (t >= T) return;
        const float m = stats[2 * t];
        const float rs = stats[2 * t + 1];
        const float st = sh[t];
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(&r[static_cast<size_t>(t) * H + c]), x);
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float u32 = ln_elem(x[e], m, rs, s1[c + e], c1[c + e]);
          const float y = __fmul_rn(__int2float_rn(v[e]), __fmul_rn(st, sw2[c + e]));
          o[e] = __fadd_rn(__fadd_rn(u32, y), b2[c + e]);
        }
        store8_f32(&z[static_cast<size_t>(t) * H + c], o);
      });
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
  if (T <= 0 || H <= 0 || H % kDownBN || F <= 0 || F % kUpBN || act < kGelu ||
      act > kRelu || (T + kDownBM - 1) / kDownBM > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* c1f = static_cast<const float*>(c1);
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

  constexpr size_t up_smem = gemm::Tile<kUpBM, kUpBN, signed char>::kSmemBytes;
  e = cudaFuncSetAttribute(ffn_up_int8_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(up_smem));
  if (e != cudaSuccess) return e;
  const dim3 up_grid(F / kUpBN, (T + kUpBM - 1) / kUpBM);
  ffn_up_int8_kernel<<<up_grid, kThreads, up_smem, s>>>(
      uqi, static_cast<const signed char*>(w1q), suf,
      static_cast<const float*>(sw1), static_cast<const float*>(b1), hf, hm, T,
      H, F, act);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  quant_h_kernel<<<rows, kThreads, 0, s>>>(hf, hm, hqi, shf, T, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr size_t down_smem =
      gemm::Tile<kDownBM, kDownBN, signed char>::kSmemBytes;
  e = cudaFuncSetAttribute(ffn_down_int8_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(down_smem));
  if (e != cudaSuccess) return e;
  const dim3 down_grid(H / kDownBN, (T + kDownBM - 1) / kDownBM);
  ffn_down_int8_kernel<<<down_grid, kThreads, down_smem, s>>>(
      hqi, static_cast<const signed char*>(w2q), shf,
      static_cast<const float*>(sw2), rb, st, s1f, c1f,
      static_cast<const float*>(b2), zf, T, H, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  ln2_kernel<<<rows, kThreads, 0, s>>>(zf, static_cast<const float*>(s2),
                                       static_cast<const float*>(c2),
                                       static_cast<__nv_bfloat16*>(out), T, H, eps);
  return cudaGetLastError();
}
