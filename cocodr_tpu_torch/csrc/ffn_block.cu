// K1: the post-attention half-layer of a post-LN BERT block,
//   u32 = LN1(r) in float32;  u = bf16(u32)
//   h   = act(u . W1^T + b1)   (float32 accumulation, exact-erf GELU)
//   z32 = (u32 + bf16(h) . W2^T) + b2   (residual added in float32)
//   out = bf16(LN2(z32))
// with r [T, H] bf16, W1 [F, H] and W2 [H, F] bf16 in nn.Linear layout,
// b1 [F] and b2 [H] bf16, LayerNorm scales and biases [H] float32.
//
// Replaces cocodr_tpu/ops/pallas_ffn.py::_ffn_block_kernel (called through
// fused_ffn_block with f_chunks=1). The TPU kernel keeps both weight
// matrices (9 MB at bert-base) and the [tokens, F] intermediate in VMEM; an
// H100 block has at most 227 KB of shared memory, so here the half-layer is
// four launches on one stream:
//   ln1:  one warp per token row: LayerNorm statistics (kept, [T, 2]) and
//         u = bf16(LN1(r)) [T, H];
//   up:   tiled GEMM u . W1^T (gemm_nt.cuh) with bias + GELU in the
//         epilogue, h [T, F] in bf16;
//   down: tiled GEMM h . W2^T whose epilogue recomputes u32 from r and the
//         kept statistics and writes z32 = (u32 + y) + b2, float32 [T, H];
//   ln2:  one warp per row: out = bf16(LN2(z32)).
// u, h and z32 pass through device memory (2*T*H + 2*T*F + 4*T*H bytes,
// ~42 MB written and read again at T = 4096, bert-base): a GEMM block that
// owned whole rows of H for an in-block LN2 would leave most of the 132 SMs
// idle at serving sizes (T = 4096 gives 128 such blocks of 32 rows).
// GELU uses libdevice erff; the TPU kernel uses the Abramowitz-Stegun
// 7.1.26 polynomial (|error| <= 1.5e-7), far below bf16 resolution.
//
// Bound on the H100: 4*T*H*F operations (38.7 GFLOP at T = 4096,
// bert-base) against ~23 MB of r, weights and out: about 1,600 operations
// per byte, so the bf16 tensor cores bound it (~0.039 ms at 989 TFLOP/s).
// The GEMMs multiply with WMMA (mma.sync) fragments fed by a 3-stage
// cp.async ring, not wgmma fed by TMA, so they stay short of that bound.
//
// K5: the FFN without LayerNorm or residual, the dropout path of a training
// layer (dropout sits between the FFN output and the residual add),
//   h   = bf16(act(x . W1^T + b1))   (float32 accumulation and activation)
//   out = bf16(h . W2^T + b2)        (b2 added in float32)
// with x [T, H] bf16 and the weights as above. Replaces
// cocodr_tpu/ops/pallas_ffn.py::_ffn_kernel (called through fused_ffn),
// which holds both weights and the [tokens, F] intermediate in VMEM. Here it
// is two launches on one stream: K1's up GEMM as it is (x in place of u),
// writing h [T, F] bf16 through device memory, and a down GEMM whose
// epilogue adds b2 and rounds. Bound on the H100: 4*T*H*F operations
// (77.3 GFLOP at T = 8192, bert-base: 0.078 ms at 989 TFLOP/s) against
// ~35 MB of x, weights and out, so the tensor cores bound it, as for K1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_nt.cuh"
#include "rowwise.cuh"

namespace {

using namespace rowwise;

constexpr int kUpBM = 128, kUpBN = 128;
constexpr int kDownBM = 64, kDownBN = 128;
static_assert(kThreads == gemm::kThreads, "row and GEMM blocks share a size");

__global__ void __launch_bounds__(kThreads)
ln1_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ s1,
           const float* __restrict__ c1, __nv_bfloat16* __restrict__ u,
           float* __restrict__ stats, int T, int H, float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = r + static_cast<size_t>(t) * H;
  auto load8 = [&](int c, float* f) {
    unpack8(*reinterpret_cast<const uint4*>(&row[c]), f);
  };
  float m, rs;
  row_stats(load8, H, eps, &m, &rs);
  for (int c = lane * 8; c < H; c += 256) {
    float f[8];
    load8(c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] - m) * rs * s1[c + e] + c1[c + e];
    *reinterpret_cast<uint4*>(&u[static_cast<size_t>(t) * H + c]) = pack8(f);
  }
  if (lane == 0) {
    stats[2 * t] = m;
    stats[2 * t + 1] = rs;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ffn_up_kernel(const __nv_bfloat16* __restrict__ u,
              const __nv_bfloat16* __restrict__ w1,
              const __nv_bfloat16* __restrict__ b1,
              __nv_bfloat16* __restrict__ h, int T, int H, int F, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = gemm::Tile<kUpBM, kUpBN>;
  const int m0 = blockIdx.y * kUpBM;
  const int n0 = blockIdx.x * kUpBN;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kUpBM, kUpBN>(acc, reinterpret_cast<__nv_bfloat16*>(smem), u,
                               w1, m0, n0, T, F, H);
  gemm::epilogue<kUpBM, kUpBN>(acc, smem, m0, n0, [&](int t, int f, float* v) {
    if (t >= T) return;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = activation(v[e] + __bfloat162float(b1[f + e]), act);
    *reinterpret_cast<uint4*>(&h[static_cast<size_t>(t) * F + f]) = pack8(o);
  });
}

__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const __nv_bfloat16* __restrict__ h,
                const __nv_bfloat16* __restrict__ w2,
                const __nv_bfloat16* __restrict__ r,
                const float* __restrict__ stats, const float* __restrict__ s1,
                const float* __restrict__ c1,
                const __nv_bfloat16* __restrict__ b2, float* __restrict__ z,
                int T, int H, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = gemm::Tile<kDownBM, kDownBN>;
  const int m0 = blockIdx.y * kDownBM;
  const int n0 = blockIdx.x * kDownBN;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kDownBM, kDownBN>(acc, reinterpret_cast<__nv_bfloat16*>(smem),
                                   h, w2, m0, n0, T, H, F);
  gemm::epilogue<kDownBM, kDownBN>(acc, smem, m0, n0, [&](int t, int c, float* v) {
    if (t >= T) return;
    const float m = stats[2 * t];
    const float rs = stats[2 * t + 1];
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(&r[static_cast<size_t>(t) * H + c]), x);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float u32 = (x[e] - m) * rs * s1[c + e] + c1[c + e];
      o[e] = (u32 + v[e]) + __bfloat162float(b2[c + e]);
    }
    store8_f32(&z[static_cast<size_t>(t) * H + c], o);
  });
}

__global__ void __launch_bounds__(kThreads)
ffn_out_kernel(const __nv_bfloat16* __restrict__ h,
               const __nv_bfloat16* __restrict__ w2,
               const __nv_bfloat16* __restrict__ b2,
               __nv_bfloat16* __restrict__ out, int T, int H, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Tile = gemm::Tile<kDownBM, kDownBN>;
  const int m0 = blockIdx.y * kDownBM;
  const int n0 = blockIdx.x * kDownBN;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kDownBM, kDownBN>(acc, reinterpret_cast<__nv_bfloat16*>(smem),
                                   h, w2, m0, n0, T, H, F);
  gemm::epilogue<kDownBM, kDownBN>(acc, smem, m0, n0, [&](int t, int c, float* v) {
    if (t >= T) return;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = v[e] + __bfloat162float(b2[c + e]);
    *reinterpret_cast<uint4*>(&out[static_cast<size_t>(t) * H + c]) = pack8(o);
  });
}

// h = bf16(act(x . W1^T + b1)), the up GEMM of K1 and K5.
cudaError_t launch_up(const __nv_bfloat16* x, const void* w1, const void* b1,
                      __nv_bfloat16* h, int T, int H, int F, int act,
                      cudaStream_t s) {
  constexpr size_t up_smem = gemm::Tile<kUpBM, kUpBN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(up_smem));
  if (e != cudaSuccess) return e;
  const dim3 up_grid(F / kUpBN, (T + kUpBM - 1) / kUpBM);
  ffn_up_kernel<<<up_grid, kThreads, up_smem, s>>>(
      x, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), h, T, H, F, act);
  return cudaGetLastError();
}

bool bad_shape(int T, int H, int F, int act) {
  return T <= 0 || H <= 0 || H % kDownBN || F <= 0 || F % kUpBN ||
         act < kGelu || act > kRelu || (T + kDownBM - 1) / kDownBM > 65535;
}

}  // namespace

// x [T, H] bf16 -> out [T, H] bf16 (K5), through the scratch buffer h
// [T, F] bf16. H % 128 == 0, F % 128 == 0, every pointer 16-byte aligned.
extern "C" int cocodr_ffn_bf16(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h,
                               void* out, int T, int H, int F, int act,
                               void* stream) {
  if (bad_shape(T, H, F, act)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  cudaError_t e = launch_up(static_cast<const __nv_bfloat16*>(x), w1, b1, hb,
                            T, H, F, act, s);
  if (e != cudaSuccess) return e;

  constexpr size_t down_smem = gemm::Tile<kDownBM, kDownBN>::kSmemBytes;
  e = cudaFuncSetAttribute(ffn_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(down_smem));
  if (e != cudaSuccess) return e;
  const dim3 down_grid(H / kDownBN, (T + kDownBM - 1) / kDownBM);
  ffn_out_kernel<<<down_grid, kThreads, down_smem, s>>>(
      hb, static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out),
      T, H, F);
  return cudaGetLastError();
}

// r [T, H] bf16 -> out [T, H] bf16, through the scratch buffers u [T, H]
// bf16, stats [T, 2] float32, h [T, F] bf16 and z [T, H] float32.
// H % 128 == 0, F % 128 == 0, every pointer 16-byte aligned.
extern "C" int cocodr_ffn_block_bf16(const void* r, const void* s1, const void* c1,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* s2, const void* c2,
                                     void* u, void* stats, void* h, void* z, void* out,
                                     int T, int H, int F, int act, float eps,
                                     void* stream) {
  if (bad_shape(T, H, F, act)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* c1f = static_cast<const float*>(c1);
  auto* ub = static_cast<__nv_bfloat16*>(u);
  auto* st = static_cast<float*>(stats);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* zf = static_cast<float*>(z);
  const int rows = row_blocks(T);

  ln1_kernel<<<rows, kThreads, 0, s>>>(rb, s1f, c1f, ub, st, T, H, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  e = launch_up(ub, w1, b1, hb, T, H, F, act, s);
  if (e != cudaSuccess) return e;

  constexpr size_t down_smem = gemm::Tile<kDownBM, kDownBN>::kSmemBytes;
  e = cudaFuncSetAttribute(ffn_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(down_smem));
  if (e != cudaSuccess) return e;
  const dim3 down_grid(H / kDownBN, (T + kDownBM - 1) / kDownBM);
  ffn_down_kernel<<<down_grid, kThreads, down_smem, s>>>(
      hb, static_cast<const __nv_bfloat16*>(w2), rb, st, s1f, c1f,
      static_cast<const __nv_bfloat16*>(b2), zf, T, H, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  ln2_kernel<<<rows, kThreads, 0, s>>>(zf, static_cast<const float*>(s2),
                                       static_cast<const float*>(c2),
                                       static_cast<__nv_bfloat16*>(out), T, H, eps);
  return cudaGetLastError();
}
