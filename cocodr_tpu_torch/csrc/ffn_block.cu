// K1: the post-attention half-layer of a post-LN BERT block,
//   u32 = LN1(r) in float32;  u = bf16(u32)
//   h   = act(u . W1^T + b1)   (float32 accumulation, exact-erf GELU)
//   z32 = (u32 + bf16(h) . W2^T) + b2   (residual added in float32)
//   out = bf16(LN2(z32))
// with r [T, H] bf16, W1 [F, H] and W2 [H, F] bf16 in nn.Linear layout,
// b1 [F] and b2 [H] bf16, LayerNorm scales and biases [H] float32.
//
// Replaces cocodr_tpu/ops/pallas_ffn.py::_ffn_block_kernel (called through
// fused_ffn_block with f_chunks=1), and _ffn_block_chunked_kernel (K4, the
// same function at bert-large widths). The TPU kernel keeps both weight
// matrices (9 MB at bert-base) and the [tokens, F] intermediate in VMEM; an
// H100 block has at most 227 KB of shared memory, so here the half-layer is
// four launches on one stream:
//   ln1:  one warp per token row: LayerNorm statistics (kept, [T, 2]) and
//         u = bf16(LN1(r)) [T, H];
//   up:   GEMM u . W1^T (gemm_wgmma.cuh) with bias + GELU applied to the
//         accumulators in registers, h [T, F] in bf16;
//   down: GEMM h . W2^T whose epilogue recomputes u32 from r and the kept
//         statistics and writes z32 = (u32 + y) + b2, float32 [T, H];
//   ln2:  one warp per row: out = bf16(LN2(z32)).
// u, h and z32 pass through device memory (2*T*H + 2*T*F + 4*T*H bytes,
// ~42 MB written and read again at T = 4096, bert-base): a GEMM block that
// owned whole rows of H for an in-block LN2 would leave most of the 132 SMs
// idle at serving sizes (T = 4096 gives 32 such blocks of 128 rows).
// GELU uses libdevice erff; the TPU kernel uses the Abramowitz-Stegun
// 7.1.26 polynomial (|error| <= 1.5e-7), far below bf16 resolution.
//
// Bound on the H100: 4*T*H*F operations (38.7 GFLOP at T = 4096,
// bert-base) against ~23 MB of r, weights and out: about 1,600 operations
// per byte, so the bf16 tensor cores bound it (~0.039 ms at 989 TFLOP/s;
// 0.313 ms at T = 32,768). Only wgmma fed by TMA reaches that rate, so both
// GEMMs run on gemm_wgmma.cuh: a producer warp keeps 64-column k-stages of
// activations and weights in flight in a 4-6 stage ring, two consumer
// warpgroups multiply 128 x BN tiles with float32 accumulators in
// registers, and the epilogues work on those registers. The output tile
// is chosen per GEMM (gemm_wgmma.cuh's gemm_by_waves) against wave
// quantisation at the serving shape. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W
// (loops of back-to-back launches): K1 0.1155 ms at T = 4096 and 0.823 ms
// at T = 32,768 (38% of the bf16 peak), K4 1.251 ms, K5 0.175 ms at
// T = 8192; the WMMA main loop fed by cp.async that this replaces took
// 0.37-0.43, 2.39-2.50, 3.97-4.12 and 0.57-0.63 ms (one launch per event
// pair). What holds the GEMMs back: one 128 x BN tile per block, so a
// tile's epilogue (GELU, the residual's reads and float32 writes) and
// its first TMA loads do not overlap the next tile's products
// (chip_smoke.py prints each launch's time beside torch.mm of the up
// GEMM's shape).
//
// K5: the FFN without LayerNorm or residual, the dropout path of a training
// layer (dropout sits between the FFN output and the residual add),
//   h   = bf16(act(x . W1^T + b1))   (float32 accumulation and activation)
//   out = bf16(h . W2^T + b2)        (b2 added in float32)
// with x [T, H] bf16 and the weights as above. Replaces
// cocodr_tpu/ops/pallas_ffn.py::_ffn_kernel (called through fused_ffn),
// which holds both weights and the [tokens, F] intermediate in VMEM. Here it
// is two launches on one stream of the same two GEMMs: K1's up GEMM as it
// is (x in place of u), writing h [T, F] bf16 through device memory, and a
// down GEMM whose epilogue adds b2 and rounds. Bound on the H100: 4*T*H*F
// operations (77.3 GFLOP at T = 8192, bert-base: 0.078 ms at 989 TFLOP/s)
// against ~35 MB of x, weights and out, so the tensor cores bound it, as
// for K1.
//
// The split forms (tensor parallelism over M model ranks, parallel/tp.py):
// each rank holds F/M rows of W1 and b1 and F/M columns of W2 and runs the
// same up GEMM on them; its down GEMM writes a float32 partial
// y_m = bf16(h_m) . W2_m^T [T, H] with no bias and no residual
// (PartialEpi), never rounded before the sum. The caller all-reduces the
// partials over the model axis, then a row pass finishes:
//   K1 split: out = bf16(LN2((u32 + y) + b2)), u32 recomputed from r and
//             the kept LN1 statistics, as ResidualEpi does
//             (residual_ln2_kernel);
//   K5 split: out = bf16(y + b2) (bias_round_kernel).
// b2 and the residual enter once, after the sum. The split K1 covers K4's
// widths (H 1024, F/M 2048 at M = 2). Entry points:
// cocodr_ffn_block_partial_bf16 / cocodr_ffn_block_finish_bf16 and
// cocodr_ffn_partial_bf16 / cocodr_ffn_finish_bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"
#include "rowwise.cuh"

namespace {

using namespace rowwise;

__global__ void __launch_bounds__(kThreads)
ln1_kernel(const __nv_bfloat16* __restrict__ r, const float* __restrict__ s1,
           const float* __restrict__ c1, __nv_bfloat16* __restrict__ u,
           float* __restrict__ stats, int T, int H, float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = r + static_cast<size_t>(t) * H;
  __nv_bfloat16* urow = u + static_cast<size_t>(t) * H;
  auto load8 = [&](int c, float* f) {
    unpack8(*reinterpret_cast<const uint4*>(&row[c]), f);
  };
  auto store8 = [&](int c, const float* f) {
    *reinterpret_cast<uint4*>(&urow[c]) = pack8(f);
  };
  float m, rs;
  if (H <= kRowVec * 256) {  // the row in registers, read once
    float f[kRowVec][8];
    load_row(load8, H, f);
    held_row_stats(f, H, eps, &m, &rs);
    normalize_row(f, H, m, rs, s1, c1, store8);
  } else {
    row_stats(load8, H, eps, &m, &rs);
    for (int c = lane * 8; c < H; c += 256) {
      float f[8];
      load8(c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] - m) * rs * s1[c + e] + c1[c + e];
      store8(c, f);
    }
  }
  if (lane == 0) {
    stats[2 * t] = m;
    stats[2 * t + 1] = rs;
  }
}

// The epilogues of gemm_wgmma.cuh: per-column parameters (biases,
// LayerNorm scale and shift) are staged in shared memory by load_col;
// per-element and per-row inputs are read with __ldg (read-only for the
// kernel: plain loads could alias the epilogue's own stores, and nvcc would
// then issue each only after the store before it).
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// h[t, f..f+1] = bf16(act(acc + b1)), the up GEMM's epilogue (K1, K5). The
// activation is a template argument: with a runtime switch every unrolled
// output pair carried the code of all three activations, and the
// epilogue's instruction fetches made the up GEMM several times slower.
template <int Act>
struct UpEpi {
  const __nv_bfloat16* b1;
  __nv_bfloat16* h;
  int F;
  __device__ void load_col(int f, float* p, int) const {
    p[0] = __bfloat162float(b1[f]);
  }
  __device__ float2 row_param(int) const { return make_float2(0.0f, 0.0f); }
  __device__ void operator()(int t, int f, float v0, float v1, const float* p,
                             int, float2) const {
    const float2 b = pair(p);
    *reinterpret_cast<__nv_bfloat162*>(&h[static_cast<size_t>(t) * F + f]) =
        __floats2bfloat162_rn(activation(v0 + b.x, Act),
                              activation(v1 + b.y, Act));
  }
};

// z32 = (u32 + y) + b2 with u32 recomputed from r and LN1's statistics
// (the row parameter), float32 [T, H]: K1's down GEMM epilogue
struct ResidualEpi {
  const __nv_bfloat16* r;
  const float* stats;
  const float* s1;
  const float* c1;
  const __nv_bfloat16* b2;
  float* z;
  int H;
  __device__ void load_col(int c, float* p, int stride) const {
    p[0] = s1[c];
    p[stride] = c1[c];
    p[2 * stride] = __bfloat162float(b2[c]);
  }
  __device__ float2 row_param(int t) const {
    return __ldg(reinterpret_cast<const float2*>(&stats[2 * t]));
  }
  __device__ void operator()(int t, int c, float v0, float v1, const float* p,
                             int stride, float2 st) const {
    const size_t at = static_cast<size_t>(t) * H + c;
    const float2 x = ldg_bf16x2(&r[at]);
    const float2 s = pair(p);
    const float2 o = pair(p + stride);
    const float2 b = pair(p + 2 * stride);
    const float u0 = (x.x - st.x) * st.y * s.x + o.x;
    const float u1 = (x.y - st.x) * st.y * s.y + o.y;
    *reinterpret_cast<float2*>(&z[at]) =
        make_float2((u0 + v0) + b.x, (u1 + v1) + b.y);
  }
};

// out = bf16(y + b2), [T, H]: K5's down GEMM epilogue
struct BiasEpi {
  const __nv_bfloat16* b2;
  __nv_bfloat16* out;
  int H;
  __device__ void load_col(int c, float* p, int) const {
    p[0] = __bfloat162float(b2[c]);
  }
  __device__ float2 row_param(int) const { return make_float2(0.0f, 0.0f); }
  __device__ void operator()(int t, int c, float v0, float v1, const float* p,
                             int, float2) const {
    const float2 b = pair(p);
    *reinterpret_cast<__nv_bfloat162*>(&out[static_cast<size_t>(t) * H + c]) =
        __floats2bfloat162_rn(v0 + b.x, v1 + b.y);
  }
};

// y[t, c..c+1] = acc, float32 [T, H]: the split forms' down GEMM epilogue
// (a partial sum over this rank's F/M, no bias, no residual)
struct PartialEpi {
  float* y;
  int H;
  __device__ void load_col(int, float*, int) const {}
  __device__ float2 row_param(int) const { return make_float2(0.0f, 0.0f); }
  __device__ void operator()(int t, int c, float v0, float v1, const float*,
                             int, float2) const {
    *reinterpret_cast<float2*>(&y[static_cast<size_t>(t) * H + c]) =
        make_float2(v0, v1);
  }
};

// out = bf16(LN2((u32 + y) + b2)) with u32 = (r - mean) * rstd * s1 + c1
// from LN1's kept statistics, y the all-reduced float32 partials: the
// split K1's row pass after the sum. One warp per row.
__global__ void __launch_bounds__(kThreads)
residual_ln2_kernel(const __nv_bfloat16* __restrict__ r,
                    const float* __restrict__ stats,
                    const float* __restrict__ s1, const float* __restrict__ c1,
                    const float* __restrict__ y,
                    const __nv_bfloat16* __restrict__ b2,
                    const float* __restrict__ s2, const float* __restrict__ c2,
                    __nv_bfloat16* __restrict__ out, int T, int H, float eps) {
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform; no barrier in this kernel
  const size_t at = static_cast<size_t>(t) * H;
  const float m1 = stats[2 * t], rs1 = stats[2 * t + 1];
  auto load8 = [&](int c, float* f) {
    float x[8], yy[8], sc[8], bi[8], bb[8];
    unpack8(*reinterpret_cast<const uint4*>(&r[at + c]), x);
    load8_f32(&y[at + c], yy);
    load8_f32(&s1[c], sc);
    load8_f32(&c1[c], bi);
    unpack8(*reinterpret_cast<const uint4*>(&b2[c]), bb);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float u = (x[e] - m1) * rs1 * sc[e] + bi[e];
      f[e] = (u + yy[e]) + bb[e];
    }
  };
  ln2_row(load8, out + at, s2, c2, H, eps);
}

// out = bf16(y + b2), y [T, H] float32: the split K5's pass after the sum.
// One thread per 8 columns of a row.
__global__ void __launch_bounds__(kThreads)
bias_round_kernel(const float* __restrict__ y,
                  const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ out, size_t n8, int H) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n8) return;
  const size_t at = i * 8;
  const int c = static_cast<int>(at % H);
  float f[8], bb[8];
  load8_f32(&y[at], f);
  unpack8(*reinterpret_cast<const uint4*>(&b2[c]), bb);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] += bb[e];
  *reinterpret_cast<uint4*>(&out[at]) = pack8(f);
}

// The bf16 GEMM of [T, K] activations by an [N, K] weight, its tile picked
// by waves over the SMs (gemm_wgmma.cuh), with a pairwise epilogue.
template <class Epi>
cudaError_t gemm(const void* a, const void* w, int T, int N, int K, Epi epi,
                 cudaStream_t s) {
  return wg::gemm_by_waves<wg::Bf16>(a, w, T, N, K, wg::pairwise(epi), s);
}

// h = bf16(act(x . W1^T + b1)), the up GEMM of K1 and K5.
cudaError_t launch_up(const __nv_bfloat16* x, const void* w1, const void* b1,
                      __nv_bfloat16* h, int T, int H, int F, int act,
                      cudaStream_t s) {
  const auto* bias = static_cast<const __nv_bfloat16*>(b1);
  if (act == kGelu) return gemm(x, w1, T, F, H, UpEpi<kGelu>{bias, h, F}, s);
  if (act == kGeluTanh) {
    return gemm(x, w1, T, F, H, UpEpi<kGeluTanh>{bias, h, F}, s);
  }
  return gemm(x, w1, T, F, H, UpEpi<kRelu>{bias, h, F}, s);
}

bool bad_shape(int T, int H, int F, int act) {
  return T <= 0 || H <= 0 || H % 128 || F <= 0 || F % 128 ||
         act < kGelu || act > kRelu;
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

  return gemm(hb, w2, T, H, F,
              BiasEpi{static_cast<const __nv_bfloat16*>(b2),
                      static_cast<__nv_bfloat16*>(out), H},
              s);
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

  e = gemm(hb, w2, T, H, F,
           ResidualEpi{rb, st, s1f, c1f, static_cast<const __nv_bfloat16*>(b2),
                       zf, H},
           s);
  if (e != cudaSuccess) return e;

  ln2_kernel<<<rows, kThreads, 0, s>>>(zf, static_cast<const float*>(s2),
                                       static_cast<const float*>(c2),
                                       static_cast<__nv_bfloat16*>(out), T, H, eps);
  return cudaGetLastError();
}

// The split K1's part before the all-reduce: r [T, H] bf16, this rank's
// w1 [F, H], b1 [F], w2 [H, F] (F its share) -> y [T, H] float32 partial
// and LN1's statistics [T, 2], through the scratch buffers u [T, H] and
// h [T, F] bf16. H % 128 == 0, F % 128 == 0, every pointer 16-byte aligned.
extern "C" int cocodr_ffn_block_partial_bf16(
    const void* r, const void* s1, const void* c1, const void* w1,
    const void* b1, const void* w2, void* u, void* stats, void* h, void* y,
    int T, int H, int F, int act, float eps, void* stream) {
  if (bad_shape(T, H, F, act)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ub = static_cast<__nv_bfloat16*>(u);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  ln1_kernel<<<row_blocks(T), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(s1),
      static_cast<const float*>(c1), ub, static_cast<float*>(stats), T, H,
      eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_up(ub, w1, b1, hb, T, H, F, act, s);
  if (e != cudaSuccess) return e;
  return gemm(hb, w2, T, H, F, PartialEpi{static_cast<float*>(y), H}, s);
}

// The split K1's part after the all-reduce: y [T, H] float32 (the sum of
// the ranks' partials), r, LN1's statistics and parameters, b2 [H] bf16,
// LN2's parameters -> out [T, H] bf16.
extern "C" int cocodr_ffn_block_finish_bf16(
    const void* r, const void* stats, const void* s1, const void* c1,
    const void* y, const void* b2, const void* s2, const void* c2, void* out,
    int T, int H, float eps, void* stream) {
  if (bad_shape(T, H, 128, kGelu)) return cudaErrorInvalidValue;
  residual_ln2_kernel<<<row_blocks(T), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(stats),
      static_cast<const float*>(s1), static_cast<const float*>(c1),
      static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(s2), static_cast<const float*>(c2),
      static_cast<__nv_bfloat16*>(out), T, H, eps);
  return cudaGetLastError();
}

// The split K5's part before the all-reduce: x [T, H] bf16, this rank's
// w1, b1, w2 -> y [T, H] float32 partial, through h [T, F] bf16.
extern "C" int cocodr_ffn_partial_bf16(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       void* h, void* y, int T, int H, int F,
                                       int act, void* stream) {
  if (bad_shape(T, H, F, act)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  cudaError_t e = launch_up(static_cast<const __nv_bfloat16*>(x), w1, b1, hb,
                            T, H, F, act, s);
  if (e != cudaSuccess) return e;
  return gemm(hb, w2, T, H, F, PartialEpi{static_cast<float*>(y), H}, s);
}

// The split K5's part after the all-reduce: y [T, H] float32, b2 [H] bf16
// -> out = bf16(y + b2) [T, H].
extern "C" int cocodr_ffn_finish_bf16(const void* y, const void* b2,
                                      void* out, int T, int H, void* stream) {
  if (bad_shape(T, H, 128, kGelu)) return cudaErrorInvalidValue;
  const size_t n8 = static_cast<size_t>(T) * H / 8;
  const unsigned blocks = static_cast<unsigned>((n8 + kThreads - 1) / kThreads);
  bias_round_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(out), n8, H);
  return cudaGetLastError();
}
