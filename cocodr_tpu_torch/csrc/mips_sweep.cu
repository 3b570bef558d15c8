// K2: dual block-max sweep, and K10: block-32 max sweep. scores =
// corpus . queries^T from bf16 inputs with float32 accumulation, reduced
// in the block to per-block maxima; only the maxima leave.
//
// K2 replaces cocodr_tpu/ops/pallas_mips.py::_sweep_kernel2 (called
// through _dual_sweep_mixed, fine=8, coarse=8): the maxima of every 8-row
// (fine) and 64-row (coarse) corpus block, both query-major, fine
// [Q, N/8] and coarse [Q, N/64], the layout that the port's block
// selection gathers from (the TPU kernel's 3D super-rows layout and
// corpus-major coarse maxima were Mosaic tiling workarounds). A coarse
// maximum is the max of its 8 fine maxima, as on the TPU. With pack
// (_pack_argmax, the fast search) each fine maximum carries its
// first-occurrence argmax row in the 3 low bits of its float32 bit
// pattern, (bits & ~7) | arg, negative values too, and the coarse maximum
// is the float max of the packed fine values.
//
// K10 replaces cocodr_tpu/ops/pallas_mips.py::_sweep_kernel (called
// through blockmax_sweep_pallas and _blockmax_sweep_transposed, block=32):
// the maxima of every 32-row block, query-major [Q, N/32].
//
// Float sums run in another order than XLA's, so maxima agree to float32
// rounding, not bit for bit, and a packed argmax may differ where two rows
// of a block score within a few ULP of each other.
//
// Bound on the H100: at the serving shape (Q = 64, N = 1,048,576,
// D = 768) a sweep does 2*Q*N*D = 103 GFLOP against 1.5 GiB of corpus,
// 64 operations per byte, far below the ~295 where bf16 tensor cores
// become the limit: it is bound by reading the corpus (~0.48 ms at
// 3.35 TB/s). At Q = 1024 (mining and search chunks) it does 1,024
// operations per byte and the tensor cores bound it. Design: each block
// streams its 256 corpus rows once, for a tile of up to 64 queries,
// through the cp.async ring of gemm_nt.cuh and multiplies on the tensor
// cores; each warp owns whole 64-row blocks (sweep.cuh), so every
// reduction finishes inside the warp and the [N, Q] score matrix never
// reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using sweep::kFine;
using sweep::kQueries;
using sweep::kRows;
using Tile = sweep::TileBf16;

enum Mode { kMax = 0, kPack = 1, kBlock32 = 2 };

__device__ __forceinline__ float pack3(float best, int arg) {
  return __int_as_float((__float_as_int(best) & ~7) | arg);
}

// kMax / kPack: out0 fine [Q, N/8], out1 coarse [Q, N/64].
// kBlock32: out0 [Q, N/32]; out1 unused.
// Two blocks per SM: the sweep streams the corpus and needs the loads of
// both in flight to approach the memory rate.
template <int kMode>
__global__ void __launch_bounds__(gemm::kThreads, 2)
sweep_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ c, float* __restrict__ out0,
             float* __restrict__ out1, int Q, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n0, q0;
  sweep::tile_origin(Q, n0, q0);
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kRows, kQueries>(acc, reinterpret_cast<__nv_bfloat16*>(smem),
                                  c, q, n0, q0, N, Q, D);

  const int wm = warp >> 2;
  const int wn = warp & 3;
  float* scr = reinterpret_cast<float*>(smem) + warp * 16 * gemm::kScrLd;
  const int qq = lane & 15;
  const int fb = lane >> 4;
  const int qi = q0 + wn * Tile::kWN + qq;
  const bool live = qi < Q;
  const size_t n_fine = N / kFine;
  const size_t n_coarse = N / 64;
  const size_t n_b32 = N / 32;
  const float lowest = -__int_as_float(0x7f800000);  // -inf
  float cm = 0.0f;
#pragma unroll
  for (int i = 0; i < Tile::kFM; ++i) {
    nvcuda::wmma::store_matrix_sync(scr, acc[i][0], gemm::kScrLd,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    const sweep::Stats<float> st = sweep::fine_stats(scr, fb, qq, lowest);
    __syncwarp();
    const int row = n0 + wm * Tile::kWM + i * 16 + fb * kFine;
    if (kMode == kBlock32) {
      // fragments (2j, 2j+1) x both lanes hold one 32-row block
      cm = (i % 2 == 0) ? st.best : fmaxf(cm, st.best);
      if (i % 2 == 1) {
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
        if (fb == 0 && live) out0[qi * n_b32 + row / 32] = cm;
      }
    } else {
      const float m = kMode == kPack ? pack3(st.best, st.arg) : st.best;
      if (live) out0[qi * n_fine + row / kFine] = m;
      cm = (i % 4 == 0) ? m : fmaxf(cm, m);
      if (i % 4 == 3) {
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
        if (fb == 0 && live) out1[qi * n_coarse + row / 64] = cm;
      }
    }
  }
}

template <int kMode>
int launch(const void* queries, const void* corpus, void* out0, void* out1,
           int Q, int N, int D, void* stream) {
  if (!sweep::shapes_ok(Q, N, D, gemm::kBK)) return cudaErrorInvalidValue;
  constexpr size_t smem = Tile::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sweep_kernel<kMode><<<sweep::grid_blocks(Q, N), gemm::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const __nv_bfloat16*>(corpus), static_cast<float*>(out0),
      static_cast<float*>(out1), Q, N, D);
  return cudaGetLastError();
}

}  // namespace

// queries [Q, D] bf16, corpus [N, D] bf16 (N % 256 == 0, D % 32 == 0,
// both 16-byte aligned) -> fine [Q, N/8] f32, coarse [Q, N/64] f32.
extern "C" int cocodr_dual_sweep_bf16(const void* queries, const void* corpus,
                                      void* fine, void* coarse, int Q, int N,
                                      int D, void* stream) {
  return launch<kMax>(queries, corpus, fine, coarse, Q, N, D, stream);
}

// As cocodr_dual_sweep_bf16, fine maxima with the packed 3-bit argmax.
extern "C" int cocodr_dual_sweep_packed_bf16(const void* queries,
                                             const void* corpus, void* fine,
                                             void* coarse, int Q, int N,
                                             int D, void* stream) {
  return launch<kPack>(queries, corpus, fine, coarse, Q, N, D, stream);
}

// queries [Q, D] bf16, corpus [N, D] bf16 (as above) -> maxima of every
// 32-row block [Q, N/32] f32.
extern "C" int cocodr_block32_sweep_bf16(const void* queries,
                                         const void* corpus, void* out, int Q,
                                         int N, int D, void* stream) {
  return launch<kBlock32>(queries, corpus, out, nullptr, Q, N, D, stream);
}
