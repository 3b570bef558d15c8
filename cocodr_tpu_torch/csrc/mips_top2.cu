// K9: top-2 certificate sweep. scores = corpus . queries^T from bf16
// inputs with float32 accumulation, reduced per 64-row block to
//   best [Q, N/64] f32: the block's exact max score;
//   pack [Q, N/64] f32: the block's second-best score (the second element
//     of the multiset, equal to the max when the max occurs twice) with
//     the first-occurrence argmax row (0..63) in its 6 low bits,
//     (bits & ~63) | arg, negative values too.
//
// Replaces cocodr_tpu/ops/pallas_mips.py::_sweep_kernel_top2 (called
// through _top2_sweep, cb=64), the sweep of mips_topk_exact2. The TPU
// kernel writes both arrays corpus-major [N/64, Q] and its caller
// transposes them; here they are written query-major. The TPU kernel
// merges fine groups in row order; the merge here runs in another order
// but gives the same three statistics (the max, the lowest row holding
// it, the multiset's second), since it breaks ties between equal maxima
// by the lower row. Float sums run in another order than XLA's, so values
// agree to float32 rounding and the argmax may differ where two rows of a
// block score within a few ULP of each other.
//
// Bound on the H100: the sweep of K2 with half K2's output bytes at
// Q = 64 (bound by reading the corpus) and the same operations at
// Q = 1024 (bound by the tensor cores). Design: K2's main loop and warp
// layout (sweep.cuh). Each lane keeps (best, second, arg) of its fine
// blocks over the four fragments of a 64-row block, and one shuffle
// merges the two lanes of a query.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using sweep::kFine;
using sweep::kQueries;
using sweep::kRows;
using Tile = sweep::TileBf16;

// (b, s, a) <- the statistics of the union of two disjoint row sets
__device__ __forceinline__ void merge(float& b, float& s, int& a, float ob,
                                     float os, int oa) {
  if (ob > b) {
    s = fmaxf(b, os);
    b = ob;
    a = oa;
  } else if (ob < b) {
    s = fmaxf(s, ob);
  } else {  // equal maxima: the max occurs twice, the lower row wins
    s = b;
    a = min(a, oa);
  }
}

__global__ void __launch_bounds__(gemm::kThreads, 2)
top2_sweep_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ c,
                  float* __restrict__ best, float* __restrict__ pack, int Q,
                  int N, int D) {
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
  const size_t n_cb = N / 64;
  const float lowest = -__int_as_float(0x7f800000);  // -inf
  float b = 0.0f, s = 0.0f;
  int a = 0;
#pragma unroll
  for (int i = 0; i < Tile::kFM; ++i) {
    nvcuda::wmma::store_matrix_sync(scr, acc[i][0], gemm::kScrLd,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    const sweep::Stats<float> st = sweep::fine_stats(scr, fb, qq, lowest);
    __syncwarp();
    // row of the argmax inside its 64-row block
    const int arg = (i % 4) * 16 + fb * kFine + st.arg;
    if (i % 4 == 0) {
      b = st.best;
      s = st.second;
      a = arg;
    } else {
      merge(b, s, a, st.best, st.second, arg);
    }
    if (i % 4 == 3) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, 16);
      const float os = __shfl_xor_sync(0xffffffffu, s, 16);
      const int oa = __shfl_xor_sync(0xffffffffu, a, 16);
      merge(b, s, a, ob, os, oa);
      if (fb == 0 && qi < Q) {
        const size_t blk = (n0 + wm * Tile::kWM + (i - 3) * 16) / 64;
        best[qi * n_cb + blk] = b;
        pack[qi * n_cb + blk] = __int_as_float((__float_as_int(s) & ~63) | a);
      }
    }
  }
}

}  // namespace

// queries [Q, D] bf16, corpus [N, D] bf16 (N % 256 == 0, D % 32 == 0,
// both 16-byte aligned) -> best [Q, N/64] f32, pack [Q, N/64] f32.
extern "C" int cocodr_top2_sweep_bf16(const void* queries, const void* corpus,
                                      void* best, void* pack, int Q, int N,
                                      int D, void* stream) {
  if (!sweep::shapes_ok(Q, N, D, gemm::kBK)) return cudaErrorInvalidValue;
  constexpr size_t smem = Tile::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      top2_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  top2_sweep_kernel<<<sweep::grid_blocks(Q, N), gemm::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const __nv_bfloat16*>(corpus), static_cast<float*>(best),
      static_cast<float*>(pack), Q, N, D);
  return cudaGetLastError();
}
