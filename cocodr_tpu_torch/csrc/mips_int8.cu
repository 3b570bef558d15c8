// K6: int8 dual block-max sweep. scores = corpus . queries^T from int8
// inputs with exact int32 accumulation, reduced in the block to packed
// maxima of every 8-row (fine) and 64-row (coarse) corpus block:
//   fine [Q, N/8] i32: (max << 3) | arg, arg the first-occurrence argmax
//     row (0..7) of the fine block;
//   coarse [Q, N/64] i32: the max of its 8 packed fine values.
// |score| <= D * 127^2 < 2^28 for D <= 16,384, so the shift cannot
// overflow and the packing is strictly monotone in the max.
//
// Replaces cocodr_tpu/ops/pallas_mips.py::_sweep_kernel_i8 (called
// through _int8_sweep, fine=8, coarse=8), the sweep of mips_topk_int8.
// Integer sums are exact in any order, so both outputs equal the TPU
// kernel's bit for bit; the TPU layouts (3D super rows, corpus-major
// coarse) are written query-major here, as K2's are.
//
// Bound on the H100: at Q = 64, N = 1,048,576, D = 768 the sweep reads
// 768 MiB of int8 corpus (~0.24 ms at 3.35 TB/s) for 103 G integer
// operations, 128 per byte, below the ~590 where the int8 tensor cores
// become the limit: it is bound by bytes. At Q = 1024 it is bound by
// operations. Design: K2's block and warp layout (sweep.cuh) over
// gemm_nt.cuh's int8 ring (64 columns a stage) and WMMA s8 x s8 -> s32
// fragments.
#include <cuda_runtime.h>

#include <climits>

#include "sweep.cuh"

namespace {

using sweep::kFine;
using sweep::kQueries;
using sweep::kRows;
using Tile = sweep::TileI8;

constexpr int kMaxDepth = 16384;  // keeps D * 127^2 << 3 inside int32

__global__ void __launch_bounds__(gemm::kThreads, 2)
int8_sweep_kernel(const signed char* __restrict__ q,
                  const signed char* __restrict__ c, int* __restrict__ fine,
                  int* __restrict__ coarse, int Q, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n0, q0;
  sweep::tile_origin(Q, n0, q0);
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kRows, kQueries>(acc, reinterpret_cast<signed char*>(smem),
                                  c, q, n0, q0, N, Q, D);

  const int wm = warp >> 2;
  const int wn = warp & 3;
  int* scr = reinterpret_cast<int*>(smem) + warp * 16 * gemm::kScrLd;
  const int qq = lane & 15;
  const int fb = lane >> 4;
  const int qi = q0 + wn * Tile::kWN + qq;
  const bool live = qi < Q;
  const size_t n_fine = N / kFine;
  const size_t n_coarse = N / 64;
  int cm = 0;
#pragma unroll
  for (int i = 0; i < Tile::kFM; ++i) {
    nvcuda::wmma::store_matrix_sync(scr, acc[i][0], gemm::kScrLd,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    const sweep::Stats<int> st = sweep::fine_stats(scr, fb, qq, INT_MIN);
    __syncwarp();
    const int row = n0 + wm * Tile::kWM + i * 16 + fb * kFine;
    const int m = static_cast<int>(static_cast<unsigned>(st.best) << 3) | st.arg;
    if (live) fine[qi * n_fine + row / kFine] = m;
    cm = (i % 4 == 0) ? m : max(cm, m);
    if (i % 4 == 3) {
      cm = max(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
      if (fb == 0 && live) coarse[qi * n_coarse + row / 64] = cm;
    }
  }
}

}  // namespace

// queries [Q, D] int8, corpus [N, D] int8 (N % 256 == 0, D % 64 == 0,
// D <= 16384, both 16-byte aligned) -> fine [Q, N/8] i32, coarse
// [Q, N/64] i32.
extern "C" int cocodr_int8_sweep(const void* queries, const void* corpus,
                                 void* fine, void* coarse, int Q, int N,
                                 int D, void* stream) {
  if (!sweep::shapes_ok(Q, N, D, gemm::Operand<signed char>::kBK) ||
      D > kMaxDepth) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = Tile::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      int8_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int8_sweep_kernel<<<sweep::grid_blocks(Q, N), gemm::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(queries),
      static_cast<const signed char*>(corpus), static_cast<int*>(fine),
      static_cast<int*>(coarse), Q, N, D);
  return cudaGetLastError();
}
