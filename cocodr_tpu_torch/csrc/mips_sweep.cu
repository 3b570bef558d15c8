// K2: dual block-max sweep. scores = corpus . queries^T from bf16 inputs
// with float32 accumulation, reduced in the block to the maxima of every
// 8-row (fine) and 64-row (coarse) corpus block; only the maxima leave.
//
// Replaces cocodr_tpu/ops/pallas_mips.py::_sweep_kernel2 (called through
// _dual_sweep_mixed, pack=False, fine=8, coarse=8). The port's layout is
// query-major for both outputs: fine [Q, N/8] and coarse [Q, N/64], the
// layout that the port's block selection gathers from (the TPU kernel's
// 3D super-rows layout and corpus-major coarse maxima were Mosaic tiling
// workarounds). A coarse maximum is the max of its 8 fine maxima, as on
// the TPU. Float sums run in another order than XLA's, so maxima agree to
// float32 rounding, not bit for bit.
//
// Bound on the H100: at the serving shape (Q = 64, N = 1,048,576,
// D = 768) the sweep does 2*Q*N*D = 103 GFLOP against 1.5 GiB of corpus,
// 64 operations per byte, far below the ~295 where bf16 tensor cores
// become the limit: it is bound by reading the corpus (~0.48 ms at
// 3.35 TB/s). Design: each block streams its 256 corpus rows once, for a
// tile of up to 64 queries, through the cp.async ring of gemm_nt.cuh (the
// corpus tile is the GEMM's A, the queries its B) and multiplies on the
// tensor cores; each warp owns whole 64-row coarse blocks, so both
// reductions finish inside the warp and the [N, Q] score matrix never
// reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_nt.cuh"

namespace {

constexpr int kRows = 256;     // corpus rows per block
constexpr int kQueries = 64;   // queries per block
constexpr int kFine = 8;
constexpr int kCoarse = 64;    // rows of a coarse block
using Tile = gemm::Tile<kRows, kQueries>;  // warp tile: 128 rows x 16 queries

// two blocks per SM: the sweep streams the corpus and needs the loads of
// both in flight to approach the memory rate
__global__ void __launch_bounds__(gemm::kThreads, 2)
dual_sweep_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ c,
                  float* __restrict__ fine, float* __restrict__ coarse,
                  int Q, int N, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kRows;
  const int q0 = blockIdx.y * kQueries;
  Tile::Acc acc[Tile::kFM][Tile::kFN];
  gemm::mainloop<kRows, kQueries>(acc, reinterpret_cast<__nv_bfloat16*>(smem),
                                  c, q, n0, q0, N, Q, D);

  // Epilogue: each warp has a 16x16 float scratch in the freed ring. Lane l
  // reduces fine block (l >> 4) of a fragment's 16 rows for query column
  // (l & 15); every 4 fragments (64 rows) the two lanes of a query combine
  // their running maxima into a coarse maximum.
  const int wm = warp >> 2;
  const int wn = warp & 3;
  float* scr = reinterpret_cast<float*>(smem) + warp * 16 * gemm::kScrLd;
  const int qq = lane & 15;
  const int fb = lane >> 4;
  const int qi = q0 + wn * Tile::kWN + qq;
  const size_t n_fine = N / kFine;
  const size_t n_coarse = N / kCoarse;
  float cm = 0.0f;
#pragma unroll
  for (int i = 0; i < Tile::kFM; ++i) {
    nvcuda::wmma::store_matrix_sync(scr, acc[i][0], gemm::kScrLd,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    float m = scr[(fb * 8) * gemm::kScrLd + qq];
#pragma unroll
    for (int r = 1; r < kFine; ++r) m = fmaxf(m, scr[(fb * 8 + r) * gemm::kScrLd + qq]);
    __syncwarp();
    const int row = n0 + wm * Tile::kWM + i * 16 + fb * 8;
    if (qi < Q) fine[qi * n_fine + row / kFine] = m;
    cm = (i % 4 == 0) ? m : fmaxf(cm, m);
    if (i % 4 == 3) {
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
      if (fb == 0 && qi < Q) coarse[qi * n_coarse + row / kCoarse] = cm;
    }
  }
}

}  // namespace

// queries [Q, D] bf16, corpus [N, D] bf16 (N % 256 == 0, D % 32 == 0,
// both 16-byte aligned) -> fine [Q, N/8] f32, coarse [Q, N/64] f32.
extern "C" int cocodr_dual_sweep_bf16(const void* queries, const void* corpus,
                                      void* fine, void* coarse, int Q, int N,
                                      int D, void* stream) {
  if (Q <= 0 || N <= 0 || N % kRows || D <= 0 || D % gemm::kBK ||
      (Q + kQueries - 1) / kQueries > 65535) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = Tile::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      dual_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(N / kRows, (Q + kQueries - 1) / kQueries);
  dual_sweep_kernel<<<grid, gemm::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const __nv_bfloat16*>(corpus), static_cast<float*>(fine),
      static_cast<float*>(coarse), Q, N, D);
  return cudaGetLastError();
}
