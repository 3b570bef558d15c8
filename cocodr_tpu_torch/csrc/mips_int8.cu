// K6: int8 dual block-max sweep. scores = queries . corpus^T from int8
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
// operations (~0.83 ms at 1,979 TOP/s). Design: K2's, on the int8 form of
// gemm_wgmma.cuh's main loop (wgmma m64n256k32 s32.s8.s8, 128 columns a
// k-stage, int32 accumulators in registers) with K2-packed's epilogue on
// integers (sweep_epi.cuh): a thread's column pair reduced with its
// argmax, the quad's two shuffle steps with the argmaxes sent as bits,
// the integer pack, the coarse max of the 8 packed values. A D that ends
// inside a k-stage reads zeros past it, which add nothing.
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"
#include "sweep_epi.cuh"

namespace {

constexpr int kMaxDepth = 16384;  // keeps D * 127^2 << 3 inside int32

}  // namespace

// queries [Q, D] int8, corpus [N, D] int8 (N % 256 == 0, D % 64 == 0,
// D <= 16384, both 16-byte aligned) -> fine [Q, N/8] i32, coarse
// [Q, N/64] i32.
extern "C" int cocodr_int8_sweep(const void* queries, const void* corpus,
                                 void* fine, void* coarse, int Q, int N,
                                 int D, void* stream) {
  if (Q <= 0 || N <= 0 || N % sweep::kTileRows || D <= 0 || D % 64 ||
      D > kMaxDepth) {
    return cudaErrorInvalidValue;
  }
  return wg::gemm<wg::S8, sweep::kTileRows>(
      queries, corpus, Q, N, D,
      sweep::SweepEpi<sweep::kPack, int>{static_cast<int*>(fine),
                                         static_cast<int*>(coarse), N},
      static_cast<cudaStream_t>(stream), /*m_fastest=*/true);
}
