// K2: dual block-max sweep, and K10: block-32 max sweep. scores =
// queries . corpus^T from bf16 inputs with float32 accumulation, reduced
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
// operations per byte and the tensor cores bound it (~1.67 ms at
// 989 TFLOP/s). Design: the scores are gemm_wgmma.cuh's bf16 GEMM with the
// queries as A (128 a block, 64 a consumer warpgroup) and 256 corpus rows
// as B, both K-major, fed by TMA, float32 accumulators in registers; the
// grid runs the query tiles fastest, so that the blocks of one corpus tile
// run side by side and share its reads through L2. The epilogue
// (sweep_epi.cuh, shared with K6) reduces each row's 8-row blocks in
// registers and inside a quad; no score reaches shared or device memory.
// A k tail past D reads as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"
#include "sweep_epi.cuh"

namespace {

using sweep::kBlock32;
using sweep::kMax;
using sweep::kPack;
using sweep::kTileRows;

template <int kMode>
int launch(const void* queries, const void* corpus, void* out0, void* out1,
           int Q, int N, int D, void* stream) {
  if (Q <= 0 || N <= 0 || N % kTileRows || D <= 0 || D % 32) {
    return cudaErrorInvalidValue;
  }
  return wg::gemm<wg::Bf16, kTileRows>(
      queries, corpus, Q, N, D,
      sweep::SweepEpi<kMode, float>{static_cast<float*>(out0),
                                    static_cast<float*>(out1), N},
      static_cast<cudaStream_t>(stream), /*m_fastest=*/true);
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
