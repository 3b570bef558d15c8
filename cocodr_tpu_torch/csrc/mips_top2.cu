// K9: top-2 certificate sweep. scores = queries . corpus^T from bf16
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
// Bound on the H100: the sweep of K2 with 2/9 of K2's output bytes:
// at Q = 64 it is bound by reading the corpus (~0.48 ms), at Q = 1024 by
// the tensor cores (~1.67 ms at 989 TFLOP/s). Design: K2's (mips_sweep.cu)
// on gemm_wgmma.cuh's bf16 loop, queries as A, 256 corpus rows as B, with
// its own epilogue: in wgmma's layout a thread holds, for each of its two
// rows, 16 values of each of the tile's four 64-row blocks (columns
// 8g + 2c and 8g + 2c + 1, g = 0..7, c = lane % 4). It runs a strict '>'
// chain over them in column order, keeping (best, second, arg) per block;
// two shuffle steps inside the quad (lane ^ 1, then lane ^ 2) each send
// half of the blocks' statistics to the partner, the args as 6 bits an
// entry, and merge the other half with the partner's. Lane c then holds
// block 2 (c & 1) + (c >> 1) of the tile, so the quad's four stores are
// contiguous. No score reaches shared or device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"
#include "sweep_epi.cuh"

namespace {

using sweep::pick;

constexpr int kBlocks = sweep::kTileRows / 64;  // 64-row blocks of a tile

// (b, s, a) <- the statistics of the union of two disjoint row sets: the
// greater max wins with its row, and on equal maxima the lower row wins
// (take_better); the second is the larger of the loser's max and the
// winner's second, which is the max itself when the maxima are equal.
__device__ __forceinline__ void merge(float& b, float& s, int& a, float ob,
                                      float os, int oa) {
  const bool gt = ob > b;
  s = pick(gt, fmaxf(b, os), fmaxf(s, ob));
  sweep::take_better(b, a, ob, oa);
}

// One step of the quad's scatter of S blocks' statistics, as
// sweep::scatter_step: of the S >> kStep entries a lane holds, send half
// to the partner (lane ^ (1 << kStep)) and merge the other half with the
// partner's; the args travel as 6 bits an entry in one word.
template <int kStep, int S>
__device__ __forceinline__ void scatter_top2_step(float (&b)[S],
                                                  float (&s)[S],
                                                  int (&a)[S]) {
  constexpr int kHalf = S >> (kStep + 1);  // entries kept after this step
  const bool upper = (threadIdx.x >> kStep) & 1;
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    bits |= static_cast<unsigned>(pick(upper, a[i], a[kHalf + i]))
            << (6 * i);
  }
  bits = __shfl_xor_sync(0xffffffffu, bits, 1 << kStep);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float ob = __shfl_xor_sync(
        0xffffffffu, pick(upper, b[i], b[kHalf + i]), 1 << kStep);
    const float os = __shfl_xor_sync(
        0xffffffffu, pick(upper, s[i], s[kHalf + i]), 1 << kStep);
    float kb = pick(upper, b[kHalf + i], b[i]);
    float ks = pick(upper, s[kHalf + i], s[i]);
    int ka = pick(upper, a[kHalf + i], a[i]);
    merge(kb, ks, ka, ob, os, static_cast<int>((bits >> (6 * i)) & 63));
    b[i] = kb;
    s[i] = ks;
    a[i] = ka;
  }
}

struct Top2Epi {
  float* best;
  float* pack;
  int N;
  __device__ void load_col(int, float*, int) const {}
  template <int BN>
  __device__ __forceinline__ void tile(const float (&d)[BN / 2], int row,
                                       int col, const float*, int M) const {
    static_assert(BN == sweep::kTileRows, "a sweep block holds 256 rows");
    const int c = threadIdx.x & 3;  // this lane's column pair in each group
    const int n0 = col - 2 * c;     // the block's first corpus row
    const float lowest = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = row + 8 * half;
      float b[kBlocks], s[kBlocks];
      int a[kBlocks];
#pragma unroll
      for (int blk = 0; blk < kBlocks; ++blk) {
        // column 8g + 2c + e of the block is d[4 (8 blk + g) + 2 half + e]
        float bb = d[32 * blk + 2 * half];
        float ss = lowest;
        int aa = 2 * c;
#pragma unroll
        for (int k = 1; k < 16; ++k) {
          const int g = k >> 1, e = k & 1;
          const float x = d[32 * blk + 4 * g + 2 * half + e];
          const bool gt = x > bb;
          ss = pick(gt, bb, fmaxf(ss, x));
          aa = pick(gt, 8 * g + 2 * c + e, aa);
          bb = pick(gt, x, bb);
        }
        b[blk] = bb;
        s[blk] = ss;
        a[blk] = aa;
      }
      scatter_top2_step<0>(b, s, a);
      scatter_top2_step<1>(b, s, a);
      if (q < M) {
        const size_t i = static_cast<size_t>(q) * (N / 64) + n0 / 64 +
                         2 * (c & 1) + (c >> 1);
        best[i] = b[0];
        pack[i] = __int_as_float((__float_as_int(s[0]) & ~63) | a[0]);
      }
    }
  }
};

}  // namespace

// queries [Q, D] bf16, corpus [N, D] bf16 (N % 256 == 0, D % 32 == 0,
// both 16-byte aligned) -> best [Q, N/64] f32, pack [Q, N/64] f32.
extern "C" int cocodr_top2_sweep_bf16(const void* queries, const void* corpus,
                                      void* best, void* pack, int Q, int N,
                                      int D, void* stream) {
  if (Q <= 0 || N <= 0 || N % sweep::kTileRows || D <= 0 || D % 32) {
    return cudaErrorInvalidValue;
  }
  return wg::gemm<wg::Bf16, sweep::kTileRows>(
      queries, corpus, Q, N, D,
      Top2Epi{static_cast<float*>(best), static_cast<float*>(pack), N},
      static_cast<cudaStream_t>(stream), /*m_fastest=*/true);
}
