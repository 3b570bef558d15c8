// What the WMMA block-max sweeps (K6, K9) share: the block shape, the grid
// order, and the per-lane statistics of one 8-row fine block. (K2 and K10
// run on gemm_wgmma.cuh: mips_sweep.cu.)
//
// Every sweep block multiplies 256 corpus rows by up to 64 queries through
// gemm::mainloop (the corpus tile is the GEMM's A, the queries its B).
// Warp (wm, wn) holds rows wm*128 .. wm*128+127 of the tile against
// queries wn*16 .. wn*16+15 as 8 fragments of 16 rows. The epilogue stores
// one fragment at a time into the warp's 16x16 scratch; lane l then owns
// query column (l & 15) and fine block (l >> 4) of the fragment (its rows
// 0-7 or 8-15). Four fragments make a 64-row coarse block, so every
// reduction a sweep needs finishes inside one warp.
#pragma once

#include <cuda_runtime.h>

#include "gemm_nt.cuh"

namespace sweep {

constexpr int kRows = 256;     // corpus rows per block
constexpr int kQueries = 64;   // queries per block
constexpr int kFine = 8;       // rows of a fine block
using TileBf16 = gemm::Tile<kRows, kQueries>;
using TileI8 = gemm::Tile<kRows, kQueries, signed char>;

// One-dimensional grid with the query tiles fastest, so that the blocks
// of one corpus tile run side by side and can share its reads through L2.
// With one query tile it is the corpus-major order; with more, the two
// orders have not been timed against each other.
inline int grid_blocks(int Q, int N) {
  const long long blocks =
      static_cast<long long>((Q + kQueries - 1) / kQueries) * (N / kRows);
  return blocks > 0x7fffffffLL ? -1 : static_cast<int>(blocks);
}

__device__ __forceinline__ void tile_origin(int Q, int& n0, int& q0) {
  const int nq = (Q + kQueries - 1) / kQueries;
  n0 = (blockIdx.x / nq) * kRows;
  q0 = (blockIdx.x % nq) * kQueries;
}

// Shapes every sweep entry point takes: N a multiple of kRows, D of the
// operand's stage depth.
inline bool shapes_ok(int Q, int N, int D, int depth) {
  return Q > 0 && N > 0 && N % kRows == 0 && D > 0 && D % depth == 0 &&
         grid_blocks(Q, N) > 0;
}

// Max, first-occurrence argmax (strict '>', as the TPU kernels' select
// chains) and second-best (the second element of the multiset: equal to
// the max when the max occurs twice) of the 8 rows of fine block fb in
// column qq of a warp's scratch.
template <typename V>
struct Stats {
  V best;
  V second;
  int arg;
};

template <typename V>
__device__ __forceinline__ Stats<V> fine_stats(const V* scr, int fb, int qq,
                                               V lowest) {
  const V* col = scr + fb * kFine * gemm::kScrLd + qq;
  Stats<V> s{col[0], lowest, 0};
#pragma unroll
  for (int r = 1; r < kFine; ++r) {
    const V v = col[r * gemm::kScrLd];
    if (v > s.best) {
      s.second = s.best;
      s.best = v;
      s.arg = r;
    } else {
      s.second = v > s.second ? v : s.second;
    }
  }
  return s;
}

}  // namespace sweep
