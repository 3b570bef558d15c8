// Tiled bf16 GEMM main loop shared by the port's kernels:
//   C[m0:m0+BM, n0:n0+BN] = A[m0:m0+BM, :] . B[n0:n0+BN, :]^T
// with A [M, K] and B [N, K] row-major (K contiguous, the nn.Linear weight
// layout), float32 accumulators in WMMA 16x16x16 fragments.
//
// 8 warps tile the block 2 (along M) x 4 (along N). Stages of kBK = 32
// columns of A and B stream through a kStages-deep ring in shared memory by
// cp.async, so the loads of the next stages overlap the products of the
// current one. Rows of A at or past M and rows of B at or past N are
// zero-filled (the caller masks their outputs); K must be a multiple of
// kBK.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gemm {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;  // bf16 stride of a stage row: 80 bytes
constexpr int kStages = 3;
constexpr int kScrLd = 20;    // float stride of a warp's 16x16 scratch

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN>
struct Tile {
  static constexpr int kWM = BM / 2;  // rows of a warp's tile
  static constexpr int kWN = BN / 4;  // columns of a warp's tile
  static constexpr int kFM = kWM / 16;
  static constexpr int kFN = kWN / 16;
  static constexpr int kStageElems = (BM + BN) * kLd;
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * kStageElems * kStages;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  static_assert(kFM >= 1 && kFN >= 1 && BM % 32 == 0 && BN % 64 == 0,
                "tile too small for 2 x 4 warps of 16x16 fragments");
};

template <int BM, int BN>
__device__ __forceinline__ void load_stage(__nv_bfloat16* st,
                                           const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int m0,
                                           int n0, int M, int N, int K,
                                           int k0) {
  constexpr int kVec = kBK / 8;  // 16-byte vectors per stage row
  __nv_bfloat16* as = st;
  __nv_bfloat16* bs = st + BM * kLd;
  for (int t = threadIdx.x; t < BM * kVec; t += kThreads) {
    const int r = t / kVec;
    const int c = (t % kVec) * 8;
    const bool ok = m0 + r < M;
    cp_async16(&as[r * kLd + c],
               A + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + c, ok);
  }
  for (int t = threadIdx.x; t < BN * kVec; t += kThreads) {
    const int r = t / kVec;
    const int c = (t % kVec) * 8;
    const bool ok = n0 + r < N;
    cp_async16(&bs[r * kLd + c],
               B + static_cast<size_t>(ok ? n0 + r : 0) * K + k0 + c, ok);
  }
}

// acc (this warp's kFM x kFN fragments) = the block's tile of A . B^T.
// smem: Tile<BM, BN>::kSmemBytes, 128-byte aligned. Ends with a barrier,
// after which the caller may reuse smem.
template <int BM, int BN>
__device__ __forceinline__ void mainloop(
    typename Tile<BM, BN>::Acc (&acc)[Tile<BM, BN>::kFM][Tile<BM, BN>::kFN],
    __nv_bfloat16* smem, const __nv_bfloat16* A, const __nv_bfloat16* B,
    int m0, int n0, int M, int N, int K) {
  using T = Tile<BM, BN>;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / kBK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      load_stage<BM, BN>(smem + s * T::kStageElems, A, B, m0, n0, M, N, K,
                         s * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();               // ... every thread's part; stage kt-1 free
    const int next = kt + kStages - 1;
    if (next < KT) {
      load_stage<BM, BN>(smem + (next % kStages) * T::kStageElems, A, B, m0,
                         n0, M, N, K, next * kBK);
    }
    cp_async_commit();
    const __nv_bfloat16* as = smem + (kt % kStages) * T::kStageElems;
    const __nv_bfloat16* bs = as + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // all B fragments, then one A fragment at a time: only one A
      // fragment is live, which keeps the register count low enough for
      // two blocks per SM
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b[T::kFN];
#pragma unroll
      for (int j = 0; j < T::kFN; ++j) {
        wmma::load_matrix_sync(b[j], &bs[(wn * T::kWN + j * 16) * kLd + kk],
                               kLd);
      }
#pragma unroll
      for (int i = 0; i < T::kFM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, &as[(wm * T::kWM + i * 16) * kLd + kk],
                               kLd);
#pragma unroll
        for (int j = 0; j < T::kFN; ++j)
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Hands each lane 8 consecutive accumulator values of one row of each of
// the warp's fragments: epi(row, col, v[8]) with (row, col) the global
// coordinates of v[0]. Uses kThreads / 32 * 16 * kScrLd floats of smem.
template <int BM, int BN, class Epi>
__device__ __forceinline__ void epilogue(
    typename Tile<BM, BN>::Acc (&acc)[Tile<BM, BN>::kFM][Tile<BM, BN>::kFN],
    void* smem, int m0, int n0, Epi epi) {
  using T = Tile<BM, BN>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  float* scr = static_cast<float*>(smem) + warp * 16 * kScrLd;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], kScrLd, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = scr[er * kScrLd + ec + e];
      __syncwarp();
      epi(m0 + wm * T::kWM + i * 16 + er, n0 + wn * T::kWN + j * 16 + ec, v);
    }
  }
}

}  // namespace gemm
