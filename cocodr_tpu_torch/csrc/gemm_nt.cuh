// Tiled GEMM main loop of the block-max sweeps K6 (mips_int8.cu, int8) and
// K9 (mips_top2.cu, bf16); the FFN kernels and the sweeps K2 and K10 run
// on gemm_wgmma.cuh:
//   C[m0:m0+BM, n0:n0+BN] = A[m0:m0+BM, :] . B[n0:n0+BN, :]^T
// with A [M, K] and B [N, K] row-major (K contiguous, the nn.Linear weight
// layout), in WMMA 16x16x16 fragments: bf16 operands with float32
// accumulators, or int8 operands with int32 accumulators.
//
// 8 warps tile the block 2 (along M) x 4 (along N). Stages of 64 bytes of
// every row of A and B (kBK = 32 bf16 or 64 int8 columns) stream through a
// kStages-deep ring in shared memory by cp.async, so the loads of the next
// stages overlap the products of the current one. Rows of A at or past M
// and rows of B at or past N are zero-filled (the caller masks their
// outputs); K must be a multiple of the operand's kBK.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gemm {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kScrLd = 20;    // 4-byte stride of a warp's 16x16 scratch

// Operand traits: accumulator type, stage depth kBK and the stage layout.
// bf16 stages keep each row's 32 columns together, rows padded to 80 bytes
// to spread the banks (ldm 40). WMMA wants each int8 fragment pointer
// 32-byte aligned, which a 16-column step inside a row is not, so int8
// stages are k-slice-major: [kBK / 16][rows][16], each fragment one
// contiguous 256-byte run (ldm 16).
template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kBK = 32;
  static constexpr int kLdm = kBK + 8;
  static constexpr int kRowElems = kLdm;  // elements a stage row takes
  __device__ static int at(int /*rows*/, int r, int c) { return r * kLdm + c; }
};

template <>
struct Operand<signed char> {
  using Acc = int;
  static constexpr int kBK = 64;
  static constexpr int kLdm = 16;
  static constexpr int kRowElems = kBK;
  __device__ static int at(int rows, int r, int c) {
    return (c >> 4) * rows * 16 + r * 16 + (c & 15);
  }
};

constexpr int kBK = Operand<__nv_bfloat16>::kBK;

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

template <int BM, int BN, typename T = __nv_bfloat16>
struct Tile {
  static constexpr int kWM = BM / 2;  // rows of a warp's tile
  static constexpr int kWN = BN / 4;  // columns of a warp's tile
  static constexpr int kFM = kWM / 16;
  static constexpr int kFN = kWN / 16;
  static constexpr int kStageElems = (BM + BN) * Operand<T>::kRowElems;
  static constexpr size_t kSmemBytes = sizeof(T) * kStageElems * kStages;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16,
                             typename Operand<T>::Acc>;
  static_assert(kFM >= 1 && kFN >= 1 && BM % 32 == 0 && BN % 64 == 0,
                "tile too small for 2 x 4 warps of 16x16 fragments");
};

template <int BM, int BN, typename T>
__device__ __forceinline__ void load_stage(T* st, const T* A, const T* B,
                                           int m0, int n0, int M, int N,
                                           int K, int k0) {
  using Op = Operand<T>;
  constexpr int kPerVec = 16 / sizeof(T);        // elements per 16 bytes
  constexpr int kVec = Op::kBK / kPerVec;        // 16-byte vectors a row
  T* as = st;
  T* bs = st + BM * Op::kRowElems;
  for (int t = threadIdx.x; t < BM * kVec; t += kThreads) {
    const int r = t / kVec;
    const int c = (t % kVec) * kPerVec;
    const bool ok = m0 + r < M;
    cp_async16(&as[Op::at(BM, r, c)],
               A + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + c, ok);
  }
  for (int t = threadIdx.x; t < BN * kVec; t += kThreads) {
    const int r = t / kVec;
    const int c = (t % kVec) * kPerVec;
    const bool ok = n0 + r < N;
    cp_async16(&bs[Op::at(BN, r, c)],
               B + static_cast<size_t>(ok ? n0 + r : 0) * K + k0 + c, ok);
  }
}

// acc (this warp's kFM x kFN fragments) = the block's tile of A . B^T.
// smem: Tile<BM, BN>::kSmemBytes, 128-byte aligned. Ends with a barrier,
// after which the caller may reuse smem.
template <int BM, int BN, typename E = __nv_bfloat16>
__device__ __forceinline__ void mainloop(
    typename Tile<BM, BN, E>::Acc (&acc)[Tile<BM, BN, E>::kFM]
                                        [Tile<BM, BN, E>::kFN],
    E* smem, const E* A, const E* B, int m0, int n0, int M, int N, int K) {
  using T = Tile<BM, BN, E>;
  using Op = Operand<E>;
  using AccT = typename Op::Acc;
  constexpr int kBKE = Op::kBK;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) wmma::fill_fragment(acc[i][j], AccT(0));

  const int KT = K / kBKE;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      load_stage<BM, BN, E>(smem + s * T::kStageElems, A, B, m0, n0, M, N, K,
                            s * kBKE);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();               // ... every thread's part; stage kt-1 free
    const int next = kt + kStages - 1;
    if (next < KT) {
      load_stage<BM, BN, E>(smem + (next % kStages) * T::kStageElems, A, B,
                            m0, n0, M, N, K, next * kBKE);
    }
    cp_async_commit();
    const E* as = smem + (kt % kStages) * T::kStageElems;
    const E* bs = as + BM * Op::kRowElems;
#pragma unroll
    for (int kk = 0; kk < kBKE; kk += 16) {
      // all B fragments, then one A fragment at a time: only one A
      // fragment is live, which keeps the register count low enough for
      // two blocks per SM
      wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::col_major> b[T::kFN];
#pragma unroll
      for (int j = 0; j < T::kFN; ++j) {
        wmma::load_matrix_sync(b[j], &bs[Op::at(BN, wn * T::kWN + j * 16, kk)],
                               Op::kLdm);
      }
#pragma unroll
      for (int i = 0; i < T::kFM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, E, wmma::row_major> a;
        wmma::load_matrix_sync(a, &as[Op::at(BM, wm * T::kWM + i * 16, kk)],
                               Op::kLdm);
#pragma unroll
        for (int j = 0; j < T::kFN; ++j)
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Hands each lane 8 consecutive accumulator values (float for bf16 tiles,
// int for int8 tiles) of one row of each of the warp's fragments:
// epi(row, col, v[8]) with (row, col) the global coordinates of v[0]. Every
// lane of the warp calls epi for every fragment, so epi may use warp
// shuffles. Uses kThreads / 32 * 16 * kScrLd 4-byte words of smem.
template <int BM, int BN, typename E = __nv_bfloat16, class Epi>
__device__ __forceinline__ void epilogue(
    typename Tile<BM, BN, E>::Acc (&acc)[Tile<BM, BN, E>::kFM]
                                        [Tile<BM, BN, E>::kFN],
    void* smem, int m0, int n0, Epi epi) {
  using T = Tile<BM, BN, E>;
  using AccT = typename Operand<E>::Acc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  AccT* scr = static_cast<AccT*>(smem) + warp * 16 * kScrLd;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], kScrLd, wmma::mem_row_major);
      __syncwarp();
      AccT v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = scr[er * kScrLd + ec + e];
      __syncwarp();
      epi(m0 + wm * T::kWM + i * 16 + er, n0 + wn * T::kWN + j * 16 + ec, v);
    }
  }
}

}  // namespace gemm
