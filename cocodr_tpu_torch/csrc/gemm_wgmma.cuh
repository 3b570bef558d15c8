// GEMM main loop on Hopper's warpgroup MMA, fed by TMA:
//   C[m0:m0+128, n0:n0+BN] = A[m0:m0+128, :] . B[n0:n0+BN, :]^T
// with A [M, K] and B [N, K] row-major (K contiguous, the nn.Linear weight
// layout: both operands are K-major, so wgmma needs no transpose, and 8-bit
// operands take no other layout), in one of two operand types: bf16 with
// float32 accumulators (Bf16) or int8 with exact int32 accumulators (S8),
// kept in registers; the caller's epilogue works straight on the
// accumulator layout. Used by the FFN kernels K1, K4, K5 (ffn_block.cu,
// bf16) and K7 (ffn_block_int8.cu, int8) and by the block-max sweeps: K2
// and K10 (mips_sweep.cu) and K9 (mips_top2.cu) in bf16, K6 (mips_int8.cu)
// in int8.
//
// A block is three warpgroups. The last is the producer: one thread issues
// TMA loads of k-stages of 128 bytes a row (64 bf16 or 128 int8 columns,
// 128-byte swizzle) of A and B into a ring of kStages stages in shared
// memory, each guarded by a full and an empty mbarrier. The first two are
// consumers, 64 rows of A each: they wait on a stage's full barrier, run
// four wgmma on it (m64nBNk16 in bf16, m64nBNk32 in int8: 32 bytes of K
// each), keep one group of products in flight, and release the stage
// before to the producer. `setmaxnreg` moves the producer's registers to
// the consumers, whose BN / 2 accumulators a thread stay in registers
// through the epilogue. Rows of A at or past M and columns at or past K
// come back from TMA as zeros; the epilogue skips the outputs of such rows.
// A row of A or B must be a multiple of 16 bytes (TMA's stride), N a
// multiple of BN.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (the library links no libcuda), and kept
// in a small cache keyed on everything a map encodes (element type,
// address, dims, box; the stride and swizzle follow from them), so a
// weight's map is encoded once per process.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace wg {

constexpr int kBM = 128;                   // rows of A per block
constexpr int kRowBytes = 128;             // k-stage: 128 bytes of a row
constexpr int kConsumers = 2;              // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemBudget = 200 * 1024;    // ring of stages
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

constexpr int kMaxColParams = 4;  // float32 values an epilogue needs a column

// The operand types: accumulator, element size, the tensor map's type
struct Bf16 {
  using Acc = float;
  static constexpr int kElemBytes = 2;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

struct S8 {
  using Acc = int;
  static constexpr int kElemBytes = 1;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

template <int BN>
struct Cfg {
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  static constexpr int kStages = kSmemBudget / kStageBytes;  // 4, 5 or 6
  static constexpr int kColBytes = kMaxColParams * BN * 4;
  // the ring, 1 KB to align it to the swizzle's 1,024-byte atom, the
  // epilogue's column parameters, barriers
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 1024 + kColBytes + 16 * kStages;
  static_assert(BN % 64 == 0 && BN <= 256 && kStages >= 4, "tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// box of the 2-D map at (column c0, row c1) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// 8-row groups 1,024 bytes apart (SBO); LBO is unused for this layout.
// Adding 2 steps 32 bytes along K (16 bf16 or 32 int8 columns).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void keep_in_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep_in_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] += A[64 x 32 bytes] . B[N x 32 bytes]^T, both from shared
// memory: bf16 (16 columns) with float32 sums, or int8 (32 columns) with
// int32 sums. Integer wgmma takes no scale or transpose operands.
template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <int N>
__device__ __forceinline__ void mma_s8(int (&d)[N / 2], uint64_t da,
                                       uint64_t db);

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16<192>(float (&d)[96], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16<256>(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_s8<128>(int (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_s8<192>(int (&d)[96], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_s8<256>(int (&d)[128], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  mma_bf16<N>(d, da, db);
}

template <int N>
__device__ __forceinline__ void mma(int (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  mma_s8<N>(d, da, db);
}

// The epilogue. Before the main loop the consumers stage each column's
// parameters in shared memory: epi.load_col(c, p, BN) writes the (at most
// kMaxColParams) float32 parameters of output column c to p[0], p[BN], ...
// After it every consumer thread, rows past M too, calls
// epi.tile<BN>(d, row, col, p, M) once with its accumulators in wgmma's
// layout: the thread holds rows `row` and `row + 8`, and d[4j..4j+3] are
// columns col + 8j and col + 8j + 1 of the first row, then of the second,
// for j < BN / 8; p points at the staged parameters of column col. The
// four lanes of a quad (lane / 4 equal) hold the same two rows and the
// columns 2 (lane % 4) + 8j, so an epilogue may reduce a row by shuffles
// within the quad. Parameters read from device memory inside the unrolled
// epilogue made the FFN's up GEMM markedly slower on the H100: each load's
// latency was paid in turn, between the epilogue's stores.
template <class Op, int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, int M, int K,
            int n_tiles, int m_fastest, Epi epi) {
  using C = Cfg<BN>;
  using Acc = typename Op::Acc;
  constexpr int kBK = kRowBytes / Op::kElemBytes;  // columns of a k-stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* cols = reinterpret_cast<float*>(
      smem_raw + (ring - smem_u32(smem_raw)) + C::kStages * C::kStageBytes);
  const uint32_t full = smem_u32(cols) + C::kColBytes;  // 8 B each
  const uint32_t empty = full + 8 * C::kStages;
  const int group = threadIdx.x / 128;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int b = blockIdx.x;
  const int m0 = (m_fastest ? b % m_tiles : b / n_tiles) * kBM;
  const int n0 = (m_fastest ? b / m_tiles : b % n_tiles) * BN;
  const int KT = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == kConsumers) {  // producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % C::kStages;
        mbar_wait(empty + 8 * s, ((kt / C::kStages) & 1) ^ 1);
        const uint32_t a = ring + s * C::kStageBytes;
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
        tma_load(a, &map_a, kt * kBK, m0, full + 8 * s);
        tma_load(a + C::kABytes, &map_b, kt * kBK, n0, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    for (int c = threadIdx.x; c < BN; c += 128 * kConsumers) {
      epi.load_col(n0 + c, cols + c, BN);
    }
    Acc d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0;
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % C::kStages;
      mbar_wait(full + 8 * s, (kt / C::kStages) & 1);
      const uint32_t a = ring + s * C::kStageBytes;
      const uint64_t da = desc_sw128(a + group * 64 * kRowBytes);
      const uint64_t db = desc_sw128(a + C::kABytes);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) {
        mma<BN>(d, da + 2 * kk, db + 2 * kk);
      }
      mma_commit();
      keep_in_regs(d);
      mma_wait<1>();  // stage kt-1's products are done: release it
      if (kt > 0 && lane == 0) {
        mbar_arrive(empty + 8 * ((kt - 1) % C::kStages));
      }
    }
    mma_wait<0>();
    keep_in_regs(d);

    // every consumer's column parameters are staged
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    // accumulator layout of wgmma m64nBN: warp w of the warpgroup holds
    // rows 16w + lane/4 and 16w + lane/4 + 8
    const int row = m0 + group * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    epi.template tile<BN>(d, row, n0 + col, cols + col, M);
  }
}

// An epilogue that works on each pair of adjacent outputs alone: e.load_col
// as above, e.row_param(row) read once per row, and
// e(row, col, v0, v1, p, BN, rp) for every pair (col even) of a row below
// M, with p the staged parameters of column col (p[1] those of col + 1,
// p[BN] the second parameter of col) and rp the row's parameter.
template <class E>
struct Pairwise {
  E e;
  __device__ void load_col(int c, float* p, int stride) const {
    e.load_col(c, p, stride);
  }
  template <int BN, class Acc>
  __device__ __forceinline__ void tile(const Acc (&d)[BN / 2], int row,
                                       int col, const float* p, int M) const {
    const auto rp0 = e.row_param(row < M ? row : 0);
    const auto rp1 = e.row_param(row + 8 < M ? row + 8 : 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (row < M) {
        e(row, col + 8 * j, d[4 * j], d[4 * j + 1], p + 8 * j, BN, rp0);
      }
      if (row + 8 < M) {
        e(row + 8, col + 8 * j, d[4 * j + 2], d[4 * j + 3], p + 8 * j, BN,
          rp1);
      }
    }
  }
};

template <class E>
Pairwise<E> pairwise(E e) {
  return Pairwise<E>{e};
}

// ---- host side ---------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major [rows, cols] matrix of elem_bytes-byte elements
// of the given type, read in boxes of box_rows x 128 bytes with 128-byte
// swizzle; rows and columns past the end read as zeros. Cached on (element
// type, address, rows, cols, box_rows): the stride, box width and swizzle
// follow from them. The element type is part of the key: a bf16 and an
// int8 matrix of one shape can lie at one address in turn (the caching
// allocator reuses freed blocks), and their maps differ in stride and box.
inline cudaError_t tensor_map(CUtensorMap* out, CUtensorMapDataType type,
                              int elem_bytes, const void* ptr, uint64_t rows,
                              uint64_t cols, int box_rows) {
  struct Key {
    CUtensorMapDataType type;
    const void* ptr;
    uint64_t rows, cols;
    int box_rows;
  };
  constexpr int kSlots = 64;
  static std::mutex mu;
  static Key keys[kSlots];
  static CUtensorMap maps[kSlots];
  static int used = 0, next = 0;
  const Key want{type, ptr, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Key& k = keys[i];
    if (k.type == type && k.ptr == ptr && k.rows == rows &&
        k.cols == cols && k.box_rows == box_rows) {
      *out = maps[i];
      return cudaSuccess;
    }
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = want;
  maps[next] = map;
  next = (next + 1) % kSlots;
  if (used < kSlots) ++used;
  *out = map;
  return cudaSuccess;
}

// C = A . B^T through the epilogue: A [M, K], B [N, K] of Op's type, 16-byte
// aligned, a row a multiple of 16 bytes; N % BN == 0. The grid is one
// dimension of M / 128 x N / BN tiles, B's tiles fastest (the blocks that
// share a tile of A run side by side), or A's with m_fastest.
template <class Op, int BN, class Epi>
cudaError_t gemm(const void* A, const void* B, int M, int N, int K, Epi epi,
                 cudaStream_t stream, bool m_fastest = false) {
  using C = Cfg<BN>;
  const long long blocks =
      static_cast<long long>((M + kBM - 1) / kBM) * (N / BN);
  if (M <= 0 || N <= 0 || N % BN || K <= 0 || (K * Op::kElemBytes) % 16 ||
      blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap ma, mb;
  cudaError_t e =
      tensor_map(&ma, Op::kMapType, Op::kElemBytes, A, M, K, kBM);
  if (e == cudaSuccess) {
    e = tensor_map(&mb, Op::kMapType, Op::kElemBytes, B, N, K, BN);
  }
  if (e != cudaSuccess) return e;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<Op, BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  gemm_kernel<Op, BN, Epi><<<static_cast<int>(blocks), kThreads,
                             C::kSmemBytes, stream>>>(
      ma, mb, M, K, N / BN, m_fastest ? 1 : 0, epi);
  return cudaGetLastError();
}

// The GEMM of [M, K] activations by an [N, K] weight, with the output tile
// of 128 x BN (BN in 256, 192, 128, dividing N) that needs the least card
// time counted in waves of one tile per SM, ceil(tiles / SMs), each wave
// costing BN + 64 (a wider tile spends less of its time outside the main
// loop). At T = 4,096, bert-base, the down GEMMs (N = H = 768) take 192
// (128 tiles for 132 SMs, where 256 gives 96); at T = 32,768 they, and the
// up GEMMs everywhere, take 256.
template <class Op, class Epi>
cudaError_t gemm_by_waves(const void* a, const void* w, int M, int N, int K,
                          Epi epi, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return e;
  }
  const long long m_tiles = (M + kBM - 1) / kBM;
  int best = 0;
  long long best_cost = 0;
  for (const int bn : {256, 192, 128}) {
    if (N % bn) continue;
    const long long cost = (m_tiles * (N / bn) + sms - 1) / sms * (bn + 64);
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  if (best == 256) return gemm<Op, 256>(a, w, M, N, K, epi, s);
  if (best == 192) return gemm<Op, 192>(a, w, M, N, K, epi, s);
  return gemm<Op, 128>(a, w, M, N, K, epi, s);
}

}  // namespace wg
