// The routed experts of a DeepSeek-V2 MoE layer, as two grouped GEMMs over
// the rows sorted by expert (ops/moe.py::route):
//   gate-up:  h[r, :] = bf16(silu(x[r] . Wg_e^T) * (x[r] . Wu_e^T))
//   down:     out[dst[r], :] = p[r] * (h[r] . Wd_e^T)        (float32)
// for the rows r of expert e, [offsets[e], offsets[e + 1]), with x [R, H]
// and h [R, F] bf16, Wg and Wu [E, F, H] and Wd [E, H, F] bf16 (the
// experts' nn.Linear weights stacked), p [R] float32 and dst [R] int64.
// Rows at or past offsets[E] (padded tokens) are computed by no block.
//
// No TPU kernel is replaced: the JAX package has no MoE tower. Bound on the
// H100: 6 R H F operations against the rows in and out and each expert's
// three matrices read once; at the encode cell's widest batch (128 x 512
// tokens, 6 experts a token, H 2,048, F 1,408) that is ~6.8 TFLOP against
// ~4.3 GB, ~1,600 operations a byte, so the bf16 tensor cores bound it.
// Measured on an H100 80GB HBM3 at 700 W (loops of launches): 6.45 ms for
// 221,184 rows against a 3.87 ms bound (60%), one cuBLAS product per
// expert 6.83 ms, torch._grouped_mm 10.36 ms. What holds it back is what
// holds the FFN GEMMs back (ffn_block.cu): one tile a block, its epilogue
// not overlapped with the next tile's loads.
// Both products run gemm_wgmma.cuh's main loop (TMA ring, one producer
// warp, two wgmma consumer warpgroups, 128 x 256 tiles): the grid holds
// ceil(R / 128) + E row-tile slots for every column tile, each block finds
// its expert and first row from the offsets on the card (a warp's scan of
// the experts' tile counts), and blocks past the last tile leave at once,
// so the host sets the grid from R alone and never reads the routing. The
// gate-up block loads 128 rows of Wg and the same 128 rows of Wu into one
// 256-row B stage, so each thread holds gate and up of the same columns and
// the epilogue applies SiLU * up in registers; the down block scales each
// row by its routing probability and stores it, float32, at the token's
// slot, for ops/moe.py::combine to sum in float32. A tile's rows past its
// expert's end belong to the next expert (or read as zeros past R): they
// are multiplied and not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"

namespace {

using namespace wg;

constexpr int kBN = 256;           // B rows a stage: gate 128 + up 128, or
                                   // 256 columns of the down product's H
constexpr int kHalf = kBN / 2;     // columns of F a gate-up block computes
constexpr int kUp = kBN / 4;       // offset of up's accumulators in d
using C = Cfg<kBN>;

// The block's tile: expert e (-1: past the last tile), first sorted row m0,
// the expert's end. Warp 0 scans the experts' tile counts, 32 at a time.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets,
                                          int E, int slot, int* tile) {
  const int lane = threadIdx.x & 31;
  int done = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int lo = e < E ? offsets[e] : 0;
    const int hi = e < E ? offsets[e + 1] : 0;
    const int tiles = (hi - lo + kBM - 1) / kBM;
    int incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = done + incl - tiles;
    const bool mine = slot >= excl && slot < done + incl;
    const unsigned who = __ballot_sync(0xffffffffu, mine);
    if (who) {
      if (mine) {
        tile[0] = e;
        tile[1] = lo + (slot - excl) * kBM;
        tile[2] = hi;
      }
      return;
    }
    done += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) tile[0] = -1;  // past the last tile
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + __expf(-x));
}

// gate-up (kGateUp): map_b0 and map_b1 are Wg and Wu as [E F, H], b_rows F;
// down: map_b0 is Wd as [E H, F], b_rows H. K: the products' depth.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b0,
                const __grid_constant__ CUtensorMap map_b1,
                const int* __restrict__ offsets, int E, int K, int n_tiles,
                int b_rows, __nv_bfloat16* __restrict__ h,
                const float* __restrict__ weights,
                const long long* __restrict__ dst, float* __restrict__ out) {
  __shared__ int tile[3];
  const int slot = blockIdx.x / n_tiles;
  const int nt = blockIdx.x % n_tiles;
  if (threadIdx.x < 32) find_tile(offsets, E, slot, tile);
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;  // block-uniform
  const int m0 = tile[1], m_end = tile[2];

  constexpr int kBK = kRowBytes / Bf16::kElemBytes;  // 64 columns a stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full =
      ring + C::kStages * C::kStageBytes;  // 8 B each
  const uint32_t empty = full + 8 * C::kStages;
  const int group = threadIdx.x / 128;
  const int KT = (K + kBK - 1) / kBK;
  const int b0 = e * b_rows + nt * (kGateUp ? kHalf : kBN);

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
        tma_load(a + C::kABytes, &map_b0, kt * kBK, b0, full + 8 * s);
        if (kGateUp) {
          tma_load(a + C::kABytes + kHalf * kRowBytes, &map_b1, kt * kBK, b0,
                   full + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    float d[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) d[i] = 0.0f;
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
        mma<kBN>(d, da + 2 * kk, db + 2 * kk);
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

    // wgmma m64nN's accumulator layout: warp w of the warpgroup holds rows
    // 16w + lane/4 and 16w + lane/4 + 8; d[4j..4j+3] are columns
    // col + 8j, col + 8j + 1 of the first row, then of the second
    const int row = m0 + group * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    if (kGateUp) {
      const int F = b_rows;
      const int f0 = nt * kHalf + col;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        if (row < m_end) {
          *reinterpret_cast<__nv_bfloat162*>(
              &h[static_cast<size_t>(row) * F + f0 + 8 * j]) =
              __floats2bfloat162_rn(silu(d[4 * j]) * d[4 * j + kUp],
                                    silu(d[4 * j + 1]) * d[4 * j + 1 + kUp]);
        }
        if (row + 8 < m_end) {
          *reinterpret_cast<__nv_bfloat162*>(
              &h[static_cast<size_t>(row + 8) * F + f0 + 8 * j]) =
              __floats2bfloat162_rn(silu(d[4 * j + 2]) * d[4 * j + 2 + kUp],
                                    silu(d[4 * j + 3]) * d[4 * j + 3 + kUp]);
        }
      }
    } else {
      const int H = b_rows;
      const int c0 = nt * kBN + col;
      const bool r0 = row < m_end, r1 = row + 8 < m_end;
      const float p0 = r0 ? __ldg(&weights[row]) : 0.0f;
      const float p1 = r1 ? __ldg(&weights[row + 8]) : 0.0f;
      float* o0 = out + (r0 ? __ldg(&dst[row]) : 0) * static_cast<size_t>(H);
      float* o1 =
          out + (r1 ? __ldg(&dst[row + 8]) : 0) * static_cast<size_t>(H);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        if (r0) {
          *reinterpret_cast<float2*>(&o0[c0 + 8 * j]) =
              make_float2(p0 * d[4 * j], p0 * d[4 * j + 1]);
        }
        if (r1) {
          *reinterpret_cast<float2*>(&o1[c0 + 8 * j]) =
              make_float2(p1 * d[4 * j + 2], p1 * d[4 * j + 3]);
        }
      }
    }
  }
}

template <bool kGateUp>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb0,
                   const CUtensorMap& mb1, const int* offsets, int R, int E,
                   int K, int n_tiles, int b_rows, __nv_bfloat16* h,
                   const float* weights, const long long* dst, float* out,
                   cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gemm_kernel<kGateUp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      (static_cast<long long>((R + kBM - 1) / kBM) + E) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  moe_gemm_kernel<kGateUp><<<static_cast<int>(blocks), kThreads,
                             C::kSmemBytes, s>>>(
      ma, mb0, mb1, offsets, E, K, n_tiles, b_rows, h, weights, dst, out);
  return cudaGetLastError();
}

bool bad_shape(int R, int E, int H, int F) {
  return R <= 0 || E <= 0 || H <= 0 || H % kBN || F <= 0 || F % kHalf;
}

}  // namespace

// x [R, H] bf16 rows in expert order, w_gate and w_up [E, F, H] bf16,
// offsets [E + 1] int32 -> h [R, F] bf16 (rows of experts only).
// H % 256 == 0, F % 128 == 0, every pointer 16-byte aligned.
extern "C" int cocodr_moe_gate_up_bf16(const void* x, const void* w_gate,
                                       const void* w_up, const void* offsets,
                                       void* h, int R, int E, int H, int F,
                                       void* stream) {
  if (bad_shape(R, E, H, F)) return cudaErrorInvalidValue;
  CUtensorMap ma, mg, mu;
  cudaError_t e = tensor_map(&ma, Bf16::kMapType, 2, x, R, H, kBM);
  if (e == cudaSuccess) {
    e = tensor_map(&mg, Bf16::kMapType, 2, w_gate,
                   static_cast<uint64_t>(E) * F, H, kHalf);
  }
  if (e == cudaSuccess) {
    e = tensor_map(&mu, Bf16::kMapType, 2, w_up,
                   static_cast<uint64_t>(E) * F, H, kHalf);
  }
  if (e != cudaSuccess) return e;
  return launch<true>(ma, mg, mu, static_cast<const int*>(offsets), R, E, H,
                      F / kHalf, F, static_cast<__nv_bfloat16*>(h), nullptr,
                      nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// h [R, F] bf16 in expert order, w_down [E, H, F] bf16, offsets [E + 1]
// int32, weights [R] float32, dst [R] int64 -> out[dst[r], :] float32 [*, H]
// (rows of experts only). H % 256 == 0, F % 128 == 0, pointers 16-byte
// aligned.
extern "C" int cocodr_moe_down_bf16(const void* h, const void* w_down,
                                    const void* offsets, const void* weights,
                                    const void* dst, void* out, int R, int E,
                                    int H, int F, void* stream) {
  if (bad_shape(R, E, H, F)) return cudaErrorInvalidValue;
  CUtensorMap ma, md;
  cudaError_t e = tensor_map(&ma, Bf16::kMapType, 2, h, R, F, kBM);
  if (e == cudaSuccess) {
    e = tensor_map(&md, Bf16::kMapType, 2, w_down,
                   static_cast<uint64_t>(E) * H, F, kBN);
  }
  if (e != cudaSuccess) return e;
  return launch<false>(ma, md, md, static_cast<const int*>(offsets), R, E, F,
                       H / kBN, H, nullptr,
                       static_cast<const float*>(weights),
                       static_cast<const long long*>(dst),
                       static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}
