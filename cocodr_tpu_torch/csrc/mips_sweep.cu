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
// run side by side and share its reads through L2. In wgmma's accumulator
// layout a thread holds two query rows and, of each 8-column group j, the
// columns 8j + 2(lane % 4) and the next one: an 8-row fine block is one
// group spread over the four lanes of a quad. The epilogue reduces the
// thread's pairs in registers, then scatters the 32 fine blocks of a row
// over the quad by two shuffle steps, each lane keeping the maxima of 8
// consecutive fine blocks (one coarse block) and storing them with two
// 16-byte stores. No score reaches shared or device memory. Rows past Q
// come back zero from TMA and are not written; a k tail past D reads as
// zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"

namespace {

enum Mode { kMax = 0, kPack = 1, kBlock32 = 2 };

constexpr int kTileRows = 256;  // corpus rows of a block (the GEMM's BN)

__device__ __forceinline__ float pack3(float best, int arg) {
  return __int_as_float((__float_as_int(best) & ~7) | arg);
}

// (v, a) replaced by the partner's (ov, oa) where that is greater, or equal
// with a lower argmax: the first occurrence wins, as in the TPU kernels'
// strict '>' select chains
__device__ __forceinline__ void take_better(float& v, int& a, float ov,
                                            int oa) {
  const bool take = ov > v || (ov == v && oa < a);
  v = take ? ov : v;
  a = take ? oa : a;
}

// c ? x : y as one selp on values in registers. nvcc turns a plain select
// between two elements of a register array into a select of their
// addresses, which moves the array to local memory.
__device__ __forceinline__ float pick(bool c, float x, float y) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r) : "f"(x), "f"(y), "r"(static_cast<int>(c)));
  return r;
}

__device__ __forceinline__ int pick(bool c, int x, int y) {
  int r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.b32 %0, %1, %2, p;\n}\n"
      : "=r"(r) : "r"(x), "r"(y), "r"(static_cast<int>(c)));
  return r;
}

// The maxima of S blocks of a row, spread over the four lanes of a quad
// (lane % 4 = c = 2 b1 + b0), each lane holding its own partial maxima
// -> in v[0 .. S/4) the maxima of blocks (S/2) b0 + (S/4) b1 + i over the
// whole quad. Two steps, each sending half of what a lane holds to its
// partner (lane ^ 1, then lane ^ 2) and keeping the other half. A step is
// a template so that every index into v is a constant: an index that
// depends on a loop the compiler does not unroll moves v to local memory.
template <int kStep, int S>
__device__ __forceinline__ void scatter_step(float (&v)[S]) {
  constexpr int kHalf = S >> (kStep + 1);  // entries kept after this step
  const bool upper = (threadIdx.x >> kStep) & 1;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float ov = __shfl_xor_sync(
        0xffffffffu, pick(upper, v[i], v[kHalf + i]), 1 << kStep);
    v[i] = fmaxf(pick(upper, v[kHalf + i], v[i]), ov);
  }
}

template <int S>
__device__ __forceinline__ void quad_scatter_max(float (&v)[S]) {
  scatter_step<0>(v);
  scatter_step<1>(v);
}

// As quad_scatter_max<32> for fine blocks, with their argmaxes a[j] in
// 0..7: a lane's own entries start as 2c + (0 or 1). The partner's
// argmaxes travel as bits, all of a step in one word: in step 0 the
// partner's lane (c ^ 1) is known, so one bit an entry; in step 1 its
// entries come from lanes c ^ 2 or c ^ 3, so two bits an entry.
template <int kStep>
__device__ __forceinline__ void scatter_arg_step(float (&v)[32],
                                                 int (&a)[32]) {
  constexpr int kHalf = 16 >> kStep;
  constexpr int kWidth = kStep + 1;  // bits sent an entry
  constexpr int kMask = (1 << kWidth) - 1;
  const int c = threadIdx.x & 3;
  const bool upper = (c >> kStep) & 1;
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    bits |= static_cast<unsigned>(pick(upper, a[i], a[kHalf + i]) & kMask)
            << (kWidth * i);
  }
  bits = __shfl_xor_sync(0xffffffffu, bits, 1 << kStep);
  // the bits above those sent: the partner's lane, c ^ 1 (step 0), or the
  // half of the quad that c ^ 2 belongs to (step 1)
  const int base = kStep == 0 ? (c ^ 1) << 1 : ((c ^ 2) >> 1) << 2;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float ov = __shfl_xor_sync(
        0xffffffffu, pick(upper, v[i], v[kHalf + i]), 1 << kStep);
    const int oa = base | ((bits >> (kWidth * i)) & kMask);
    float kv = pick(upper, v[kHalf + i], v[i]);
    int ka = pick(upper, a[kHalf + i], a[i]);
    take_better(kv, ka, ov, oa);
    v[i] = kv;
    a[i] = ka;
  }
}

__device__ __forceinline__ void quad_scatter_argmax(float (&v)[32],
                                                    int (&a)[32]) {
  scatter_arg_step<0>(v, a);
  scatter_arg_step<1>(v, a);
}

// kMax / kPack: out0 fine [Q, N/8], out1 coarse [Q, N/64].
// kBlock32: out0 [Q, N/32]; out1 unused.
template <int kMode>
struct SweepEpi {
  float* out0;
  float* out1;
  int N;
  __device__ void load_col(int, float*, int) const {}
  template <int BN>
  __device__ __forceinline__ void tile(const float (&d)[BN / 2], int row,
                                       int col, const float*, int M) const {
    static_assert(BN == kTileRows, "a sweep block holds 256 corpus rows");
    const int lane = threadIdx.x & 31;
    const int c = lane & 3;        // this lane's column pair in each group
    const int n0 = col - 2 * c;    // the block's first corpus row
    const int b0 = c & 1, b1 = c >> 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = row + 8 * half;
      if (kMode == kBlock32) {
        // a 32-row block is 4 groups: 8 of the thread's values a block
        float v[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          float m = fmaxf(d[16 * b + 2 * half], d[16 * b + 2 * half + 1]);
#pragma unroll
          for (int g = 1; g < 4; ++g) {
            m = fmaxf(m, fmaxf(d[16 * b + 4 * g + 2 * half],
                               d[16 * b + 4 * g + 2 * half + 1]));
          }
          v[b] = m;
        }
        quad_scatter_max<8>(v);
        if (q < M) {
          *reinterpret_cast<float2*>(
              &out0[static_cast<size_t>(q) * (N / 32) + n0 / 32 + 4 * b0 +
                    2 * b1]) = make_float2(v[0], v[1]);
        }
      } else {
        // a fine block is one group: the thread's pair, then the quad
        float v[32];
        int a[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x0 = d[4 * j + 2 * half];
          const float x1 = d[4 * j + 2 * half + 1];
          const bool second = x1 > x0;
          v[j] = pick(second, x1, x0);
          a[j] = 2 * c + second;
        }
        if (kMode == kPack) {
          quad_scatter_argmax(v, a);
        } else {
          quad_scatter_max<32>(v);
        }
        // this lane now holds fine blocks j0 .. j0 + 7: one coarse block
        const int j0 = 16 * b0 + 8 * b1;
        float cm = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (kMode == kPack) v[i] = pack3(v[i], a[i]);
          cm = i == 0 ? v[i] : fmaxf(cm, v[i]);
        }
        if (q < M) {
          float4* f = reinterpret_cast<float4*>(
              &out0[static_cast<size_t>(q) * (N / 8) + n0 / 8 + j0]);
          f[0] = make_float4(v[0], v[1], v[2], v[3]);
          f[1] = make_float4(v[4], v[5], v[6], v[7]);
          out1[static_cast<size_t>(q) * (N / 64) + n0 / 64 + j0 / 8] = cm;
        }
      }
    }
  }
};

template <int kMode>
int launch(const void* queries, const void* corpus, void* out0, void* out1,
           int Q, int N, int D, void* stream) {
  if (Q <= 0 || N <= 0 || N % kTileRows || D <= 0 || D % 32) {
    return cudaErrorInvalidValue;
  }
  return wg::gemm<wg::Bf16, kTileRows>(
      queries, corpus, Q, N, D,
      SweepEpi<kMode>{static_cast<float*>(out0), static_cast<float*>(out1), N},
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
