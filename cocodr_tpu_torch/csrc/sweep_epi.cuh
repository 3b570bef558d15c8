// The block-max sweeps' epilogue on gemm_wgmma.cuh's accumulator layout,
// generic over the accumulator type: float32 sums for the bf16 sweeps K2
// and K10 (mips_sweep.cu), int32 sums for the int8 sweep K6
// (mips_int8.cu); K9 (mips_top2.cu) takes its selects and its layout.
//
// Every sweep runs wg::gemm with the queries as A (rows) and 256 corpus
// rows as B (columns). In wgmma's accumulator layout a thread holds two
// query rows and, of each 8-column group j, the columns 8j + 2(lane % 4)
// and the next one: an 8-row fine block is one group spread over the four
// lanes of a quad, a 64-row coarse block eight groups. The epilogue
// reduces the thread's pairs in registers, then scatters the 32 fine
// blocks of a row over the quad by two shuffle steps, each lane keeping
// the maxima of 8 consecutive fine blocks (one coarse block) and storing
// them with two 16-byte stores. No score reaches shared or device memory.
// Rows past Q come back zero from TMA and are not written.
//
// Register arrays are indexed only by constants (unrolled loops, template
// steps) and selected between with pick (inline selp): nvcc otherwise
// moves them to local memory, which -Xptxas -v shows as a stack frame.
#pragma once

#include <cuda_runtime.h>

namespace sweep {

enum Mode { kMax = 0, kPack = 1, kBlock32 = 2 };

constexpr int kTileRows = 256;  // corpus rows of a block (the GEMM's BN)

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

__device__ __forceinline__ float vmax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ int vmax(int x, int y) { return max(x, y); }

// (v, a) replaced by the partner's (ov, oa) where that is greater, or equal
// with a lower argmax: the first occurrence wins, as in the TPU kernels'
// strict '>' select chains
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& a, T ov, int oa) {
  const bool take = ov > v || (ov == v && oa < a);
  v = pick(take, ov, v);
  a = pick(take, oa, a);
}

// The maxima of S blocks of a row, spread over the four lanes of a quad
// (lane % 4 = c = 2 b1 + b0), each lane holding its own partial maxima
// -> in v[0 .. S/4) the maxima of blocks (S/2) b0 + (S/4) b1 + i over the
// whole quad. Two steps, each sending half of what a lane holds to its
// partner (lane ^ 1, then lane ^ 2) and keeping the other half. A step is
// a template so that every index into v is a constant: an index that
// depends on a loop the compiler does not unroll moves v to local memory.
template <int kStep, int S, typename T>
__device__ __forceinline__ void scatter_step(T (&v)[S]) {
  constexpr int kHalf = S >> (kStep + 1);  // entries kept after this step
  const bool upper = (threadIdx.x >> kStep) & 1;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const T ov = __shfl_xor_sync(
        0xffffffffu, pick(upper, v[i], v[kHalf + i]), 1 << kStep);
    v[i] = vmax(pick(upper, v[kHalf + i], v[i]), ov);
  }
}

template <int S, typename T>
__device__ __forceinline__ void quad_scatter_max(T (&v)[S]) {
  scatter_step<0>(v);
  scatter_step<1>(v);
}

// As quad_scatter_max<32> for fine blocks, with their argmaxes a[j] in
// 0..7: a lane's own entries start as 2c + (0 or 1). The partner's
// argmaxes travel as bits, all of a step in one word: in step 0 the
// partner's lane (c ^ 1) is known, so one bit an entry; in step 1 its
// entries come from lanes c ^ 2 or c ^ 3, so two bits an entry.
template <int kStep, typename T>
__device__ __forceinline__ void scatter_arg_step(T (&v)[32], int (&a)[32]) {
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
    const T ov = __shfl_xor_sync(
        0xffffffffu, pick(upper, v[i], v[kHalf + i]), 1 << kStep);
    const int oa = base | ((bits >> (kWidth * i)) & kMask);
    T kv = pick(upper, v[kHalf + i], v[i]);
    int ka = pick(upper, a[kHalf + i], a[i]);
    take_better(kv, ka, ov, oa);
    v[i] = kv;
    a[i] = ka;
  }
}

template <typename T>
__device__ __forceinline__ void quad_scatter_argmax(T (&v)[32], int (&a)[32]) {
  scatter_arg_step<0>(v, a);
  scatter_arg_step<1>(v, a);
}

// A fine maximum with its argmax row (0..7) in the 3 low bits: of the
// float32 bit pattern, (bits & ~7) | arg, negative values too; of an
// integer, (max << 3) | arg, strictly monotone in the max while
// |max| < 2^28.
__device__ __forceinline__ float pack3(float best, int arg) {
  return __int_as_float((__float_as_int(best) & ~7) | arg);
}

__device__ __forceinline__ int pack3(int best, int arg) {
  return static_cast<int>(static_cast<unsigned>(best) << 3) | arg;
}

__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

__device__ __forceinline__ void store4(int* p, int x, int y, int z, int w) {
  *reinterpret_cast<int4*>(p) = make_int4(x, y, z, w);
}

// kMax / kPack: out0 fine [Q, N/8], out1 coarse [Q, N/64].
// kBlock32 (float only): out0 [Q, N/32]; out1 unused.
template <int kMode, typename T>
struct SweepEpi {
  T* out0;
  T* out1;
  int N;
  __device__ void load_col(int, float*, int) const {}
  template <int BN>
  __device__ __forceinline__ void tile(const T (&d)[BN / 2], int row,
                                       int col, const float*, int M) const {
    static_assert(BN == kTileRows, "a sweep block holds 256 corpus rows");
    const int lane = threadIdx.x & 31;
    const int c = lane & 3;        // this lane's column pair in each group
    const int n0 = col - 2 * c;    // the block's first corpus row
    const int b0 = c & 1, b1 = c >> 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = row + 8 * half;
      if constexpr (kMode == kBlock32) {
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
        T v[32];
        int a[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const T x0 = d[4 * j + 2 * half];
          const T x1 = d[4 * j + 2 * half + 1];
          const bool second = x1 > x0;
          v[j] = pick(second, x1, x0);
          a[j] = 2 * c + second;
        }
        if constexpr (kMode == kPack) {
          quad_scatter_argmax(v, a);
        } else {
          quad_scatter_max<32>(v);
        }
        // this lane now holds fine blocks j0 .. j0 + 7: one coarse block
        const int j0 = 16 * b0 + 8 * b1;
        if constexpr (kMode == kPack) {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = pack3(v[i], a[i]);
        }
        T cm = v[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) cm = vmax(cm, v[i]);
        if (q < M) {
          T* f = &out0[static_cast<size_t>(q) * (N / 8) + n0 / 8 + j0];
          store4(f, v[0], v[1], v[2], v[3]);
          store4(f + 4, v[4], v[5], v[6], v[7]);
          out1[static_cast<size_t>(q) * (N / 64) + n0 / 64 + j0 / 8] = cm;
        }
      }
    }
  }
};

}  // namespace sweep
