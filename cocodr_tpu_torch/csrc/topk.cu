// K3: exact top-k by k rounds of extract-max along the last axis of a
// row-major [Q, W] array (float32 or int32).
//
// Replaces cocodr_tpu/ops/pallas_mips.py::_topk_kernel (called through
// pallas_topk). Semantics are the TPU kernel's, bit for bit:
//   * the row is virtually padded to Wp = W rounded up to 128 with the
//     sentinel neg (finfo(float32).min or iinfo(int32).min), as pallas_topk
//     pads it;
//   * each round takes the row maximum and the LOWEST index holding it,
//     writes them out, and sets that slot to neg;
//   * so when fewer than k entries lie above neg (e.g. -inf masked blocks)
//     a later round returns an already-extracted index with value neg,
//     where a sort-based top-k would return a -inf entry instead.
//
// Bound on the H100: the serving path calls it on [64, 2048], [64, 640]
// and [64, 80] rows with k = 10, a few hundred KB in all, so the bound is
// neither bytes nor operations but k dependent block-wide reductions per
// row (launch and barrier latency). Design: one block per row, the row
// staged once in shared memory when it fits (then every round reads
// shared memory only); rows too wide for shared memory stay in global
// memory and a shared bitmap records the extracted slots. Every thread
// runs the same number of rounds and barriers, so no barrier sits in
// divergent code.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a block may ask for, under the H100's 227 KB
constexpr size_t kMaxDynamicSmem = 200 * 1024;

template <typename T>
struct Limits;

template <>
struct Limits<float> {
  // the value an extracted slot takes: finfo(float32).min
  __device__ static float neg() { return -FLT_MAX; }
  // below every value, -inf included: the start of each reduction
  __device__ static float lowest() {
    return __int_as_float(static_cast<int>(0xff800000u));
  }
};

template <>
struct Limits<int> {
  __device__ static int neg() { return INT_MIN; }
  __device__ static int lowest() { return INT_MIN; }
};

// (value descending, index ascending): true when (v, i) comes first
template <typename T>
__device__ __forceinline__ bool before(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
            int* __restrict__ ids, int W, int Wp, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const T* xr = x + row * W;
  const T neg = Limits<T>::neg();
  T* srow = reinterpret_cast<T*>(smem);               // kStaged: Wp values
  unsigned* taken = reinterpret_cast<unsigned*>(smem);  // else: Wp bits

  if (kStaged) {
    for (int j = tid; j < Wp; j += kThreads) srow[j] = j < W ? xr[j] : neg;
  } else {
    for (int j = tid; j < (Wp + 31) / 32; j += kThreads) taken[j] = 0u;
  }
  __syncthreads();

  for (int r = 0; r < k; ++r) {
    T bv = Limits<T>::lowest();
    int bi = INT_MAX;
    for (int j = tid; j < Wp; j += kThreads) {
      T v;
      if (kStaged) {
        v = srow[j];
      } else {
        v = (j >= W || ((taken[j >> 5] >> (j & 31)) & 1u)) ? neg : xr[j];
      }
      if (before(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      T mv = red_v[0];
      int mi = red_i[0];
      for (int w = 1; w < kWarps; ++w) {
        if (before(red_v[w], red_i[w], mv, mi)) {
          mv = red_v[w];
          mi = red_i[w];
        }
      }
      vals[row * k + r] = mv;
      ids[row * k + r] = mi;
      if (mi < Wp) {  // false only for a row of NaNs
        if (kStaged) {
          srow[mi] = neg;
        } else {
          taken[mi >> 5] |= 1u << (mi & 31);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_topk(const void* x, void* vals, void* ids, int Q, int W, int k,
                void* stream) {
  if (Q <= 0 || W <= 0 || k <= 0 || k > W) return cudaErrorInvalidValue;
  const int Wp = (W + 127) / 128 * 128;
  const size_t staged = static_cast<size_t>(Wp) * sizeof(T);
  const size_t bitmap = static_cast<size_t>((Wp + 31) / 32) * sizeof(unsigned);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(vals);
  int* ip = static_cast<int*>(ids);
  if (staged <= kMaxDynamicSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (e != cudaSuccess) return e;
    topk_kernel<T, true><<<Q, kThreads, staged, s>>>(xp, vp, ip, W, Wp, k);
  } else {
    if (bitmap > kMaxDynamicSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        topk_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bitmap));
    if (e != cudaSuccess) return e;
    topk_kernel<T, false><<<Q, kThreads, bitmap, s>>>(xp, vp, ip, W, Wp, k);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int cocodr_topk_f32(const void* x, void* vals, void* ids, int Q,
                               int W, int k, void* stream) {
  return launch_topk<float>(x, vals, ids, Q, W, k, stream);
}

extern "C" int cocodr_topk_i32(const void* x, void* vals, void* ids, int Q,
                               int W, int k, void* stream) {
  return launch_topk<int>(x, vals, ids, Q, W, k, stream);
}
