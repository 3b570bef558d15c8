// K8: fused attention on the sequence-major layout [B, S, N, D],
//   s   = float32(q . k^T) * scale + bias[b, key]
//   p   = bf16(exp(s - max s) / sum exp(s - max s))     float32 softmax
//   out = bf16(float32(p . v))
// per batch element b and head n, with q, k, v, out [B, S, N, D] bf16,
// bias [B, S] float32 (0 for a real key, -1e9 for padding), D = 64.
//
// Replaces cocodr_tpu/ops/pallas_attention.py::_attn_kernel (called
// through fused_attention_seq_major). The TPU kernel takes g batch
// elements with all heads per grid step and transposes heads in VMEM; here
// a block takes one (query tile, head, batch element) and reads its rows
// of q, k and v straight from the [B, S, N, D] layout (each row is D
// contiguous bf16, rows N*D apart), so no head transpose exists at all.
// It keeps the TPU kernel's rounding points: the probabilities are
// normalised in float32 and rounded to bf16 before the PV product. An
// online (flash) softmax would rescale partial sums and round elsewhere.
//
// Design: the block loads its query tile Q [qt, 64] and the whole K and V
// [S, 64] of (b, n) into shared memory, computes the float32 score tile
// [qt, S] with WMMA bf16 fragments, runs the softmax one warp per row,
// writes the bf16 probabilities to shared memory, and multiplies them by V
// with WMMA into float32. S is padded to a multiple of 16 with zero rows
// of K and V whose probabilities are 0. qt is 64 where shared memory
// allows, and 32 or 16 for longer S (S <= 512).
//
// Bound on the H100: 8*B*N*S*D bytes (q, k, v read once, out written once:
// 201 MB at B = 256, S = 128, N = 12) against 4*B*N*S^2*D operations (12.9
// GFLOP, 64 per byte): it is bound by bytes (~0.060 ms at 3.35 TB/s). Each
// query tile reads K and V of its (b, n) again; at S = 128 the second read
// of the pair comes mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

#include "rowwise.cuh"

namespace {

using namespace nvcuda;
using rowwise::warp_max;
using rowwise::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;         // head dim
constexpr int kLd = kD + 8;    // bf16 row stride of the Q, K, V tiles
constexpr int kLdo = kD + 4;   // float row stride of the output staging
constexpr int kMaxS = 512;     // max_position_embeddings
constexpr size_t kMaxSmem = 232448;

struct Layout {  // byte offsets of the shared-memory regions
  int sp;        // S rounded up to 16
  int lds, ldp;  // row strides of the float scores and bf16 probabilities
  size_t q, k, v, s, p, total;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

__host__ __device__ inline Layout layout(int qt, int S) {
  Layout L;
  L.sp = (S + 15) / 16 * 16;
  L.lds = L.sp + 4;
  L.ldp = L.sp + 8;
  const int s_cols = L.lds > kLdo ? L.lds : kLdo;  // scores, then output
  L.q = 0;
  L.k = align128(L.q + sizeof(__nv_bfloat16) * qt * kLd);
  L.v = align128(L.k + sizeof(__nv_bfloat16) * L.sp * kLd);
  L.s = align128(L.v + sizeof(__nv_bfloat16) * L.sp * kLd);
  L.p = align128(L.s + sizeof(float) * qt * s_cols);
  L.total = align128(L.p + sizeof(__nv_bfloat16) * qt * L.ldp);
  return L;
}

// rows [0, rows) of a [*, 64] tile whose row i is at src + i * stride;
// rows at or past `valid` are zero
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int rows, int valid) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += kThreads) {
    const int i = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < valid) val = *reinterpret_cast<const uint4*>(src + i * stride + c);
    *reinterpret_cast<uint4*>(dst + i * kLd + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int S, int N, float scale, int qt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(qt, S);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  auto* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  auto* ss = reinterpret_cast<float*>(smem + L.s);
  auto* ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  const int b = blockIdx.z;
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * qt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(N) * kD;  // between rows s, s+1
  const size_t head0 = (static_cast<size_t>(b) * S * N + n) * kD;

  load_rows(qs, q + head0 + q0 * stride, stride, qt, S - q0);
  load_rows(ks, k + head0, stride, L.sp, S);
  load_rows(vs, v + head0, stride, L.sp, S);
  __syncthreads();

  // scores [qt, sp] = Q . K^T, float32 sums of bf16 products
  const int fm = qt / 16;
  const int fn = L.sp / 16;
  for (int f = warp; f < fm * fn; f += kWarps) {
    const int i0 = (f / fn) * 16;
    const int j0 = (f % fn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(a, qs + i0 * kLd + kk, kLd);
      wmma::load_matrix_sync(bf, ks + j0 * kLd + kk, kLd);
      wmma::mma_sync(acc, a, bf, acc);
    }
    wmma::store_matrix_sync(ss + i0 * L.lds + j0, acc, L.lds, wmma::mem_row_major);
  }
  __syncthreads();

  // float32 softmax, one warp per row, normalised before the rounding to
  // bf16; padded key columns get probability 0
  const float* brow = bias + static_cast<size_t>(b) * S;
  for (int i = warp; i < qt; i += kWarps) {
    float* srow = ss + i * L.lds;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float x = __fadd_rn(__fmul_rn(srow[j], scale), brow[j]);
      srow[j] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(__fsub_rn(srow[j], m));
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __nv_bfloat16* prow = ps + i * L.ldp;
    for (int j = lane; j < L.sp; j += 32) {
      prow[j] = __float2bfloat16(j < S ? __fdiv_rn(srow[j], sum) : 0.0f);
    }
  }
  __syncthreads();

  // out [qt, 64] = P . V, float32 sums, staged in the score region
  float* os = ss;
  for (int f = warp; f < fm * (kD / 16); f += kWarps) {
    const int i0 = (f / (kD / 16)) * 16;
    const int d0 = (f % (kD / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < L.sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(a, ps + i0 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(bf, vs + kk * kLd + d0, kLd);
      wmma::mma_sync(acc, a, bf, acc);
    }
    wmma::store_matrix_sync(os + i0 * kLdo + d0, acc, kLdo, wmma::mem_row_major);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < qt * 8; idx += kThreads) {
    const int i = idx >> 3;
    const int c = (idx & 7) * 8;
    if (q0 + i >= S) continue;
    __align__(16) __nv_bfloat16 x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __float2bfloat16(os[i * kLdo + c + e]);
    *reinterpret_cast<uint4*>(out + head0 + (q0 + i) * stride + c) =
        *reinterpret_cast<const uint4*>(x);
  }
}

}  // namespace

// q, k, v, out [B, S, N, D] bf16 contiguous, bias [B, S] float32; D = 64,
// S % 8 == 0, S <= 512, every pointer 16-byte aligned.
extern "C" int cocodr_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int B, int S, int N, int D,
                                     float scale, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S > kMaxS || S % 8 || N <= 0 ||
      N > 65535 || D != kD) {
    return cudaErrorInvalidValue;
  }
  const int sp = (S + 15) / 16 * 16;
  int qt = 64;  // query rows per block: 64, 32 or 16
  while (qt > 16 && (qt / 2 >= sp || layout(qt, S).total > kMaxSmem)) qt /= 2;
  const size_t smem = layout(qt, S).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((S + qt - 1) / qt, N, B);
  attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), S, N, scale, qt);
  return cudaGetLastError();
}
