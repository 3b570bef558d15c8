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
// a work item is one (batch element, head, tile of 128 query rows), read
// straight from the [B, S, N, D] layout (each row is D contiguous bf16,
// rows N*D apart), so no head transpose exists at all. It keeps the TPU
// kernel's rounding points: the probabilities are normalised in float32
// and rounded to bf16 before the PV product. An online (flash) softmax
// would rescale partial sums and round elsewhere.
//
// Bound on the H100: 8*B*N*S*D bytes (q, k, v read once, out written once:
// 201 MB at B = 256, S = 128, N = 12) against 4*B*N*S^2*D operations (12.9
// GFLOP, 64 per byte): it is bound by bytes (~0.060 ms at 3.35 TB/s), and
// beside them by the float32 softmax (B*N*S^2 = 50M expf and correctly
// rounded divisions at the encode shape). The kernel that this replaces
// staged the score tile, the probabilities and the output through shared
// memory between five barrier-separated phases and loaded with no overlap:
// 0.47-0.54 ms, ~4x scaled_dot_product_attention (H100 80GB HBM3, 700 W).
// This one takes 0.149 ms there (chip_smoke.py, loops of back-to-back
// launches), 1.78x scaled_dot_product_attention timed in turns (0.084
// ms). Its arithmetic holds it back, not its copies (variants that skip
// one or the other said so): mma.sync, and ~18 float32 operations a
// score for the exactly rounded softmax (the scale and bias, the max,
// expf, the sum, the normalisation), at 128 registers a thread (96 bytes
// spilled) for two blocks of 8 warps an SM.
//
// Design. mma.sync m16n8k16 (bf16, float32 accumulation) with ldmatrix,
// not wgmma: at 64 operations a byte the tensor cores are far from the
// limit, and a warp's 16 query rows are what a register-resident softmax
// wants. Each of a block's 8 warps owns 16 query rows. For a key tile of
// up to 128 keys a warp holds its 16 x 128 scores in registers (64 floats
// a thread, in the mma accumulator layout: a thread holds two rows, and
// the four threads of a quad share them), so the row max and sum are quad
// shuffles. The probabilities are rounded to bf16 and packed straight into
// the A operand of the PV product; V is its B operand through
// ldmatrix.trans. No score or probability touches shared memory.
//  - S <= 128: one key tile; scores are computed once.
//  - S > 128 (bucket widths up to 512): pass 1 walks key tiles of 64
//    (half the registers, beside the PV products that pass 2 holds) and
//    keeps each row's running max and a rescaled running sum (Sum then
//    differs from the plain sum as a reordered sum does; no probability is
//    rounded in pass 1); pass 2 recomputes each tile's scores, normalises
//    them by the final max and sum, rounds, and accumulates PV.
// Copies: Q, K, V and the bias row of a work item land in shared memory by
// cp.async (16 bytes a thread, rows swizzled by 16-byte chunk for
// conflict-free ldmatrix). Blocks are persistent and walk work items with
// a 2-deep ring: the next item's copies are in flight while the current
// one computes (49 KB a stage at S = 128, two blocks an SM). From S = 392
// a stage no longer fits twice and the ring is 1 deep.
// Rounding: every score and softmax operation is rounded one by one
// (__fmul_rn, __fadd_rn, __fsub_rn, libdevice expf), as the plain version
// rounds them; nvcc would otherwise contract a*b + c into an FMA and move
// the rounding point. The normalisation gives the bf16 of the correctly
// rounded e / l, as __fdiv_rn would, by a multiplication with 1 / l that
// falls back to __fdiv_rn near a bf16 rounding boundary (prob()).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;                  // head dim: 8 chunks of 16 bytes
constexpr int kRowBytes = kD * 2;
constexpr int kQRows = kWarps * 16;     // query rows of a work item
constexpr int kKeyTile = 128;           // keys whose scores a warp holds
constexpr int kNT = kKeyTile / 8;       // n8 tiles of a key tile
constexpr int kMaxS = 512;              // max_position_embeddings
constexpr int kMaxSmem = 232448;

struct Stage {  // byte offsets inside one stage of the ring
  int k, v, bias, bytes;  // q at 0
};

__host__ __device__ inline Stage stage_layout(int sp) {
  Stage L;
  L.k = kQRows * kRowBytes;
  L.v = L.k + sp * kRowBytes;
  L.bias = L.v + sp * kRowBytes;
  L.bytes = (L.bias + sp * 4 + 127) & ~127;
  return L;
}

// byte offset of 16-byte chunk c of row r in a [rows, 64] bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));  // 0: fill with zeros
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Item {
  int b, n, q0;
};

__device__ __forceinline__ Item item_of(int i, int N, int qtiles) {
  Item it;
  it.q0 = (i % qtiles) * kQRows;
  i /= qtiles;
  it.n = i % N;
  it.b = i / N;
  return it;
}

// cp.async of one work item's Q rows, K, V (sp rows; rows at or past S
// and past the item's query rows are zeros) and bias row into a stage
__device__ __forceinline__ void load_item(uint32_t st, const Stage& L,
                                          const __nv_bfloat16* q,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v,
                                          const float* bias, Item it, int S,
                                          int sp, int N) {
  const size_t stride = static_cast<size_t>(N) * kD;  // rows s, s+1
  const size_t head0 = (static_cast<size_t>(it.b) * S * N + it.n) * kD;
  for (int i = threadIdx.x; i < kQRows * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = it.q0 + r < S;
    cp_async16(st + swz(r, c),
               q + head0 + (ok ? it.q0 + r : 0) * stride + c * 8, ok);
  }
  for (int i = threadIdx.x; i < sp * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < S;
    const size_t at = head0 + (ok ? r : 0) * stride + c * 8;
    cp_async16(st + L.k + swz(r, c), k + at, ok);
    cp_async16(st + L.v + swz(r, c), v + at, ok);
  }
  // the bias of keys S..sp (at most 8, S % 8 == 0) is -inf: their scores
  // then drop out of the softmax with no test per score
  const float* brow = bias + static_cast<size_t>(it.b) * S;
  for (int i = threadIdx.x; i < sp / 4; i += kThreads) {
    if (4 * i < S) {
      cp_async16(st + L.bias + 16 * i, brow + 4 * i, true);
    } else {
      const float ninf = -INFINITY;
      asm volatile("st.shared.v4.f32 [%0], {%1, %1, %1, %1};\n"
                   ::"r"(st + L.bias + 16 * i), "f"(ninf) : "memory");
    }
  }
}

// Per-lane parts of the ldmatrix addresses. The swizzle XORs a row's
// chunk index with row & 7, and every row a lane addresses is congruent to
// the lane mod 8, so a lane's chunk offsets are fixed: (chunk ^ (lane & 7))
// << 4, with rows 8 apart at compile-time offsets of 1,024 bytes.
struct Lanes {
  uint32_t q;  // A operand of QK^T: rows 16w + lane%16, chunk 2kk + lane/16
  uint32_t k;  // B of QK^T: keys 8j + lane%8 (+8 from lane 16), chunk half
               // (lane/8)%2 of k16 step kk
  uint32_t v;  // B of PV (trans): keys 16c + lane%8 (+8 for (lane/8)%2),
               // d chunk n + lane/16
  int l7, q_hi, k_hi, v_hi;
};

__device__ __forceinline__ uint32_t chunk_off(int chunk, int l7) {
  return static_cast<uint32_t>((chunk ^ l7) << 4);
}

// s = the warp's 16 x 8NT scores against keys key0.. (nkeys of them,
// a multiple of 16), scaled and biased in float32; keys at or past S (by
// their -inf bias), and the tile's unused n8 tiles, are -inf
template <int NT>
__device__ __forceinline__ void tile_scores(float (&s)[NT][4], const Lanes& ln,
                                            const float* bias, int key0,
                                            int nkeys, float scale,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  const uint32_t krow = ln.k + key0 * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(ln.q + chunk_off(2 * kk + ln.q_hi, ln.l7), a);
    const uint32_t kc = krow + chunk_off(2 * kk + ln.k_hi, ln.l7);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (8 * j < nkeys) {
        // n8 tiles j and j+1, k-halves 2kk and 2kk+1 of this k16 step
        uint32_t b[4];
        ldsm_x4(kc + j * 8 * kRowBytes, b);
        mma(s[j], a, b[0], b[1]);
        mma(s[j + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < nkeys) {
      const float2 b = *reinterpret_cast<const float2*>(
          &bias[key0 + 8 * j + 2 * (lane & 3)]);
      s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), b.x);
      s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), b.y);
      s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), b.x);
      s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), b.y);
    } else {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
    }
  }
}

// bf16(e / l) with e / l correctly rounded to float32 first, as
// __fdiv_rn(e, l) then a bf16 rounding gives it, from q = e * r, r = 1 / l
// correctly rounded: q is within 2 float32 ulps of e / l, and float32 to
// bf16 rounding looks only at whether the low 16 bits are above, below or
// at 0x8000, so q rounds to the same bf16 as e / l unless its low bits lie
// within 4 of 0x8000 (about 1 in 8,000 values), which take the division.
__device__ __forceinline__ float prob(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  const unsigned int low = __float_as_uint(q) & 0xffffu;
  return (low - 0x7ffcu <= 8u) ? __fdiv_rn(e, l) : q;
}

// p = bf16(e / l) packed as the mma A operand of PV, one k16 chunk of keys
// per p[c]; l0, l1 the sums of the thread's two rows
template <int NT>
__device__ __forceinline__ void probs(uint32_t (&p)[NT / 2][4],
                                      const float (&e)[NT][4], float l0,
                                      float l1, int nkeys) {
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    if (16 * c < nkeys) {
      p[c][0] = pack_bf16(prob(e[2 * c][0], l0, r0), prob(e[2 * c][1], l0, r0));
      p[c][1] = pack_bf16(prob(e[2 * c][2], l1, r1), prob(e[2 * c][3], l1, r1));
      p[c][2] = pack_bf16(prob(e[2 * c + 1][0], l0, r0),
                          prob(e[2 * c + 1][1], l0, r0));
      p[c][3] = pack_bf16(prob(e[2 * c + 1][2], l1, r1),
                          prob(e[2 * c + 1][3], l1, r1));
    }
  }
}

// o += p . V[key0.., :]
template <int NC>
__device__ __forceinline__ void tile_pv(float (&o)[kD / 8][4],
                                        const uint32_t (&p)[NC][4],
                                        const Lanes& ln, int key0, int nkeys) {
  const uint32_t vrow = ln.v + key0 * kRowBytes;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (16 * c < nkeys) {
#pragma unroll
      for (int n = 0; n < kD / 8; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(vrow + c * 16 * kRowBytes + chunk_off(n + ln.v_hi, ln.l7),
                      b);
        mma(o[n], p[c], b[0], b[1]);
        mma(o[n + 1], p[c], b[2], b[3]);
      }
    }
  }
}

// e = exp(s - m) for the thread's two rows (m0: entries 0, 1; m1: 2, 3)
template <int NT>
__device__ __forceinline__ void exp_rows(float (&s)[NT][4], float m0,
                                         float m1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = expf(__fsub_rn(s[j][0], m0));
    s[j][1] = expf(__fsub_rn(s[j][1], m0));
    s[j][2] = expf(__fsub_rn(s[j][2], m1));
    s[j][3] = expf(__fsub_rn(s[j][3], m1));
  }
}

// the maxima (or sums) over the thread's columns of its two rows
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float& m0,
                                        float& m1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
}

template <int NT>
__device__ __forceinline__ void row_sum(const float (&s)[NT][4], float& l0,
                                        float& l1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
}

// a running (max, sum) of exponentials, rescaled when the max moves
__device__ __forceinline__ void online_update(float& m, float& l, float tm,
                                              float ts) {
  if (tm == -INFINITY) return;  // nothing in this tile
  if (tm > m) {
    l = (m == -INFINITY ? 0.0f : l * expf(__fsub_rn(m, tm)));
    m = tm;
  }
  l += ts * expf(__fsub_rn(tm, m));  // ts is a sum of exp(s - tm)
}

// out rows of the warp from its float32 products with V
__device__ __forceinline__ void store_rows(const float (&o)[kD / 8][4],
                                           __nv_bfloat16* out, Item it, int S,
                                           int N, int warp, int lane) {
  const size_t stride = static_cast<size_t>(N) * kD;
  const int r0 = it.q0 + 16 * warp + (lane >> 2);
  __nv_bfloat16* base =
      out + (static_cast<size_t>(it.b) * S * N + it.n) * kD + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(base + r0 * stride + 8 * n) =
          pack_bf16(o[n][0], o[n][1]);
    }
    if (r0 + 8 < S) {
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * stride + 8 * n) =
          pack_bf16(o[n][2], o[n][3]);
    }
  }
}

// one work item from a landed stage: this warp's 16 query rows. S <= 128
// holds all scores of a row in one tile of 16 n8 tiles; a longer S walks
// key tiles of 64 twice, so that the scores of a tile, the products with V
// and the addresses stay in registers beside each other.
__device__ __forceinline__ void compute_item(uint32_t st, const float* bias,
                                             const Stage& L,
                                             __nv_bfloat16* out, Item it,
                                             int S, int sp, int N,
                                             float scale) {
  constexpr int kLongNT = 8;  // n8 tiles of a key tile when S > 128
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (it.q0 + 16 * warp >= S) return;  // warp-uniform: rows past S only
  Lanes ln;
  ln.l7 = lane & 7;
  ln.q_hi = lane >> 4;
  ln.k_hi = (lane >> 3) & 1;
  ln.v_hi = lane >> 4;
  ln.q = st + (16 * warp + (lane & 15)) * kRowBytes;
  ln.k = st + L.k + (ln.l7 + ((lane >> 4) << 3)) * kRowBytes;
  ln.v = st + L.v + (ln.l7 + (((lane >> 3) & 1) << 3)) * kRowBytes;
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // the thread's two rows, lane/4 and lane/4 + 8: max and sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  if (sp <= kKeyTile) {
    float s[kNT][4];
    tile_scores(s, ln, bias, 0, sp, scale, lane);
    row_max(s, m0, m1);
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    exp_rows(s, m0, m1);
    row_sum(s, l0, l1);
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    uint32_t p[kNT / 2][4];
    probs(p, s, l0, l1, sp);
    tile_pv(o, p, ln, 0, sp);
  } else {
    constexpr int kTile = 8 * kLongNT;
    // pass 1: each thread's running max and sum over its own columns,
    // then merged over the quad
    for (int key0 = 0; key0 < sp; key0 += kTile) {
      const int nkeys = min(kTile, sp - key0);
      float s[kLongNT][4];
      tile_scores(s, ln, bias, key0, nkeys, scale, lane);
      float t0 = -INFINITY, t1 = -INFINITY, u0 = 0.0f, u1 = 0.0f;
      row_max(s, t0, t1);
      exp_rows(s, t0, t1);
      row_sum(s, u0, u1);
      online_update(m0, l0, t0, u0);
      online_update(m1, l1, t1, u1);
    }
    const float q0 = quad_max(m0), q1 = quad_max(m1);
    l0 = quad_sum(m0 == -INFINITY ? 0.0f : l0 * expf(__fsub_rn(m0, q0)));
    l1 = quad_sum(m1 == -INFINITY ? 0.0f : l1 * expf(__fsub_rn(m1, q1)));
    m0 = q0;
    m1 = q1;
    // pass 2: the scores again, normalised by the final max and sum
    for (int key0 = 0; key0 < sp; key0 += kTile) {
      const int nkeys = min(kTile, sp - key0);
      float s[kLongNT][4];
      tile_scores(s, ln, bias, key0, nkeys, scale, lane);
      exp_rows(s, m0, m1);
      uint32_t p[kLongNT / 2][4];
      probs(p, s, l0, l1, nkeys);
      tile_pv(o, p, ln, key0, nkeys);
    }
  }
  store_rows(o, out, it, S, N, warp, lane);
}

__global__ void __launch_bounds__(kThreads, 2)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int B, int S, int N, float scale, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = (S + 15) / 16 * 16;
  const Stage L = stage_layout(sp);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int qtiles = (S + kQRows - 1) / kQRows;
  const int items = B * N * qtiles;
  int i = blockIdx.x;
  if (i >= items) return;
  load_item(base, L, q, k, v, bias, item_of(i, N, qtiles), S, sp, N);
  cp_async_commit();
  for (int buf = 0; i < items; i += gridDim.x) {
    const int next = i + gridDim.x;
    if (ring == 2) {  // the next item's copies fly while this one computes
      if (next < items) {
        load_item(base + (buf ^ 1) * L.bytes, L, q, k, v, bias,
                  item_of(next, N, qtiles), S, sp, N);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this item have landed
    const int off = buf * L.bytes;
    compute_item(base + off,
                 reinterpret_cast<const float*>(smem + off + L.bias), L, out,
                 item_of(i, N, qtiles), S, sp, N, scale);
    __syncthreads();  // the stage is free for the item after next
    if (ring == 2) {
      buf ^= 1;
    } else if (next < items) {
      load_item(base, L, q, k, v, bias, item_of(next, N, qtiles), S, sp, N);
      cp_async_commit();
    }
  }
}

}  // namespace

// q, k, v, out [B, S, N, D] bf16 contiguous, bias [B, S] float32; D = 64,
// S % 8 == 0, S <= 512, every pointer 16-byte aligned.
extern "C" int cocodr_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int B, int S, int N, int D,
                                     float scale, void* stream) {
  if (B <= 0 || S <= 0 || S > kMaxS || S % 8 || N <= 0 || D != kD ||
      static_cast<long long>(B) * N * ((S + kQRows - 1) / kQRows) >
          0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int sp = (S + 15) / 16 * 16;
  const int stage = stage_layout(sp).bytes;
  const int ring = 2 * stage <= kMaxSmem ? 2 : 1;
  const int smem = ring * stage;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // blocks the card holds at once, for the persistent grid; the last
  // query is kept, since consecutive calls share S
  static int dev = -1, last_smem = -1, slots = 0;
  int cur = 0;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, cur);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, attention_kernel, kThreads, smem);
    }
    if (e != cudaSuccess) return e;
    dev = cur;
    last_smem = smem;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long items =
      static_cast<long long>(B) * N * ((S + kQRows - 1) / kQRows);
  const int grid = static_cast<int>(items < slots ? items : slots);
  attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), B, S, N, scale, ring);
  return cudaGetLastError();
}
