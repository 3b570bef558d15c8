// K3: exact top-k along the last axis of a row-major [Q, W] array (float32
// or int32), by radix select.
//
// Replaces cocodr_tpu/ops/pallas_mips.py::_topk_kernel (called through
// pallas_topk), an extract-max loop: k rounds of (row max, the LOWEST index
// holding it, set that slot to neg), the row virtually padded to Wp = W
// rounded up to 128 with neg = finfo(float32).min or iinfo(int32).min. The
// output is that loop's, bit for bit:
//   * values descending, equal values (+0.0 and -0.0 included) lowest
//     index first; each value is the entry's own;
//   * with m entries above neg and m < k, rounds m+1.. return (neg, j*),
//     j* the lowest index among the m extracted entries, the entries equal
//     to neg and the pad slots W..Wp-1; when that set is empty (m = 0, no
//     entry equal to neg, W % 128 = 0: every entry is -inf), round 1
//     returns (x[0], 0) and the later rounds (neg, 0).
//
// Bound on the H100: the function reads the row once and writes k values
// and ids (the search's [1024, 6400] at k = 100 is 27 MB, 8 us at
// 3.35 TB/s); its operations are one compare per entry. Extract-max costs
// k dependent row scans, each ended by a block-wide reduction: 100 at the
// search's k. Design:
//   * order-preserving uint32 keys (float32: negative values with all bits
//     flipped, the others with the sign bit flipped, -0.0 first mapped to
//     +0.0 so the two tie; int32: the sign bit flipped), staged once in
//     shared memory where the row fits (else read from global memory in
//     each pass), with the first digit's histogram and the lowest index
//     the tail rule needs taken on the way in;
//   * an MSB-first radix select with 8-bit digits of the kk-th largest key
//     T among the keys above key(neg), kk = min(k, m): a 256-bin histogram
//     a pass (plain shared atomics), the digit found by one warp's scan,
//     and a stop as soon as the digit's bin holds exactly the entries
//     still needed. After the first digit the entries of its bin and above
//     go to a list when at most kListCap of them do (rows from 2048 wide),
//     and the later passes read the list instead of the row. A row with
//     at most min(128, threads a row) entries above neg skips the digits;
//   * the gather: every key above T in any order, the keys equal to T in
//     index order (an ordered compaction: per-thread counts, warp scans, a
//     scan over the warps' totals);
//   * the order (key descending, index ascending): each candidate counts
//     those before it (at most kRankMax), else a bitonic sort in shared
//     memory; more than kMaxCand candidates go in segments, each the
//     kMaxCand best of the entries after the last one written.
// Threads a row by shape: one warp for rows up to 128 wide (eight rows a
// block), else 128, 256 or 512 as the row widens; few rows (serving) take
// wide blocks for latency.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;           // one 8-bit digit
constexpr int kMaxCand = 2048;       // candidates ordered at once (a segment)
constexpr int kRankMax = 128;        // up to this many, ordered by counting
constexpr int kListCap = 1024;       // entries the list holds
constexpr int kListMinWidth = 2048;  // rows from this Wp may use the list
constexpr int kFewRows = 264;        // up to two rows a multiprocessor
// dynamic shared memory a block may ask for, under the H100's 227 KB
constexpr size_t kMaxDynamicSmem = 200 * 1024;

template <typename T>
struct Keys;

template <>
struct Keys<float> {
  static constexpr uint32_t kNeg = 0x00800000u;  // key(-FLT_MAX)
  __device__ static float neg() { return -FLT_MAX; }
  __device__ static float from_bits(int b) { return __int_as_float(b); }
  __device__ static uint32_t key(float v) {
    uint32_t u = __float_as_uint(v);
    u = u == 0x80000000u ? 0u : u;  // -0.0 ties with +0.0
    return u ^ (static_cast<uint32_t>(static_cast<int>(u) >> 31) |
                0x80000000u);
  }
  // the value of a key; +0.0's key may stand for -0.0: read the entry
  __device__ static float value(uint32_t key, const float* xr, int j) {
    if (key == 0x80000000u) return xr[j];
    return __uint_as_float(key & 0x80000000u ? key ^ 0x80000000u : ~key);
  }
};

template <>
struct Keys<int> {
  static constexpr uint32_t kNeg = 0u;  // key(INT_MIN)
  __device__ static int neg() { return INT_MIN; }
  __device__ static int from_bits(int b) { return b; }
  __device__ static uint32_t key(int v) {
    return static_cast<uint32_t>(v) ^ 0x80000000u;
  }
  __device__ static int value(uint32_t key, const int*, int) {
    return static_cast<int>(key ^ 0x80000000u);
  }
};

// the order of the output: a larger composite comes first (key descending,
// index ascending); every real composite is >= 2^32 since key > kNeg >= 0,
// so 0 pads a sort
__device__ __forceinline__ uint64_t composite(uint32_t key, int j) {
  return (static_cast<uint64_t>(key) << 32) |
         static_cast<uint32_t>(0x7fffffff - j);
}

__device__ __forceinline__ int index_of(uint64_t c) {
  return 0x7fffffff - static_cast<int>(static_cast<uint32_t>(c));
}

__host__ __device__ constexpr int block_threads(int G) {
  return G == 32 ? 256 : G;
}

// G threads take one row: one warp (several rows a block) or the block
template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

struct Scalars {
  int total;  // entries counted in the digit pass's histogram
  int want;   // entries the segment selects
  int d;      // the digit holding the want-th entry
  int above;  // entries in the digit's higher bins
  int hd;     // entries in the digit's bin
  int slot;   // entries appended so far (list or candidates)
  int jstar;  // lowest index whose key is >= key(neg)
};

// per-row shared memory: candidates, the list, keys (staged only), two
// histograms, the warps' counts of one ordered compaction, the scalars
struct Layout {
  size_t list, keys, hist, cnt, scal, bytes;
  __host__ __device__ Layout(int P, int list_cap, int Wp, int G,
                             bool staged) {
    const int rounds = (Wp + 4 * G - 1) / (4 * G);
    list = static_cast<size_t>(P) * sizeof(uint64_t);
    keys = list + static_cast<size_t>(list_cap) * sizeof(uint64_t);
    hist = keys + (staged ? static_cast<size_t>(Wp) * 4 : 0);
    cnt = hist + 2 * kBins * 4;
    scal = cnt + (static_cast<size_t>(rounds) * (G / 32) * 4 + 15) / 16 * 16;
    bytes = (scal + sizeof(Scalars) + 15) / 16 * 16;
  }
};

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// hist[bin] += 1 where p. Plain shared atomics: on the H100 they beat
// warp-aggregated ones (__match_any_sync), also on rows of ties
__device__ __forceinline__ void hist_add(int* hist, uint32_t bin, bool p) {
  if (p) atomicAdd(hist + bin, 1);
}

// append the composites of a thread's entries j..j+3 where p, at slots
// taken from *slot (any order). Every lane of the warp calls it.
__device__ __forceinline__ void push4(uint64_t* out, int* slot,
                                      const uint32_t (&q)[4], int j,
                                      const bool (&p)[4], int lane) {
  const int n = p[0] + p[1] + p[2] + p[3];
  if (!__any_sync(kFull, n)) return;
  const int incl = warp_inclusive(n, lane);
  int base = 0;
  if (lane == 31) base = atomicAdd(slot, incl);
  base = __shfl_sync(kFull, base, 31) + incl - n;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (p[e]) out[base++] = composite(q[e], j + e);
  }
}

// the same for one composite a lane
__device__ __forceinline__ void push1(uint64_t* out, int* slot, uint64_t v,
                                      bool p, int lane) {
  const unsigned b = __ballot_sync(kFull, p);
  if (!b) return;
  const int leader = __ffs(b) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(slot, __popc(b));
  base = __shfl_sync(kFull, base, leader);
  if (p) out[base + __popc(b & ((1u << lane) - 1u))] = v;
}

// one warp: the digit d at which the count of entries in bins >= d,
// scanning from bin 255 down, first reaches want (want < 0: min(k, total,
// kMaxCand), the first pass of a row). Writes the scalars.
__device__ __forceinline__ void find_digit(const int* hist, int want, int k,
                                           int lane, Scalars* S) {
  // lane l holds bins 255 - 8l .. 248 - 8l
  const int4 hi = *reinterpret_cast<const int4*>(hist + kBins - 4 - 8 * lane);
  const int4 lo = *reinterpret_cast<const int4*>(hist + kBins - 8 - 8 * lane);
  const int c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
  const int s = c[0] + c[1] + c[2] + c[3] + c[4] + c[5] + c[6] + c[7];
  const int incl = warp_inclusive(s, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  if (want < 0) want = min(min(k, total), kMaxCand);
  if (lane == 0) {
    S->total = total;
    S->want = want;
    S->slot = 0;
  }
  __syncwarp();
  const int excl = incl - s;
  if (want > 0 && excl < want && incl >= want) {
    int acc = excl;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (acc < want && acc + c[i] >= want) {
        S->d = kBins - 1 - 8 * lane - i;
        S->above = acc;
        S->hd = c[i];
      }
      acc += c[i];
    }
  }
}

// keys of entries j..j+3 (key(neg) past W) from global memory
template <typename T>
__device__ __forceinline__ void load_keys4(const T* xr, int W, bool vec,
                                           int j, uint32_t (&q)[4]) {
  using K = Keys<T>;
  if (vec && j + 3 < W) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(xr + j));
    q[0] = K::key(K::from_bits(v.x));
    q[1] = K::key(K::from_bits(v.y));
    q[2] = K::key(K::from_bits(v.z));
    q[3] = K::key(K::from_bits(v.w));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[e] = j + e < W ? K::key(xr[j + e]) : K::kNeg;
    }
  }
}

// keys of entries j..j+3, key(neg) past Wp
template <typename T, bool kStaged>
__device__ __forceinline__ void keys4(const T* xr, const uint32_t* keys,
                                      int W, int Wp, bool vec, int j,
                                      uint32_t (&q)[4]) {
  if (kStaged) {
    if (j < Wp) {
      const uint4 v = *reinterpret_cast<const uint4*>(keys + j);
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
    } else {
      q[0] = q[1] = q[2] = q[3] = Keys<T>::kNeg;
    }
  } else {
    load_keys4(xr, W, vec, j, q);
  }
}

template <int G>
__device__ __forceinline__ void bitonic_descending(uint64_t* a, int P,
                                                   int t) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < P / 2; i += G) {
        const int lo = 2 * i - (i & (stride - 1));
        const uint64_t x = a[lo], y = a[lo + stride];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[lo + stride] = x;
        }
      }
      group_sync<G>();
    }
  }
}

template <typename T, int G, bool kStaged>
__global__ void __launch_bounds__(block_threads(G))
radix_topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                  int* __restrict__ ids, int Q, int W, int Wp, int k, int P,
                  int list_cap, int row_bytes) {
  using K = Keys<T>;
  constexpr int kWarps = G / 32;
  constexpr uint32_t kNeg = K::kNeg;
  extern __shared__ __align__(16) unsigned char smem[];

  const int t = threadIdx.x % G;
  const int lane = threadIdx.x & 31;
  const int w = t >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * (block_threads(G) / G) +
      threadIdx.x / G;
  if (row >= Q) return;  // whole warps: only one-warp rows end here

  const Layout L(P, list_cap, Wp, G, kStaged);
  unsigned char* base = smem + (threadIdx.x / G) * row_bytes;
  uint64_t* cand = reinterpret_cast<uint64_t*>(base);
  uint64_t* list = reinterpret_cast<uint64_t*>(base + L.list);
  uint32_t* keys = reinterpret_cast<uint32_t*>(base + L.keys);
  int* hist = reinterpret_cast<int*>(base + L.hist);
  int* cnt = reinterpret_cast<int*>(base + L.cnt);
  Scalars* S = reinterpret_cast<Scalars*>(base + L.scal);

  const T* xr = x + row * W;
  T* vr = vals + row * k;
  int* ir = ids + row * k;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;

  // f(q, j) on a thread's keys q of entries j..j+3, round by round in index
  // order (key(neg) past Wp); every lane of a warp calls f equally often
  auto row_pass = [&](auto&& f) {
    for (int b = 0; b < Wp; b += 4 * G) {
      const int j = b + 4 * t;
      uint32_t q[4];
      keys4<T, kStaged>(xr, keys, W, Wp, vec, j, q);
      f(q, j);
    }
  };
  // f(composite, valid) on the n composites of the list, one a thread
  auto list_pass = [&](int n, auto&& f) {
    for (int b = 0; b < n; b += G) {
      const bool v = b + t < n;
      f(v ? list[b + t] : 0ull, v);
    }
  };

  for (int i = t; i < 2 * kBins; i += G) hist[i] = 0;
  if (t == 0) S->jstar = INT_MAX;
  group_sync<G>();

  // the one read of the row: keys staged, the first digit's histogram of
  // the keys above key(neg), and the lowest index whose key is >= key(neg)
  // (pad slots included), which the tail rule needs. The next round's
  // keys load while this round's are counted.
  int jmin = INT_MAX;
  uint32_t q[4];
  load_keys4(xr, W, vec, 4 * t, q);
  for (int b = 0; b < Wp; b += 4 * G) {
    const int j = b + 4 * t;
    uint32_t nq[4] = {kNeg, kNeg, kNeg, kNeg};
    if (b + 4 * G < Wp) load_keys4(xr, W, vec, j + 4 * G, nq);
    if (kStaged && j < Wp) {
      *reinterpret_cast<uint4*>(keys + j) = make_uint4(q[0], q[1], q[2], q[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j + e < Wp && q[e] >= kNeg && jmin == INT_MAX) jmin = j + e;
      hist_add(hist, q[e] >> 24, q[e] > kNeg);
      q[e] = nq[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    jmin = min(jmin, __shfl_xor_sync(kFull, jmin, o));
  }
  if (lane == 0 && jmin != INT_MAX) atomicMin(&S->jstar, jmin);

  int cur = 0;             // the histogram being filled
  int emitted = 0;         // outputs written
  int kk = 0;              // min(k, m)
  uint64_t bound = ~0ull;  // a segment takes composites below it
  bool first = true;
  for (;;) {
    // the entries a segment selects from: above key(neg), and after the
    // last one written
    const bool bounded = !first;
    auto in_r = [&](uint32_t key, int j) {
      return key > kNeg && (!bounded || composite(key, j) < bound);
    };
    // --- radix select of the segment's want-th key -----------------------
    if (!first) {
      row_pass([&](const uint32_t (&q)[4], int j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hist_add(hist + cur * kBins, q[e] >> 24, in_r(q[e], j + e));
        }
      });
    }
    uint32_t prefix = 0;
    int shift = 24, want = 0, rem = 0;
    int n_cand = 0;   // candidates to order: want, or all m <= kRankMax
    int n_list = -1;  // entries in the list (-1: the passes read the row)
    uint64_t lo = 0;  // take every key >= lo
    bool eq = false;  // and the first rem keys == prefix, in index order
    for (;;) {
      group_sync<G>();
      if (w == 0) {
        find_digit(hist + cur * kBins,
                   shift < 24 ? rem
                              : (first ? -1 : min(kk - emitted, kMaxCand)),
                   k, lane, S);
      }
      for (int i = t; i < kBins; i += G) hist[(cur ^ 1) * kBins + i] = 0;
      group_sync<G>();
      if (shift == 24) {
        if (first) kk = min(k, S->total);
        want = rem = n_cand = S->want;
        if (want == 0) break;
        if (first && S->total <= kRankMax && S->total <= G) {
          n_cand = S->total;  // order all m of them, at most one a thread
          break;
        }
      }
      rem -= S->above;
      prefix = (prefix << 8) | static_cast<uint32_t>(S->d);
      if (S->hd == rem) {  // every entry of the bin is needed
        lo = static_cast<uint64_t>(prefix) << shift;
        break;
      }
      if (shift == 0) {  // T = prefix; rem of its S->hd copies are needed
        lo = static_cast<uint64_t>(prefix) + 1;
        eq = true;
        break;
      }
      if (shift == 24 && want - rem + S->hd <= list_cap) {
        // the entries of the digit's bin and above move to the list
        const uint32_t from = prefix << 24;
        row_pass([&](const uint32_t (&q)[4], int j) {
          bool p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = q[e] >= from && in_r(q[e], j + e);
          push4(list, &S->slot, q, j, p, lane);
        });
        n_list = want - rem + S->hd;
        group_sync<G>();
      }
      cur ^= 1;
      shift -= 8;
      if (n_list >= 0) {
        list_pass(n_list, [&](uint64_t c, bool v) {
          const uint32_t key = static_cast<uint32_t>(c >> 32);
          hist_add(hist + cur * kBins, (key >> shift) & 0xffu,
                   v && (key >> (shift + 8)) == prefix);
        });
      } else {
        row_pass([&](const uint32_t (&q)[4], int j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hist_add(hist + cur * kBins, (q[e] >> shift) & 0xffu,
                     (q[e] >> (shift + 8)) == prefix && in_r(q[e], j + e));
          }
        });
      }
    }
    first = false;
    if (want == 0) break;

    // --- gather the candidates -------------------------------------------
    if (n_list >= 0) {
      list_pass(n_list, [&](uint64_t c, bool v) {
        push1(cand, &S->slot, c, v && (c >> 32) >= lo, lane);
      });
    } else {
      row_pass([&](const uint32_t (&q)[4], int j) {
        bool p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = q[e] >= lo && in_r(q[e], j + e);
        push4(cand, &S->slot, q, j, p, lane);
      });
    }
    if (eq) {  // the rem lowest indices holding T, after the want - rem above
      // an ordered compaction: each thread's count of its four entries, a
      // warp scan a round, then a scan over the warps' totals in index order
      int r = 0;
      row_pass([&](const uint32_t (&q)[4], int j) {
        int ne = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) ne += q[e] == prefix && in_r(q[e], j + e);
        const int incl = warp_inclusive(ne, lane);
        if (lane == 31) cnt[r * kWarps + w] = incl;
        ++r;
      });
      group_sync<G>();
      if (w == 0) {
        const int n = r * kWarps;
        int carry = 0;
        for (int b = 0; b < n; b += 32) {
          const int v = b + lane < n ? cnt[b + lane] : 0;
          const int incl = warp_inclusive(v, lane);
          if (b + lane < n) cnt[b + lane] = carry + incl - v;
          carry += __shfl_sync(kFull, incl, 31);
        }
      }
      group_sync<G>();
      r = 0;
      row_pass([&](const uint32_t (&q)[4], int j) {
        bool f[4];
        int ne = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e] = q[e] == prefix && in_r(q[e], j + e);
          ne += f[e];
        }
        int rank = cnt[r * kWarps + w] + warp_inclusive(ne, lane) - ne;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (f[e]) {
            if (rank < rem) cand[want - rem + rank] = composite(q[e], j + e);
            ++rank;
          }
        }
        ++r;
      });
    }
    group_sync<G>();

    // --- order and write them --------------------------------------------
    auto write = [&](int pos, uint64_t c) {
      const int idx = index_of(c);
      vr[emitted + pos] = K::value(static_cast<uint32_t>(c >> 32), xr, idx);
      ir[emitted + pos] = idx;
    };
    if (n_cand <= kRankMax) {
      for (int i = t; i < n_cand; i += G) {
        const uint64_t c = cand[i];
        int r0 = 0, r1 = 0, r2 = 0, r3 = 0, j = 0;
        for (; j + 4 <= n_cand; j += 4) {
          r0 += cand[j] > c;
          r1 += cand[j + 1] > c;
          r2 += cand[j + 2] > c;
          r3 += cand[j + 3] > c;
        }
        for (; j < n_cand; ++j) r0 += cand[j] > c;
        const int r = r0 + r1 + r2 + r3;
        if (r < want) write(r, c);
      }
    } else {
      for (int i = n_cand + t; i < P; i += G) cand[i] = 0;
      group_sync<G>();
      bitonic_descending<G>(cand, P, t);
      for (int i = t; i < want; i += G) write(i, cand[i]);
      bound = cand[want - 1];
    }
    emitted += want;
    if (emitted >= kk) break;
    cur ^= 1;  // zeroed in the last digit pass
    group_sync<G>();
  }

  // --- the tail rule: rounds after the m-th ------------------------------
  if (emitted < k) {
    int js = S->jstar;
    int start = emitted;
    if (js == INT_MAX) {  // nothing extracted, no neg, no pad: all -inf
      js = 0;
      if (t == 0) {
        vr[start] = xr[0];
        ir[start] = 0;
      }
      ++start;
    }
    for (int i = start + t; i < k; i += G) {
      vr[i] = K::neg();
      ir[i] = js;
    }
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the rows' geometry: P candidates (a power of two: the bitonic sort's
// width, and at least kRankMax for a row of few entries above neg), the
// list's capacity, the bytes of one row
struct Geometry {
  int P, list_cap;
  size_t row_bytes;
  Geometry(int Wp, int k, int G, bool staged) {
    P = pow2_at_least(k < kMaxCand ? k : kMaxCand);
    P = P < kRankMax ? kRankMax : P;
    list_cap = Wp >= kListMinWidth ? kListCap : 0;
    row_bytes = Layout(P, list_cap, Wp, G, staged).bytes;
  }
  size_t block_bytes(int G) const {
    return row_bytes * (block_threads(G) / G);
  }
};

template <typename T, int G, bool kStaged>
int launch(const T* x, T* vals, int* ids, int Q, int W, int Wp, int k,
           const Geometry& g, cudaStream_t s) {
  const size_t bytes = g.block_bytes(G);
  auto kernel = radix_topk_kernel<T, G, kStaged>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int rows = block_threads(G) / G;
  kernel<<<(Q + rows - 1) / rows, block_threads(G), bytes, s>>>(
      x, vals, ids, Q, W, Wp, k, g.P, g.list_cap,
      static_cast<int>(g.row_bytes));
  return cudaGetLastError();
}

// staged rows at G threads or, where they do not fit, 512 threads a row
// reading global memory in each pass
template <typename T, int G>
int launch_group(const T* x, T* vals, int* ids, int Q, int W, int Wp, int k,
                 cudaStream_t s) {
  const Geometry staged(Wp, k, G, true);
  if (staged.block_bytes(G) <= kMaxDynamicSmem) {
    return launch<T, G, true>(x, vals, ids, Q, W, Wp, k, staged, s);
  }
  if constexpr (G == 512) {
    const Geometry global(Wp, k, G, false);
    if (global.block_bytes(G) > kMaxDynamicSmem) return cudaErrorInvalidValue;
    return launch<T, G, false>(x, vals, ids, Q, W, Wp, k, global, s);
  } else {
    return launch_group<T, 512>(x, vals, ids, Q, W, Wp, k, s);
  }
}

template <typename T>
int launch_topk(const void* x, void* vals, void* ids, int Q, int W, int k,
                void* stream) {
  if (Q <= 0 || W <= 0 || k <= 0 || k > W) return cudaErrorInvalidValue;
  const int Wp = (W + 127) / 128 * 128;
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(vals);
  int* ip = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // timed on the H100: many rows run best on the fewest threads that keep
  // a pass short, few rows (serving) on wide blocks, for latency
  if (Q <= kFewRows) {
    if (Wp < kListMinWidth) {
      return launch_group<T, 256>(xp, vp, ip, Q, W, Wp, k, s);
    }
    return launch_group<T, 512>(xp, vp, ip, Q, W, Wp, k, s);
  }
  if (Wp <= 128) return launch_group<T, 32>(xp, vp, ip, Q, W, Wp, k, s);
  if (Wp <= 2048) return launch_group<T, 128>(xp, vp, ip, Q, W, Wp, k, s);
  if (Wp <= 8192) return launch_group<T, 256>(xp, vp, ip, Q, W, Wp, k, s);
  return launch_group<T, 512>(xp, vp, ip, Q, W, Wp, k, s);
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
