// Block-level building blocks shared by the port's kernels (sm_90a).
//
// Most kernels of this library run one CTA per row, so most of what is
// shared here is block-wide: reductions, in-place scans (over shared or
// device memory), a bitonic sort of 64-bit keys, the rank-key encoding and
// the causal moving average (ma_predict), which pair_verdict.cu and
// ma_band.cu both use so that their moving-average semantics cannot drift
// apart. The warp-level helpers at the end (shuffle reductions and scans,
// a register bitonic sort, a warp standing in for a block of 128 threads,
// cp.async copies) serve the kernels that run a warp per row or row group
// (smoothers.cu; kernels A and N's warp path).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace fm {

// The block functions below serve any CTA of whole warps up to kMaxThreads
// threads; each kernel launches at the size that measured best for it.
constexpr int kMaxThreads = 256;

// Scratch every block function below may use: one 8-byte slot per thread.
struct Scratch {
  alignas(8) unsigned char bytes[kMaxThreads * 8];
  template <typename T>
  __device__ T* as() { return reinterpret_cast<T*>(bytes); }
};

template <typename T>
struct Add {
  __device__ T operator()(T a, T b) const { return a + b; }
};
template <typename T>
struct Max {
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
template <typename T>
struct Min {
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// Every thread passes a value and gets the block's total. Called by all
// threads of the block.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  T* w = s.as<T>();
  __syncthreads();  // the previous call's readers are done with the slots
  if (lane == 0) w[warp] = v;
  __syncthreads();
  T r = w[0];
  for (int i = 1; i < int(blockDim.x >> 5); ++i) r = op(r, w[i]);
  return r;
}

template <typename T>
__device__ T block_sum(T v, Scratch& s) { return block_reduce(v, Add<T>(), s); }

// In-place inclusive scan of a[0, n) in shared memory. Each thread scans a
// contiguous chunk, the chunk totals are scanned across the block, and each
// chunk adds its offset. Called by all threads; syncs before and after.
template <typename T, typename Op>
__device__ void block_scan(T* a, int n, Op op, T ident, Scratch& s) {
  __syncthreads();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int per = (n + nt - 1) / nt;
  const int beg = min(tid * per, n), end = min(beg + per, n);
  T acc = ident;
  for (int i = beg; i < end; ++i) {
    acc = op(acc, a[i]);
    a[i] = acc;
  }
  T* tot = s.as<T>();
  tot[tid] = acc;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const T v = tid >= off ? tot[tid - off] : ident;
    __syncthreads();
    tot[tid] = op(tot[tid], v);
    __syncthreads();
  }
  const T pre = tid > 0 ? tot[tid - 1] : ident;
  for (int i = beg; i < end; ++i) a[i] = op(pre, a[i]);
  __syncthreads();
}

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Ascending bitonic sort of a[0, n), n a power of two, in shared memory.
// Not stable; the statistics built on it read only tie-group quantities,
// which do not depend on the order of equal keys.
__device__ inline void bitonic_sort(uint64_t* a, int n) {
  __syncthreads();
  // k unsigned: at n = 2^30 (kernel O's most keys) an int k would overflow
  for (unsigned k = 2; k <= unsigned(n); k <<= 1) {
    for (int j = int(k >> 1); j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = a[i], y = a[ixj];
          if ((x > y) == ((unsigned(i) & k) == 0u)) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Rank key: bits 63..32 the value as an order-preserving unsigned (masked
// slots and NaN mapped to +inf, -0.0 folded into +0.0), bits 2..1 the class
// (valid 0 < valid NaN 1 < masked 2), bit 0 a payload the sort carries.
// A tie group is a run of equal key >> 1. Padding sorts after everything.
constexpr uint64_t kPadKey = ~0ull;

__device__ __forceinline__ uint64_t rank_key(float v, bool valid, bool payload) {
  const bool nan = v != v;
  float k = (valid && !nan) ? v : CUDART_INF_F;
  k = (k == 0.0f) ? 0.0f : k;  // -0.0 and +0.0 are one tie group
  uint32_t b = __float_as_uint(k);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const uint32_t cls = valid ? (nan ? 1u : 0u) : 2u;
  return (uint64_t(b) << 32) | (cls << 1) | (payload ? 1u : 0u);
}

__device__ __forceinline__ uint64_t tie_group(uint64_t key) { return key >> 1; }

// Tie-group statistics of sorted keys whose first nvalid entries are the
// valid ones (the class sorts them first): the rank sum of the payload
// members times two, the tie term sum(t^3 - t), and the KS integer
// statistic max |cx*n2 - cy*n1| over group ends, where cx counts payload
// members <= the group's value. cnt and start are int scratch of nvalid
// entries. All integer, so exact.
struct GroupStats {
  long long twice_wsum;
  long long tie;
  long long ks_t;
};

__device__ inline GroupStats sorted_group_stats(const uint64_t* keys, int nvalid, int n1, int n2,
                                                int* cnt, int* start, Scratch& s) {
  __syncthreads();
  for (int i = threadIdx.x; i < nvalid; i += blockDim.x) {
    cnt[i] = int(keys[i] & 1u);
    start[i] = (i == 0 || tie_group(keys[i]) != tie_group(keys[i - 1])) ? i : 0;
  }
  block_scan(cnt, nvalid, Add<int>(), 0, s);
  block_scan(start, nvalid, Max<int>(), 0, s);
  long long w = 0, tie = 0, ks = 0;
  for (int e = threadIdx.x; e < nvalid; e += blockDim.x) {
    if (e + 1 < nvalid && tie_group(keys[e]) == tie_group(keys[e + 1])) continue;
    const int b = start[e];
    const long long t = e - b + 1;
    const long long cx = cnt[e];
    const long long members = cx - (b > 0 ? cnt[b - 1] : 0);
    w += members * (b + e + 2);  // members * 2 * average 1-based rank
    tie += t * t * t - t;
    const long long cy = (e + 1) - cx;
    const long long d = cx * n2 - cy * n1;
    ks = max(ks, d < 0 ? -d : d);
  }
  GroupStats g;
  g.twice_wsum = block_sum(w, s);
  g.tie = block_sum(tie, s);
  g.ks_t = block_reduce(ks, Max<long long>(), s);
  return g;
}

// Regularized upper incomplete gamma Q(a, x) in float64, a > 0: the series
// of P(a, x) below x = a + 1 (Q = 1 - P), Lentz's continued fraction of Q
// above it (Numerical Recipes, 6.2). Both stop at a relative term of 1e-16,
// within 1000 steps for the a of any chi-square df a launch takes. Q = 1
// at x <= 0, 0 at x = +inf; NaN stays NaN. At a = 0 (a chi-square of df =
// 0, a point mass at 0) Q is 0 for every x >= 0.
__device__ inline double gammaincc(double a, double x) {
  if (x != x) return x;
  if (a == 0.0) return 0.0;
  if (x <= 0.0) return 1.0;
  if (x > 1.0e300) return 0.0;
  const double front = exp(a * log(x) - x - lgamma(a));
  if (x < a + 1.0) {
    double ap = a, del = 1.0 / a, sum = del;
    for (int n = 0; n < 1000; ++n) {
      ap += 1.0;
      del *= x / ap;
      sum += del;
      if (fabs(del) < fabs(sum) * 1e-16) break;
    }
    return 1.0 - sum * front;
  }
  const double tiny = 1e-300;
  double b = x + 1.0 - a, c = 1.0 / tiny, d = 1.0 / b, h = d;
  for (int i = 1; i < 1000; ++i) {
    const double an = -double(i) * (double(i) - a);
    b += 2.0;
    d = an * d + b;
    if (fabs(d) < tiny) d = tiny;
    c = b + an / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < 1e-16) break;
  }
  return front * h;
}

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
struct NanMax {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};
// jnp.minimum, likewise.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// Every thread passes K values and gets the block's K totals, with one pair
// of barriers for all K (K times the warps must fit the Scratch's 256
// slots). The order of the additions is fixed, so a row sums the same way
// in every launch.
template <int K>
__device__ void block_sum_n(double (&v)[K], Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = int(blockDim.x >> 5);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
  double* w = s.as<double>();
  __syncthreads();  // the previous call's readers are done with the slots
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) w[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double r = w[k];
    for (int i = 1; i < nw; ++i) r += w[i * K + k];
    v[k] = r;
  }
}

// One step of warp_sum_scatter, at lane offset 16 >> STEP, and the rest.
template <int K, int STEP>
__device__ __forceinline__ void warp_sum_scatter_step(double (&v)[K], int lane) {
  constexpr int o = 16 >> STEP, h = (K >> STEP) / 2;
  if constexpr (h >= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const double recv = __shfl_xor_sync(0xffffffffu, upper ? v[j] : v[h + j], o);
      v[j] = (upper ? v[h + j] : v[j]) + recv;
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
  if constexpr (STEP < 4) warp_sum_scatter_step<K, STEP + 1>(v, lane);
}

// A warp's totals of K float64 values a lane (K a power of two, at most
// 32), each by block_sum's tree: a butterfly over the lanes at offsets 16
// down to 1 (the pairs shfl_down's tree adds), whose first log2(K) steps
// each send a partner the half of the values it keeps, so a lane shuffles
// K - 1 values in all where block_sum_n shuffles 5 K. Returns in each lane
// the warp's total of value lane >> (5 - log2 K). A block's total of value
// k is then the warps' totals added in warp order, as block_sum_n adds
// them. Each step is its own instance, so every index is a constant and v
// stays in registers.
template <int K>
__device__ __forceinline__ double warp_sum_scatter(double (&v)[K]) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K is a power of two up to 32");
  warp_sum_scatter_step<K, 0>(v, threadIdx.x & 31);
  return v[0];
}

// ---------------------------------------------------------------------------
// Causal time-based moving average (the reference's _moving_average_1d).
//
// S[j] and C[j] (j = 0..n) are the float64 sum and the count of the history
// values in slots [0, j); slots >= n hold no history. The prediction for
// slot t is the mean of the history in [t - w, t). Where that window is
// empty it freezes at the mean of the window ending just after the last
// observation before t, or, before the first observation, at `first`. A
// window w < 1 is empty everywhere (the mean of an empty window is 0).
//
// Sums are float64 prefix differences: a constant history gives its level
// exactly, so its residuals and sigma are exactly 0.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ma_mean(const double* S, const int* C, int lo, int hi) {
  const int c = C[hi] - C[lo];
  return c > 0 ? float((S[hi] - S[lo]) / double(c)) : 0.0f;
}

__device__ inline float ma_predict(const double* S, const int* C, int n, int t, int w,
                                   float first) {
  const int hi = min(t, n);
  const int lo = min(max(t - w, 0), hi);
  if (C[hi] > C[lo]) return ma_mean(S, C, lo, hi);
  const int k = C[hi];  // observations before t
  if (k == 0) return first;
  // j = 1 + the last observation before t = the smallest j with C[j] >= k
  int a = 0, b = hi;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (C[mid] >= k) b = mid; else a = mid + 1;
  }
  return ma_mean(S, C, min(max(a - w, 0), a), a);
}

// Fill S[0..n] and C[0..n] from the n history slots (x where hist, else
// nothing), and return the first history value (0 when there is none).
// x and hist are global; called by all threads.
__device__ inline float ma_prefix(const float* x, const uint8_t* hist_a, const uint8_t* hist_b,
                                  int n, double* S, int* C, Scratch& s) {
  // hist = hist_a[i] && !hist_b[i] (hist_b may be null)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool h = hist_a[i] && !(hist_b != nullptr && hist_b[i]);
    S[i + 1] = h ? double(x[i]) : 0.0;
    C[i + 1] = h ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    S[0] = 0.0;
    C[0] = 0;
  }
  block_scan(S + 1, n, Add<double>(), 0.0, s);
  block_scan(C + 1, n, Add<int>(), 0, s);
  if (C[n] == 0) return 0.0f;
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (C[mid] >= 1) b = mid; else a = mid + 1;
  }
  return x[a - 1];
}

// ---------------------------------------------------------------------------
// Warp-level helpers.
// ---------------------------------------------------------------------------
constexpr unsigned kFullWarp = 0xffffffffu;

// Every lane passes a value and gets the warp's total (xor butterfly).
// Every lane's float total has the bits lane 0 of block_reduce's
// shfl_down tree gets: lane 0 adds the same pairs, and at each level the
// lanes of a group add the same two halves in either order.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullWarp, v, o);
  return v;
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll 1
  for (int s = 4; s >= 0; --s) v = op(v, __shfl_xor_sync(kFullWarp, v, 1 << s));
  return v;
}

// warp_sum as a loop of one body: the same additions, less code where it
// is called many times.
template <typename T>
__device__ __forceinline__ T warp_sum_rolled(T v) {
#pragma unroll 1
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullWarp, v, o);
  return v;
}

// Inclusive scan over the lanes (Hillis-Steele by shfl_up).
template <typename T, typename Op>
__device__ __forceinline__ T warp_scan(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int s = 0; s < 5; ++s) {
    const T u = __shfl_up_sync(kFullWarp, v, 1 << s);
    if (lane >= (1 << s)) v = op(v, u);
  }
  return v;
}

// p[q] = v for a q known only at run time, by selects: p stays in
// registers, and a loop over q need not be unrolled.
template <typename T>
__device__ __forceinline__ void put4(T (&p)[4], int q, T v) {
  p[0] = q == 0 ? v : p[0];
  p[1] = q == 1 ? v : p[1];
  p[2] = q == 2 ? v : p[2];
  p[3] = q == 3 ? v : p[3];
}

// One warp standing in for a block of 128 threads (kernels A and N at
// T <= 256): virtual thread v = lane + 32 q, q < 4, is lane `lane`'s q-th.
//
// block_sum's total of the virtual threads' values p[q]: each virtual
// warp's shfl_down tree (warp_sum gives its bits), then the four totals
// added in warp order. p[q] for q >= live must be +0.0, whose trees are
// skipped (a tree of zeros is +0.0).
template <typename T>
__device__ __forceinline__ T block128_sum(T (&p)[4], int live) {
  T w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = q < live ? warp_sum_rolled(p[q]) : T(0);
  return ((w[0] + w[1]) + w[2]) + w[3];
}

// block_scan(a, n, Add<T>(), 0, s) as a block of 128 threads computes it,
// in place on a[0, n) in the warp's shared memory: virtual thread v scans
// its chunk [v per, v per + per), per = ceil(n / 128), from 0; a
// Hillis-Steele scan over the 128 chunk totals, each step from the last
// step's values (adding 0 below the offset, as the block does); each chunk
// then adds the total before it. The same additions in the same order, so
// the same bits. Called by the whole warp after a[] is written; ends with
// __syncwarp.
template <typename T>
__device__ void block128_scan(T* a, int n) {
  const int lane = threadIdx.x & 31, per = (n + 127) / 128;
  T tot[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int beg = min((lane + 32 * q) * per, n), end = min(beg + per, n);
    T acc = T(0);
    for (int i = beg; i < end; ++i) {
      acc = acc + a[i];
      a[i] = acc;
    }
    tot[q] = acc;
  }
  // offsets 1-16: from lane - off of the same q, or of q - 1 below the offset
#pragma unroll 1
  for (int s = 0; s < 5; ++s) {
    const int off = 1 << s;
    T r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = __shfl_sync(kFullWarp, tot[q], (lane - off) & 31);
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[q] = tot[q] + (lane >= off ? r[q] : q > 0 ? r[q - 1] : T(0));
  }
  // offsets 32 and 64: the same lane, q - 1 and q - 2 (q descending: old values)
  tot[3] = tot[3] + tot[2];
  tot[2] = tot[2] + tot[1];
  tot[1] = tot[1] + tot[0];
  tot[0] = tot[0] + T(0);
  tot[3] = tot[3] + tot[1];
  tot[2] = tot[2] + tot[0];
  tot[1] = tot[1] + T(0);
  tot[0] = tot[0] + T(0);
  T r[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = __shfl_sync(kFullWarp, tot[q], (lane - 1) & 31);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T pre = lane >= 1 ? r[q] : q > 0 ? r[q - 1] : T(0);
    const int beg = min((lane + 32 * q) * per, n), end = min(beg + per, n);
    for (int i = beg; i < end; ++i) a[i] = pre + a[i];
  }
  __syncwarp();
}

// ma_prefix(x, hist, nullptr, n, S, C, s) by one warp standing in for a
// block of 128 threads, from the history in registers (slot lane + 32 r in
// x[r], bit r of hist where it is history, n <= 32 R): the same S bit for
// bit (block128_scan), the same C and the same first history value
// (read from xg, the history in device memory). S and C are the warp's own
// shared memory.
template <int R>
__device__ inline float warp_ma_prefix(const float (&x)[R], unsigned hist, const float* xg,
                                       int n, double* S, int* C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < n) {
      const bool h = hist >> r & 1u;
      S[i + 1] = h ? double(x[r]) : 0.0;
      C[i + 1] = h ? 1 : 0;
    }
  }
  if (lane == 0) {
    S[0] = 0.0;
    C[0] = 0;
  }
  __syncwarp();
  block128_scan(S + 1, n);
  block128_scan(C + 1, n);
  if (C[n] == 0) return 0.0f;
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (C[mid] >= 1) b = mid; else a = mid + 1;
  }
  return xg[a - 1];
}

// One in-lane compare-exchange of a bitonic step: keys a (the lower
// position) and b, ascending where up.
template <typename K>
__device__ __forceinline__ void bitonic_ce(K& a, K& b, bool up) {
  const K x = a, y = b;
  if constexpr (sizeof(K) == 4) {
    // 32-bit keys: the pair's minimum and maximum, then their places
    const bool lt = x < y;
    const K lo = lt ? x : y, hi = lt ? y : x;
    a = up ? lo : hi;
    b = up ? hi : lo;
  } else {
    const bool sw = (x > y) == up;
    a = sw ? y : x;
    b = sw ? x : y;
  }
}

// Ascending bitonic sort of a warp's 32 M keys (64- or 32-bit) in registers: key r
// of lane l sits at network position l M + r, so compare-exchanges at a
// stride below M stay in the lane and those at M and above pair lanes by
// shfl_xor. M is a power of two. The runs up to M are sorted in the lane,
// every index a constant; each longer run then takes its cross-lane strides
// in a loop over one body and its in-lane strides unrolled, so the code
// stays short (a kernel's warps run different parts of it at once) and k
// stays in registers. The sorted keys end in the same order of positions.
template <int M, typename K>
__device__ __forceinline__ void warp_bitonic_sort(K (&k)[M]) {
  constexpr int kLogM = M >= 16 ? 4 : M >= 8 ? 3 : M >= 4 ? 2 : M >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ls = 1; ls <= kLogM; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
#pragma unroll
      for (int r = 0; r < M; ++r)
        if ((r & (1 << lj)) == 0)
          bitonic_ce(k[r], k[r | (1 << lj)], ((lane * M + r) & (1 << ls)) == 0);
    }
  }
#pragma unroll 1
  for (int size = 2 * M; size <= 32 * M; size <<= 1) {
    const bool up = ((lane * M) & size) == 0;  // r < M never reaches size's bit
#pragma unroll 1
    for (int lm = size / (2 * M); lm >= 1; lm >>= 1) {
      // the partner lane is lane ^ lm; the lower position keeps the smaller
      // key in an ascending run
      const bool keep_min = ((lane & lm) == 0) == up;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const K o = __shfl_xor_sync(kFullWarp, k[r], lm);
        if constexpr (sizeof(K) == 4)
          k[r] = (o < k[r]) == keep_min ? o : k[r];
        else
          k[r] = (keep_min ? o < k[r] : o > k[r]) ? o : k[r];
      }
    }
#pragma unroll
    for (int lj = kLogM - 1; lj >= 0; --lj) {
#pragma unroll
      for (int r = 0; r < M; ++r)
        if ((r & (1 << lj)) == 0) bitonic_ce(k[r], k[r | (1 << lj)], up);
    }
  }
}

// ---------------------------------------------------------------------------
// Thread block clusters (sm_90): a CTA's rank in its cluster; a barrier over
// every thread of the cluster (release, then acquire: shared-memory writes
// before the arrival, local or remote, are seen after the wait), whole or
// split so that work between arrive and wait overlaps it; the address of the same
// shared-memory location in another CTA of the cluster (distributed shared
// memory, written through the generic pointer mapa gives); and a launch
// with clusters of cl CTAs along x.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrival that orders no memory: the wait that pairs with it only says
// that every thread of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  T* q;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(q) : "l"(p), "r"(rank));
  return q;
}
template <typename... Args>
__host__ inline cudaError_t launch_cluster(void (*kernel)(Args...), int grid, int block,
                                           size_t smem, cudaStream_t stream, int cl,
                                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Float64 tensor-core products of one warp (DMMA; m16n8k4 on sm_90),
// accumulating in place, D = A B + D. The fragments are PTX's, with
// g = lane >> 2 and t = lane & 3:
//   m8n8k4:  a[0] = A[g][t]; b[0] = B[t][g]; d[i] = D[g][2t + i]
//   m16n8k4: a[0] = A[g][t], a[1] = A[g + 8][t]; b[0] = B[t][g];
//            d[i] = D[g][2t + i], d[2 + i] = D[g + 8][2t + i]
__device__ __forceinline__ void mma_f64_m8n8k4(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
               "{%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma_f64_m16n8k4(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, "
               "{%6}, {%0, %1, %2, %3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// Asynchronous 4-, 8- and 16-byte copies from device to shared memory (sm_80+;
// the 16-byte one bypasses L1):
// a warp issues a tile's loads back to back and waits once.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// a ring of stages: commit closes the copies issued since the last commit
// into a group; wait_group<N> waits until at most N groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fm
