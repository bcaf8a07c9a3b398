// Device code shared by kernel A (pair_verdict.cu) and kernel N
// (pair_tests.cu): the two sorts of a window pair, the p-value of each
// two-sample test from its sorted-space statistics, and the exact sign test. Both kernels call these
// functions, so the two cannot drift apart; A's outputs are what they were
// when this code lived in pair_verdict.cu.
//
// Two forms of each: the block form (a CTA a pair, T > 256) and the warp
// form (a warp a pair, T <= 256: the second half of this file), which
// gives the block form's outputs bit for bit. Nothing of a pair on the warp
// path waits on a block barrier.
//
// Built with -fmad=false so each float32 expression rounds as the plain
// twins' PyTorch operations do.
#pragma once

#include "common.cuh"

namespace fm {

template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) { return a / (b == T(0) ? T(1) : b); }
__device__ __forceinline__ float clamp01(float p) { return fminf(fmaxf(p, 0.0f), 1.0f); }
__device__ __forceinline__ float norm_sf(float z) { return 0.5f * erfcf(z / 1.4142135623730951f); }

__device__ inline float kolmogorov_sf(float x) {
  if (x < 0.2f) return 1.0f;
  float s = 0.0f;
  for (int k = 1; k <= 64; ++k) {
    const float e = expf(-2.0f * float(k * k) * (x * x));
    s += (k & 1) ? e : -e;
  }
  return clamp01(2.0f * s);
}

// Exact two-sample KS survival P(D >= t/(n1 n2)) by the reference's
// probability-space lattice DP along anti-diagonals d = i + j:
//   B[i][j] = inside(i,j) * (B[i-1][j] * i + B[i][j-1] * j) / d,
// inside iff |i*n2 - j*n1| < t - 0.5. Only the (n1 + 1)(n2 + 1) lattice
// feeds B[n1][n2]: each diagonal runs i over [max(0, d - n2), min(d, n1)],
// and the sweep stops at d = n1 + n2. buf: 2 (n1 + 1) floats.
__device__ inline float ks_exact_sf(long long t, int n1, int n2, float* buf) {
  float* prev = buf;
  float* cur = buf + (n1 + 1);
  for (int i = threadIdx.x; i <= n1; i += blockDim.x) {
    prev[i] = (i == 0 && t > 0) ? 1.0f : 0.0f;
    cur[i] = 0.0f;
  }
  __syncthreads();
  const float fn1 = float(n1), fn2 = float(n2), lim = float(t) - 0.5f;
  for (int d = 1; d <= n1 + n2; ++d) {
    const int imin = max(0, d - n2), imax = min(d, n1);
    const float fd = float(d);
    for (int i = imin + int(threadIdx.x); i <= imax; i += blockDim.x) {
      const float fi = float(i), fj = float(d - i);
      const bool inside = fabsf(fi * fn2 - fj * fn1) < lim;
      const float up = i > 0 ? prev[i - 1] : 0.0f;
      cur[i] = inside ? (up * fi + prev[i] * fj) / fd : 0.0f;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  const float inside_prob = prev[n1];
  __syncthreads();
  return clamp01(1.0f - inside_prob);
}

// The combined sample's rank keys, x's valid members carrying the payload
// bit, padded to n_sort (a power of two >= 2T).
__device__ inline void fill_pair_keys(uint64_t* keys, int n_sort, const float* xb,
                                      const uint8_t* mb, const float* xc, const uint8_t* mc,
                                      int T) {
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
    uint64_t k = kPadKey;
    if (i < T) k = rank_key(xb[i], mb[i], mb[i]);
    else if (i < 2 * T) k = rank_key(xc[i - T], mc[i - T], false);
    keys[i] = k;
  }
}

// Wilcoxon's keys: |x - y| over the pairs valid on both sides with a
// nonzero difference, the sign as payload, padded to n_w (>= T).
__device__ inline void fill_wilcoxon_keys(uint64_t* keys, int n_w, const float* xb,
                                          const uint8_t* mb, const float* xc, const uint8_t* mc,
                                          int T) {
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    uint64_t k = kPadKey;
    if (i < T) {
      const bool both = mb[i] && mc[i];
      const float d = both ? xb[i] - xc[i] : 0.0f;
      const bool nonzero = both && d != 0.0f;
      k = rank_key(fabsf(d), nonzero, nonzero && d > 0.0f);
    }
    keys[i] = k;
  }
}

// Two-sided Mann-Whitney U with tie and continuity corrections, from the
// combined sort's statistics: p, and U1 = R1 - n1 (n1 + 1) / 2.
__device__ inline float mann_whitney_p(const GroupStats& g, int n1, int n2, float* U1_out) {
  const float f1 = float(n1), f2 = float(n2), N = f1 + f2;
  const float R1 = float(g.twice_wsum) * 0.5f, tie = float(g.tie);
  const float U1 = R1 - f1 * (f1 + 1.0f) / 2.0f;
  const float U = fmaxf(U1, f1 * f2 - U1);
  const float mu = f1 * f2 / 2.0f;
  const float s2 = f1 * f2 / 12.0f * ((N + 1.0f) - safe_div(tie, N * (N - 1.0f)));
  const float sd = sqrtf(fmaxf(s2, 0.0f));
  const float z = safe_div(U - mu - 0.5f, sd);
  if (U1_out != nullptr) *U1_out = U1;
  return sd > 0.0f ? clamp01(2.0f * norm_sf(z)) : 1.0f;
}

// Two-group Kruskal-Wallis: p = chi2 sf at df = 1 as erfc(sqrt(H/2)), and H
// (0 where undefined). H in float64, as the twin: a small difference of
// large terms.
__device__ inline float kruskal2_p(const GroupStats& g, int n1, int n2, float* H_out) {
  const double d1 = n1, d2 = n2, dN = d1 + d2, dR1 = double(g.twice_wsum) * 0.5;
  const double dR2 = dN * (dN + 1.0) / 2.0 - dR1, dt = double(g.tie);
  double H = safe_div(12.0, dN * (dN + 1.0)) * (safe_div(dR1 * dR1, d1) + safe_div(dR2 * dR2, d2))
             - 3.0 * (dN + 1.0);
  const double corr = 1.0 - safe_div(dt, dN * dN * dN - dN);
  H = safe_div(H, corr);
  const bool ok = corr > 0.0 && dN > 0.0;
  if (H_out != nullptr) *H_out = ok ? float(H) : 0.0f;
  return ok ? erfcf(sqrtf(fmaxf(float(H), 0.0f) / 2.0f)) : 1.0f;
}

// Two-sided KS p from the integer sup statistic: the exact DP when both
// samples fit ks_exact_max, else Stephens. Called by the whole block (the
// DP syncs); dp may alias the sort's memory, which is done with by then.
__device__ inline float ks_p(const GroupStats& g, int n1, int n2, int ks_exact_max, float* dp) {
  const float f1 = float(n1), f2 = float(n2);
  float p_ks = 1.0f;
  if (n1 > 0 && n2 > 0) {
    if (n1 <= ks_exact_max && n2 <= ks_exact_max) {
      __syncthreads();  // the DP may reuse the sort's shared memory
      p_ks = ks_exact_sf(g.ks_t, n1, n2, dp);
    } else {
      const float D = float(g.ks_t) / (f1 * f2);
      const float en = sqrtf(f1 * f2 / (f1 + f2));
      p_ks = kolmogorov_sf((en + 0.12f + 0.11f / en) * D);
    }
  }
  return p_ks;
}

// Wilcoxon's tie-corrected normal p from the |x - y| sort's statistics
// over nz nonzero paired differences, and W = min(T+, T-) into W_out.
__device__ inline float wilcoxon_normal_p(const GroupStats& gw, int nz, float* W_out) {
  const float n = float(nz), r_plus = float(gw.twice_wsum) * 0.5f, tw = float(gw.tie);
  const float mn = n * (n + 1.0f) / 4.0f;
  const float var = n * (n + 1.0f) * (2.0f * n + 1.0f) / 24.0f - tw / 48.0f;
  const float se = sqrtf(fmaxf(var, 0.0f));
  const float z = safe_div(r_plus - mn, se);
  if (W_out != nullptr) {
    const float total = n * (n + 1.0f) / 2.0f;
    *W_out = fminf(r_plus, total - r_plus);
  }
  return se > 0.0f ? clamp01(2.0f * norm_sf(fabsf(z))) : 1.0f;
}

// The exact null applies to untied, zero-free samples (nz of nblk paired
// slots nonzero) with 1 <= nz <= max_n.
__device__ __forceinline__ bool wilcoxon_exact(const GroupStats& gw, int nz, int nblk, int max_n) {
  return gw.tie == 0 && nblk <= nz && nz >= 1 && nz <= max_n;
}

// Two-sided Wilcoxon signed-rank p from the |x - y| sort's statistics over
// nz nonzero paired differences of nblk paired slots: the exact null from
// the pmf table for untied, zero-free samples with nz <= max_n, else the
// tie-corrected normal approximation. W = min(T+, T-). Called by the whole
// block.
__device__ inline float wilcoxon_p(const GroupStats& gw, int nz, int nblk, const float* table,
                                   int max_n, Scratch& scr, float* W_out) {
  const int tid = threadIdx.x;
  float p_w = wilcoxon_normal_p(gw, nz, W_out);
  if (wilcoxon_exact(gw, nz, nblk, max_n)) {
    const float r_plus = float(gw.twice_wsum) * 0.5f;
    const int W = max_n * (max_n + 1) / 2 + 1;
    const float* P = table + size_t(nz - 1) * W;
    float cdf = 0.0f, sf = 0.0f;
    for (int w = tid; w <= nz * (nz + 1) / 2; w += blockDim.x) {
      const float fw = float(w);
      if (fw <= r_plus + 0.5f) cdf += P[w];
      if (fw >= r_plus - 0.5f) sf += P[w];
    }
    cdf = block_sum(cdf, scr);
    sf = block_sum(sf, scr);
    p_w = clamp01(2.0f * fminf(cdf, sf));
  }
  return p_w;
}

// Exact two-sided paired sign test from its wins and losses: min(1, 2 P(X
// <= min(pos, neg))), X ~ Binom(pos + neg, 1/2), the tail summed in float64
// through lgamma. Called by the whole block.
__device__ inline float sign_test_p(int pos, int neg, Scratch& scr) {
  const int ns = pos + neg, s = min(pos, neg);
  double cdf = 0.0;
  const double nd = double(ns);
  for (int k = threadIdx.x; k <= s; k += blockDim.x) {
    const double kd = double(k);
    cdf += exp(lgamma(nd + 1.0) - lgamma(kd + 1.0) - lgamma(fmax(nd - kd + 1.0, 1.0))
               - nd * 0.6931471805599453);
  }
  cdf = block_sum(cdf, scr);
  return ns > 0 ? clamp01(2.0f * float(cdf)) : 1.0f;
}

// ---------------------------------------------------------------------------
// The warp form: one warp a pair, T <= 256 (kernels.WARP_PAIR_T). The 2T
// rank keys (at most 512) sit in registers, 32 M a warp (M = n / 32 a
// lane, n = max(32, next_pow2(2T))), sorted by warp_bitonic_sort; the tie
// statistics come from warp scans; the KS lattice runs a diagonal a step
// with its cells spread over the lanes; every float sum whose order sets
// its bits is taken as the block form's block of 128 threads takes it
// (block128_sum, block128_scan). Integer statistics take any order.
// ---------------------------------------------------------------------------

// A pair's two windows in registers: slot lane + 32 r of each side in
// register r (R registers, T <= 32 R), with bit r of `in` set where that
// slot is inside T and of mx / my where it is valid on that side. Every
// load of the lane is issued before any is used; the counts and both
// sorts' keys come from here.
template <int R>
struct WarpWindows {
  float x[R], y[R];
  unsigned in, mx, my;
};

template <int R>
__device__ __forceinline__ WarpWindows<R> warp_windows(const float* xb, const uint8_t* mb,
                                                       const float* xc, const uint8_t* mc,
                                                       int T) {
  const int lane = threadIdx.x & 31;
  WarpWindows<R> w;
  uint8_t bx[R], by[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = lane + 32 * r;
    const bool in = g < T;
    w.x[r] = in ? xb[g] : 0.0f;
    w.y[r] = in ? xc[g] : 0.0f;
    bx[r] = in ? mb[g] : 0;
    by[r] = in ? mc[g] : 0;
  }
  w.in = w.mx = w.my = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w.in |= unsigned(lane + 32 * r < T) << r;
    w.mx |= unsigned(bx[r] != 0) << r;
    w.my |= unsigned(by[r] != 0) << r;
  }
  return w;
}

// A pair's counts: valid per side, paired slots, the sign test's wins and
// losses, nonzero paired differences.
struct PairCounts {
  int n1, n2, nblk, pos, neg, nz;
};

template <int R>
__device__ inline PairCounts warp_pair_counts(const WarpWindows<R>& w) {
  int nblk = 0, pos = 0, neg = 0, nz = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((w.mx & w.my) >> r & 1u) {
      const float x = w.x[r], y = w.y[r];
      nblk += 1;
      pos += y > x;
      neg += y < x;
      nz += (x - y) != 0.0f;
    }
  }
  return {warp_sum(__popc(w.mx)), warp_sum(__popc(w.my)), warp_sum(nblk), warp_sum(pos),
          warp_sum(neg), warp_sum(nz)};
}

// fill_pair_keys' keys: the combined sample's 2T keys, x's valid members
// carrying the payload bit, padded with kPadKey. Register r < R holds x's
// slot lane + 32 r, register R + r y's (the sort does not care where a key
// starts); at M = 1 (2T <= 32) lane g holds x's slot g or y's slot g - T.
template <int M, int R>
__device__ __forceinline__ void warp_pair_keys(uint64_t (&k)[M], const WarpWindows<R>& w, int T) {
  if constexpr (M == 1) {
    const int lane = threadIdx.x & 31;
    const float y = __shfl_sync(kFullWarp, w.y[0], (lane - T) & 31);
    const bool my = __shfl_sync(kFullWarp, w.my, (lane - T) & 31) & 1u;
    const bool mx = w.mx & 1u;
    k[0] = lane < T ? rank_key(w.x[0], mx, mx) : lane < 2 * T ? rank_key(y, my, false) : kPadKey;
  } else {
    static_assert(M == 2 * R, "two registers of keys a register of each window");
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = w.in >> r & 1u, mx = w.mx >> r & 1u, my = w.my >> r & 1u;
      k[r] = in ? rank_key(w.x[r], mx, mx) : kPadKey;
      k[R + r] = in ? rank_key(w.y[r], my, false) : kPadKey;
    }
  }
}

// fill_wilcoxon_keys' keys: |x - y| over the pairs valid on both sides
// with a nonzero difference, the sign as payload, padded with kPadKey;
// register r holds slot lane + 32 r.
template <int R>
__device__ __forceinline__ void warp_wilcoxon_keys(uint64_t (&k)[R], const WarpWindows<R>& w) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool both = (w.mx & w.my) >> r & 1u;
    const float d = both ? w.x[r] - w.y[r] : 0.0f;
    const bool nonzero = both && d != 0.0f;
    k[r] = (w.in >> r & 1u) ? rank_key(fabsf(d), nonzero, nonzero && d > 0.0f) : kPadKey;
  }
}

// sorted_group_stats of a warp's sorted keys (position l M + r in lane l,
// register r). A position's inclusive payload count is the lane's running
// count after the warp's exclusive scan of lane totals; the start of its
// tie group comes from a max-scan of (start << 10 | payload count before
// the start) over the group starts, which both grow along the sort. Two
// passes over the lane's keys (totals, then the group ends), so no array
// but the keys is held. Integer sums, so the block form's values.
template <int M>
__device__ inline GroupStats warp_group_stats(const uint64_t (&k)[M], int nvalid, int n1, int n2) {
  const int lane = threadIdx.x & 31, base = lane * M;
  const uint64_t before = __shfl_up_sync(kFullWarp, k[M - 1], 1);
  const uint64_t after = __shfl_down_sync(kFullWarp, k[0], 1);
  int lane_pay = 0, lane_start = 0;  // the lane's payload count; its last start's position + 1
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int i = base + r;
    if (i == 0 || tie_group(k[r]) != tie_group(r > 0 ? k[r - 1] : before)) lane_start = r + 1;
    lane_pay += i < nvalid ? int(k[r] & 1u) : 0;
  }
  const int cx0 = warp_scan(lane_pay, Add<int>()) - lane_pay;
  // the lane's own last start, coded, then the latest start before the lane
  int run = 0;
  if (lane_start > 0) {
    int cx = cx0;
#pragma unroll
    for (int r = 0; r < M; ++r)
      if (r + 1 < lane_start) cx += base + r < nvalid ? int(k[r] & 1u) : 0;
    run = ((base + lane_start - 1) << 10) | cx;
  }
  int code = __shfl_up_sync(kFullWarp, warp_scan(run, Max<int>()), 1);
  code = lane > 0 ? code : 0;
  long long w = 0, tie = 0, ks = 0;
  int cx = cx0;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int e = base + r;
    if (e == 0 || tie_group(k[r]) != tie_group(r > 0 ? k[r - 1] : before)) code = (e << 10) | cx;
    cx += e < nvalid ? int(k[r] & 1u) : 0;
    const uint64_t next = r + 1 < M ? k[r + 1] : after;
    if (e < nvalid && !(e + 1 < nvalid && tie_group(k[r]) == tie_group(next))) {
      const int b = code >> 10;
      const long long t = e - b + 1;
      const long long cxl = cx;
      const long long members = cxl - (code & 1023);
      w += members * (b + e + 2);  // members * 2 * average 1-based rank
      tie += t * t * t - t;
      const long long cy = (e + 1) - cxl;
      const long long d = cxl * n2 - cy * n1;
      ks = max(ks, d < 0 ? -d : d);
    }
  }
  GroupStats g;
  g.twice_wsum = warp_sum(w);
  g.tie = warp_sum(tie);
  g.ks_t = warp_reduce(ks, Max<long long>());
  return g;
}

// a / d rounded to nearest as IEEE division rounds it, through r =
// __frcp_rn(d): the quotient by the reciprocal, then one correction by the
// exact remainder (Markstein). The warp path's KS lattice divides every
// cell of diagonal d by d, so it takes the reciprocal once a step. Equal to
// a / d for every float32 a in [kKsDivMin, 512] and integer d in [1, 512]
// (kernels.ks_division_check() runs all of them on the card); below
// kKsDivMin, near the subnormal quotients where a tie may round otherwise,
// the lattice divides.
constexpr float kKsDivMin = 7.888609052210118e-31f;  // 2^-100
__device__ __forceinline__ float ks_div(float a, float d, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, d, a), r, q);
}
// IEEE a / d, out of line: the rare cells that take it cost a call, and the
// lattice's code stays short.
static __device__ __noinline__ float ks_div_ieee(float a, float d) { return a / d; }

// One register of the lattice's cells: cell i's value from i - 1's (up)
// and its own (cur) on the last diagonal, by ks_exact_sf's expression, 0
// past the window (room < 0).
__device__ __forceinline__ float ks_cell(float up, float cur, float fi, float fd, float rd,
                                         int room) {
  const float fj = fd - fi;
  const float num = up * fi + cur * fj;
  float val = ks_div(num, fd, rd);
  // 0 < num < kKsDivMin, on the bits (num >= +0)
  const bool tiny = unsigned(__float_as_int(num)) - 1u < unsigned(__float_as_int(kKsDivMin)) - 1u;
  if (__any_sync(kFullWarp, tiny))
    val = tiny ? ks_div_ieee(num, fd) : val;  // rare: a quotient near the subnormal range
  return room >= 0 ? val : 0.0f;
}

// Diagonal d's window of ks_exact_sf's lattice: the cells inside the band
// |i (n1 + n2) - d n1| <= tm1 (the block form's float test, exact on these
// integers) and on the lattice, [lo, hi] (empty where lo > hi).
__device__ __forceinline__ int2 ks_window(int d, int n1, int n2, int tm1) {
  const int N = n1 + n2, a_lo = d * n1 - tm1, a_hi = d * n1 + tm1;
  const int blo = a_lo > 0 ? (a_lo + N - 1) / N : -(-a_lo / N), bhi = a_hi / N;
  return make_int2(max(max(0, d - n2), blo), min(min(d, n1), bhi));
}

// ks_exact_sf by one warp, with its lattice values bit for bit. Cell i of
// diagonal d is nonzero only in the diagonal's window (ks_window), which
// moves up by 0 or 1 a step; cells outside it are zero in the block form
// too (set to 0, or never written). The lanes first write each diagonal's
// step into `steps`, the warp's n1 + n2 + 2 int2 of shared memory: its
// window's low end and width, the wider of it and the last window, whether
// it moved up, and the reciprocal its cells divide by. The warp holds the
// window: cell lo + 32 k + l in lane l's register k (NS registers, at least
// ceil((n1 + 1) / 32)), zeros past the window. A step computes each cell by
// the block form's expression from the previous diagonal's cells i - 1 and
// i: while both windows hold at most 31 cells (a null pair's band, ~13
// cells at T = 128) by one rotation of the lanes (lane 31 holds a zero, or
// a cell past the window whose value is dropped); wider, by a shuffle a
// register and one more to carry lane 31 or lane 0 across registers. A
// diagonal of zeros ends the sweep: every later one is zero. Every float of
// a step but the cells is exact: d and i as floats by additions of integers.
template <int NS>
__device__ inline float warp_ks_exact_sf(long long t, int n1, int n2, int2* steps) {
  if (t <= 0) return 1.0f;
  const int lane = threadIdx.x & 31;
  const int N = n1 + n2, tm1 = int(t) - 1;
  for (int d = lane + 1; d <= N; d += 32) {
    const int2 w = ks_window(d, n1, n2, tm1), o = ks_window(d - 1, n1, n2, tm1);
    const int width = w.y - w.x, span = max(o.y - o.x, width);
    const int code = w.x | width << 9 | span << 18 | int(w.x != o.x) << 27 | int(span <= 30) << 28;
    steps[d] = make_int2(w.x > w.y ? -1 : code, __float_as_int(__frcp_rn(float(d))));
  }
  __syncwarp();
  float v[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) v[k] = 0.0f;
  v[0] = lane == 0 ? 1.0f : 0.0f;
  const float flane = float(lane);
  const int below = (lane - 1) & 31, above = (lane + 1) & 31;
  float fd = 0.0f;
  int2 next = steps[1];
  for (int d = 1; d <= N; ++d) {
    const int2 st = next;
    next = steps[d + 1];
    if (st.x < 0) return 1.0f;
    fd += 1.0f;
    const float rd = __int_as_float(st.y);
    const float fbase = float(st.x & 511) + flane;  // cell i of register k: fbase + 32 k
    const int room = (st.x >> 9 & 511) - lane;       // register k's cell is on the window while 32 k <= room
    const bool moved = st.x >> 27 & 1;
    if (st.x >> 28 & 1) {
      // both windows in one register, lane 31 zero in the last: i - 1 (kept)
      // or i (moved up) is one lane away, around the warp
      const float mine = v[0];
      const float other = __shfl_sync(kFullWarp, mine, moved ? above : below);
      v[0] = ks_cell(moved ? mine : other, moved ? other : mine, fbase, fd, rd, room);
    } else if (!moved) {
      // cell i's i - 1 is the lane below's (lane 0: lane 31's of the register before)
      const int span = st.x >> 18 & 511;
      float carry = 0.0f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (32 * k <= span) {
          const float cur = v[k];
          float up = __shfl_up_sync(kFullWarp, cur, 1);
          up = lane == 0 ? carry : up;
          carry = __shfl_sync(kFullWarp, cur, 31);
          v[k] = ks_cell(up, cur, fbase + float(32 * k), fd, rd, room - 32 * k);
        }
      }
    } else {
      // cell i is the lane above's (lane 31: lane 0's of the register
      // after), i - 1 the lane's own
      const int span = st.x >> 18 & 511;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (32 * k <= span) {
          const float up = v[k];
          float cur = __shfl_down_sync(kFullWarp, up, 1);
          const float next_k = k + 1 < NS ? __shfl_sync(kFullWarp, v[k + 1 < NS ? k + 1 : k], 0)
                                          : 0.0f;
          cur = lane == 31 ? next_k : cur;
          v[k] = ks_cell(up, cur, fbase + float(32 * k), fd, rd, room - 32 * k);
        }
      }
    }
  }
  // the last diagonal is cell n1 alone: register 0 of lane 0
  return clamp01(1.0f - __shfl_sync(kFullWarp, v[0], 0));
}

// ks_p by one warp; steps as warp_ks_exact_sf's.
template <int NS>
__device__ inline float warp_ks_p(const GroupStats& g, int n1, int n2, int ks_exact_max,
                                  int2* steps) {
  const float f1 = float(n1), f2 = float(n2);
  float p_ks = 1.0f;
  if (n1 > 0 && n2 > 0) {
    if (n1 <= ks_exact_max && n2 <= ks_exact_max) {
      p_ks = warp_ks_exact_sf<NS>(g.ks_t, n1, n2, steps);
    } else {
      const float D = float(g.ks_t) / (f1 * f2);
      const float en = sqrtf(f1 * f2 / (f1 + f2));
      p_ks = kolmogorov_sf((en + 0.12f + 0.11f / en) * D);
    }
  }
  return p_ks;
}

// wilcoxon_p by one warp: the exact null's two sums as the block of 128
// threads takes them.
__device__ inline float warp_wilcoxon_p(const GroupStats& gw, int nz, int nblk, const float* table,
                                        int max_n, float* W_out) {
  float p_w = wilcoxon_normal_p(gw, nz, W_out);
  if (wilcoxon_exact(gw, nz, nblk, max_n)) {
    const int lane = threadIdx.x & 31, top = nz * (nz + 1) / 2;
    const float r_plus = float(gw.twice_wsum) * 0.5f;
    const float* P = table + size_t(nz - 1) * (max_n * (max_n + 1) / 2 + 1);
    const int live = min(4, top / 32 + 1);
    float cdf[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int q = 0; q < live; ++q) {
      float c = 0.0f, f = 0.0f;
      for (int w = lane + 32 * q; w <= top; w += 128) {
        const float fw = float(w);
        if (fw <= r_plus + 0.5f) c += P[w];
        if (fw >= r_plus - 0.5f) f += P[w];
      }
      put4(cdf, q, c);
      put4(sf, q, f);
    }
    p_w = clamp01(2.0f * fminf(block128_sum(cdf, live), block128_sum(sf, live)));
  }
  return p_w;
}

// sign_test_p by one warp: the float64 tail as the block of 128 threads
// sums it, each term from lg[m] = lgamma(m) (kLgammaTable entries, built
// by the same lgamma: the terms' bits) in place of its three lgamma calls.
constexpr int kLgammaTable = 512;
__device__ inline float warp_sign_test_p(int pos, int neg, const double* lg) {
  const int lane = threadIdx.x & 31, ns = pos + neg, s = min(pos, neg);
  const double nd = double(ns), lg_n = lg[ns + 1];
  const int live = min(4, s / 32 + 1);
  double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 1
  for (int q = 0; q < live; ++q) {
    double c = 0.0;
    for (int k = lane + 32 * q; k <= s; k += 128)
      c += exp(lg_n - lg[k + 1] - lg[max(ns - k + 1, 1)] - nd * 0.6931471805599453);
    put4(part, q, c);
  }
  const double cdf = block128_sum(part, live);
  return ns > 0 ? clamp01(2.0f * float(cdf)) : 1.0f;
}

// The warp path's CTA: kPairWarps pairs (warps), at most 64 registers a
// thread so that kPairWarpBlocks CTAs fit an SM (32 warps; 24 at 80
// registers measured slower, 40 or 48 at 48 or 40 registers no faster).
constexpr int kPairWarps = 4;
constexpr int kPairWarpBlocks = 8;

// Keys a lane on the warp path for the combined sort of 2T keys (M); the
// Wilcoxon sort of T keys takes max(1, M / 2), the KS window M / 2 + 1
// registers (its n1 + 1 <= T + 1 <= 16 M + 1 cells).
__host__ __device__ inline int warp_keys_per_lane(int T) {
  return next_pow2(2 * T) <= 32 ? 1 : next_pow2(2 * T) / 32;
}
template <int M>
struct WarpPair {
  static constexpr int kWilcoxon = M > 1 ? M / 2 : 1;  // also a window's registers
  static constexpr int kCells = M / 2 + 1;
};
// Bytes of a warp's KS steps (2T + 2 int2), rounded to 16.
__host__ __device__ inline size_t warp_steps_bytes(int T) {
  return (size_t(2 * T + 2) * 8 + 15) / 16 * 16;
}

}  // namespace fm
