// Device code shared by kernel A (pair_verdict.cu) and kernel N
// (pair_tests.cu): the two sorts of a window pair, the p-value of each
// two-sample test from its sorted-space statistics, and the exact sign test. Both kernels call these
// functions, so the two cannot drift apart; A's outputs are what they were
// when this code lived in pair_verdict.cu.
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

// Two-sided Wilcoxon signed-rank p from the |x - y| sort's statistics over
// nz nonzero paired differences of nblk paired slots: the exact null from
// the pmf table for untied, zero-free samples with nz <= max_n, else the
// tie-corrected normal approximation. W = min(T+, T-). Called by the whole
// block.
__device__ inline float wilcoxon_p(const GroupStats& gw, int nz, int nblk, const float* table,
                                   int max_n, Scratch& scr, float* W_out) {
  const int tid = threadIdx.x;
  const float n = float(nz), r_plus = float(gw.twice_wsum) * 0.5f, tw = float(gw.tie);
  const float mn = n * (n + 1.0f) / 4.0f;
  const float var = n * (n + 1.0f) * (2.0f * n + 1.0f) / 24.0f - tw / 48.0f;
  const float se = sqrtf(fmaxf(var, 0.0f));
  const float z = safe_div(r_plus - mn, se);
  float p_w = se > 0.0f ? clamp01(2.0f * norm_sf(fabsf(z))) : 1.0f;
  const bool has_zero = nblk > nz;
  if (gw.tie == 0 && !has_zero && nz >= 1 && nz <= max_n) {
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
  if (W_out != nullptr) {
    const float total = n * (n + 1.0f) / 2.0f;
    *W_out = fminf(r_plus, total - r_plus);
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

}  // namespace fm
