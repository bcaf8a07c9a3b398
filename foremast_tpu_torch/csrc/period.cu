// Kernel F: `detect_period`, the seasonal period of B rows in one launch.
//
// Replaces the reference's jitted ops/forecast.py:detect_period (:225-346).
// For each row, in one CTA:
//   1. the masked linear detrend from five sums (count, sum t, sum t^2 in
//      int64; sum x, sum t x in float64), the residuals kept in shared
//      memory;
//   2. for each candidate p, the masked autocorrelation at lag p and, when
//      p >= 4, at p // 2 (each distinct lag once), with the support test
//      sum(w) >= p;
//   3. the half-lag contrast r_p + contrast_margin >= r_{p//2}, the alias
//      margin against the best contrast-passing score, the first eligible
//      candidate, or the row's fallback.
// Candidates with p < 2 or p >= T score -inf and are not eligible.
//
// Two deliberate differences from the reference, in how the numbers are
// summed, not in what is computed: every sum is float64 (or exact int64)
// where the reference sums float32, and the trend is solved from centred
// sums, slope = (sum t x - sum t * mean x) / ((n sum t^2 - (sum t)^2) / n).
// Together they make a constant row's slope exactly 0, so its residuals are
// exactly 0, every candidate scores -inf and the row keeps its fallback;
// the reference's float32 sums leave a ramp of rounding noise there that
// correlates with itself at every lag. Elsewhere the scores agree with the
// reference to float32 rounding (the tests bracket decisions within 1e-5
// of a margin).
//
// What bounds it on an H100: the operations, narrowly. A row reads 5 B per
// slot once; the residuals (4 B) and the mask (1 B) stay in shared memory
// (80 KB at T = 16384, two CTAs per SM; each candidate's score and
// eligibility, 5 B, beside them), and each distinct lag costs ~8
// operations per slot, seven lags for the engine's four candidates. At
// B = 100k, T = 16384 that is ~8.2 GB (2.4 ms at 3.35 TB/s) against ~100 G
// operations (~3 ms at the fp32 instruction rate).
//
// Built with -fmad=false, as the rest of the library.
#include "common.cuh"

namespace fm {

constexpr int kPeriodThreads = 256;
// candidates' scores and eligibility live in shared memory beside the row
constexpr int kMaxCandidates = 1024;
// lags whose autocorrelation a thread remembers; a lag past the cache is
// computed again (the same sums in the same order: the same value)
constexpr int kLagCache = 32;

struct PeriodArgs {
  const float* x;
  const uint8_t* mask;
  const int* cands;
  int C;
  const int* fallback;
  float min_acf;
  float alias_margin;
  float contrast_margin;
  int T;
  int* period;
  float* scores;
};

// Masked autocorrelation of the residuals d at lag p (0 < p < T), or -inf
// where fewer than p pairs support it or the denominator is not positive.
// Called by all threads; every thread gets the result.
__device__ float acf_at(const float* d, const uint8_t* m, int T, int p, Scratch& scr) {
  double num = 0.0, sa = 0.0, sb = 0.0;
  int cnt = 0;
  for (int t = threadIdx.x; t < T - p; t += blockDim.x) {
    const bool both = m[t] && m[t + p];
    const float w = both ? 1.0f : 0.0f;
    const float lead = d[t + p], lag = d[t];
    num += double((w * lead) * lag);
    sa += double((w * lead) * lead);
    sb += double((w * lag) * lag);
    cnt += both;
  }
  num = block_sum(num, scr);
  sa = block_sum(sa, scr);
  sb = block_sum(sb, scr);
  cnt = block_sum(cnt, scr);
  const double den = sqrt(sa * sb);
  const float r = float(num / (den == 0.0 ? 1.0 : den));
  return (cnt >= p && den > 0.0) ? r : -CUDART_INF_F;
}

__global__ void __launch_bounds__(kPeriodThreads) detect_period_kernel(PeriodArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x;
  const size_t off = size_t(row) * T;
  float* d = reinterpret_cast<float*>(smem);
  float* S = d + T;  // (C,) scores
  uint8_t* m = reinterpret_cast<uint8_t*>(S + a.C);
  uint8_t* ok = m + T;  // (C,) contrast-eligible

  // 1. the detrend
  long long n = 0, st = 0, stt = 0;
  double sx = 0.0, stx = 0.0;
  for (int t = tid; t < T; t += blockDim.x) {
    const bool mt = a.mask[off + t];
    const float xf = mt ? a.x[off + t] : 0.0f;
    m[t] = mt;
    d[t] = xf;
    if (mt) {
      n += 1;
      st += t;
      stt += (long long)t * t;
      sx += double(xf);
      stx += double(t) * double(xf);
    }
  }
  n = block_sum(n, scr);
  st = block_sum(st, scr);
  stt = block_sum(stt, scr);
  sx = block_sum(sx, scr);
  stx = block_sum(stx, scr);
  const long long det = n * stt - st * st;
  const double nn = double(n > 0 ? n : 1);
  const double xbar = sx / nn, tbar = double(st) / nn;
  const double slope = det > 0 ? (stx - double(st) * xbar) / (double(det) / nn) : 0.0;
  const float slope_f = float(slope), icept_f = float(xbar - slope * tbar);
  for (int t = tid; t < T; t += blockDim.x)
    d[t] = m[t] ? (d[t] - icept_f) - slope_f * float(t) : 0.0f;
  __syncthreads();

  // 2. scores and contrasts; lags already computed are looked up
  int lag_p[kLagCache];
  float lag_r[kLagCache];
  int n_lags = 0;
  auto acf = [&](int p) {
    for (int i = 0; i < n_lags; ++i)
      if (lag_p[i] == p) return lag_r[i];
    const float r = acf_at(d, m, T, p, scr);
    if (n_lags < kLagCache) {
      lag_p[n_lags] = p;
      lag_r[n_lags] = r;
      ++n_lags;
    }
    return r;
  };
  // every thread computes every score (acf_at is block-wide); thread 0
  // keeps them
  for (int c = 0; c < a.C; ++c) {
    const int p = a.cands[c];
    float sc = -CUDART_INF_F;
    bool good = false;
    if (p >= 2 && p < T) {
      sc = acf(p);
      good = p >= 4 ? sc + a.contrast_margin >= acf(p / 2) : true;
    }
    if (tid == 0) {
      S[c] = sc;
      ok[c] = good;
    }
  }

  // 3. the pick
  if (tid == 0) {
    float best = -CUDART_INF_F;
    for (int c = 0; c < a.C; ++c) best = nan_max(best, ok[c] ? S[c] : -CUDART_INF_F);
    const float cut = nan_max(best - a.alias_margin, a.min_acf);
    int pick = -1;
    for (int c = 0; c < a.C; ++c) {
      a.scores[size_t(row) * a.C + c] = S[c];
      if (pick < 0 && ok[c] && S[c] >= cut) pick = c;
    }
    a.period[row] = pick >= 0 ? a.cands[pick] : a.fallback[row];
  }
}

}  // namespace fm

extern "C" int fm_detect_period(const float* x, const uint8_t* mask, const int* cands, int C,
                                const int* fallback, float min_acf, float alias_margin,
                                float contrast_margin, int B, int T, int* period, float* scores,
                                void* stream) {
  if (C < 0 || C > fm::kMaxCandidates) return int(cudaErrorInvalidValue);
  fm::PeriodArgs a{x, mask, cands, C, fallback, min_acf, alias_margin, contrast_margin, T,
                   period, scores};
  const size_t smem = (size_t(T) + C) * 5;
  cudaError_t e = cudaFuncSetAttribute(fm::detect_period_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::detect_period_kernel<<<B, fm::kPeriodThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
