// Kernel A: the whole canary-pair verdict, one launch for B pairs.
//
// Replaces the reference's jitted, vmapped XLA program
// foremast_tpu/parallel/fleet.py:_pair_verdict / score_pairs (:65, :179),
// with what it fuses: the sorted-space rank view (ops/ranks.py:90),
// two_sample_tests (ops/pairwise.py:447) with the exact KS DP (:69),
// Stephens (:126) and the exact Wilcoxon null (:205), the exact sign test
// (:362), the distribution tails (ops/stats.py) and the moving-average band
// over baseline ++ current (ops/forecast.py:110, fleet.py:137-163).
//
// Design: one CTA of 128 threads per pair. Up to T = 4096 the pair's 2T
// sort entries (2 x 4096 x 16 B = 128 KB) and the band's prefix sums live
// in shared memory. Above that (the 8192 and 16384 buckets, up to 512 KB
// of sort entries a pair) they live in device scratch that the launcher
// allocates, one slot per CTA; the launch then holds at most as many CTAs
// as the scratch budget allows and each walks pairs grid-stride, so the
// scratch stays bounded whatever B is. Only the KS DP's two diagonals
// (at most KS_EXACT_MAX_T + 1 floats each) stay in shared memory there.
//   1. A bitonic sort of 2T 64-bit rank keys (value, class, x-membership)
//      gives the Mann-Whitney / Kruskal rank sum, the tie term and the KS
//      integer statistic from group-end counts (block scans of counts and
//      group starts).
//   2. A second sort of |x - y| over the pairs valid on both sides and
//      nonzero, carrying the sign, gives Wilcoxon's T+ and tie term.
//   3. p-values: erfc for Mann-Whitney and Kruskal (chi2 df=1 as
//      erfc(sqrt(H/2)) = gammaincc(1/2, H/2), H in float64); KS by the anti-diagonal DP
//      when both samples fit KS_EXACT_MAX_T, else Stephens; Wilcoxon's exact
//      null read from a pmf table built once per process; the sign test's
//      binomial tail summed through float64 lgamma.
//   4. Gates, the ALL/ANY combinator and the band: float64 prefix sums of
//      the baseline in shared memory feed ma_predict (common.cuh), sigma is
//      a block reduction, and each current point is checked against the
//      band.
//
// What bounds it on an H100 at T = 128 (the simfleet window), measured
// with the phase stamps below (PERF.md): the KS DP takes half the CTAs'
// cycles, the two bitonic sorts a quarter, the tie-group scans a tenth;
// the ~1.3 KB of inputs per pair (128 MB at B = 100k) are far below all
// of it. The DP is a chain of n1 + n2 ~ 244 dependent diagonal steps, each
// a __syncthreads, so latency rather than the fp32 rate limits it; the
// design answers with many small CTAs per SM (2 KB of shared memory at
// T = 128, 128 threads: 8 resident), so that other pairs' steps fill each
// SM while one waits.
//
// Built with -fmad=false so each float32 expression rounds as the plain
// twin's PyTorch operations do.
#include "common.cuh"

namespace fm {

// 128 threads: at 256 the kernel took 12.6 ms for 100k pairs at T = 128 on
// an H100, at 128 8.1 ms (chip_smoke.py): barrier-bound CTAs gain more
// from twice the resident CTAs per SM than from wider ones.
constexpr int kPairThreads = 128;

struct PairArgs {
  const float* baseline;
  const uint8_t* b_mask;
  const float* current;
  const uint8_t* c_mask;
  const float* pvalue_threshold;
  const int* test_mask;
  const int* combine;
  const int* ma_window;
  const float* band_threshold;
  const int* bound_mode;
  const float* min_lower_bound;
  const int* min_points;
  int min_points_width;
  const float* wilcoxon_table;
  int wilcoxon_max_n;
  int ks_exact_max;
  int T;
  uint8_t* unhealthy;
  float* severity;
  float* pvalues;
  int* band_count;
  float* min_p;
  uint8_t* pairwise_unhealthy;
  uint8_t* band_unhealthy;
  long long* clocks;  // null, or (B, kPairStamps) clock64() stamps per pair
  int B;
  unsigned char* scratch;  // null (shared-memory path), or one slot per CTA
  size_t scratch_stride;
};

// With a.clocks set, thread 0 of each CTA stamps the SM clock at the start
// and after each phase, each stamp past the phase's last block barrier (or
// its block-uniform scalar work): counts, the combined sort, its tie-group
// scans, the Wilcoxon sort, its scans, Mann-Whitney / Kruskal / KS, the
// exact Wilcoxon and sign-test tails, gates and band. The phase names are
// kernels.PAIR_PHASES; null costs one uniform branch per stamp.
constexpr int kPairStamps = 9;

__device__ __forceinline__ void stamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && threadIdx.x == 0) clocks[size_t(row) * kPairStamps + k] = clock64();
}

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
__device__ float ks_exact_sf(long long t, int n1, int n2, float* buf) {
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

// One pair's verdict, by the whole CTA. work holds the sort entries and the
// band's prefix sums, dp the KS DP's two diagonals (shared memory).
__device__ __forceinline__ void pair_row(const PairArgs& a, int row, unsigned char* work,
                                         float* dp, Scratch& scr) {
  const int T = a.T, tid = threadIdx.x;
  const size_t off = size_t(row) * T;
  const float* xb = a.baseline + off;
  const float* xc = a.current + off;
  const uint8_t* mb = a.b_mask + off;
  const uint8_t* mc = a.c_mask + off;
  stamp(a.clocks, row, 0);

  // counts: valid per side, paired blocks, sign-test wins and losses,
  // nonzero paired differences
  int n1 = 0, n2 = 0, nblk = 0, pos = 0, neg = 0, nz = 0;
  for (int i = tid; i < T; i += blockDim.x) {
    const bool bm = mb[i], cm = mc[i];
    n1 += bm;
    n2 += cm;
    if (bm && cm) {
      const float x = xb[i], y = xc[i];
      nblk += 1;
      pos += y > x;
      neg += y < x;
      nz += (x - y) != 0.0f;
    }
  }
  n1 = block_sum(n1, scr);
  n2 = block_sum(n2, scr);
  nblk = block_sum(nblk, scr);
  pos = block_sum(pos, scr);
  neg = block_sum(neg, scr);
  nz = block_sum(nz, scr);
  stamp(a.clocks, row, 1);

  // 1. one sort of the combined sample
  const int n_sort = next_pow2(2 * T);
  uint64_t* keys = reinterpret_cast<uint64_t*>(work);
  int* cnt = reinterpret_cast<int*>(keys + n_sort);
  int* start = cnt + n_sort;
  for (int i = tid; i < n_sort; i += blockDim.x) {
    uint64_t k = kPadKey;
    if (i < T) k = rank_key(xb[i], mb[i], mb[i]);
    else if (i < 2 * T) k = rank_key(xc[i - T], mc[i - T], false);
    keys[i] = k;
  }
  bitonic_sort(keys, n_sort);
  stamp(a.clocks, row, 2);
  const GroupStats g = sorted_group_stats(keys, n1 + n2, n1, n2, cnt, start, scr);
  stamp(a.clocks, row, 3);

  // 2. Wilcoxon: sort |x - y| over the nonzero paired differences
  const int n_w = next_pow2(T);
  __syncthreads();
  for (int i = tid; i < n_w; i += blockDim.x) {
    uint64_t k = kPadKey;
    if (i < T) {
      const bool both = mb[i] && mc[i];
      const float d = both ? xb[i] - xc[i] : 0.0f;
      const bool nonzero = both && d != 0.0f;
      k = rank_key(fabsf(d), nonzero, nonzero && d > 0.0f);
    }
    keys[i] = k;
  }
  bitonic_sort(keys, n_w);
  stamp(a.clocks, row, 4);
  const GroupStats gw = sorted_group_stats(keys, nz, 0, 0, cnt, start, scr);
  stamp(a.clocks, row, 5);

  // 3. p-values (block-uniform scalars)
  const float f1 = float(n1), f2 = float(n2), N = f1 + f2;
  const float R1 = float(g.twice_wsum) * 0.5f, tie = float(g.tie);

  float p_mw;
  {
    const float U1 = R1 - f1 * (f1 + 1.0f) / 2.0f;
    const float U = fmaxf(U1, f1 * f2 - U1);
    const float mu = f1 * f2 / 2.0f;
    const float s2 = f1 * f2 / 12.0f * ((N + 1.0f) - safe_div(tie, N * (N - 1.0f)));
    const float sd = sqrtf(fmaxf(s2, 0.0f));
    const float z = safe_div(U - mu - 0.5f, sd);
    p_mw = sd > 0.0f ? clamp01(2.0f * norm_sf(z)) : 1.0f;
  }
  float p_kw;
  {
    // float64, as the twin: H is a small difference of large terms
    const double d1 = n1, d2 = n2, dN = d1 + d2, dR1 = double(g.twice_wsum) * 0.5;
    const double dR2 = dN * (dN + 1.0) / 2.0 - dR1, dt = double(g.tie);
    double H = safe_div(12.0, dN * (dN + 1.0)) * (safe_div(dR1 * dR1, d1) + safe_div(dR2 * dR2, d2))
               - 3.0 * (dN + 1.0);
    const double corr = 1.0 - safe_div(dt, dN * dN * dN - dN);
    H = safe_div(H, corr);
    const bool ok = corr > 0.0 && dN > 0.0;
    p_kw = ok ? erfcf(sqrtf(fmaxf(float(H), 0.0f) / 2.0f)) : 1.0f;
  }

  float p_ks = 1.0f;
  if (n1 > 0 && n2 > 0) {
    if (n1 <= a.ks_exact_max && n2 <= a.ks_exact_max) {
      __syncthreads();  // the DP may reuse the sort's shared memory
      p_ks = ks_exact_sf(g.ks_t, n1, n2, dp);
    } else {
      const float D = float(g.ks_t) / (f1 * f2);
      const float en = sqrtf(f1 * f2 / (f1 + f2));
      p_ks = kolmogorov_sf((en + 0.12f + 0.11f / en) * D);
    }
  }
  stamp(a.clocks, row, 6);

  float p_w;
  {
    const float n = float(nz), r_plus = float(gw.twice_wsum) * 0.5f, tw = float(gw.tie);
    const float mn = n * (n + 1.0f) / 4.0f;
    const float var = n * (n + 1.0f) * (2.0f * n + 1.0f) / 24.0f - tw / 48.0f;
    const float se = sqrtf(fmaxf(var, 0.0f));
    const float z = safe_div(r_plus - mn, se);
    p_w = se > 0.0f ? clamp01(2.0f * norm_sf(fabsf(z))) : 1.0f;
    const bool has_zero = nblk > nz;
    if (gw.tie == 0 && !has_zero && nz >= 1 && nz <= a.wilcoxon_max_n) {
      const int W = a.wilcoxon_max_n * (a.wilcoxon_max_n + 1) / 2 + 1;
      const float* P = a.wilcoxon_table + size_t(nz - 1) * W;
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
  }

  float p_sign = 1.0f;
  {
    const int ns = pos + neg, s = min(pos, neg);
    double cdf = 0.0;
    const double nd = double(ns);
    for (int k = tid; k <= s; k += blockDim.x) {
      const double kd = double(k);
      cdf += exp(lgamma(nd + 1.0) - lgamma(kd + 1.0) - lgamma(fmax(nd - kd + 1.0, 1.0))
                 - nd * 0.6931471805599453);
    }
    cdf = block_sum(cdf, scr);
    if (ns > 0) p_sign = clamp01(2.0f * float(cdf));
  }
  stamp(a.clocks, row, 7);

  // 4. gates and combinator
  const float pv[5] = {p_mw, p_w, p_kw, p_ks, p_sign};
  const int* mp = a.min_points + size_t(row) * a.min_points_width;
  const float n_min = fminf(f1, f2);
  const float fried_gate = a.min_points_width >= 4 ? float(mp[3]) : 5.0f;
  const bool enough[5] = {n_min >= float(mp[0]), n_min >= float(mp[1]), n_min >= float(mp[2]),
                          n_min >= 2.0f, float(nblk) >= fried_gate};
  const int tmask = a.test_mask[row];
  const float pthr = a.pvalue_threshold[row];
  int n_enabled = 0;
  bool any_reject = false, all_reject = true;
  float min_p = 1.0f;
  for (int k = 0; k < 5; ++k) {
    const bool enabled = (tmask & (1 << k)) && enough[k];
    const bool rejects = pv[k] < pthr && enabled;
    n_enabled += enabled;
    any_reject |= rejects;
    all_reject &= rejects || !enabled;
    if (enabled) min_p = fminf(min_p, pv[k]);
  }
  all_reject &= n_enabled > 0;
  const bool pw_unhealthy = a.combine[row] == 1 ? all_reject : any_reject;

  // band over baseline ++ current: the baseline is the history
  __syncthreads();
  double* S = reinterpret_cast<double*>(work);
  int* C = reinterpret_cast<int*>(S + T + 1);
  const float first = ma_prefix(xb, mb, nullptr, T, S, C, scr);
  const int w = a.ma_window[row];
  float ss = 0.0f;
  for (int t = tid; t < T; t += blockDim.x) {
    if (mb[t]) {
      const float r = xb[t] - ma_predict(S, C, T, t, w, first);
      ss += r * r;
    }
  }
  ss = block_sum(ss, scr);
  const float sigma = n1 >= 2 ? sqrtf(ss / fmaxf(f1, 1.0f)) : CUDART_INF_F;
  const float thr = a.band_threshold[row] * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  int count = 0;
  for (int t = tid; t < T; t += blockDim.x) {
    if (!mc[t]) continue;
    const float p = ma_predict(S, C, T, T + t, w, first);
    const float x = xc[t];
    const bool viol = ((x > p + thr) && (mode & 1)) || ((x < nan_max(p - thr, mlb)) && (mode & 2));
    count += viol;
  }
  count = block_sum(count, scr);
  stamp(a.clocks, row, 8);
  const float frac = float(count) / fmaxf(f2, 1.0f);
  const bool band_unhealthy = frac > 0.3f;

  if (tid == 0) {
    a.unhealthy[row] = pw_unhealthy || band_unhealthy;
    a.severity[row] = -log10f(fmaxf(min_p, 1e-12f)) + frac;
    for (int k = 0; k < 5; ++k) a.pvalues[size_t(row) * 5 + k] = pv[k];
    a.band_count[row] = count;
    a.min_p[row] = min_p;
    a.pairwise_unhealthy[row] = pw_unhealthy;
    a.band_unhealthy[row] = band_unhealthy;
  }
}

// kScratch false: one pair per CTA, its working set in shared memory.
// kScratch true: one slot of device scratch per CTA, pairs grid-stride.
template <bool kScratch>
__global__ void __launch_bounds__(kPairThreads) pair_verdict_kernel(PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  float* dp = reinterpret_cast<float*>(smem);
  if constexpr (kScratch) {
    unsigned char* work = a.scratch + size_t(blockIdx.x) * a.scratch_stride;
    for (int row = blockIdx.x; row < a.B; row += gridDim.x) pair_row(a, row, work, dp, scr);
  } else {
    pair_row(a, blockIdx.x, smem, dp, scr);
  }
}

}  // namespace fm

// Bytes of one pair's working set: the largest of the sort (keys, counts,
// group starts) and the band's prefix sums. In shared memory up to
// T = 4096 (kernels.SHARED_PAIR_T), in a scratch slot above it.
static size_t pair_work_bytes(int T) {
  const size_t sort = size_t(fm::next_pow2(2 * T)) * 16;
  const size_t band = size_t(T + 1) * 12;
  return sort > band ? sort : band;
}

static size_t pair_dp_bytes(int T, int ks_exact_max) {
  return size_t(2) * (size_t(T < ks_exact_max ? T : ks_exact_max) + 1) * 4;
}

extern "C" long long fm_pair_verdict_scratch_stride(int T) {
  return (long long)((pair_work_bytes(T) + 255) / 256 * 256);
}

extern "C" int fm_pair_verdict(
    const float* baseline, const uint8_t* b_mask, const float* current, const uint8_t* c_mask,
    const float* pvalue_threshold, const int* test_mask, const int* combine, const int* ma_window,
    const float* band_threshold, const int* bound_mode, const float* min_lower_bound,
    const int* min_points, int min_points_width, const float* wilcoxon_table, int wilcoxon_max_n,
    int ks_exact_max, int B, int T, uint8_t* unhealthy, float* severity, float* pvalues,
    int* band_count, float* min_p, uint8_t* pairwise_unhealthy, uint8_t* band_unhealthy,
    long long* clocks, unsigned char* scratch, long long scratch_stride, int grid,
    void* stream) {
  fm::PairArgs a{baseline, b_mask, current, c_mask, pvalue_threshold, test_mask, combine,
                 ma_window, band_threshold, bound_mode, min_lower_bound, min_points,
                 min_points_width, wilcoxon_table, wilcoxon_max_n, ks_exact_max, T, unhealthy,
                 severity, pvalues, band_count, min_p, pairwise_unhealthy, band_unhealthy,
                 clocks, B, scratch, size_t(scratch_stride)};
  const size_t dp = pair_dp_bytes(T, ks_exact_max);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (scratch == nullptr) {
    const size_t work = pair_work_bytes(T);
    const size_t smem = work > dp ? work : dp;
    e = cudaFuncSetAttribute(fm::pair_verdict_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::pair_verdict_kernel<false><<<grid, fm::kPairThreads, smem, st>>>(a);
  } else {
    e = cudaFuncSetAttribute(fm::pair_verdict_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dp));
    if (e != cudaSuccess) return int(e);
    fm::pair_verdict_kernel<true><<<grid, fm::kPairThreads, dp, st>>>(a);
  }
  return int(cudaGetLastError());
}

extern "C" const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
