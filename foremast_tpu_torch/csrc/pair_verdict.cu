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
// Three paths with the same outputs bit for bit (kernels.pair_path picks by
// T; a launcher's path= forces one):
//   - warp (T <= 256, every engine and simfleet window): a warp a pair,
//     kPairWarps pairs a CTA, nothing of a pair waiting on a block barrier
//     (pair_common.cuh's warp forms). Each lane loads its slots of the two
//     windows at once into registers; the 2T <= 512 rank keys sit in
//     registers, M = max(32, next_pow2(2T)) / 32 a lane, sorted by a
//     register bitonic network (in-lane below stride M, shfl_xor above);
//     tie statistics come from warp scans. The KS lattice keeps only each
//     diagonal's window of cells the band leaves nonzero (a null pair's
//     ~13 of ~123 at T = 128), one register a lane while it fits 31, each
//     cell divided through the step's reciprocal (equal to IEEE division
//     there: kernels.ks_division_check). Every float sum whose order sets
//     its bits (the band's ss and float64 prefix sums, the exact tails) is
//     added as the CTA path's block of 128 threads adds it (block128_sum,
//     block128_scan); the sign test's lgamma terms come from a table the
//     library's lgamma fills. The code is kept short (loops over one body
//     where registers allow), because a CTA's warps run different phases of
//     it at once and a longer kernel missed the instruction caches.
//   - cta (256 < T <= 4096): one CTA of 128 threads a pair. The pair's 2T
//     sort entries (2 x 4096 x 16 B = 128 KB) and the band's prefix sums
//     live in shared memory.
//   - scratch (T > 4096, the 8192 and 16384 buckets, up to 512 KB of sort
//     entries a pair): the cta path's work in device scratch that the
//     launcher allocates, one slot per CTA; the launch then holds at most
//     as many CTAs as the scratch budget allows and each walks pairs
//     grid-stride, so the scratch stays bounded whatever B is. Only the KS
//     DP's two diagonals (at most KS_EXACT_MAX_T + 1 floats each) stay in
//     shared memory there.
// Each path:
//   1. A bitonic sort of 2T 64-bit rank keys (value, class, x-membership)
//      gives the Mann-Whitney / Kruskal rank sum, the tie term and the KS
//      integer statistic from group-end counts (scans of counts and group
//      starts).
//   2. A second sort of |x - y| over the pairs valid on both sides and
//      nonzero, carrying the sign, gives Wilcoxon's T+ and tie term.
//   3. p-values: erfc for Mann-Whitney and Kruskal (chi2 df=1 as
//      erfc(sqrt(H/2)) = gammaincc(1/2, H/2), H in float64); KS by the anti-diagonal DP
//      when both samples fit KS_EXACT_MAX_T, else Stephens; Wilcoxon's exact
//      null read from a pmf table built once per process; the sign test's
//      binomial tail summed through float64 lgamma.
//   4. Gates, the ALL/ANY combinator and the band: float64 prefix sums of
//      the baseline feed ma_predict (common.cuh), sigma is a reduction,
//      and each current point is checked against the band.
//
// What bounds it on an H100 at T = 128 (the simfleet window), from the
// phase stamps below (PERF.md, NVIDIA H100 80GB HBM3 at 700.00 W): the cta
// path takes 7.3 ms for 100k pairs, 152 k cycles a pair, the KS DP 51%
// (~244 dependent diagonal steps, each a __syncthreads), the sorts 24%,
// their scans 10%, at 7.96 pairs resident an SM: about 450 block barriers a
// pair, latency rather than any rate. The ~1.3 KB of inputs a pair (128 MB
// at B = 100k) are far below all of it. The warp path takes 2.93 ms, 212 k
// cycles a pair at 27.6 resident an SM: the KS lattice 57%, issue-bound
// within 1.1x of its own SASS instructions at the issue rate (1.54 ms).
//
// Built with -fmad=false so each float32 expression rounds as the plain
// twin's PyTorch operations do.
#include "pair_common.cuh"

namespace fm {

// The cta path's 128 threads: at 256 the kernel took 12.6 ms for 100k
// pairs at T = 128 on an H100, at 128 8.1 ms (chip_smoke.py): barrier-bound
// CTAs gain more from twice the resident CTAs per SM than from wider ones.
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
  const double* lgamma_table;  // the warp path: lgamma(m), m < kLgammaTable
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
// the warp path's stamps, by lane 0 of the pair's warp
__device__ __forceinline__ void wstamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && (threadIdx.x & 31) == 0)
    clocks[size_t(row) * kPairStamps + k] = clock64();
}

// The warp path: each warp's slice of shared memory holds the band's prefix
// sums (T + 1 doubles and ints), and before them the KS lattice's steps.
__host__ __device__ inline size_t warp_band_s_bytes(int T) {
  return (size_t(T + 1) * 8 + 15) / 16 * 16;
}
__host__ __device__ inline size_t warp_band_bytes(int T) {
  const size_t band = warp_band_s_bytes(T) + (size_t(T + 1) * 4 + 15) / 16 * 16;
  return band > warp_steps_bytes(T) ? band : warp_steps_bytes(T);
}

// The gates and the ALL/ANY combinator of one pair's five p-values.
struct PairGates {
  bool pw_unhealthy;
  float min_p;
};

__device__ __forceinline__ PairGates pair_gates(const PairArgs& a, int row, const float (&pv)[5],
                                                float f1, float f2, int nblk) {
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
  return {a.combine[row] == 1 ? all_reject : any_reject, min_p};
}

// Whether a current point x lies outside the band around its prediction p.
__device__ __forceinline__ bool band_violation(float x, float p, float thr, float mlb, int mode) {
  return ((x > p + thr) && (mode & 1)) || ((x < nan_max(p - thr, mlb)) && (mode & 2));
}

// One pair's seven outputs, by one thread.
__device__ __forceinline__ void pair_write(const PairArgs& a, int row, const float (&pv)[5],
                                           const PairGates& g, int count, float f2) {
  const float frac = float(count) / fmaxf(f2, 1.0f);
  const bool band_unhealthy = frac > 0.3f;
  a.unhealthy[row] = g.pw_unhealthy || band_unhealthy;
  a.severity[row] = -log10f(fmaxf(g.min_p, 1e-12f)) + frac;
  for (int k = 0; k < 5; ++k) a.pvalues[size_t(row) * 5 + k] = pv[k];
  a.band_count[row] = count;
  a.min_p[row] = g.min_p;
  a.pairwise_unhealthy[row] = g.pw_unhealthy;
  a.band_unhealthy[row] = band_unhealthy;
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
  fill_pair_keys(keys, n_sort, xb, mb, xc, mc, T);
  bitonic_sort(keys, n_sort);
  stamp(a.clocks, row, 2);
  const GroupStats g = sorted_group_stats(keys, n1 + n2, n1, n2, cnt, start, scr);
  stamp(a.clocks, row, 3);

  // 2. Wilcoxon: sort |x - y| over the nonzero paired differences
  const int n_w = next_pow2(T);
  __syncthreads();
  fill_wilcoxon_keys(keys, n_w, xb, mb, xc, mc, T);
  bitonic_sort(keys, n_w);
  stamp(a.clocks, row, 4);
  const GroupStats gw = sorted_group_stats(keys, nz, 0, 0, cnt, start, scr);
  stamp(a.clocks, row, 5);

  // 3. p-values (block-uniform scalars)
  const float f1 = float(n1), f2 = float(n2);
  const float p_mw = mann_whitney_p(g, n1, n2, nullptr);
  const float p_kw = kruskal2_p(g, n1, n2, nullptr);
  const float p_ks = ks_p(g, n1, n2, a.ks_exact_max, dp);
  stamp(a.clocks, row, 6);
  const float p_w = wilcoxon_p(gw, nz, nblk, a.wilcoxon_table, a.wilcoxon_max_n, scr, nullptr);

  const float p_sign = sign_test_p(pos, neg, scr);
  stamp(a.clocks, row, 7);

  // 4. gates and combinator
  const float pv[5] = {p_mw, p_w, p_kw, p_ks, p_sign};
  const PairGates gates = pair_gates(a, row, pv, f1, f2, nblk);

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
    count += band_violation(xc[t], ma_predict(S, C, T, T + t, w, first), thr, mlb, mode);
  }
  count = block_sum(count, scr);
  stamp(a.clocks, row, 8);
  if (tid == 0) pair_write(a, row, pv, gates, count, f2);
}

// One pair's verdict, by one warp (T <= 256): the CTA form's phases in the
// warp forms of pair_common.cuh, the same outputs bit for bit. S and C are
// the band's prefix sums in the warp's own slice of shared memory.
template <int M>
__device__ __forceinline__ void pair_row_warp(const PairArgs& a, int row, double* S, int* C) {
  const int T = a.T, lane = threadIdx.x & 31;
  const size_t off = size_t(row) * T;
  const float* xb = a.baseline + off;
  const float* xc = a.current + off;
  const uint8_t* mb = a.b_mask + off;
  const uint8_t* mc = a.c_mask + off;
  constexpr int R = WarpPair<M>::kWilcoxon;
  wstamp(a.clocks, row, 0);
  const WarpWindows<R> win = warp_windows<R>(xb, mb, xc, mc, T);
  const PairCounts c = warp_pair_counts(win);
  wstamp(a.clocks, row, 1);

  uint64_t k[M];
  warp_pair_keys(k, win, T);
  warp_bitonic_sort(k);
  wstamp(a.clocks, row, 2);
  const GroupStats g = warp_group_stats(k, c.n1 + c.n2, c.n1, c.n2);
  wstamp(a.clocks, row, 3);
  uint64_t kw[R];
  warp_wilcoxon_keys(kw, win);
  warp_bitonic_sort(kw);
  wstamp(a.clocks, row, 4);
  const GroupStats gw = warp_group_stats(kw, c.nz, 0, 0);
  wstamp(a.clocks, row, 5);

  const float f1 = float(c.n1), f2 = float(c.n2);
  const float p_mw = mann_whitney_p(g, c.n1, c.n2, nullptr);
  const float p_kw = kruskal2_p(g, c.n1, c.n2, nullptr);
  // the KS steps in the band's shared memory, which the band fills later
  const float p_ks = warp_ks_p<WarpPair<M>::kCells>(g, c.n1, c.n2, a.ks_exact_max,
                                                    reinterpret_cast<int2*>(S));
  wstamp(a.clocks, row, 6);
  const float p_w = warp_wilcoxon_p(gw, c.nz, c.nblk, a.wilcoxon_table, a.wilcoxon_max_n, nullptr);
  const float p_sign = warp_sign_test_p(c.pos, c.neg, a.lgamma_table);
  wstamp(a.clocks, row, 7);

  const float pv[5] = {p_mw, p_w, p_kw, p_ks, p_sign};
  const PairGates gates = pair_gates(a, row, pv, f1, f2, c.nblk);

  // the band: ss summed as the CTA's 128 threads sum it
  __syncwarp();  // every lane is done with the KS steps
  const float first = warp_ma_prefix(win.x, win.mx, xb, T, S, C);
  const int w = a.ma_window[row];
  // the CTA's thread q 32 + lane sums slots q 32 + lane + 128 j in j's
  // order: slot lane + 32 r goes to q = r % 4 (x read again from device
  // memory, its lines in L1, so that ma_predict is inlined once)
  float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    if (win.mx >> r & 1u) {
      const int t = lane + 32 * r;
      const float res = xb[t] - ma_predict(S, C, T, t, w, first);
      const int q = r & 3;
      put4(ss, q, (q == 0 ? ss[0] : q == 1 ? ss[1] : q == 2 ? ss[2] : ss[3]) + res * res);
    }
  }
  const float sum = block128_sum(ss, min(4, (T - 1) / 32 + 1));
  const float sigma = c.n1 >= 2 ? sqrtf(sum / fmaxf(f1, 1.0f)) : CUDART_INF_F;
  const float thr = a.band_threshold[row] * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  int count = 0;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    if (win.my >> r & 1u) {
      const int t = lane + 32 * r;
      count += band_violation(xc[t], ma_predict(S, C, T, T + t, w, first), thr, mlb, mode);
    }
  }
  count = warp_sum(count);
  wstamp(a.clocks, row, 8);
  if (lane == 0) pair_write(a, row, pv, gates, count, f2);
}

// A warp a pair, kPairWarps pairs a CTA. A tail warp with no pair returns
// at once: nothing on this path waits for another warp.
template <int M>
__global__ void __launch_bounds__(32 * kPairWarps, kPairWarpBlocks)
    pair_verdict_warp_kernel(PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, row = blockIdx.x * kPairWarps + warp;
  if (row >= a.B) return;
  unsigned char* mine = smem + size_t(warp) * warp_band_bytes(a.T);
  pair_row_warp<M>(a, row, reinterpret_cast<double*>(mine),
                   reinterpret_cast<int*>(mine + warp_band_s_bytes(a.T)));
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

// Counts, over every float32 a in [0, 512] (all bit patterns) and every
// integer d in [1, 512], the (a, d) at which the warp path's lattice
// division differs from IEEE division in its bits: out[0] those with
// a >= kKsDivMin (ks_div's own: must be 0, the lattice's cells then equal
// the CTA path's), out[1] those below it (where the lattice divides), out[2]
// the largest such a's bits. The reciprocals come from __frcp_rn as the
// lattice takes them.
__global__ void ks_division_check_kernel(unsigned long long* out) {
  __shared__ float rcp[513];
  for (int d = threadIdx.x; d <= 512; d += blockDim.x) rcp[d] = __frcp_rn(float(d));
  __syncthreads();
  unsigned long long above = 0, below = 0;
  unsigned worst = 0;
  const unsigned last = __float_as_uint(512.0f);
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x; u <= last;
       u += size_t(gridDim.x) * blockDim.x) {
    const float a = __uint_as_float(unsigned(u));
    float fd = 0.0f;
    for (int d = 1; d <= 512; ++d) {
      fd += 1.0f;
      if (__float_as_uint(ks_div(a, fd, rcp[d])) != __float_as_uint(a / fd)) {
        if (a >= kKsDivMin) ++above; else ++below;
        worst = max(worst, unsigned(u));
      }
    }
  }
  if (above) atomicAdd(&out[0], above);
  if (below) atomicAdd(&out[1], below);
  if (worst) atomicMax(&out[2], (unsigned long long)worst);
}

}  // namespace fm

extern "C" int fm_ks_division_check(unsigned long long* out, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  fm::ks_division_check_kernel<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return int(cudaGetLastError());
}

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
                 clocks, B, nullptr, scratch, size_t(scratch_stride)};
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

template <int M>
static cudaError_t launch_pair_warp(const fm::PairArgs& a, int grid, size_t smem,
                                    cudaStream_t st) {
  fm::pair_verdict_warp_kernel<M><<<grid, 32 * fm::kPairWarps, smem, st>>>(a);
  return cudaGetLastError();
}

extern "C" int fm_pair_warps() { return fm::kPairWarps; }

namespace fm {
__global__ void lgamma_table_kernel(double* out) {
  for (int m = threadIdx.x; m < kLgammaTable; m += blockDim.x) out[m] = lgamma(double(m));
}
}  // namespace fm

// lgamma(m) for m < kLgammaTable (m = 0: +inf), the warp path's sign-test
// terms: one launch, once a process a card.
extern "C" int fm_lgamma_table(double* out, void* stream) {
  fm::lgamma_table_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return int(cudaGetLastError());
}

extern "C" int fm_lgamma_table_size() { return fm::kLgammaTable; }

// Kernel A's warp path (T <= 256): grid CTAs of fm_pair_warps() pairs.
extern "C" int fm_pair_verdict_warp(
    const float* baseline, const uint8_t* b_mask, const float* current, const uint8_t* c_mask,
    const float* pvalue_threshold, const int* test_mask, const int* combine, const int* ma_window,
    const float* band_threshold, const int* bound_mode, const float* min_lower_bound,
    const int* min_points, int min_points_width, const float* wilcoxon_table, int wilcoxon_max_n,
    int ks_exact_max, int B, int T, uint8_t* unhealthy, float* severity, float* pvalues,
    int* band_count, float* min_p, uint8_t* pairwise_unhealthy, uint8_t* band_unhealthy,
    long long* clocks, const double* lgamma_table, int grid, void* stream) {
  if (T < 1 || T > 256 || (long long)grid * fm::kPairWarps < B) return int(cudaErrorInvalidValue);
  fm::PairArgs a{baseline, b_mask, current, c_mask, pvalue_threshold, test_mask, combine,
                 ma_window, band_threshold, bound_mode, min_lower_bound, min_points,
                 min_points_width, wilcoxon_table, wilcoxon_max_n, ks_exact_max, T, unhealthy,
                 severity, pvalues, band_count, min_p, pairwise_unhealthy, band_unhealthy,
                 clocks, B, lgamma_table, nullptr, 0};
  const size_t smem = fm::kPairWarps * fm::warp_band_bytes(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fm::warp_keys_per_lane(T)) {
    case 1: return int(launch_pair_warp<1>(a, grid, smem, st));
    case 2: return int(launch_pair_warp<2>(a, grid, smem, st));
    case 4: return int(launch_pair_warp<4>(a, grid, smem, st));
    case 8: return int(launch_pair_warp<8>(a, grid, smem, st));
    default: return int(launch_pair_warp<16>(a, grid, smem, st));
  }
}

extern "C" const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
