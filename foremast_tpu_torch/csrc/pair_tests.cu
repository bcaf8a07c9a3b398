// Kernel N: the public two-sample test battery, one launch for B pairs.
//
// Replaces the reference's jitted, vmapped XLA programs
// foremast_tpu/ops/pairwise.py:all_pairwise_tests (:533, the fused
// two_sample_tests :447), mann_whitney_u_batch, wilcoxon_batch and
// ks_2samp_batch (:525-529; ks_2samp :408): Mann-Whitney U1, the two-group
// Kruskal-Wallis H, the Wilcoxon signed-rank W and the KS D of each pair,
// each with its two-sided p-value; and the exact sign test (sign_test_exact
// :362) for the public single form on the card.
//
// Design: kernel A's pair machinery without its gates and band
// (pair_common.cuh holds what the two share), on kernel A's three paths
// with the same bits: a warp a pair up to T = 256 (kPairWarps pairs a CTA,
// the keys in registers, the KS lattice's band across the lanes, its
// steps in shared memory), a CTA of 128 threads a pair up to T = 4096 (the sort entries in
// shared memory), and above it the same from device scratch, one slot per
// CTA, the CTAs walking the pairs grid-stride. A bitmask says which tests to
// run: Mann-Whitney, Kruskal-Wallis and KS read one bitonic sort of the 2T
// rank keys, Wilcoxon a second sort of |x - y|, the sign test only the
// counts; a launch that asks for neither sorting part skips its sort.
//
// What bounds it on an H100 at T = 128 (PERF.md, NVIDIA H100 80GB HBM3 at
// 700.00 W): on the CTA path, as kernel A, the exact KS DP's chain of
// barriers (n1 + n2 dependent diagonal steps) and the two sorts, not the
// ~1 KB of inputs a pair: 6.446 ms for the four tests of 100k pairs, 5.562
// for KS alone, 1.587 for Mann-Whitney alone, 0.957 for Wilcoxon alone. The
// warp path removes the barriers and cuts the DP to the band: 2.36, 2.05,
// 0.52 and 0.27 ms, the KS lattice 70% of a pair's cycles.
#include "pair_common.cuh"

namespace fm {

constexpr int kTestsThreads = 128;
// the tests bitmask, and each test's column in the (B, kTests) outputs
constexpr int kTestMannWhitney = 1, kTestKruskal = 2, kTestWilcoxon = 4, kTestKs = 8,
              kTestSign = 16;
constexpr int kTests = 5;

struct TestsArgs {
  const float* x;
  const uint8_t* xm;
  const float* y;
  const uint8_t* ym;
  int B, T, tests;
  const float* wilcoxon_table;
  int wilcoxon_max_n;
  int ks_exact_max;
  float* stat;  // (B, kTests): U1, H, W, D, n untied
  float* p;     // (B, kTests)
  unsigned char* scratch;
  size_t scratch_stride;
  long long* clocks;  // the warp path: null, or (B, kTestsStamps) clock64() stamps a pair
  const double* lgamma_table;  // the warp path: lgamma(m), m < kLgammaTable
};

// The warp path's stamps, by lane 0 of the pair's warp: the start and the
// end of each phase of kernels.TESTS_PHASES (kernel A's phases but its
// gates and band: counts, the combined sort, its scans, the Wilcoxon sort,
// its scans, Mann-Whitney / Kruskal / KS, the exact tails); a phase a
// launch skips takes no time.
constexpr int kTestsStamps = 8;

__device__ __forceinline__ void tstamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && (threadIdx.x & 31) == 0)
    clocks[size_t(row) * kTestsStamps + k] = clock64();
}

__device__ __forceinline__ void tests_row(const TestsArgs& a, int row, unsigned char* work,
                                          float* dp, Scratch& scr) {
  const int T = a.T, tid = threadIdx.x;
  const size_t off = size_t(row) * T;
  const float* xb = a.x + off;
  const float* xc = a.y + off;
  const uint8_t* mb = a.xm + off;
  const uint8_t* mc = a.ym + off;
  int n1 = 0, n2 = 0, nblk = 0, nz = 0, pos = 0, neg = 0;
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
  nz = block_sum(nz, scr);
  pos = block_sum(pos, scr);
  neg = block_sum(neg, scr);

  uint64_t* keys = reinterpret_cast<uint64_t*>(work);
  const bool combined = a.tests & (kTestMannWhitney | kTestKruskal | kTestKs);
  GroupStats g{0, 0, 0}, gw{0, 0, 0};
  if (combined) {
    const int n_sort = next_pow2(2 * T);
    int* cnt = reinterpret_cast<int*>(keys + n_sort);
    fill_pair_keys(keys, n_sort, xb, mb, xc, mc, T);
    bitonic_sort(keys, n_sort);
    g = sorted_group_stats(keys, n1 + n2, n1, n2, cnt, cnt + n_sort, scr);
  }
  if (a.tests & kTestWilcoxon) {
    const int n_w = next_pow2(T);
    int* cnt = reinterpret_cast<int*>(keys + n_w);
    __syncthreads();
    fill_wilcoxon_keys(keys, n_w, xb, mb, xc, mc, T);
    bitonic_sort(keys, n_w);
    gw = sorted_group_stats(keys, nz, 0, 0, cnt, cnt + n_w, scr);
  }
  float st[kTests] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, pv[kTests] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  if (a.tests & kTestMannWhitney) pv[0] = mann_whitney_p(g, n1, n2, &st[0]);
  if (a.tests & kTestKruskal) pv[1] = kruskal2_p(g, n1, n2, &st[1]);
  if (a.tests & kTestWilcoxon)
    pv[2] = wilcoxon_p(gw, nz, nblk, a.wilcoxon_table, a.wilcoxon_max_n, scr, &st[2]);
  if (a.tests & kTestKs) {
    pv[3] = ks_p(g, n1, n2, a.ks_exact_max, dp);
    st[3] = safe_div(float(g.ks_t), float(n1) * float(n2));
  }
  if (a.tests & kTestSign) {
    pv[4] = sign_test_p(pos, neg, scr);
    st[4] = float(pos + neg);
  }
  if (tid == 0) {
    for (int k = 0; k < kTests; ++k) {
      a.stat[size_t(row) * kTests + k] = st[k];
      a.p[size_t(row) * kTests + k] = pv[k];
    }
  }
  __syncthreads();  // the next pair (grid-stride) reuses work and dp
}

// One pair's tests, by one warp (T <= 256): tests_row in the warp forms of
// pair_common.cuh, the same outputs bit for bit.
template <int M>
__device__ __forceinline__ void tests_row_warp(const TestsArgs& a, int row, int2* steps) {
  const int T = a.T;
  const size_t off = size_t(row) * T;
  const float* xb = a.x + off;
  const float* xc = a.y + off;
  const uint8_t* mb = a.xm + off;
  const uint8_t* mc = a.ym + off;
  constexpr int R = WarpPair<M>::kWilcoxon;
  tstamp(a.clocks, row, 0);
  const WarpWindows<R> win = warp_windows<R>(xb, mb, xc, mc, T);
  const PairCounts c = warp_pair_counts(win);
  tstamp(a.clocks, row, 1);
  GroupStats g{0, 0, 0}, gw{0, 0, 0};
  if (a.tests & (kTestMannWhitney | kTestKruskal | kTestKs)) {
    uint64_t k[M];
    warp_pair_keys(k, win, T);
    warp_bitonic_sort(k);
    tstamp(a.clocks, row, 2);
    g = warp_group_stats(k, c.n1 + c.n2, c.n1, c.n2);
  } else {
    tstamp(a.clocks, row, 2);
  }
  tstamp(a.clocks, row, 3);
  if (a.tests & kTestWilcoxon) {
    uint64_t kw[R];
    warp_wilcoxon_keys(kw, win);
    warp_bitonic_sort(kw);
    tstamp(a.clocks, row, 4);
    gw = warp_group_stats(kw, c.nz, 0, 0);
  } else {
    tstamp(a.clocks, row, 4);
  }
  tstamp(a.clocks, row, 5);
  float st[kTests] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, pv[kTests] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  if (a.tests & kTestMannWhitney) pv[0] = mann_whitney_p(g, c.n1, c.n2, &st[0]);
  if (a.tests & kTestKruskal) pv[1] = kruskal2_p(g, c.n1, c.n2, &st[1]);
  if (a.tests & kTestKs) {
    pv[3] = warp_ks_p<WarpPair<M>::kCells>(g, c.n1, c.n2, a.ks_exact_max, steps);
    st[3] = safe_div(float(g.ks_t), float(c.n1) * float(c.n2));
  }
  tstamp(a.clocks, row, 6);
  if (a.tests & kTestWilcoxon)
    pv[2] = warp_wilcoxon_p(gw, c.nz, c.nblk, a.wilcoxon_table, a.wilcoxon_max_n, &st[2]);
  if (a.tests & kTestSign) {
    pv[4] = warp_sign_test_p(c.pos, c.neg, a.lgamma_table);
    st[4] = float(c.pos + c.neg);
  }
  tstamp(a.clocks, row, 7);
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < kTests; ++k) {
      a.stat[size_t(row) * kTests + k] = st[k];
      a.p[size_t(row) * kTests + k] = pv[k];
    }
  }
}

// Kernel A's warp-path shape; a warp's shared memory holds its KS steps. A
// tail warp returns at once.
template <int M>
__global__ void __launch_bounds__(32 * kPairWarps, kPairWarpBlocks)
    pair_tests_warp_kernel(TestsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, row = blockIdx.x * kPairWarps + warp;
  if (row >= a.B) return;
  tests_row_warp<M>(a, row,
                    reinterpret_cast<int2*>(smem + size_t(warp) * warp_steps_bytes(a.T)));
}

template <bool kScratch>
__global__ void __launch_bounds__(kTestsThreads) pair_tests_kernel(TestsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  float* dp = reinterpret_cast<float*>(smem);
  if constexpr (kScratch) {
    unsigned char* work = a.scratch + size_t(blockIdx.x) * a.scratch_stride;
    for (int row = blockIdx.x; row < a.B; row += gridDim.x) tests_row(a, row, work, dp, scr);
  } else {
    tests_row(a, blockIdx.x, smem, dp, scr);
  }
}

}  // namespace fm

// One pair's sort entries (keys, counts, group starts): the combined sort
// of 2T is the larger of the two.
static size_t tests_work_bytes(int T) { return size_t(fm::next_pow2(2 * T)) * 16; }

static size_t tests_dp_bytes(int T, int ks_exact_max) {
  return size_t(2) * (size_t(T < ks_exact_max ? T : ks_exact_max) + 1) * 4;
}

extern "C" long long fm_pair_tests_scratch_stride(int T) {
  return (long long)((tests_work_bytes(T) + 255) / 256 * 256);
}

extern "C" int fm_pair_tests(const float* x, const uint8_t* xm, const float* y, const uint8_t* ym,
                             int B, int T, int tests, const float* wilcoxon_table,
                             int wilcoxon_max_n, int ks_exact_max, float* stat, float* p,
                             unsigned char* scratch, long long scratch_stride, int grid,
                             void* stream) {
  fm::TestsArgs a{x, xm, y, ym, B, T, tests, wilcoxon_table, wilcoxon_max_n, ks_exact_max,
                  stat, p, scratch, size_t(scratch_stride), nullptr, nullptr};
  const size_t dp = (tests & fm::kTestKs) ? tests_dp_bytes(T, ks_exact_max) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (scratch == nullptr) {
    const size_t work = tests_work_bytes(T);
    const size_t smem = work > dp ? work : dp;
    e = cudaFuncSetAttribute(fm::pair_tests_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::pair_tests_kernel<false><<<grid, fm::kTestsThreads, smem, st>>>(a);
  } else {
    const size_t smem = dp > 16 ? dp : 16;
    e = cudaFuncSetAttribute(fm::pair_tests_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::pair_tests_kernel<true><<<grid, fm::kTestsThreads, smem, st>>>(a);
  }
  return int(cudaGetLastError());
}

template <int M>
static cudaError_t launch_tests_warp(const fm::TestsArgs& a, int grid, cudaStream_t st) {
  const size_t smem = fm::kPairWarps * fm::warp_steps_bytes(a.T);
  fm::pair_tests_warp_kernel<M><<<grid, 32 * fm::kPairWarps, smem, st>>>(a);
  return cudaGetLastError();
}

// Kernel N's warp path (T <= 256): grid CTAs of fm_pair_warps() pairs.
extern "C" int fm_pair_tests_warp(const float* x, const uint8_t* xm, const float* y,
                                  const uint8_t* ym, int B, int T, int tests,
                                  const float* wilcoxon_table, int wilcoxon_max_n,
                                  int ks_exact_max, float* stat, float* p, long long* clocks,
                                  const double* lgamma_table, int grid, void* stream) {
  if (T < 1 || T > 256 || (long long)grid * fm::kPairWarps < B) return int(cudaErrorInvalidValue);
  fm::TestsArgs a{x, xm, y, ym, B, T, tests, wilcoxon_table, wilcoxon_max_n, ks_exact_max,
                  stat, p, nullptr, 0, clocks, lgamma_table};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fm::warp_keys_per_lane(T)) {
    case 1: return int(launch_tests_warp<1>(a, grid, st));
    case 2: return int(launch_tests_warp<2>(a, grid, st));
    case 4: return int(launch_tests_warp<4>(a, grid, st));
    case 8: return int(launch_tests_warp<8>(a, grid, st));
    default: return int(launch_tests_warp<16>(a, grid, st));
  }
}
