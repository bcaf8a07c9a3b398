// Kernel G: the tier-0 triage screen, one launch for B packed rows.
//
// Replaces the reference's ops/triage.py `_screen_1d` (:58), vmapped and
// jitted as `screen_rows` (:140): per row, the band scorer's own moving
// average over the history (mask & ~region) and its RMS residual sigma;
// the violations of the current region (mask & region) under the policy
// band and under the band narrowed by `margin` sigmas (lower edge floored
// at min_lower_bound, ML_BOUND bitmask, 0 read as both); the means of both
// band edges over every region slot; the largest residual z of a checked
// slot; and the robust z: the largest |x - median| of a checked slot over
// max(1.4826 MAD, finite sigma), the median and MAD of the valid history
// taken as the mean of the order statistics (n-1)//2 and n//2 (clipped to
// the row), masked slots reading as +inf, NaN after +inf.
//
// The moving average is the port's, not a copy of the reference's float32
// algebra: ma_prefix / ma_predict of common.cuh on float64 prefix sums,
// shared with kernels A and B, and the sigma sums run in kernel B's order
// (kScreenThreads == kBandThreads, the same strided loop and block sum).
// So the screen's predictions and sigma are kernel B's to the bit, its
// `count` is B's count, and CLEAR (shrunk count under the verdict gate)
// is one-sided against the band scorer the engine would otherwise run.
//
// Design: one CTA of kScreenThreads threads per row, everything in shared
// memory, in four phases that reuse one buffer:
//   1. block scans build the float64 prefix sums and counts of the history
//      (12 B per slot: 196 KB at T = 16384, the largest bucket);
//   2. each thread predicts its slots (ma_predict) and sums its squared
//      history residuals; one block sum gives sigma;
//   3. it predicts them again and counts both bands, sums the band edges
//      over the region and takes the largest checked residual;
//   4. only then the prefix-sum space is reused for 4-byte order keys (the
//      float bits mapped to an unsigned total order: -0 folded into +0,
//      +inf for masked slots, NaN above +inf, as jnp.sort orders them), and
//      an exact radix select (four passes of 8-bit digit histograms; lanes
//      of a warp that share a digit add once) finds the two order
//      statistics of the history values, then, after rewriting the keys as
//      |x - median|, of the absolute deviations.
// Keeping the order keys in the prefix-sum space (and not beside it) is
// what fits T = 16384 in one CTA: 196 KB + 64 KB would exceed the 227 KB a
// CTA may use, so no device scratch is needed at any bucket.
//
// What bounds it on an H100: by chip_smoke.py's count (triage_bound),
// bytes: a row reads 6 B per slot (value, mask, region) and writes 36 B,
// while its ~35 operations per slot and the selects' compares would take
// less time at the fp32 rate. The kernel runs far above that bound (PERF.md
// keeps the measurements); why is not measured yet, the suspects being the
// ~100 block barriers per row of the two radix selects, their shared-memory
// histograms, and, at T = 16384, one resident CTA per SM (196 KB of shared
// memory).
#include "common.cuh"

namespace fm {

// = kBandThreads of ma_band.cu: the sigma sums must run in its order
constexpr int kScreenThreads = 256;
constexpr uint32_t kKeyInf = 0xFF800000u;  // order_key(+inf)
constexpr uint32_t kKeyNaN = 0xFFFFFFFFu;  // above every other key

// float -> unsigned with the same order (jnp.sort's: NaN last, -0 == +0)
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return kKeyNaN;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == kKeyNaN) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

struct SelectSpace {
  int hist[256];
  int digit;
  int rank;
};

// The k-th smallest (0-based) of keys[0, n) in shared memory, exactly: four
// passes of an 8-bit digit histogram over the keys that share the prefix
// found so far. Called by all threads; returns the key to all.
__device__ uint32_t block_select(const uint32_t* keys, int n, int k, SelectSpace& sp,
                                 Scratch& s) {
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    __syncthreads();  // the previous pass's readers are done with hist
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sp.hist[i] = 0;
    __syncthreads();
    // the keys of a row mostly share their leading digits, so lanes that
    // hold the same digit add once, through their lowest lane (a warp's
    // iterations are uniform: every lane runs the loop the same count)
    const int lane = threadIdx.x & 31;
    for (int i0 = threadIdx.x - lane; i0 < n; i0 += blockDim.x) {
      const int i = i0 + lane;
      const uint32_t v = i < n ? keys[i] : 0u;
      const uint32_t d = (i < n && (v & pmask) == prefix) ? (v >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(kFullWarp, d);
      if (d < 256u && lane == __ffs(peers) - 1) atomicAdd(&sp.hist[d], __popc(peers));
    }
    block_scan(sp.hist, 256, Add<int>(), 0, s);  // inclusive counts
    for (int d = threadIdx.x; d < 256; d += blockDim.x) {
      const int lo = d > 0 ? sp.hist[d - 1] : 0;
      if (lo <= k && k < sp.hist[d]) {
        sp.digit = d;
        sp.rank = k - lo;
      }
    }
    __syncthreads();
    prefix |= uint32_t(sp.digit) << shift;
    pmask |= 255u << shift;
    k = sp.rank;
  }
  return prefix;
}

// The order statistics i0 <= i1 = i0 or i0 + 1 of keys[0, n): the i0-th by
// block_select, the i1-th from it (the same key while it repeats that far,
// else the least larger key).
__device__ void block_select_pair(const uint32_t* keys, int n, int i0, int i1, uint32_t& k0,
                                  uint32_t& k1, SelectSpace& sp, Scratch& s) {
  k0 = block_select(keys, n, i0, sp, s);
  if (i1 == i0) {
    k1 = k0;
    return;
  }
  int le = 0;
  uint32_t above = 0xFFFFFFFFu;  // kKeyNaN: what i1 reads when nothing is larger
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t v = keys[i];
    le += v <= k0;
    if (v > k0) above = min(above, v);
  }
  le = block_sum(le, s);
  above = block_reduce(above, Min<uint32_t>(), s);
  k1 = i1 < le ? k0 : above;
}

struct ScreenArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* region;
  const float* threshold;
  const int* bound_mode;
  const float* min_lower_bound;
  const float* margin;
  int window;
  int T;
  int* count;
  int* shrunk_count;
  int* checked;
  int* n_hist;
  float* upper_mean;
  float* lower_mean;
  float* resid_z;
  float* robust_z;
  float* sigma;
};

__global__ void __launch_bounds__(kScreenThreads) triage_kernel(ScreenArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  __shared__ SelectSpace sel;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x;
  const size_t off = size_t(row) * T;
  const float* x = a.x + off;
  const uint8_t* mask = a.mask + off;
  const uint8_t* region = a.region + off;

  // 1. prefix sums of the history
  double* S = reinterpret_cast<double*>(smem);
  int* C = reinterpret_cast<int*>(S + T + 1);
  const float first = ma_prefix(x, mask, region, T, S, C, scr);
  const int nh = C[T];

  // 2. sigma, in kernel B's order
  float ss = 0.0f;
  for (int t = tid; t < T; t += blockDim.x) {
    const float p = ma_predict(S, C, T, t, a.window, first);
    if (mask[t] && !region[t]) {
      const float r = x[t] - p;
      ss += r * r;
    }
  }
  ss = block_sum(ss, scr);
  const float sigma = nh >= 2 ? sqrtf(ss / fmaxf(float(nh), 1.0f)) : CUDART_INF_F;

  // 3. the policy band and the shrunk band
  const float thr = a.threshold[row];
  const float w_real = thr * sigma;
  const float w_shrunk = (thr - a.margin[row]) * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  int count = 0, shrunk = 0, checked = 0, n_region = 0;
  double up_sum = 0.0, lo_sum = 0.0;
  float dev_max = 0.0f;
  for (int t = tid; t < T; t += blockDim.x) {
    const float p = ma_predict(S, C, T, t, a.window, first);
    const float v = x[t];
    const float up = p + w_real;
    const float lo = nan_max(p - w_real, mlb);
    const float up_s = p + w_shrunk;
    const float lo_s = nan_max(p - w_shrunk, mlb);
    const bool reg = region[t];
    const bool chk = mask[t] && reg;
    count += chk && (((v > up) && (mode & 1)) || ((v < lo) && (mode & 2)));
    shrunk += chk && (((v > up_s) && (mode & 1)) || ((v < lo_s) && (mode & 2)));
    checked += chk;
    if (reg) {
      n_region += 1;
      up_sum += double(up);
      lo_sum += double(lo);
    }
    if (chk) dev_max = nan_max(dev_max, fabsf(v - p));
  }
  count = block_sum(count, scr);
  shrunk = block_sum(shrunk, scr);
  checked = block_sum(checked, scr);
  n_region = block_sum(n_region, scr);
  up_sum = block_sum(up_sum, scr);
  lo_sum = block_sum(lo_sum, scr);
  dev_max = block_reduce(dev_max, NanMax(), scr);
  const double n_r = double(max(n_region, 1));
  const float resid_z = dev_max / nan_max(sigma, 1e-30f);

  // 4. median and MAD of the valid history, in the prefix-sum space
  __syncthreads();  // every thread is done with S and C
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  for (int t = tid; t < T; t += blockDim.x)
    keys[t] = (mask[t] && !region[t]) ? order_key(x[t]) : kKeyInf;
  const int i0 = min(max(nh > 0 ? (nh - 1) / 2 : 0, 0), T - 1);
  const int i1 = min(max(nh / 2, 0), T - 1);
  uint32_t k0, k1;
  block_select_pair(keys, T, i0, i1, k0, k1, sel, scr);
  const float med = 0.5f * (key_value(k0) + key_value(k1));
  float rob_max = 0.0f;
  __syncthreads();  // the select's readers are done with the keys
  for (int t = tid; t < T; t += blockDim.x) {
    const float d = fabsf(x[t] - med);
    keys[t] = (mask[t] && !region[t]) ? order_key(d) : kKeyInf;
    if (mask[t] && region[t]) rob_max = nan_max(rob_max, d);
  }
  block_select_pair(keys, T, i0, i1, k0, k1, sel, scr);
  const float mad = 0.5f * (key_value(k0) + key_value(k1));
  rob_max = block_reduce(rob_max, NanMax(), scr);
  const float scale = nan_max(1.4826f * mad, isfinite(sigma) ? sigma : 0.0f);
  const float robust_z = nh > 0 ? rob_max / nan_max(scale, 1e-30f) : 0.0f;

  if (tid == 0) {
    a.count[row] = count;
    a.shrunk_count[row] = shrunk;
    a.checked[row] = checked;
    a.n_hist[row] = nh;
    a.upper_mean[row] = float(up_sum / n_r);
    a.lower_mean[row] = float(lo_sum / n_r);
    a.resid_z[row] = resid_z;
    a.robust_z[row] = robust_z;
    a.sigma[row] = sigma;
  }
}

}  // namespace fm

static size_t triage_smem(int T) { return size_t(T + 1) * 12; }

extern "C" int fm_triage_screen(const float* x, const uint8_t* mask, const uint8_t* region,
                                const float* threshold, const int* bound_mode,
                                const float* min_lower_bound, const float* margin, int window,
                                int B, int T, int* count, int* shrunk_count, int* checked,
                                int* n_hist, float* upper_mean, float* lower_mean, float* resid_z,
                                float* robust_z, float* sigma, void* stream) {
  fm::ScreenArgs a{x, mask, region, threshold, bound_mode, min_lower_bound, margin, window, T,
                   count, shrunk_count, checked, n_hist, upper_mean, lower_mean, resid_z,
                   robust_z, sigma};
  const size_t smem = triage_smem(T);
  cudaError_t e = cudaFuncSetAttribute(fm::triage_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::triage_kernel<<<B, fm::kScreenThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
