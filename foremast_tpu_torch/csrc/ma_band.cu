// Kernel B: the band family's chain, one launch for B rows, in two entries
// that share one code path.
//
// `ma_band` runs the chain under moving_average_all and replaces the three
// jitted XLA programs that the engine's band launch runs back to back:
// ops/forecast.py moving_average_predictions (:210, the vmapped
// _moving_average_1d :110 with _hold_last :73 and _first_valid :91),
// residual_sigma (:478) and band_anomalies (:497). `band_from_preds` takes
// the predictions as an input (from the smoothers, kernels C and E, or the
// Holt-Winters fit) and replaces residual_sigma + band_anomalies alone.
// History is mask & ~region; the band judges mask & region.
//
// Design: one CTA of kBandThreads threads per row.
//   1. (ma_band) Block scans build the float64 prefix sums and counts of
//      the history in shared memory (12 B per slot: 196 KB at T = 16384,
//      the largest bucket, under the 227 KB a CTA may use); the first
//      history value comes from a search of the counts.
//   2. Each thread predicts its slots with ma_predict (common.cuh): a
//      windowed mean from two prefix reads, or, in a gap, the freeze-fill,
//      found by a binary search for the last observation; band_from_preds
//      reads them instead. Residuals over the history reduce to sigma
//      (+inf below 2 points).
//   3. The same threads re-read their own predictions and write the band,
//      the flags and the per-row count, first index and checked count.
//
// What bounds it on an H100: bytes. Per slot ma_band reads 6 B (value,
// mask, region) and writes 13 B (preds, upper, lower, flags) against some
// 20 floating-point operations, about one per byte, far below the card's
// ~20 operations per byte balance point; at B = 100k rows of the simfleet
// bucket T = 1024 that is ~1.9 GB, ~0.6 ms at 3.35 TB/s. band_from_preds
// reads 10 B and writes 9 B per slot: ~31 GB at B = 100k, T = 16384. The
// design keeps every intermediate (prefix sums, residuals) in shared memory
// or registers so that only those bytes cross device memory, and writes
// each output once.
#include "common.cuh"

namespace fm {

// 256 threads: on an H100, 100k rows at T = 1024 took 1.83 ms at 256 and
// 2.14 ms at 128 (chip_smoke.py, two runs).
constexpr int kBandThreads = 256;

struct BandArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* region;
  int window;              // ma_band
  const float* preds_in;   // band_from_preds
  const float* threshold;
  const int* bound_mode;
  const float* min_lower_bound;
  int T;
  float* preds;            // ma_band
  float* sigma;
  float* upper;
  float* lower;
  uint8_t* flags;
  int* count;
  int* first_index;
  int* checked;
};

template <bool kPredict>
__global__ void __launch_bounds__(kBandThreads) band_kernel(BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x;
  const size_t off = size_t(row) * T;
  const float* x = a.x + off;
  const uint8_t* mask = a.mask + off;
  const uint8_t* region = a.region + off;
  const float* preds = kPredict ? a.preds + off : a.preds_in + off;

  double* S = reinterpret_cast<double*>(smem);
  int* C = reinterpret_cast<int*>(S + T + 1);
  float first = 0.0f;
  if constexpr (kPredict) first = ma_prefix(x, mask, region, T, S, C, scr);

  float ss = 0.0f;
  int nh = 0;  // history points: the prefix counts hold them for ma_band
  if constexpr (kPredict) nh = C[T];
  for (int t = tid; t < T; t += blockDim.x) {
    float p;
    if constexpr (kPredict) {
      p = ma_predict(S, C, T, t, a.window, first);
      a.preds[off + t] = p;
    } else {
      p = preds[t];
    }
    if (mask[t] && !region[t]) {
      const float r = x[t] - p;
      ss += r * r;
      if constexpr (!kPredict) nh += 1;
    }
  }
  ss = block_sum(ss, scr);
  if constexpr (!kPredict) nh = block_sum(nh, scr);
  const float sigma = nh >= 2 ? sqrtf(ss / fmaxf(float(nh), 1.0f)) : CUDART_INF_F;

  const float thr = a.threshold[row] * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  int count = 0, checked = 0, first_flag = T;
  for (int t = tid; t < T; t += blockDim.x) {
    const float p = preds[t];  // ma_band: this thread's own write above
    const float up = p + thr;
    const float lo = nan_max(p - thr, mlb);
    const float v = x[t];
    const bool chk = mask[t] && region[t];
    const bool flag = chk && (((v > up) && (mode & 1)) || ((v < lo) && (mode & 2)));
    a.upper[off + t] = up;
    a.lower[off + t] = lo;
    a.flags[off + t] = flag;
    count += flag;
    checked += chk;
    if (flag) first_flag = min(first_flag, t);
  }
  count = block_sum(count, scr);
  checked = block_sum(checked, scr);
  first_flag = block_reduce(first_flag, Min<int>(), scr);
  if (tid == 0) {
    a.sigma[row] = sigma;
    a.count[row] = count;
    a.first_index[row] = count > 0 ? first_flag : -1;
    a.checked[row] = checked;
  }
}

}  // namespace fm

static size_t ma_band_smem(int T) { return size_t(T + 1) * 12; }

extern "C" int fm_ma_band(const float* x, const uint8_t* mask, const uint8_t* region, int window,
                          const float* threshold, const int* bound_mode,
                          const float* min_lower_bound, int B, int T, float* preds, float* sigma,
                          float* upper, float* lower, uint8_t* flags, int* count,
                          int* first_index, int* checked, void* stream) {
  fm::BandArgs a{x, mask, region, window, nullptr, threshold, bound_mode, min_lower_bound, T,
                 preds, sigma, upper, lower, flags, count, first_index, checked};
  const size_t smem = ma_band_smem(T);
  cudaError_t e = cudaFuncSetAttribute(fm::band_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::band_kernel<true><<<B, fm::kBandThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

extern "C" int fm_band_from_preds(const float* x, const uint8_t* mask, const uint8_t* region,
                                  const float* preds, const float* threshold,
                                  const int* bound_mode, const float* min_lower_bound, int B,
                                  int T, float* sigma, float* upper, float* lower, uint8_t* flags,
                                  int* count, int* first_index, int* checked, void* stream) {
  fm::BandArgs a{x, mask, region, 0, preds, threshold, bound_mode, min_lower_bound, T,
                 nullptr, sigma, upper, lower, flags, count, first_index, checked};
  fm::band_kernel<false><<<B, fm::kBandThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
