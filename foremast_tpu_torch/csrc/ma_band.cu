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
// Design: one CTA of kBandThreads threads per row. ma_band has three paths
// with the same bits (kernels.band_path): up to T = 4096 the staged path
// (band_staged_kernel below: the row read once, seven block barriers a
// row), above it the long path (band_long_kernel below: the row read once,
// S rebuilt from each chunk's offset, three CTAs an SM); the unstaged path
// (the first design, forcible at every T) and band_from_preds:
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
  long long* clocks;       // ma_band: null, or (B, kBandStamps) clock64() stamps a row
};

// With a.clocks set (ma_band), thread 0 stamps the SM clock at a row's
// start and after each phase, past a block barrier: the loads into the
// prefix arrays, the two scans and the first-value search, the
// predictions and sigma, the band, the three reductions. The phase names
// are kernels.BAND_PHASES; null costs one uniform branch a stamp.
constexpr int kBandStamps = 6;

__device__ __forceinline__ void bstamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && threadIdx.x == 0) clocks[size_t(row) * kBandStamps + k] = clock64();
}

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
  if constexpr (kPredict) {
    bstamp(a.clocks, row, 0);
    if (a.clocks != nullptr) {
      // the stamped split: ma_prefix's loads, a barrier, then its scans and
      // its search
      for (int i = tid; i < T; i += blockDim.x) {
        const bool h = mask[i] && !region[i];
        S[i + 1] = h ? double(x[i]) : 0.0;
        C[i + 1] = h ? 1 : 0;
      }
      if (tid == 0) {
        S[0] = 0.0;
        C[0] = 0;
      }
      __syncthreads();
      bstamp(a.clocks, row, 1);
      block_scan(S + 1, T, Add<double>(), 0.0, scr);
      block_scan(C + 1, T, Add<int>(), 0, scr);
      if (C[T] > 0) {
        int lo = 0, hi = T;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (C[mid] >= 1) hi = mid; else lo = mid + 1;
        }
        first = x[lo - 1];
      }
    } else {
      first = ma_prefix(x, mask, region, T, S, C, scr);
    }
    bstamp(a.clocks, row, 2);
  }

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
  if constexpr (kPredict) bstamp(a.clocks, row, 3);
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
  if constexpr (kPredict) {
    if (a.clocks != nullptr) {
      __syncthreads();
      bstamp(a.clocks, row, 4);
    }
  }
  count = block_sum(count, scr);
  checked = block_sum(checked, scr);
  first_flag = block_reduce(first_flag, Min<int>(), scr);
  if constexpr (kPredict) bstamp(a.clocks, row, 5);
  if (tid == 0) {
    a.sigma[row] = sigma;
    a.count[row] = count;
    a.first_index[row] = count > 0 ? first_flag : -1;
    a.checked[row] = checked;
  }
}

// ---------------------------------------------------------------------------
// ma_band's staged path (T <= kStagedBandT): the row read from device
// memory once, seven block barriers a row, and the first design's bits.
//
//   1. stage: each thread loads its scan chunk of x (block_scan's
//      contiguous ceil(T / 256) slots, as float4 where T % 4 == 0 and the
//      chunk is a multiple of 4) into registers and shared memory; each
//      warp ballots mask and region, 32 slots at a time, into history and
//      checked bit words.
//   2. scan: each thread sums its chunk's history into S from 0.0 in turn,
//      as block_scan does; warp 1 counts the history before each word (C
//      is those counts plus a popcount) and finds the first history value.
//      Then warp 0 runs block_scan's Hillis-Steele scan of the 256 chunk
//      totals in registers (lane l holds totals l + 32 q, q < 8: offsets
//      1-16 by shuffles, 32-128 within the lane; the same additions in the
//      same order), and each thread adds its chunk's offset.
//   3. predict_sigma: each thread predicts its chunk's slots as the first
//      design does (ma_predict's reads and divisions: S and C at the slot
//      from its registers, at the window's start from shared memory), keeps
//      them in registers and writes the history's squared residuals (+0.0
//      elsewhere) in place of x; then thread tid sums slots tid + 256 j in
//      j's order, the first design's partial sums, and the warps'
//      shfl_down trees and the eight totals in order give block_sum's bits.
//   4. band: the chunk's slots from registers, its outputs written as
//      float4 (the flags four to a word) where the chunk allows; count,
//      checked and first index by warp reductions and one barrier.
// ---------------------------------------------------------------------------
constexpr int kStagedBandT = 4096;  // kernels.STAGED_BAND_T: 16 slots a thread
constexpr int kBandWarps = kBandThreads / 32;
// resident CTAs an SM: 6 (40 registers) up to 4 slots a thread, 4 (64
// registers) above, where 40 spilled (an H100: 1.275 against 1.486 ms at
// 100k x 1024, 0.147 against 0.128 ms at 4096 x 2048)
constexpr int band_staged_blocks(int per) { return per <= 4 ? 6 : 4; }

// The staged row in shared memory: x, S (S[0] = 0, S[j] the float64 sum
// of the history in [0, j)), the history and checked bits of each word of
// 32 slots, and the history count before each word (nw + 1 entries each).
__host__ __device__ inline size_t staged_x_bytes(int T) { return (size_t(T) * 4 + 15) / 16 * 16; }
__host__ __device__ inline size_t staged_band_bytes(int T) {
  const size_t nw = size_t(T + 31) / 32 + 1;
  return staged_x_bytes(T) + size_t(T + 1) * 8 + nw * 12;
}

// C[j], the history slots in [0, j) for 0 <= j <= T, from the history
// bits of each word of 32 slots (hb) and the count before each word (cw).
__device__ __forceinline__ int hist_count(const uint32_t* hb, const int* cw, int j) {
  return cw[j >> 5] + __popc(hb[j >> 5] & ((1u << (j & 31)) - 1u));
}

// The staged row's prefix sums and history bits: C[j] and ma_mean of
// common.cuh on them.
struct StagedPrefix {
  const double* S;
  const uint32_t* hb;
  const int* cw;

  __device__ __forceinline__ int count(int j) const { return hist_count(hb, cw, j); }
  __device__ __forceinline__ float mean(int lo, int hi) const {
    const int c = count(hi) - count(lo);
    return c > 0 ? float((S[hi] - S[lo]) / double(c)) : 0.0f;
  }
};

// By one warp: the history count before each word of 32 slots (cw[wd]
// for wd <= nw, from the history bits hb[0, nw)) and the first history
// value, x_at(its slot), in *first (0 where the row has no history).
template <typename XAt>
__device__ __forceinline__ void band_counts(const uint32_t* hb, int nw, int* cw, float* first,
                                            XAt x_at) {
  const int lane = threadIdx.x & 31;
  const int per_lane = (nw + 32) / 32;  // words 0..nw, nw + 1 of them
  int c = 0;
  for (int u = 0; u < per_lane; ++u) {
    const int wd = lane * per_lane + u;
    c += wd < nw ? __popc(hb[wd]) : 0;
  }
  const int incl = warp_scan(c, Add<int>());
  int run = incl - c;
  for (int u = 0; u < per_lane; ++u) {
    const int wd = lane * per_lane + u;
    if (wd <= nw) {
      cw[wd] = run;
      const int pc = wd < nw ? __popc(hb[wd]) : 0;
      if (pc > 0 && run == 0) *first = x_at(32 * wd + __ffs(hb[wd]) - 1);
      run += pc;
    }
  }
  if (__shfl_sync(kFullWarp, incl, 31) == 0 && lane == 0) *first = 0.0f;
}

// By one warp: block_scan's Hillis-Steele scan of the kBandThreads chunk
// totals in tot (the same additions in the same order; lane l holds totals
// l + 32 q, q < 8: offsets 1-16 by shuffles, 32-128 within the lane), each
// replaced by its chunk's offset, the scan at the chunk before it (0.0 for
// the first).
__device__ __forceinline__ void band_chunk_offsets(double* tot) {
  const int lane = threadIdx.x & 31;
  double v[kBandWarps];
#pragma unroll
  for (int q = 0; q < kBandWarps; ++q) v[q] = tot[lane + 32 * q];
#pragma unroll 1
  for (int sh = 0; sh < 5; ++sh) {
    const int o = 1 << sh;
    // from lane - o of the same q, or of q - 1 below the offset (both the
    // last step's values: q ascending, each shuffled before it changes)
    double below = 0.0;
#pragma unroll
    for (int q = 0; q < kBandWarps; ++q) {
      const double u = __shfl_sync(kFullWarp, v[q], (lane - o) & 31);
      v[q] = v[q] + (lane >= o ? u : below);
      below = u;
    }
  }
#pragma unroll
  for (int d = 1; d < kBandWarps; d <<= 1) {
#pragma unroll
    for (int q = kBandWarps - 1; q >= 0; --q) v[q] = v[q] + (q >= d ? v[q - d] : 0.0);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kBandWarps; ++q) {
    const double mine = lane == 31 ? (q > 0 ? v[q - 1] : 0.0) : v[q];
    const double got = __shfl_sync(kFullWarp, mine, (lane - 1) & 31);
    tot[lane + 32 * q] = lane + 32 * q > 0 ? got : 0.0;
  }
}

// ma_predict's value at a slot whose window holds no history, k the
// history count before the slot: `first` before any history, else the
// freeze fill, the mean of the window ending just after the k-th history
// value (the smallest j with C[j] >= k, by bisection as ma_predict finds
// it). It depends on k alone, so a thread keeps the last one it found.
__device__ __noinline__ float band_fill(StagedPrefix r, int T, int w, float first, int k) {
  if (k == 0) return first;
  int a = 0, b = T;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (r.count(mid) >= k) b = mid; else a = mid + 1;
  }
  return r.mean(min(max(a - w, 0), a), a);
}

// A thread's chunk of len <= PER floats to dst: as float4 where vec (the
// chunk and the row are whole float4s), else one at a time.
template <int PER>
__device__ __forceinline__ void put_chunk(float* dst, const float (&v)[PER], int len, bool vec) {
  if constexpr (PER >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < PER; q += 4) {
        if (q < len)
          *reinterpret_cast<float4*>(dst + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (q < len) dst[q] = v[q];
  }
}

template <int PER>
__global__ void __launch_bounds__(kBandThreads, band_staged_blocks(PER))
    band_staged_kernel(BandArgs a, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double tot[kBandThreads];
  __shared__ float wss[kBandWarps];
  __shared__ int wint[3][kBandWarps];
  __shared__ float first_s;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (T + kBandThreads - 1) / kBandThreads, nw = (T + 31) >> 5;
  const size_t off = size_t(row) * T;
  float* xs = reinterpret_cast<float*>(smem);
  double* S = reinterpret_cast<double*>(smem + staged_x_bytes(T));
  uint32_t* hb = reinterpret_cast<uint32_t*>(S + T + 1);
  uint32_t* cb = hb + nw + 1;
  int* cw = reinterpret_cast<int*>(cb + nw + 1);
  bstamp(a.clocks, row, 0);

  // 1. stage
  const int beg = min(tid * per, T), len = min(beg + per, T) - beg;
  float xr[PER];
  // every load of the row issued before any is used or stored: no branch
  // between them (an index past the row reads its last slot, and is
  // dropped). x: the chunk; mask and region: slots warp 32 + 256 j + lane.
  const float* xg = a.x + off;
  uint8_t mg[PER], gg[PER];
  bool vec4 = false;
  if constexpr (PER >= 4) vec4 = vec;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xg);
#pragma unroll
    for (int q = 0; q < PER; q += 4) {
      const float4 v = __ldg(x4 + min(beg + q, T - 4) / 4);
      xr[q] = v.x;
      xr[(q + 1) % PER] = v.y;
      xr[(q + 2) % PER] = v.z;
      xr[(q + 3) % PER] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) xr[q] = __ldg(xg + min(beg + q, T - 1));
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = min(warp * 32 + kBandThreads * j + lane, T - 1);
    mg[j] = __ldg(a.mask + off + t);
    gg[j] = __ldg(a.region + off + t);
  }
  put_chunk(xs + beg, xr, len, vec4);
  uint32_t mbits = 0u, gbits = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool in = warp * 32 + kBandThreads * j + lane < T;
    mbits |= uint32_t(in && mg[j] != 0) << j;
    gbits |= uint32_t(in && gg[j] != 0) << j;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t0 = warp * 32 + kBandThreads * j;
    const bool m = (mbits >> j) & 1u, g = (gbits >> j) & 1u;
    const unsigned h = __ballot_sync(kFullWarp, m && !g), c = __ballot_sync(kFullWarp, m && g);
    if (lane == 0 && t0 < T) {
      hb[t0 >> 5] = h;
      cb[t0 >> 5] = c;
    }
  }
  if (tid == 0) {
    hb[nw] = cb[nw] = 0u;
    S[0] = 0.0;
  }
  __syncthreads();
  bstamp(a.clocks, row, 1);

  // 2. scan: the chunk from 0.0 in turn (block_scan's first pass), its
  // sums kept in registers ...
  double loc[PER];
  uint32_t hq = 0u;  // bit q: slot beg + q is history
  double acc = 0.0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = beg + q;
    const bool h = q < len && ((hb[min(i, T - 1) >> 5] >> (i & 31)) & 1u);
    hq |= uint32_t(h) << q;
    acc = q < len ? acc + (h ? double(xr[q]) : 0.0) : acc;
    loc[q] = acc;
  }
  tot[tid] = acc;
  if (warp == 1) band_counts(hb, nw, cw, &first_s, [&](int i) { return xs[i]; });
  __syncthreads();
  if (warp == 0) band_chunk_offsets(tot);
  __syncthreads();
  // ... and each chunk adds its offset: S[i + 1] = pre + its sum to i
  const double pre = tot[tid];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (q < len) S[beg + q + 1] = pre + loc[q];
  }
  __syncthreads();
  bstamp(a.clocks, row, 2);

  // 3. predictions of the chunk's slots: C at the slot from the chunk's
  // history bits, S at it and both at the window's start from shared
  // memory; the windowed means side by side, dividing only where the
  // window holds history (as ma_predict: a warp whose slots all lie past
  // the history skips the float64 divisions), then the slots whose window
  // is empty (band_fill)
  const StagedPrefix r{S, hb, cw};
  const int w = a.window, c_beg = r.count(beg);
  float pr[PER];
  uint32_t empty = 0u;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int t = min(beg + q, T - 1);
    const int lo = min(max(t - w, 0), t);
    const int chi = c_beg + __popc(hq & ((1u << q) - 1u)), clo = r.count(lo);
    pr[q] = 0.0f;
    if (chi > clo) pr[q] = float((S[t] - S[lo]) / double(chi - clo));
    empty |= uint32_t(chi <= clo && q < len) << q;
  }
  int k_kept = -1;
  float p_kept = 0.0f;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if ((empty >> q) & 1u) {
      const int k = c_beg + __popc(hq & ((1u << q) - 1u));
      if (k != k_kept) {
        p_kept = band_fill(r, T, w, first_s, k);
        k_kept = k;
      }
      pr[q] = p_kept;
    }
  }
  // the squared residuals of the history slots (0 elsewhere) in place of
  // x, for sigma's sums in the first design's order
  float rs[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const float e = xr[q] - pr[q];
    rs[q] = ((hq >> q) & 1u) ? e * e : 0.0f;
  }
  put_chunk(xs + beg, rs, len, vec4);
  __syncthreads();
  // sigma: thread tid adds slots tid + 256 j in j's order (a slot outside
  // the history adds +0.0, which leaves a sum of squares as it is), then
  // block_sum's shfl_down tree in each warp and the warps in order
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = tid + kBandThreads * j;
    if (t < T) ss = ss + xs[t];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(kFullWarp, ss, o);
  if (lane == 0) wss[warp] = ss;
  __syncthreads();
  ss = wss[0];
  for (int i = 1; i < kBandWarps; ++i) ss = ss + wss[i];
  const int nh = cw[nw];
  const float sigma = nh >= 2 ? sqrtf(ss / fmaxf(float(nh), 1.0f)) : CUDART_INF_F;
  bstamp(a.clocks, row, 3);

  // 4. the band over the chunk
  const float thr = a.threshold[row] * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  float up[PER], lw[PER];
  uint32_t fl = 0u, ck = 0u;  // bit q: slot beg + q flagged, checked
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    up[q] = pr[q] + thr;
    lw[q] = nan_max(pr[q] - thr, mlb);
    const int t = min(beg + q, T - 1);
    const bool chk = q < len && ((cb[t >> 5] >> (t & 31)) & 1u);
    const bool flag = chk && (((xr[q] > up[q]) && (mode & 1)) || ((xr[q] < lw[q]) && (mode & 2)));
    fl |= uint32_t(flag) << q;
    ck |= uint32_t(chk) << q;
  }
  put_chunk(a.preds + off + beg, pr, len, vec4);
  put_chunk(a.upper + off + beg, up, len, vec4);
  put_chunk(a.lower + off + beg, lw, len, vec4);
  uint8_t* fo = a.flags + off + beg;
  if (vec4) {
#pragma unroll
    for (int q = 0; q < PER; q += 4) {
      if (q < len) {
        const uint32_t f4 = (fl >> q) & 0xFu;
        *reinterpret_cast<uint32_t*>(fo + q) =
            (f4 & 1u) | ((f4 & 2u) << 7) | ((f4 & 4u) << 14) | ((f4 & 8u) << 21);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (q < len) fo[q] = (fl >> q) & 1u;
    }
  }
  unsigned count = __reduce_add_sync(kFullWarp, unsigned(__popc(fl)));
  unsigned checked = __reduce_add_sync(kFullWarp, unsigned(__popc(ck)));
  unsigned first_flag = __reduce_min_sync(kFullWarp, fl ? unsigned(beg + __ffs(fl) - 1) : T);
  if (lane == 0) {
    wint[0][warp] = int(count);
    wint[1][warp] = int(checked);
    wint[2][warp] = int(first_flag);
  }
  bstamp(a.clocks, row, 4);
  __syncthreads();
  if (tid == 0) {
    int n = 0, c = 0, f = T;
    for (int i = 0; i < kBandWarps; ++i) {
      n += wint[0][i];
      c += wint[1][i];
      f = min(f, wint[2][i]);
    }
    a.sigma[row] = sigma;
    a.count[row] = n;
    a.first_index[row] = n > 0 ? f : -1;
    a.checked[row] = c;
  }
  bstamp(a.clocks, row, 5);
}


// ---------------------------------------------------------------------------
// ma_band's long path (kStagedBandT < T <= kLongBandT; the engine's buckets
// of 8192 and 16384 slots, 4-11 days of 60 s history): a CTA a row, the row
// read from device memory once, three CTAs an SM, and the first design's
// bits. Shared memory holds x as float (chunk c of block_scan's chunks at
// c * stride, stride = per | 1: odd, so the lanes of a warp, each walking
// its own chunk, read distinct banks), the history and checked bits of
// each word, the history count before each word, and the 256 chunk totals
// then offsets: 73 KB at T = 16384, where the first design's float64 S and
// int C took 196 KB (one CTA an SM). S is never stored: the first design's
// S[j] is offset[c] + the running float64 sum of chunk c's history from 0.0
// to slot j - 1 (c = (j - 1) / per), and a thread repeats those additions.
//
//   1. stage: x from device memory a slot a lane in the row's order (the
//      stores then fall on distinct banks) to its chunk's place; mask and
//      region, 16 bytes a lane where the row allows, to the bit words.
//   2. scan: each thread sums its chunk's history from 0.0 in turn (the
//      first design's first pass); warp 1 counts the history before each
//      word and finds the first history value; warp 0 scans the chunk
//      totals (band_chunk_offsets, as the staged path).
//   3. predict: each thread walks its chunk, S at the slot from its own
//      running sum (S at the chunk's start is the chunk before's end,
//      offset + total, from the lane before), S at the window's start
//      from a second running sum that
//      repeats the additions of the start's chunk (a chunk's worth to set
//      up, then one a slot), C from the bits; it divides only where the
//      window holds history and keeps its last freeze fill (band_fill's
//      value, S at two slots by the same walk). The predictions go to their
//      output (float4 where the chunk allows) as they are found.
//   4. sigma: thread tid adds the squared residuals of the history slots
//      tid + 256 j in j's order, x from shared memory and the prediction
//      read back (from L2), then the warps' shfl_down trees and the eight
//      totals in order: block_sum's bits.
//   5. band: the slots four at a time a thread in the row's order
//      (coalesced), the predictions read back once more, x read only where
//      the band judges it, the outputs written as float4 and the flags
//      four to a word; count, checked and first index by warp reductions
//      and one barrier.
// ---------------------------------------------------------------------------
constexpr int kLongBandT = 16384;   // kernels.MAX_BAND_T
constexpr int kLongBandBlocks = 3;  // resident CTAs an SM: 80 registers, 73 KB each

__host__ __device__ inline int long_band_stride(int per) { return per | 1; }
// tot (256 float64), x (256 chunks of stride floats), hb and cb (nw + 1
// words each), cw (nw + 1 ints)
__host__ __device__ inline size_t long_band_bytes(int T) {
  const int per = (T + kBandThreads - 1) / kBandThreads;
  const size_t nw = size_t(T + 31) / 32 + 1;
  return size_t(kBandThreads) * 8 + size_t(kBandThreads) * long_band_stride(per) * 4 + nw * 12;
}

// The long path's row in shared memory.
struct LongRow {
  const double* off;  // each chunk's offset
  const float* xs;
  const uint32_t* hb;
  int per, stride;

  __device__ __forceinline__ float x(int c, int q) const { return xs[c * stride + q]; }
  __device__ __forceinline__ bool hist(int i) const { return (hb[i >> 5] >> (i & 31)) & 1u; }
  // the 32 history bits of slots i .. i + 31 (hb[nw] is 0)
  __device__ __forceinline__ uint32_t bits(int i) const {
    return __funnelshift_r(hb[i >> 5], hb[(i >> 5) + 1], i & 31);
  }
};

// The first design's S at slot j + 1 (j >= -1) as a walk keeps it: the
// running float64 sum (from 0.0) of chunk c's history to its slot q,
// c * per + q = j. step() moves it one slot on.
struct ChunkSum {
  int c, q;
  double acc;

  __device__ __forceinline__ void step(const LongRow& r) {
    if (++q == r.per) {
      ++c;
      q = 0;
      acc = 0.0;
    }
    const int i = c * r.per + q;
    acc = acc + (r.hist(i) ? double(r.x(c, q)) : 0.0);
  }
  // S[j + 1]: 0 before the row (j = -1)
  __device__ __forceinline__ double S(const LongRow& r) const {
    return q < 0 ? 0.0 : r.off[c] + acc;
  }
};

// The walk at slot j - 1, S[j] (0 <= j <= T): up to a chunk's additions.
__device__ inline ChunkSum chunk_sum_at(const LongRow& r, int j) {
  ChunkSum w{0, -1, 0.0};
  if (j == 0) return w;
  w.c = (j - 1) / r.per;
  w.q = -1;
  const int q_end = j - 1 - w.c * r.per;
  const int b = w.c * r.per;
  uint32_t hw = 0u;
  for (int q = 0; q <= q_end; ++q) {
    if ((q & 31) == 0) hw = r.bits(b + q);
    w.acc = w.acc + (((hw >> (q & 31)) & 1u) ? double(r.x(w.c, q)) : 0.0);
  }
  w.q = q_end;
  return w;
}

// band_fill on the long path's row: S from chunk_sum_at.
__device__ __noinline__ float long_band_fill(LongRow r, const int* cw, int T, int w, float first,
                                             int k) {
  if (k == 0) return first;
  int a = 0, b = T;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (hist_count(r.hb, cw, mid) >= k) b = mid; else a = mid + 1;
  }
  const int lo = min(max(a - w, 0), a);
  const int c = hist_count(r.hb, cw, a) - hist_count(r.hb, cw, lo);
  if (c <= 0) return 0.0f;
  return float((chunk_sum_at(r, a).S(r) - chunk_sum_at(r, lo).S(r)) / double(c));
}

template <bool VEC>
__global__ void __launch_bounds__(kBandThreads, kLongBandBlocks) band_long_kernel(BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wss[kBandWarps];
  __shared__ int wint[3][kBandWarps];
  __shared__ float first_s;
  __shared__ double wend[kBandWarps];  // S at the end of each warp's last chunk
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (T + kBandThreads - 1) / kBandThreads, nw = (T + 31) >> 5;
  const int stride = long_band_stride(per);
  const size_t off = size_t(row) * T;
  double* tot = reinterpret_cast<double*>(smem);
  float* xs = reinterpret_cast<float*>(tot + kBandThreads);
  uint32_t* hb = reinterpret_cast<uint32_t*>(xs + kBandThreads * stride);
  uint32_t* cb = hb + nw + 1;
  int* cw = reinterpret_cast<int*>(cb + nw + 1);
  bstamp(a.clocks, row, 0);

  // 1. stage: x a slot a lane in the row's order (slot t of chunk c = t /
  // per at q, stepped 256 slots at a time), each batch's loads issued
  // before any is stored (an index past the row reads its last slot, and
  // is dropped); mask and region to the bit words
  {
    const float* xg = a.x + off;
    const int dc = kBandThreads / per, dq = kBandThreads - dc * per;
    int c = tid / per, q = tid - c * per;
    for (int t0 = tid; t0 < T; t0 += 8 * kBandThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldg(xg + min(t0 + u * kBandThreads, T - 1));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (t0 + u * kBandThreads < T) xs[c * stride + q] = v[u];
        q += dq;
        c += dc;
        if (q >= per) {
          q -= per;
          ++c;
        }
      }
    }
  }
  if constexpr (VEC) {
    // 16 slots a lane: two lanes a word
    const uint4* m16 = reinterpret_cast<const uint4*>(a.mask + off);
    const uint4* g16 = reinterpret_cast<const uint4*>(a.region + off);
    const int n16 = T >> 4;
    for (int i0 = tid - lane; i0 < n16; i0 += kBandThreads) {
      const int i = i0 + lane;
      const uint4 mv = __ldg(m16 + min(i, n16 - 1)), gv = __ldg(g16 + min(i, n16 - 1));
      const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
      uint32_t h = 0u, k = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const bool m = (mw[b >> 2] >> (8 * (b & 3))) & 0xFFu;
        const bool g = (gw[b >> 2] >> (8 * (b & 3))) & 0xFFu;
        h |= uint32_t(m && !g) << b;
        k |= uint32_t(m && g) << b;
      }
      if (i >= n16) h = k = 0u;
      const uint32_t h2 = __shfl_xor_sync(kFullWarp, h, 1), k2 = __shfl_xor_sync(kFullWarp, k, 1);
      if ((lane & 1) == 0 && i < n16) {
        hb[i >> 1] = h | (h2 << 16);
        cb[i >> 1] = k | (k2 << 16);
      }
    }
  } else {
    // slot warp 32 + 256 j + lane: word warp + 8 j
    for (int t0 = warp * 32; t0 < T; t0 += kBandThreads) {
      const int t = min(t0 + lane, T - 1);
      const bool in = t0 + lane < T;
      const bool m = in && __ldg(a.mask + off + t), g = in && __ldg(a.region + off + t);
      const unsigned h = __ballot_sync(kFullWarp, m && !g), k = __ballot_sync(kFullWarp, m && g);
      if (lane == 0) {
        hb[t0 >> 5] = h;
        cb[t0 >> 5] = k;
      }
    }
  }
  if (tid == 0) hb[nw] = cb[nw] = 0u;
  __syncthreads();
  bstamp(a.clocks, row, 1);

  // 2. scan: the chunk from 0.0 in turn, as block_scan's first pass
  const LongRow r{tot, xs, hb, per, stride};
  const int beg = min(tid * per, T), len = min(beg + per, T) - beg;
  double total = 0.0;
  {
    uint32_t hw = 0u;
    for (int q = 0; q < len; ++q) {
      if ((q & 31) == 0) hw = r.bits(beg + q);
      total = total + (((hw >> (q & 31)) & 1u) ? double(r.x(tid, q)) : 0.0);
    }
    tot[tid] = total;
  }
  if (warp == 1) band_counts(hb, nw, cw, &first_s, [&](int i) { return r.x(i / per, i % per); });
  __syncthreads();
  if (warp == 0) band_chunk_offsets(tot);
  __syncthreads();
  // S at the chunk's end, the first design's S[beg + per]: offset + total;
  // the chunk before this one's is S at this chunk's start
  const double s_end = tot[tid] + total;
  if (lane == 31) wend[warp] = s_end;
  __syncthreads();
  const double s_beg = __shfl_up_sync(kFullWarp, s_end, 1);
  bstamp(a.clocks, row, 2);

  // 3. predict the chunk's slots
  if (len > 0) {
    const int w = a.window;
    const float first = first_s;
    float* pout = a.preds + off + beg;
    // S at the slot: the chunk before's end, then offset + the chunk's own
    // running sum (the first design's S[t + 1] = pre + loc)
    const double pre = tot[tid];
    double loc = 0.0, s_t = lane > 0 ? s_beg : (warp > 0 ? wend[warp - 1] : 0.0);
    int lo = min(max(beg - w, 0), beg);
    ChunkSum start = chunk_sum_at(r, lo);  // S at the window's start
    int chi = hist_count(hb, cw, beg), clo = hist_count(hb, cw, lo);
    int k_kept = -1;
    float p_kept = 0.0f;
    uint32_t hw = 0u;
    for (int q0 = 0; q0 < len; q0 += 4) {
      float pr[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u, t = beg + q;
        pr[u] = 0.0f;
        if (q < len) {
          const int lo_t = min(max(t - w, 0), t);
          while (lo < lo_t) {
            clo += r.hist(lo);
            start.step(r);
            ++lo;
          }
          if (chi > clo) {
            pr[u] = float((s_t - start.S(r)) / double(chi - clo));
          } else {
            if (chi != k_kept) {
              p_kept = long_band_fill(r, cw, T, w, first, chi);
              k_kept = chi;
            }
            pr[u] = p_kept;
          }
          if ((q & 31) == 0) hw = r.bits(t);
          const bool h = (hw >> (q & 31)) & 1u;
          chi += h;
          loc = loc + (h ? double(r.x(tid, q)) : 0.0);
          s_t = pre + loc;
        }
      }
      if (VEC) {
        *reinterpret_cast<float4*>(pout + q0) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q0 + u < len) pout[q0 + u] = pr[u];
        }
      }
    }
  }
  __syncthreads();  // the predictions in device memory are the block's to read

  // 4. sigma: slots tid + 256 j in j's order, chunk c = t / per at q
  const float* pg = a.preds + off;
  float ss = 0.0f;
  {
    const int dc = kBandThreads / per, dq = kBandThreads - dc * per;
    int c = tid / per, q = tid - c * per;
    for (int t = tid; t < T; t += kBandThreads) {
      if (r.hist(t)) {
        const float e = r.x(c, q) - pg[t];
        ss = ss + e * e;
      }
      q += dq;
      c += dc;
      if (q >= per) {
        q -= per;
        ++c;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(kFullWarp, ss, o);
  if (lane == 0) wss[warp] = ss;
  __syncthreads();
  ss = wss[0];
  for (int i = 1; i < kBandWarps; ++i) ss = ss + wss[i];
  const int nh = cw[nw];
  const float sigma = nh >= 2 ? sqrtf(ss / fmaxf(float(nh), 1.0f)) : CUDART_INF_F;
  bstamp(a.clocks, row, 3);

  // 5. the band, four slots at a time a thread in the row's order
  const float thr = a.threshold[row] * sigma;
  const float mlb = a.min_lower_bound[row];
  int mode = a.bound_mode[row];
  mode = mode == 0 ? 3 : mode;
  unsigned count = 0u, checked = 0u, first_flag = unsigned(T);
  for (int t0 = 4 * tid; t0 < T; t0 += 4 * kBandThreads) {
    float p[4], up[4], lw[4];
    uint32_t fl = 0u, ck = 0u;
    if (VEC) {
      const float4 p4 = *reinterpret_cast<const float4*>(pg + t0);
      p[0] = p4.x;
      p[1] = p4.y;
      p[2] = p4.z;
      p[3] = p4.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = pg[min(t0 + u, T - 1)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = min(t0 + u, T - 1);
      up[u] = p[u] + thr;
      lw[u] = nan_max(p[u] - thr, mlb);
      const bool chk = t0 + u < T && ((cb[t >> 5] >> (t & 31)) & 1u);
      bool flag = false;
      if (chk) {  // x is read only where the band judges it
        const int c = t / per;
        const float xv = r.x(c, t - c * per);
        flag = ((xv > up[u]) && (mode & 1)) || ((xv < lw[u]) && (mode & 2));
      }
      fl |= uint32_t(flag) << u;
      ck |= uint32_t(chk) << u;
    }
    if (VEC) {
      *reinterpret_cast<float4*>(a.upper + off + t0) = make_float4(up[0], up[1], up[2], up[3]);
      *reinterpret_cast<float4*>(a.lower + off + t0) = make_float4(lw[0], lw[1], lw[2], lw[3]);
      *reinterpret_cast<uint32_t*>(a.flags + off + t0) =
          (fl & 1u) | ((fl & 2u) << 7) | ((fl & 4u) << 14) | ((fl & 8u) << 21);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (t0 + u < T) {
          a.upper[off + t0 + u] = up[u];
          a.lower[off + t0 + u] = lw[u];
          a.flags[off + t0 + u] = (fl >> u) & 1u;
        }
      }
    }
    count += __popc(fl);
    checked += __popc(ck);
    if (fl) first_flag = min(first_flag, unsigned(t0 + __ffs(fl) - 1));
  }
  count = __reduce_add_sync(kFullWarp, count);
  checked = __reduce_add_sync(kFullWarp, checked);
  first_flag = __reduce_min_sync(kFullWarp, first_flag);
  if (lane == 0) {
    wint[0][warp] = int(count);
    wint[1][warp] = int(checked);
    wint[2][warp] = int(first_flag);
  }
  bstamp(a.clocks, row, 4);
  __syncthreads();
  if (tid == 0) {
    int n = 0, c = 0, f = T;
    for (int i = 0; i < kBandWarps; ++i) {
      n += wint[0][i];
      c += wint[1][i];
      f = min(f, wint[2][i]);
    }
    a.sigma[row] = sigma;
    a.count[row] = n;
    a.first_index[row] = n > 0 ? f : -1;
    a.checked[row] = c;
  }
  bstamp(a.clocks, row, 5);
}

}  // namespace fm

static size_t ma_band_smem(int T) { return size_t(T + 1) * 12; }

extern "C" int fm_ma_band(const float* x, const uint8_t* mask, const uint8_t* region, int window,
                          const float* threshold, const int* bound_mode,
                          const float* min_lower_bound, int B, int T, float* preds, float* sigma,
                          float* upper, float* lower, uint8_t* flags, int* count,
                          int* first_index, int* checked, long long* clocks, void* stream) {
  fm::BandArgs a{x, mask, region, window, nullptr, threshold, bound_mode, min_lower_bound, T,
                 preds, sigma, upper, lower, flags, count, first_index, checked, clocks};
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
                 nullptr, sigma, upper, lower, flags, count, first_index, checked, nullptr};
  fm::band_kernel<false><<<B, fm::kBandThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <int PER>
static int launch_band_staged(const fm::BandArgs& a, int B, bool vec, cudaStream_t st) {
  const size_t smem = fm::staged_band_bytes(a.T);
  cudaError_t e = cudaFuncSetAttribute(fm::band_staged_kernel<PER>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::band_staged_kernel<PER><<<B, fm::kBandThreads, smem, st>>>(a, vec);
  return int(cudaGetLastError());
}

extern "C" int fm_staged_band_t() { return fm::kStagedBandT; }

// ma_band's staged path (T <= 4096), the same arguments as fm_ma_band.
extern "C" int fm_ma_band_staged(const float* x, const uint8_t* mask, const uint8_t* region,
                                 int window, const float* threshold, const int* bound_mode,
                                 const float* min_lower_bound, int B, int T, float* preds,
                                 float* sigma, float* upper, float* lower, uint8_t* flags,
                                 int* count, int* first_index, int* checked, long long* clocks,
                                 void* stream) {
  if (T < 1 || T > fm::kStagedBandT) return int(cudaErrorInvalidValue);
  fm::BandArgs a{x, mask, region, window, nullptr, threshold, bound_mode, min_lower_bound, T,
                 preds, sigma, upper, lower, flags, count, first_index, checked, clocks};
  const int per = (T + fm::kBandThreads - 1) / fm::kBandThreads;
  // float4 loads: whole rows of whole float4s, chunks of whole float4s
  const bool vec = T % 4 == 0 && per % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fm::next_pow2(per)) {
    case 1: return launch_band_staged<1>(a, B, vec, st);
    case 2: return launch_band_staged<2>(a, B, vec, st);
    case 4: return launch_band_staged<4>(a, B, vec, st);
    case 8: return launch_band_staged<8>(a, B, vec, st);
    default: return launch_band_staged<16>(a, B, vec, st);
  }
}

template <bool VEC>
static int launch_band_long(const fm::BandArgs& a, int B, cudaStream_t st) {
  const size_t smem = fm::long_band_bytes(a.T);
  cudaError_t e = cudaFuncSetAttribute(fm::band_long_kernel<VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(fm::band_long_kernel<VEC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           int(cudaSharedmemCarveoutMaxShared));
  if (e != cudaSuccess) return int(e);
  fm::band_long_kernel<VEC><<<B, fm::kBandThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}

static bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// ma_band's long path (4096 < T <= 16384), the same arguments as fm_ma_band.
extern "C" int fm_ma_band_long(const float* x, const uint8_t* mask, const uint8_t* region,
                               int window, const float* threshold, const int* bound_mode,
                               const float* min_lower_bound, int B, int T, float* preds,
                               float* sigma, float* upper, float* lower, uint8_t* flags,
                               int* count, int* first_index, int* checked, long long* clocks,
                               void* stream) {
  if (T <= fm::kStagedBandT || T > fm::kLongBandT) return int(cudaErrorInvalidValue);
  fm::BandArgs a{x, mask, region, window, nullptr, threshold, bound_mode, min_lower_bound, T,
                 preds, sigma, upper, lower, flags, count, first_index, checked, clocks};
  const int per = (T + fm::kBandThreads - 1) / fm::kBandThreads;
  // rows of whole float4s and whole 16-byte mask words, chunks of whole
  // float4s, every array aligned to them
  const bool vec = T % 16 == 0 && per % 4 == 0 && aligned(x, 16) && aligned(mask, 16) &&
                   aligned(region, 16) && aligned(preds, 16) && aligned(upper, 16) &&
                   aligned(lower, 16) && aligned(flags, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_band_long<true>(a, B, st) : launch_band_long<false>(a, B, st);
}

extern "C" long long fm_long_band_bytes(int T) { return (long long)fm::long_band_bytes(T); }
