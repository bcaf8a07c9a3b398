// Kernel F: `detect_period`, the seasonal period of B rows in one launch.
//
// Replaces the reference's jitted ops/forecast.py:detect_period (:225-346).
// For each row:
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
// What bounds it on an H100: the float-to-double conversions of its terms.
// A lag's sums take float32 products, each added to a float64 sum, and
// sm_90 converts float to double at 16 a clock an SM, a quarter of its
// float64 add rate. The first design (one CTA a row, each distinct lag
// swept alone, four block reductions a lag, the row staged with a load of x
// waiting on its mask byte) took 35.7 ms at B = 100k, T = 16384 with the
// engine's four candidates on an H100 80GB HBM3 at 700 W, its thread 0's
// cycles split stage 46%, sweeps 35%, reductions 10% (clock stamps). This
// design:
//   - stages the row eight slots a thread at a time, each x loaded only
//     under its mask while the next slots' mask bytes are in flight, the
//     mask kept as bits (one ballot a warp) beside the residuals: 4.1 B a
//     slot of shared memory, three CTAs an SM at T = 16384 (two before);
//   - sweeps each row once per batch of up to kLagBatch distinct lags,
//     reading a slot's residual once for the whole batch, and ends each
//     sweep at the row's last valid slot (while its residuals are finite
//     the terms after it are exact zeros);
//   - marks a masked slot's residual -0.0 so that a finite row's sweep
//     reads its mask from the residual, drops the terms that are exact
//     zeros, and converts a lag slot's square once for every lag of the
//     batch: two conversions a slot and lag, not three;
//   - counts each lag's supporting pairs by popcount over the mask's words;
//   - reduces a batch's sums and counts with warp_sum_scatter and one
//     barrier (warp 0 adds the warps' totals), where the first design took
//     four block reductions a lag;
//   - builds the lag table (the distinct lags in ascending order, each
//     candidate's lag and half-lag index) once per CTA, whose rows run
//     grid-stride, not a lag cache in local memory per row.
// Each thread sums the slots t = tid + 256 j in ascending order and every
// total adds the same partial sums in the same tree as the first design's
// block reductions, so every sum takes the same terms in the same order:
// the outputs are the first design's bit for bit (SHA-256 of every output
// at 100k x 16384 on the card; scripts/time_torch_kernels.py --period-hpa).
// Rows whose residuals are not all finite (an infinite or NaN value under
// the mask) keep the first design's sweep over every pair, in which no term
// is dropped. 10.0 ms at that shape on that card, 3.4x its 3.0 ms bound
// (PERF.md).
//
// Past kTileCandidates candidates (the tiled path, kernels.period_path)
// the lag table holds a tile of them and is rebuilt for each row after its
// residuals; the scores and eligibility of every candidate stay in shared
// memory for the pick (5 B a candidate bounds C: fm_period_max_candidates).
// A lag's sums do not depend on the lags swept beside it, so every output
// is what one table would give (forced at C <= kTileCandidates, the tiled
// path gives the table path's bits).
//
// Built with -fmad=false, as the rest of the library.
#include "common.cuh"

namespace fm {

constexpr int kPeriodThreads = 256;
constexpr int kWarps = kPeriodThreads / 32;
// candidates of one lag table: up to this many the table is built once a
// CTA (the first design); above it the candidates are swept in tiles of
// this many, a tile's table built for each row (kernels.TILE_CANDIDATES)
constexpr int kTileCandidates = 1024;
// the tiled path's dynamic shared memory stays under an H100 CTA's most
// (232,448 B) less the kernel's static arrays
constexpr size_t kPeriodSmemBudget = 232448 - 12 * 1024;
// distinct lags swept together (the engine's four candidates have seven); a
// batch's three float64 sums a lag live in registers, and its num, sa, sb
// and pair counts fill a warp's 32 reduction slots
constexpr int kLagBatch = 8;
// mask bytes (and x loads) a thread has in flight while staging
constexpr int kStageUnroll = 8;

struct PeriodArgs {
  const float* x;
  const uint8_t* mask;
  const int* cands;
  int C;
  const int* fallback;
  float min_acf;
  float alias_margin;
  float contrast_margin;
  int B;
  int T;
  int* period;
  float* scores;
  long long* clocks;  // null, or (B, kPeriodPhases) SM cycles a row spent per phase
};

// kernels.PERIOD_PHASES: stage, detrend, sweeps, reductions, pick (thread
// 0's cycles; a phase that ends in a barrier includes the wait for the
// slowest warp)
constexpr int kPeriodPhases = 5;

__host__ __device__ inline int period_words(int T) { return (T + 31) / 32; }

// Distinct lags of C candidates in a row of T slots, at most.
__host__ __device__ inline int period_max_lags(int C, int T) { return min(2 * C, T); }

// The dynamic shared memory, in bytes and in this order: the residuals
// (whose space the lag table's bitmap and prefix counts take while it is
// built), the mask's words, the lags and their scores, each candidate's lag
// and half-lag index, its score and eligibility.
__host__ __device__ inline size_t period_smem(int T, int C) {
  const size_t W = size_t(period_words(T)), NL = size_t(period_max_lags(C, T));
  const size_t d = (4 * size_t(T) + 8 + 15) / 16 * 16;
  return d + 4 * W + 8 * NL + 12 * size_t(C) + size_t(C);
}

// The tiled path's: the residuals, the mask's words, the lag bitmap and its
// prefix counts, a tile's lags and scores, a tile's lag and half-lag
// indices, then every candidate's score and eligibility.
__host__ __device__ inline size_t period_tiled_smem(int T, int C) {
  const size_t W = size_t(period_words(T)), NL = size_t(period_max_lags(kTileCandidates, T));
  const size_t d = (4 * size_t(T) + 8 + 15) / 16 * 16;
  return d + 12 * W + 8 * NL + 8 * size_t(kTileCandidates) + 5 * size_t(C);
}

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int t) {
  return (bits[t >> 5] >> (t & 31)) & 1u;
}

// A masked slot's residual is -0.0f, a bit pattern no valid residual keeps:
// a valid -0.0 is stored as +0.0. That changes no sum: each float64 sum
// here starts at +0.0 and so never holds -0.0, and adding either zero
// leaves it as it is. A masked slot's terms are zeros too (the first
// design's weight w is 0 there), so a finite row's sweep reads each slot's
// mask from its residual.
__device__ __forceinline__ bool unmasked(float v) { return __float_as_uint(v) != 0x80000000u; }

// Finite rows: the sums of the batch's NB lags lp[0] < ... < lp[NB - 1] over
// each thread's slots t = tid + 256 j, pairs (t, t + p) with t + p < end
// (one past the last valid slot), dropping the terms that are exact zeros:
// a masked lag slot's and, but for sb's mask test, a masked lead slot's.
// The slots where every lag has its pair run without a bound test.
template <int NB>
__device__ __forceinline__ void sweep_finite(const float* d, int end, const int* lp,
                                             double (&num)[kLagBatch], double (&sa)[kLagBatch],
                                             double (&sb)[kLagBatch]) {
  int P[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) P[i] = lp[i];
  int t = threadIdx.x;
  for (; t < end - P[NB - 1]; t += kPeriodThreads) {
    const float lag = d[t];
    if (!unmasked(lag)) continue;
    const double qb = double(lag * lag);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float lead = d[t + P[i]];
      num[i] += double(lead * lag);
      sa[i] += double(lead * lead);
      if (unmasked(lead)) sb[i] += qb;
    }
  }
  for (; t < end - P[0]; t += kPeriodThreads) {
    const float lag = d[t];
    if (!unmasked(lag)) continue;
    const double qb = double(lag * lag);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (t < end - P[i]) {
        const float lead = d[t + P[i]];
        num[i] += double(lead * lag);
        sa[i] += double(lead * lead);
        if (unmasked(lead)) sb[i] += qb;
      }
    }
  }
}

// Rows with a non-finite residual: the first design's terms for every pair
// t + p < T of the batch's nb lags, none dropped.
__device__ __forceinline__ void sweep_general(const float* d, const uint32_t* mb, int T,
                                              const int* lp, int nb, double (&num)[kLagBatch],
                                              double (&sa)[kLagBatch], double (&sb)[kLagBatch]) {
  for (int t = threadIdx.x; t < T - lp[0]; t += kPeriodThreads) {
    const float lag = d[t];
    const bool mt = bit_at(mb, t);
#pragma unroll
    for (int i = 0; i < kLagBatch; ++i) {
      if (i < nb && t < T - lp[i]) {
        const int s = t + lp[i];
        const float lead = d[s];
        const float w = (mt && bit_at(mb, s)) ? 1.0f : 0.0f;
        num[i] += double((w * lead) * lag);
        sa[i] += double((w * lead) * lead);
        sb[i] += double((w * lag) * lag);
      }
    }
  }
}

// The lag table of C candidates: a bitmap of the distinct lags, its words'
// prefix counts, the lags ascending, each candidate's index into them (and
// its half lag's); *nl the distinct lags. Ends in a barrier.
__device__ void period_lag_table(const int* cands, int C, int T, uint32_t* lbits, int* pre,
                                 int* lags, int* cidx, int* hidx, int* nl) {
  const int tid = threadIdx.x, W = period_words(T);
  for (int w = tid; w < W; w += kPeriodThreads) lbits[w] = 0;
  __syncthreads();
  for (int c = tid; c < C; c += kPeriodThreads) {
    const int p = cands[c];
    if (p >= 2 && p < T) {
      atomicOr(&lbits[p >> 5], 1u << (p & 31));
      if (p >= 4) atomicOr(&lbits[(p / 2) >> 5], 1u << ((p / 2) & 31));
    }
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int w = 0; w < W; ++w) {
      pre[w] = acc;
      acc += __popc(lbits[w]);
    }
    *nl = acc;
  }
  __syncthreads();
  for (int w = tid; w < W; w += kPeriodThreads) {
    uint32_t bits = lbits[w];
    for (int k = pre[w]; bits != 0; ++k, bits &= bits - 1) lags[k] = 32 * w + __ffs(bits) - 1;
  }
  auto rank = [&](int p) {
    return pre[p >> 5] + __popc(lbits[p >> 5] & ((1u << (p & 31)) - 1u));
  };
  for (int c = tid; c < C; c += kPeriodThreads) {
    const int p = cands[c];
    const bool valid = p >= 2 && p < T;
    cidx[c] = valid ? rank(p) : -1;
    hidx[c] = (valid && p >= 4) ? rank(p / 2) : -1;
  }
  __syncthreads();
}

// kTiled: the candidates in tiles of kTileCandidates, each tile's lag table
// built for each row after its residuals; every candidate's score and
// eligibility kept in shared memory for the pick, which is the first
// design's over all C. A lag's score does not depend on the lags swept
// beside it, so a candidate scores as it would in one table.
template <bool kTiled>
__global__ void __launch_bounds__(kPeriodThreads, 3) detect_period_kernel(PeriodArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  __shared__ double slots_b[kPeriodThreads];
  __shared__ int ends[kWarps];
  __shared__ int nl_s;
  __shared__ long long ck[kPeriodPhases];  // thread 0's cycles a phase, this row
  const int T = a.T, C = a.C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CT = kTiled ? kTileCandidates : C;  // candidates a lag table
  const int W = period_words(T), NL = period_max_lags(CT, T);
  float* d = reinterpret_cast<float*>(smem);
  uint32_t* mb = reinterpret_cast<uint32_t*>(smem + (4 * size_t(T) + 8 + 15) / 16 * 16);
  uint32_t* lbits = kTiled ? mb + W : reinterpret_cast<uint32_t*>(d);
  int* pre = reinterpret_cast<int*>(lbits + W);
  int* lags = kTiled ? pre + W : reinterpret_cast<int*>(mb + W);
  float* r = reinterpret_cast<float*>(lags + NL);
  int* cidx = reinterpret_cast<int*>(r + NL);
  int* hidx = cidx + CT;
  float* S = reinterpret_cast<float*>(hidx + CT);
  uint8_t* ok = reinterpret_cast<uint8_t*>(S + C);

  // the first design's lag table, once per CTA (its bitmap and prefix
  // counts in the residuals' space)
  if (!kTiled) period_lag_table(a.cands, C, T, lbits, pre, lags, cidx, hidx, &nl_s);
  int nl = nl_s;

  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    const size_t off = size_t(row) * T;
    const bool timed = a.clocks != nullptr;
    if (timed && tid == 0)
      for (int k = 0; k < kPeriodPhases; ++k) ck[k] = 0;
    long long c_mark = timed ? clock64() : 0;
    auto lap = [&](int k) {
      if (timed) {
        const long long c = clock64();
        if (tid == 0) ck[k] += c - c_mark;
        c_mark = c;
      }
    };

    // 1. stage: x under its mask into d (a masked slot -0.0), the mask's
    //    bits, the detrend's sums; the next slots' mask bytes load before
    //    this slots' x is used
    long long n_ = 0, st_ = 0, stt_ = 0;
    double sx_ = 0.0, stx_ = 0.0;
    int end = 0;  // one past the last valid slot
    bool mk[kStageUnroll], mk_next[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int t = tid + u * kPeriodThreads;
      mk_next[u] = t < T && a.mask[off + t];
    }
    // the bound is the warp's first slot: every lane reaches the ballots
    for (int t0 = tid; t0 - lane < T; t0 += kPeriodThreads * kStageUnroll) {
      float xv[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        mk[u] = mk_next[u];
        const int t = t0 + u * kPeriodThreads;
        xv[u] = mk[u] ? a.x[off + t] : -0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int t = t0 + (kStageUnroll + u) * kPeriodThreads;
        mk_next[u] = t < T && a.mask[off + t];
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int t = t0 + u * kPeriodThreads;
        const uint32_t bits = __ballot_sync(kFullWarp, mk[u]);
        if (lane == 0 && t < T) mb[t >> 5] = bits;  // t is the word's first slot
        if (t < T) d[t] = xv[u];
        if (mk[u]) {
          n_ += 1;
          st_ += t;
          stt_ += (long long)t * t;
          sx_ += double(xv[u]);
          stx_ += double(t) * double(xv[u]);
          end = t + 1;
        }
      }
    }
    lap(0);

    // 2. the trend and the residuals: one barrier for the sums and the end
    //    (the integer sums, below 2^53, are exact in float64)
    double sums[8] = {double(n_), double(st_), double(stt_), sx_, stx_};
    {
      const double tot = warp_sum_scatter(sums);  // lanes 4k..4k+3: sum k
      const unsigned wend = __reduce_max_sync(kFullWarp, unsigned(end));
      if ((lane & 3) == 0) scr.as<double>()[warp * 8 + (lane >> 2)] = tot;
      if (lane == 0) ends[warp] = int(wend);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        double v = scr.as<double>()[k];
        for (int w = 1; w < kWarps; ++w) v += scr.as<double>()[w * 8 + k];
        sums[k] = v;
      }
      end = ends[0];
      for (int w = 1; w < kWarps; ++w) end = max(end, ends[w]);
    }
    const long long n = (long long)sums[0], st = (long long)sums[1], stt = (long long)sums[2];
    const double sx = sums[3], stx = sums[4];
    const long long det = n * stt - st * st;
    const double nn = double(n > 0 ? n : 1);
    const double xbar = sx / nn, tbar = double(st) / nn;
    const double slope = det > 0 ? (stx - double(st) * xbar) / (double(det) / nn) : 0.0;
    const float slope_f = float(slope), icept_f = float(xbar - slope * tbar);
    bool finite = true;
    for (int t = tid; t < end; t += kPeriodThreads) {
      if (bit_at(mb, t)) {
        const float v = (d[t] - icept_f) - slope_f * float(t);
        d[t] = v + 0.0f;  // -0.0 marks the masked slots
        finite &= isfinite(v);
      }
    }
    finite = __syncthreads_and(finite);  // also publishes the residuals
    if (!finite) end = T;
    lap(1);

    // 3. each batch of lags: the sweep, the pairs' counts, one reduction
    //    whose totals warp 0 turns into the lags' scores (the tiled path:
    //    for each tile of candidates, after its lag table)
    for (int c0 = 0, first = 1; kTiled ? c0 < C : first; c0 += CT, first = 0) {
      const int Ct = kTiled ? min(CT, C - c0) : C;
      if (kTiled) {
        period_lag_table(a.cands + c0, Ct, T, lbits, pre, lags, cidx, hidx, &nl_s);
        nl = nl_s;
      }
      for (int b0 = 0; b0 < nl; b0 += kLagBatch) {
        const int nb = min(kLagBatch, nl - b0);
        double num[kLagBatch], sa[kLagBatch], sb[kLagBatch];
#pragma unroll
        for (int i = 0; i < kLagBatch; ++i) num[i] = sa[i] = sb[i] = 0.0;
        const int* lp = lags + b0;
        if (!finite) {
          sweep_general(d, mb, T, lp, nb, num, sa, sb);
        } else {
          static_assert(kLagBatch == 8, "one case for each batch size");
          switch (nb) {
            case 1: sweep_finite<1>(d, end, lp, num, sa, sb); break;
            case 2: sweep_finite<2>(d, end, lp, num, sa, sb); break;
            case 3: sweep_finite<3>(d, end, lp, num, sa, sb); break;
            case 4: sweep_finite<4>(d, end, lp, num, sa, sb); break;
            case 5: sweep_finite<5>(d, end, lp, num, sa, sb); break;
            case 6: sweep_finite<6>(d, end, lp, num, sa, sb); break;
            case 7: sweep_finite<7>(d, end, lp, num, sa, sb); break;
            default: sweep_finite<kLagBatch>(d, end, lp, num, sa, sb); break;
          }
        }
        // pairs with both slots valid: the mask's word w against its words
        // shifted by the lag (bits past the row are 0)
        double cnt[kLagBatch];
#pragma unroll
        for (int i = 0; i < kLagBatch; ++i) {
          int c = 0;
          if (i < nb) {
            const int q = lp[i] >> 5, sh = lp[i] & 31;
            for (int w = tid; w + q < W; w += kPeriodThreads) {
              const uint32_t lo = mb[w + q], hi = w + q + 1 < W ? mb[w + q + 1] : 0u;
              c += __popc(mb[w] & __funnelshift_r(lo, hi, sh));
            }
          }
          cnt[i] = double(c);
        }
        lap(2);
        // the warp's totals of num, sa, sb and cnt in two halves of 16 values
        // (lanes 2k, 2k + 1 hold value k of a half), into two sets of slots
        // taken in turn: warp 0 reads one batch's while the others write the
        // next one's. Slots 8 q + i of a warp's 32: lag i's num, sa, sb, cnt
        // for q = 0..3.
        double* slots = ((b0 / kLagBatch) & 1) ? slots_b : scr.as<double>();
        {
          double v[2 * kLagBatch];
#pragma unroll
          for (int i = 0; i < kLagBatch; ++i) {
            v[i] = num[i];
            v[kLagBatch + i] = sa[i];
          }
          const double tv = warp_sum_scatter(v);
          if ((lane & 1) == 0) slots[warp * 32 + (lane >> 1)] = tv;
        }
        {
          double v[2 * kLagBatch];
#pragma unroll
          for (int i = 0; i < kLagBatch; ++i) {
            v[i] = sb[i];
            v[kLagBatch + i] = cnt[i];
          }
          const double tv = warp_sum_scatter(v);
          if ((lane & 1) == 0) slots[warp * 32 + 2 * kLagBatch + (lane >> 1)] = tv;
        }
        __syncthreads();
        if (warp == 0) {
          double tot = slots[lane];
          for (int w = 1; w < kWarps; ++w) tot += slots[w * 32 + lane];
          const double va = __shfl_sync(kFullWarp, tot, (lane + kLagBatch) & 31);
          const double vb = __shfl_sync(kFullWarp, tot, (lane + 2 * kLagBatch) & 31);
          const double cn = __shfl_sync(kFullWarp, tot, (lane + 3 * kLagBatch) & 31);
          if (lane < nb) {
            const double den = sqrt(va * vb);
            const float rr = float(tot / (den == 0.0 ? 1.0 : den));
            r[b0 + lane] = (cn >= double(lp[lane]) && den > 0.0) ? rr : -CUDART_INF_F;
          }
        }
        lap(3);
      }
      __syncthreads();  // the lags' scores

      // 4. the candidates' scores and eligibility, then the pick
      for (int c = tid; c < Ct; c += kPeriodThreads) {
        const int i = cidx[c], h = hidx[c];
        const float sc = i >= 0 ? r[i] : -CUDART_INF_F;
        S[c0 + c] = sc;
        ok[c0 + c] = i >= 0 && (h < 0 || sc + a.contrast_margin >= r[h]);
        a.scores[size_t(row) * C + c0 + c] = sc;
      }
      __syncthreads();
    }
    if (tid == 0) {
      float best = -CUDART_INF_F;
      for (int c = 0; c < C; ++c) best = nan_max(best, ok[c] ? S[c] : -CUDART_INF_F);
      const float cut = nan_max(best - a.alias_margin, a.min_acf);
      int pick = -1;
      for (int c = 0; c < C && pick < 0; ++c)
        if (ok[c] && S[c] >= cut) pick = c;
      a.period[row] = pick >= 0 ? a.cands[pick] : a.fallback[row];
    }
    lap(4);
    if (timed && tid == 0)
      for (int k = 0; k < kPeriodPhases; ++k) a.clocks[size_t(row) * kPeriodPhases + k] = ck[k];
  }
}

}  // namespace fm

extern "C" int fm_detect_period(const float* x, const uint8_t* mask, const int* cands, int C,
                                const int* fallback, float min_acf, float alias_margin,
                                float contrast_margin, int B, int T, int* period, float* scores,
                                long long* clocks, int force_tiled, void* stream) {
  const bool tiled = C > fm::kTileCandidates || force_tiled;
  const size_t smem = tiled ? fm::period_tiled_smem(T, C) : fm::period_smem(T, C);
  if (C < 0 || smem > fm::kPeriodSmemBudget) return int(cudaErrorInvalidValue);
  fm::PeriodArgs a{x, mask, cands, C, fallback, min_acf, alias_margin, contrast_margin, B, T,
                   period, scores, clocks};
  void (*kern)(fm::PeriodArgs) =
      tiled ? fm::detect_period_kernel<true> : fm::detect_period_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  // persistent CTAs, rows grid-stride: each CTA builds the lag table once
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, fm::kPeriodThreads,
                                                         smem)) != cudaSuccess)
    return int(e);
  const int grid = min(B, max(sms * per_sm, 1));
  kern<<<grid, fm::kPeriodThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// The most candidates a launch at T takes (the tiled path's shared memory).
extern "C" int fm_period_max_candidates(int T) {
  int C = fm::kTileCandidates;
  const size_t base = fm::period_tiled_smem(T, 0);
  if (base <= fm::kPeriodSmemBudget) C = max(C, int((fm::kPeriodSmemBudget - base) / 5));
  return C;
}

extern "C" int fm_period_tile_candidates() { return fm::kTileCandidates; }
