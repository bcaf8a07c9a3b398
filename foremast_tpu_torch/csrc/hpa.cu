// Kernel I: the HPA autoscaling score, one launch for B rows, in two
// entries that share one code path.
//
// Replaces the reference's ops/hpa.py `hpa_scores` (:74, one jitted XLA
// program, with `_masked_mean` :55 and `_recent_slope` :61): per row, the
// traffic band pred +- threshold * sigma, the current traffic and the band
// means over the region, the out-of-band share of the checked slots (the
// anomaly trend takes over once n_out * 3 >= max(checked, 1)), the
// least-squares slope of the checked slots extrapolated half a region
// ahead, the per-pod demand against the per-pod capacity of the history,
// the SLA limit (static, dynamic mean + 3 sd of the history, or their
// min; a static limit relative to the history's mean where sla_absolute
// says so), the reward ramp between `safe` and the limit, the violation
// floor, the clip to [0, 100] and the reason code (violation > headroom >
// anomaly > predicted). `hpa_scores` takes sigma from the caller;
// `hpa_from_preds` computes it first, the reference's ops/forecast.py
// `residual_sigma` (:478) over tps_mask & ~region (RMS, +inf below 2
// points), and so replaces both programs of the engine's HPA launch after
// the SES predictions (kernel C). The float32 expressions are the
// reference's, in its order (-fmad=false keeps each rounding).
//
// The reference writes its masked means as x * w, which XLA's algebraic
// simplifier compiles to a select: a NaN or inf at a masked slot never
// reaches them, and an infinite sigma gives band means of +-inf, not NaN.
// The means here skip masked slots, which is that select. The one product
// of another form is the slope's sel * (t - tm) * (x - xm): the selected
// factor times x - xm at every slot, so a non-finite tps anywhere in the
// row (masked or not) makes the slope, the anomaly demand and the score
// NaN there; this kernel gives the same (below). (The engine's packers
// leave masked slots finite anyway.)
//
// What bounds it on an H100: bytes. A row reads tps and its three masks at
// every slot (7 B), tps_pred where the region or the history's sigma needs
// it and sla under its mask (4 B each), and writes 48 B; at B = 100k rows of
// T = 16384 with 10,110 valid slots that is ~19.5 GB, 5.8 ms at 3.35 TB/s.
//
// The first design (one CTA of 256 threads a row, the row staged whole in
// shared memory at 13 B a slot, six scalar loads a slot) took 36.1 ms at
// B = 100k, T = 16384 on an H100 80GB HBM3 at 700 W: 208 KB a CTA left one
// CTA and 8 warps an SM, too few loads in flight, and pass A took 74% of a
// row's cycles (clock stamps).
// This design keeps in shared memory only what pass B reads back:
//   A. one pass over the row, each thread's slots t = tid + 256 j: the
//      masks and tps of the next slots load while this slots' tps_pred and
//      sla load under their masks (padding costs its masks and tps only);
//      the sums that need no mean in float64 (counts in int); the SLA
//      history's values kept in shared memory; the region's, the selected
//      slots' and the SLA history's slots as bits (a ballot a warp); over
//      the slots outside the selection the largest and smallest tps
//      (non-finite ones as +-inf);
//   B. the sums around those means, only at the slots that have terms:
//      each warp skips a word of slots whose bits are all 0, the region's
//      tps and tps_pred are read again (through L2), the SLA history from
//      shared memory;
//   C. the scalar tail of the row in one thread.
// Each pass's sums are reduced by warp_sum_scatter, then by warp 0 across
// the warps, in block_sum_n's order. Rows of kHpaDeepT slots or more keep
// four slots' loads a thread in flight, shorter ones two (registers for
// four CTAs an SM); both give the same bits.
// 4.4 B a slot of shared memory: three CTAs an SM at T = 16384.
// The slope's product at a slot outside the selection is 0 * (x - xm): an
// exact zero unless x - xm is not finite, which, x - xm growing with x,
// holds at some such slot exactly when it holds at their largest or
// smallest tps; pass B adds NaN to the slope's sum then. Every other term
// and its order is the first design's (each thread's slots ascending, the
// same tree of additions across the block), so the outputs are the first
// design's bit for bit (SHA-256 of every output at 100k x 2048 and 16384,
// both entries; scripts/time_torch_kernels.py --period-hpa): on that card
// 8.1 ms at 16384 (4.2x faster, 1.4x its bound), 1.67 ms at 2048 (PERF.md).
#include "common.cuh"

namespace fm {

constexpr int kHpaThreads = 256;
constexpr int kHpaWarps = kHpaThreads / 32;

struct HpaArgs {
  const float* tps;
  const uint8_t* tps_mask;
  const uint8_t* region;
  const float* pred;
  const float* sigma_in;  // hpa_scores; hpa_from_preds computes it
  const float* sla;
  const uint8_t* sla_mask;
  const float* sla_static_limit;
  const int* sla_mode;
  const float* threshold;
  const float* safe;          // optional (null: 0.7)
  const float* pods_now;      // optional (null: 1)
  const float* pods_hist;     // optional (null: 1)
  const uint8_t* sla_absolute;  // optional (null: every limit absolute)
  int T;
  float* score;
  int* reason;
  float* demand;
  float* demand_per_pod;
  float* pods_now_out;
  float* current_tps;
  float* sla_current;
  float* sla_limit;
  float* tps_pred;
  float* tps_upper;
  float* tps_lower;
  float* sigma_out;  // hpa_from_preds
  long long* clocks;  // null, or (B, kHpaPhases) SM cycles a row spent per phase
};

// kernels.HPA_PHASES: pass A (loads and sums), its reduction, pass B (with
// its reduction), the tail (thread 0's cycles)
constexpr int kHpaPhases = 4;

__device__ __forceinline__ float clip01(float v) { return nan_min(nan_max(v, 0.0f), 1.0f); }

__host__ __device__ inline int hpa_words(int T) { return (T + 31) / 32; }

// The dynamic shared memory: the SLA history's values, then three bit
// planes (the region, the selection tps_mask & region, the SLA history
// sla_mask & ~region), a word per 32 slots each.
__host__ __device__ inline size_t hpa_smem(int T) {
  return 4 * size_t(T) + 12 * size_t(hpa_words(T));
}

// Two depths of pass A's loads, the same sums in the same order: rows of
// kHpaDeepT slots or more keep four slots a thread in flight beside the
// next four (three CTAs an SM, held there by shared memory at T = 16384);
// shorter rows two and two, in registers that let four CTAs share an SM
// without spilling (capped for five, the spills cost 26% at T = 2048).
constexpr int kHpaDeepT = 4096;
template <int U>
struct HpaDepth {
  static constexpr int kMinBlocks = U >= 4 ? 3 : 4;
};

template <bool kSigma, int U>
__global__ void __launch_bounds__(kHpaThreads, HpaDepth<U>::kMinBlocks) hpa_kernel(HpaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  __shared__ double tot[12];
  __shared__ float ext_w[2 * kHpaWarps], ext_tot[2];
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = hpa_words(T);
  const size_t off = size_t(row) * T;
  float* ss = reinterpret_cast<float*>(smem);
  uint32_t* rgb = reinterpret_cast<uint32_t*>(ss + T);
  uint32_t* selb = rgb + W;
  uint32_t* shb = selb + W;
  const bool timed = a.clocks != nullptr;
  long long* clk = timed ? a.clocks + size_t(row) * kHpaPhases : nullptr;
  long long c_mark = timed ? clock64() : 0;
  auto lap = [&](int k) {
    if (timed) {
      const long long c = clock64();
      if (tid == 0) clk[k] = c - c_mark;
      c_mark = c;
    }
  };

  // A. n_sel, sum x sel, sum t sel, n_reg, sum pred reg, n_prov, sum x prov,
  //    n_sla_hist, sum sla hist, n_sla_cur, sum sla cur, sum resid^2; the
  //    counts in int, the rest float64 as the first design summed them
  int n[5] = {0, 0, 0, 0, 0};  // n_sel, n_reg, n_prov, n_sla_hist, n_sla_cur
  double s[12] = {};
  // the slots outside the selection: largest tps and minus the smallest,
  // a non-finite tps counted as +inf in both
  float ext[2] = {-CUDART_INF_F, -CUDART_INF_F};
  // the next U slots' masks and tps load while this U slots' tps_pred and
  // sla, which wait on their masks, do
  uint8_t tm_n[U], sm_n[U], rg_n[U];
  float x_n[U];
  auto load_head = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kHpaThreads;
      const bool in = t < T;
      tm_n[u] = in ? a.tps_mask[off + t] : uint8_t(0);
      sm_n[u] = in ? a.sla_mask[off + t] : uint8_t(0);
      rg_n[u] = in ? a.region[off + t] : uint8_t(0);
      x_n[u] = in ? a.tps[off + t] : 0.0f;
    }
  };
  load_head(tid);
  // the bound is the warp's first slot: every lane reaches the ballots
  for (int t0 = tid; t0 - lane < T; t0 += kHpaThreads * U) {
    bool tm[U], sm[U], rg[U];
    float x[U], p[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kHpaThreads;
      tm[u] = tm_n[u];
      sm[u] = sm_n[u];
      rg[u] = rg_n[u];
      x[u] = x_n[u];
      p[u] = (rg[u] || (kSigma && tm[u])) ? a.pred[off + t] : 0.0f;
      y[u] = sm[u] ? a.sla[off + t] : 0.0f;
    }
    load_head(t0 + kHpaThreads * U);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kHpaThreads;
      const bool sel = tm[u] && rg[u];
      const uint32_t rw = __ballot_sync(kFullWarp, rg[u]);
      const uint32_t sw = __ballot_sync(kFullWarp, sel);
      const uint32_t hw = __ballot_sync(kFullWarp, sm[u] && !rg[u]);
      if (lane == 0 && t < T) {  // t is the word's first slot
        rgb[t >> 5] = rw;
        selb[t >> 5] = sw;
        shb[t >> 5] = hw;
      }
      if (sel) {
        n[0] += 1;
        s[1] += double(x[u]);
        s[2] += double(t);
      } else if (t < T) {
        const bool fin = isfinite(x[u]);
        ext[0] = fmaxf(ext[0], fin ? x[u] : CUDART_INF_F);
        ext[1] = fmaxf(ext[1], fin ? -x[u] : CUDART_INF_F);
      }
      if (rg[u]) {
        n[1] += 1;
        s[4] += double(p[u]);
      }
      if (tm[u] && !rg[u]) {
        n[2] += 1;
        s[6] += double(x[u]);
        if (kSigma) {
          const float r = x[u] - p[u];
          s[11] += double(r * r);
        }
      }
      if (sm[u] && !rg[u]) {
        n[3] += 1;
        s[8] += double(y[u]);
        ss[t] = y[u];
      }
      if (sm[u] && rg[u]) {
        n[4] += 1;
        s[10] += double(y[u]);
      }
    }
  }
  lap(0);
  // the block's totals: each warp's by warp_sum_scatter, then warp 0 adds
  // the warps' in order (block_sum's tree) and takes the extremes
  {
    double v[16] = {double(n[0]), s[1], s[2], double(n[1]), s[4], double(n[2]), s[6],
                    double(n[3]), s[8], double(n[4]), s[10], s[11]};
    const double wt = warp_sum_scatter(v);  // lanes 2k, 2k + 1: value k
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ext[0] = fmaxf(ext[0], __shfl_xor_sync(kFullWarp, ext[0], o));
      ext[1] = fmaxf(ext[1], __shfl_xor_sync(kFullWarp, ext[1], o));
    }
    double* slots = scr.as<double>();
    if ((lane & 1) == 0) slots[warp * 16 + (lane >> 1)] = wt;
    if (lane == 0) {
      ext_w[warp * 2] = ext[0];
      ext_w[warp * 2 + 1] = ext[1];
    }
    __syncthreads();  // also publishes the bits and the SLA history
    if (warp == 0) {
      if (lane < 12) {
        double v_ = slots[lane];
        for (int w = 1; w < kHpaWarps; ++w) v_ += slots[w * 16 + lane];
        tot[lane] = v_;
      } else if (lane < 14) {
        float e = ext_w[lane - 12];
        for (int w = 1; w < kHpaWarps; ++w) e = fmaxf(e, ext_w[w * 2 + lane - 12]);
        ext_tot[lane - 12] = e;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 12; ++k) s[k] = tot[k];
    ext[0] = ext_tot[0];
    ext[1] = ext_tot[1];
  }
  lap(1);
  const float n_sel = float(s[0]), n_reg = float(s[3]), n_prov = float(s[5]);
  const float n_sh = float(s[7]), n_sc = float(s[9]);
  const float current = float(s[1]) / fmaxf(n_sel, 1.0f);  // = the slope's xm
  const float tmean = float(s[2]) / fmaxf(n_sel, 1.0f);
  const float pred_mean = float(s[4]) / fmaxf(n_reg, 1.0f);
  const float provisioned = float(s[6]) / fmaxf(n_prov, 1.0f);
  const float sla_mu = float(s[8]) / fmaxf(n_sh, 1.0f);
  const float sla_cur = float(s[10]) / fmaxf(n_sc, 1.0f);
  float sigma;
  if constexpr (kSigma) {
    sigma = n_prov >= 2.0f ? sqrtf(float(s[11]) / fmaxf(n_prov, 1.0f)) : CUDART_INF_F;
  } else {
    sigma = a.sigma_in[row];
  }
  const float thr = a.threshold[row] * sigma;

  // B. sum upper reg, sum lower reg, n_out, slope cov, slope var, sla var
  double q[8] = {};
  for (int t = tid; t < T; t += kHpaThreads) {
    const int w = t >> 5;
    const uint32_t rw = rgb[w], hw = shb[w];
    if ((rw | hw) == 0u) continue;  // the whole warp's word: uniform
    if ((rw >> lane) & 1u) {
      const float x = a.tps[off + t], p = a.pred[off + t];
      const bool sel = (selb[w] >> lane) & 1u;
      const float upper = p + thr, lower = p - thr;
      q[0] += double(upper);
      q[1] += double(lower);
      if (sel && (x > upper || x < lower)) q[2] += 1.0;
      if (sel) {
        const float dt = float(t) - tmean;
        q[3] += double(dt * (x - current));
        q[4] += double(dt * dt);
      }
    }
    if ((hw >> lane) & 1u) {
      const float dv = ss[t] - sla_mu;
      q[5] += double(dv * dv);
    }
  }
  // the slope's products outside the selection: 0 * (x - xm), NaN where
  // x - xm is not finite
  if (tid == 0 && s[0] < double(T) &&
      !(isfinite(ext[0] - current) && isfinite(-ext[1] - current)))
    q[3] += double(CUDART_NAN_F);
  {
    const double wq = warp_sum_scatter(q);  // lanes 4k..4k + 3: value k
    double* slots = scr.as<double>();  // warp 0 read pass A's before the last barrier
    if ((lane & 3) == 0) slots[warp * 8 + (lane >> 2)] = wq;
    __syncthreads();
    if (warp != 0) return;
    double v_ = 0.0;
    if (lane < 6) {
      v_ = slots[lane];
      for (int w = 1; w < kHpaWarps; ++w) v_ += slots[w * 8 + lane];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = __shfl_sync(kFullWarp, v_, k);
  }
  lap(2);
  if (tid != 0) return;

  // C. the scalar tail
  const float upper_mean = float(q[0]) / fmaxf(n_reg, 1.0f);
  const float lower_mean = float(q[1]) / fmaxf(n_reg, 1.0f);
  const int n_out = int(q[2]);
  const int n_checked = max(int(s[0]), 1);
  const bool anomalous = n_out * 3 >= n_checked;
  const float horizon = n_reg * 0.5f;
  const float slope = float(q[3]) / nan_max(float(q[4]), 1e-6f);
  const float anomaly_demand = current + slope * horizon;
  const float demand = nan_max(anomalous ? anomaly_demand : pred_mean, 0.0f);
  const float p_now = a.pods_now != nullptr ? nan_max(a.pods_now[row], 1e-6f) : 1.0f;
  const float p_hist = a.pods_hist != nullptr ? nan_max(a.pods_hist[row], 1e-6f) : 1.0f;
  const float demand_per_pod = demand / p_now;
  const float capacity_per_pod = provisioned / p_hist;

  const float sla_sd = sqrtf(nan_max(float(q[5]) / fmaxf(n_sh, 1.0f), 1e-12f));
  const float dyn_limit = sla_mu + 3.0f * sla_sd;
  const float lim = a.sla_static_limit[row];
  const float static_eff =
      (a.sla_absolute == nullptr || a.sla_absolute[row]) ? lim : lim * sla_mu;
  const int mode = a.sla_mode[row];
  const float limit = mode == 0 ? static_eff
                      : mode == 1 ? dyn_limit
                                  : nan_min(static_eff, dyn_limit);
  const bool violated = sla_cur > limit;

  const float safe = a.safe != nullptr ? a.safe[row] : 0.7f;
  const float h = sla_cur / nan_max(limit, 1e-9f);
  const float base = 50.0f * demand_per_pod / nan_max(capacity_per_pod, 1e-6f);
  const float w = clip01((1.0f - h) / nan_max(1.0f - safe, 1e-6f));
  const float shaped = base < 50.0f ? 50.0f - (50.0f - base) * w : base;
  const float viol_floor = 75.0f + 25.0f * clip01(h - 1.0f);
  float score = violated ? nan_max(base, viol_floor) : shaped;
  score = nan_min(nan_max(score, 0.0f), 100.0f);
  const bool suppressed = !violated && base < 50.0f && w < 1.0f;

  a.score[row] = score;
  a.reason[row] = violated ? 2 : suppressed ? 3 : anomalous ? 1 : 0;
  a.demand[row] = demand;
  a.demand_per_pod[row] = demand_per_pod;
  a.pods_now_out[row] = p_now;
  a.current_tps[row] = current;
  a.sla_current[row] = sla_cur;
  a.sla_limit[row] = limit;
  a.tps_pred[row] = pred_mean;
  a.tps_upper[row] = upper_mean;
  a.tps_lower[row] = lower_mean;
  if constexpr (kSigma) a.sigma_out[row] = sigma;
  lap(3);
}

}  // namespace fm

template <bool kSigma, int U>
static int launch_hpa_depth(const fm::HpaArgs& a, int B, void* stream) {
  const size_t smem = fm::hpa_smem(a.T);
  cudaError_t e = cudaFuncSetAttribute(fm::hpa_kernel<kSigma, U>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::hpa_kernel<kSigma, U><<<B, fm::kHpaThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <bool kSigma>
static int launch_hpa(const fm::HpaArgs& a, int B, void* stream) {
  return a.T >= fm::kHpaDeepT ? launch_hpa_depth<kSigma, 4>(a, B, stream)
                              : launch_hpa_depth<kSigma, 2>(a, B, stream);
}

// The outputs, in the order both entries take them: score, reason, demand,
// demand_per_pod, pods_now, current_tps, sla_current, sla_limit, tps_pred,
// tps_upper, tps_lower.
extern "C" int fm_hpa_scores(const float* tps, const uint8_t* tps_mask, const uint8_t* region,
                             const float* pred, const float* sigma, const float* sla,
                             const uint8_t* sla_mask, const float* sla_static_limit,
                             const int* sla_mode, const float* threshold, const float* safe,
                             const float* pods_now, const float* pods_hist,
                             const uint8_t* sla_absolute, int B, int T, float* score,
                             int* reason, float* demand, float* demand_per_pod,
                             float* pods_now_out, float* current_tps, float* sla_current,
                             float* sla_limit, float* tps_pred, float* tps_upper,
                             float* tps_lower, long long* clocks, void* stream) {
  fm::HpaArgs a{tps, tps_mask, region, pred, sigma, sla, sla_mask, sla_static_limit, sla_mode,
                threshold, safe, pods_now, pods_hist, sla_absolute, T, score, reason, demand,
                demand_per_pod, pods_now_out, current_tps, sla_current, sla_limit, tps_pred,
                tps_upper, tps_lower, nullptr, clocks};
  return launch_hpa<false>(a, B, stream);
}

extern "C" int fm_hpa_from_preds(const float* tps, const uint8_t* tps_mask,
                                 const uint8_t* region, const float* pred, const float* sla,
                                 const uint8_t* sla_mask, const float* sla_static_limit,
                                 const int* sla_mode, const float* threshold, const float* safe,
                                 const float* pods_now, const float* pods_hist,
                                 const uint8_t* sla_absolute, int B, int T, float* score,
                                 int* reason, float* demand, float* demand_per_pod,
                                 float* pods_now_out, float* current_tps, float* sla_current,
                                 float* sla_limit, float* tps_pred, float* tps_upper,
                                 float* tps_lower, float* sigma, long long* clocks,
                                 void* stream) {
  fm::HpaArgs a{tps, tps_mask, region, pred, nullptr, sla, sla_mask, sla_static_limit,
                sla_mode, threshold, safe, pods_now, pods_hist, sla_absolute, T, score, reason,
                demand, demand_per_pod, pods_now_out, current_tps, sla_current, sla_limit,
                tps_pred, tps_upper, tps_lower, sigma, clocks};
  return launch_hpa<true>(a, B, stream);
}
