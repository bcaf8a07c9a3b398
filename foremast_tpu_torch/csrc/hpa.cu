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
// NaN there; this kernel forms that product the same way. (The engine's
// packers leave masked slots finite anyway.)
//
// Design: one CTA of kHpaThreads threads per row, the row staged once in
// shared memory (tps, pred, sla and one byte of the three masks: 13 B a
// slot, 208 KB at T = 16384, the largest bucket), then
//   A. the sums that need no mean (counts, the masked sums of tps, t, pred
//      and sla, and, for hpa_from_preds, the squared history residuals):
//      float64 accumulators of the reference's float32 terms, one block
//      reduction for all of them;
//   B. from shared memory, the sums around those means (the band edges,
//      the out-of-band count, the slope's centred sums, the SLA variance):
//      two passes, as the reference computes them;
//   C. the scalar tail of the row in one thread.
//
// What bounds it on an H100: bytes. A row reads 15 B a slot (three floats,
// three masks) and writes 44 B per row against ~30 operations a slot; at
// B = 100k rows of the engine's bucket T = 2048 that is ~3.1 GB, ~0.9 ms
// at 3.35 TB/s. Staging keeps both passes to one read of device memory.
#include "common.cuh"

namespace fm {

constexpr int kHpaThreads = 256;
constexpr uint8_t kTps = 1, kSla = 2, kReg = 4;

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
};

__device__ __forceinline__ float clip01(float v) { return nan_min(nan_max(v, 0.0f), 1.0f); }

template <bool kSigma>
__global__ void __launch_bounds__(kHpaThreads) hpa_kernel(HpaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x, nt = blockDim.x;
  const size_t off = size_t(row) * T;
  float* sx = reinterpret_cast<float*>(smem);
  float* sp = sx + T;
  float* ss = sp + T;
  uint8_t* code = reinterpret_cast<uint8_t*>(ss + T);

  // A. n_sel, sum x sel, sum t sel, n_reg, sum pred reg, n_prov, sum x prov,
  //    n_sla_hist, sum sla hist, n_sla_cur, sum sla cur, sum resid^2
  double s[12] = {};
  for (int t = tid; t < T; t += nt) {
    const float x = a.tps[off + t], p = a.pred[off + t], y = a.sla[off + t];
    const bool tm = a.tps_mask[off + t], sm = a.sla_mask[off + t], rg = a.region[off + t];
    sx[t] = x;
    sp[t] = p;
    ss[t] = y;
    code[t] = (tm ? kTps : 0) | (sm ? kSla : 0) | (rg ? kReg : 0);
    if (tm && rg) {
      s[0] += 1.0;
      s[1] += double(x);
      s[2] += double(t);
    }
    if (rg) {
      s[3] += 1.0;
      s[4] += double(p);
    }
    if (tm && !rg) {
      s[5] += 1.0;
      s[6] += double(x);
      if (kSigma) {
        const float r = x - p;
        s[11] += double(r * r);
      }
    }
    if (sm && !rg) {
      s[7] += 1.0;
      s[8] += double(y);
    }
    if (sm && rg) {
      s[9] += 1.0;
      s[10] += double(y);
    }
  }
  block_sum_n(s, scr);  // its barriers also publish the staged row
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
  double q[6] = {};
  for (int t = tid; t < T; t += nt) {
    const float x = sx[t], p = sp[t];
    const uint8_t c = code[t];
    const bool rg = c & kReg;
    const bool sel = (c & kTps) && rg;
    const float upper = p + thr, lower = p - thr;
    if (rg) {
      q[0] += double(upper);
      q[1] += double(lower);
    }
    if (sel && (x > upper || x < lower)) q[2] += 1.0;
    const float dt = float(t) - tmean;
    // (sel ? t - tm : 0) * (x - xm) at every slot, as the reference forms it
    q[3] += double((sel ? dt : 0.0f) * (x - current));
    if (sel) q[4] += double(dt * dt);
    if ((c & kSla) && !rg) {
      const float dv = ss[t] - sla_mu;
      q[5] += double(dv * dv);
    }
  }
  block_sum_n(q, scr);
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
}

}  // namespace fm

static size_t hpa_smem(int T) { return size_t(T) * 13; }

template <bool kSigma>
static int launch_hpa(const fm::HpaArgs& a, int B, void* stream) {
  const size_t smem = hpa_smem(a.T);
  cudaError_t e = cudaFuncSetAttribute(fm::hpa_kernel<kSigma>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::hpa_kernel<kSigma><<<B, fm::kHpaThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
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
                             float* tps_lower, void* stream) {
  fm::HpaArgs a{tps, tps_mask, region, pred, sigma, sla, sla_mask, sla_static_limit, sla_mode,
                threshold, safe, pods_now, pods_hist, sla_absolute, T, score, reason, demand,
                demand_per_pod, pods_now_out, current_tps, sla_current, sla_limit, tps_pred,
                tps_upper, tps_lower, nullptr};
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
                                 float* tps_lower, float* sigma, void* stream) {
  fm::HpaArgs a{tps, tps_mask, region, pred, nullptr, sla, sla_mask, sla_static_limit,
                sla_mode, threshold, safe, pods_now, pods_hist, sla_absolute, T, score, reason,
                demand, demand_per_pod, pods_now_out, current_tps, sla_current, sla_limit,
                tps_pred, tps_upper, tps_lower, sigma};
  return launch_hpa<true>(a, B, stream);
}
