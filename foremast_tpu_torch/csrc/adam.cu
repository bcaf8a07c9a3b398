// Kernel M: `adam`, the fused Adam update of J jobs' parameter rows after
// kernel L, in one launch.
//
// Replaces the optimizer half of the reference's jitted
// models/lstm_ae.py:train_step (:144; optax.adam(1e-3)'s tx.update and
// optax.apply_updates), vmapped over jobs by _train_step_fleet (:196).
//   1. Per job, once per CTA (its thread 0, into shared memory): n_j, the
//      sum of cnt[j, :] in float64 in block order, 1 / max(n_j, 1) in
//      float32, the bias corrections 1 - b^t at the job's step t (after the
//      increment; b^t in float64, rounded), and in the row's first CTA the
//      loss, sum(num[j, :]) (float64, block order) / max(n_j, 1).
//   2. For each entry (j, p) of the (J, P) rows: g = the sum of the NG
//      gradient blocks gpart[j, b, p] in block order (float32; kernel L now
//      writes one), times 1 / max(n_j, 1); then optax's scale_by_adam in its
//      order of operations: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
//      b2 nu (1 - b taken in float64 and rounded, as optax's Python floats
//      are), u = (mu / bc1) / (sqrt(nu / bc2) + eps), then
//      scale_by_learning_rate's u (-lr) and apply_updates' p + u; params, mu
//      and nu in place.
// Every operation rounds once in float32 (-fmad=false; IEEE sqrt and
// division), so the result equals the twin's (models/lstm_ae.py
// reduce_partials_plain and adam_plain) bit for bit.
//
// What bounds it on an H100: the bytes, 28 an entry with one gradient
// block (params, mu and nu read and written, the gradient read), as
// PyTorch's fused Adam. A thread updates kAdamPer groups of four
// consecutive entries with float4 loads and stores when every row starts on
// 16 bytes (P a multiple of 4), of one entry otherwise; each thread issues
// its loads before the CTA waits for thread 0's per-job scalars.
#include "common.cuh"

namespace fm {

constexpr int kAdamThreads = 128, kAdamPer = 2;  // kAdamPer: groups of entries a thread

struct AdamArgs {
  float* params;
  float* mu;
  float* nu;
  const int* step;
  const float* gpart;  // (J, NG, P)
  const double* num;   // (J, NC)
  const double* cnt;   // (J, NC)
  float* loss;
  long long P;
  int J, NG, NC, cpr, vec;  // cpr: CTAs a row; vec: four entries a thread
  float lr, b1, b2, c1, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2, rounded from float64
};

struct AdamScalars {
  float inv, bc1, bc2;
};

__device__ __forceinline__ void adam_entry(float& p, float& m, float& v, float g,
                                           const AdamScalars& s, const AdamArgs& a) {
  g = g * s.inv;
  const float mn = a.c1 * g + a.b1 * m;
  const float vn = a.c2 * (g * g) + a.b2 * v;
  m = mn;
  v = vn;
  const float u = (mn / s.bc1) / (sqrtf(vn / s.bc2) + a.eps);
  p = p + u * (-a.lr);
}

__global__ void __launch_bounds__(kAdamThreads) adam_kernel(AdamArgs a) {
  __shared__ AdamScalars sc;
  const int j = blockIdx.x / a.cpr, c = blockIdx.x - j * a.cpr;
  const int width = a.vec ? 4 : 1;
  const float* gj = a.gpart + size_t(j) * a.NG * a.P;
  float4 pv[kAdamPer], mv[kAdamPer], vv[kAdamPer], gv[kAdamPer];
  long long p0[kAdamPer];
#pragma unroll
  for (int e = 0; e < kAdamPer; ++e) {
    p0[e] = (1LL * (c * kAdamPer + e) * kAdamThreads + threadIdx.x) * width;
    pv[e] = mv[e] = vv[e] = gv[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p0[e] >= a.P) continue;
    const size_t at = size_t(j) * a.P + p0[e];
    const float* gp = gj + p0[e];
    if (a.vec) {
      pv[e] = *reinterpret_cast<const float4*>(a.params + at);
      mv[e] = *reinterpret_cast<const float4*>(a.mu + at);
      vv[e] = *reinterpret_cast<const float4*>(a.nu + at);
      gv[e] = *reinterpret_cast<const float4*>(gp);
      for (int b = 1; b < a.NG; ++b) {
        const float4 q = *reinterpret_cast<const float4*>(gp + size_t(b) * a.P);
        gv[e].x += q.x;
        gv[e].y += q.y;
        gv[e].z += q.z;
        gv[e].w += q.w;
      }
    } else {
      pv[e].x = a.params[at];
      mv[e].x = a.mu[at];
      vv[e].x = a.nu[at];
      gv[e].x = gp[0];
      for (int b = 1; b < a.NG; ++b) gv[e].x += gp[size_t(b) * a.P];
    }
  }
  if (threadIdx.x == 0) {
    double n = 0.0;
    for (int b = 0; b < a.NC; ++b) n += a.cnt[size_t(j) * a.NC + b];
    const float nf = fmaxf(float(n), 1.0f);
    if (c == 0) {
      double s = 0.0;
      for (int b = 0; b < a.NC; ++b) s += a.num[size_t(j) * a.NC + b];
      a.loss[j] = float(s) / nf;
    }
    const double t = double(a.step[j]);
    sc.inv = 1.0f / nf;
    sc.bc1 = 1.0f - float(pow(double(a.b1), t));
    sc.bc2 = 1.0f - float(pow(double(a.b2), t));
  }
  __syncthreads();
  const AdamScalars s = sc;
#pragma unroll
  for (int e = 0; e < kAdamPer; ++e) {
    if (p0[e] >= a.P) continue;
    const size_t at = size_t(j) * a.P + p0[e];
    adam_entry(pv[e].x, mv[e].x, vv[e].x, gv[e].x, s, a);
    if (a.vec) {
      adam_entry(pv[e].y, mv[e].y, vv[e].y, gv[e].y, s, a);
      adam_entry(pv[e].z, mv[e].z, vv[e].z, gv[e].z, s, a);
      adam_entry(pv[e].w, mv[e].w, vv[e].w, gv[e].w, s, a);
      *reinterpret_cast<float4*>(a.params + at) = pv[e];
      *reinterpret_cast<float4*>(a.mu + at) = mv[e];
      *reinterpret_cast<float4*>(a.nu + at) = vv[e];
    } else {
      a.params[at] = pv[e].x;
      a.mu[at] = mv[e].x;
      a.nu[at] = vv[e].x;
    }
  }
}

}  // namespace fm

extern "C" int fm_adam(float* params, float* mu, float* nu, const int* step, const float* gpart,
                       const double* num, const double* cnt, float* loss, long long P, int J,
                       int NG, int NC, int vec, float lr, float b1, float b2, float c1, float c2,
                       float eps, void* stream) {
  if (P < 1 || J < 0 || NG < 1 || NC < 1 || (vec && P % 4 != 0))
    return int(cudaErrorInvalidValue);
  if (J == 0) return int(cudaSuccess);
  const long long per = 1LL * fm::kAdamThreads * fm::kAdamPer * (vec ? 4 : 1);
  const int cpr = int((P + per - 1) / per);
  fm::AdamArgs a{params, mu, nu, step, gpart, num, cnt, loss, P, J, NG, NC, cpr, vec,
                 lr,     b1, b2, c1,   c2,    eps};
  fm::adam_kernel<<<J * cpr, fm::kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
