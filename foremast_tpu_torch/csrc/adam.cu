// Kernel M: `adam`, the fused Adam update of J jobs' parameter rows after
// kernel L, in one launch.
//
// Replaces the optimizer half of the reference's jitted
// models/lstm_ae.py:train_step (:144; optax.adam(1e-3)'s tx.update and
// optax.apply_updates), vmapped over jobs by _train_step_fleet (:196). For
// each entry (j, p) of the (J, P) rows, one thread:
//   1. g = the sum of kernel L's partials gpart[j, b, p] over the window
//      blocks b in order (float32), times 1 / max(n_j, 1), n_j the job's
//      count of valid slots (the sum of cnt[j, :], float64);
//   2. optax's scale_by_adam in its order of operations: mu = (1 - b1) g +
//      b1 mu, nu = (1 - b2) g^2 + b2 nu (1 - b taken in float64 and
//      rounded, as optax's Python floats are), the bias corrections 1 - b^t at the
//      job's step t (after the increment; b^t in float64, rounded), u =
//      (mu / bc1) / (sqrt(nu / bc2) + eps), then scale_by_learning_rate's
//      u (-lr) and apply_updates' p + u; params, mu and nu in place;
//   3. the thread of p = 0 writes the job's loss, sum(num[j, :]) / max(n_j,
//      1) (the numerator summed in float64 in block order).
// Every operation rounds once in float32 (-fmad=false; IEEE sqrt and
// division), so the result equals the twin's (models/lstm_ae.py
// reduce_partials_plain and adam_plain) bit for bit.
//
// What bounds it on an H100: the bytes. Per entry it reads nkb partials and
// reads and writes three floats (24 + 4 nkb bytes), against ~15
// operations.
#include "common.cuh"

namespace fm {

constexpr int kAdamThreads = 256;

struct AdamArgs {
  float* params;
  float* mu;
  float* nu;
  const int* step;
  const float* gpart;
  const double* num;
  const double* cnt;
  float* loss;
  long long P;
  int J, nkb;
  float lr, b1, b2, c1, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2, rounded from float64
};

__global__ void __launch_bounds__(kAdamThreads) adam_kernel(AdamArgs a) {
  const long long total = 1LL * a.J * a.P;
  for (long long i = blockIdx.x * 1LL * blockDim.x + threadIdx.x; i < total;
       i += 1LL * gridDim.x * blockDim.x) {
    const int j = int(i / a.P);
    const long long p = i - 1LL * j * a.P;
    double n = 0.0;
    for (int b = 0; b < a.nkb; ++b) n += a.cnt[size_t(j) * a.nkb + b];
    const float nf = fmaxf(float(n), 1.0f);
    if (p == 0) {
      double s = 0.0;
      for (int b = 0; b < a.nkb; ++b) s += a.num[size_t(j) * a.nkb + b];
      a.loss[j] = float(s) / nf;
    }
    const float* gp = a.gpart + size_t(j) * a.nkb * a.P + p;
    float g = gp[0];
    for (int b = 1; b < a.nkb; ++b) g += gp[size_t(b) * a.P];
    g = g * (1.0f / nf);
    const double t = double(a.step[j]);
    const float bc1 = 1.0f - float(pow(double(a.b1), t));
    const float bc2 = 1.0f - float(pow(double(a.b2), t));
    const float m = a.c1 * g + a.b1 * a.mu[i];
    const float v = a.c2 * (g * g) + a.b2 * a.nu[i];
    a.mu[i] = m;
    a.nu[i] = v;
    const float u = (m / bc1) / (sqrtf(v / bc2) + a.eps);
    a.params[i] = a.params[i] + u * (-a.lr);
  }
}

}  // namespace fm

extern "C" int fm_adam(float* params, float* mu, float* nu, const int* step, const float* gpart,
                       const double* num, const double* cnt, float* loss, long long P, int J,
                       int nkb, float lr, float b1, float b2, float c1, float c2, float eps,
                       void* stream) {
  if (P < 1 || J < 0 || nkb < 1) return int(cudaErrorInvalidValue);
  const long long total = 1LL * J * P;
  const long long blocks = (total + fm::kAdamThreads - 1) / fm::kAdamThreads;
  const int grid = int(blocks < 132LL * 64 ? blocks : 132LL * 64);
  if (grid == 0) return int(cudaSuccess);
  fm::AdamArgs a{params, mu, nu, step, gpart, num, cnt, loss, P, J, nkb,
                 lr,     b1, b2, c1,   c2,  eps};
  fm::adam_kernel<<<grid, fm::kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
