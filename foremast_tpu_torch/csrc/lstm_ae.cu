// Kernel K: `lstm_ae`, the LSTM autoencoder's scoring pass for J jobs, each
// with its own parameters, in one launch.
//
// Replaces the reference's jitted models/lstm_ae.py:reconstruction_errors
// (:240; LstmAutoencoder.__call__ :64 inside it), anomaly_scores (:258) and
// anomaly_scores_fleet (:269, the vmap over stacked parameters). Per window
// of W steps by F features: the encoder LSTM over [x, mask] (2F channels,
// x fed as given at masked slots), the latent Dense_0 of the last step's
// output, the decoder LSTM fed the latent at every step, the Dense_1 head,
// then sum((recon - x)^2 m) / max(sum m, 1); optionally
// z = (err - mu_j) / sigma_j. The cells are flax's LSTMCell: gates i, f, g,
// o, each dense_i(x) (no bias) + dense_h(h) (with bias), activations
// sigmoid, sigmoid, tanh, sigmoid, c' = f c + i g, h' = o tanh(c'), the
// carry starting at zeros.
//
// Parameters: one row of P floats per job in the port's flat layout
// (lstm.cuh, shared with kernel L).
//
// Design: a CTA of kLstmThreads threads runs up to KB windows of one job
// (grid J x ceil(K / KB)), their steps in lock step.
//   - The job's parameters are copied to shared memory when they fit
//     beside the windows' state (48.7 KB at the engine's F = 4, H = 32,
//     Z = 16); above the limit (the module's default H = 128: 711 KB) they
//     are read from device memory through L1 and L2.
//   - A step: each thread computes whole gate pre-activations (window,
//     column) from the step's input and the previous h in shared memory,
//     then each thread updates whole (window, unit) states; two barriers.
//   - The decoder's input is the latent at every step, so its input
//     projection is computed once per window.
//   - The head's squared errors are summed per (window, feature) thread in
//     float64 across the steps and reduced per window at the end.
// Full float32 FMA-free arithmetic (-fmad=false, as the library builds),
// expf / tanhf (never the fast intrinsics), no tensor cores.
//
// What bounds it on an H100: at the engine's width (H = 32) the
// operations, narrowly: a window costs ~4H (2F + H) + 4H H + H Z + Z 4H +
// H F multiply-adds a step (~301,600 for W = 32), against its parameters
// (48.7 KB a job) and windows (~0.6 KB) of traffic. This first version
// keeps every product in fp32 CUDA cores and waits on two barriers a step;
// making it fast (tensor cores, more windows per CTA) is later work.
#include "lstm.cuh"

namespace fm {

constexpr int kLstmThreads = 256;

struct LstmArgs {
  const float* params;
  long long P;
  const float* x;
  const uint8_t* mask;
  const float* mu;
  const float* sigma;
  int J, K, W, F, H, Z, KB, nkb;
  float* err;
  float* z;
};

// floats of per-window state: input (2F), h and c (H each), gates and the
// decoder's input projection (4H each), latent (Z), head partials (2F,
// kept as float64 pairs: 4F floats)
__host__ __device__ inline int lstm_window_floats(int F, int H, int Z) {
  return 2 * F + 2 * H + 8 * H + Z + 4 * F;
}

__global__ void __launch_bounds__(kLstmThreads) lstm_ae_kernel(LstmArgs a, int smem_params) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x / a.nkb, kb = blockIdx.x - job * a.nkb;
  const int k0 = kb * a.KB, nk = min(a.KB, a.K - k0);
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, IN = 2 * F, W = a.W, tid = threadIdx.x;
  float* sp = reinterpret_cast<float*>(smem);
  const float* p = a.params + size_t(job) * a.P;
  if (smem_params) {
    for (long long i = tid; i < a.P; i += blockDim.x) sp[i] = p[i];
    p = sp;
    sp += (a.P + 3) & ~3LL;
  }
  const LstmLayout l = lstm_layout(p, F, H, Z);
  const int KB = a.KB;
  float* inp = sp;
  float* h = inp + KB * IN;
  float* c = h + KB * H;
  float* gates = c + KB * H;
  float* dz = gates + KB * G;
  float* zl = dz + KB * G;
  double* part = reinterpret_cast<double*>(zl + KB * Z + ((KB * Z) & 1));  // (KB, F, 2)
  const size_t win0 = (size_t(job) * a.K + k0) * W;  // first step of the CTA's windows
  for (int i = tid; i < nk * H; i += blockDim.x) h[i] = c[i] = 0.0f;

  // the encoder over [x, mask]
  for (int t = 0; t < W; ++t) {
    for (int i = tid; i < nk * F; i += blockDim.x) {
      const int k = i / F, f = i - k * F;
      const size_t at = ((win0 + size_t(k) * W) + t) * F + f;
      inp[k * IN + f] = a.x[at];
      inp[k * IN + F + f] = a.mask[at] ? 1.0f : 0.0f;
    }
    __syncthreads();
    lstm_step(inp, IN, l.wi_e, nullptr, l.wh_e, l.b_e, h, c, gates, nk, H);
  }
  // the latent of the last step's output, and the decoder's input projection
  for (int i = tid; i < nk * Z; i += blockDim.x) {
    const int k = i / Z, q = i - k * Z;
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) acc += h[k * H + j] * l.w0[j * Z + q];
    zl[i] = acc + l.b0[q];
  }
  __syncthreads();
  for (int i = tid; i < nk * G; i += blockDim.x) {
    const int k = i / G, col = i - k * G;
    float acc = 0.0f;
    for (int q = 0; q < Z; ++q) acc += zl[k * Z + q] * l.wi_d[q * G + col];
    dz[i] = acc;
  }
  for (int i = tid; i < nk * H; i += blockDim.x) h[i] = c[i] = 0.0f;
  __syncthreads();

  // the decoder and the head; thread i < nk F keeps window i / F, feature
  // i % F (nk F <= blockDim: the launcher's KB keeps it so)
  const int kf = tid < nk * F ? tid : -1;
  double se = 0.0, cnt = 0.0;
  for (int t = 0; t < W; ++t) {
    lstm_step(nullptr, 0, nullptr, dz, l.wh_d, l.b_d, h, c, gates, nk, H);
    if (kf >= 0) {
      const int k = kf / F, f = kf - k * F;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += h[k * H + j] * l.w1[j * F + f];
      const float r = acc + l.b1[f];
      const size_t at = ((win0 + size_t(k) * W) + t) * F + f;
      if (a.mask[at]) {
        const float d = r - a.x[at];
        se += double(d * d);
        cnt += 1.0;
      }
    }
  }
  if (kf >= 0) {
    part[2 * kf] = se;
    part[2 * kf + 1] = cnt;
  }
  __syncthreads();
  if (tid < nk) {
    double s = 0.0, n = 0.0;
    for (int f = 0; f < F; ++f) {
      s += part[2 * (tid * F + f)];
      n += part[2 * (tid * F + f) + 1];
    }
    const float e = float(s) / fmaxf(float(n), 1.0f);
    const size_t o = size_t(job) * a.K + k0 + tid;
    a.err[o] = e;
    if (a.z != nullptr) a.z[o] = (e - a.mu[job]) / a.sigma[job];
  }
}

__host__ inline long long lstm_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  long long floats = 1LL * KB * lstm_window_floats(F, H, Z) + 2;
  if (smem_params) floats += (lstm_param_count(F, H, Z) + 3) & ~3LL;
  return floats * 4;
}

}  // namespace fm

extern "C" long long fm_lstm_ae_param_count(int F, int H, int Z) {
  return fm::lstm_param_count(F, H, Z);
}

extern "C" long long fm_lstm_ae_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  return fm::lstm_smem_bytes(F, H, Z, KB, smem_params);
}

extern "C" int fm_lstm_ae(const float* params, long long P, const float* x, const uint8_t* mask,
                          const float* mu, const float* sigma, int J, int K, int W, int F, int H,
                          int Z, int KB, int smem_params, float* err, float* z, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || KB < 1 || KB * F > fm::kLstmThreads || W < 1)
    return int(cudaErrorInvalidValue);
  const int nkb = (K + KB - 1) / KB;
  fm::LstmArgs a{params, P, x, mask, mu, sigma, J, K, W, F, H, Z, KB, nkb, err, z};
  const size_t smem = size_t(fm::lstm_smem_bytes(F, H, Z, KB, smem_params));
  cudaError_t e = cudaFuncSetAttribute(fm::lstm_ae_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::lstm_ae_kernel<<<J * nkb, fm::kLstmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, smem_params);
  return int(cudaGetLastError());
}
