// Kernel L: `lstm_train_forward` and `lstm_train_backward`, the LSTM
// autoencoder's training loss and its gradient for J jobs, each with its own
// parameters: the value and the gradient of the reference's jitted
// models/lstm_ae.py:_loss_fn (:88) under jax.value_and_grad in train_step
// (:144), vmapped over jobs by _train_step_fleet (:196). The loss of a job is
// sum((recon - x)^2 m) / max(sum m, 1) over all its K windows; the model and
// its layout are kernel K's (lstm.cuh).
//
// Forward entry: kernel K's recurrences for a CTA of up to KB windows of one
// job (grid J x nkb, nkb = ceil(K / KB)). Besides, every step of both LSTMs
// stores its gate activations i, f, g, o and its c (5H floats) to device
// scratch `act`, laid out (J K, 2, W, 5H), and each CTA writes its windows'
// sum of (recon - x)^2 over the mask (float64, in a fixed order) and their
// count of valid slots to num and cnt (J, nkb).
//
// Backward entry: backpropagation through time of the numerator's gradient
// (kernel M scales it by 1 / max(sum m, 1)), per CTA over the same windows:
//   - the decoder from t = W - 1 down to 0: the head's error 2 (r - x) at
//     valid slots, Dense_1's gradient, the cell's, and the latent's input
//     projection's gradient summed over the steps (the decoder is fed the
//     same latent at every step);
//   - the decoder's input kernel, Dense_0, and the gradient of the
//     encoder's last output;
//   - the encoder from its last step down to 0.
// h and the head's output are recomputed from the stored o and c with the
// forward's own operations, so they equal the forward's bit for bit. Each
// CTA writes its partial gradient (P floats, the flat layout) to gpart
// (J, nkb, P): each entry is summed by one thread in a fixed order (steps,
// then windows), with no atomics, so the same windows give the same
// gradient on every run (kernel M then sums the blocks in order).
//
// Shared memory: the job's parameters and the CTA's gradient accumulator
// when both fit (48.7 KB each at the engine's F = 4, H = 32, Z = 16),
// otherwise each is read / summed in device memory (the accumulator then in
// the CTA's own gpart row); the windows' state beside them.
//
// Full float32 arithmetic without FMA contraction (-fmad=false), expf /
// tanhf, no tensor cores, as kernel K; the loss's sums in float64.
//
// What bounds it on an H100: the operations. A window costs ~301,600
// multiply-adds forward at the engine's width (W = 32) and about twice that
// backward (the products with the transposed weights and the weight
// gradients), against its parameters (once a CTA) and 40 KB of stored
// activations a window written once and read once. This first version
// keeps every product in fp32 CUDA cores with three or four barriers a
// step; making it fast is later work.
#include "lstm.cuh"

namespace fm {

constexpr int kTrainThreads = 256;

struct TrainArgs {
  const float* params;
  long long P;
  const float* x;
  const uint8_t* mask;
  int J, K, W, F, H, Z, KB, nkb;
  float* act;     // (J K, 2, W, 5H)
  double* num;    // (J, nkb)
  double* cnt;    // (J, nkb)
  float* gpart;   // (J, nkb, P)
};

// floats of the forward's per-window state: kernel K's (input, h, c, gates,
// the decoder's input projection, latent, head partials as float64 pairs)
__host__ __device__ inline int train_fwd_window_floats(int F, int H, int Z) {
  return 2 * F + 2 * H + 8 * H + Z + 4 * F;
}

// floats of the backward's per-window state: h and h_{t-1}, the gradients
// of h and c, the encoder's last h (H each), the gates' gradient and the
// latent projection's (4H each), the encoder's input (2F), the head's
// error (F), the latent and its gradient (Z each)
__host__ __device__ inline int train_bwd_window_floats(int F, int H, int Z) {
  return 5 * H + 8 * H + 3 * F + 2 * Z;
}

__host__ inline long long train_smem_bytes(int F, int H, int Z, int KB, int smem_params,
                                           int backward) {
  const long long P4 = (lstm_param_count(F, H, Z) + 3) & ~3LL;
  long long floats = 1LL * KB * (backward ? train_bwd_window_floats(F, H, Z)
                                          : train_fwd_window_floats(F, H, Z)) + 2;
  if (smem_params) floats += (backward ? 2 : 1) * P4;
  return floats * 4;
}

__device__ __forceinline__ const float* stage_params(const TrainArgs& a, int job, float*& sp,
                                                     int smem_params) {
  const float* p = a.params + size_t(job) * a.P;
  if (!smem_params) return p;
  for (long long i = threadIdx.x; i < a.P; i += blockDim.x) sp[i] = p[i];
  sp += (a.P + 3) & ~3LL;
  return sp - ((a.P + 3) & ~3LL);
}

__global__ void __launch_bounds__(kTrainThreads) lstm_train_fwd_kernel(TrainArgs a,
                                                                       int smem_params) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x / a.nkb, kb = blockIdx.x - job * a.nkb;
  const int k0 = kb * a.KB, nk = min(a.KB, a.K - k0);
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, IN = 2 * F, W = a.W, tid = threadIdx.x;
  float* sp = reinterpret_cast<float*>(smem);
  const LstmLayout l = lstm_layout(stage_params(a, job, sp, smem_params), F, H, Z);
  const int KB = a.KB;
  float* inp = sp;
  float* h = inp + KB * IN;
  float* c = h + KB * H;
  float* gates = c + KB * H;
  float* dz = gates + KB * G;
  float* zl = dz + KB * G;
  double* part = reinterpret_cast<double*>(zl + KB * Z + ((KB * Z) & 1));  // (KB, F, 2)
  const size_t win0 = size_t(job) * a.K + k0;
  const size_t step = size_t(5) * H, stride = size_t(2) * W * step;  // per step, per window
  float* act = a.act + win0 * stride;
  for (int i = tid; i < nk * H; i += blockDim.x) h[i] = c[i] = 0.0f;

  for (int t = 0; t < W; ++t) {
    for (int i = tid; i < nk * F; i += blockDim.x) {
      const int k = i / F, f = i - k * F;
      const size_t at = ((win0 + size_t(k)) * W + t) * F + f;
      inp[k * IN + f] = a.x[at];
      inp[k * IN + F + f] = a.mask[at] ? 1.0f : 0.0f;
    }
    __syncthreads();
    lstm_step(inp, IN, l.wi_e, nullptr, l.wh_e, l.b_e, h, c, gates, nk, H, act + t * step,
              stride);
  }
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

  // thread i < nk F keeps window i / F, feature i % F (nk F <= blockDim)
  const int kf = tid < nk * F ? tid : -1;
  double se = 0.0, n = 0.0;
  for (int t = 0; t < W; ++t) {
    lstm_step(nullptr, 0, nullptr, dz, l.wh_d, l.b_d, h, c, gates, nk, H,
              act + (W + t) * step, stride);
    if (kf >= 0) {
      const int k = kf / F, f = kf - k * F;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += h[k * H + j] * l.w1[j * F + f];
      const float r = acc + l.b1[f];
      const size_t at = ((win0 + size_t(k)) * W + t) * F + f;
      if (a.mask[at]) {
        const float d = r - a.x[at];
        se += double(d * d);
        n += 1.0;
      }
    }
  }
  if (kf >= 0) {
    part[2 * kf] = se;
    part[2 * kf + 1] = n;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0, m = 0.0;
    for (int i = 0; i < nk * F; ++i) {
      s += part[2 * i];
      m += part[2 * i + 1];
    }
    a.num[size_t(job) * a.nkb + kb] = s;
    a.cnt[size_t(job) * a.nkb + kb] = m;
  }
}

// h of window k at step t of LSTM lstm (0 encoder, 1 decoder) into out,
// from the stored o and c; zeros before the first step
__device__ __forceinline__ void load_h(const float* act, size_t stride, size_t step, int lstm,
                                       int W, int t, int nk, int H, float* out) {
  for (int i = threadIdx.x; i < nk * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    if (t < 0) {
      out[i] = 0.0f;
    } else {
      const float* s = act + k * stride + (size_t(lstm) * W + t) * step;
      out[i] = s[3 * H + j] * tanhf(s[4 * H + j]);
    }
  }
}

// One step of the backward through a cell, for nk windows. dh holds the
// gradient of h_t (head or latent part plus the next step's), dc the next
// step's gradient of c; both are updated to the ones for step t - 1, after
// da (the gates' pre-activation gradient, nk x 4H) and the weight gradients
// have been taken. hprev is h_{t-1}; inp (in_dim floats a window), when
// given, the step's input for wi's gradient; ddz, when given, sums da.
struct CellGrads {
  float *wi, *wh, *b;
};

__device__ __forceinline__ void cell_backward(const float* act_t, const float* act_prev,
                                              size_t stride, const float* wh, const float* hprev,
                                              const float* inp, int in_dim, float* dh, float* dc,
                                              float* da, float* ddz, CellGrads g, int nk, int H) {
  const int G = 4 * H;
  for (int i = threadIdx.x; i < nk * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    const float* s = act_t + k * stride;
    const float ig = s[j], fg = s[H + j], gg = s[2 * H + j], og = s[3 * H + j], cn = s[4 * H + j];
    const float cp = act_prev != nullptr ? act_prev[k * stride + 4 * H + j] : 0.0f;
    const float tc = tanhf(cn);
    const float dhv = dh[i];
    const float dcv = dhv * og * (1.0f - tc * tc) + dc[i];
    float* d = da + k * G;
    d[j] = (dcv * gg) * (ig * (1.0f - ig));
    d[H + j] = (dcv * cp) * (fg * (1.0f - fg));
    d[2 * H + j] = (dcv * ig) * (1.0f - gg * gg);
    d[3 * H + j] = (dhv * tc) * (og * (1.0f - og));
    dc[i] = dcv * fg;
  }
  __syncthreads();
  // weight gradients: each entry by one thread, windows in order
  for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
    const int j = i / G, col = i - j * G;
    float acc = g.wh[i];
    for (int k = 0; k < nk; ++k) acc += hprev[k * H + j] * da[k * G + col];
    g.wh[i] = acc;
  }
  if (inp != nullptr) {
    for (int i = threadIdx.x; i < in_dim * G; i += blockDim.x) {
      const int q = i / G, col = i - q * G;
      float acc = g.wi[i];
      for (int k = 0; k < nk; ++k) acc += inp[k * in_dim + q] * da[k * G + col];
      g.wi[i] = acc;
    }
  }
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float acc = g.b[col];
    for (int k = 0; k < nk; ++k) acc += da[k * G + col];
    g.b[col] = acc;
  }
  if (ddz != nullptr)
    for (int i = threadIdx.x; i < nk * G; i += blockDim.x) ddz[i] += da[i];
  // the gradient of h_{t-1} through wh: wh is read across its rows, so
  // each unit j starts its sum at column j (neighbouring lanes on
  // neighbouring banks, not all on one bank of shared memory)
  for (int i = threadIdx.x; i < nk * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    float acc = 0.0f;
    for (int q = 0; q < G; ++q) {
      const int col = (q + j) % G;
      acc += da[k * G + col] * wh[j * G + col];
    }
    dh[i] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTrainThreads) lstm_train_bwd_kernel(TrainArgs a,
                                                                       int smem_params) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x / a.nkb, kb = blockIdx.x - job * a.nkb;
  const int k0 = kb * a.KB, nk = min(a.KB, a.K - k0);
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, IN = 2 * F, W = a.W, tid = threadIdx.x;
  float* sp = reinterpret_cast<float*>(smem);
  const LstmLayout l = lstm_layout(stage_params(a, job, sp, smem_params), F, H, Z);
  float* gacc = a.gpart + (size_t(job) * a.nkb + kb) * a.P;
  if (smem_params) {
    gacc = sp;
    sp += (a.P + 3) & ~3LL;
  }
  for (long long i = tid; i < a.P; i += blockDim.x) gacc[i] = 0.0f;
  long long o[10];
  lstm_offsets(F, H, Z, o);
  const CellGrads genc{gacc + o[0], gacc + o[1], gacc + o[2]};
  const CellGrads gdec{gacc + o[5], gacc + o[6], gacc + o[7]};
  float *gw0 = gacc + o[3], *gb0 = gacc + o[4], *gw1 = gacc + o[8], *gb1 = gacc + o[9];
  const int KB = a.KB;
  float* hcur = sp;
  float* hprev = hcur + KB * H;
  float* dh = hprev + KB * H;
  float* dc = dh + KB * H;
  float* hlast = dc + KB * H;
  float* da = hlast + KB * H;
  float* ddz = da + KB * G;
  float* inp = ddz + KB * G;
  float* dr = inp + KB * IN;
  float* zl = dr + KB * F;
  float* dzl = zl + KB * Z;
  const size_t win0 = size_t(job) * a.K + k0;
  const size_t step = size_t(5) * H, stride = size_t(2) * W * step;
  const float* act = a.act + win0 * stride;
  for (int i = tid; i < nk * H; i += blockDim.x) dh[i] = dc[i] = 0.0f;
  for (int i = tid; i < nk * G; i += blockDim.x) ddz[i] = 0.0f;
  __syncthreads();

  // the decoder and the head, last step first
  for (int t = W - 1; t >= 0; --t) {
    load_h(act, stride, step, 1, W, t, nk, H, hcur);
    load_h(act, stride, step, 1, W, t - 1, nk, H, hprev);
    __syncthreads();
    for (int i = tid; i < nk * F; i += blockDim.x) {
      const int k = i / F, f = i - k * F;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += hcur[k * H + j] * l.w1[j * F + f];
      const float r = acc + l.b1[f];
      const size_t at = ((win0 + size_t(k)) * W + t) * F + f;
      dr[i] = a.mask[at] ? 2.0f * (r - a.x[at]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < H * F; i += blockDim.x) {
      const int j = i / F, f = i - j * F;
      float acc = gw1[i];
      for (int k = 0; k < nk; ++k) acc += hcur[k * H + j] * dr[k * F + f];
      gw1[i] = acc;
    }
    for (int f = tid; f < F; f += blockDim.x) {
      float acc = gb1[f];
      for (int k = 0; k < nk; ++k) acc += dr[k * F + f];
      gb1[f] = acc;
    }
    for (int i = tid; i < nk * H; i += blockDim.x) {
      const int k = i / H, j = i - k * H;
      float acc = 0.0f;
      for (int f = 0; f < F; ++f) acc += dr[k * F + f] * l.w1[j * F + f];
      dh[i] += acc;
    }
    __syncthreads();
    cell_backward(act + (W + t) * step, t > 0 ? act + (W + t - 1) * step : nullptr, stride,
                  l.wh_d, hprev, nullptr, 0, dh, dc, da, ddz, gdec, nk, H);
  }

  // the decoder's input kernel, the latent and Dense_0
  load_h(act, stride, step, 0, W, W - 1, nk, H, hlast);
  __syncthreads();
  for (int i = tid; i < nk * Z; i += blockDim.x) {
    const int k = i / Z, q = i - k * Z;
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) acc += hlast[k * H + j] * l.w0[j * Z + q];
    zl[i] = acc + l.b0[q];
  }
  __syncthreads();
  for (int i = tid; i < Z * G; i += blockDim.x) {
    const int q = i / G, col = i - q * G;
    float acc = gdec.wi[i];
    for (int k = 0; k < nk; ++k) acc += zl[k * Z + q] * ddz[k * G + col];
    gdec.wi[i] = acc;
  }
  for (int i = tid; i < nk * Z; i += blockDim.x) {
    const int k = i / Z, q = i - k * Z;
    float acc = 0.0f;
    for (int col = 0; col < G; ++col) acc += ddz[k * G + col] * l.wi_d[q * G + col];
    dzl[i] = acc;
  }
  __syncthreads();
  for (int i = tid; i < H * Z; i += blockDim.x) {
    const int j = i / Z, q = i - j * Z;
    float acc = gw0[i];
    for (int k = 0; k < nk; ++k) acc += hlast[k * H + j] * dzl[k * Z + q];
    gw0[i] = acc;
  }
  for (int q = tid; q < Z; q += blockDim.x) {
    float acc = gb0[q];
    for (int k = 0; k < nk; ++k) acc += dzl[k * Z + q];
    gb0[q] = acc;
  }
  for (int i = tid; i < nk * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    float acc = 0.0f;
    for (int q = 0; q < Z; ++q) acc += dzl[k * Z + q] * l.w0[j * Z + q];
    dh[i] = acc;
    dc[i] = 0.0f;
  }
  __syncthreads();

  // the encoder, last step first
  for (int t = W - 1; t >= 0; --t) {
    load_h(act, stride, step, 0, W, t - 1, nk, H, hprev);
    for (int i = tid; i < nk * F; i += blockDim.x) {
      const int k = i / F, f = i - k * F;
      const size_t at = ((win0 + size_t(k)) * W + t) * F + f;
      inp[k * IN + f] = a.x[at];
      inp[k * IN + F + f] = a.mask[at] ? 1.0f : 0.0f;
    }
    __syncthreads();
    cell_backward(act + t * step, t > 0 ? act + (t - 1) * step : nullptr, stride, l.wh_e, hprev,
                  inp, IN, dh, dc, da, nullptr, genc, nk, H);
  }
  if (smem_params) {
    float* out = a.gpart + (size_t(job) * a.nkb + kb) * a.P;
    for (long long i = tid; i < a.P; i += blockDim.x) out[i] = gacc[i];
  }
}

}  // namespace fm

extern "C" long long fm_lstm_train_smem_bytes(int F, int H, int Z, int KB, int smem_params,
                                             int backward) {
  return fm::train_smem_bytes(F, H, Z, KB, smem_params, backward);
}

extern "C" int fm_lstm_train(int backward, const float* params, long long P, const float* x,
                             const uint8_t* mask, int J, int K, int W, int F, int H, int Z,
                             int KB, int smem_params, float* act, double* num, double* cnt,
                             float* gpart, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || KB < 1 || KB * F > fm::kTrainThreads || W < 1)
    return int(cudaErrorInvalidValue);
  const int nkb = (K + KB - 1) / KB;
  fm::TrainArgs a{params, P, x, mask, J, K, W, F, H, Z, KB, nkb, act, num, cnt, gpart};
  const size_t smem = size_t(fm::train_smem_bytes(F, H, Z, KB, smem_params, backward));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (backward) {
    e = cudaFuncSetAttribute(fm::lstm_train_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::lstm_train_bwd_kernel<<<J * nkb, fm::kTrainThreads, smem, s>>>(a, smem_params);
  } else {
    e = cudaFuncSetAttribute(fm::lstm_train_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::lstm_train_fwd_kernel<<<J * nkb, fm::kTrainThreads, smem, s>>>(a, smem_params);
  }
  return int(cudaGetLastError());
}
