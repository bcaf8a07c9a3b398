// Kernel L: the LSTM autoencoder's training loss and its gradient for J
// jobs, each with its own parameters: the value and the gradient of the
// reference's jitted models/lstm_ae.py:_loss_fn (:88) under
// jax.value_and_grad in train_step (:144), vmapped over jobs by
// _train_step_fleet (:196). The loss of a job is sum((recon - x)^2 m) /
// max(sum m, 1) over all its K windows; the model and its layout are kernel
// K's (lstm.cuh). Three entries:
//
// Forward: kernel K's recurrences; every step of both LSTMs stores its gate
// activations i, f, g, o and its c (5H floats, a "slot") to device scratch
// `act`, laid out (J K, 2, W, 5H), and each block of KB windows gets its sum
// of (recon - x)^2 over the mask (float64, in a fixed order) and its count
// of valid slots in num and cnt (J, nkb), nkb = ceil(K / KB). Two paths,
// chosen by width, with the same bits:
//   - the tile path (`lstm_train_fwd_tile_kernel`), where a job's parameter
//     row and windows fit a CTA's shared memory (the engine's widths): a
//     CTA for a job's windows (KC of them), thread (u, group) owning unit u
//     and its four gates for a group of 8 windows in registers
//     (lstm_tile_step), h double-buffered, one barrier a step, each weight
//     read once a step for 8 windows;
//   - the wide path (`lstm_train_fwd_kernel`): a CTA of KB
//     windows (grid J x nkb) stepping with kernel K's lstm_step, the
//     parameters in shared memory while they fit, else read from device
//     memory (H = 128 and above).
//
// Backward, in two entries (kernel M scales the gradient by
// 1 / max(sum m, 1)):
//   1. The recurrence (`lstm_bptt_kernel`) carries only the gates'
//      pre-activation gradient da, dh and dc of each window back through
//      time: the decoder and its head from t = W - 1 down to 0, the latent,
//      then the encoder. A group of 32 ceil(H / 32) threads (one warp at
//      H <= 32, a few warps joined by a named barrier above) runs two
//      windows side by side, thread u owning unit u and its four gates in
//      both. Step t overwrites its own slot of act with (da_t, h_{t-1})
//      (4H + H floats): each thread reads and writes only its own unit's
//      five floats of a slot, and reads slot t - 1's o and c before step
//      t - 1 overwrites them, so the weight gradients' rows need no scratch.
//      h_{t-1} is carried from step to step (one tanhf a step and unit). The
//      product dh_{t-1} = da_t Wh^T reads unit u's row of Wh from shared
//      memory (rows padded to 4H + 1 floats: lanes on distinct banks; from
//      the parameter row when Wh does not fit under the launcher's budget),
//      once for both windows, and each window's da as a float4 broadcast
//      from a double buffer: one barrier a step, two in the decoder when the
//      head sums across warps.
//      What is summed per window goes to a record (rec, (J K, S)): the
//      latent z and its gradient, the decoder's per-window sum of da (the
//      decoder is fed z at every step), the encoder's last h, Dense_1's
//      gradient summed over the steps, and the encoder's input [x, m] as
//      floats.
//      Where a group's warps cannot hold the units (H > 256) or a warp's
//      lanes the features (F > 32), the wide path (`lstm_bptt_wide_kernel`,
//      kernels.lstm_bptt_path): a CTA a window, threads striding units and
//      features, the same records and rewritten slots, not tuned.
//   2. The weight gradients (`lstm_wgrad_kernel`): per job and LSTM, a
//      tiled float32 GEMM over the K W rewritten slots, dWh = sum h_{t-1}^T
//      da_t, with the encoder's rows extended by [x_t, m_t, 1] for its input
//      kernel and bias (32 x 128 output tiles a CTA, 4 x 4 a thread, chunks
//      of 32 rows staged through shared memory by cp.async, a ring of three;
//      products by explicit fmaf); one more CTA a job sums the records over
//      the job's K windows in order: the decoder's input kernel z^T ddz and
//      bias, Dense_0, Dense_1. Each entry of the gradient is summed by one
//      thread in a fixed order (rows, or windows, ascending), with no
//      atomics, so the same inputs give the same bits on every run. It
//      writes one gradient row a job, gpart (J, 1, P).
//
// Full float32 arithmetic, expf / tanhf, no tensor cores (TF32 would not
// hold the tolerances); the forward's sums without FMA contraction
// (-fmad=false, as kernel K), the backward's products by explicit fmaf.
//
// What bounds it on an H100: the forward, the 1.9 GB of activations it
// writes at the engine's shape (0.587 ms); its 1.39e10 multiply-adds,
// unfused (-fmad=false), need 0.83 ms of the fp32 pipes, the tile path's
// floor. The backward, the operations, about W (2 H 4H + 2F 4H)
// multiply-adds a window (0.791 ms for 1,024 jobs x 45 windows at the
// engine's F = 4, H = 32, Z = 16), against the activations
// written by the forward, then read, rewritten and read once more by the
// backward (1.9 GB each time at that size). The recurrence is bound by
// shared memory: a float4 broadcast of da costs four wavefronts, so a
// window-step moves about 4H + 4H / 2 floats' worth of wavefronts for its
// 4H H multiply-adds; the GEMM by its operands' staging.
#include "lstm.cuh"

namespace fm {

constexpr int kTrainThreads = 256;
constexpr int kBpttThreads = 256;  // a CTA of the recurrence holds at most this many threads
// the weight-gradient GEMM: a CTA's output tile (BM x BN), rows a chunk,
// a thread's tile TM x 4 (a warp: TM rows x 128 columns), chunks in flight
// (a ring of stages)
constexpr int kGemmBM = 32, kGemmBN = 128, kGemmBK = 32, kGemmTM = 4, kGemmStages = 3;
constexpr int kGemmThreads = 32 * kGemmBM / kGemmTM;
static_assert(kGemmBM == 32 && kGemmBN == 128, "a warp stages a row: 32 A and 128 B columns");
constexpr int kGemmLdA = kGemmBM + 4;

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

struct TrainArgs {
  const float* params;
  long long P;
  const float* x;
  const uint8_t* mask;
  int J, K, W, F, H, Z, KB, nkb;
  int KC, nkc;    // the tile path: windows a CTA (a multiple of KB) and CTAs a job
  float* act;     // (J K, 2, W, 5H)
  double* num;    // (J, nkb)
  double* cnt;    // (J, nkb)
  long long* clocks;  // null, or (J, kFwdPhases) SM cycles a job's CTAs spent per phase
};

// phases of the forward's optional cycle counts: parameters staged, the
// encoder, the latent and the decoder's input projection, the decoder and
// its head, the block sums
constexpr int kFwdPhases = 5;

// adds a CTA's cycles per phase (stamps c[0..kFwdPhases]) to its job's row
__device__ __forceinline__ void add_fwd_clocks(long long* clocks, int job, const long long* c) {
  for (int k = 0; k < kFwdPhases; ++k)
    atomicAdd(reinterpret_cast<unsigned long long*>(clocks) + size_t(job) * kFwdPhases + k,
              static_cast<unsigned long long>(c[k + 1] - c[k]));
}

// floats of the forward's per-window state: kernel K's (input, h, c, gates,
// the decoder's input projection, latent, head partials as float64 pairs)
__host__ __device__ inline int train_fwd_window_floats(int F, int H, int Z) {
  return 2 * F + 2 * H + 8 * H + Z + 4 * F;
}

__host__ inline long long train_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  const long long P4 = (lstm_param_count(F, H, Z) + 3) & ~3LL;
  long long floats = 1LL * KB * train_fwd_window_floats(F, H, Z) + 2;
  if (smem_params) floats += P4;
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
  long long cyc[kFwdPhases + 1];
  cyc[0] = clock64();
  const LstmLayout l = lstm_layout(stage_params(a, job, sp, smem_params), F, H, Z);
  if (a.clocks != nullptr) {
    __syncthreads();
    cyc[1] = clock64();
  }
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
  cyc[2] = clock64();
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
  cyc[3] = clock64();

  // the head: thread i keeps (window, feature) pairs kf = i, i + blockDim,
  // ..., each pair's squared errors and count summed in step order in part
  for (int kf = tid; kf < nk * F; kf += blockDim.x) part[2 * kf] = part[2 * kf + 1] = 0.0;
  for (int t = 0; t < W; ++t) {
    lstm_step(nullptr, 0, nullptr, dz, l.wh_d, l.b_d, h, c, gates, nk, H,
              act + (W + t) * step, stride);
    for (int kf = tid; kf < nk * F; kf += blockDim.x) {
      const int k = kf / F, f = kf - k * F;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += h[k * H + j] * l.w1[j * F + f];
      const float r = acc + l.b1[f];
      const size_t at = ((win0 + size_t(k)) * W + t) * F + f;
      if (a.mask[at]) {
        const float d = r - a.x[at];
        part[2 * kf] += double(d * d);
        part[2 * kf + 1] += 1.0;
      }
    }
  }
  __syncthreads();
  cyc[4] = clock64();
  if (tid == 0) {
    double s = 0.0, m = 0.0;
    for (int i = 0; i < nk * F; ++i) {
      s += part[2 * i];
      m += part[2 * i + 1];
    }
    a.num[size_t(job) * a.nkb + kb] = s;
    a.cnt[size_t(job) * a.nkb + kb] = m;
    if (a.clocks != nullptr) {
      cyc[5] = clock64();
      add_fwd_clocks(a.clocks, job, cyc);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward, the tile path: a CTA for a job's windows
// ---------------------------------------------------------------------------
// A CTA runs KC windows of one job (all K of them where they fit), kFwdWin
// windows a thread group of H threads: thread (u, group) owns hidden unit u
// and its four gates for its group's windows (lstm_tile_step), the state in
// registers, h double-buffered in shared memory, one barrier a step. Each
// weight is read from shared memory once a step for kFwdWin windows; the
// parameter row is staged once a CTA, gate weights unit-major as float4s.
// (window, feature) pairs, at most kFwdMaxPairs a thread, load the next
// step's encoder input and the decoder's targets a step ahead and sum the
// head's squared errors in step order; the block sums (KB windows, as the
// wide path's CTAs) keep the wide path's order, so num and cnt are its bits.
// windows a thread, a CTA's most threads (registers for two CTAs an SM: at
// the engine's shape on an H100, 4 windows a thread at two CTAs an SM took
// 2.283 ms, 8 at one CTA of the same 12 warps 2.374 ms)
constexpr int kFwdWin = 4;
constexpr int kFwdMaxThreads = 384;
constexpr int kFwdMaxPairs = 4;

// The tile path's shared memory, in floats: the parameter row restaged,
// then h (two buffers of H rows of ld floats, a window a column), the
// encoder's input (two buffers of 2F rows), the latent (Z rows), and each
// pair's squared-error sum and count (float64).
struct FwdLayout {
  int wi, wh, b, w0, b0, wd, whd, bd, w1, b1, h, inp, zl, se, floats;
};

__host__ __device__ inline FwdLayout fwd_layout(int F, int H, int Z, int ld) {
  FwdLayout l;
  int at = 0;
  l.wi = at, at += 8 * F * H;
  l.wh = at, at += 4 * H * H;
  l.b = at, at += 4 * H;
  l.w0 = at, at += align4(H * Z);
  l.b0 = at, at += align4(Z);
  l.wd = at, at += 4 * Z * H;
  l.whd = at, at += 4 * H * H;
  l.bd = at, at += 4 * H;
  l.w1 = at, at += align4(H * F);
  l.b1 = at, at += align4(F);
  l.h = at, at += 2 * H * ld;
  l.inp = at, at += 4 * F * ld;
  l.zl = at, at += Z * ld;
  l.se = at, at += 4 * ld * F;  // ld F pairs of two doubles
  l.floats = at;
  return l;
}

// the row stride of h, the input and the latent for KC windows: whole
// groups, plus 4 floats so that a warp's float4 stores of h fall on
// distinct banks
__host__ __device__ inline int fwd_ld(int KC) {
  return (KC + kFwdWin - 1) / kFwdWin * kFwdWin + 4;
}

__host__ inline long long fwd_tile_smem_bytes(int F, int H, int Z, int KC) {
  return 4LL * fwd_layout(F, H, Z, fwd_ld(KC)).floats;
}

// KC for the tile path, or 0 where it does not serve: at most
// kFwdMaxThreads threads and kFwdMaxPairs pairs a thread, a multiple of
// KB, and the CTAs of a job as even as KB allows
__host__ inline int fwd_tile_windows(int K, int F, int H, int KB) {
  const int groups = kFwdMaxThreads / H;
  if (groups < 1) return 0;
  const int most = groups * kFwdWin / KB * KB;
  if (most < 1) return 0;
  const int nkc = (K + most - 1) / most;
  const int KC = ((K + nkc - 1) / nkc + KB - 1) / KB * KB;
  const int threads = H * ((KC + kFwdWin - 1) / kFwdWin);
  if (KC * F > kFwdMaxPairs * threads) return 0;
  return KC;
}

// (window, feature) pair r of this thread: its window and feature, or false
__device__ __forceinline__ bool fwd_pair(int r, int nk, int F, int& k, int& f) {
  const int i = threadIdx.x + r * blockDim.x;
  k = i / F;
  f = i - k * F;
  return i < nk * F;
}

__global__ void __launch_bounds__(kFwdMaxThreads, 2) lstm_train_fwd_tile_kernel(TrainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int job = blockIdx.x / a.nkc, kc = blockIdx.x - job * a.nkc;
  const int F = a.F, H = a.H, Z = a.Z, W = a.W, G = 4 * H, IN = 2 * F;
  const int k0 = kc * a.KC, nk = min(a.KC, a.K - k0), ld = fwd_ld(a.KC);
  const int tid = threadIdx.x, nt = blockDim.x, u = tid % H, kw = tid / H * kFwdWin;
  const FwdLayout L = fwd_layout(F, H, Z, ld);
  long long cyc[kFwdPhases + 1];
  cyc[0] = clock64();

  // the parameter row, gate weights unit-major
  const float* p = a.params + size_t(job) * a.P;
  long long o[10];
  lstm_offsets(F, H, Z, o);
  float4* wi = reinterpret_cast<float4*>(sm + L.wi);
  float4* wh = reinterpret_cast<float4*>(sm + L.wh);
  float4* bb = reinterpret_cast<float4*>(sm + L.b);
  float4* wd = reinterpret_cast<float4*>(sm + L.wd);
  float4* whd = reinterpret_cast<float4*>(sm + L.whd);
  float4* bd = reinterpret_cast<float4*>(sm + L.bd);
  float* w0 = sm + L.w0;
  float* b0 = sm + L.b0;
  float* w1 = sm + L.w1;
  float* b1 = sm + L.b1;
  const struct {
    float4* dst;
    long long src;
    int rows;
  } gates[6] = {{wi, o[0], IN}, {wh, o[1], H}, {bb, o[2], 1},
                {wd, o[5], Z},  {whd, o[6], H}, {bd, o[7], 1}};
  for (int m = 0; m < 6; ++m)
    for (int i = tid; i < gates[m].rows * H; i += nt) {
      const int r = i / H, c = i - r * H;
      const float* q = p + gates[m].src + size_t(r) * G + c;
      gates[m].dst[i] = make_float4(q[0], q[H], q[2 * H], q[3 * H]);
    }
  for (int i = tid; i < H * Z; i += nt) w0[i] = p[o[3] + i];
  for (int i = tid; i < Z; i += nt) b0[i] = p[o[4] + i];
  for (int i = tid; i < H * F; i += nt) w1[i] = p[o[8] + i];
  for (int i = tid; i < F; i += nt) b1[i] = p[o[9] + i];
  float* h = sm + L.h;
  float* inp = sm + L.inp;
  float* zl = sm + L.zl;
  double* se = reinterpret_cast<double*>(sm + L.se);
  double* nn = se + ld * F;
  for (int i = tid; i < 2 * H * ld; i += nt) h[i] = 0.0f;
  for (int i = tid; i < 2 * IN * ld; i += nt) inp[i] = 0.0f;
  for (int i = tid; i < ld * F; i += nt) se[i] = nn[i] = 0.0;
  const size_t win0 = size_t(job) * a.K + k0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kFwdMaxPairs; ++r) {
    int k, f;
    if (!fwd_pair(r, nk, F, k, f)) break;
    const size_t at = (win0 + k) * W * F + f;
    inp[f * ld + k] = a.x[at];
    inp[(F + f) * ld + k] = a.mask[at] ? 1.0f : 0.0f;
  }
  __syncthreads();
  cyc[1] = clock64();

  const size_t step = size_t(5) * H, stride = size_t(2) * W * step;  // per step, per window
  float* act = a.act + (win0 + kw) * stride + u;
  const int mine = max(0, min(kFwdWin, nk - kw));  // this thread's windows that exist
  float c[kFwdWin], hn[kFwdWin], out[5][kFwdWin], dz[4][kFwdWin];
#pragma unroll
  for (int w = 0; w < kFwdWin; ++w) c[w] = 0.0f;

  for (int t = 0; t < W; ++t) {
    const float* hc = h + (t & 1) * H * ld;
    float* hx = h + ((t + 1) & 1) * H * ld;
    float xr[kFwdMaxPairs];
    bool mr[kFwdMaxPairs];
#pragma unroll
    for (int r = 0; r < kFwdMaxPairs; ++r) {
      int k, f;
      if (t + 1 < W && fwd_pair(r, nk, F, k, f)) {
        const size_t at = ((win0 + k) * W + t + 1) * F + f;
        xr[r] = a.x[at];
        mr[r] = a.mask[at];
      }
    }
    lstm_tile_step<kFwdWin, false>(inp + (t & 1) * IN * ld + kw, IN, wi, dz, hc + kw, ld, wh,
                                   bb[u], H, u, c, out, hn);
#pragma unroll
    for (int w = 0; w < kFwdWin; w += 4)
      *reinterpret_cast<float4*>(hx + u * ld + kw + w) =
          make_float4(hn[w], hn[w + 1], hn[w + 2], hn[w + 3]);
#pragma unroll
    for (int w = 0; w < kFwdWin; ++w)
      if (w < mine)
#pragma unroll
        for (int g = 0; g < 5; ++g) act[w * stride + t * step + g * H] = out[g][w];
    float* in_next = inp + ((t + 1) & 1) * IN * ld;
#pragma unroll
    for (int r = 0; r < kFwdMaxPairs; ++r) {
      int k, f;
      if (t + 1 < W && fwd_pair(r, nk, F, k, f)) {
        in_next[f * ld + k] = xr[r];
        in_next[(F + f) * ld + k] = mr[r] ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
  }
  cyc[2] = clock64();

  // the latent, then the decoder's input projection into registers
  const float* he = h + (W & 1) * H * ld;
  for (int i = tid; i < Z * ld; i += nt) {
    const int q = i / ld, k = i - q * ld;
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) acc += he[j * ld + k] * w0[j * Z + q];
    zl[i] = acc + b0[q];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kFwdWin; ++w) {
    c[w] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) dz[g][w] = 0.0f;
  }
  for (int q = 0; q < Z; ++q) {
    const float4 wq = wd[q * H + u];
#pragma unroll
    for (int w = 0; w < kFwdWin; ++w) {
      const float v = zl[q * ld + kw + w];
      dz[0][w] += v * wq.x;
      dz[1][w] += v * wq.y;
      dz[2][w] += v * wq.z;
      dz[3][w] += v * wq.w;
    }
  }
  for (int i = tid; i < H * ld; i += nt) h[i] = 0.0f;
  __syncthreads();
  cyc[3] = clock64();

  // the decoder; in step t, the head of step t - 1 (h of step t - 1 is what
  // step t reads); after the last step, the last head
  for (int t = 0; t <= W; ++t) {
    const float* hc = h + (t & 1) * H * ld;
    float xr[kFwdMaxPairs];
    bool mr[kFwdMaxPairs];
#pragma unroll
    for (int r = 0; r < kFwdMaxPairs; ++r) {
      int k, f;
      if (t > 0 && fwd_pair(r, nk, F, k, f)) {
        const size_t at = ((win0 + k) * W + t - 1) * F + f;
        xr[r] = a.x[at];
        mr[r] = a.mask[at];
      }
    }
    if (t < W) {
      float* hx = h + ((t + 1) & 1) * H * ld;
      lstm_tile_step<kFwdWin, true>(nullptr, 0, nullptr, dz, hc + kw, ld, whd, bd[u], H, u, c,
                                    out, hn);
#pragma unroll
      for (int w = 0; w < kFwdWin; w += 4)
        *reinterpret_cast<float4*>(hx + u * ld + kw + w) =
            make_float4(hn[w], hn[w + 1], hn[w + 2], hn[w + 3]);
#pragma unroll
      for (int w = 0; w < kFwdWin; ++w)
        if (w < mine)
#pragma unroll
          for (int g = 0; g < 5; ++g) act[w * stride + (W + t) * step + g * H] = out[g][w];
    }
#pragma unroll
    for (int r = 0; r < kFwdMaxPairs; ++r) {
      int k, f;
      if (t > 0 && fwd_pair(r, nk, F, k, f)) {
        float acc = 0.0f;
        for (int j = 0; j < H; ++j) acc += hc[j * ld + k] * w1[j * F + f];
        const float rr = acc + b1[f];
        if (mr[r]) {
          const float d = rr - xr[r];
          se[k * F + f] += double(d * d);
          nn[k * F + f] += 1.0;
        }
      }
    }
    __syncthreads();
  }
  cyc[4] = clock64();

  // each block of KB windows: its pairs' sums in (window, feature) order
  const int nb = (nk + a.KB - 1) / a.KB, kb0 = k0 / a.KB;
  for (int b = tid; b < nb; b += nt) {
    double s = 0.0, m = 0.0;
    for (int i = b * a.KB * F; i < min((b + 1) * a.KB, nk) * F; ++i) {
      s += se[i];
      m += nn[i];
    }
    a.num[size_t(job) * a.nkb + kb0 + b] = s;
    a.cnt[size_t(job) * a.nkb + kb0 + b] = m;
  }
  if (a.clocks != nullptr) {
    __syncthreads();
    if (tid == 0) {
      cyc[5] = clock64();
      add_fwd_clocks(a.clocks, job, cyc);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, entry 1: the recurrence
// ---------------------------------------------------------------------------
// A group of 32 ceil(H / 32) threads runs kBpttWin windows side by side,
// thread u owning unit u of each: a recurrent weight read from shared memory
// serves all of them.
constexpr int kBpttWin = 2;

struct BpttArgs {
  const float* params;
  long long P;
  const float* x;
  const uint8_t* mask;
  int J, K, W, F, H, Z, KR, nkr, GT;  // KR windows a CTA, GT threads a group
  float* act;  // (J K, 2, W, 5H): read, then each slot rewritten as (da_t, h_{t-1})
  float* rec;  // (J K, S): the per-window record
};

// A window's record: z (Z), the decoder's sum of da over its steps (4H),
// the encoder's last h (H), the latent's gradient (Z), Dense_1's kernel
// gradient (H x F, its layout) and bias gradient (F), then the encoder's
// input as floats, [x_t, m_t] a step (W x 2F).
struct RecLayout {
  int z, ddz, hlast, dzl, dw1, db1, inp, S;
};

__host__ __device__ inline RecLayout rec_layout(int F, int H, int Z, int W) {
  RecLayout r;
  r.z = 0;
  r.ddz = Z;
  r.hlast = r.ddz + 4 * H;
  r.dzl = r.hlast + H;
  r.dw1 = r.dzl + Z;
  r.db1 = r.dw1 + H * F;
  r.inp = r.db1 + F;
  r.S = r.inp + 2 * F * W;
  return r;
}

__host__ __device__ inline int bptt_group_threads(int H) { return 32 * ((H + 31) / 32); }

// windows a CTA of the recurrence runs: kBpttWin a group, as many groups as
// kBpttThreads threads hold and K needs
__host__ inline int bptt_windows(int K, int H) {
  const int groups = kBpttThreads / bptt_group_threads(H), need = (K + kBpttWin - 1) / kBpttWin;
  return (groups < need ? groups : need) * kBpttWin;
}

// shared floats of one window of the recurrence: da (double-buffered, 8H),
// the decoder's sum of da (4H), the encoder's last h (H), the latent's
// gradient (Z), the head's per-warp partials (F a warp), Dense_1's gradient
// (F x H)
__host__ __device__ inline int bptt_window_floats(int F, int H, int Z) {
  const int nw = (H + 31) / 32;
  return 12 * H + align4(H) + align4(Z) + align4(nw * F) + align4(H * F);
}

__host__ inline long long bptt_smem_bytes(int F, int H, int Z, int KR, int wh_smem) {
  long long floats = align4(F * H) + 1LL * KR * bptt_window_floats(F, H, Z);
  if (wh_smem) floats += align4(H * (4 * H + 1));
  return floats * 4;
}

// a barrier over one group's threads: the warp itself, or the named
// barrier `id` of n threads
__device__ __forceinline__ void group_sync(int id, int n) {
  if (n == 32) {
    __syncwarp();
    return;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Wh (H, 4H) into shared memory, rows padded to 4H + 1 floats: the thread
// of unit u reads row u, lanes on distinct banks
__device__ __forceinline__ void stage_wh(float* dst, const float* wh, int H) {
  const int G = 4 * H;
  for (int i = threadIdx.x; i < H * G; i += blockDim.x) dst[i + i / G] = wh[i];
}

// One thread's view of its group's windows during the recurrence.
struct BpttLane {
  int H, F, W, GT, u, bar;
  bool own;                 // u < H: the thread owns unit u
  bool live[kBpttWin];      // the window exists
  bool unit[kBpttWin];      // both
  const float* wh;          // the LSTM's Wh (H, 4H), rows ldw floats apart
  int ldw;
  const float* w1t;         // Dense_1's kernel transposed (F, H), shared
  const float* b1;
  float* dab[kBpttWin];     // a window's da, two buffers of 4H
  float* hps[kBpttWin];     // the head's per-warp partials
  float* dw1[kBpttWin];     // Dense_1's kernel gradient (F, H)
  float* inp[kBpttWin];     // the record's encoder input (W, 2F)
  float db1[kBpttWin];      // Dense_1's bias gradient of feature u (u < F)
  float ddz[kBpttWin][4];   // the decoder's sum of da over its steps, unit u's gates
};

// The head's error at feature f of window w, from s = h_t W1[:, f] summed
// over the window's units: 2 (r - x) at a valid slot (x and the mask on
// lane f), into dh, Dense_1's gradients
__device__ __forceinline__ void head_error(BpttLane& L, int w, int f, float s, float xv, int mv,
                                           float h, float& dh) {
  const float r = s + L.b1[f];
  const float xf = __shfl_sync(kFullWarp, xv, f);
  const int mf = __shfl_sync(kFullWarp, mv, f);
  const float d = mf ? 2.0f * (r - xf) : 0.0f;
  if (L.unit[w]) {
    const int at = f * L.H + L.u;
    dh = fmaf(d, L.w1t[at], dh);
    L.dw1[w][at] = fmaf(h, d, L.dw1[w][at]);
  }
  if (L.u == f) L.db1[w] += d;
}

// The steps of one LSTM of the group's windows, last step first: act[w]
// holds window w's W slots, xw / mw its values and mask (W, F); dh and dc
// enter as the gradients after the last step and leave as those of the
// initial state.
template <bool kDecoder>
__device__ __forceinline__ void bptt_steps(BpttLane& L, float* const (&act)[kBpttWin],
                                           const float* const (&xw)[kBpttWin],
                                           const uint8_t* const (&mw)[kBpttWin],
                                           float (&dh)[kBpttWin], float (&dc)[kBpttWin]) {
  constexpr int NWIN = kBpttWin;
  const int H = L.H, F = L.F, W = L.W, u = L.u, lane = u & 31, warp = u >> 5;
  const int NW = L.GT >> 5;
  const size_t step = size_t(5) * H;
  // slot W - 1's o and c, then the first step's prefetch
  float o_c[NWIN], c_c[NWIN], tc_c[NWIN], h_c[NWIN];
  float pi[NWIN], pf[NWIN], pg[NWIN], po[NWIN], pc[NWIN], px[NWIN];
  int pm[NWIN];
#pragma unroll
  for (int w = 0; w < NWIN; ++w) {
    o_c[w] = c_c[w] = pi[w] = pf[w] = pg[w] = po[w] = pc[w] = px[w] = 0.0f;
    pm[w] = 0;
    if (L.unit[w]) {
      const float* s = act[w] + (W - 1) * step;
      o_c[w] = s[3 * H + u];
      c_c[w] = s[4 * H + u];
      pi[w] = s[u];
      pf[w] = s[H + u];
      pg[w] = s[2 * H + u];
      if (W >= 2) {
        po[w] = (s - step)[3 * H + u];
        pc[w] = (s - step)[4 * H + u];
      }
    }
    if (kDecoder && L.live[w] && lane < F) {
      px[w] = xw[w][(W - 1) * F + lane];
      pm[w] = mw[w][(W - 1) * F + lane];
    }
    tc_c[w] = tanhf(c_c[w]);
    h_c[w] = o_c[w] * tc_c[w];
  }
  for (int t = W - 1; t >= 0; --t) {
    float ig[NWIN], fg[NWIN], gg[NWIN], cp[NWIN], op[NWIN], xv[NWIN], tcp[NWIN], hp[NWIN];
    int mv[NWIN];
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      ig[w] = pi[w];
      fg[w] = pf[w];
      gg[w] = pg[w];
      cp[w] = pc[w];
      op[w] = po[w];
      xv[w] = px[w];
      mv[w] = pm[w];
      if (t >= 1) {  // the next step's loads, in flight during this one
        if (L.unit[w]) {
          const float* s = act[w] + (t - 1) * step;
          pi[w] = s[u];
          pf[w] = s[H + u];
          pg[w] = s[2 * H + u];
          po[w] = t >= 2 ? (s - step)[3 * H + u] : 0.0f;
          pc[w] = t >= 2 ? (s - step)[4 * H + u] : 0.0f;
        }
        if (kDecoder && L.live[w] && lane < F) {
          px[w] = xw[w][(t - 1) * F + lane];
          pm[w] = mw[w][(t - 1) * F + lane];
        }
      }
      tcp[w] = tanhf(cp[w]);  // h_{t-1}, zero before the first step
      hp[w] = op[w] * tcp[w];
      // the encoder's input of step t as floats, for its input kernel's
      // gradient (the encoder reads the decoder's targets: the same x)
      if (kDecoder && L.live[w] && u < F) {
        L.inp[w][t * 2 * F + u] = xv[w];
        L.inp[w][t * 2 * F + F + u] = mv[w] ? 1.0f : 0.0f;
      }
    }
    if (kDecoder) {
      // the head: r = h_t W1 + b1 summed over the window's units (the warp,
      // then the group's warps in order), its error 2 (r - x) at valid slots
#pragma unroll
      for (int w = 0; w < NWIN; ++w)
        for (int f = 0; f < F; ++f) {
          const float s = warp_sum(L.unit[w] ? h_c[w] * L.w1t[f * H + u] : 0.0f);
          if (NW == 1)
            head_error(L, w, f, s, xv[w], mv[w], h_c[w], dh[w]);
          else if (lane == 0)
            L.hps[w][warp * F + f] = s;
        }
      if (NW > 1) {
        group_sync(L.bar, L.GT);
#pragma unroll
        for (int w = 0; w < NWIN; ++w)
          for (int f = 0; f < F; ++f) {
            float s = L.hps[w][f];
            for (int q = 1; q < NW; ++q) s += L.hps[w][q * F + f];
            head_error(L, w, f, s, xv[w], mv[w], h_c[w], dh[w]);
          }
      }
    }
    // the cell: da_t (4H) and h_{t-1} over slot t, da into this step's buffer
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      if (!L.unit[w]) continue;
      const float dcv = dh[w] * o_c[w] * (1.0f - tc_c[w] * tc_c[w]) + dc[w];
      float da[4];
      da[0] = (dcv * gg[w]) * (ig[w] * (1.0f - ig[w]));
      da[1] = (dcv * cp[w]) * (fg[w] * (1.0f - fg[w]));
      da[2] = (dcv * ig[w]) * (1.0f - gg[w] * gg[w]);
      da[3] = (dh[w] * tc_c[w]) * (o_c[w] * (1.0f - o_c[w]));
      dc[w] = dcv * fg[w];
      float* s = act[w] + t * step;
      float* d = L.dab[w] + (t & 1) * 4 * H;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[q * H + u] = da[q];
        d[q * H + u] = da[q];
        if (kDecoder) L.ddz[w][q] += da[q];
      }
      s[4 * H + u] = hp[w];
    }
    group_sync(L.bar, L.GT);
    if (t > 0 && L.own) {  // dh_{t-1} = da_t Wh^T: unit u's row of Wh, da broadcast
      const float* wr = L.wh + size_t(u) * L.ldw;
      float acc[NWIN];
#pragma unroll
      for (int w = 0; w < NWIN; ++w) acc[w] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < H; ++c) {
        const float w0 = wr[4 * c], w1 = wr[4 * c + 1], w2 = wr[4 * c + 2], w3 = wr[4 * c + 3];
#pragma unroll
        for (int w = 0; w < NWIN; ++w) {
          const float4 v = reinterpret_cast<const float4*>(L.dab[w] + (t & 1) * 4 * H)[c];
          acc[w] = fmaf(v.x, w0, acc[w]);
          acc[w] = fmaf(v.y, w1, acc[w]);
          acc[w] = fmaf(v.z, w2, acc[w]);
          acc[w] = fmaf(v.w, w3, acc[w]);
        }
      }
#pragma unroll
      for (int w = 0; w < NWIN; ++w) dh[w] = acc[w];
    }
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      o_c[w] = op[w];
      c_c[w] = cp[w];
      tc_c[w] = tcp[w];
      h_c[w] = hp[w];
    }
  }
}

__global__ void __launch_bounds__(kBpttThreads, 2) lstm_bptt_kernel(BpttArgs a, int wh_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NWIN = kBpttWin;
  const int job = blockIdx.x / a.nkr, kb = blockIdx.x - job * a.nkr;
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, W = a.W, GT = a.GT, tid = threadIdx.x;
  const int g = tid / GT, u = tid - g * GT;
  const int k0 = kb * a.KR + g * NWIN;  // the group's first window in the job
  const bool any = k0 < a.K;
  const LstmLayout l = lstm_layout(a.params + size_t(job) * a.P, F, H, Z);
  float* sp = reinterpret_cast<float*>(smem);
  float* whs = sp;
  if (wh_smem) sp += align4(H * (G + 1));
  float* w1t = sp;
  sp += align4(F * H);
  const int wf = bptt_window_floats(F, H, Z);
  const RecLayout rl = rec_layout(F, H, Z, W);
  const size_t step = size_t(5) * H;
  BpttLane L;
  L.H = H;
  L.F = F;
  L.W = W;
  L.GT = GT;
  L.u = u;
  L.bar = 1 + g;
  L.own = u < H;
  L.ldw = wh_smem ? G + 1 : G;
  L.w1t = w1t;
  L.b1 = l.b1;
  float *zb[NWIN], *hl[NWIN], *dzs[NWIN], *act_enc[NWIN], *act_dec[NWIN], *rec[NWIN];
  const float* xw[NWIN];
  const uint8_t* mw[NWIN];
  float dh[NWIN], dc[NWIN];  // the decoder's h and c after its last step: no gradient
#pragma unroll
  for (int w = 0; w < NWIN; ++w) {
    float* ws = sp + (g * NWIN + w) * wf;
    L.dab[w] = ws;
    zb[w] = ws + 8 * H;
    hl[w] = zb[w] + 4 * H;
    dzs[w] = hl[w] + align4(H);
    L.hps[w] = dzs[w] + align4(Z);
    L.dw1[w] = L.hps[w] + align4((GT >> 5) * F);
    L.live[w] = k0 + w < a.K;
    L.unit[w] = L.live[w] && L.own;
    L.db1[w] = 0.0f;
    for (int q = 0; q < 4; ++q) L.ddz[w][q] = 0.0f;
    const size_t win = size_t(job) * a.K + k0 + w;
    act_enc[w] = a.act + win * (2 * W * step);
    act_dec[w] = act_enc[w] + W * step;
    xw[w] = a.x + win * W * F;
    mw[w] = a.mask + win * W * F;
    rec[w] = a.rec + win * rl.S;
    L.inp[w] = rec[w] + rl.inp;
    dh[w] = dc[w] = 0.0f;
    if (any)
      for (int i = u; i < F * H; i += GT) L.dw1[w][i] = 0.0f;
  }
  for (int i = tid; i < H * F; i += blockDim.x) {
    const int j = i / F, f = i - j * F;
    w1t[f * H + j] = l.w1[i];
  }
  if (wh_smem) stage_wh(whs, l.wh_d, H);
  __syncthreads();
  L.wh = wh_smem ? whs : l.wh_d;

  if (any) {
    // the decoder and its head
    bptt_steps<true>(L, act_dec, xw, mw, dh, dc);
    // the latent: z = h_enc,W-1 W0 + b0 (as the forward), its gradient
    // dzl = ddz Wi_d^T, then the encoder's last dh = dzl W0^T
#pragma unroll
    for (int w = 0; w < NWIN; ++w)
      if (L.unit[w]) {
        for (int q = 0; q < 4; ++q) zb[w][q * H + u] = L.ddz[w][q];
        const float* s = act_enc[w] + (W - 1) * step;
        hl[w][u] = s[3 * H + u] * tanhf(s[4 * H + u]);
      }
    group_sync(L.bar, GT);
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      if (!L.live[w]) continue;
      for (int q = u; q < Z; q += GT) {
        float acc = 0.0f;
        for (int j = 0; j < H; ++j) acc += hl[w][j] * l.w0[j * Z + q];
        rec[w][rl.z + q] = acc + l.b0[q];
        const float* wi = l.wi_d + size_t(q) * G;
        float d = 0.0f;
        for (int c = 0; c < G; ++c) d = fmaf(zb[w][c], wi[c], d);
        dzs[w][q] = d;
        rec[w][rl.dzl + q] = d;
      }
      for (int i = u; i < G; i += GT) rec[w][rl.ddz + i] = zb[w][i];
      if (L.own) rec[w][rl.hlast + u] = hl[w][u];
    }
    group_sync(L.bar, GT);
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      dh[w] = 0.0f;
      dc[w] = 0.0f;
      if (L.unit[w])
        for (int q = 0; q < Z; ++q) dh[w] = fmaf(dzs[w][q], l.w0[u * Z + q], dh[w]);
    }
  }
  __syncthreads();
  if (wh_smem) stage_wh(whs, l.wh_e, H);
  __syncthreads();
  L.wh = wh_smem ? whs : l.wh_e;
  if (any) {
    bptt_steps<false>(L, act_enc, xw, mw, dh, dc);
#pragma unroll
    for (int w = 0; w < NWIN; ++w) {
      if (L.unit[w])
        for (int f = 0; f < F; ++f) rec[w][rl.dw1 + u * F + f] = L.dw1[w][f * H + u];
      if (L.live[w] && u < F) rec[w][rl.db1 + u] = L.db1[w];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, entry 1, the wide path: a CTA a window, any F and H
// ---------------------------------------------------------------------------
// Where the group path does not serve (more than kBpttThreads / 32 warps of
// units, or more features than a warp's lanes): kBpttWideThreads threads
// stride the window's units (thread u % blockDim owns unit u: its dh, dc,
// its slots' entries and its rows of Dense_1's gradient) and its features
// (thread f % blockDim: the head's error and Dense_1's bias gradient). The
// same records and rewritten slots as the group path, summed in other
// orders (held to the twin, not to the group path's bits). The head's
// products and Dense_1's kernel gradient go through the record in device
// memory, the state through shared memory: three barriers a step. Not
// tuned: each unit's row of Wh is read from device memory (L2) each step.
constexpr int kBpttWideThreads = 256;

// shared floats: da (4H), the decoder's sum of da (4H), h_t, dh, dc and the
// encoder's last h (H each), the head's errors (F), the latent's gradient (Z)
__host__ __device__ inline int bptt_wide_floats(int F, int H, int Z) {
  return 8 * H + 4 * H + F + Z;
}

__device__ void bptt_wide_steps(bool decoder, const float* wh, const LstmLayout& l,
                                float* act, const float* xw, const uint8_t* mw, int W, int F,
                                int H, float* da, float* ddz, float* hs, float* dh, float* dc,
                                float* df, float* rec, const RecLayout& rl) {
  const int tid = threadIdx.x, nt = blockDim.x, G = 4 * H;
  const size_t step = size_t(5) * H;
  for (int t = W - 1; t >= 0; --t) {
    float* s = act + t * step;
    if (decoder) {
      // h_t, then the head's errors 2 (r - x) at valid slots
      for (int u = tid; u < H; u += nt) hs[u] = s[3 * H + u] * tanhf(s[4 * H + u]);
      __syncthreads();
      for (int f = tid; f < F; f += nt) {
        float acc = 0.0f;
        for (int u = 0; u < H; ++u) acc = fmaf(hs[u], l.w1[u * F + f], acc);
        const float r = acc + l.b1[f];
        const float d = mw[t * F + f] ? 2.0f * (r - xw[t * F + f]) : 0.0f;
        df[f] = d;
        rec[rl.db1 + f] += d;
      }
      __syncthreads();
    }
    for (int u = tid; u < H; u += nt) {
      const float ig = s[u], fg = s[H + u], gg = s[2 * H + u], og = s[3 * H + u];
      const float tc = tanhf(s[4 * H + u]);
      const float cp = t >= 1 ? (s - step)[4 * H + u] : 0.0f;
      const float op = t >= 1 ? (s - step)[3 * H + u] : 0.0f;
      const float hp = op * tanhf(cp);
      float dhu = dh[u];
      if (decoder) {
        const float h = hs[u];
        float* dw1 = rec + rl.dw1 + size_t(u) * F;
        for (int f = 0; f < F; ++f) {
          dhu = fmaf(df[f], l.w1[u * F + f], dhu);
          dw1[f] = fmaf(h, df[f], dw1[f]);
        }
      }
      const float dcv = dhu * og * (1.0f - tc * tc) + dc[u];
      float d4[4];
      d4[0] = (dcv * gg) * (ig * (1.0f - ig));
      d4[1] = (dcv * cp) * (fg * (1.0f - fg));
      d4[2] = (dcv * ig) * (1.0f - gg * gg);
      d4[3] = (dhu * tc) * (og * (1.0f - og));
      dc[u] = dcv * fg;
      for (int q = 0; q < 4; ++q) {
        s[q * H + u] = d4[q];
        da[q * H + u] = d4[q];
        if (decoder) ddz[q * H + u] += d4[q];
      }
      s[4 * H + u] = hp;
    }
    __syncthreads();
    if (t > 0) {  // dh_{t-1} = da_t Wh^T, unit u's row of Wh
      for (int u = tid; u < H; u += nt) {
        const float* wr = wh + size_t(u) * G;
        float acc = 0.0f;
        for (int c = 0; c < G; ++c) acc = fmaf(da[c], wr[c], acc);
        dh[u] = acc;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBpttWideThreads) lstm_bptt_wide_kernel(BpttArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, W = a.W, tid = threadIdx.x, nt = blockDim.x;
  const size_t win = blockIdx.x;  // job * K + window
  const int job = int(win / a.K);
  const LstmLayout l = lstm_layout(a.params + size_t(job) * a.P, F, H, Z);
  const RecLayout rl = rec_layout(F, H, Z, W);
  const size_t step = size_t(5) * H;
  float* da = reinterpret_cast<float*>(smem);
  float* ddz = da + G;
  float* hs = ddz + G;
  float* dh = hs + H;
  float* dc = dh + H;
  float* hl = dc + H;
  float* df = hl + H;
  float* dzs = df + F;
  float* act_enc = a.act + win * (2 * W * step);
  float* act_dec = act_enc + W * step;
  const float* xw = a.x + win * W * F;
  const uint8_t* mw = a.mask + win * W * F;
  float* rec = a.rec + win * rl.S;
  for (int i = tid; i < W * F; i += nt) {
    const int t = i / F, f = i - t * F;
    rec[rl.inp + t * 2 * F + f] = xw[i];
    rec[rl.inp + t * 2 * F + F + f] = mw[i] ? 1.0f : 0.0f;
  }
  for (int u = tid; u < H; u += nt) {
    for (int f = 0; f < F; ++f) rec[rl.dw1 + size_t(u) * F + f] = 0.0f;
    dh[u] = dc[u] = 0.0f;
  }
  for (int f = tid; f < F; f += nt) rec[rl.db1 + f] = 0.0f;
  for (int i = tid; i < G; i += nt) ddz[i] = 0.0f;
  __syncthreads();

  // the decoder and its head
  bptt_wide_steps(true, l.wh_d, l, act_dec, xw, mw, W, F, H, da, ddz, hs, dh, dc, df, rec, rl);
  // the latent: z = h_enc,W-1 W0 + b0 (as the forward), its gradient
  // dzl = ddz Wi_d^T, then the encoder's last dh = dzl W0^T
  for (int u = tid; u < H; u += nt) {
    const float* s = act_enc + (W - 1) * step;
    hl[u] = s[3 * H + u] * tanhf(s[4 * H + u]);
  }
  __syncthreads();
  for (int q = tid; q < Z; q += nt) {
    float acc = 0.0f;
    for (int j = 0; j < H; ++j) acc += hl[j] * l.w0[j * Z + q];
    rec[rl.z + q] = acc + l.b0[q];
    const float* wi = l.wi_d + size_t(q) * G;
    float d = 0.0f;
    for (int c = 0; c < G; ++c) d = fmaf(ddz[c], wi[c], d);
    dzs[q] = d;
    rec[rl.dzl + q] = d;
  }
  for (int i = tid; i < G; i += nt) rec[rl.ddz + i] = ddz[i];
  for (int u = tid; u < H; u += nt) rec[rl.hlast + u] = hl[u];
  __syncthreads();
  for (int u = tid; u < H; u += nt) {
    float acc = 0.0f;
    for (int q = 0; q < Z; ++q) acc = fmaf(dzs[q], l.w0[u * Z + q], acc);
    dh[u] = acc;
    dc[u] = 0.0f;
  }
  __syncthreads();
  bptt_wide_steps(false, l.wh_e, l, act_enc, xw, mw, W, F, H, da, ddz, hs, dh, dc, df, rec, rl);
}

// ---------------------------------------------------------------------------
// Backward, entry 2: the weight gradients
// ---------------------------------------------------------------------------
struct WgradArgs {
  const float* act;  // (J K, 2, W, 5H) as the recurrence left it
  const float* rec;  // (J K, S)
  float* gpart;      // (J, P)
  long long P;
  int J, K, W, F, H, Z;
  int mt_enc, mt_dec, nt, per_job, vec;
};

__host__ __device__ inline void wgrad_tiles(int F, int H, int& mt_enc, int& mt_dec, int& nt) {
  mt_enc = (H + 2 * F + 1 + kGemmBM - 1) / kGemmBM;
  mt_dec = (H + kGemmBM - 1) / kGemmBM;
  nt = (4 * H + kGemmBN - 1) / kGemmBN;
}

// One output tile (rows m0.., columns n0..) of LSTM lstm's weight
// gradient, sum over the job's rows r = (window, step) of A_r^T B_r with
// A_r = [h_{t-1}] (decoder) or [h_{t-1}, x_t, m_t, 1] (encoder; x_t, m_t from
// the window's record) and B_r = da_t. Both operands reach shared memory
// by cp.async, kGemmStages chunks of rows in flight.
__device__ void wgrad_tile(const WgradArgs& a, int job, int lstm, int m0, int n0,
                           float* smem) {
  const int H = a.H, G = 4 * H, F = a.F, W = a.W, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int M = lstm == 0 ? H + 2 * F + 1 : H, R = a.K * W;
  const size_t step = size_t(5) * H;
  const float* actj = a.act + size_t(job) * a.K * 2 * W * step;
  const RecLayout rl = rec_layout(F, H, a.Z, W);
  const float* recj = a.rec + size_t(job) * a.K * rl.S + rl.inp;
  float* As = smem;                                      // [stages][BK][LdA]
  float* Bs = smem + kGemmStages * kGemmBK * kGemmLdA;   // [stages][BK][BN]
  // chunk r0's rows into stage st, a warp a row at a time: B (da, BN
  // columns from n0) and A (BM columns from m0) by cp.async, ones and zeros
  // stored
  auto load = [&](int r0, int st) {
    float* Ab = As + st * kGemmBK * kGemmLdA;
    float* Bb = Bs + st * kGemmBK * kGemmBN;
    for (int rr = warp; rr < kGemmBK; rr += kGemmThreads / 32) {
      const int r = r0 + rr, k = r / W, t = r - k * W, i = m0 + lane;
      const float* s = actj + ((size_t(k) * 2 + lstm) * W + t) * step;
      float* a_dst = Ab + rr * kGemmLdA + lane;
      float* b_dst = Bb + rr * kGemmBN;
      if (r >= R || i >= M)
        *a_dst = 0.0f;
      else if (i < H)
        cp_async4(a_dst, s + 4 * H + i);
      else if (i < H + 2 * F)
        cp_async4(a_dst, recj + size_t(k) * rl.S + t * 2 * F + i - H);
      else
        *a_dst = 1.0f;
      if (a.vec) {
        const int c = 4 * lane, n = n0 + c;
        if (r < R && n < G)
          cp_async16(b_dst + c, s + n);
        else
          *reinterpret_cast<float4*>(b_dst + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        for (int c = lane; c < kGemmBN; c += 32) {
          const int n = n0 + c;
          if (r < R && n < G)
            cp_async4(b_dst + c, s + n);
          else
            b_dst[c] = 0.0f;
        }
      }
    }
  };

  float acc[kGemmTM][4];
#pragma unroll
  for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  const bool on = m0 + warp * kGemmTM < M;  // the warp's rows hold outputs
  const int chunks = (R + kGemmBK - 1) / kGemmBK;
  for (int st = 0; st < kGemmStages - 1; ++st) {
    if (st < chunks) load(st * kGemmBK, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait_group<kGemmStages - 2>();  // chunk ch has landed
    __syncthreads();
    const int next = ch + kGemmStages - 1;  // into the stage chunk ch - 1 used
    if (next < chunks) load(next * kGemmBK, next % kGemmStages);
    cp_async_commit();
    if (on) {
      const float* Ab = As + (ch % kGemmStages) * kGemmBK * kGemmLdA + warp * kGemmTM;
      const float* Bb = Bs + (ch % kGemmStages) * kGemmBK * kGemmBN + lane * 4;
#pragma unroll 4
      for (int rr = 0; rr < kGemmBK; ++rr) {
        float ar[kGemmTM];
#pragma unroll
        for (int i = 0; i < kGemmTM; i += 4) {
          const float4 av = *reinterpret_cast<const float4*>(Ab + rr * kGemmLdA + i);
          ar[i] = av.x;
          ar[i + 1] = av.y;
          ar[i + 2] = av.z;
          ar[i + 3] = av.w;
        }
        const float4 bv = *reinterpret_cast<const float4*>(Bb + rr * kGemmBN);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ar[i], br[c], acc[i][c]);
      }
    }
  }
  if (!on) return;
  long long o[10];
  lstm_offsets(F, H, a.Z, o);
  float* out = a.gpart + size_t(job) * a.P;
#pragma unroll
  for (int ii = 0; ii < kGemmTM; ++ii) {
    const int i = m0 + warp * kGemmTM + ii;
    if (i >= M) break;
    float* row;
    if (lstm == 1)
      row = out + o[6] + size_t(i) * G;  // decoder Wh
    else if (i < H)
      row = out + o[1] + size_t(i) * G;  // encoder Wh
    else if (i < H + 2 * F)
      row = out + o[0] + size_t(i - H) * G;  // encoder Wi: x, then mask
    else
      row = out + o[2];  // encoder bias
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + lane * 4 + c;
      if (n < G) row[n] = acc[ii][c];
    }
  }
}

// The gradients summed from the job's K window records, each entry by one
// thread over the windows in order: the decoder's input kernel (z^T ddz)
// and bias (sum ddz), Dense_0 (hlast^T dzl, sum dzl), Dense_1 (sums).
__device__ void wgrad_records(const WgradArgs& a, int job) {
  const int F = a.F, H = a.H, Z = a.Z, G = 4 * H, K = a.K;
  const RecLayout rl = rec_layout(F, H, Z, a.W);
  const float* rj = a.rec + size_t(job) * K * rl.S;
  float* out = a.gpart + size_t(job) * a.P;
  long long o[10];
  lstm_offsets(F, H, Z, o);
  for (int i = threadIdx.x; i < (Z + 1) * G; i += blockDim.x) {
    const int q = i / G, c = i - q * G;
    float acc = 0.0f;
    if (q < Z) {
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        acc = fmaf(rj[size_t(k) * rl.S + rl.z + q], rj[size_t(k) * rl.S + rl.ddz + c], acc);
      out[o[5] + i] = acc;
    } else {
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc += rj[size_t(k) * rl.S + rl.ddz + c];
      out[o[7] + c] = acc;
    }
  }
  for (int i = threadIdx.x; i < (H + 1) * Z; i += blockDim.x) {
    const int j = i / Z, q = i - j * Z;
    float acc = 0.0f;
    if (j < H) {
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        acc = fmaf(rj[size_t(k) * rl.S + rl.hlast + j], rj[size_t(k) * rl.S + rl.dzl + q], acc);
      out[o[3] + i] = acc;
    } else {
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc += rj[size_t(k) * rl.S + rl.dzl + q];
      out[o[4] + q] = acc;
    }
  }
  // Dense_1's kernel and bias lie side by side in both layouts
  for (int i = threadIdx.x; i < H * F + F; i += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc += rj[size_t(k) * rl.S + rl.dw1 + i];
    out[o[8] + i] = acc;
  }
}

__global__ void __launch_bounds__(kGemmThreads, 3) lstm_wgrad_kernel(WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int job = blockIdx.x / a.per_job, t = blockIdx.x - job * a.per_job;
  const int enc = a.mt_enc * a.nt, dec = a.mt_dec * a.nt;
  if (t < enc)
    wgrad_tile(a, job, 0, (t / a.nt) * kGemmBM, (t % a.nt) * kGemmBN,
               reinterpret_cast<float*>(smem));
  else if (t < enc + dec)
    wgrad_tile(a, job, 1, ((t - enc) / a.nt) * kGemmBM, ((t - enc) % a.nt) * kGemmBN,
               reinterpret_cast<float*>(smem));
  else
    wgrad_records(a, job);
}

constexpr int kGemmSmemBytes = kGemmStages * (kGemmBK * kGemmLdA + kGemmBK * kGemmBN) * 4;

}  // namespace fm

extern "C" long long fm_lstm_train_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  return fm::train_smem_bytes(F, H, Z, KB, smem_params);
}

extern "C" int fm_lstm_train_forward(const float* params, long long P, const float* x,
                                     const uint8_t* mask, int J, int K, int W, int F, int H,
                                     int Z, int KB, int smem_params, long long tile_budget,
                                     float* act, double* num, double* cnt, long long* clocks,
                                     void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || KB < 1 || W < 1) return int(cudaErrorInvalidValue);
  const int nkb = (K + KB - 1) / KB;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile path where a job's parameters and windows fit its budget
  const int KC = fm::fwd_tile_windows(K, F, H, KB);
  if (KC > 0 && fm::fwd_tile_smem_bytes(F, H, Z, KC) <= tile_budget) {
    const int nkc = (K + KC - 1) / KC;
    fm::TrainArgs a{params, P, x, mask, J, K, W, F, H, Z, KB, nkb, KC, nkc, act, num, cnt,
                    clocks};
    const int smem = int(fm::fwd_tile_smem_bytes(F, H, Z, KC));
    const cudaError_t e = cudaFuncSetAttribute(fm::lstm_train_fwd_tile_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    const int threads = H * ((KC + fm::kFwdWin - 1) / fm::kFwdWin);
    fm::lstm_train_fwd_tile_kernel<<<J * nkc, threads, smem, s>>>(a);
    return int(cudaGetLastError());
  }
  fm::TrainArgs a{params, P, x, mask, J, K, W, F, H, Z, KB, nkb, 0, 0, act, num, cnt, clocks};
  const size_t smem = size_t(fm::train_smem_bytes(F, H, Z, KB, smem_params));
  const cudaError_t e = cudaFuncSetAttribute(fm::lstm_train_fwd_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem));
  if (e != cudaSuccess) return int(e);
  fm::lstm_train_fwd_kernel<<<J * nkb, fm::kTrainThreads, smem, s>>>(a, smem_params);
  return int(cudaGetLastError());
}

extern "C" int fm_lstm_forward_tile_windows(int K, int F, int H, int KB) {
  return fm::fwd_tile_windows(K, F, H, KB);
}

extern "C" long long fm_lstm_forward_tile_smem_bytes(int F, int H, int Z, int KC) {
  return fm::fwd_tile_smem_bytes(F, H, Z, KC);
}

extern "C" int fm_lstm_rec_floats(int F, int H, int Z, int W) {
  return fm::rec_layout(F, H, Z, W).S;
}

extern "C" int fm_lstm_bptt_windows(int K, int H) { return fm::bptt_windows(K, H); }

extern "C" int fm_lstm_bptt(const float* params, long long P, const float* x, const uint8_t* mask,
                            int J, int K, int W, int F, int H, int Z, long long smem_budget,
                            float* act, float* rec, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || W < 1 || K < 1 || F > 32)
    return int(cudaErrorInvalidValue);
  const int GT = fm::bptt_group_threads(H), KR = fm::bptt_windows(K, H);
  const int nkr = (K + KR - 1) / KR;
  fm::BpttArgs a{params, P, x, mask, J, K, W, F, H, Z, KR, nkr, GT, act, rec};
  const int wh_smem = fm::bptt_smem_bytes(F, H, Z, KR, 1) <= smem_budget;
  const size_t smem = size_t(fm::bptt_smem_bytes(F, H, Z, KR, wh_smem));
  const cudaError_t e = cudaFuncSetAttribute(fm::lstm_bptt_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem));
  if (e != cudaSuccess) return int(e);
  const int threads = KR / fm::kBpttWin * GT;
  fm::lstm_bptt_kernel<<<J * nkr, threads, smem, static_cast<cudaStream_t>(stream)>>>(a,
                                                                                     wh_smem);
  return int(cudaGetLastError());
}

// The wide path of the recurrence: a CTA a window (J K CTAs), any F and H
// whose window state fits a CTA's shared memory.
extern "C" long long fm_lstm_bptt_wide_smem_bytes(int F, int H, int Z) {
  return 4LL * fm::bptt_wide_floats(F, H, Z);
}

extern "C" int fm_lstm_bptt_wide(const float* params, long long P, const float* x,
                                 const uint8_t* mask, int J, int K, int W, int F, int H, int Z,
                                 float* act, float* rec, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || W < 1 || K < 1) return int(cudaErrorInvalidValue);
  fm::BpttArgs a{params, P, x, mask, J, K, W, F, H, Z, 1, K, 0, act, rec};
  const int smem = 4 * fm::bptt_wide_floats(F, H, Z);
  const cudaError_t e = cudaFuncSetAttribute(fm::lstm_bptt_wide_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  fm::lstm_bptt_wide_kernel<<<J * K, fm::kBpttWideThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

extern "C" int fm_lstm_wgrad(const float* act, const float* rec, float* gpart, long long P, int J,
                             int K, int W, int F, int H, int Z, int vec, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || W < 1 || K < 1 || (vec && H % 4 != 0))
    return int(cudaErrorInvalidValue);
  int mt_enc, mt_dec, nt;
  fm::wgrad_tiles(F, H, mt_enc, mt_dec, nt);
  const int per_job = (mt_enc + mt_dec) * nt + 1;
  fm::WgradArgs a{act, rec, gpart, P, J, K, W, F, H, Z, mt_enc, mt_dec, nt, per_job, vec};
  const cudaError_t e = cudaFuncSetAttribute(fm::lstm_wgrad_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             fm::kGemmSmemBytes);
  if (e != cudaSuccess) return int(e);
  fm::lstm_wgrad_kernel<<<J * per_job, fm::kGemmThreads, fm::kGemmSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
