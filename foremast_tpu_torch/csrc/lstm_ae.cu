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
// Three paths, chosen by the launcher from (K, W, F, H, Z)
// (kernels.lstm_ae_path), with the same bits: every gate column is summed
// as lstm_step sums it (the input terms from 0, then j ascending, multiply
// then add, gate = ax + (ah + b)), the head's squared errors in float64 by
// step, then by feature, as below.
//   - The warp path (`lstm_ae_warp_kernel`, H <= 32: the engine's width): a
//     warp for a chunk of one job's windows, NW (2 or 4) at a time. Lane u
//     owns unit u and its four gate columns: their recurrent weights' first
//     kWarpRegRows rows in registers, the rest in the warp's slice of
//     shared memory as unit-major float4s, with the registers capped for
//     three CTAs (12 warps) an SM. h is exchanged through the slice
//     (double-buffered, read as broadcasts two rows at a time, one
//     __syncwarp a step); no CTA barrier at all. The decoder's head of step
//     t - 1 rides on step t's reads of h. All the chunk's encoders run
//     first, their latents kept in the slice, then all its decoders, so the
//     row is loaded twice a warp. A chunk is at most four groups, so a
//     job's windows spread over many warps when there are few jobs.
//   - The cluster path (`lstm_ae_cluster_kernel`, 32 < H <= 256: rows too
//     large for one SM, 711 KB at the module's default H = 128, Z = 64): a
//     thread block cluster of ceil(H / 32) CTAs for a chunk of one job's
//     windows; CTA r owns units 32 r.. and their gate columns (warp g,
//     lane u: gate g of unit 32 r + u), each column's first 64 recurrent
//     weights in registers and the rest in shared memory, so each LSTM's
//     Wh crosses device memory once a chunk. Each step's new h is written
//     into every CTA's history (distributed shared memory), then one
//     cluster barrier, split in the encoder so that the next step's input
//     projection runs while it completes. The latents are spread over the
//     cluster; the head runs after the decoder over the kept history, its
//     squared errors gathered into CTA 0 and summed there in step order.
//   - The wide path (`lstm_ae_kernel`, the first design, any width): a CTA
//     of kLstmThreads threads runs up to KB windows of one job (grid J x
//     ceil(K / KB)), their steps in lock step (lstm_step), the parameters in
//     shared memory while they fit, else read through L1 and L2; two
//     barriers a step. Its head loops over the (window, feature) pairs, so
//     any F runs; it is the only path past 256 units.
// Full float32 FMA-free arithmetic (-fmad=false, as the library builds),
// expf / tanhf (never the fast intrinsics), no tensor cores.
//
// What bounds it on an H100: the operations. A window costs 4H (2F + H) +
// 4H H + H F multiply-adds a step and H Z + Z 4H once (301,568 at the
// engine's F = 4, H = 32, Z = 16, W = 32; 4.38 M at H = 128, Z = 64),
// against its job's row (48.7 KB; 711 KB at H = 128) and its windows
// (~0.6 KB). With -fmad=false each multiply-add is an FMUL and an FADD, so
// the fp32 pipes' floor is twice the FMA count's (3.6 ms at 100,000 jobs x
// 2 windows); the gates' expf / tanhf / IEEE divisions add about a third.
// Both new paths are bound by latency more than by issue: each gate
// column's sum is one chain of 2F + H dependent additions a step (the
// order every path keeps), so a warp's throughput rests on how many
// warps an SM holds (registers: the warp path's weights; shared memory:
// the cluster path's history, three CTAs an SM at H = 128). Without its
// cluster barrier (a diagnostic, wrong results) the cluster path ran in
// 84% of its time, so the barrier is not its bound.
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
  int KW, nch;  // the warp and cluster paths: windows a chunk, chunks a job
  float* err;
  float* z;
  long long* clocks;  // null, or (J, kAePhases) SM cycles a job's CTAs spent per phase
};

// phases of the optional cycle counts: parameters staged, the encoder, the
// latent and the decoder's input projection, the decoder and its head, the
// per-window sums
constexpr int kAePhases = 5;

// a CTA's cycles per phase, kept by one thread, added to the job's row
struct AeClock {
  long long c[kAePhases] = {0, 0, 0, 0, 0};
  long long at = 0;
  __device__ __forceinline__ void start() { at = clock64(); }
  __device__ __forceinline__ void mark(int phase) {
    const long long now = clock64();
    c[phase] += now - at;
    at = now;
  }
  __device__ __forceinline__ void add(long long* clocks, int job) const {
    for (int k = 0; k < kAePhases; ++k)
      atomicAdd(reinterpret_cast<unsigned long long*>(clocks) + size_t(job) * kAePhases + k,
                static_cast<unsigned long long>(c[k]));
  }
};

// ---------------------------------------------------------------------------
// The wide path: the first design, a CTA of up to KB windows of one job
// ---------------------------------------------------------------------------
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
  AeClock clk;
  clk.start();
  if (smem_params) {
    for (long long i = tid; i < a.P; i += blockDim.x) sp[i] = p[i];
    p = sp;
    sp += (a.P + 3) & ~3LL;
  }
  if (a.clocks != nullptr) __syncthreads();
  clk.mark(0);
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
  clk.mark(1);
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
  clk.mark(2);

  // the decoder and the head; thread i keeps (window, feature) pairs kf =
  // i, i + blockDim, ..., each pair's squared errors and count summed in
  // step order in part
  for (int kf = tid; kf < nk * F; kf += blockDim.x) part[2 * kf] = part[2 * kf + 1] = 0.0;
  for (int t = 0; t < W; ++t) {
    lstm_step(nullptr, 0, nullptr, dz, l.wh_d, l.b_d, h, c, gates, nk, H);
    for (int kf = tid; kf < nk * F; kf += blockDim.x) {
      const int k = kf / F, f = kf - k * F;
      float acc = 0.0f;
      for (int j = 0; j < H; ++j) acc += h[k * H + j] * l.w1[j * F + f];
      const float r = acc + l.b1[f];
      const size_t at = ((win0 + size_t(k) * W) + t) * F + f;
      if (a.mask[at]) {
        const float d = r - a.x[at];
        part[2 * kf] += double(d * d);
        part[2 * kf + 1] += 1.0;
      }
    }
  }
  __syncthreads();
  clk.mark(3);
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
  if (a.clocks != nullptr) {
    __syncthreads();
    clk.mark(4);
    if (tid == 0) clk.add(a.clocks, job);
  }
}

__host__ inline long long lstm_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  long long floats = 1LL * KB * lstm_window_floats(F, H, Z) + 2;
  if (smem_params) floats += (lstm_param_count(F, H, Z) + 3) & ~3LL;
  return floats * 4;
}

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// The window chunks of the warp and cluster paths: groups of NW windows, at
// most kMaxGroups a chunk, fewer where the jobs alone give fewer than
// kChunkTarget groups' worth of work
constexpr int kMaxGroups = 4;
constexpr long long kChunkTarget = 16384;

__host__ inline int chunk_windows(int J, int K, int NW) {
  const long long groups = (K + NW - 1) / NW;
  long long per = (1LL * J * groups + kChunkTarget - 1) / kChunkTarget;
  per = per < 1 ? 1 : per > kMaxGroups ? kMaxGroups : per;
  return int(per < groups ? per : groups) * NW;
}

// ---------------------------------------------------------------------------
// The warp path: H <= 32, a warp for a chunk of one job's windows
// ---------------------------------------------------------------------------
constexpr int kWarpUnits = 32;    // units a warp holds (lane u owns unit u)
constexpr int kWarpThreads = 128;  // four independent warps a CTA
constexpr int kWarpMinBlocks = 3;  // CTAs an SM the registers are sized for
// rows of a lane's recurrent weights kept in registers; the rest sit in the
// warp's slice of shared memory as unit-major float4s. On an H100, 16 rows
// at three CTAs an SM beat all 32 at two (8.86 against 9.31 ms at 100,000
// jobs x 2 windows, 20.0 against 24.5 ms at 10,000 x 45); 12 or 20 rows
// were within 4% of 16.
constexpr int kWarpRegRows = 16;

// A warp's slice of shared memory, in floats: the encoder's input weights
// as unit-major float4s (2F x 32), the recurrent weights' rows past
// kWarpRegRows (likewise), h (two buffers of [j][w]), the step's
// input (two buffers of [q][w]), the chunk's latents ([q][k], KW windows),
// Dense_1 (H x F) and its bias, each pair's squared-error sum and count
// (float64).
struct WarpLayout {
  int wi, wh, h, inp, zl, w1, b1, part, floats;
};

__host__ __device__ inline WarpLayout warp_layout(int F, int H, int Z, int NW, int KW) {
  WarpLayout l;
  int at = 0;
  l.wi = at, at += 2 * F * kWarpUnits * 4;
  l.wh = at, at += (kWarpUnits - kWarpRegRows) * kWarpUnits * 4;
  l.h = at, at += 2 * kWarpUnits * NW;
  l.inp = at, at += align4(2 * 2 * F * NW);
  l.zl = at, at += align4(Z * KW);
  l.w1 = at, at += align4(H * F);
  l.b1 = at, at += align4(F);
  l.part = at, at += 4 * NW * F;
  l.floats = at;
  return l;
}

__host__ inline long long warp_smem_bytes(int F, int H, int Z, int NW, int KW) {
  return 4LL * (kWarpThreads / 32) * warp_layout(F, H, Z, NW, KW).floats;
}

// NW values at p (NW floats, 8- or 16-byte aligned) as a broadcast read
template <int NW>
__device__ __forceinline__ void load_nw(const float* p, float (&v)[NW]) {
  static_assert(NW == 2 || NW == 4, "two or four windows");
  if constexpr (NW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

template <int NW>
__device__ __forceinline__ void store_nw(float* p, const float (&v)[NW]) {
  if constexpr (NW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// h of rows j and j + 1 (NW floats each, j even): one 16-byte broadcast
// read at NW = 2, two at NW = 4
template <int NW>
__device__ __forceinline__ void load_rows2(const float* h, int j, float (&v)[2][NW]) {
  load_nw<NW>(h + j * NW, v[0]);
  load_nw<NW>(h + (j + 1) * NW, v[1]);
}

template <>
__device__ __forceinline__ void load_rows2<2>(const float* h, int j, float (&v)[2][2]) {
  const float4 t = *reinterpret_cast<const float4*>(h + j * 2);
  v[0][0] = t.x, v[0][1] = t.y, v[1][0] = t.z, v[1][1] = t.w;
}

// One step of lane u's unit over NW windows: the input projection (ax,
// summed by the caller) plus h (32 rows of NW floats) times the lane's
// recurrent weights, then the cell update; hn receives the new h. With
// kHead, the same reads of h also run the previous step's head for this
// lane's (window pw, feature pf): head = sum_j h[j][pw] w1[j F + pf], j
// ascending from 0. kFull: H = 32 (no row is skipped).
template <int NW, bool kFull, bool kHead>
__device__ __forceinline__ void warp_cell(const float (&ax)[4][NW], const float* h,
                                          const float (&wh)[kWarpRegRows][4], const float4* whs,
                                          float4 b, int H, float (&c)[NW], float (&hn)[NW],
                                          const float* w1, int F, int pw, int pf, float& head) {
  float ah[4][NW];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int w = 0; w < NW; ++w) ah[g][w] = 0.0f;
  head = 0.0f;
#pragma unroll
  for (int j = 0; j < kWarpUnits; j += 2) {
    if (kFull || j < H) {
      float v[2][NW];
      load_rows2<NW>(h, j, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kFull || j + r < H) {
          float4 wj;
          if (j + r < kWarpRegRows)
            wj = make_float4(wh[j + r][0], wh[j + r][1], wh[j + r][2], wh[j + r][3]);
          else
            wj = whs[(j + r - kWarpRegRows) * kWarpUnits];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            ah[0][w] += v[r][w] * wj.x;
            ah[1][w] += v[r][w] * wj.y;
            ah[2][w] += v[r][w] * wj.z;
            ah[3][w] += v[r][w] * wj.w;
          }
          if (kHead) {
            float hv = v[r][0];
#pragma unroll
            for (int w = 1; w < NW; ++w) hv = pw == w ? v[r][w] : hv;
            head += hv * w1[(j + r) * F + pf];
          }
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float ig = sigmoid(ax[0][w] + (ah[0][w] + b.x));
    const float fg = sigmoid(ax[1][w] + (ah[1][w] + b.y));
    const float gg = tanhf(ax[2][w] + (ah[2][w] + b.z));
    const float og = sigmoid(ax[3][w] + (ah[3][w] + b.w));
    const float cn = fg * c[w] + ig * gg;
    c[w] = cn;
    hn[w] = og * tanhf(cn);
  }
}

// lane u's four gate columns of a (rows x 4H) matrix at m: row j's entries
// into w[j][g] below kWarpRegRows, else into ws[(j - kWarpRegRows) 32 + u]
// (zero for j >= H or u >= H)
template <bool kFull>
__device__ __forceinline__ void warp_weights(const float* m, int H, int u,
                                             float (&w)[kWarpRegRows][4], float4* ws) {
  const int G = 4 * H;
#pragma unroll
  for (int j = 0; j < kWarpUnits; ++j) {
    float e[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) e[g] = ((kFull || j < H) && u < H) ? m[j * G + g * H + u] : 0.0f;
    if (j < kWarpRegRows) {
#pragma unroll
      for (int g = 0; g < 4; ++g) w[j][g] = e[g];
    } else {
      ws[(j - kWarpRegRows) * kWarpUnits + u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

template <int NW, bool kFull>
__global__ void __launch_bounds__(kWarpThreads, kWarpMinBlocks) lstm_ae_warp_kernel(LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long gw = 1LL * blockIdx.x * (kWarpThreads / 32) + wid;
  if (gw >= 1LL * a.J * a.nch) return;  // the whole warp: no CTA barrier follows
  const int job = int(gw / a.nch), ch = int(gw - 1LL * job * a.nch);
  const int k0 = ch * a.KW, nk = min(a.KW, a.K - k0);
  const int F = a.F, H = kFull ? kWarpUnits : a.H, Z = a.Z, W = a.W, G = 4 * H, IN = 2 * F;
  const int u = lane;
  const WarpLayout L = warp_layout(F, H, Z, NW, a.KW);
  float* sm = reinterpret_cast<float*>(smem) + size_t(wid) * L.floats;
  float4* wi = reinterpret_cast<float4*>(sm + L.wi);
  float4* whs = reinterpret_cast<float4*>(sm + L.wh);
  float* hb = sm + L.h;
  float* inp = sm + L.inp;
  float* zl = sm + L.zl;
  float* w1 = sm + L.w1;
  float* b1 = sm + L.b1;
  double* part = reinterpret_cast<double*>(sm + L.part);  // (NW F) sums, then counts
  AeClock clk;
  clk.start();

  const float* p = a.params + size_t(job) * a.P;
  long long o[10];
  lstm_offsets(F, H, Z, o);
#pragma unroll 4
  for (int i = lane; i < IN * kWarpUnits; i += 32) {
    const int q = i / kWarpUnits, uu = i - q * kWarpUnits;
    const float* r = p + o[0] + size_t(q) * G + uu;
    wi[i] = uu < H ? make_float4(r[0], r[H], r[2 * H], r[3 * H]) : make_float4(0, 0, 0, 0);
  }
#pragma unroll 4
  for (int i = lane; i < H * F; i += 32) w1[i] = p[o[8] + i];
  for (int i = lane; i < F; i += 32) b1[i] = p[o[9] + i];
  float wh[kWarpRegRows][4];
  warp_weights<kFull>(p + o[1], H, u, wh, whs);
  float4 b = u < H ? make_float4(p[o[2] + u], p[o[2] + H + u], p[o[2] + 2 * H + u],
                                 p[o[2] + 3 * H + u])
                   : make_float4(0, 0, 0, 0);
  __syncwarp();
  clk.mark(0);

  // pair lane (w, f) of a group: its window and feature (NW F <= 32); the
  // other lanes take window NW - 1's values and keep nothing
  const int pw = min(lane / F, NW - 1), pf = lane - (lane / F) * F;
  const bool pair = lane < NW * F;
  const size_t win0 = size_t(job) * a.K + k0;  // the chunk's first window
  float head;

  // the encoders of the chunk's groups, each group's latents into zl
  for (int kg = 0; kg < nk; kg += NW) {
    const int nv = min(NW, nk - kg);
    const bool pv = pair && pw < nv;
    const float* xg = a.x + (win0 + kg + pw) * W * F + pf;
    const uint8_t* mg = a.mask + (win0 + kg + pw) * W * F + pf;
    {
      const float z0[NW] = {};
      store_nw<NW>(hb + u * NW, z0);
    }
    if (pair) {
      inp[pf * NW + pw] = pv ? xg[0] : 0.0f;
      inp[(F + pf) * NW + pw] = pv && mg[0] ? 1.0f : 0.0f;
    }
    float c[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) c[w] = 0.0f;
    __syncwarp();
    for (int t = 0; t < W; ++t) {
      const float* in = inp + (t & 1) * IN * NW;
      float xr = 0.0f;
      bool mr = false;
      if (pv && t + 1 < W) {
        xr = xg[size_t(t + 1) * F];
        mr = mg[size_t(t + 1) * F];
      }
      float ax[4][NW];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int w = 0; w < NW; ++w) ax[g][w] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < IN; ++q) {
        const float4 wq = wi[q * kWarpUnits + u];
        float v[NW];
        load_nw<NW>(in + q * NW, v);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          ax[0][w] += v[w] * wq.x;
          ax[1][w] += v[w] * wq.y;
          ax[2][w] += v[w] * wq.z;
          ax[3][w] += v[w] * wq.w;
        }
      }
      float hn[NW];
      warp_cell<NW, kFull, false>(ax, hb + (t & 1) * kWarpUnits * NW, wh, whs + u, b, H, c, hn,
                                  w1, F, pw, pf, head);
      store_nw<NW>(hb + ((t + 1) & 1) * kWarpUnits * NW + u * NW, hn);
      if (pair && t + 1 < W) {
        float* nx = inp + ((t + 1) & 1) * IN * NW;
        nx[pf * NW + pw] = xr;
        nx[(F + pf) * NW + pw] = mr ? 1.0f : 0.0f;
      }
      __syncwarp();
    }
    clk.mark(1);
    const float* he = hb + (W & 1) * kWarpUnits * NW;
    for (int q = lane; q < Z; q += 32) {
      float acc[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w] = 0.0f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) {
        const float wq = p[o[3] + size_t(j) * Z + q];
        float v[NW];
        load_nw<NW>(he + j * NW, v);
#pragma unroll
        for (int w = 0; w < NW; ++w) acc[w] += v[w] * wq;
      }
      const float bq = p[o[4] + q];
#pragma unroll
      for (int w = 0; w < NW; ++w) zl[q * a.KW + kg + w] = acc[w] + bq;
    }
    __syncwarp();
    clk.mark(2);
  }

  // the decoders: the latent's projection once a window, then the steps;
  // step t also runs the head of step t - 1 on the h it reads, and the
  // last step's head follows the loop
  warp_weights<kFull>(p + o[6], H, u, wh, whs);  // a lane's whs entries are its own
  b = u < H ? make_float4(p[o[7] + u], p[o[7] + H + u], p[o[7] + 2 * H + u],
                          p[o[7] + 3 * H + u])
            : make_float4(0, 0, 0, 0);
  clk.mark(0);
  const float b1f = b1[pf];
  for (int kg = 0; kg < nk; kg += NW) {
    const int nv = min(NW, nk - kg);
    const bool pv = pair && pw < nv;
    const float* xg = a.x + (win0 + kg + pw) * W * F + pf;
    const uint8_t* mg = a.mask + (win0 + kg + pw) * W * F + pf;
    float dz[4][NW];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int w = 0; w < NW; ++w) dz[g][w] = 0.0f;
#pragma unroll 8
    for (int q = 0; q < Z; ++q) {
      const float* r = p + o[5] + size_t(q) * G + u;
      const float w0 = u < H ? r[0] : 0.0f, w1q = u < H ? r[H] : 0.0f;
      const float w2 = u < H ? r[2 * H] : 0.0f, w3 = u < H ? r[3 * H] : 0.0f;
      float v[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) v[w] = zl[q * a.KW + kg + w];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        dz[0][w] += v[w] * w0;
        dz[1][w] += v[w] * w1q;
        dz[2][w] += v[w] * w2;
        dz[3][w] += v[w] * w3;
      }
    }
    {
      const float z0[NW] = {};
      store_nw<NW>(hb + u * NW, z0);
    }
    float c[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) c[w] = 0.0f;
    double se = 0.0, n = 0.0;
    float xr = 0.0f;
    bool mr = false;
    __syncwarp();
    clk.mark(2);
    for (int t = 0; t < W; ++t) {
      float hn[NW];
      warp_cell<NW, kFull, true>(dz, hb + (t & 1) * kWarpUnits * NW, wh, whs + u, b, H, c, hn,
                                 w1, F, pw, pf, head);
      if (t > 0 && pv && mr) {  // the head of step t - 1
        const float d = (head + b1f) - xr;
        se += double(d * d);
        n += 1.0;
      }
      if (pv) {
        xr = xg[size_t(t) * F];
        mr = mg[size_t(t) * F];
      }
      store_nw<NW>(hb + ((t + 1) & 1) * kWarpUnits * NW + u * NW, hn);
      __syncwarp();
    }
    if (pv && mr) {  // the head of the last step
      const float* hl = hb + (W & 1) * kWarpUnits * NW;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < H; ++j) acc += hl[j * NW + pw] * w1[j * F + pf];
      const float d = (acc + b1f) - xr;
      se += double(d * d);
      n += 1.0;
    }
    clk.mark(3);
    if (pair) {
      part[lane] = se;
      part[NW * F + lane] = n;
    }
    __syncwarp();
    if (lane < nv) {
      double s = 0.0, m = 0.0;
      for (int f = 0; f < F; ++f) {
        s += part[lane * F + f];
        m += part[NW * F + lane * F + f];
      }
      const float e = float(s) / fmaxf(float(m), 1.0f);
      const size_t oo = win0 + kg + lane;
      a.err[oo] = e;
      if (a.z != nullptr) a.z[oo] = (e - a.mu[job]) / a.sigma[job];
    }
    __syncwarp();
    clk.mark(4);
  }
  if (a.clocks != nullptr && lane == 0) clk.add(a.clocks, job);
}

// ---------------------------------------------------------------------------
// The cluster path: 32 < H <= 256, a cluster of ceil(H / 32) CTAs for a
// chunk of one job's windows
// ---------------------------------------------------------------------------
constexpr int kClusterUnits = 32;     // units a CTA owns
constexpr int kClusterThreads = 128;  // warp g, lane u: gate g of the CTA's unit u
constexpr int kRegRows = 64;          // rows of a column's Wh kept in registers
constexpr int kMaxCluster = 8;

// A CTA's shared memory, in floats: its columns' rows of Wh past kRegRows
// ([j][c], c = g 32 + u), its columns of the encoder's input kernel
// ([q][c]), h of every step of the group (the history, [t][j][w], rows of
// H rounded up to even), the group's inputs ([t][q][w]), the step's gate
// pre-activations ([g][w][u]), the chunk's latents ([q][k]), the head's
// squared errors ([t][w][f], gathered in CTA 0) and its sums by (window,
// feature) pair (float64). At the module's default width (H = 128, Z = 64,
// F = 4, W = 32, two windows) that is 75.4 KB: three CTAs an SM.
struct ClusterLayout {
  int wh, wi, hist, xin, gates, zl, dd, part, floats, hs;
};

__host__ __device__ inline ClusterLayout cluster_layout(int W, int F, int H, int Z, int NW,
                                                        int KW) {
  ClusterLayout l;
  l.hs = ((H + 1) & ~1) * NW;  // floats a step of the history
  int at = 0;
  l.wh = at, at += max(H - kRegRows, 0) * 4 * kClusterUnits;
  l.wi = at, at += 2 * F * 4 * kClusterUnits;
  l.hist = at, at += align4((W + 1) * l.hs);
  l.xin = at, at += align4(W * 2 * F * NW);
  l.gates = at, at += 4 * NW * kClusterUnits;
  l.zl = at, at += align4(Z * KW);
  l.dd = at, at += align4(W * NW * F);
  l.part = at, at += 4 * NW * F;
  l.floats = at;
  return l;
}

__host__ inline long long cluster_smem_bytes(int W, int F, int H, int Z, int NW, int KW) {
  return 4LL * cluster_layout(W, F, H, Z, NW, KW).floats;
}

// a column's rows [0, kRegRows) of a (rows x 4H) matrix into registers and
// rows [kRegRows, H) into shared memory (cp.async; the caller waits)
__device__ __forceinline__ void cluster_weights(const float* m, int H, int col, bool mine,
                                                float (&wr)[kRegRows], float* ws, int c) {
  const int G = 4 * H;
#pragma unroll
  for (int j = 0; j < kRegRows; ++j) wr[j] = (mine && j < H) ? m[size_t(j) * G + col] : 0.0f;
  for (int j = kRegRows; j < H; ++j) {
    float* d = ws + (j - kRegRows) * 4 * kClusterUnits + c;
    if (mine)
      cp_async4(d, m + size_t(j) * G + col);
    else
      *d = 0.0f;
  }
}

// ah over j ascending of the step's h (the history slot ht) times a column
// held as wr (rows below kRegRows) and ws (the rest, this CTA's column c);
// kRegFull: H >= kRegRows (no register row is skipped)
template <int NW, bool kRegFull>
__device__ __forceinline__ void cluster_dot(const float* ht, const float (&wr)[kRegRows],
                                            const float* ws, int c, int H, float (&ah)[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) ah[w] = 0.0f;
#pragma unroll
  for (int j = 0; j < kRegRows; j += 2) {
    if (kRegFull || j < H) {
      float v[2][NW];
      load_rows2<NW>(ht, j, v);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (kRegFull || j + r < H)
#pragma unroll
          for (int w = 0; w < NW; ++w) ah[w] += v[r][w] * wr[j + r];
    }
  }
  int j = kRegRows;
#pragma unroll 4
  for (; j + 1 < H; j += 2) {
    const float w0 = ws[(j - kRegRows) * 4 * kClusterUnits + c];
    const float w1 = ws[(j + 1 - kRegRows) * 4 * kClusterUnits + c];
    float v[2][NW];
    load_rows2<NW>(ht, j, v);
#pragma unroll
    for (int w = 0; w < NW; ++w) ah[w] += v[0][w] * w0;
#pragma unroll
    for (int w = 0; w < NW; ++w) ah[w] += v[1][w] * w1;
  }
  if (j < H) {
    const float wj = ws[(j - kRegRows) * 4 * kClusterUnits + c];
    float v[NW];
    load_nw<NW>(ht + j * NW, v);
#pragma unroll
    for (int w = 0; w < NW; ++w) ah[w] += v[w] * wj;
  }
}

template <int NW, bool kRegFull>
__global__ void __launch_bounds__(kClusterThreads) lstm_ae_cluster_kernel(LstmArgs a, int cl) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const unsigned rank = cluster_ctarank();
  const int cid = blockIdx.x / cl;
  const int job = cid / a.nch, ch = cid - job * a.nch;
  const int k0 = ch * a.KW, nk = min(a.KW, a.K - k0);
  const int F = a.F, H = a.H, Z = a.Z, W = a.W, G = 4 * H, IN = 2 * F, tid = threadIdx.x;
  const int g = tid / kClusterUnits, ul = tid - g * kClusterUnits;
  const int u0 = int(rank) * kClusterUnits, u = u0 + ul;
  const bool mine = u < H;
  const int col = g * H + u;
  const ClusterLayout L = cluster_layout(W, F, H, Z, NW, a.KW);
  float* ws = sm + L.wh;
  float* wi = sm + L.wi;
  float* hist = sm + L.hist;
  float* xin = sm + L.xin;
  float* gates = sm + L.gates;
  float* zl = sm + L.zl;
  float* dd = sm + L.dd;
  double* part = reinterpret_cast<double*>(sm + L.part);
  const int hs = L.hs;
  AeClock clk;
  clk.start();

  const float* p = a.params + size_t(job) * a.P;
  long long o[10];
  lstm_offsets(F, H, Z, o);
  float wr[kRegRows];
  cluster_weights(p + o[1], H, col, mine, wr, ws, tid);
  for (int q = 0; q < IN; ++q) {
    float* d = wi + q * 4 * kClusterUnits + tid;
    if (mine)
      cp_async4(d, p + o[0] + size_t(q) * G + col);
    else
      *d = 0.0f;
  }
  float b = mine ? p[o[2] + col] : 0.0f;
  for (int i = tid; i < hs; i += kClusterThreads) hist[i] = 0.0f;  // h_0 = 0, never written
  cp_async_wait_all();
  __syncthreads();
  clk.mark(0);

  // the thread that updates (window w, unit u) of the CTA's units: tid < 32 NW
  const int aw = tid / kClusterUnits, au = u0 + (tid - aw * kClusterUnits);
  const bool act = tid < kClusterUnits * NW && au < H;
  const size_t win0 = size_t(job) * a.K + k0;

  // the group's inputs as floats, [t][q][w] (x, then the mask)
  auto stage_inputs = [&](int kg, int nv) {
    for (int i = tid; i < W * F * NW; i += kClusterThreads) {
      const int w = i / (W * F), r = i - w * W * F, t = r / F, f = r - t * F;
      const size_t at = ((win0 + kg + w) * W + t) * F + f;
      const bool v = w < nv;
      xin[(t * IN + f) * NW + w] = v ? a.x[at] : 0.0f;
      xin[(t * IN + F + f) * NW + w] = v && a.mask[at] ? 1.0f : 0.0f;
    }
  };
  // a step's gates from the projection px and the history slot t, the
  // cell update of (aw, au), the new h into every CTA's slot t + 1, then
  // the cluster barrier's arrival (the caller waits)
  float c = 0.0f;
  auto step = [&](int t, const float (&px)[NW]) {
    float ah[NW];
    cluster_dot<NW, kRegFull>(hist + t * hs, wr, ws, tid, H, ah);
#pragma unroll
    for (int w = 0; w < NW; ++w) gates[(g * NW + w) * kClusterUnits + ul] = px[w] + (ah[w] + b);
    __syncthreads();
    if (act) {
      const float* gt = gates + aw * kClusterUnits + (tid - aw * kClusterUnits);
      const float ig = sigmoid(gt[0]), fg = sigmoid(gt[NW * kClusterUnits]);
      const float gg = tanhf(gt[2 * NW * kClusterUnits]);
      const float og = sigmoid(gt[3 * NW * kClusterUnits]);
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      float* dst = hist + (t + 1) * hs + au * NW + aw;
      for (int r = 0; r < cl; ++r) *cluster_map(dst, unsigned(r)) = hn;
    }
    cluster_arrive();
  };
  // the encoder's input projection of step t
  auto project = [&](int t, float (&ax)[NW]) {
#pragma unroll
    for (int w = 0; w < NW; ++w) ax[w] = 0.0f;
#pragma unroll 4
    for (int q = 0; q < IN; ++q) {
      const float wq = wi[q * 4 * kClusterUnits + tid];
      float v[NW];
      load_nw<NW>(xin + (t * IN + q) * NW, v);
#pragma unroll
      for (int w = 0; w < NW; ++w) ax[w] += v[w] * wq;
    }
  };

  for (int kg = 0; kg < nk; kg += NW) {
    stage_inputs(kg, min(NW, nk - kg));
    c = 0.0f;
    __syncthreads();
    float ax[NW];
    project(0, ax);
    for (int t = 0; t < W; ++t) {
      step(t, ax);
      if (t + 1 < W) project(t + 1, ax);  // while the cluster's h arrives
      cluster_wait();
    }
    clk.mark(1);
    // the group's latents, spread over the cluster's threads, each into
    // every CTA's zl (each needs them all for its columns)
    const float* he = hist + W * hs;
    for (int i = int(rank) * kClusterThreads + tid; i < Z * NW; i += cl * kClusterThreads) {
      const int q = i / NW, w = i - q * NW;
      float acc = 0.0f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) acc += he[j * NW + w] * p[o[3] + size_t(j) * Z + q];
      const float v = acc + p[o[4] + q];
      for (int r = 0; r < cl; ++r) *cluster_map(zl + q * a.KW + kg + w, unsigned(r)) = v;
    }
    cluster_sync();  // the latents are everywhere; the next group overwrites the history
    clk.mark(2);
  }

  // the decoders, then each group's head over the history it kept
  cluster_weights(p + o[6], H, col, mine, wr, ws, tid);
  b = mine ? p[o[7] + col] : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  clk.mark(0);
  for (int kg = 0; kg < nk; kg += NW) {
    const int nv = min(NW, nk - kg);
    stage_inputs(kg, nv);
    float dz[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) dz[w] = 0.0f;
#pragma unroll 16
    for (int q = 0; q < Z; ++q) {
      const float wq = mine ? p[o[5] + size_t(q) * G + col] : 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) dz[w] += zl[q * a.KW + kg + w] * wq;
    }
    c = 0.0f;
    __syncthreads();
    clk.mark(2);
    for (int t = 0; t < W; ++t) {
      step(t, dz);
      cluster_wait();
    }
    clk.mark(3);
    // the head of every step, spread over the cluster's threads; each
    // squared error into CTA 0's dd
    const int np = W * NW * F;
    for (int i = int(rank) * kClusterThreads + tid; i < np; i += cl * kClusterThreads) {
      const int t = i / (NW * F), r = i - t * NW * F, w = r / F, f = r - w * F;
      if (w >= nv) continue;
      const float* ht = hist + (t + 1) * hs + w;
      float acc = 0.0f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) acc += ht[j * NW] * p[o[8] + size_t(j) * F + f];
      const float d = (acc + p[o[9] + f]) - xin[(t * IN + f) * NW + w];
      *cluster_map(dd + i, 0u) = d * d;
    }
    cluster_sync();
    if (rank == 0) {
      if (tid < nv * F) {  // a (window, feature) pair's sums in step order
        const int w = tid / F, f = tid - w * F;
        double se = 0.0, n = 0.0;
        for (int t = 0; t < W; ++t)
          if (xin[(t * IN + F + f) * NW + w] != 0.0f) {
            se += double(dd[(t * NW + w) * F + f]);
            n += 1.0;
          }
        part[tid] = se;
        part[NW * F + tid] = n;
      }
      __syncthreads();
      if (tid < nv) {
        double s = 0.0, m = 0.0;
        for (int f = 0; f < F; ++f) {
          s += part[tid * F + f];
          m += part[NW * F + tid * F + f];
        }
        const float e = float(s) / fmaxf(float(m), 1.0f);
        const size_t oo = win0 + kg + tid;
        a.err[oo] = e;
        if (a.z != nullptr) a.z[oo] = (e - a.mu[job]) / a.sigma[job];
      }
    }
    cluster_sync();  // dd, part, the inputs and the history are the next group's
    clk.mark(4);
  }
  if (a.clocks != nullptr && tid == 0) clk.add(a.clocks, job);
}

}  // namespace fm

extern "C" long long fm_lstm_ae_param_count(int F, int H, int Z) {
  return fm::lstm_param_count(F, H, Z);
}

extern "C" long long fm_lstm_ae_smem_bytes(int F, int H, int Z, int KB, int smem_params) {
  return fm::lstm_smem_bytes(F, H, Z, KB, smem_params);
}

extern "C" long long fm_lstm_ae_warp_smem_bytes(int F, int H, int Z, int NW, int KW) {
  return fm::warp_smem_bytes(F, H, Z, NW, KW);
}

extern "C" long long fm_lstm_ae_cluster_smem_bytes(int W, int F, int H, int Z, int NW, int KW) {
  return fm::cluster_smem_bytes(W, F, H, Z, NW, KW);
}

extern "C" int fm_lstm_ae_chunk_windows(int J, int K, int NW) {
  return fm::chunk_windows(J, K, NW);
}

// path 0: the wide path (KB windows a CTA, the parameters in shared memory
// when smem_params); 1: the warp path; 2: the cluster path; NW windows a
// group on the last two. A path outside its envelope is refused.
extern "C" int fm_lstm_ae(const float* params, long long P, const float* x, const uint8_t* mask,
                          const float* mu, const float* sigma, int J, int K, int W, int F, int H,
                          int Z, int path, int KB, int smem_params, int NW, float* err, float* z,
                          long long* clocks, void* stream) {
  if (P != fm::lstm_param_count(F, H, Z) || W < 1 || K < 1 || J < 1)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (KB < 1) return int(cudaErrorInvalidValue);
    const int nkb = (K + KB - 1) / KB;
    fm::LstmArgs a{params, P, x, mask, mu, sigma, J, K, W, F, H, Z, KB, nkb, 0, 0, err, z,
                   clocks};
    const size_t smem = size_t(fm::lstm_smem_bytes(F, H, Z, KB, smem_params));
    cudaError_t e = cudaFuncSetAttribute(fm::lstm_ae_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    fm::lstm_ae_kernel<<<J * nkb, fm::kLstmThreads, smem, s>>>(a, smem_params);
    return int(cudaGetLastError());
  }
  if (NW != 2 && NW != 4) return int(cudaErrorInvalidValue);
  const int KW = fm::chunk_windows(J, K, NW), nch = (K + KW - 1) / KW;
  fm::LstmArgs a{params, P, x, mask, mu, sigma, J, K, W, F, H, Z, 0, 0, KW, nch, err, z, clocks};
  if (path == 1) {
    if (H > fm::kWarpUnits || NW * F > 32) return int(cudaErrorInvalidValue);
    const int smem = int(fm::warp_smem_bytes(F, H, Z, NW, KW));
    const long long warps = 1LL * J * nch, per = fm::kWarpThreads / 32;
    const int grid = int((warps + per - 1) / per);
    auto kernel = NW == 4 ? (H == fm::kWarpUnits ? fm::lstm_ae_warp_kernel<4, true>
                                                 : fm::lstm_ae_warp_kernel<4, false>)
                          : (H == fm::kWarpUnits ? fm::lstm_ae_warp_kernel<2, true>
                                                 : fm::lstm_ae_warp_kernel<2, false>);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<grid, fm::kWarpThreads, smem, s>>>(a);
    return int(cudaGetLastError());
  }
  if (path == 2) {
    const int cl = (H + fm::kClusterUnits - 1) / fm::kClusterUnits;
    if (H <= fm::kWarpUnits || cl > fm::kMaxCluster) return int(cudaErrorInvalidValue);
    const int smem = int(fm::cluster_smem_bytes(W, F, H, Z, NW, KW));
    const bool full = H >= fm::kRegRows;
    auto kernel = NW == 4 ? (full ? fm::lstm_ae_cluster_kernel<4, true>
                                  : fm::lstm_ae_cluster_kernel<4, false>)
                          : (full ? fm::lstm_ae_cluster_kernel<2, true>
                                  : fm::lstm_ae_cluster_kernel<2, false>);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    const long long grid = 1LL * J * nch * cl;
    if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const cudaError_t l =
        fm::launch_cluster(kernel, int(grid), fm::kClusterThreads, size_t(smem), s, cl, a, cl);
    if (l != cudaSuccess) return int(l);
    return int(cudaGetLastError());
  }
  return int(cudaErrorInvalidValue);
}
