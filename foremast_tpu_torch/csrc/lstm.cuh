// The LSTM autoencoder's pieces shared by kernel K (lstm_ae.cu, scoring)
// and kernel L (lstm_train.cu, training): the flat parameter layout and one
// recurrent step of flax's LSTMCell for a block of windows in lock step
// (lstm_step), or for a register tile of a unit's gates over a few windows
// (lstm_tile_step, kernel L's forward; the same bits).
// Built with -fmad=false, expf / tanhf (never the fast intrinsics), so a
// step rounds the same in both kernels and in a recomputation.
#pragma once

#include "common.cuh"

namespace fm {

// Parameters: one row of P floats per job in the port's flat layout
// (models/lstm_ae.py:flat_params): encoder Wi (2F, 4H), Wh (H, 4H), b (4H),
// gates in the order i, f, g, o along the columns; Dense_0 W (H, Z), b (Z);
// decoder Wi (Z, 4H), Wh (H, 4H), b (4H); Dense_1 W (H, F), b (F).
struct LstmLayout {
  const float *wi_e, *wh_e, *b_e, *w0, *b0, *wi_d, *wh_d, *b_d, *w1, *b1;
};

__host__ __device__ inline long long lstm_param_count(int F, int H, int Z) {
  const long long G = 4LL * H;
  return 2LL * F * G + H * G + G + 1LL * H * Z + Z + 1LL * Z * G + H * G + G + 1LL * H * F + F;
}

// Offsets of the ten tensors in a row (the same order as LstmLayout).
__host__ __device__ inline void lstm_offsets(int F, int H, int Z, long long* off) {
  const long long G = 4LL * H;
  const long long n[10] = {2LL * F * G, 1LL * H * G, G, 1LL * H * Z, Z, 1LL * Z * G, 1LL * H * G, G,
                           1LL * H * F, F};
  long long at = 0;
  for (int i = 0; i < 10; ++i) {
    off[i] = at;
    at += n[i];
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ LstmLayout lstm_layout(const float* p, int F, int H, int Z) {
  long long o[10];
  lstm_offsets(F, H, Z, o);
  return LstmLayout{p + o[0], p + o[1], p + o[2], p + o[3], p + o[4],
                    p + o[5], p + o[6], p + o[7], p + o[8], p + o[9]};
}

// One LSTM step for nk windows: gates from the input projection (inp wi,
// or the decoder's precomputed dz when that is given) and h, then the state
// update. With act given, window k's gate activations i, f, g, o and its
// new c (5H floats) go to act + k * act_stride.
__device__ __forceinline__ void lstm_step(const float* inp, int in_dim, const float* wi,
                                          const float* dz, const float* wh, const float* b,
                                          float* h, float* c, float* gates, int nk, int H,
                                          float* act = nullptr, size_t act_stride = 0) {
  const int G = 4 * H;
  for (int i = threadIdx.x; i < nk * G; i += blockDim.x) {
    const int k = i / G, col = i - k * G;
    float ax;
    if (dz != nullptr) {
      ax = dz[i];
    } else {
      ax = 0.0f;
      const float* in = inp + k * in_dim;
      for (int q = 0; q < in_dim; ++q) ax += in[q] * wi[q * G + col];
    }
    float ah = 0.0f;
    const float* hk = h + k * H;
    for (int j = 0; j < H; ++j) ah += hk[j] * wh[j * G + col];
    gates[i] = ax + (ah + b[col]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    const float* g = gates + k * G;
    const float ig = sigmoid(g[j]), fg = sigmoid(g[H + j]);
    const float gg = tanhf(g[2 * H + j]), og = sigmoid(g[3 * H + j]);
    const float cn = fg * c[i] + ig * gg;
    c[i] = cn;
    h[i] = og * tanhf(cn);
    if (act != nullptr) {
      float* a = act + k * act_stride;
      a[j] = ig;
      a[H + j] = fg;
      a[2 * H + j] = gg;
      a[3 * H + j] = og;
      a[4 * H + j] = cn;
    }
  }
  __syncthreads();
}

// One LSTM step of a register tile: the calling thread owns hidden unit u
// and its four gate columns (i, f, g, o) for NW windows. The input
// projection is inp (in_dim rows of ld floats, a window a column) times wi,
// or the decoder's precomputed one (dz, with kDz); the recurrence is h (H
// rows of ld floats) times wh. The weights are unit-major float4s (wi[q H +
// u], wh[j H + u] = the four gates' entries), each read once a step for all
// NW windows; inp and h are read as broadcasts, four windows a float4. The
// sums keep lstm_step's order (the input terms from 0, then j ascending from
// 0, multiply then add; gate = ax + (ah + b)), so the tile's gates, c and h
// are lstm_step's bit for bit. c is updated in place; act receives i, f, g,
// o and c, and hn the new h.
template <int NW, bool kDz>
__device__ __forceinline__ void lstm_tile_step(const float* inp, int in_dim, const float4* wi,
                                               const float (&dz)[4][NW], const float* h, int ld,
                                               const float4* wh, float4 b, int H, int u,
                                               float (&c)[NW], float (&act)[5][NW],
                                               float (&hn)[NW]) {
  static_assert(NW % 4 == 0, "windows come in float4s");
  float ax[4][NW], ah[4][NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      ax[g][w] = kDz ? dz[g][w] : 0.0f;
      ah[g][w] = 0.0f;
    }
  if (!kDz) {
    for (int q = 0; q < in_dim; ++q) {
      const float4 wq = wi[q * H + u];
      float v[NW];
#pragma unroll
      for (int w = 0; w < NW; w += 4) {
        const float4 t = *reinterpret_cast<const float4*>(inp + q * ld + w);
        v[w] = t.x;
        v[w + 1] = t.y;
        v[w + 2] = t.z;
        v[w + 3] = t.w;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        ax[0][w] += v[w] * wq.x;
        ax[1][w] += v[w] * wq.y;
        ax[2][w] += v[w] * wq.z;
        ax[3][w] += v[w] * wq.w;
      }
    }
  }
  for (int j = 0; j < H; ++j) {
    const float4 wj = wh[j * H + u];
    float v[NW];
#pragma unroll
    for (int w = 0; w < NW; w += 4) {
      const float4 t = *reinterpret_cast<const float4*>(h + j * ld + w);
      v[w] = t.x;
      v[w + 1] = t.y;
      v[w + 2] = t.z;
      v[w + 3] = t.w;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      ah[0][w] += v[w] * wj.x;
      ah[1][w] += v[w] * wj.y;
      ah[2][w] += v[w] * wj.z;
      ah[3][w] += v[w] * wj.w;
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
    act[0][w] = ig;
    act[1][w] = fg;
    act[2][w] = gg;
    act[3][w] = og;
    act[4][w] = cn;
  }
}

}  // namespace fm
