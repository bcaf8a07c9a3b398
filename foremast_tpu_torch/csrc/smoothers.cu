// Kernels C and D: the sequential smoothers and the Holt-Winters grid fit.
//
// Kernel C, `smooth`, replaces the reference's vmapped lax.scan programs
// ops/forecast.py _ses_1d (:156), _des_1d (:169) and _hw_1d (:186), jitted as
// ses_predictions, des_predictions and holt_winters_predictions (:213-216).
// Kernel D, `hw_fit`, replaces fit_holt_winters (:358) over _default_grid
// (:349): the masked mean squared one-step error of every (alpha, beta,
// gamma) candidate and the argmin (the first minimum wins, NaN first, as
// jnp.argmin). Its refit of the winner is a launch of kernel C with the
// chosen parameters per row. Both run the one step function below, so the
// fit and the predictions cannot drift apart.
//
// Semantics are the reference's: pred_t is the state before step t, a
// masked step carries the state forward (level + trend for DES and HW), the
// level starts at the first valid value (SES, DES) or at the masked mean of
// the first period (HW), and HW's season starts at x - l0 where the mask is
// set. The period is per row (the reference's static period, and the
// engine's partition by period, become a (B,) input); a period above T
// acts as T and one below 1 as 1.
//
// What bounds them on an H100, and the design's answer:
// - C walks each row sequentially, one lane per row: a chain of ~10
//   dependent float32 operations per step. With 32 rows per warp and some
//   3,000 warps at B = 100k the card hides that chain, and the kernel is
//   bound by bytes: 9 B per slot (value, mask, prediction). One lane per row
//   reading along T would not coalesce, so each warp stages a tile of
//   32 rows x 32 steps through shared memory (cp.async for the values, a
//   ballot per row for the mask) and writes its predictions back the same
//   way, transposed.
// - HW's season ring is `period` floats per row (5.76 KB at 1440). It
//   lives in device scratch (smooth_hw_kernel: 24 warps an SM, every group
//   in flight, the ring's tile of slots read with x and the mask and written
//   back where the tile set one: up to ~6 B a slot more than the 9 B). The
//   32 rings of a group in a CTA's shared memory (184 KB at 1440) leave one
//   walking warp an SM, whose chain of dependent steps then sets the pace:
//   that design measured 26 ms against 11.4 at 100k x 16384, period 1440.
// - D runs 60 candidates per row: 60 x B x T steps, ~14 operations each,
//   which bounds it by operations (~40 ms at B = 100k, T = 16384). One warp
//   takes one row, two candidates per lane, and shares the row's value and
//   mask through shuffles. The 60 rings of a row (346 KB at period 1440)
//   cannot live in shared memory, so they too live in device scratch,
//   (period, G rounded up to even) floats per warp: each step reads and
//   writes one slot of each, 480 B a step at G = 60. Fewer warps in flight
//   (rings nearer to L2) measured slower on an H100: the card needs its
//   warps more than L2 hits, so the ring traffic sets D's time, and the
//   design cuts it and hides its latency:
//   - a row's walk stops after its last (mask & fit) slot, found by a
//     ballot scan from the row's end (no later step enters an error, and
//     the float64 sums keep their order: the outputs are the full walk's);
//   - for period >= 2 kTile the ring reads of the next tile are in flight
//     (cp.async into a second buffer) while a tile is walked, and x, mask
//     and fit come a tile ahead through registers;
//   - a slot is written back only when its value changed (a set mask, or
//     the first visit's s0): a masked step carries s;
//   - the launcher bounds the warps by the scratch budget, the C entry by
//     what the card holds at once, and each warp walks rows grid-stride.
// - D sums each candidate's squared error in float64 (the reference sums in
//   float32), so a close race between two candidates is decided by the
//   exact error rather than by rounding.
//
// Built with -fmad=false: every float32 expression rounds as the plain
// twin's PyTorch operations do.
#include "common.cuh"

namespace fm {

enum : int { kSES = 1, kDES = 2, kHW = 3 };

constexpr int kTile = 32;        // steps per staged tile
constexpr int kSmoothWarps = 4;  // warps per CTA (kernel C)
constexpr int kFitWarps = 2;     // warps per CTA (kernel D): two tiles each, 32 KB
constexpr int kFitLanes = 64;    // candidate slots per row in kernel D

// One step of the reference's recurrences on (l, b, s). Returns pred_t, the
// forecast before observing x_t; oma = 1 - alpha and so on, precomputed in
// float32 as the reference does.
template <int KIND>
__device__ __forceinline__ float smooth_step(float xt, bool mt, float al, float oma, float be,
                                             float omb, float ga, float omg, float& l, float& b,
                                             float& s) {
  if constexpr (KIND == kSES) {
    const float pred = l;
    l = mt ? al * xt + oma * l : l;
    return pred;
  }
  const float lb = l + b;
  if constexpr (KIND == kDES) {
    const float ln = mt ? al * xt + oma * lb : lb;
    b = mt ? be * (ln - l) + omb * b : b;
    l = ln;
    return lb;
  }
  const float st = s;
  const float pred = lb + st;
  const float ln = mt ? al * (xt - st) + oma * lb : lb;
  b = mt ? be * (ln - l) + omb * b : b;
  s = mt ? ga * (xt - ln) + omg * st : st;
  l = ln;
  return pred;
}

__device__ __forceinline__ int clamp_period(int p, int T) { return min(max(p, 1), T); }

// The masked mean of x[0, P) of one row, by one warp: HW's initial level.
// Summed in float64 and rounded once, so that it does not depend on the
// order of the sum: a Holt-Winters row whose (alpha, beta, gamma) lie
// outside the stable region amplifies a one-ulp difference in l0 without
// bound, and the twin sums in another order.
__device__ __forceinline__ float hw_level0(const float* x, const uint8_t* mask, int P) {
  double s = 0.0;
  int c = 0;
  for (int k = threadIdx.x & 31; k < P; k += 32) {
    if (mask[k]) {
      s += double(x[k]);
      c += 1;
    }
  }
  s = warp_sum(s);
  c = warp_sum(c);
  return float(s / double(c > 0 ? c : 1));
}

// ---------------------------------------------------------------------------
// Kernel C
// ---------------------------------------------------------------------------
struct SmoothArgs {
  const float* x;
  const uint8_t* mask;
  const float* alpha;
  const float* beta;    // DES
  int B;
  int T;
  float* preds;
};

// SES and DES; Holt-Winters runs smooth_hw_kernel (below)
template <int KIND>
__global__ void __launch_bounds__(kSmoothWarps * 32) smooth_kernel(SmoothArgs a) {
  static_assert(KIND == kSES || KIND == kDES, "smooth_kernel runs SES and DES");
  __shared__ float xs[kSmoothWarps][32][kTile + 1];  // values, then predictions
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int T = a.T;
  const int warp_id = blockIdx.x * kSmoothWarps + w;
  const int n_warps = gridDim.x * kSmoothWarps;
  const int n_groups = (a.B + 31) / 32;

  for (int g = warp_id; g < n_groups; g += n_warps) {
    const int row0 = g * 32;
    const int row = row0 + lane;
    const bool live = row < a.B;
    float al = 0.0f, be = 0.0f;
    if (live) {
      al = a.alpha[row];
      if constexpr (KIND != kSES) be = a.beta[row];
    }
    const float oma = 1.0f - al, omb = 1.0f - be;

    // initial state: the first valid value (rows in turn, the whole warp on
    // each)
    float l = 0.0f, b = 0.0f, s = 0.0f;
    for (int r = 0; r < 32 && row0 + r < a.B; ++r) {
      const size_t off = size_t(row0 + r) * T;
      for (int t0 = 0; t0 < T; t0 += 32) {
        const bool m = t0 + lane < T && a.mask[off + t0 + lane];
        const unsigned bits = __ballot_sync(kFullWarp, m);
        if (bits != 0u) {
          const float v = a.x[off + t0 + __ffs(bits) - 1];
          if (lane == r) l = v;
          break;
        }
      }
    }

    for (int t0 = 0; t0 < T; t0 += kTile) {
      const int L = min(kTile, T - t0);
      // stage: row r's L values by lanes 0..L-1, its mask as one ballot
      unsigned mbits = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const bool in = row0 + r < a.B && lane < L;
        const size_t at = size_t(row0 + r) * T + t0 + lane;
        if (in) cp_async4(&xs[w][r][lane], a.x + at);
        const unsigned bits = __ballot_sync(kFullWarp, in && a.mask[at]);
        if (lane == r) mbits = bits;
      }
      cp_async_wait_all();
      __syncwarp();
      // walk: lane = row, sequential over the tile's steps
      if (live) {
        for (int j = 0; j < L; ++j) {
          const float xt = xs[w][lane][j];
          const bool mt = (mbits >> j) & 1u;
          xs[w][lane][j] = smooth_step<KIND>(xt, mt, al, oma, be, omb, 0.0f, 1.0f, l, b, s);
        }
      }
      __syncwarp();
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        if (row0 + r < a.B && lane < L) a.preds[size_t(row0 + r) * T + t0 + lane] = xs[w][r][lane];
      }
      __syncwarp();
    }
  }
}

// kernels.SMOOTH_HW_PHASES, a group of 32 rows' warp's cycles: the initial
// levels, issuing the copies of x and the mask, issuing the season slots'
// copies and waiting for all of them (and the mask as bits), the walk, the
// stores of the predictions and of the ring
constexpr int kSmoothHwPhases = 5;

struct HwArgs {
  const float* x;
  const uint8_t* mask;
  const float* alpha;
  const float* beta;
  const float* gamma;
  const int* period;
  int B;
  int T;
  int stride;         // the launch's largest period (clamped to T): the rings' length
  bool vec;           // rows 16-byte aligned (T a multiple of 16): 16-byte mask copies
  float* ring;        // the rings: (warps in flight, 32, stride)
  float* preds;
  long long* clocks;  // null, or (groups, kSmoothHwPhases) SM cycles of the walking warp
};

// ---------------------------------------------------------------------------
// Kernel C, Holt-Winters: the season rings in device scratch
// ---------------------------------------------------------------------------
// A warp walks groups of 32 rows grid-stride (a lane a row); each row's
// season ring, `stride` floats, lives in device scratch that the launcher
// allocates for the warps in flight. Four warps a CTA at 37 KB of shared
// memory and few registers: six CTAs, 24 warps an SM, so every group of
// the engine's 100k rows is in flight at once and the card's memory
// parallelism comes from its warps. A tile of 32 steps is one round trip:
// x, the mask (16 B a copy where the rows allow it) and the tile's season
// slots are all issued before one wait (a slot's first visit, t < P, takes
// s0 in the walk, so nothing waits for x first). A slot is written back only
// for a row whose tile set one (a set mask or a first visit): its tile's
// 32 slots, as they stand (periods below kTile, where a slot repeats within
// a tile: the last min(P, L) steps', which hold each slot's newest value).
// A tile masked on every row advances l += b. (The first design staged the
// mask one row a ballot, each waiting for its global load, and the slots
// after x: 65% and 14% of a warp's cycles at 100k x 16384.)
constexpr int kDevWarps = 4;  // warps a CTA
struct HwDevTiles {           // a warp's tile
  float xs[32][kTile + 1];    // x, then the predictions
  uint8_t ms[32][kTile];      // the mask
  float rs[32][kTile + 1];    // the tile's season slots, then their new values
};

// Copies of the season slots of tile t0 of group g (steps t >= P of each
// row, each its own kr: the slot of the tile's first step) into rs.
__device__ __forceinline__ void hw_stage_ring(const HwArgs& a, int g, int t0, int kr, int P,
                                              const float* ring, float (*rs)[kTile + 1]) {
  const int lane = threadIdx.x & 31;
  const int L = min(kTile, a.T - t0);
  for (int r = 0; r < 32; ++r) {
    const int Pr = __shfl_sync(kFullWarp, P, r);
    const int kr_r = __shfl_sync(kFullWarp, kr, r);
    if (g * 32 + r < a.B && lane < min(Pr, L) && t0 + lane >= Pr) {
      int k = kr_r + lane;
      if (k >= Pr) k = Pr >= kTile ? k - Pr : k % Pr;
      cp_async4(&rs[r][lane], ring + size_t(r) * a.stride + k);
    }
  }
}

__global__ void __launch_bounds__(kDevWarps * 32, 6) smooth_hw_kernel(HwArgs a) {
  __shared__ HwDevTiles tiles[kDevWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  HwDevTiles& tl = tiles[w];
  const int T = a.T, n_groups = (a.B + 31) / 32;
  const int warp_id = blockIdx.x * kDevWarps + w, n_warps = gridDim.x * kDevWarps;
  float* ring = a.ring + size_t(warp_id) * 32 * a.stride;
  for (int g = warp_id; g < n_groups; g += n_warps) {
    const int row0 = g * 32, row = row0 + lane;
    const bool live = row < a.B;
    long long cyc[kSmoothHwPhases] = {0, 0, 0, 0, 0};
    long long c_prev = clock64();
    const bool timed = a.clocks != nullptr;
    auto lap = [&](int k) {
      if (timed) {
        const long long c = clock64();
        cyc[k] += c - c_prev;
        c_prev = c;
      }
    };
    float al = 0.0f, be = 0.0f, ga = 0.0f;
    int P = 1;  // a lane past the rows walks, and writes nothing out
    if (live) {
      al = a.alpha[row];
      be = a.beta[row];
      ga = a.gamma[row];
      P = clamp_period(a.period[row], T);
    }
    const float oma = 1.0f - al, omb = 1.0f - be, omg = 1.0f - ga;
    // the initial levels, rows in turn, the whole warp on each
    float l0 = 0.0f;
    for (int r = 0; r < 32 && row0 + r < a.B; ++r) {
      const size_t off = size_t(row0 + r) * T;
      const float v = hw_level0(a.x + off, a.mask + off, __shfl_sync(kFullWarp, P, r));
      if (lane == r) l0 = v;
    }
    lap(0);
    float l = l0, b = 0.0f;
    int kr = 0;  // the ring slot of the tile's first step: t0 mod P
    for (int t0 = 0; t0 < T; t0 += kTile) {
      const int L = min(kTile, T - t0);
      // x and the mask of the tile
      for (int r = 0; r < 32; ++r) {
        if (row0 + r < a.B && lane < L) {
          cp_async4(&tl.xs[r][lane], a.x + size_t(row0 + r) * T + t0 + lane);
        }
      }
      if (a.vec) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane + 32 * i, r = c >> 1, h = c & 1;
          if (row0 + r < a.B && 16 * h < L) {
            cp_async16(&tl.ms[r][16 * h], a.mask + size_t(row0 + r) * T + t0 + 16 * h);
          }
        }
      } else {
        for (int r = 0; r < 32; ++r) {
          if (row0 + r < a.B && lane < L) {
            tl.ms[r][lane] = a.mask[size_t(row0 + r) * T + t0 + lane];
          }
        }
      }
      lap(1);
      hw_stage_ring(a, g, t0, kr, P, ring, tl.rs);
      cp_async_wait_all();
      __syncwarp();
      unsigned mbits = 0u;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        const unsigned bits =
            __ballot_sync(kFullWarp, row0 + r < a.B && lane < L && tl.ms[r][lane]);
        if (lane == r) mbits = bits;
      }
      const bool masked = !__any_sync(kFullWarp, mbits != 0u);
      lap(2);
      // walk: lane = row; a slot's first visit takes s0 = x - l0 where the
      // mask is set, a later one its ring slot (within the tile for P < j)
      bool changed = false;
      float* xr = tl.xs[lane];
      float* rr = tl.rs[lane];
      if (masked) {
        for (int j = 0; j < L; ++j) {
          const bool fresh = t0 + j < P;
          const float st = fresh ? 0.0f : (j >= P ? rr[j - P] : rr[j]);
          const float lb = l + b;
          xr[j] = lb + st;
          l = lb;
          rr[j] = st;
          changed |= fresh;
        }
      } else {
        for (int j = 0; j < L; ++j) {
          const float xt = xr[j];
          const bool mt = (mbits >> j) & 1u;
          const bool fresh = t0 + j < P;
          float s = fresh ? (mt ? xt - l0 : 0.0f) : (j >= P ? rr[j - P] : rr[j]);
          xr[j] = smooth_step<kHW>(xt, mt, al, oma, be, omb, ga, omg, l, b, s);
          rr[j] = s;
          changed |= mt || fresh;
        }
      }
      __syncwarp();
      lap(3);
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        if (row0 + r < a.B && lane < L) a.preds[size_t(row0 + r) * T + t0 + lane] = tl.xs[r][lane];
      }
      // write back the tiles of the rows that set a slot (periods below
      // kTile: the last min(P, L) steps, each slot's newest value)
      const unsigned wrote = __ballot_sync(kFullWarp, live && changed);
      for (int r = 0; r < 32; ++r) {
        const int Pr = __shfl_sync(kFullWarp, P, r);
        const int kr_r = __shfl_sync(kFullWarp, kr, r);
        if (((wrote >> r) & 1u) && lane < L && (Pr >= kTile || lane >= L - min(Pr, L))) {
          int k = kr_r + lane;
          if (k >= Pr) k = Pr >= kTile ? k - Pr : k % Pr;
          ring[size_t(r) * a.stride + k] = tl.rs[r][lane];
        }
      }
      __syncwarp();
      kr = (kr + L) % P;
      lap(4);
    }
    if (timed && lane == 0) {
      for (int k = 0; k < kSmoothHwPhases; ++k) a.clocks[size_t(g) * kSmoothHwPhases + k] = cyc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel D
// ---------------------------------------------------------------------------
struct HwFitArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* fit;
  const int* period;
  const float* grid;  // (G, 3): alpha, beta, gamma
  int G;
  int B;
  int T;
  bool vec;           // mask and fit rows 16-byte aligned: fit_end reads them 16 B a lane
  float* ring;        // (warps in flight, ring_stride, ring_row)
  int ring_stride;
  int ring_row;       // floats a ring slot: G rounded up to even
  float* params;      // (B, 3)
  int* best;          // (B,)
  double* mse;        // (B, G)
  long long* clocks;  // null, or (B, kFitPhases) SM cycles a row's warp spent per phase
};

// kernels.HW_FIT_PHASES: the initial level and the row's end, staging (the
// ring reads issued and waited for, the x and mask loads), the walk, the
// ring's write-back
constexpr int kFitPhases = 4;

// argmin order: NaN before any number (jnp.argmin returns the first NaN),
// then the smaller value, then the smaller index
__device__ __forceinline__ bool fit_better(double av, int ai, double bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an != bn) return an;
  if (!an && av != bv) return av < bv;
  return ai < bi;
}

// 1 + the row's last slot with mask & fit, 0 if none: a warp reads from the
// end, 16 slots a lane (four 512-slot blocks in flight) when the rows are
// 16-byte aligned, else 32 a ballot. No step from there on enters an error.
__device__ int fit_end(const uint8_t* mask, const uint8_t* fit, int T, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    const uint4* f4 = reinterpret_cast<const uint4*>(fit);
    const int nv = T / 16;
    for (int v0 = ((nv - 1) / 32) * 32; v0 >= 0; v0 -= 4 * 32) {
      uint4 m[4], f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 - 32 * u + lane;
        const bool in = v >= 0 && v < nv;
        m[u] = in ? m4[v] : make_uint4(0u, 0u, 0u, 0u);
        f[u] = in ? f4[v] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t w[4] = {m[u].x & f[u].x, m[u].y & f[u].y, m[u].z & f[u].z,
                               m[u].w & f[u].w};
        int last = -1;  // the lane's last slot with both bytes set, of its 16
        for (int k = 3; k >= 0 && last < 0; --k) {
          if (w[k]) last = 4 * k + (31 - __clz(w[k])) / 8;
        }
        const unsigned any = __ballot_sync(kFullWarp, last >= 0);
        if (any) {
          const int src = 31 - __clz(any);
          return 16 * (v0 - 32 * u + src) + __shfl_sync(kFullWarp, last, src) + 1;
        }
      }
    }
    return 0;
  }
  for (int t0 = ((T - 1) / 32) * 32; t0 >= 0; t0 -= 32) {
    const int t = t0 + lane;
    const unsigned bits = __ballot_sync(kFullWarp, t < T && mask[t] && fit[t]);
    if (bits) return t0 + 32 - __clz(bits);
  }
  return 0;
}

__global__ void __launch_bounds__(kFitWarps * 32) hw_fit_kernel(HwFitArgs a) {
  // season tiles: the one walked and, for P >= 2 kTile, the next one's
  // ring reads in flight
  __shared__ __align__(16) float rs[kFitWarps][2][kTile][kFitLanes];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int T = a.T, G = a.G, R = a.ring_row;
  const int warp_id = blockIdx.x * kFitWarps + w;
  const int n_warps = gridDim.x * kFitWarps;
  float* ring = a.ring + size_t(warp_id) * a.ring_stride * R;
  // lane holds candidates c0 = 2 lane and c0 + 1; lanes past the grid
  // repeat its last candidate and keep no ring
  const int c0 = 2 * lane;
  const bool ring_lane = c0 < R;
  float al[2], be[2], ga[2], oma[2], omb[2], omg[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = min(c0 + q, G - 1);
    al[q] = a.grid[3 * c];
    be[q] = a.grid[3 * c + 1];
    ga[q] = a.grid[3 * c + 2];
    oma[q] = 1.0f - al[q];
    omb[q] = 1.0f - be[q];
    omg[q] = 1.0f - ga[q];
  }

  for (int row = warp_id; row < a.B; row += n_warps) {
    const size_t off = size_t(row) * T;
    const float* x = a.x + off;
    const uint8_t* mask = a.mask + off;
    const uint8_t* fit = a.fit + off;
    long long cyc[kFitPhases] = {0, 0, 0, 0};
    long long c_prev = clock64();
    const bool timed = a.clocks != nullptr;
    auto lap = [&](int k) {
      if (timed) {
        const long long c = clock64();
        cyc[k] += c - c_prev;
        c_prev = c;
      }
    };
    const int P = clamp_period(a.period[row], T);
    // the walk stops after the last fitted step: the errors, and so mse,
    // best and params, are the full walk's to the bit
    const int t_end = fit_end(mask, fit, T, a.vec);
    const float l0 = hw_level0(x, mask, P);
    float l[2] = {l0, l0}, b[2] = {0.0f, 0.0f};
    double sse[2] = {0.0, 0.0};
    int n_fit = 0;
    lap(0);

    if (P >= 2 * kTile) {
      // Each step reads its season slot once (slots t mod P, j < kTile apart
      // within a tile, all written before the tile began), so the reads of
      // tile t0 + kTile are issued while tile t0 is walked; a first visit
      // (t < P) takes s0 = x - l0 where the mask is set. x, mask and fit come
      // one tile ahead through registers.
      float xn = lane < t_end ? x[lane] : 0.0f;
      bool mn = lane < t_end && mask[lane], fn = lane < t_end && fit[lane];
      int buf = 0;
      for (int t0 = 0; t0 < t_end; t0 += kTile, buf ^= 1) {
        const int L = min(kTile, t_end - t0);
        const float xv = xn;
        const unsigned mbits = __ballot_sync(kFullWarp, mn);
        const unsigned fbits = __ballot_sync(kFullWarp, fn);
        n_fit += __popc(mbits & fbits);
        const int t1 = t0 + kTile;
        const bool next = t1 + lane < t_end;
        xn = next ? x[t1 + lane] : 0.0f;
        mn = next && mask[t1 + lane];
        fn = next && fit[t1 + lane];
        if (ring_lane) {
          const int L1 = min(kTile, t_end - t1);
          int k = t1 % P;
          for (int j = 0; j < L1; ++j, k = k + 1 == P ? 0 : k + 1) {
            if (t1 + j >= P) cp_async8(&rs[w][buf ^ 1][j][c0], ring + size_t(k) * R + c0);
          }
        }
        cp_async_commit();
        cp_async_wait_group<1>();  // this tile's reads, issued a tile ago
        __syncwarp();
        lap(1);
        for (int j = 0; j < L; ++j) {
          const float xt = __shfl_sync(kFullWarp, xv, j);
          const bool mt = (mbits >> j) & 1u;
          const bool ft = (fbits >> j) & 1u;
          const bool fresh = t0 + j < P;
          const float s0 = mt ? xt - l0 : 0.0f;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float s = fresh ? s0 : rs[w][buf][j][c0 + q];
            const float pred = smooth_step<kHW>(xt, mt, al[q], oma[q], be[q], omb[q], ga[q],
                                                omg[q], l[q], b[q], s);
            rs[w][buf][j][c0 + q] = s;
            if (mt && ft) {
              const double r = double(xt - pred);
              sse[q] += r * r;
            }
          }
        }
        __syncwarp();
        lap(2);
        // write back the slots whose value changed: a masked step carries
        // s, so only a set mask or a first visit (s0) writes
        if (ring_lane) {
          int k = t0 % P;
          for (int j = 0; j < L; ++j, k = k + 1 == P ? 0 : k + 1) {
            if (((mbits >> j) & 1u) || t0 + j < P) {
              *reinterpret_cast<float2*>(ring + size_t(k) * R + c0) =
                  *reinterpret_cast<const float2*>(&rs[w][buf][j][c0]);
            }
          }
        }
        __syncwarp();
        lap(3);
      }
      cp_async_wait_all();
    } else {
      // P < 2 kTile: a tile may read slots the tile before it wrote (and,
      // for P < kTile, its own), so it stages its slots after the last
      // write-back and walks them from one buffer
      for (int t0 = 0; t0 < t_end; t0 += kTile) {
        const int L = min(kTile, t_end - t0);
        const bool in = lane < L;
        const float xv = in ? x[t0 + lane] : 0.0f;
        const unsigned mbits = __ballot_sync(kFullWarp, in && mask[t0 + lane]);
        const unsigned fbits = __ballot_sync(kFullWarp, in && fit[t0 + lane]);
        n_fit += __popc(mbits & fbits);
        const int need = min(P, L);
        const int base = t0 % P;
        for (int j = 0; j < need; ++j) {
          const float xj = __shfl_sync(kFullWarp, xv, j);
          if (t0 + j < P) {
            const float s0 = ((mbits >> j) & 1u) ? xj - l0 : 0.0f;
            rs[w][0][j][c0] = s0;
            rs[w][0][j][c0 + 1] = s0;
          } else if (ring_lane) {
            int k = base + j;
            if (k >= P) k -= P;
            cp_async8(&rs[w][0][j][c0], ring + size_t(k) * R + c0);
          }
        }
        cp_async_wait_all();
        __syncwarp();
        lap(1);
        for (int j = 0; j < L; ++j) {
          const float xt = __shfl_sync(kFullWarp, xv, j);
          const bool mt = (mbits >> j) & 1u;
          const bool ft = (fbits >> j) & 1u;
          const int js = j >= P ? j - P : j;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float s = rs[w][0][js][c0 + q];
            const float pred = smooth_step<kHW>(xt, mt, al[q], oma[q], be[q], omb[q], ga[q],
                                                omg[q], l[q], b[q], s);
            rs[w][0][j][c0 + q] = s;
            if (mt && ft) {
              const double r = double(xt - pred);
              sse[q] += r * r;
            }
          }
        }
        __syncwarp();
        lap(2);
        if (ring_lane) {
          for (int j = L - need; j < L; ++j) {
            int k = base + j;
            k = k >= P ? (P >= kTile ? k - P : k % P) : k;
            *reinterpret_cast<float2*>(ring + size_t(k) * R + c0) =
                *reinterpret_cast<const float2*>(&rs[w][0][j][c0]);
          }
        }
        __syncwarp();
        lap(3);
      }
    }

    // mean squared error per candidate, then the warp's argmin
    const double n = double(max(n_fit, 1));
    double bv = 0.0;
    int bi = G;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + q;
      if (c < G) {
        const double v = sse[q] / n;
        a.mse[size_t(row) * G + c] = v;
        if (bi == G || fit_better(v, c, bv, bi)) {
          bv = v;
          bi = c;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(kFullWarp, bv, o);
      const int oi = __shfl_xor_sync(kFullWarp, bi, o);
      if (oi < G && (bi == G || fit_better(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      a.best[row] = bi;
      for (int k = 0; k < 3; ++k) a.params[size_t(row) * 3 + k] = a.grid[3 * bi + k];
      if (timed) {
        for (int k = 0; k < kFitPhases; ++k) a.clocks[size_t(row) * kFitPhases + k] = cyc[k];
      }
    }
  }
}

}  // namespace fm

extern "C" int fm_smooth(int kind, const float* x, const uint8_t* mask, const float* alpha,
                         const float* beta, int B, int T, int n_warps, float* preds,
                         void* stream) {
  fm::SmoothArgs a{x, mask, alpha, beta, B, T, preds};
  const int grid = (n_warps + fm::kSmoothWarps - 1) / fm::kSmoothWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == fm::kSES) {
    fm::smooth_kernel<fm::kSES><<<grid, fm::kSmoothWarps * 32, 0, st>>>(a);
  } else if (kind == fm::kDES) {
    fm::smooth_kernel<fm::kDES><<<grid, fm::kSmoothWarps * 32, 0, st>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}


// CTAs of `kernel` (threads, smem) the card holds at once
template <typename K>
static cudaError_t resident_ctas(K kernel, int threads, size_t smem, int* n) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  // the SM's whole shared memory: six CTAs of the Holt-Winters kind take 228 KB
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  *n = sms * per_sm;
  return e != cudaSuccess ? e : (per_sm < 1 ? cudaErrorInvalidValue : cudaSuccess);
}

// Kernel C's Holt-Winters kind: `ring` holds (n_warps,
// 32, stride) floats; the launch takes at most n_warps warps (a multiple of
// kDevWarps), and no more than the card holds at once
extern "C" int fm_smooth_hw(const float* x, const uint8_t* mask, const float* alpha,
                                   const float* beta, const float* gamma, const int* period,
                                   int B, int T, int stride, float* ring, int n_warps,
                                   float* preds, long long* clocks, void* stream) {
  if (stride < 1 || n_warps < fm::kDevWarps) return int(cudaErrorInvalidValue);
  const bool vec = T % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  fm::HwArgs a{x, mask, alpha, beta, gamma, period, B, T, stride, vec, ring, preds, clocks};
  int resident = 0;
  cudaError_t e = resident_ctas(fm::smooth_hw_kernel, fm::kDevWarps * 32, 0, &resident);
  if (e != cudaSuccess) return int(e);
  const int grid = min(n_warps / fm::kDevWarps, resident);
  fm::smooth_hw_kernel<<<grid, fm::kDevWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

extern "C" int fm_hw_fit_ring_row(int G) { return (G + 1) & ~1; }

extern "C" int fm_hw_fit(const float* x, const uint8_t* mask, const uint8_t* fit,
                         const int* period, const float* grid, int G, int B, int T, float* ring,
                         int ring_stride, int n_warps, float* params, int* best, double* mse,
                         long long* clocks, void* stream) {
  if (G < 1 || G > fm::kFitLanes) return int(cudaErrorInvalidValue);
  const bool vec = T % 16 == 0 && (reinterpret_cast<uintptr_t>(mask) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(fit) % 16 == 0);
  fm::HwFitArgs a{x, mask, fit, period, grid, G, B, T, vec, ring, ring_stride,
                  fm_hw_fit_ring_row(G), params, best, mse, clocks};
  // no more warps than the card holds at once: every warp in flight from
  // the start, rows grid-stride
  int dev = 0, sms = 1, per_sm = 1;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fm::hw_fit_kernel,
                                                      fm::kFitWarps * 32, 0);
  }
  if (e != cudaSuccess) return int(e);
  const int blocks = min((n_warps + fm::kFitWarps - 1) / fm::kFitWarps, max(1, sms * per_sm));
  fm::hw_fit_kernel<<<blocks, fm::kFitWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
