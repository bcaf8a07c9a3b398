// Kernel E: `affine_scan`, the long-window exponential smoothers as scans of
// affine maps, one launch for B rows.
//
// Replaces the reference's ops/seqscan.py: _exclusive_states (:61) under
// _ses_assoc_1d (:78) and _des_assoc_1d (:89), jitted as
// ses_predictions_assoc and des_predictions_assoc (:113-114). A masked SES
// or DES step is an affine map of the state, state_t = A_t state_{t-1} + c_t
// (scalar for SES, 2 x 2 for DES, built from the mask exactly as the
// reference builds them), and pred_t is h . state_{t-1}: the exclusive
// prefix of those maps applied to the first state.
//
// Two paths (kernels.scan_path picks by kind and rows):
//   - scan (SES, and DES at few rows): one CTA of kScanThreads threads per
//     row walks the row in tiles of kScanThreads x kScanPer steps, carrying
//     the state from tile to tile. In a tile each thread composes the maps
//     of its kScanPer consecutive steps (vector loads of values and mask), a
//     warp-shuffle scan and one pass across the warps give each thread the
//     composed map of every step before its chunk, and the thread applies
//     it to the carried state and walks its chunk, writing predictions. The
//     combine order differs from XLA's tree, so the results agree with the
//     reference within a tolerance, not to the bit.
//   - walk (DES at many rows): one lane a row, 32 rows a warp, each lane
//     applying its row's maps one step after another, as the twin does, so
//     its predictions are the twin's bit for bit. A fleet of rows gives the
//     card its parallelism, so nothing is composed: a step is the twin's
//     own ~10 float64 operations (a scan step costs ~70). Each warp stages
//     tiles of 32 rows x kWalkSteps steps (values and mask) into its shared
//     memory by cp.async, kWalkStages tiles in flight, in rows padded so
//     that a lane's 16-byte reads of its own row meet no bank conflict; each
//     lane walks its row's steps there, writing each prediction over its value, and
//     the warp stores the tile's predictions back in coalesced 16-byte
//     rows. A row's map takes only two values, by its mask bit, so the
//     lane builds both once with the twin's expressions (m A_obs +
//     (1 - m) A_gap at m = 1 and m = 0, alpha m and beta alpha m) and picks
//     one a step: the same bits, NaN and inf included, as the twin's
//     products. Only c = (alpha m) x and (beta alpha m) x are multiplied a
//     step.
//
// Precision: SES composes its scalar maps in float32. DES composes, carries
// and applies its 2 x 2 maps in float64 and rounds only the predictions to
// float32: over a masked stretch the maps are shears ([[1, 1], [0, 1]]),
// and in float32 their composed products let the trend's rounding grow with
// the stretch's length (0.12 against a limit of ~0.006 on a row of
// T = 16384 on an H100). Its twin steps the same maps in float64.
//
// What bounds it on an H100: bytes. Per step it reads 5 B (value, mask) and
// writes 4 B (prediction); at B = 100k rows of T = 16384 that is ~14.7 GB,
// ~4.4 ms at 3.35 TB/s. The scan path does ~10 float32 operations a step
// for SES and ~70 float64 ones for DES (a compose a step, about one more for
// the scans): DES's scan at 100k x 16384 took 10.03 ms (PERF.md), bound
// by its float64 instructions. The walk's ~10 float64 operations a step are ~1 ms of the
// card's float64 rate there, hidden behind its tiles' loads and stores: it
// takes 5.63 ms, within 1% of the same staging with no walk (2.64 TB/s;
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md). A row walked alone is latency:
// ~77 cycles a dependent step, 0.66 ms at T = 16384, where the scan takes
// 0.08. Nothing but the row's inputs and outputs crosses device memory.
//
// Built with -fmad=false, as the rest of the library.
#include "common.cuh"

namespace fm {

constexpr int kScanThreads = 256;
constexpr int kScanPer = 8;
constexpr int kScanWarps = kScanThreads / 32;

// s -> A s + c (SES)
struct Map1 {
  float A, c;
};
// (l, b) -> A (l, b) + c (DES), in float64
struct Map2 {
  double a00, a01, a10, a11, c0, c1;
};

__device__ __forceinline__ Map1 identity(Map1) { return {1.0f, 0.0f}; }
__device__ __forceinline__ Map2 identity(Map2) { return {1.0, 0.0, 0.0, 1.0, 0.0, 0.0}; }

// later o earlier, as the reference's combine (A2 A1, A2 c1 + c2)
__device__ __forceinline__ Map1 compose(const Map1& e, const Map1& l) {
  return {l.A * e.A, l.A * e.c + l.c};
}
__device__ __forceinline__ Map2 compose(const Map2& e, const Map2& l) {
  return {l.a00 * e.a00 + l.a01 * e.a10, l.a00 * e.a01 + l.a01 * e.a11,
          l.a10 * e.a00 + l.a11 * e.a10, l.a10 * e.a01 + l.a11 * e.a11,
          (l.a00 * e.c0 + l.a01 * e.c1) + l.c0, (l.a10 * e.c0 + l.a11 * e.c1) + l.c1};
}

struct State1 {
  float s;
};
struct State2 {
  double l, b;
};
__device__ __forceinline__ State1 apply(const Map1& m, State1 v) { return {m.A * v.s + m.c}; }
__device__ __forceinline__ State2 apply(const Map2& m, State2 v) {
  return {(m.a00 * v.l + m.a01 * v.b) + m.c0, (m.a10 * v.l + m.a11 * v.b) + m.c1};
}
__device__ __forceinline__ State1 first_state(State1, float v0) { return {v0}; }
__device__ __forceinline__ State2 first_state(State2, float v0) { return {double(v0), 0.0}; }
__device__ __forceinline__ float predict(State1 v) { return v.s; }
__device__ __forceinline__ float predict(State2 v) { return float(v.l + v.b); }

// The step's map, as the reference builds it from m in {0, 1}:
// SES  A = 1 - alpha m, c = alpha m x;
// DES  A = m A_obs + (1 - m) A_gap, c = (alpha m x, beta alpha m x).
struct Coef {
  float al, be;
};
__device__ __forceinline__ Map1 step_map(Map1, float x, float m, Coef k) {
  return {1.0f - k.al * m, (k.al * m) * x};
}
__device__ __forceinline__ Map2 step_map(Map2, float x, float m, Coef k) {
  const double al = k.al, be = k.be, md = m, xd = x;
  const double g = 1.0 - md;
  const double oma = 1.0 - al;
  const double o00 = oma, o01 = oma, o10 = -be * al, o11 = be * oma + (1.0 - be);
  return {md * o00 + g * 1.0, md * o01 + g * 1.0, md * o10 + g * 0.0, md * o11 + g * 1.0,
          (al * md) * xd, ((be * al) * md) * xd};
}

// a map's words (float32 or float64 halves) shuffled up by o lanes
template <typename M>
__device__ __forceinline__ M shfl_up_map(const M& m, int o) {
  M r;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(&m);
  uint32_t* dst = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < int(sizeof(M) / sizeof(uint32_t)); ++i)
    dst[i] = __shfl_up_sync(kFullWarp, src[i], o);
  return r;
}

struct ScanArgs {
  const float* x;
  const uint8_t* mask;
  const float* alpha;
  const float* beta;
  int T;
  float* preds;
};

template <typename M, typename S>
__global__ void __launch_bounds__(kScanThreads) affine_scan_kernel(ScanArgs a) {
  __shared__ M warp_total[kScanWarps];
  __shared__ S carry;
  __shared__ Scratch scr;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t off = size_t(row) * T;
  const float* x = a.x + off;
  const uint8_t* mask = a.mask + off;
  float* preds = a.preds + off;
  const Coef k{a.alpha[row], a.beta != nullptr ? a.beta[row] : 0.0f};

  // the first state: the first valid value (0.0 if none), zero trend
  int first = T;
  for (int t0 = 0; t0 < T && first == T; t0 += kScanThreads * 16) {
    int f = T;
    for (int i = 0; i < 16; ++i) {
      const int t = t0 + tid * 16 + i;
      if (t < T && mask[t]) {
        f = t;
        break;
      }
    }
    first = block_reduce(f, Min<int>(), scr);
  }
  if (tid == 0) carry = first_state(S{}, first < T ? x[first] : 0.0f);
  __syncthreads();

  const bool vec = (T % kScanPer) == 0;
  for (int t0 = 0; t0 < T; t0 += kScanThreads * kScanPer) {
    const int beg = t0 + tid * kScanPer;
    float xv[kScanPer], mv[kScanPer];
    if (vec && beg + kScanPer <= T) {
      const float4 x0 = *reinterpret_cast<const float4*>(x + beg);
      const float4 x1 = *reinterpret_cast<const float4*>(x + beg + 4);
      const uint2 mm = *reinterpret_cast<const uint2*>(mask + beg);
      xv[0] = x0.x; xv[1] = x0.y; xv[2] = x0.z; xv[3] = x0.w;
      xv[4] = x1.x; xv[5] = x1.y; xv[6] = x1.z; xv[7] = x1.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mv[i] = ((mm.x >> (8 * i)) & 0xffu) ? 1.0f : 0.0f;
        mv[4 + i] = ((mm.y >> (8 * i)) & 0xffu) ? 1.0f : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScanPer; ++i) {
        const int t = beg + i;
        xv[i] = t < T ? x[t] : 0.0f;
        mv[i] = (t < T && mask[t]) ? 1.0f : 0.0f;
      }
    }
    // this thread's chunk map (steps past T stay the identity)
    M chunk = identity(M{});
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      if (beg + i < T) chunk = compose(chunk, step_map(M{}, xv[i], mv[i], k));
    }
    // inclusive scan across the warp, then the maps of earlier warps
    M inc = chunk;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const M left = shfl_up_map(inc, o);
      if (lane >= o) inc = compose(left, inc);
    }
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    M before = shfl_up_map(inc, 1);
    if (lane == 0) before = identity(M{});
    M pre = identity(M{});
    for (int q = 0; q < warp; ++q) pre = compose(pre, warp_total[q]);
    before = compose(pre, before);
    // walk the chunk from the carried state
    S st = apply(before, carry);
    float out[kScanPer];
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      out[i] = predict(st);
      if (beg + i < T) st = apply(step_map(M{}, xv[i], mv[i], k), st);
    }
    if (vec && beg + kScanPer <= T) {
      *reinterpret_cast<float4*>(preds + beg) = make_float4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<float4*>(preds + beg + 4) = make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kScanPer; ++i) {
        if (beg + i < T) preds[beg + i] = out[i];
      }
    }
    __syncthreads();  // every thread has read carry and warp_total
    if (tid == kScanThreads - 1) carry = st;
    __syncthreads();
  }
}


// ---------------------------------------------------------------------------
// The walk path (DES): a lane a row, 32 rows a warp, kWalkWarps warps a CTA.
// ---------------------------------------------------------------------------
constexpr int kWalkWarps = 4;
constexpr int kWalkStages = 2;  // tiles in flight a warp
constexpr int kWalkSteps = 64;  // a tile's steps (32 took 8% longer on an H100, PERF.md)

// A warp's tile of 32 rows x S steps in shared memory. kVec (T % 16 == 0):
// 16-byte cp.async rows, padded to an odd count of 16-byte chunks (S + 4
// floats, S + 16 mask bytes), so that the 8 lanes of a quarter-warp reading
// 16 bytes each of their own rows fall in distinct bank groups; otherwise
// element loads, rows padded to an odd count of words.
template <int S, bool kVec>
struct WalkTile {
  static constexpr int kX = kVec ? S + 4 : S + 1;   // floats a row
  static constexpr int kM = kVec ? S + 16 : S + 4;  // mask bytes a row
  static constexpr int kBytes = 32 * kX * 4 + 32 * kM;
};

struct WalkArgs {
  const float* x;
  const uint8_t* mask;
  const float* alpha;
  const float* beta;
  int B, T;
  float* preds;
};

// The row's two maps (mask 1 and mask 0), each built with the twin's
// expressions at that m, and its state.
struct WalkRow {
  double a1[4], a0[4];  // m A_obs + (1 - m) A_gap at m = 1, 0
  double am1, am0;      // alpha m
  double bam1, bam0;    // (beta alpha) m
  double l, b;
};

__device__ __forceinline__ void walk_maps(WalkRow& r, double al, double be) {
  const double oma = 1.0 - al;
  const double o[4] = {oma, oma, -be * al, be * oma + (1.0 - be)};
  const double gap[4] = {1.0, 1.0, 0.0, 1.0};
  const double one = 1.0, zero = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.a1[i] = one * o[i] + (1.0 - one) * gap[i];
    r.a0[i] = zero * o[i] + (1.0 - zero) * gap[i];
  }
  const double ba = be * al;
  r.am1 = al * one;
  r.am0 = al * zero;
  r.bam1 = ba * one;
  r.bam0 = ba * zero;
}

// One step: the prediction before it, then the state through the map the
// mask picks.
__device__ __forceinline__ float walk_step(WalkRow& r, float x, bool m) {
  const float pred = float(r.l + r.b);
  const double xd = x;
  const double c0 = (m ? r.am1 : r.am0) * xd, c1 = (m ? r.bam1 : r.bam0) * xd;
  const double a00 = m ? r.a1[0] : r.a0[0], a01 = m ? r.a1[1] : r.a0[1];
  const double a10 = m ? r.a1[2] : r.a0[2], a11 = m ? r.a1[3] : r.a0[3];
  const double l = (a00 * r.l + a01 * r.b) + c0;
  r.b = (a10 * r.l + a11 * r.b) + c1;
  r.l = l;
  return pred;
}

// Start the loads of tile [t0, t0 + L) of the warp's 32 rows (those below
// B) into xs / ms. kVec: L % 16 == 0, 16-byte copies in flight, a row's
// S / 4 value chunks (S / 16 mask chunks) on consecutive lanes; else
// element loads, done on return.
template <int S, bool kVec>
__device__ __forceinline__ void walk_load(const WalkArgs& a, int row0, int t0, int L, float* xs,
                                          uint8_t* ms, int lane) {
  using Tile = WalkTile<S, kVec>;
  const int rows = min(32, a.B - row0);
  if constexpr (kVec) {
    constexpr int CX = S / 4, CM = S / 16;
    const int qx = lane % CX, qm = lane % CM;
    if (4 * qx < L) {
      for (int r = lane / CX; r < rows; r += 32 / CX)
        cp_async16(xs + r * Tile::kX + 4 * qx, a.x + size_t(row0 + r) * a.T + t0 + 4 * qx);
    }
    if (16 * qm < L) {
      for (int r = lane / CM; r < rows; r += 32 / CM)
        cp_async16(ms + r * Tile::kM + 16 * qm, a.mask + size_t(row0 + r) * a.T + t0 + 16 * qm);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const size_t g = size_t(row0 + r) * a.T + t0;
      for (int j = lane; j < L; j += 32) {
        xs[r * Tile::kX + j] = a.x[g + j];
        ms[r * Tile::kM + j] = a.mask[g + j];
      }
    }
  }
}

template <int S, bool kVec>
__device__ __forceinline__ void walk_store(const WalkArgs& a, int row0, int t0, int L,
                                           const float* xs, int lane) {
  using Tile = WalkTile<S, kVec>;
  const int rows = min(32, a.B - row0);
  if constexpr (kVec) {
    constexpr int CX = S / 4;
    const int qx = lane % CX;
    if (4 * qx < L) {
      for (int r = lane / CX; r < rows; r += 32 / CX)
        *reinterpret_cast<float4*>(a.preds + size_t(row0 + r) * a.T + t0 + 4 * qx) =
            *reinterpret_cast<const float4*>(xs + r * Tile::kX + 4 * qx);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const size_t g = size_t(row0 + r) * a.T + t0;
      for (int j = lane; j < L; j += 32) a.preds[g + j] = xs[r * Tile::kX + j];
    }
  }
}

// The lane's walk of its row's L steps of a tile, each prediction written
// over its value.
template <int S, bool kVec>
__device__ __forceinline__ void walk_tile(WalkRow& r, float* xrow, const uint8_t* mrow, int L) {
  if constexpr (kVec) {
    for (int i = 0; i < L; i += 16) {
      const uint4 mm = *reinterpret_cast<const uint4*>(mrow + i);
      const uint32_t mw[4] = {mm.x, mm.y, mm.z, mm.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 v = *reinterpret_cast<const float4*>(xrow + i + 4 * q);
        v.x = walk_step(r, v.x, (mw[q] & 0xffu) != 0u);
        v.y = walk_step(r, v.y, (mw[q] & 0xff00u) != 0u);
        v.z = walk_step(r, v.z, (mw[q] & 0xff0000u) != 0u);
        v.w = walk_step(r, v.w, (mw[q] & 0xff000000u) != 0u);
        *reinterpret_cast<float4*>(xrow + i + 4 * q) = v;
      }
    }
  } else {
    for (int i = 0; i < L; ++i) xrow[i] = walk_step(r, xrow[i], mrow[i] != 0);
  }
}

// The first valid slot of the lane's row (T if none): its own row's mask
// read from the start, 16 bytes at a time where kVec.
template <bool kVec>
__device__ __forceinline__ int walk_first(const WalkArgs& a, int row) {
  const uint8_t* m = a.mask + size_t(row) * a.T;
  if constexpr (kVec) {
    for (int t = 0; t < a.T; t += 16) {
      const uint4 mm = *reinterpret_cast<const uint4*>(m + t);
      const uint32_t mw[4] = {mm.x, mm.y, mm.z, mm.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (mw[q] != 0u) return t + 4 * q + (__ffs(int(mw[q])) - 1) / 8;
    }
  } else {
    for (int t = 0; t < a.T; ++t)
      if (m[t]) return t;
  }
  return a.T;
}

template <int S, bool kVec>
__global__ void __launch_bounds__(kWalkWarps * 32) affine_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Tile = WalkTile<S, kVec>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWalkWarps + warp) * 32;
  if (row0 >= a.B) return;  // a whole warp past the rows
  unsigned char* mine = smem + size_t(warp) * kWalkStages * Tile::kBytes;
  auto xs = [&](int s) { return reinterpret_cast<float*>(mine + size_t(s) * Tile::kBytes); };
  auto ms = [&](int s) {
    return reinterpret_cast<uint8_t*>(mine + size_t(s) * Tile::kBytes + 32 * Tile::kX * 4);
  };
  const int T = a.T, tiles = (T + S - 1) / S;
  // the first tiles' loads in flight while the lanes find their first state
#pragma unroll
  for (int s = 0; s < kWalkStages - 1; ++s) {
    if (s < tiles) walk_load<S, kVec>(a, row0, s * S, min(S, T - s * S), xs(s), ms(s), lane);
    if constexpr (kVec) cp_async_commit();
  }
  const int row = row0 + lane;
  const bool live = row < a.B;
  WalkRow r;
  if (live) {
    walk_maps(r, double(a.alpha[row]), double(a.beta[row]));
    const int first = walk_first<kVec>(a, row);
    r.l = first < T ? double(a.x[size_t(row) * T + first]) : 0.0;
    r.b = 0.0;
  }
  for (int i = 0; i < tiles; ++i) {
    const int nxt = i + kWalkStages - 1;
    if (nxt < tiles) {
      const int s = nxt % kWalkStages;
      walk_load<S, kVec>(a, row0, nxt * S, min(S, T - nxt * S), xs(s), ms(s), lane);
    }
    if constexpr (kVec) {
      cp_async_commit();
      cp_async_wait_group<kWalkStages - 1>();
    }
    __syncwarp();
    const int s = i % kWalkStages, t0 = i * S, L = min(S, T - t0);
    if (live) walk_tile<S, kVec>(r, xs(s) + lane * Tile::kX, ms(s) + lane * Tile::kM, L);
    __syncwarp();
    walk_store<S, kVec>(a, row0, t0, L, xs(s), lane);
    __syncwarp();  // the tile's buffer is free for the next loads
  }
}
}  // namespace fm

extern "C" int fm_affine_scan(int kind, const float* x, const uint8_t* mask, const float* alpha,
                              const float* beta, int B, int T, float* preds, void* stream) {
  fm::ScanArgs a{x, mask, alpha, beta, T, preds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1) {
    fm::affine_scan_kernel<fm::Map1, fm::State1><<<B, fm::kScanThreads, 0, st>>>(a);
  } else if (kind == 2) {
    fm::affine_scan_kernel<fm::Map2, fm::State2><<<B, fm::kScanThreads, 0, st>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Shared memory of a walk CTA: kWalkWarps warps, kWalkStages tiles each.
template <int S, bool kVec>
static size_t walk_smem() {
  return size_t(fm::kWalkWarps) * fm::kWalkStages * fm::WalkTile<S, kVec>::kBytes;
}

template <int S, bool kVec>
static int launch_walk(const fm::WalkArgs& a, cudaStream_t st) {
  const size_t smem = walk_smem<S, kVec>();
  cudaError_t e = cudaFuncSetAttribute(fm::affine_walk_kernel<S, kVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int warps = (a.B + 31) / 32;
  const int grid = (warps + fm::kWalkWarps - 1) / fm::kWalkWarps;
  fm::affine_walk_kernel<S, kVec><<<grid, fm::kWalkWarps * 32, smem, st>>>(a);
  return int(cudaGetLastError());
}

// Kernel E's DES walk (kernels.scan_path's "walk").
extern "C" int fm_affine_scan_walk(const float* x, const uint8_t* mask, const float* alpha,
                                   const float* beta, int B, int T, float* preds, void* stream) {
  fm::WalkArgs a{x, mask, alpha, beta, B, T, preds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row's start 16-byte aligned
  const bool vec = T % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(preds) % 16 == 0;
  return vec ? launch_walk<fm::kWalkSteps, true>(a, st) : launch_walk<fm::kWalkSteps, false>(a, st);
}
