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
// Design: one CTA of kScanThreads threads per row walks the row in tiles of
// kScanThreads x kScanPer steps, carrying the state from tile to tile. In a
// tile each thread composes the maps of its kScanPer consecutive steps
// (vector loads of values and mask), a warp-shuffle scan and one pass
// across the warps give each thread the composed map of every step before
// its chunk, and the thread applies it to the carried state and walks its
// chunk, writing predictions. The combine order differs from XLA's tree,
// so the results agree with the reference within a tolerance, not to the
// bit.
//
// Precision: SES composes its scalar maps in float32. DES composes, carries
// and applies its 2 x 2 maps in float64 and rounds only the predictions to
// float32: over a masked stretch the maps are shears ([[1, 1], [0, 1]]),
// and in float32 their composed products let the trend's rounding grow with
// the stretch's length (0.12 against a limit of ~0.006 on a row of
// T = 16384 on an H100). Its twin steps the same maps in float64.
//
// What bounds it on an H100: bytes. Per step it reads 5 B (value, mask) and
// writes 4 B (prediction) against ~10 float32 operations for SES and ~60
// float64 ones for DES (a compose a step, about one more for the scans);
// at B = 100k rows of T = 16384 that is ~14.7 GB, ~4.4 ms at 3.35 TB/s,
// and DES's ~1e11 float64 operations ~3 ms at the card's 34 TFLOP/s.
// Nothing but the row's inputs and outputs crosses device memory.
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
