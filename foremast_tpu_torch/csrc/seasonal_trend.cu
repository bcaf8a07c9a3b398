// Kernel J: `st_fit`, the seasonal-trend (Prophet-core) fit of B rows in one
// launch.
//
// Replaces the reference's jitted ops/forecast.py:fit_seasonal_trend
// (:400-466). Per row: the design X = [1, tn, relu(tn - s_j) for the C
// hinge knots, sin(k w), cos(k w) for k = 1..order], D = 2 + C + 2 order
// columns; the normal equations G = X^T diag(sel) X and rhs = X^T (sel x)
// over sel = mask & fit; a ridge solve with penalty ridge + cp_shrink on the
// hinge columns; when C > 0, l1_iters - 1 IRLS rounds with penalty ridge +
// cp_shrink / (|beta| + 1e-3) on them (the gram is reused, only its
// diagonal changes); preds = X beta at every slot, padding included.
//
// Design: one CTA of kStThreads threads per row.
//   1. The row's columns are generated in the kernel from its own period;
//      there is no (T, D) table in device memory. Every column rounds as
//      the reference's compiled program does (ops/forecast.py:st_columns):
//      tn = t * fl(1 / max(T - 1, 1)), knots s_j = fl(fl(j fl(1 / (C + 1)))
//      0.8), Fourier arguments t * c_k with c_k = fl(fl(fl(2 pi)
//      fl(1 / period)) k), then sinf / cosf (never the fast intrinsics;
//      the library builds with -fmad=false, so no step fuses).
//   2. Tiles of kStTile slots: the selected slots of a tile are compacted
//      (warp ballots), and their columns and value are written to shared
//      memory as float64 (an augmented row of D + 1 values). Each thread
//      owns up to kStOwn entries of the upper triangle of the augmented
//      gram [G rhs] ((D + 1)(D + 2) / 2 - 1 entries: 230 at D = 20) and adds
//      the tile's products to float64 accumulators: the sums are float64
//      throughout (each product of two float32 values is exact in float64).
//   3. Warp 0 solves in float64: G + diag(pen) is symmetric positive
//      definite, so a left-looking Cholesky (lane i holds row i) and two
//      triangular solves by shuffles serve; a non-positive (or NaN) pivot
//      gives the row NaN, as the twin's cholesky_ex does.
//   4. Every thread writes preds for its slots: the float64 dot of the
//      columns with beta, rounded once.
//
// What bounds it on an H100: the operations. A fitted slot costs
// (D + 1)(D + 2) / 2 - 1 float64 FMAs (230 at D = 20), a written slot D
// more; at B = 100k rows of T = 16384 with ~10,080 history slots each that
// is ~2.6e11 float64 FMAs, ~16 ms at the float64 rate, against 10 B a slot
// of traffic (~16 GB, ~4.9 ms at 3.35 TB/s). This first version reads each
// tile entry from shared memory twice per FMA, so shared-memory bandwidth,
// not the FMA pipe, is its limit; making it fast is later work.
#include "common.cuh"

namespace fm {

constexpr int kStThreads = 256;
constexpr int kStTile = 256;  // slots per tile: one per thread
constexpr int kMaxStD = 32;   // columns: one lane of warp 0 per row of G
constexpr int kMaxStEntries = (kMaxStD + 1) * (kMaxStD + 2) / 2 - 1;
constexpr int kStOwn = (kMaxStEntries + kStThreads - 1) / kStThreads;

struct StArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* fit;
  const int* period;
  int T;
  int C;
  int order;
  int l1_iters;
  double ridge;
  double cp_shrink;
  float* beta;
  float* preds;
};

// The row's design constants, as the reference rounds them.
struct StDesign {
  float inv_t;                 // fl(1 / max(T - 1, 1))
  float knot[kMaxStD];         // s_j, j = 1..C
  float ck[kMaxStD / 2];       // c_k, k = 1..order
};

__device__ __forceinline__ float st_tn(const StDesign& d, int t) { return float(t) * d.inv_t; }

// One augmented design row (D columns, then x) as float64 in out[0, D].
__device__ __forceinline__ void st_row(const StDesign& d, int C, int K, int t, float x,
                                       double* out) {
  const float tn = st_tn(d, t);
  out[0] = 1.0;
  out[1] = double(tn);
  for (int j = 0; j < C; ++j) out[2 + j] = double(fmaxf(tn - d.knot[j], 0.0f));
  const float tf = float(t);
  for (int k = 0; k < K; ++k) {
    const float a = tf * d.ck[k];
    out[2 + C + 2 * k] = double(sinf(a));
    out[3 + C + 2 * k] = double(cosf(a));
  }
  out[2 + C + 2 * K] = double(x);
}

// X beta at slot t, summed over the columns in order in float64.
__device__ __forceinline__ float st_predict(const StDesign& d, int C, int K, int t,
                                            const double* beta) {
  const float tn = st_tn(d, t);
  double acc = beta[0];
  acc += double(tn) * beta[1];
  for (int j = 0; j < C; ++j) acc += double(fmaxf(tn - d.knot[j], 0.0f)) * beta[2 + j];
  const float tf = float(t);
  for (int k = 0; k < K; ++k) {
    const float a = tf * d.ck[k];
    acc += double(sinf(a)) * beta[2 + C + 2 * k];
    acc += double(cosf(a)) * beta[3 + C + 2 * k];
  }
  return float(acc);
}

// Warp 0 solves (G + diag(pen)) beta = rhs by Cholesky; lane i holds row i:
// its penalty and right-hand side in, its beta out. G is symmetric, read
// from its lower triangle. Returns false (every lane) on a pivot that is
// not positive.
__device__ bool st_cholesky_solve(const double (*G)[kMaxStD + 1], double (*L)[kMaxStD + 1],
                                  int D, double pen, double rhs, double& beta) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int j = 0; j < D; ++j) {
    double s = 0.0;
    if (lane >= j && lane < D) {
      s = G[lane][j] + (lane == j ? pen : 0.0);
      for (int k = 0; k < j; ++k) s -= L[lane][k] * L[j][k];
    }
    const double piv = __shfl_sync(kFullWarp, s, j);
    ok = ok && piv > 0.0;
    const double ljj = sqrt(piv);
    if (lane == j) L[j][j] = ljj;
    else if (lane > j && lane < D) L[lane][j] = s / ljj;
    __syncwarp();
  }
  // L y = rhs
  double b = lane < D ? rhs : 0.0;
  for (int k = 0; k < D; ++k) {
    const double yk = __shfl_sync(kFullWarp, b, k) / L[k][k];
    if (lane == k) b = yk;
    else if (lane > k && lane < D) b -= L[lane][k] * yk;
  }
  // L^T beta = y
  for (int k = D - 1; k >= 0; --k) {
    const double bk = __shfl_sync(kFullWarp, b, k) / L[k][k];
    if (lane == k) b = bk;
    else if (lane < k) b -= L[k][lane] * bk;
  }
  beta = ok ? b : CUDART_NAN;
  return ok;
}

__global__ void __launch_bounds__(kStThreads) st_fit_kernel(StArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StDesign des;
  __shared__ double G[kMaxStD][kMaxStD + 1];
  __shared__ double L[kMaxStD][kMaxStD + 1];
  __shared__ double rhs[kMaxStD];
  __shared__ double beta[kMaxStD];
  __shared__ int warp_n[kStThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, C = a.C, K = a.order, D = 2 + C + 2 * K, DA = D + 1;
  const size_t off = size_t(row) * T;
  double* tile = reinterpret_cast<double*>(smem);  // [kStTile][DA]

  if (tid == 0) des.inv_t = 1.0f / float(T - 1 > 1 ? T - 1 : 1);
  if (tid < C) des.knot[tid] = (float(tid + 1) * (1.0f / float(C + 1))) * 0.8f;
  if (tid < K) des.ck[tid] = (6.2831855f * (1.0f / float(a.period[row]))) * float(tid + 1);

  // the upper-triangle entries (d, e), d <= e <= D, but (D, D), this thread owns
  const int n_entries = DA * (DA + 1) / 2 - 1;
  int own_d[kStOwn], own_e[kStOwn];
  double acc[kStOwn];
#pragma unroll
  for (int q = 0; q < kStOwn; ++q) {
    int idx = tid + q * kStThreads, d = -1, e = 0;
    if (idx < n_entries) {
      d = 0;
      while (idx >= DA - d) {
        idx -= DA - d;
        ++d;
      }
      e = d + idx;
    }
    own_d[q] = d;
    own_e[q] = e;
    acc[q] = 0.0;
  }
  __syncthreads();

  for (int base = 0; base < T; base += kStTile) {
    const int t = base + tid;
    const bool sel = t < T && a.mask[off + t] && a.fit[off + t];
    const unsigned bal = __ballot_sync(kFullWarp, sel);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int pos = __popc(bal & ((1u << lane) - 1u)), n = 0;
    for (int w = 0; w < kStThreads / 32; ++w) {
      pos += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (sel) st_row(des, C, K, t, a.x[off + t], tile + pos * DA);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kStOwn; ++q) {
      if (own_d[q] < 0) continue;
      const double* pd = tile + own_d[q];
      const double* pe = tile + own_e[q];
      double s = acc[q];
      for (int i = 0; i < n; ++i) s += pd[i * DA] * pe[i * DA];
      acc[q] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kStOwn; ++q) {
    const int d = own_d[q], e = own_e[q];
    if (d < 0) continue;
    if (e < D) {
      G[d][e] = acc[q];
      G[e][d] = acc[q];
    } else {
      rhs[d] = acc[q];
    }
  }
  __syncthreads();

  if (warp == 0) {
    const bool cp = lane >= 2 && lane < 2 + C;
    const double r = lane < D ? rhs[lane] : 0.0;
    double b = 0.0;
    bool ok = st_cholesky_solve(G, L, D, a.ridge + (cp ? a.cp_shrink : 0.0), r, b);
    const int rounds = C > 0 ? (a.l1_iters - 1 > 0 ? a.l1_iters - 1 : 0) : 0;
    for (int it = 0; it < rounds && ok; ++it) {
      // the reference's penalty, is_cp / (|beta| + 1e-3) on every column
      const double pen = a.ridge + a.cp_shrink * (cp ? 1.0 : 0.0) / (fabs(b) + 1e-3);
      ok = st_cholesky_solve(G, L, D, pen, r, b);
    }
    if (!ok) b = CUDART_NAN;
    if (lane < D) {
      beta[lane] = b;
      a.beta[size_t(row) * D + lane] = float(b);
    }
  }
  __syncthreads();
  for (int t = tid; t < T; t += kStThreads) a.preds[off + t] = st_predict(des, C, K, t, beta);
}

}  // namespace fm

extern "C" int fm_st_fit(const float* x, const uint8_t* mask, const uint8_t* fit,
                         const int* period, int order, int C, double ridge, double cp_shrink,
                         int l1_iters, int B, int T, float* beta, float* preds, void* stream) {
  const int D = 2 + C + 2 * order;
  if (order < 0 || C < 0 || D > fm::kMaxStD || T < 1) return int(cudaErrorInvalidValue);
  fm::StArgs a{x, mask, fit, period, T, C, order, l1_iters, ridge, cp_shrink, beta, preds};
  const size_t smem = size_t(fm::kStTile) * (D + 1) * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(fm::st_fit_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::st_fit_kernel<<<B, fm::kStThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
