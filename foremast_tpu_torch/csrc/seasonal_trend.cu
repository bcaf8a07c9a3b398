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
// Two paths, chosen by the launcher (kernels.st_path): up to kMaxStD = 32
// columns the warp path below; above it the cta path (st_fit_cta_kernel,
// further down), which takes any D.
//
// The warp path: one warp per row, kStWarps rows a CTA (the warps share
// nothing).
//   1. The row's columns are generated in the kernel from its own period;
//      there is no (T, D) table in device memory. Every column rounds as
//      the reference's compiled program does (ops/forecast.py:st_columns):
//      tn = t * fl(1 / max(T - 1, 1)), knots s_j = fl(fl(j fl(1 / (C + 1)))
//      0.8), Fourier arguments t * c_k with c_k = fl(fl(fl(2 pi)
//      fl(1 / period)) k), then the sine and cosine of one sincosf (which
//      gives sinf's and cosf's bits: kernels.st_sincos_check; never the
//      fast intrinsics; the library builds with -fmad=false, so no step
//      fuses).
//   2. The augmented gram [X x]^T diag(sel) [X x] on the float64 tensor
//      cores (DMMA m16n8k4). A warp walks its row 32 slots at a time, a
//      slot a lane: the selected ones (a ballot) build their rows [X x]
//      once, as float32, into the warp's tile in shared memory, compacted;
//      then the tile feeds the MMA 4 rows a step. The D + 1 columns are
//      padded to NB blocks of 8; in X^T X the A fragment of block b (X^T)
//      and the B fragment of block b (X) hold the same values, so lane
//      (g, t) reads column 8 b + g of row t once for both operands. For
//      each column block b2: the 16 x 8 tiles of row blocks (2q, 2q + 1),
//      2q + 1 <= b2 (m16n8k4), and for an even b2 its diagonal 8 x 8 block
//      (m8n8k4): 384 products a slot at D = 20, of which 230 are needed.
//      Every product of two float32 values is exact in float64, so only
//      the order of the float64 sums differs from the twin's. (On an H100
//      at 100,000 x 16384, m16n8k4 tiles alone, 512 products a slot, took
//      44.6 ms against 42.0 with this mix; m8n8k4, m16n8k8 or m16n8k16
//      throughout 46.6, 45.5 or 50.1; building each fragment's columns in
//      a lane's registers 69.6; the gram without its MMAs kept 95% of its
//      cycles: issuing its builds, loads and conversions bounds it, not the
//      tensor pipe.)
//   3. The same warp solves in float64: G + diag(pen) is symmetric positive
//      definite, so a left-looking Cholesky (lane i holds row i; G kept in
//      the strict upper triangle of one matrix and L in its strict lower
//      one) and two triangular solves by shuffles serve; a non-positive (or
//      NaN) pivot gives the row NaN, as the twin's cholesky_ex does. Other
//      warps' grams run on while one warp solves.
//   4. The warp writes preds for the row's slots, a lane a slot: the
//      columns built once and summed with beta by D float64 FMAs.
//
// What bounds it on an H100: the operations. A fitted slot costs
// (D + 1)(D + 2) / 2 - 1 float64 multiply-adds for the gram (230 at
// D = 20), a written slot D more; at B = 100k rows of T = 16384 with
// ~9,600 fitted slots each that is ~2.3e11, 7.6 ms at the float64 tensor
// cores' 67 TFLOP/s, against 10 B a slot of traffic (~16 GB, ~4.9 ms at
// 3.35 TB/s). This design's padded gram does 384 products a fitted slot
// (3.7e11, 11.0 ms at that rate); the gram and the preds pass (a sincosf a
// Fourier pair, a conversion and an FMA a column) are bound by issue.
#include "common.cuh"

namespace fm {

constexpr int kStWarps = 4;  // rows (warps) a CTA
constexpr int kMaxStD = 32;  // columns: one lane per row of G in the solve
constexpr int kStPhases = 3;  // the gram, the solves, preds

struct StArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* fit;
  const int* period;
  int B;
  int T;
  int C;
  int order;
  int l1_iters;
  double ridge;
  double cp_shrink;
  float* beta;
  float* preds;
  long long* clocks;  // null, or (B, kStPhases) SM cycles a row spent per phase
};

// A warp's shared memory: the gram G in the strict upper triangle of A
// (D rows of ld = D + 1 doubles) and L in its strict lower one, both
// diagonals, rhs and beta, the design constants, and the tile of up to 32
// selected slots' rows [X x], padded with zero columns to the gram's 8 NB
// (rows of 8 NB + 1 floats, an odd count, so that the lanes writing a row
// each fall on distinct banks).
struct StWarpMem {
  double* A;
  double* gdiag;
  double* ldiag;
  double* rhs;
  double* beta;
  float* knot;
  float* ck;
  float* tile;
};

__host__ __device__ inline int st_tile_ld(int D) { return (D + 8) / 8 * 8 + 1; }

__host__ __device__ inline int st_warp_bytes(int D) {
  return (D * (D + 1) + 4 * kMaxStD) * 8 + (kMaxStD + kMaxStD / 2 + 32 * st_tile_ld(D)) * 4;
}

__device__ inline StWarpMem st_warp_mem(unsigned char* base, int D) {
  StWarpMem w;
  w.A = reinterpret_cast<double*>(base);
  w.gdiag = w.A + D * (D + 1);
  w.ldiag = w.gdiag + kMaxStD;
  w.rhs = w.ldiag + kMaxStD;
  w.beta = w.rhs + kMaxStD;
  w.knot = reinterpret_cast<float*>(w.beta + kMaxStD);
  w.ck = w.knot + kMaxStD;
  w.tile = w.ck + kMaxStD / 2;
  return w;
}

__device__ __forceinline__ void st_sin_cos(float a, float& s, float& c) { sincosf(a, &s, &c); }

// A selected slot's augmented design row [X x] (D + 1 floats) into r, as
// the reference rounds each column.
__device__ __forceinline__ void st_row_cols(const float* knot, const float* ck, int C, int K,
                                            int t, float x, float inv_t, float* r) {
  const float tf = float(t), tn = tf * inv_t;
  r[0] = 1.0f;
  r[1] = tn;
  for (int j = 0; j < C; ++j) r[2 + j] = fmaxf(tn - knot[j], 0.0f);
  for (int k = 0; k < K; ++k) st_sin_cos(tf * ck[k], r[2 + C + 2 * k], r[3 + C + 2 * k]);
  r[2 + C + 2 * K] = x;
}

__device__ __forceinline__ void st_row(const StWarpMem& w, int C, int K, int t, float x,
                                       float inv_t, float* r) {
  st_row_cols(w.knot, w.ck, C, K, t, x, inv_t, r);
}

// The gram's tiles, for each column block b2: the 16 x 8 tiles of row
// blocks (2q, 2q + 1), 2q + 1 <= b2 (m16n8k4), and for an even b2 its
// diagonal 8 x 8 block (m8n8k4); 4 accumulator doubles a lane each (2 used
// by an 8 x 8 one).
template <int NB>
__host__ __device__ constexpr int st_tiles() {
  int n = 0;
  for (int b2 = 0; b2 < NB; ++b2) n += (b2 + 1) / 2 + (b2 % 2 == 0);
  return n;
}

// One step of 4 rows: v[b] holds column 8 b + g of row t of the step.
template <int NB>
__device__ __forceinline__ void st_mma(double* acc, const double (&v)[NB]) {
  int u = 0;
#pragma unroll
  for (int b2 = 0; b2 < NB; ++b2) {
#pragma unroll
    for (int q = 0; 2 * q + 1 <= b2; ++q, ++u) {
      const double a[2] = {v[2 * q], v[2 * q + 1]};
      mma_f64_m16n8k4(acc + 4 * u, a, &v[b2]);
    }
    if (b2 % 2 == 0) mma_f64_m8n8k4(acc + 4 * u++, &v[b2], &v[b2]);
  }
}

// One entry (p1, p2) of the padded augmented gram into the warp's G, gdiag
// or rhs; each unordered pair is stored once (p1 <= p2).
__device__ __forceinline__ void st_store(const StWarpMem& w, int D, int p1, int p2,
                                         double val) {
  if (p1 > p2 || p2 > D || p1 == D) return;
  if (p2 == D) w.rhs[p1] = val;
  else if (p1 == p2) w.gdiag[p1] = val;
  else w.A[p1 * (D + 1) + p2] = val;
}

// The warp solves (G + diag(pen)) beta = rhs by Cholesky; lane i holds row
// i: its penalty and right-hand side in, its beta out. G is read from the
// strict upper triangle of w.A and gdiag, L written to the strict lower one
// and ldiag. Returns false (every lane) on a pivot that is not positive.
__device__ bool st_cholesky_solve(const StWarpMem& w, int D, double pen, double rhs,
                                  double& beta) {
  const int lane = threadIdx.x & 31, ld = D + 1;
  const double* A = w.A;
  bool ok = true;
  for (int j = 0; j < D; ++j) {
    double s = 0.0;
    if (lane >= j && lane < D) {
      s = lane == j ? w.gdiag[j] + pen : A[j * ld + lane];
      for (int k = 0; k < j; ++k) s -= A[lane * ld + k] * A[j * ld + k];
    }
    const double piv = __shfl_sync(kFullWarp, s, j);
    ok = ok && piv > 0.0;
    const double ljj = sqrt(piv);
    if (lane == j) w.ldiag[j] = ljj;
    else if (lane > j && lane < D) w.A[lane * ld + j] = s / ljj;
    __syncwarp();
  }
  // L y = rhs
  double b = lane < D ? rhs : 0.0;
  for (int k = 0; k < D; ++k) {
    const double yk = __shfl_sync(kFullWarp, b, k) / w.ldiag[k];
    if (lane == k) b = yk;
    else if (lane > k && lane < D) b -= A[lane * ld + k] * yk;
  }
  // L^T beta = y
  for (int k = D - 1; k >= 0; --k) {
    const double bk = __shfl_sync(kFullWarp, b, k) / w.ldiag[k];
    if (lane == k) b = bk;
    else if (lane < k) b -= A[k * ld + lane] * bk;
  }
  __syncwarp();
  beta = ok ? b : CUDART_NAN;
  return ok;
}

template <int NB>
__global__ void __launch_bounds__(kStWarps * 32) st_fit_kernel(StArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTiles = st_tiles<NB>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kStWarps + warp;
  if (row >= a.B) return;
  const int T = a.T, C = a.C, K = a.order, D = 2 + C + 2 * K;
  const StWarpMem w = st_warp_mem(smem + size_t(warp) * st_warp_bytes(D), D);
  const size_t off = size_t(row) * T;
  const long long c0 = clock64();

  const float inv_t = 1.0f / float(T - 1 > 1 ? T - 1 : 1);
  if (lane < C) w.knot[lane] = (float(lane + 1) * (1.0f / float(C + 1))) * 0.8f;
  if (lane < K) w.ck[lane] = (6.2831855f * (1.0f / float(a.period[row]))) * float(lane + 1);
  __syncwarp();
  double acc[4 * kTiles];
#pragma unroll
  for (int i = 0; i < 4 * kTiles; ++i) acc[i] = 0.0;

  // 32 slots at a time, a slot a lane (the next 32's loads in flight): the
  // selected slots' rows go to the tile, compacted (rows past the last one
  // up to a whole step zeroed), then 4 rows a step into the MMA, lane (g, t)
  // reading column 8 b + g of row t
  const int g = lane >> 2, t4 = lane & 3, ldx = st_tile_ld(D);
  for (int i = lane; i < 32 * ldx; i += 32) w.tile[i] = 0.0f;
  __syncwarp();
  bool sel_next = lane < T && a.mask[off + lane] && a.fit[off + lane];
  float x_next = sel_next ? a.x[off + lane] : 0.0f;
  for (int base = 0; base < T; base += 32) {
    const bool sel = sel_next;
    const float xv = x_next;
    const int t_next = base + 32 + lane;
    sel_next = t_next < T && a.mask[off + t_next] && a.fit[off + t_next];
    x_next = sel_next ? a.x[off + t_next] : 0.0f;
    const unsigned bal = __ballot_sync(kFullWarp, sel);
    if (bal == 0u) continue;
    const int n = __popc(bal);
    if (sel) {
      const int pos = __popc(bal & ((1u << lane) - 1u));
      st_row(w, C, K, base + lane, xv, inv_t, w.tile + pos * ldx);
    }
    for (int i = lane; i < ((4 - n) & 3) * ldx; i += 32) w.tile[n * ldx + i] = 0.0f;
    __syncwarp();
    for (int j = 0; j < n; j += 4) {
      const float* r = w.tile + (j + t4) * ldx + g;
      double v[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) v[b] = double(r[8 * b]);
      st_mma<NB>(acc, v);
    }
    __syncwarp();  // before the next group's rows overwrite the tile
  }

  // the tiles into G, gdiag and rhs
  {
    int u = 0;
#pragma unroll
    for (int b2 = 0; b2 < NB; ++b2) {
#pragma unroll
      for (int q = 0; 2 * q + 1 <= b2; ++q, ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_store(w, D, 16 * q + 8 * (i >> 1) + g, 8 * b2 + 2 * t4 + (i & 1), acc[4 * u + i]);
      if (b2 % 2 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          st_store(w, D, 8 * b2 + g, 8 * b2 + 2 * t4 + i, acc[4 * u + i]);
        ++u;
      }
    }
  }
  __syncwarp();
  const long long c1 = clock64();

  {
    const bool cp = lane >= 2 && lane < 2 + C;
    const double r = lane < D ? w.rhs[lane] : 0.0;
    double b = 0.0;
    bool ok = st_cholesky_solve(w, D, a.ridge + (cp ? a.cp_shrink : 0.0), r, b);
    const int rounds = C > 0 ? (a.l1_iters - 1 > 0 ? a.l1_iters - 1 : 0) : 0;
    for (int it = 0; it < rounds && ok; ++it) {
      // the reference's penalty, is_cp / (|beta| + 1e-3) on every column
      const double pen = a.ridge + a.cp_shrink * (cp ? 1.0 : 0.0) / (fabs(b) + 1e-3);
      ok = st_cholesky_solve(w, D, pen, r, b);
    }
    if (!ok) b = CUDART_NAN;
    if (lane < D) {
      w.beta[lane] = b;
      a.beta[size_t(row) * D + lane] = float(b);
    }
  }
  __syncwarp();
  const long long c2 = clock64();

  // preds, 4 slots a lane a round (beta and the design constants read once
  // for the 4)
  for (int t0 = lane; t0 < T; t0 += 128) {
    float tf[4], tn[4];
    double acc_p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      tf[r] = float(t0 + 32 * r);
      tn[r] = tf[r] * inv_t;
      acc_p[r] = fma(double(tn[r]), w.beta[1], w.beta[0]);
    }
    for (int j = 0; j < C; ++j) {
      const float kn = w.knot[j];
      const double bj = w.beta[2 + j];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_p[r] = fma(double(fmaxf(tn[r] - kn, 0.0f)), bj, acc_p[r]);
    }
    for (int k = 0; k < K; ++k) {
      const float ckk = w.ck[k];
      const double bs = w.beta[2 + C + 2 * k], bc = w.beta[3 + C + 2 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sv, cv;
        st_sin_cos(tf[r] * ckk, sv, cv);
        acc_p[r] = fma(double(cv), bc, fma(double(sv), bs, acc_p[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (t0 + 32 * r < T) a.preds[off + t0 + 32 * r] = float(acc_p[r]);
  }
  if (a.clocks != nullptr && lane == 0) {
    long long* out = a.clocks + size_t(row) * kStPhases;
    out[0] = c1 - c0;
    out[1] = c2 - c1;
    out[2] = clock64() - c2;
  }
}

cudaError_t st_launch(int NB, const StArgs& a, size_t smem, cudaStream_t s) {
  void (*k)(StArgs) = NB == 1   ? st_fit_kernel<1>
                      : NB == 2 ? st_fit_kernel<2>
                      : NB == 3 ? st_fit_kernel<3>
                      : NB == 4 ? st_fit_kernel<4>
                                : st_fit_kernel<5>;
  const cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  k<<<(a.B + kStWarps - 1) / kStWarps, kStWarps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cta path: D > kMaxStD columns (Prophet's defaults, 25 changepoints and
// order 10, give D = 47), a CTA a row
// ---------------------------------------------------------------------------
// A persistent CTA of kStCtaThreads threads walks rows grid-stride:
//   1. kStCtaThreads slots a round, a slot a thread: the selected ones
//      (ballots, then the warps' counts) build their rows [X x] as the warp
//      path does (st_row) into the CTA's tile, compacted, padded with zero
//      columns to 8 NB and with zero rows to a multiple of 4;
//   2. the gram's 8 x 8 blocks (b1 <= b2) dealt to the warps in turn, each
//      block's products over the round's rows on DMMA m8n8k4 (lane (g, t)
//      reads column 8 b + g of row t for each operand), added to G once a
//      round; G ((8 NB)^2 doubles, the augmented gram in its upper
//      triangle, rhs in column D) lives in shared memory while it fits
//      beside the tile, else in the CTA's slice of device scratch;
//   3. a left-looking Cholesky by the CTA (column j: the threads over rows
//      i >= j, two barriers), L written into G's strict lower triangle as
//      in the warp path, the triangular solves by warp 0; the IRLS rounds
//      change only the penalty; a non-positive (or NaN) pivot gives the row
//      NaN, as the twin's cholesky_ex does;
//   4. preds a thread a slot, summed as the warp path sums them.
// The sums of the gram and the solve run in another order than the warp
// path's; the results are held to the twin (float64), not to the warp path.
// Bound, as the warp path: (D + 1)(D + 2) / 2 - 1 float64 multiply-adds a
// fitted slot (1,175 at D = 47) at the float64 tensor cores' rate; this
// path does 64 NB (NB + 1) / 2 a fitted slot (1,344 at D = 47) and is not
// tuned.
constexpr int kStCtaThreads = 128;
constexpr int kStCtaWarps = kStCtaThreads / 32;

struct StCtaMem {
  double* G;     // (8 NB) x (8 NB)
  double* pen;   // 8 NB each, from here on
  double* ldiag;
  double* tmp;
  double* beta;
  double* y;
  float* knot;   // C
  float* ck;     // order
  float* tile;   // kStCtaThreads rows of st_tile_ld(D) floats
  int* wcnt;     // kStCtaWarps
};

__host__ __device__ inline int st_cta_ldg(int D) { return (D + 8) / 8 * 8; }

__host__ __device__ inline size_t st_cta_g_bytes(int D) {
  return size_t(st_cta_ldg(D)) * st_cta_ldg(D) * 8;
}

// shared bytes besides G
__host__ __device__ inline size_t st_cta_rest_bytes(int D, int C, int K) {
  return size_t(5) * st_cta_ldg(D) * 8 +
         (size_t(C) + K + size_t(kStCtaThreads) * st_tile_ld(D) + kStCtaWarps) * 4;
}

// whether G takes shared memory (else device scratch) on a card whose CTA
// may take `most` bytes of it
__host__ inline bool st_cta_g_shared(int D, int C, int K, size_t most) {
  return st_cta_g_bytes(D) + st_cta_rest_bytes(D, C, K) <= most;
}

__device__ inline StCtaMem st_cta_mem(unsigned char* base, double* g_global, int D, int C,
                                      int K) {
  StCtaMem m;
  const int ldg = st_cta_ldg(D);
  double* d = reinterpret_cast<double*>(base);
  if (g_global != nullptr) {
    m.G = g_global;
  } else {
    m.G = d;
    d += size_t(ldg) * ldg;
  }
  m.pen = d;
  m.ldiag = m.pen + ldg;
  m.tmp = m.ldiag + ldg;
  m.beta = m.tmp + ldg;
  m.y = m.beta + ldg;
  m.knot = reinterpret_cast<float*>(m.y + ldg);
  m.ck = m.knot + C;
  m.tile = m.ck + K;
  m.wcnt = reinterpret_cast<int*>(m.tile + kStCtaThreads * st_tile_ld(D));
  return m;
}

// (G + diag(pen)) beta = rhs by the CTA: G's upper triangle and diagonal
// in, L in its strict lower triangle and ldiag, rhs in G's column D; beta
// (or NaN) into m.beta. Returns false (every thread) on a pivot that is not
// positive.
__device__ bool st_cta_solve(const StCtaMem& m, int D) {
  const int ldg = st_cta_ldg(D), tid = threadIdx.x;
  double* G = m.G;
  bool ok = true;
  for (int j = 0; j < D; ++j) {
    for (int i = j + tid; i < D; i += kStCtaThreads) {
      double s = i == j ? G[size_t(j) * ldg + j] + m.pen[j] : G[size_t(j) * ldg + i];
      for (int k = 0; k < j; ++k) s -= G[size_t(i) * ldg + k] * G[size_t(j) * ldg + k];
      m.tmp[i] = s;
    }
    __syncthreads();
    const double piv = m.tmp[j];
    ok = ok && piv > 0.0;
    const double ljj = sqrt(piv);
    for (int i = j + tid; i < D; i += kStCtaThreads) {
      if (i == j) m.ldiag[j] = ljj;
      else G[size_t(i) * ldg + j] = m.tmp[i] / ljj;
    }
    __syncthreads();
  }
  if (tid < 32) {
    const int lane = tid;
    // L y = rhs, then L^T beta = y, a column at a time
    for (int i = lane; i < D; i += 32) m.y[i] = G[size_t(i) * ldg + D];
    __syncwarp();
    for (int k = 0; k < D; ++k) {
      const double yk = m.y[k] / m.ldiag[k];
      __syncwarp();
      if (lane == 0) m.y[k] = yk;
      for (int i = k + 1 + lane; i < D; i += 32) m.y[i] -= G[size_t(i) * ldg + k] * yk;
      __syncwarp();
    }
    for (int k = D - 1; k >= 0; --k) {
      const double bk = m.y[k] / m.ldiag[k];
      __syncwarp();
      if (lane == 0) m.y[k] = bk;
      for (int i = lane; i < k; i += 32) m.y[i] -= G[size_t(k) * ldg + i] * bk;
      __syncwarp();
    }
    for (int i = lane; i < D; i += 32) m.beta[i] = ok ? m.y[i] : CUDART_NAN;
  }
  __syncthreads();
  return ok;
}

__global__ void __launch_bounds__(kStCtaThreads) st_fit_cta_kernel(StArgs a, double* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, C = a.C, K = a.order, D = 2 + C + 2 * K;
  const int ldg = st_cta_ldg(D), NB = ldg / 8, ldx = st_tile_ld(D);
  const StCtaMem m = st_cta_mem(
      smem, scratch == nullptr ? nullptr : scratch + size_t(blockIdx.x) * ldg * ldg, D, C, K);
  const float inv_t = 1.0f / float(T - 1 > 1 ? T - 1 : 1);
  const int g = lane >> 2, t4 = lane & 3;
  for (int j = tid; j < C; j += kStCtaThreads)
    m.knot[j] = (float(j + 1) * (1.0f / float(C + 1))) * 0.8f;

  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    const size_t off = size_t(row) * T;
    const long long c0 = clock64();
    for (int k = tid; k < K; k += kStCtaThreads)
      m.ck[k] = (6.2831855f * (1.0f / float(a.period[row]))) * float(k + 1);
    for (int i = tid; i < ldg * ldg; i += kStCtaThreads) m.G[i] = 0.0;
    __syncthreads();

    // 1-2. the gram, kStCtaThreads slots a round
    for (int base = 0; base < T; base += kStCtaThreads) {
      const int t = base + tid;
      const bool sel = t < T && a.mask[off + t] && a.fit[off + t];
      const float xv = sel ? a.x[off + t] : 0.0f;
      const unsigned bal = __ballot_sync(kFullWarp, sel);
      if (lane == 0) m.wcnt[warp] = __popc(bal);
      __syncthreads();
      int before = 0, n = 0;
      for (int w = 0; w < kStCtaWarps; ++w) {
        before += w < warp ? m.wcnt[w] : 0;
        n += m.wcnt[w];
      }
      if (n == 0) {
        __syncthreads();  // before the next round's counts
        continue;
      }
      if (sel) {
        float* r = m.tile + (before + __popc(bal & ((1u << lane) - 1u))) * ldx;
        st_row_cols(m.knot, m.ck, C, K, t, xv, inv_t, r);
        for (int c = D + 1; c < 8 * NB; ++c) r[c] = 0.0f;
      }
      for (int i = tid; i < ((4 - n) & 3) * ldx; i += kStCtaThreads) m.tile[n * ldx + i] = 0.0f;
      __syncthreads();
      int u = 0;
      for (int b2 = 0; b2 < NB; ++b2)
        for (int b1 = 0; b1 <= b2; ++b1, ++u) {
          if (u % kStCtaWarps != warp) continue;
          double acc[2] = {0.0, 0.0};
          for (int j = 0; j < n; j += 4) {
            const float* r = m.tile + (j + t4) * ldx + g;
            const double va = double(r[8 * b1]), vb = double(r[8 * b2]);
            mma_f64_m8n8k4(acc, &va, &vb);
          }
          double* out = m.G + size_t(8 * b1 + g) * ldg + 8 * b2 + 2 * t4;
          out[0] += acc[0];
          out[1] += acc[1];
        }
      __syncthreads();  // before the next round's rows overwrite the tile
    }
    const long long c1 = clock64();

    // 3. the solves
    for (int p = tid; p < D; p += kStCtaThreads)
      m.pen[p] = a.ridge + (p >= 2 && p < 2 + C ? a.cp_shrink : 0.0);
    __syncthreads();
    bool ok = st_cta_solve(m, D);
    const int rounds = C > 0 ? (a.l1_iters - 1 > 0 ? a.l1_iters - 1 : 0) : 0;
    for (int it = 0; it < rounds && ok; ++it) {
      for (int p = tid; p < D; p += kStCtaThreads) {
        const bool cp = p >= 2 && p < 2 + C;
        m.pen[p] = a.ridge + a.cp_shrink * (cp ? 1.0 : 0.0) / (fabs(m.beta[p]) + 1e-3);
      }
      __syncthreads();
      ok = st_cta_solve(m, D);
    }
    for (int p = tid; p < D; p += kStCtaThreads) {
      if (!ok) m.beta[p] = CUDART_NAN;
      a.beta[size_t(row) * D + p] = float(ok ? m.beta[p] : CUDART_NAN);
    }
    __syncthreads();
    const long long c2 = clock64();

    // 4. preds, a slot a thread, in the warp path's order of terms
    for (int t = tid; t < T; t += kStCtaThreads) {
      const float tf = float(t), tn = tf * inv_t;
      double acc = fma(double(tn), m.beta[1], m.beta[0]);
      for (int j = 0; j < C; ++j) acc = fma(double(fmaxf(tn - m.knot[j], 0.0f)), m.beta[2 + j], acc);
      for (int k = 0; k < K; ++k) {
        float sv, cv;
        st_sin_cos(tf * m.ck[k], sv, cv);
        acc = fma(double(cv), m.beta[3 + C + 2 * k], fma(double(sv), m.beta[2 + C + 2 * k], acc));
      }
      a.preds[off + t] = float(acc);
    }
    if (a.clocks != nullptr && tid == 0) {
      long long* out = a.clocks + size_t(row) * kStPhases;
      out[0] = c1 - c0;
      out[1] = c2 - c1;
      out[2] = clock64() - c2;
    }
    __syncthreads();  // before the next row's constants and G
  }
}

// Counts the float32 arguments (all 2^32 bit patterns) at which sincosf's
// sine or cosine differs in its bits from sinf's or cosf's: kernel J takes
// both from one sincosf on the premise that the count is 0.
__global__ void st_sincos_check_kernel(unsigned long long* mismatches) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += size_t(gridDim.x) * blockDim.x) {
    const float v = __uint_as_float(unsigned(i));
    float s, c;
    sincosf(v, &s, &c);
    const float s1 = sinf(v), c1 = cosf(v);
    const bool same_s = __float_as_uint(s) == __float_as_uint(s1) || (s != s && s1 != s1);
    const bool same_c = __float_as_uint(c) == __float_as_uint(c1) || (c != c && c1 != c1);
    n += !(same_s && same_c);
  }
  if (n) atomicAdd(mismatches, n);
}

}  // namespace fm

extern "C" int fm_st_fit(const float* x, const uint8_t* mask, const uint8_t* fit,
                         const int* period, int order, int C, double ridge, double cp_shrink,
                         int l1_iters, int B, int T, float* beta, float* preds, long long* clocks,
                         void* stream) {
  const int D = 2 + C + 2 * order;
  if (order < 0 || C < 0 || D > fm::kMaxStD || T < 1) return int(cudaErrorInvalidValue);
  fm::StArgs a{x, mask, fit, period, B, T, C, order, l1_iters, ridge, cp_shrink, beta, preds,
               clocks};
  const size_t smem = size_t(fm::kStWarps) * fm::st_warp_bytes(D);
  return int(fm::st_launch((D + 1 + 7) / 8, a, smem, static_cast<cudaStream_t>(stream)));
}

extern "C" long long fm_st_cta_scratch_doubles(int order, int C) {
  const int D = 2 + C + 2 * order;
  return fm::st_cta_g_shared(D, C, order, 232448) ? 0LL
                                                   : (long long)fm::st_cta_ldg(D) * fm::st_cta_ldg(D);
}

// CTAs of the cta path for B rows: the card's resident CTAs, at most B
extern "C" int fm_st_cta_grid(int order, int C, int B) {
  const int D = 2 + C + 2 * order;
  const bool sh = fm::st_cta_g_shared(D, C, order, 232448);
  const size_t smem = fm::st_cta_rest_bytes(D, C, order) + (sh ? fm::st_cta_g_bytes(D) : 0);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(fm::st_fit_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fm::st_fit_cta_kernel,
                                                    fm::kStCtaThreads, smem) != cudaSuccess)
    return -1;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  return B < most ? B : most;
}

// The cta path (the launcher's choice above D = 32; any D when forced):
// grid persistent CTAs; scratch holds grid (8 NB)^2
// doubles where G does not fit shared memory (fm_st_cta_scratch_doubles),
// else null.
extern "C" int fm_st_fit_cta(const float* x, const uint8_t* mask, const uint8_t* fit,
                             const int* period, int order, int C, double ridge, double cp_shrink,
                             int l1_iters, int B, int T, float* beta, float* preds,
                             long long* clocks, double* scratch, int grid, void* stream) {
  const int D = 2 + C + 2 * order;
  if (order < 0 || C < 0 || T < 1 || grid < 1) return int(cudaErrorInvalidValue);
  const bool sh = fm::st_cta_g_shared(D, C, order, 232448);
  if (sh != (scratch == nullptr)) return int(cudaErrorInvalidValue);
  fm::StArgs a{x, mask, fit, period, B, T, C, order, l1_iters, ridge, cp_shrink, beta, preds,
               clocks};
  const size_t smem = fm::st_cta_rest_bytes(D, C, order) + (sh ? fm::st_cta_g_bytes(D) : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      fm::st_fit_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::st_fit_cta_kernel<<<grid, fm::kStCtaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, scratch);
  return int(cudaGetLastError());
}

extern "C" int fm_st_sincos_check(unsigned long long* mismatches, void* stream) {
  fm::st_sincos_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      mismatches);
  return int(cudaGetLastError());
}
