// Kernel H: the bivariate-normal ellipse of the two-metric family, one
// launch for B rows.
//
// Replaces the reference's ops/bivariate.py `bivariate_normal_anomalies`
// (:26, one jitted XLA program): per row, a 2-D Gaussian fit on the joint
// history (m1 & m2 & ~region): n, the means, the 2x2 covariance with the
// ridge 1e-6 * max(var1, var2, 1), det = max(var1 var2 - cov^2, 1e-12); the
// squared Mahalanobis distance d2 at every slot by the analytic 2x2
// inverse; flags where d2 > threshold^2 on a joint slot of the region of a
// row with n >= 2, kept (when both bound modes are given) only if one
// metric's excursion direction is enabled by its ML_BOUND bitmask (0 read
// as both); count, first index (-1 if none) and checked (joint & region);
// and the marginal bands mu +- threshold sqrt(var), the lower ones floored
// at min_lower_bound when it is given. The float32 expressions are the
// reference's, in its order (-fmad=false keeps each rounding), so where the
// sums agree every output agrees.
//
// The reference writes its masked sums as x * w (w = 1.0 on a history
// slot, 0.0 elsewhere), which XLA's algebraic simplifier compiles to a
// select: a NaN or inf at a masked slot never reaches its sums (the JAX
// reference gives the same statistics with or without it). The sums here
// skip masked slots, which is that select. d2 itself is computed from the
// raw values at every slot, as there. (The engine's packers leave masked
// slots finite anyway: resample_to_grid and the zero padding.)
//
// Design: one CTA of kBiThreads threads per row, the row staged once in
// shared memory: x1 and x2 (8 B a slot) and one byte of flags (joint,
// region), 9 B a slot, 144 KB at T = 16384, the largest bucket.
//   1. load and stage the row; sum n and the history values of both
//      metrics (float64 accumulators, one block reduction for all three);
//   2. from shared memory, the centred squares and cross products
//      (float32 products as the reference forms them, float64 sums);
//   3. from shared memory, d2 and the flags of every slot, written once,
//      with the count, first index and checked; thread 0 writes the bands
//      as (B,) values: they are constant in t, and the entry point expands
//      them to the reference's (B, T) without memory.
// Two-pass statistics, as the reference computes them: a single pass of
// x^2 sums would lose the variance of a metric at a high level.
//
// What bounds it on an H100: bytes. A row reads 11 B a slot (two floats,
// three masks) and writes 5 B (d2, flags) against ~20 operations a slot,
// far below the card's balance point; at B = 100k rows of the engine's
// bucket T = 2048 that is ~3.3 GB, ~1 ms at 3.35 TB/s. Staging keeps the
// three passes to one read of device memory.
#include "common.cuh"

namespace fm {

constexpr int kBiThreads = 256;
constexpr uint8_t kJoint = 1, kRegion = 2;

struct BiArgs {
  const float* x1;
  const uint8_t* m1;
  const float* x2;
  const uint8_t* m2;
  const uint8_t* region;
  const float* threshold;
  const float* mlb1;  // optional (null: no floor)
  const float* mlb2;
  const int* bm1;     // optional (null: no direction filter)
  const int* bm2;
  int T;
  uint8_t* flags;
  float* d2;
  int* count;
  int* first_index;
  int* checked;
  float* upper1;
  float* lower1;
  float* upper2;
  float* lower2;
};

// the reference's `directional`: an excursion of sign dev passes when the
// metric's bound mode (0 read as 3) enables that side
__device__ __forceinline__ bool directional(float dev, int mode) {
  const int md = mode == 0 ? 3 : mode;
  return (dev > 0.0f && (md & 1) > 0) || (dev < 0.0f && (md & 2) > 0);
}

__global__ void __launch_bounds__(kBiThreads) bivariate_kernel(BiArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x, nt = blockDim.x;
  const size_t off = size_t(row) * T;
  float* sx1 = reinterpret_cast<float*>(smem);
  float* sx2 = sx1 + T;
  uint8_t* code = reinterpret_cast<uint8_t*>(sx2 + T);

  // 1. stage the row; n and the sums over the history
  double s[3] = {0.0, 0.0, 0.0};  // n, sum x1, sum x2
  for (int t = tid; t < T; t += nt) {
    const float v1 = a.x1[off + t], v2 = a.x2[off + t];
    const bool joint = a.m1[off + t] && a.m2[off + t];
    const bool reg = a.region[off + t];
    sx1[t] = v1;
    sx2[t] = v2;
    code[t] = (joint ? kJoint : 0) | (reg ? kRegion : 0);
    if (joint && !reg) {
      s[0] += 1.0;
      s[1] += double(v1);
      s[2] += double(v2);
    }
  }
  block_sum_n(s, scr);  // its barriers also publish the staged row
  const float n = float(s[0]);
  const float denom = fmaxf(n, 1.0f);
  const float mu1 = float(s[1]) / denom;
  const float mu2 = float(s[2]) / denom;

  // 2. centred second moments
  double q[3] = {0.0, 0.0, 0.0};  // sum d1^2, sum d2^2, sum d1 d2
  for (int t = tid; t < T; t += nt) {
    if (code[t] != kJoint) continue;  // joint and not region: the history
    const float d1 = sx1[t] - mu1;
    const float e2 = sx2[t] - mu2;
    q[0] += double(d1 * d1);
    q[1] += double(e2 * e2);
    q[2] += double(d1 * e2);
  }
  block_sum_n(q, scr);
  float var1 = float(q[0]) / denom;
  float var2 = float(q[1]) / denom;
  const float cov = float(q[2]) / denom;
  const float ridge = 1e-6f * nan_max(nan_max(var1, var2), 1.0f);
  var1 = var1 + ridge;
  var2 = var2 + ridge;
  const float det = nan_max(var1 * var2 - cov * cov, 1e-12f);

  // 3. d2 and the flags of every slot
  const float thr = a.threshold[row];
  const float thr2 = thr * thr;
  const bool enough = n >= 2.0f;
  const bool directed = a.bm1 != nullptr && a.bm2 != nullptr;
  const int mode1 = directed ? a.bm1[row] : 0, mode2 = directed ? a.bm2[row] : 0;
  int count = 0, checked = 0, first = T;
  for (int t = tid; t < T; t += nt) {
    const float av = sx1[t] - mu1;
    const float bv = sx2[t] - mu2;
    const float d2 = (var2 * av * av - 2.0f * cov * av * bv + var1 * bv * bv) / det;
    const bool chk = code[t] == (kJoint | kRegion);
    bool flag = chk && enough && d2 > thr2;
    if (directed) flag = flag && (directional(av, mode1) || directional(bv, mode2));
    a.d2[off + t] = d2;
    a.flags[off + t] = flag;
    count += flag;
    checked += chk;
    if (flag) first = min(first, t);
  }
  count = block_sum(count, scr);
  checked = block_sum(checked, scr);
  first = block_reduce(first, Min<int>(), scr);
  if (tid == 0) {
    a.count[row] = count;
    a.first_index[row] = count > 0 ? first : -1;
    a.checked[row] = checked;
    const float s1 = sqrtf(var1), s2 = sqrtf(var2);
    float lo1 = mu1 - thr * s1, lo2 = mu2 - thr * s2;
    if (a.mlb1 != nullptr) lo1 = nan_max(lo1, a.mlb1[row]);
    if (a.mlb2 != nullptr) lo2 = nan_max(lo2, a.mlb2[row]);
    a.upper1[row] = mu1 + thr * s1;
    a.lower1[row] = lo1;
    a.upper2[row] = mu2 + thr * s2;
    a.lower2[row] = lo2;
  }
}

}  // namespace fm

static size_t bivariate_smem(int T) { return size_t(T) * 9; }

extern "C" int fm_bivariate(const float* x1, const uint8_t* m1, const float* x2,
                            const uint8_t* m2, const uint8_t* region, const float* threshold,
                            const float* mlb1, const float* mlb2, const int* bm1, const int* bm2,
                            int B, int T, uint8_t* flags, float* d2, int* count,
                            int* first_index, int* checked, float* upper1, float* lower1,
                            float* upper2, float* lower2, void* stream) {
  fm::BiArgs a{x1, m1, x2, m2, region, threshold, mlb1, mlb2, bm1, bm2, T,
               flags, d2, count, first_index, checked, upper1, lower1, upper2, lower2};
  const size_t smem = bivariate_smem(T);
  cudaError_t e = cudaFuncSetAttribute(fm::bivariate_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::bivariate_kernel<<<B, fm::kBiThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
