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
// Two-pass statistics, as the reference computes them: float32 centred
// products summed in float64 (a single pass of x^2 sums would lose the
// variance of a metric at a high level). So the row is read from device
// memory once and kept on chip for the second and third pass: x1 and x2 and
// the three mask bytes, 11 B a slot.
//
// What bounds it on an H100: bytes. A row reads 11 B a slot (two floats,
// three masks) and writes 5 B (d2, flags) against ~27 operations a slot,
// far below the card's balance point: 7.8 ms at B = 100k rows of
// T = 16384, 1.0 ms at the engine's bucket T = 2048. The design keeps
// that traffic in flight:
// - a CTA stages a slice of at most kernels.BI_SLICE_T = 4096 slots (45 KB) with
//   cp.async, 16 B a copy where the rows allow it, so that an SM holds
//   four CTAs (at most 64 registers a thread), some loading while others
//   compute;
// - a row up to BI_SLICE_T slots is one CTA ("cta" path); a longer row is a
//   thread block cluster of ceil(T / BI_SLICE_T) CTAs ("cluster" path), each
//   staging its slice (the launcher passes the CTAs a row, cl); the three
//   reductions of a row (the sums, the centred moments, the counts) cross
//   the cluster through distributed shared memory, each CTA pushing its
//   totals to the others before one cluster barrier a reduction (the first
//   push waits on an arrival made at the kernel's start, so every CTA of
//   the cluster has started, behind the staging);
// - the passes read four slots a thread at a time (float4 and 32-bit mask
//   words from shared memory) and write d2 16 B and the flags 4 B at a time;
// - a CTA's totals are warp_sum_scatter's (three float64 sums and a pad,
//   one butterfly), then the warps' in warp order, then the CTAs' in rank
//   order: every CTA of a cluster adds them alike and holds the same
//   statistics.
// The slot sets of the sums differ from the first design's (one slot a
// thread), so a row's float64 sums may round differently in their last
// bits (they do not where the float32 terms' sum is exact in float64, as on
// chip_smoke.py's family rows); every output is held to the twin within
// chip_smoke's compare_bivariate.
#include "common.cuh"

namespace fm {

constexpr int kBiThreads = 256;
constexpr int kBiWarps = kBiThreads / 32;
constexpr int kBiMaxCluster = 8;  // kernels.BI_MAX_CLUSTER
constexpr uint8_t kJoint = 1, kRegion = 2;
// kernels.BI_PHASES: staging and the sums, the centred moments, d2 and the
// flags, every reduction (block, and cluster where there is one)
constexpr int kBiPhases = 4;

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
  int cl;             // CTAs a row
  int S;              // slots a CTA stages (a multiple of 16)
  uint8_t* flags;
  float* d2;
  int* count;
  int* first_index;
  int* checked;
  float* upper1;
  float* lower1;
  float* upper2;
  float* lower2;
  long long* clocks;  // null, or (B, kBiPhases) SM cycles rank 0's thread 0 spent per phase
};

// The scratch at the head of a CTA's dynamic shared memory (the emulator
// keeps a cluster's CTAs apart only there): the warps' totals, and each
// reduction's inbox, one row a CTA of the cluster (written by that CTA).
struct BiScratch {
  double warp[kBiWarps][4];
  double sums[kBiMaxCluster][4];
  double moments[kBiMaxCluster][4];
  int counts[kBiMaxCluster][4];
};
constexpr int kBiScratchBytes = (int(sizeof(BiScratch)) + 15) & ~15;

__host__ __device__ inline int bi_slice(int T, int cl) { return ((T + cl - 1) / cl + 15) & ~15; }
__host__ __device__ inline size_t bi_smem_bytes(int T, int cl) {
  return size_t(kBiScratchBytes) + size_t(bi_slice(T, cl)) * 11;
}

// the reference's `directional`: an excursion of sign dev passes when the
// metric's bound mode (0 read as 3) enables that side
__device__ __forceinline__ bool directional(float dev, int mode) {
  const int md = mode == 0 ? 3 : mode;
  return (dev > 0.0f && (md & 1) > 0) || (dev < 0.0f && (md & 2) > 0);
}

// The row's totals of v[4] in every thread: the CTA's (warp_sum_scatter,
// then the warps in order), then on the cluster path every CTA's pushed to
// each CTA's inbox and added in rank order after one cluster barrier.
template <bool CLUSTER>
__device__ __forceinline__ void row_sum4(double (&v)[4], BiScratch* sc, double (*inbox)[4],
                                         int cl, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double t = warp_sum_scatter<4>(v);  // the warp's total of value lane >> 3
  if ((lane & 7) == 0) sc->warp[warp][lane >> 3] = t;
  __syncthreads();
  if (threadIdx.x < 4) {
    double r = sc->warp[0][threadIdx.x];
    for (int w = 1; w < kBiWarps; ++w) r += sc->warp[w][threadIdx.x];
    if constexpr (CLUSTER) {
      for (int c = 0; c < cl; ++c) *cluster_map(&inbox[rank][threadIdx.x], unsigned(c)) = r;
    } else {
      inbox[0][threadIdx.x] = r;
    }
  }
  if constexpr (CLUSTER) {
    cluster_sync();
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    double r = inbox[0][k];
    for (int c = 1; c < cl; ++c) r += inbox[c][k];
    v[k] = r;
  }
}

// VEC: the rows allow 16-byte copies and four slots a thread (T a
// multiple of 16, every pointer 16-byte aligned); else a slot a thread.
template <bool CLUSTER, bool VEC>
__global__ void __launch_bounds__(kBiThreads, 4) bivariate_kernel(BiArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  BiScratch* sc = reinterpret_cast<BiScratch*>(smem);
  const int tid = threadIdx.x, nt = kBiThreads;
  const int cl = CLUSTER ? a.cl : 1;
  const int rank = CLUSTER ? int(cluster_ctarank()) : 0;
  // paired with the wait before the first push: no CTA writes into another
  // CTA's shared memory before that CTA has started
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  const int row = blockIdx.x / cl, T = a.T, S = a.S;
  const int lo = rank * S;
  const int L = max(0, min(S, T - lo));  // this CTA's slots [lo, lo + L)
  const size_t off = size_t(row) * T + lo;
  float* sx1 = reinterpret_cast<float*>(smem + kBiScratchBytes);
  float* sx2 = sx1 + S;
  uint8_t* sm1 = reinterpret_cast<uint8_t*>(sx2 + S);  // m1, then the slot's code
  uint8_t* sm2 = sm1 + S;
  uint8_t* srg = sm2 + S;
  long long cyc[kBiPhases] = {0, 0, 0, 0};
  long long c_prev = clock64();
  const bool timed = a.clocks != nullptr && rank == 0;
  auto lap = [&](int k) {
    if (timed) {
      const long long c = clock64();
      cyc[k] += c - c_prev;
      c_prev = c;
    }
  };

  // 1. stage the slice; n and the sums over the history
  if constexpr (VEC) {
    for (int i = tid; i < L / 4; i += nt) {
      cp_async16(sx1 + 4 * i, a.x1 + off + 4 * i);
      cp_async16(sx2 + 4 * i, a.x2 + off + 4 * i);
    }
    for (int i = tid; i < L / 16; i += nt) {
      cp_async16(sm1 + 16 * i, a.m1 + off + 16 * i);
      cp_async16(sm2 + 16 * i, a.m2 + off + 16 * i);
      cp_async16(srg + 16 * i, a.region + off + 16 * i);
    }
  } else {
    for (int t = tid; t < L; t += nt) {
      cp_async4(sx1 + t, a.x1 + off + t);
      cp_async4(sx2 + t, a.x2 + off + t);
      sm1[t] = a.m1[off + t];
      sm2[t] = a.m2[off + t];
      srg[t] = a.region[off + t];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  double s[4] = {0.0, 0.0, 0.0, 0.0};  // n, sum x1, sum x2, a pad
  if constexpr (VEC) {
    for (int q = tid; q < L / 4; q += nt) {
      const float4 v1 = reinterpret_cast<const float4*>(sx1)[q];
      const float4 v2 = reinterpret_cast<const float4*>(sx2)[q];
      // bool bytes are 0 or 1: a byte's code is joint | region << 1
      const uint32_t j = reinterpret_cast<const uint32_t*>(sm1)[q] &
                         reinterpret_cast<const uint32_t*>(sm2)[q];
      const uint32_t r = reinterpret_cast<const uint32_t*>(srg)[q];
      reinterpret_cast<uint32_t*>(sm1)[q] = j | (r << 1);
      const uint32_t h = j & ~r;
      const float a1[4] = {v1.x, v1.y, v1.z, v1.w}, a2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((h >> (8 * k)) & 1u) {
          s[0] += 1.0;
          s[1] += double(a1[k]);
          s[2] += double(a2[k]);
        }
      }
    }
  } else {
    for (int t = tid; t < L; t += nt) {
      const bool joint = sm1[t] && sm2[t];
      const bool reg = srg[t];
      sm1[t] = (joint ? kJoint : 0) | (reg ? kRegion : 0);
      if (joint && !reg) {
        s[0] += 1.0;
        s[1] += double(sx1[t]);
        s[2] += double(sx2[t]);
      }
    }
  }
  lap(0);
  if constexpr (CLUSTER) cluster_wait();
  row_sum4<CLUSTER>(s, sc, sc->sums, cl, rank);
  lap(3);
  const float n = float(s[0]);
  const float denom = fmaxf(n, 1.0f);
  const float mu1 = float(s[1]) / denom;
  const float mu2 = float(s[2]) / denom;

  // 2. centred second moments
  double q[4] = {0.0, 0.0, 0.0, 0.0};  // sum d1^2, sum d2^2, sum d1 d2, a pad
  auto moment = [&](float v1, float v2) {
    const float d1 = v1 - mu1;
    const float e2 = v2 - mu2;
    q[0] += double(d1 * d1);
    q[1] += double(e2 * e2);
    q[2] += double(d1 * e2);
  };
  if constexpr (VEC) {
    for (int i = tid; i < L / 4; i += nt) {
      const float4 v1 = reinterpret_cast<const float4*>(sx1)[i];
      const float4 v2 = reinterpret_cast<const float4*>(sx2)[i];
      const uint32_t c = reinterpret_cast<const uint32_t*>(sm1)[i];
      const float a1[4] = {v1.x, v1.y, v1.z, v1.w}, a2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (((c >> (8 * k)) & 0xffu) == kJoint) moment(a1[k], a2[k]);
      }
    }
  } else {
    for (int t = tid; t < L; t += nt) {
      if (sm1[t] == kJoint) moment(sx1[t], sx2[t]);  // joint and not region: the history
    }
  }
  lap(1);
  row_sum4<CLUSTER>(q, sc, sc->moments, cl, rank);
  lap(3);
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
  auto slot = [&](float v1, float v2, unsigned code, int t, float& d2) {
    const float av = v1 - mu1;
    const float bv = v2 - mu2;
    d2 = (var2 * av * av - 2.0f * cov * av * bv + var1 * bv * bv) / det;
    const bool chk = code == (kJoint | kRegion);
    bool flag = chk && enough && d2 > thr2;
    if (directed) flag = flag && (directional(av, mode1) || directional(bv, mode2));
    count += flag;
    checked += chk;
    if (flag) first = min(first, t);
    return flag;
  };
  if constexpr (VEC) {
    for (int i = tid; i < L / 4; i += nt) {
      const float4 v1 = reinterpret_cast<const float4*>(sx1)[i];
      const float4 v2 = reinterpret_cast<const float4*>(sx2)[i];
      const uint32_t c = reinterpret_cast<const uint32_t*>(sm1)[i];
      const float a1[4] = {v1.x, v1.y, v1.z, v1.w}, a2[4] = {v2.x, v2.y, v2.z, v2.w};
      float d[4];
      uint32_t f = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f |= uint32_t(slot(a1[k], a2[k], (c >> (8 * k)) & 0xffu, lo + 4 * i + k, d[k])) << (8 * k);
      }
      reinterpret_cast<float4*>(a.d2 + off)[i] = make_float4(d[0], d[1], d[2], d[3]);
      reinterpret_cast<uint32_t*>(a.flags + off)[i] = f;
    }
  } else {
    for (int t = tid; t < L; t += nt) {
      float d;
      a.flags[off + t] = slot(sx1[t], sx2[t], sm1[t], lo + t, d);
      a.d2[off + t] = d;
    }
  }
  lap(2);
  // count, checked, first: warps, then the warps in order, then (cluster)
  // rank 0 adds the CTAs' in rank order
  count = warp_sum(count);
  checked = warp_sum(checked);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kFullWarp, first, o));
  int* wi = reinterpret_cast<int*>(sc->warp);
  if ((tid & 31) == 0) {
    wi[4 * (tid >> 5)] = count;
    wi[4 * (tid >> 5) + 1] = checked;
    wi[4 * (tid >> 5) + 2] = first;
  }
  __syncthreads();
  if (tid == 0) {
    int c = wi[0], k = wi[1], f = wi[2];
    for (int w = 1; w < kBiWarps; ++w) {
      c += wi[4 * w];
      k += wi[4 * w + 1];
      f = min(f, wi[4 * w + 2]);
    }
    if constexpr (CLUSTER) {
      int* dst = cluster_map(&sc->counts[rank][0], 0u);
      dst[0] = c;
      dst[1] = k;
      dst[2] = f;
    } else {
      sc->counts[0][0] = c;
      sc->counts[0][1] = k;
      sc->counts[0][2] = f;
    }
  }
  if constexpr (CLUSTER) cluster_sync();
  lap(3);
  if (tid == 0 && rank == 0) {
    count = 0;
    checked = 0;
    first = T;
    for (int c = 0; c < cl; ++c) {
      count += sc->counts[c][0];
      checked += sc->counts[c][1];
      first = min(first, sc->counts[c][2]);
    }
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
    if (timed) {
      for (int k = 0; k < kBiPhases; ++k) a.clocks[size_t(row) * kBiPhases + k] = cyc[k];
    }
  }
}

template <bool CLUSTER, bool VEC>
cudaError_t bivariate_launch(const BiArgs& a, int B, size_t smem, cudaStream_t st) {
  auto kernel = bivariate_kernel<CLUSTER, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return e;
  if constexpr (CLUSTER) {
    return launch_cluster(kernel, B * a.cl, kBiThreads, smem, st, a.cl, a);
  } else {
    bivariate_kernel<CLUSTER, VEC><<<B, kBiThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
}

}  // namespace fm

// dynamic shared memory of a CTA when a row of T slots is cl CTAs
extern "C" long long fm_bivariate_smem_bytes(int T, int cl) {
  return (long long)fm::bi_smem_bytes(T, cl);
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

extern "C" int fm_bivariate(const float* x1, const uint8_t* m1, const float* x2,
                            const uint8_t* m2, const uint8_t* region, const float* threshold,
                            const float* mlb1, const float* mlb2, const int* bm1, const int* bm2,
                            int B, int T, int cl, uint8_t* flags, float* d2, int* count,
                            int* first_index, int* checked, float* upper1, float* lower1,
                            float* upper2, float* lower2, long long* clocks, void* stream) {
  if (cl < 1 || cl > fm::kBiMaxCluster) return int(cudaErrorInvalidValue);
  fm::BiArgs a{x1, m1, x2, m2, region, threshold, mlb1, mlb2, bm1, bm2, T, cl,
               fm::bi_slice(T, cl), flags, d2, count, first_index, checked, upper1, lower1,
               upper2, lower2, clocks};
  const size_t smem = fm::bi_smem_bytes(T, cl);
  const bool vec = T % 16 == 0 && aligned16(x1) && aligned16(x2) && aligned16(m1) &&
                   aligned16(m2) && aligned16(region) && aligned16(flags) && aligned16(d2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cl > 1) {
    e = vec ? fm::bivariate_launch<true, true>(a, B, smem, st)
            : fm::bivariate_launch<true, false>(a, B, smem, st);
  } else {
    e = vec ? fm::bivariate_launch<false, true>(a, B, smem, st)
            : fm::bivariate_launch<false, false>(a, B, smem, st);
  }
  return int(e);
}
