// Kernel O: masked, tie-averaged ranks and the k-sample rank tests, three
// entries.
//
// Replaces the reference's jitted XLA programs:
//   - rank_and_ties: foremast_tpu/ops/ranks.py:rank_and_ties (:164, and
//     masked_rankdata :191 on it): each row's average ranks in input order
//     (0 at masked slots), its tie term sum(t^3 - t) and valid count;
//   - kruskal_groups: foremast_tpu/ops/pairwise.py:kruskal_batch (:527,
//     kruskal_wallis :294): the Kruskal-Wallis H of k masked groups and its
//     chi-square p at df = k - 1;
//   - friedman: foremast_tpu/ops/pairwise.py:friedman_batch (:528,
//     friedman_chi_square :325): the Friedman chi-square of n blocks x k
//     treatments over the masked-in blocks, and its p at df = k - 1.
//
// Design.
//   - rank_and_ties and kruskal_groups: one CTA per row sorts the row's keys
//     (T, or k T for the groups) with kernel A's bitonic sort. The key is
//     kernel A's rank key with its payload bit replaced by a 30-bit tag:
//     bits 63..32 the value as an order-preserving unsigned (masked slots and
//     NaN as +inf, -0.0 folded into +0.0), bits 31..30 the class (valid 0 <
//     valid NaN 1 < masked 2), bits 29..0 the slot's input position (ranks)
//     or its group (Kruskal). A tie group is a run of equal key >> 30. Block
//     scans give each sorted position its group's first and last position
//     (a max scan of group starts, a min scan of group ends over the
//     reversed order), so a rank is (first + last + 2) / 2 and every sum is
//     of integers: twice the ranks, exactly. Up to 8192 keys a row they live
//     in shared memory (16 B a key with the two scan arrays), above it in
//     device scratch, one slot per CTA walking rows grid-stride, as kernel
//     A does above T = 4096.
//   - Kruskal's per-group rank sums: one pass over the sorted positions per
//     group, a block sum each (k passes of k T positions; k is small). H and
//     its tie correction in float64, p = gammaincc((k - 1) / 2, H / 2) in
//     float64 (common.cuh).
//   - friedman needs no sort: an entry's rank within its block is
//     #less + (#equal + 1) / 2 under the same key order (ties and NaN as the
//     reference's rank_and_ties orders them), and the block's tie term is
//     the sum over its entries of #equal^2 - 1 (= sum over its tie groups of
//     t^3 - t). A CTA per row; up to 128 treatments, 128 / k threads share a
//     treatment and their partial sums meet in shared memory; above it a
//     thread owns treatments. No limit on k or n.
//
// What bounds it on an H100: the sorts' chains of block barriers
// (log2(n)^2 / 2 steps over n keys), not the bytes (a row's values and
// masks are read once); friedman's O(n k^2) compares at the fp32 issue
// rate. Many CTAs per SM at the north-star widths hide the barriers.
#include "common.cuh"

namespace fm {

constexpr int kRankThreads = 128;
constexpr int kTagBits = 30;
constexpr uint64_t kTagMask = (1ull << kTagBits) - 1;

__device__ __forceinline__ uint64_t tagged_key(float v, bool valid, uint32_t tag) {
  const uint64_t k = rank_key(v, valid, false);
  return (k & 0xffffffff00000000ull) | (((k >> 1) & 3ull) << kTagBits) | uint64_t(tag);
}
__device__ __forceinline__ uint64_t tag_group(uint64_t key) { return key >> kTagBits; }

// First and last sorted position of each valid position's tie group:
// first[p] by a max scan of group starts, last by a min scan of group ends
// over the reversed order (rev[j] is the end for position nvalid - 1 - j).
__device__ inline void group_bounds(const uint64_t* keys, int nvalid, int* first, int* rev,
                                    Scratch& s) {
  __syncthreads();
  for (int i = threadIdx.x; i < nvalid; i += blockDim.x) {
    first[i] = (i == 0 || tag_group(keys[i]) != tag_group(keys[i - 1])) ? i : 0;
    const int p = nvalid - 1 - i;
    rev[i] = (p == nvalid - 1 || tag_group(keys[p]) != tag_group(keys[p + 1])) ? p : 0x7fffffff;
  }
  block_scan(first, nvalid, Max<int>(), 0, s);
  block_scan(rev, nvalid, Min<int>(), 0x7fffffff, s);
}

struct RankArgs {
  const float* values;
  const uint8_t* mask;
  int B, T;
  float* ranks;  // (B, T)
  float* tie;    // (B,)
  float* n_valid;
  unsigned char* scratch;
  size_t scratch_stride;
};

__device__ void rank_row(const RankArgs& a, int row, unsigned char* work, Scratch& scr) {
  const int T = a.T, n_sort = next_pow2(T);
  const float* v = a.values + size_t(row) * T;
  const uint8_t* m = a.mask + size_t(row) * T;
  float* out = a.ranks + size_t(row) * T;
  uint64_t* keys = reinterpret_cast<uint64_t*>(work);
  int* first = reinterpret_cast<int*>(keys + n_sort);
  int* rev = first + n_sort;
  int nv = 0;
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
    keys[i] = i < T ? tagged_key(v[i], m[i], uint32_t(i)) : kPadKey;
    nv += i < T && m[i];
  }
  const int nvalid = block_sum(nv, scr);
  bitonic_sort(keys, n_sort);
  group_bounds(keys, nvalid, first, rev, scr);
  long long tie = 0;
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const uint32_t at = uint32_t(keys[p] & kTagMask);
    if (p >= nvalid) {
      out[at] = 0.0f;
      continue;
    }
    const int b = first[p], e = rev[nvalid - 1 - p];
    out[at] = float(b + e + 2) * 0.5f;
    if (p == e) {
      const long long t = e - b + 1;
      tie += t * t * t - t;
    }
  }
  tie = block_sum(tie, scr);
  if (threadIdx.x == 0) {
    a.tie[row] = float(tie);
    a.n_valid[row] = float(nvalid);
  }
  __syncthreads();  // the next row (grid-stride) reuses work
}

struct KruskalArgs {
  const float* groups;  // (B, k, T)
  const uint8_t* masks;
  int B, k, T;
  float* H;
  float* p;
  unsigned char* scratch;
  size_t scratch_stride;
};

__device__ void kruskal_row(const KruskalArgs& a, int row, unsigned char* work, Scratch& scr) {
  const int k = a.k, T = a.T, n = k * T, n_sort = next_pow2(n);
  const float* v = a.groups + size_t(row) * n;
  const uint8_t* m = a.masks + size_t(row) * n;
  uint64_t* keys = reinterpret_cast<uint64_t*>(work);
  int* first = reinterpret_cast<int*>(keys + n_sort);
  int* rev = first + n_sort;
  int nv = 0;
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
    keys[i] = i < n ? tagged_key(v[i], m[i], uint32_t(i / T)) : kPadKey;
    nv += i < n && m[i];
  }
  const int nvalid = block_sum(nv, scr);
  bitonic_sort(keys, n_sort);
  group_bounds(keys, nvalid, first, rev, scr);
  long long tie = 0;
  for (int p = threadIdx.x; p < nvalid; p += blockDim.x) {
    const int b = first[p], e = rev[nvalid - 1 - p];
    if (p == e) {
      const long long t = e - b + 1;
      tie += t * t * t - t;
    }
  }
  tie = block_sum(tie, scr);
  // sum over groups of R_g^2 / n_g, with R_g = (sum of twice the ranks) / 2
  double ssq = 0.0;
  for (int grp = 0; grp < k; ++grp) {
    long long r2 = 0;
    int cnt = 0;
    for (int p = threadIdx.x; p < nvalid; p += blockDim.x) {
      if (int(keys[p] & kTagMask) != grp) continue;
      r2 += first[p] + rev[nvalid - 1 - p] + 2;
      cnt += 1;
    }
    r2 = block_sum(r2, scr);
    cnt = block_sum(cnt, scr);
    const double R = double(r2) * 0.5;
    ssq += R * R / (cnt == 0 ? 1.0 : double(cnt));
  }
  if (threadIdx.x == 0) {
    const double N = nvalid;
    double H = (N * (N + 1.0) == 0.0 ? 12.0 : 12.0 / (N * (N + 1.0))) * ssq - 3.0 * (N + 1.0);
    const double denom = N * N * N - N;
    const double corr = 1.0 - double(tie) / (denom == 0.0 ? 1.0 : denom);
    H = H / (corr == 0.0 ? 1.0 : corr);
    const bool ok = corr > 0.0 && N > 0.0;
    a.H[row] = ok ? float(H) : 0.0f;
    a.p[row] = ok ? float(gammaincc(0.5 * double(k - 1), 0.5 * fmax(H, 0.0))) : 1.0f;
  }
  __syncthreads();
}

struct FriedmanArgs {
  const float* data;  // (B, n, k)
  const uint8_t* block_mask;  // (B, n)
  int B, n, k;
  float* chi2;
  float* p;
};

// rank key of an entry among its block's treatments (every entry valid)
__device__ __forceinline__ uint64_t entry_key(float v) { return rank_key(v, true, false) >> 1; }

// Twice the rank of entry j of a block (2 #less + #equal + 1) and #equal.
__device__ __forceinline__ void block_rank(const float* blk, int k, int j, long long* r2,
                                           long long* eq) {
  const uint64_t kj = entry_key(blk[j]);
  long long less = 0, same = 0;
  for (int q = 0; q < k; ++q) {
    const uint64_t kq = entry_key(blk[q]);
    less += kq < kj;
    same += kq == kj;
  }
  *r2 = 2 * less + same + 1;
  *eq = same;
}

__global__ void __launch_bounds__(kRankThreads) friedman_kernel(FriedmanArgs a) {
  __shared__ Scratch scr;
  __shared__ long long part[kRankThreads];
  const int row = blockIdx.x, n = a.n, k = a.k, tid = threadIdx.x, nt = blockDim.x;
  const float* d = a.data + size_t(row) * n * k;
  const uint8_t* bm = a.block_mask + size_t(row) * n;
  long long tie = 0;
  int nb = 0;
  double ssq = 0.0;
  if (k <= nt) {
    // workers w < k * per: treatment w % k, blocks w / k, w / k + per, ...
    const int per = nt / k;
    long long r2sum = 0;
    if (tid < k * per) {
      const int j = tid % k;
      for (int i = tid / k; i < n; i += per) {
        if (!bm[i]) continue;
        long long r2, eq;
        block_rank(d + size_t(i) * k, k, j, &r2, &eq);
        r2sum += r2;
        tie += eq * eq - 1;
      }
    }
    part[tid] = r2sum;
    __syncthreads();
    if (tid < k) {
      long long R2 = 0;
      for (int w = tid; w < k * per; w += k) R2 += part[w];
      const double R = double(R2) * 0.5;
      ssq = R * R;
    }
  } else {
    for (int j = tid; j < k; j += nt) {
      long long R2 = 0;
      for (int i = 0; i < n; ++i) {
        if (!bm[i]) continue;
        long long r2, eq;
        block_rank(d + size_t(i) * k, k, j, &r2, &eq);
        R2 += r2;
        tie += eq * eq - 1;
      }
      const double R = double(R2) * 0.5;
      ssq += R * R;
    }
  }
  for (int i = tid; i < n; i += nt) nb += bm[i] != 0;
  tie = block_sum(tie, scr);
  nb = block_sum(nb, scr);
  ssq = block_sum(ssq, scr);
  if (tid == 0) {
    const double N = nb, K = k;
    const double denom = N * K * (K * K - 1.0);
    const double c = 1.0 - double(tie) / (denom == 0.0 ? 1.0 : denom);
    const double scale = N * K * (K + 1.0);
    double chi = (scale == 0.0 ? 12.0 : 12.0 / scale) * ssq - 3.0 * N * (K + 1.0);
    chi = chi / (c == 0.0 ? 1.0 : c);
    const bool ok = c > 0.0 && N > 0.0;
    a.chi2[row] = ok ? float(chi) : 0.0f;
    a.p[row] = ok ? float(gammaincc(0.5 * (K - 1.0), 0.5 * fmax(chi, 0.0))) : 1.0f;
  }
}

template <bool kScratch>
__global__ void __launch_bounds__(kRankThreads) rank_kernel(RankArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  if constexpr (kScratch) {
    unsigned char* work = a.scratch + size_t(blockIdx.x) * a.scratch_stride;
    for (int row = blockIdx.x; row < a.B; row += gridDim.x) rank_row(a, row, work, scr);
  } else {
    rank_row(a, blockIdx.x, smem, scr);
  }
}

template <bool kScratch>
__global__ void __launch_bounds__(kRankThreads) kruskal_kernel(KruskalArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch scr;
  if constexpr (kScratch) {
    unsigned char* work = a.scratch + size_t(blockIdx.x) * a.scratch_stride;
    for (int row = blockIdx.x; row < a.B; row += gridDim.x) kruskal_row(a, row, work, scr);
  } else {
    kruskal_row(a, blockIdx.x, smem, scr);
  }
}

}  // namespace fm

// Bytes of a row's working set at n keys: the keys and the two scan arrays.
extern "C" long long fm_rank_work_bytes(long long n) {
  return (long long)(size_t(fm::next_pow2(int(n))) * 16);
}

template <typename Args, typename KS, typename KD>
static int launch_sorted(KS shared_kernel, KD scratch_kernel, const Args& a, long long n_keys,
                         int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a.scratch == nullptr) {
    const int smem = int(fm_rank_work_bytes(n_keys));
    e = cudaFuncSetAttribute(shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    shared_kernel<<<grid, fm::kRankThreads, smem, st>>>(a);
  } else {
    scratch_kernel<<<grid, fm::kRankThreads, 0, st>>>(a);
  }
  return int(cudaGetLastError());
}

extern "C" int fm_rank_and_ties(const float* values, const uint8_t* mask, int B, int T,
                                float* ranks, float* tie, float* n_valid, unsigned char* scratch,
                                long long scratch_stride, int grid, void* stream) {
  fm::RankArgs a{values, mask, B, T, ranks, tie, n_valid, scratch, size_t(scratch_stride)};
  return launch_sorted(fm::rank_kernel<false>, fm::rank_kernel<true>, a, T, grid, stream);
}

extern "C" int fm_kruskal_groups(const float* groups, const uint8_t* masks, int B, int k, int T,
                                 float* H, float* p, unsigned char* scratch,
                                 long long scratch_stride, int grid, void* stream) {
  fm::KruskalArgs a{groups, masks, B, k, T, H, p, scratch, size_t(scratch_stride)};
  return launch_sorted(fm::kruskal_kernel<false>, fm::kruskal_kernel<true>, a,
                       (long long)k * T, grid, stream);
}

extern "C" int fm_friedman(const float* data, const uint8_t* block_mask, int B, int n, int k,
                           float* chi2, float* p, void* stream) {
  fm::FriedmanArgs a{data, block_mask, B, n, k, chi2, p};
  fm::friedman_kernel<<<B, fm::kRankThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
