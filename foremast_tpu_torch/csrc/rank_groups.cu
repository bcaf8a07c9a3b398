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
//   - the CTA paths of rank_and_ties and kruskal_groups: one CTA per row
//     sorts the row's keys (T, or k T for the groups) with kernel A's
//     bitonic sort. The key is
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
//     A does above T = 4096, up to the tag's 2^30 keys a row (a slot of
//     16 GB there). Past 2,097,151 valid keys a tie group's t^3 - t leaves a
//     long long, so such rows sum the tie term in limbs (TieTerm), exact.
//   - Kruskal's per-group rank sums: one pass over the sorted positions per
//     group, a block sum each (k passes of k T positions; k is small). H and
//     its tie correction in float64, p = gammaincc((k - 1) / 2, H / 2) in
//     float64 (common.cuh).
//   - the warp path of kruskal_groups (k T <= 512, the battery's k = 3
//     groups of T = 128) and of rank_and_ties (T <= 512, the battery's
//     T = 256): a warp a row, four rows a CTA, no block barrier on a row's
//     path. 32-bit keys (the tie group alone: no class bits, no tag) sorted
//     in registers, 16 a lane at most; each sorted position's doubled rank
//     from bit masks of run starts and ends and two warp scans; each valid
//     element's rank found by a binary search of the sorted keys
//     (warp_rank_row below). The same integers as the CTA path, so the
//     ranks, tie terms, counts, H and p have its bits.
//   - friedman needs no sort: an entry's rank within its block is
//     #less + (#equal + 1) / 2 under the same key order (ties and NaN as the
//     reference's rank_and_ties orders them), and the block's tie term is
//     the sum over its entries of #equal^2 - 1 (= sum over its tie groups of
//     t^3 - t). Two paths with the same bits:
//       - warp (k <= kWarpFriedmanK, the battery's k = 3; n <= 2^20): a
//         warp takes kFriedmanRows rows, one after another, the next row's
//         loads in flight while a row's sums meet; its lanes stride a row's
//         blocks, each lane loading its blocks' k entries once as 32-bit
//         keys in registers and keeping its k doubled rank sums, tie term
//         and block count there; warp reductions add them, with no block
//         barrier. Lane r keeps row r's integers, and after the warp's last
//         row each lane finishes its own row's chi2 and p: the tail's
//         float64 series runs once a warp for 32 rows, not once a row;
//       - cta (every k, the first design): a CTA per row; up to 128
//         treatments, 128 / k threads share a treatment and their partial
//         sums meet in shared memory; above it a thread owns treatments.
//     Every sum is of integers, or of exact squares of multiples of 0.25
//     (R = R2 / 2, R2 < 2^26) in float64, so no order of summation moves
//     chi2 or p, and friedman_write is the one tail of both.
//
// What bounds it on an H100: on the CTA paths the sorts' chains of block
// barriers (log2(n)^2 / 2 steps over n keys; at k = 3, T = 128 the sort was
// 69% of a row's cycles), not the bytes (a row's values and masks are read
// once); on the warp path the instructions of the register sort and the
// searches, issued by ~30 warps an SM. friedman: not its O(n k^2)
// compares (2 k^2 a block) but, on its cta path, three chains of block
// barriers (the sums) and a one-thread float64 tail a row; on its warp
// path its loads' latency (a warp reads a row at a time, ~1.6 KB at the
// battery's 128 blocks x 3) and its instructions, at about twice its bytes
// bound on an H100.
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

// The tie term sum(t^3 - t) of a row's tie groups. A row of at most
// kNarrowTieKeys valid keys sums it in one long long (t^3 < 2^63). A longer
// row (up to 2^kTagBits keys, t^3 - t < 2^90) sums each group's term in
// three limbs, bits 0-31, 32-63 and 64 up, each limb a long long sum of
// values below 2^32: exact for any row the tag serves. Its float and double
// are the exact sum rounded once.
constexpr int kNarrowTieKeys = 2097151;

struct TieLimbs {
  long long l0 = 0, l1 = 0, l2 = 0;
  // t^3 - t = t (t^2 - 1), t^2 - 1 = ph 2^32 + pl: pl t < 2^63, ph t < 2^59
  __device__ __forceinline__ void add(long long t) {
    const unsigned long long u = t, p = u * u - 1ull;
    const unsigned long long x = (p & 0xffffffffull) * u, y = (p >> 32) * u;
    l0 += (long long)(x & 0xffffffffull);
    l1 += (long long)(x >> 32) + (long long)(y & 0xffffffffull);
    l2 += (long long)(y >> 32);
  }
  __device__ __forceinline__ void block_total(Scratch& s) {
    l0 = block_sum(l0, s);
    l1 = block_sum(l1, s);
    l2 = block_sum(l2, s);
  }
  // the sum as a 64-bit value at most, scaled by 2^sh, with the bits shifted
  // out folded into bit 0 (sticky): its float and double round as the
  // exact sum's
  __device__ inline unsigned long long top(int& sh) const {
    unsigned long long a1 = (unsigned long long)l1 + ((unsigned long long)l0 >> 32);
    const unsigned long long a0 = (unsigned long long)l0 & 0xffffffffull;
    const unsigned long long a2 = (unsigned long long)l2 + (a1 >> 32);
    a1 &= 0xffffffffull;
    const unsigned long long lo = (a1 << 32) | a0;
    sh = 0;
    while ((a2 >> sh) != 0ull) ++sh;
    if (sh == 0) return lo;
    const unsigned long long dropped = lo & ((1ull << sh) - 1ull);
    return (a2 << (64 - sh)) | (lo >> sh) | (dropped != 0ull ? 1ull : 0ull);
  }
  __device__ inline float to_float() const {
    int sh;
    const unsigned long long t = top(sh);
    return ldexpf(float(t), sh);
  }
  __device__ inline double to_double() const {
    int sh;
    const unsigned long long t = top(sh);
    return ldexp(double(t), sh);
  }
};

// A row's tie term: one long long up to kNarrowTieKeys valid keys (the
// first design's sum, its bits), limbs above.
struct TieTerm {
  bool narrow;
  long long tie = 0;
  TieLimbs wide;
  __device__ explicit TieTerm(int nvalid) : narrow(nvalid <= kNarrowTieKeys) {}
  __device__ __forceinline__ void add(long long t) {
    if (narrow) {
      tie += t * t * t - t;
    } else {
      wide.add(t);
    }
  }
  __device__ __forceinline__ void block_total(Scratch& s) {
    if (narrow) {
      tie = block_sum(tie, s);
    } else {
      wide.block_total(s);
    }
  }
  __device__ inline float to_float() const { return narrow ? float(tie) : wide.to_float(); }
  __device__ inline double to_double() const { return narrow ? double(tie) : wide.to_double(); }
};

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
  long long* clocks;  // the warp path's: null, or (B, kKruskalStamps) clock64() stamps a row
  unsigned char* scratch;
  size_t scratch_stride;
};

// One row by one CTA (the cta and scratch paths; no stamps: six of them
// cost this path 4% at T = 256 on an H100).
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
  TieTerm tie(nvalid);
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const uint32_t at = uint32_t(keys[p] & kTagMask);
    if (p >= nvalid) {
      out[at] = 0.0f;
      continue;
    }
    const int b = first[p], e = rev[nvalid - 1 - p];
    out[at] = float((long long)b + e + 2) * 0.5f;
    if (p == e) tie.add(e - b + 1);
  }
  tie.block_total(scr);
  if (threadIdx.x == 0) {
    a.tie[row] = tie.to_float();
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
  long long* clocks;  // null, or (B, kKruskalStamps) clock64() stamps a row
  unsigned char* scratch;
  size_t scratch_stride;
};

// With a.clocks set, thread 0 stamps the SM clock at a row's start and
// after each phase, past the phase's last block barrier: the keys' loads
// and the valid count, the sort, the group bounds' scans, the tie term and
// the group sums, the tail (H, p and the writes). The phase names are
// kernels.KRUSKAL_PHASES; null costs one uniform branch a stamp.
constexpr int kKruskalStamps = 6;

__device__ __forceinline__ void kstamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && threadIdx.x == 0) clocks[size_t(row) * kKruskalStamps + k] = clock64();
}

// H and its p from a row's integers, on every path: nvalid values, ssq the
// sum over groups of R_g^2 / n_g, the tie term sum(t^3 - t) (exact, or
// rounded once past 2^53).
__device__ __forceinline__ void kruskal_write(const KruskalArgs& a, int row, int nvalid,
                                              double ssq, double tie) {
  const double N = nvalid;
  double H = (N * (N + 1.0) == 0.0 ? 12.0 : 12.0 / (N * (N + 1.0))) * ssq - 3.0 * (N + 1.0);
  const double denom = N * N * N - N;
  const double corr = 1.0 - tie / (denom == 0.0 ? 1.0 : denom);
  H = H / (corr == 0.0 ? 1.0 : corr);
  const bool ok = corr > 0.0 && N > 0.0;
  a.H[row] = ok ? float(H) : 0.0f;
  a.p[row] = ok ? float(gammaincc(0.5 * double(a.k - 1), 0.5 * fmax(H, 0.0))) : 1.0f;
}

__device__ void kruskal_row(const KruskalArgs& a, int row, unsigned char* work, Scratch& scr) {
  const int k = a.k, T = a.T, n = k * T, n_sort = next_pow2(n);
  const float* v = a.groups + size_t(row) * n;
  const uint8_t* m = a.masks + size_t(row) * n;
  uint64_t* keys = reinterpret_cast<uint64_t*>(work);
  int* first = reinterpret_cast<int*>(keys + n_sort);
  int* rev = first + n_sort;
  kstamp(a.clocks, row, 0);
  int nv = 0;
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
    keys[i] = i < n ? tagged_key(v[i], m[i], uint32_t(i / T)) : kPadKey;
    nv += i < n && m[i];
  }
  const int nvalid = block_sum(nv, scr);
  kstamp(a.clocks, row, 1);
  bitonic_sort(keys, n_sort);
  kstamp(a.clocks, row, 2);
  group_bounds(keys, nvalid, first, rev, scr);
  kstamp(a.clocks, row, 3);
  TieTerm tie(nvalid);
  for (int p = threadIdx.x; p < nvalid; p += blockDim.x) {
    const int b = first[p], e = rev[nvalid - 1 - p];
    if (p == e) tie.add(e - b + 1);
  }
  tie.block_total(scr);
  // sum over groups of R_g^2 / n_g, with R_g = (sum of twice the ranks) / 2
  double ssq = 0.0;
  for (int grp = 0; grp < k; ++grp) {
    long long r2 = 0;
    int cnt = 0;
    for (int p = threadIdx.x; p < nvalid; p += blockDim.x) {
      if (int(keys[p] & kTagMask) != grp) continue;
      r2 += (long long)first[p] + rev[nvalid - 1 - p] + 2;
      cnt += 1;
    }
    r2 = block_sum(r2, scr);
    cnt = block_sum(cnt, scr);
    const double R = double(r2) * 0.5;
    ssq += R * R / (cnt == 0 ? 1.0 : double(cnt));
  }
  kstamp(a.clocks, row, 4);
  if (threadIdx.x == 0) kruskal_write(a, row, nvalid, ssq, tie.to_double());
  kstamp(a.clocks, row, 5);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kruskal_groups' warp path (k T <= kWarpRankKeys): a warp a row,
// kKruskalWarps rows a CTA, no block barrier on a row's path.
//
// The key is 32 bits, the tie group's own: the value as an order-preserving
// unsigned (-0.0 folded into +0.0), a valid NaN one above +inf's (one group
// after every valid non-NaN, as class 1 sorts on the CTA path), a masked
// slot or padding 0xFFFFFFFF, after every valid key. The warp sorts its
// 32 M keys in registers (M = next_pow2(k T) / 32, at least 1), writes them
// to its shared memory, and from each sorted position's group bounds (run
// starts and ends as bit masks a lane, their carries by warp scans) writes
// the position's doubled rank, first + last + 2. Each valid element then
// finds the first position of its key by a binary search of the sorted
// keys, and its doubled rank there. The group sums, counts, the tie term
// sum(t^3 - t) and the valid count are integers, so H and p, from them by
// kruskal_write as on the CTA path, have its bits.
// ---------------------------------------------------------------------------
constexpr int kKruskalWarps = 4;       // rows a CTA (kernels.KRUSKAL_WARPS)
constexpr int kKruskalWarpBlocks = 8;  // resident CTAs an SM: 64 registers
constexpr int kWarpRankKeys = 512;     // kernels.WARP_RANK_KEYS
constexpr uint32_t kNanKey = 0xFF800001u;
constexpr uint32_t kMaskedKey = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t value_key(float v, bool valid) {
  if (!valid) return kMaskedKey;
  if (v != v) return kNanKey;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the warp path's stamps, by lane 0 of the row's warp
__device__ __forceinline__ void kwstamp(long long* clocks, int row, int k) {
  if (clocks != nullptr && (threadIdx.x & 31) == 0)
    clocks[size_t(row) * kKruskalStamps + k] = clock64();
}

// One row of n <= 32 M masked values (v, m) by one warp: the warp path's
// ranks, shared by kruskal_groups and rank_and_ties. sorted and twice_rank
// hold 32 M entries, in_key n: the warp's own shared memory. On return
// in_key[i] holds element i's doubled rank (below bit 20) and a count of
// one (above it), or 0 where masked; *nvalid the valid count, *tie the tie
// term sum(t^3 - t). Stamps 0-3 of the row (the caller's phases' first
// four) where clocks is set.
template <int M>
__device__ void warp_rank_row(const float* v, const uint8_t* m, int n, uint32_t* sorted,
                              uint32_t* twice_rank, uint32_t* in_key, bool vec,
                              long long* clocks, int row, int* nvalid_out, int* tie_out) {
  constexpr int N = 32 * M;
  const int lane = threadIdx.x & 31;
  kwstamp(clocks, row, 0);
  // every load issued before any is used: no branch between them (an index
  // past the row reads its last element, and is dropped). Where the row is
  // whole float4s (vec), key 4 u + c of the lane is element
  // 4 (lane + 32 u) + c, loaded as a float4 and the masks' four bytes as a
  // word; else key r is element lane + 32 r.
  uint32_t key[M];
  uint32_t valid = 0u;  // bit r: key r's element is valid
  bool vec4 = false;
  if constexpr (M >= 4) vec4 = vec;
  if (vec4) {
    constexpr int V = M >= 4 ? M / 4 : 1;
    float4 xv[V];
    uint32_t mw[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int e = min(4 * (lane + 32 * u), n - 4);
      xv[u] = __ldg(reinterpret_cast<const float4*>(v + e));
      mw[u] = __ldg(reinterpret_cast<const uint32_t*>(m + e));
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int e = 4 * (lane + 32 * u);
      const float x4[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
      uint32_t k4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = e < n && ((mw[u] >> (8 * c)) & 0xFFu) != 0;
        k4[c] = value_key(x4[c], ok);
        valid |= uint32_t(ok) << (4 * u + c);
        key[(4 * u + c) % M] = k4[c];
      }
      if (e < n) *reinterpret_cast<uint4*>(in_key + e) = make_uint4(k4[0], k4[1], k4[2], k4[3]);
    }
  } else {
    float xv[M];
    uint8_t mv[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const int i = min(lane + 32 * r, n - 1);
      xv[r] = __ldg(v + i);
      mv[r] = __ldg(m + i);
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const int i = lane + 32 * r;
      const bool ok = i < n && mv[r] != 0;
      valid |= uint32_t(ok) << r;
      key[r] = value_key(xv[r], ok);
      if (i < n) in_key[i] = key[r];
    }
  }
  const int nv = __popc(valid);
  const int nvalid = warp_sum(nv);
  kwstamp(clocks, row, 1);

  warp_bitonic_sort(key);
#pragma unroll
  for (int r = 0; r < M; ++r) sorted[lane * M + r] = key[r];
  kwstamp(clocks, row, 2);

  // runs of equal keys: bit r of start (end) where position lane M + r
  // begins (ends) one; a position's group runs from the last start at or
  // before it to the first end at or after it
  const uint32_t before = __shfl_up_sync(kFullWarp, key[M - 1], 1);
  const uint32_t after = __shfl_down_sync(kFullWarp, key[0], 1);
  uint32_t start = 0u, end = 0u;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const bool s = r > 0 ? key[r] != key[r - 1] : (lane == 0 || key[0] != before);
    const bool e = r < M - 1 ? key[r] != key[r + 1] : (lane == 31 || key[M - 1] != after);
    start |= uint32_t(s) << r;
    end |= uint32_t(e) << r;
  }
  const int base = lane * M;
  // the last start below this lane's positions, the first end above them
  int first_in = warp_scan(start ? base + 31 - __clz(start) : -1, Max<int>());
  int last_in = end ? base + __ffs(end) - 1 : N;
#pragma unroll 1
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_down_sync(kFullWarp, last_in, o);
    if (lane + o < 32) last_in = min(last_in, u);
  }
  first_in = __shfl_up_sync(kFullWarp, first_in, 1);
  last_in = __shfl_down_sync(kFullWarp, last_in, 1);
  int tie = 0;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int p = base + r;
    const uint32_t s = start & ((2u << r) - 1u), e = end >> r;
    const int first = s ? base + 31 - __clz(s) : first_in;
    const int last = e ? p + __ffs(e) - 1 : last_in;
    twice_rank[p] = uint32_t(first + last + 2);
    if ((e & 1u) && p < nvalid) {
      const int t = p - first + 1;
      tie += t * t * t - t;
    }
  }
  tie = warp_sum(tie);
  __syncwarp();
  kwstamp(clocks, row, 3);

  // each of the lane's elements: the first sorted position of its key by a
  // binary search (U searches side by side), its doubled rank there (below
  // bit 20) and a count of one (above it), or 0 where masked, written in
  // place of its key
  constexpr int U = M < 8 ? M : 8;
#pragma unroll 1
  for (int r0 = 0; r0 < M; r0 += U) {
    uint32_t kk[U];
    int pos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = lane + 32 * (r0 + u);
      kk[u] = i < n ? in_key[i] : kMaskedKey;
      pos[u] = 0;  // ends as the count of keys below kk[u]
    }
#pragma unroll 1
    for (int step = N >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) pos[u] += sorted[pos[u] + step - 1] < kk[u] ? step : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = lane + 32 * (r0 + u);
      if (i < n) in_key[i] = kk[u] == kMaskedKey ? 0u : twice_rank[pos[u]] + (1u << 20);
    }
  }
  __syncwarp();
  *nvalid_out = nvalid;
  *tie_out = tie;
}

// One Kruskal-Wallis row by one warp: warp_rank_row over its k T values,
// then each group's doubled rank sum and count from in_key.
template <int M>
__device__ void kruskal_row_warp(const KruskalArgs& a, int row, uint32_t* sorted,
                                 uint32_t* twice_rank, uint32_t* in_key, bool vec) {
  const int k = a.k, T = a.T, n = k * T, lane = threadIdx.x & 31;
  int nvalid, tie;
  warp_rank_row<M>(a.groups + size_t(row) * n, a.masks + size_t(row) * n, n, sorted, twice_rank,
                   in_key, vec, a.clocks, row, &nvalid, &tie);
  // sum over groups of R_g^2 / n_g, in group order
  double ssq = 0.0;
#pragma unroll 1
  for (int grp = 0; grp < k; ++grp) {
    int acc = 0;
#pragma unroll 1
    for (int j = lane; j < T; j += 32) acc += int(in_key[grp * T + j]);
    acc = warp_sum_rolled(acc);
    const int cnt = acc >> 20;
    const double R = double(acc & 0xFFFFF) * 0.5;
    ssq += R * R / (cnt == 0 ? 1.0 : double(cnt));
  }
  kwstamp(a.clocks, row, 4);
  if (lane == 0) kruskal_write(a, row, nvalid, ssq, double(tie));
  kwstamp(a.clocks, row, 5);
}

// A warp a row, kKruskalWarps rows a CTA. A tail warp with no row returns
// at once: nothing on this path waits for another warp.
template <int M>
__global__ void __launch_bounds__(32 * kKruskalWarps, kKruskalWarpBlocks)
    kruskal_warp_kernel(KruskalArgs a, bool vec) {
  __shared__ __align__(16) uint32_t work[kKruskalWarps][3][32 * M];
  const int warp = threadIdx.x >> 5, row = blockIdx.x * kKruskalWarps + warp;
  if (row >= a.B) return;
  kruskal_row_warp<M>(a, row, work[warp][0], work[warp][1], work[warp][2], vec);
}

// rank_and_ties' warp path (T <= kWarpRankKeys): warp_rank_row a row,
// then each element's rank in input order, its doubled rank / 2 (0 where
// masked), the integers of the CTA path's ranks, tie term and count.
template <int M>
__global__ void __launch_bounds__(32 * kKruskalWarps, kKruskalWarpBlocks)
    rank_warp_kernel(RankArgs a, bool vec) {
  __shared__ __align__(16) uint32_t work[kKruskalWarps][3][32 * M];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kKruskalWarps + warp;
  if (row >= a.B) return;
  const int T = a.T;
  uint32_t* in_key = work[warp][2];
  int nvalid, tie;
  warp_rank_row<M>(a.values + size_t(row) * T, a.mask + size_t(row) * T, T, work[warp][0],
                   work[warp][1], in_key, vec, a.clocks, row, &nvalid, &tie);
  kwstamp(a.clocks, row, 4);
  float* out = a.ranks + size_t(row) * T;
  if (vec) {
    for (int i = 4 * lane; i < T; i += 128) {
      const uint4 k4 = *reinterpret_cast<const uint4*>(in_key + i);
      *reinterpret_cast<float4*>(out + i) =
          make_float4(float(k4.x & 0xFFFFFu) * 0.5f, float(k4.y & 0xFFFFFu) * 0.5f,
                      float(k4.z & 0xFFFFFu) * 0.5f, float(k4.w & 0xFFFFFu) * 0.5f);
    }
  } else {
    for (int i = lane; i < T; i += 32) out[i] = float(in_key[i] & 0xFFFFFu) * 0.5f;
  }
  if (lane == 0) {
    a.tie[row] = float(tie);
    a.n_valid[row] = float(nvalid);
  }
  kwstamp(a.clocks, row, 5);
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

// chi2 and its p from a row's integers, on both paths: nb counted blocks,
// ssq the sum over treatments of R_j^2, the tie term sum(#equal^2 - 1).
__device__ __forceinline__ void friedman_write(const FriedmanArgs& a, int row, int nb,
                                               double ssq, long long tie) {
  const double N = nb, K = a.k;
  const double denom = N * K * (K * K - 1.0);
  const double c = 1.0 - double(tie) / (denom == 0.0 ? 1.0 : denom);
  const double scale = N * K * (K + 1.0);
  double chi = (scale == 0.0 ? 12.0 : 12.0 / scale) * ssq - 3.0 * N * (K + 1.0);
  chi = chi / (c == 0.0 ? 1.0 : c);
  const bool ok = c > 0.0 && N > 0.0;
  a.chi2[row] = ok ? float(chi) : 0.0f;
  a.p[row] = ok ? float(gammaincc(0.5 * (K - 1.0), 0.5 * fmax(chi, 0.0))) : 1.0f;
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
  if (tid == 0) friedman_write(a, row, nb, ssq, tie);
}

// ---------------------------------------------------------------------------
// friedman's warp path (k <= kWarpFriedmanK, n <= kWarpFriedmanN):
// kFriedmanWarps warps a CTA, kFriedmanRows rows a warp. A row's blocks go
// to the lanes in turn (lane l takes blocks l, l + 32, ...), G of them a
// batch: the lane loads a batch's entries and mask bytes at once (a warp's
// loads of 32 blocks cover 128 k contiguous bytes) and ranks each block in
// registers by its pairs of entries: K entries (K = k for k <= 4), those
// past k padded with a key above every value's (so they are never less
// than, nor equal to, an entry), and kept out of the sums. The next row's
// first batch is loaded before this row's sums meet, so its loads wait
// beside them. The sums meet by warp reductions of 32-bit integers (the
// tie term in two 16-bit halves); lane r of the warp keeps its r-th row's,
// and the tail (chi2, p) runs once, a lane a row.
// ---------------------------------------------------------------------------
constexpr int kFriedmanWarps = 4;    // warps a CTA (kernels.FRIEDMAN_WARPS)
constexpr int kFriedmanRows = 32;    // rows a warp, a lane each for the tail
constexpr int kWarpFriedmanK = 16;   // kernels.WARP_FRIEDMAN_K
// kernels.WARP_FRIEDMAN_N: a lane's tie term, sum(#equal^2 - 1) over at
// most 2^15 blocks of 16, and a row's doubled rank sums (2 k n) fit 31 bits
constexpr int kWarpFriedmanN = 1 << 20;
constexpr uint32_t kPadEntryKey = 0xFFFFFFFFu;  // above kNanKey

template <int K, int G>
__device__ __forceinline__ void friedman_load(const FriedmanArgs& a, size_t row, int i0,
                                              float (&v)[G][K], int (&on)[G]) {
  const int n = a.n, k = a.k;
  const float* d = a.data + row * size_t(n) * k;
  const uint8_t* bm = a.block_mask + row * size_t(n);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = i0 + 32 * g;
    const bool in = i < n;
#pragma unroll
    for (int j = 0; j < K; ++j) v[g][j] = in && j < k ? __ldg(d + size_t(i) * k + j) : 0.0f;
    on[g] = in ? __ldg(bm + i) : 0;
  }
}

// Each entry's #less and #equal among its block's K (itself counted equal)
// from the K (K - 1) / 2 pairs; a masked-out block adds nothing.
template <int K, int G>
__device__ __forceinline__ void friedman_rank(const float (&v)[G][K], const int (&on)[G],
                                              int k, int (&R2)[K], int* tie, int* nb) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int w = on[g] != 0;
    uint32_t key[K];
    int less[K], same[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      key[j] = j < k ? value_key(v[g][j], true) : kPadEntryKey;
      less[j] = 0;
      same[j] = 1;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int q = j + 1; q < K; ++q) {
        const bool lt = key[j] < key[q], eq = key[j] == key[q];
        less[q] += lt;
        less[j] += !lt && !eq;
        same[j] += eq;
        same[q] += eq;
      }
    }
    *nb += w;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      R2[j] += w * (2 * less[j] + same[j] + 1);
      *tie += (w && j < k) ? same[j] * same[j] - 1 : 0;
    }
  }
}

// Up to K = 4, 64 registers a thread: every warp of the battery's 100,000
// rows (~24 an SM) resident at once.
template <int K>
__global__ void __launch_bounds__(32 * kFriedmanWarps, K <= 4 ? 8 : 4)
    friedman_warp_kernel(FriedmanArgs a) {
  // the blocks a lane loads at once, 12 entries of registers a batch (the
  // battery's 128 blocks x 3 in one)
  constexpr int G = K >= 12 ? 1 : 12 / K;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (long long)(blockIdx.x * kFriedmanWarps + (threadIdx.x >> 5)) * kFriedmanRows;
  if (row0 >= a.B) return;
  const int rows = int(min((long long)kFriedmanRows, a.B - row0));
  const int n = a.n, k = a.k;
  int my_nb = 0;
  long long my_tie = 0;
  double my_ssq = 0.0;
  float v[G][K];
  int on[G];
  friedman_load<K, G>(a, size_t(row0), lane, v, on);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const size_t row = size_t(row0) + r;
    int R2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) R2[j] = 0;
    int tie = 0, nb = 0;
#pragma unroll 1
    for (int i0 = 0;;) {
      friedman_rank<K, G>(v, on, k, R2, &tie, &nb);
      i0 += 32 * G;
      if (i0 >= n) break;
      friedman_load<K, G>(a, row, i0 + lane, v, on);
    }
    if (r + 1 < rows) friedman_load<K, G>(a, row + 1, lane, v, on);
    nb = int(__reduce_add_sync(kFullWarp, unsigned(nb)));
    const long long tie_sum =
        (long long)__reduce_add_sync(kFullWarp, unsigned(tie) & 0xFFFFu) +
        ((long long)__reduce_add_sync(kFullWarp, unsigned(tie) >> 16) << 16);
    double ssq = 0.0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        const double R = double(__reduce_add_sync(kFullWarp, unsigned(R2[j]))) * 0.5;
        ssq += R * R;
      }
    }
    if (lane == r) {
      my_nb = nb;
      my_tie = tie_sum;
      my_ssq = ssq;
    }
  }
  if (lane < rows) friedman_write(a, int(row0 + lane), my_nb, my_ssq, my_tie);
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
  fm::RankArgs a{values, mask, B, T, ranks, tie, n_valid, nullptr, scratch,
                 size_t(scratch_stride)};
  return launch_sorted(fm::rank_kernel<false>, fm::rank_kernel<true>, a, T, grid, stream);
}

extern "C" int fm_kruskal_groups(const float* groups, const uint8_t* masks, int B, int k, int T,
                                 float* H, float* p, long long* clocks, unsigned char* scratch,
                                 long long scratch_stride, int grid, void* stream) {
  fm::KruskalArgs a{groups, masks, B, k, T, H, p, clocks, scratch, size_t(scratch_stride)};
  return launch_sorted(fm::kruskal_kernel<false>, fm::kruskal_kernel<true>, a,
                       (long long)k * T, grid, stream);
}

extern "C" int fm_kruskal_warps() { return fm::kKruskalWarps; }
extern "C" int fm_warp_rank_keys() { return fm::kWarpRankKeys; }

template <int M>
static cudaError_t launch_kruskal_warp(const fm::KruskalArgs& a, int grid, bool vec,
                                       cudaStream_t st) {
  fm::kruskal_warp_kernel<M><<<grid, 32 * fm::kKruskalWarps, 0, st>>>(a, vec);
  return cudaGetLastError();
}

// kruskal_groups' warp path (k T <= 512): grid CTAs of fm_kruskal_warps() rows.
extern "C" int fm_kruskal_groups_warp(const float* groups, const uint8_t* masks, int B, int k,
                                      int T, float* H, float* p, long long* clocks, int grid,
                                      void* stream) {
  const long long n = (long long)k * T;
  if (n < 1 || n > fm::kWarpRankKeys || (long long)grid * fm::kKruskalWarps < B)
    return int(cudaErrorInvalidValue);
  fm::KruskalArgs a{groups, masks, B, k, T, H, p, clocks, nullptr, 0};
  // rows of whole float4s: the values' and masks' loads four elements wide
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(groups) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(masks) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fm::next_pow2(int(n) < 32 ? 32 : int(n)) / 32) {
    case 1: return int(launch_kruskal_warp<1>(a, grid, vec, st));
    case 2: return int(launch_kruskal_warp<2>(a, grid, vec, st));
    case 4: return int(launch_kruskal_warp<4>(a, grid, vec, st));
    case 8: return int(launch_kruskal_warp<8>(a, grid, vec, st));
    default: return int(launch_kruskal_warp<16>(a, grid, vec, st));
  }
}

template <int M>
static cudaError_t launch_rank_warp(const fm::RankArgs& a, int grid, bool vec, cudaStream_t st) {
  fm::rank_warp_kernel<M><<<grid, 32 * fm::kKruskalWarps, 0, st>>>(a, vec);
  return cudaGetLastError();
}

// rank_and_ties' warp path (T <= 512): grid CTAs of fm_kruskal_warps() rows.
extern "C" int fm_rank_and_ties_warp(const float* values, const uint8_t* mask, int B, int T,
                                     float* ranks, float* tie, float* n_valid, long long* clocks,
                                     int grid, void* stream) {
  if (T < 1 || T > fm::kWarpRankKeys || (long long)grid * fm::kKruskalWarps < B)
    return int(cudaErrorInvalidValue);
  fm::RankArgs a{values, mask, B, T, ranks, tie, n_valid, clocks, nullptr, 0};
  // rows of whole float4s: the loads and the ranks' stores four elements wide
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ranks) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fm::next_pow2(T < 32 ? 32 : T) / 32) {
    case 1: return int(launch_rank_warp<1>(a, grid, vec, st));
    case 2: return int(launch_rank_warp<2>(a, grid, vec, st));
    case 4: return int(launch_rank_warp<4>(a, grid, vec, st));
    case 8: return int(launch_rank_warp<8>(a, grid, vec, st));
    default: return int(launch_rank_warp<16>(a, grid, vec, st));
  }
}

extern "C" int fm_friedman(const float* data, const uint8_t* block_mask, int B, int n, int k,
                           float* chi2, float* p, void* stream) {
  fm::FriedmanArgs a{data, block_mask, B, n, k, chi2, p};
  fm::friedman_kernel<<<B, fm::kRankThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

extern "C" int fm_friedman_warps() { return fm::kFriedmanWarps; }
extern "C" int fm_friedman_rows() { return fm::kFriedmanRows; }
extern "C" int fm_warp_friedman_k() { return fm::kWarpFriedmanK; }
extern "C" int fm_warp_friedman_n() { return fm::kWarpFriedmanN; }

template <int K>
static cudaError_t launch_friedman_warp(const fm::FriedmanArgs& a, cudaStream_t st) {
  const long long per = (long long)fm::kFriedmanWarps * fm::kFriedmanRows;
  const int grid = int((a.B + per - 1) / per);
  fm::friedman_warp_kernel<K><<<grid, 32 * fm::kFriedmanWarps, 0, st>>>(a);
  return cudaGetLastError();
}

// friedman's warp path (1 <= k <= kWarpFriedmanK, 1 <= n <= kWarpFriedmanN):
// K the next of 2, 3, 4, 8, 16.
extern "C" int fm_friedman_warp(const float* data, const uint8_t* block_mask, int B, int n,
                                int k, float* chi2, float* p, void* stream) {
  if (k < 1 || k > fm::kWarpFriedmanK || n < 1 || n > fm::kWarpFriedmanN || B < 1)
    return int(cudaErrorInvalidValue);
  fm::FriedmanArgs a{data, block_mask, B, n, k, chi2, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 2) return int(launch_friedman_warp<2>(a, st));
  if (k == 3) return int(launch_friedman_warp<3>(a, st));
  if (k == 4) return int(launch_friedman_warp<4>(a, st));
  if (k <= 8) return int(launch_friedman_warp<8>(a, st));
  return int(launch_friedman_warp<16>(a, st));
}
