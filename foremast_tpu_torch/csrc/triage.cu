// Kernel G: the tier-0 triage screen, one launch for B packed rows.
//
// Replaces the reference's ops/triage.py `_screen_1d` (:58), vmapped and
// jitted as `screen_rows` (:140): per row, the band scorer's own moving
// average over the history (mask & ~region) and its RMS residual sigma;
// the violations of the current region (mask & region) under the policy
// band and under the band narrowed by `margin` sigmas (lower edge floored
// at min_lower_bound, ML_BOUND bitmask, 0 read as both); the means of both
// band edges over every region slot; the largest residual z of a checked
// slot; and the robust z: the largest |x - median| of a checked slot over
// max(1.4826 MAD, finite sigma), the median and MAD of the valid history
// taken as the mean of the order statistics (n-1)//2 and n//2 (clipped to
// the row), masked slots reading as +inf, NaN after +inf.
//
// The contract with kernel B. The moving average is the port's (float64
// prefix sums, ma_predict's semantics of common.cuh), and the screen's
// prefix sums and sigma are kernel B's to the bit: S is built in
// block_scan's order of additions (contiguous chunks of ceil(T/256) slots
// summed in turn, a Hillis-Steele scan of the 256 chunk totals, then offset
// plus entry), and sigma is summed in kernel B's order (256 strided float32
// partial sums, then block_sum's warp tree and its sum over the warps). So
// `count` is B's count and CLEAR (shrunk count under the verdict gate) is
// one-sided against the band scorer the engine would otherwise run.
//
// What bounds it on an H100: by chip_smoke.py's count (triage_bound),
// bytes, 6 B a slot read; the work between (a prefix scan, two passes of
// predictions, two exact selections) is what the design has to make cheap.
// The first design took 276 ms on an H100 at 100,000 x 16384, its phases
// (clock stamps) split as prefix sums 34%, sigma 14%, bands 14%, median
// 19%, MAD 19%: 32-way bank conflicts in the chunked scans, five
// reads of the inputs from L2, ~180 block barriers in 8-bit radix selects,
// 8 warps an SM at T = 16384. This design, one CTA of 512 threads a row:
//   1. stage: x is read once into shared memory (a float4 a lane when
//      T % 4 == 0), mask and region into bit words (history, checked,
//      region; four bytes a lane, their bits ORed across 8 lanes), and
//      every later phase reads only shared memory or registers. x and S live in a chunk-padded layout
//      (chunk c at c * stride, stride = ceil(T/256) rounded up to odd), so
//      the chunked scan (thread c on chunk c) and the strided passes
//      (consecutive slots on consecutive lanes) both meet distinct banks.
//      Prefix counts are not stored: C(j) is a word's prefix count plus a
//      popcount of its bits.
//   2. two groups of 256 threads then run side by side on named barriers:
//      - the predictor group builds S (block_scan's order), then sums
//        sigma over the history slots and the bands over the region slots
//        (each prediction is ma_predict's: two prefix differences, or the
//        freeze fill after a gap, searched once a thread per gap);
//      - the select group holds the row's order keys in registers (64 a
//        thread at T = 16384) and finds each order statistic from the bits
//        the range's ends share, then 11 bits a pass: a shared-memory
//        histogram of the keys that match so far, scanned by the group
//        (three barriers a pass, two or three passes); then the MAD's keys
//        |x - median| from the staged values.
//   3. one barrier; thread 0 writes the row's outputs.
// Shared memory is 12.7 B a slot and an 8 KB histogram (216 KB at T =
// 16384: one CTA an SM, 16 warps; 2 CTAs an SM up to T = 8192).
#include "common.cuh"

namespace fm {

// kScanChunks = kBandThreads of ma_band.cu: block_scan's chunks and the
// sigma sums' strided partials, as kernel B runs them
constexpr int kScanChunks = 256;
constexpr int kScreenGroup = 256;                 // threads a group
constexpr int kScreenThreads = 2 * kScreenGroup;  // predictor group, then select group
constexpr int kGroupWarps = kScreenGroup / 32;
constexpr uint32_t kKeyInf = 0xFF800000u;  // order_key(+inf)
constexpr uint32_t kKeyNaN = 0xFFFFFFFFu;  // above every other key
constexpr uint32_t kKeyPad = 0xFFFFFFFFu;  // slots past T: never below a bisection's candidate
enum : int { kBarPredict = 1, kBarSelect = 2 };

// float -> unsigned with the same order (jnp.sort's: NaN last, -0 == +0)
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return kKeyNaN;
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == kKeyNaN) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// the named barrier `id` of n threads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct ScreenArgs {
  const float* x;
  const uint8_t* mask;
  const uint8_t* region;
  const float* threshold;
  const int* bound_mode;
  const float* min_lower_bound;
  const float* margin;
  int window;
  int T;
  int* count;
  int* shrunk_count;
  int* checked;
  int* n_hist;
  float* upper_mean;
  float* lower_mean;
  float* resid_z;
  float* robust_z;
  float* sigma;
  long long* clocks;  // null, or (B, kScreenPhases) SM cycles a row spent per phase
  bool vec;           // T % 4 == 0 and the rows aligned: staged 4 slots a lane
};

// kernels.TRIAGE_PHASES: stage; scan, sigma, bands (the predictor group);
// beside them keys, minmax, passes, pair (both selections' summed),
// mad_keys (the select group); total
constexpr int kScreenPhases = 10;

// the select group's cycles by part, summed over both selections
struct SelectClocks {
  bool on;
  long long mark, minmax, passes, pair;
  __device__ __forceinline__ void lap(long long& part) {
    if (on) {
      const long long c = clock64();
      part += c - mark;
      mark = c;
    }
  }
};

// The row's staged state: the chunk-padded layout of x and S, the bit
// words, the words' prefix counts.
struct Row {
  const double* S;   // S[idx(s)] = S(s + 1), the float64 sum of the history in [0, s]
  const float* xs;   // xs[idx(s)] = x[s]
  const uint32_t* hbits;  // history (mask & ~region)
  const uint32_t* cbits;  // checked (mask & region)
  const int* cw;     // history count before each word; cw[nw] = the row's total
  int T, per, stride, nw, window;
  float inv_per, first;

  // the padded position of slot s: its chunk is s / per, computed in
  // float32: (s + 0.5) / per lies at least 0.5 / per >= 1/128 (T <= 16384)
  // from an integer, and the product's error is below 256 * 2^-23
  __device__ __forceinline__ int idx(int s) const {
    const int c = int((float(s) + 0.5f) * inv_per);
    return c * stride + (s - c * per);
  }
  __device__ __forceinline__ bool hist(int s) const { return (hbits[s >> 5] >> (s & 31)) & 1u; }
  // C(j): history slots in [0, j), j < T
  __device__ __forceinline__ int count(int j) const {
    return cw[j >> 5] + __popc(hbits[j >> 5] & ((1u << (j & 31)) - 1u));
  }
  __device__ __forceinline__ double sum(int j) const { return j > 0 ? S[idx(j - 1)] : 0.0; }
  // ma_mean of common.cuh on (S, C)
  __device__ __forceinline__ float mean(int lo, int hi) const {
    const int c = count(hi) - count(lo);
    return c > 0 ? float((sum(hi) - sum(lo)) / double(c)) : 0.0f;
  }
  // 1 + the slot of the k-th history value (k >= 1): the smallest j with
  // C(j) >= k
  __device__ int after_kth(int k) const {
    int lo = 0, hi = nw - 1;  // the last word with cw < k
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cw[mid] < k) lo = mid; else hi = mid - 1;
    }
    uint32_t w = hbits[lo];
    for (int n = k - cw[lo]; n > 1; --n) w &= w - 1u;
    return 32 * lo + __ffs(w);
  }
};

// ma_predict of common.cuh on a Row: the same prefix reads and divisions,
// so the same bits. The freeze fill after a gap depends only on the count
// before t, so a thread keeps the last one it searched.
struct Predictor {
  int k_cached = -1;
  float p_cached = 0.0f;

  __device__ __forceinline__ float operator()(const Row& r, int t) {
    const int w = r.window;
    const int hi = t;
    const int lo = min(max(t - w, 0), hi);
    const int chi = r.count(hi);
    if (chi > r.count(lo)) return r.mean(lo, hi);
    if (chi == 0) return r.first;
    if (chi != k_cached) {
      const int a = r.after_kth(chi);
      p_cached = r.mean(min(max(a - w, 0), a), a);
      k_cached = chi;
    }
    return p_cached;
  }
};

// block_reduce of common.cuh over one group of 256 threads, K values at
// once: each value's warp tree, then its sum over the 8 warps in order
// (the same association as K calls of block_sum in a CTA of 256). `red`
// holds 8 K slots; the group's barrier runs before and after the writes.
template <typename V, int K, typename Op>
__device__ __forceinline__ void group_reduce(V (&v)[K], V* red, Op op, int bar) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] = op(v[k], __shfl_down_sync(kFullWarp, v[k], o));
  }
  group_sync(bar, kScreenGroup);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  group_sync(bar, kScreenGroup);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    V s = red[k];
    for (int i = 1; i < kGroupWarps; ++i) s = op(s, red[i * K + k]);
    v[k] = s;
  }
}

// The select group's shared state: the digit histogram, and the per-warp
// partials of a reduction round, double buffered by round parity (a warp
// writes round r + 2's only after every warp has passed round r + 1's
// barrier, so after every read of round r's).
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;  // 8 a select thread
static_assert(kBins == 8 * kScreenGroup, "a select thread scans 8 bins");
struct SelectSpace {
  alignas(16) int bins[kBins];
  uint32_t part[2][kGroupWarps][2];
  int found[2];  // the digit a histogram pass picked, and the rank left in it
};

// One round: the group's totals of (a, b) under (sum, sum) or (min, max).
template <bool kMinMax>
__device__ __forceinline__ void select_round(uint32_t& a, uint32_t& b, SelectSpace& sp,
                                             int& round) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
  a = kMinMax ? __reduce_min_sync(kFullWarp, a) : __reduce_add_sync(kFullWarp, a);
  b = kMinMax ? __reduce_max_sync(kFullWarp, b) : __reduce_add_sync(kFullWarp, b);
  uint32_t(*p)[2] = sp.part[round & 1];
  if (lane == 0) {
    p[warp][0] = a;
    p[warp][1] = b;
  }
  group_sync(kBarSelect, kScreenGroup);
  a = p[0][0];
  b = p[0][1];
  for (int i = 1; i < kGroupWarps; ++i) {
    a = kMinMax ? min(a, p[i][0]) : a + p[i][0];
    b = kMinMax ? max(b, p[i][1]) : b + p[i][1];
  }
  ++round;
}

// The order statistics i0 <= i1 (= i0 or i0 + 1) of the row's keys, held
// KPT a thread (padding kKeyPad, above every real key, so it moves no
// order statistic below the real keys' count). The i0-th: the answer lies
// between the least key and the largest history key (i0 < n_hist; with no
// history every key is kKeyInf), so the bits they share are known; each
// pass then fixes the next kDigitBits from a histogram of the keys that
// share the bits fixed so far (shared-memory atomics), scanned by the
// group. The i1-th as block_select_pair takes it: the same key while it
// repeats that far, else the least larger key.
template <int KPT>
__device__ void select_pair(const uint32_t (&key)[KPT], const uint32_t (&is_hist)[(KPT + 31) / 32],
                            int nh, int i0, int i1, uint32_t& k0, uint32_t& k1, SelectSpace& sp,
                            int& round, SelectClocks& clk) {
  if (nh == 0) {
    k0 = k1 = kKeyInf;
    return;
  }
  if (clk.on) clk.mark = clock64();
  const int q = threadIdx.x % kScreenGroup, lane = threadIdx.x & 31;
  const int warp = q >> 5;
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    lo = min(lo, key[i]);
    if ((is_hist[i >> 5] >> (i & 31)) & 1u) hi = max(hi, key[i]);
  }
  select_round<true>(lo, hi, sp, round);
  clk.lap(clk.minmax);
  uint32_t prefix = lo;
  if (lo != hi) {
    int bits = 32 - __clz(lo ^ hi);  // the low bits still open
    prefix = bits == 32 ? 0u : lo & ~((1u << bits) - 1u);
    int rank = i0;  // no key lies below the prefix
    while (bits > 0) {
      const int d = min(kDigitBits, bits), shift = bits - d;
      const uint32_t fixed = bits == 32 ? 0u : ~((1u << bits) - 1u), digit = (1u << d) - 1u;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        if ((key[i] & fixed) == prefix) atomicAdd(&sp.bins[(key[i] >> shift) & digit], 1);
      }
      group_sync(kBarSelect, kScreenGroup);
      // thread q scans bins [8q, 8q + 8) (two int4 reads), zeroing them
      // for the next pass
      int4* own = reinterpret_cast<int4*>(&sp.bins[q * 8]);
      const int4 b0 = own[0], b1 = own[1];
      own[0] = own[1] = make_int4(0, 0, 0, 0);
      const int c[8] = {b0.x, b0.x + b0.y, b0.x + b0.y + b0.z, b0.x + b0.y + b0.z + b0.w,
                        b0.x + b0.y + b0.z + b0.w + b1.x, b0.x + b0.y + b0.z + b0.w + b1.x + b1.y,
                        b0.x + b0.y + b0.z + b0.w + b1.x + b1.y + b1.z,
                        b0.x + b0.y + b0.z + b0.w + b1.x + b1.y + b1.z + b1.w};
      const int mine = c[7];
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFullWarp, incl, o);
        if (lane >= o) incl += u;
      }
      int(*wt)[2] = reinterpret_cast<int(*)[2]>(sp.part[round & 1]);
      if (lane == 31) wt[warp][0] = incl;
      group_sync(kBarSelect, kScreenGroup);
      int base = incl - mine;
      for (int w = 0; w < warp; ++w) base += wt[w][0];
      if (rank >= base && rank < base + mine) {
        int j = 8, before = 0;
#pragma unroll
        for (int u = 7; u >= 0; --u) {
          if (base + c[u] > rank) {
            j = u;
            before = u > 0 ? c[u - 1] : 0;
          }
        }
        sp.found[0] = q * 8 + j;
        sp.found[1] = rank - base - before;
      }
      group_sync(kBarSelect, kScreenGroup);
      prefix |= uint32_t(sp.found[0]) << shift;
      rank = sp.found[1];
      bits = shift;
      ++round;
    }
  }
  k0 = prefix;
  clk.lap(clk.passes);
  if (i1 == i0) {
    k1 = k0;
    return;
  }
  uint32_t le = 0, above = 0xFFFFFFFFu;  // kKeyNaN: what i1 reads when nothing is larger
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    le += key[i] <= k0;  // padding counts only when k0 is kKeyNaN, where i1 < le anyway
    if (key[i] > k0) above = min(above, key[i]);
  }
  uint32_t unused = 0;
  select_round<true>(above, unused, sp, round);
  select_round<false>(le, unused, sp, round);
  k1 = i1 < int(le) ? k0 : above;
  clk.lap(clk.pair);
}

template <int KPT>
__global__ void __launch_bounds__(kScreenThreads, KPT <= 16 ? 2 : 1) triage_kernel(ScreenArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red_d[kGroupWarps * 2];
  __shared__ float red_f[kGroupWarps * 2];
  __shared__ int red_i[kGroupWarps * 4];
  __shared__ double tot[kScanChunks];
  __shared__ int wsum[kScreenThreads / 32];
  __shared__ SelectSpace sel;
  __shared__ float first_s, mad_s, rob_s;
  const int row = blockIdx.x, T = a.T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t off = size_t(row) * T;
  const bool timed = a.clocks != nullptr;
  long long c_start = timed ? clock64() : 0, c_mark = c_start;
  long long* clk = timed ? a.clocks + size_t(row) * kScreenPhases : nullptr;
  auto lap = [&](int k) {
    if (timed) {
      const long long c = clock64();
      if ((tid == 0 && k < 4) || (tid == kScreenGroup && k >= 4)) clk[k] = c - c_mark;
      c_mark = c;
    }
  };

  Row r;
  r.T = T;
  r.per = (T + kScanChunks - 1) / kScanChunks;
  r.stride = r.per | 1;
  r.inv_per = 1.0f / float(r.per);
  r.nw = (T + 31) / 32;
  r.window = a.window;
  double* S = reinterpret_cast<double*>(smem);
  float* xs = reinterpret_cast<float*>(S + size_t(kScanChunks) * r.stride);
  uint32_t* hbits = reinterpret_cast<uint32_t*>(xs + size_t(kScanChunks) * r.stride);
  uint32_t* cbits = hbits + r.nw + 1;
  uint32_t* rbits = cbits + r.nw + 1;
  int* cw = reinterpret_cast<int*>(rbits + r.nw + 1);
  r.S = S;
  r.xs = xs;
  r.hbits = hbits;
  r.cbits = cbits;
  r.cw = cw;

  // 1. stage: x into the padded layout, mask and region into bit words
  if (a.vec) {
    // 4 slots a lane: x as float4, mask and region as 4 bytes (0 or 1),
    // whose nibbles 8 lanes OR into a word
    const float4* x4 = reinterpret_cast<const float4*>(a.x + off);
    const uint32_t* m4 = reinterpret_cast<const uint32_t*>(a.mask + off);
    const uint32_t* g4 = reinterpret_cast<const uint32_t*>(a.region + off);
    const int nv = T / 4;
#pragma unroll 2
    for (int v0 = warp * 32; v0 < nv; v0 += kScreenThreads) {
      const int v = v0 + lane;
      const bool in = v < nv;
      const float4 xv = in ? x4[v] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const uint32_t mb = in ? m4[v] : 0u, gb = in ? g4[v] : 0u;
      if (in) {
        xs[r.idx(4 * v)] = xv.x;
        xs[r.idx(4 * v + 1)] = xv.y;
        xs[r.idx(4 * v + 2)] = xv.z;
        xs[r.idx(4 * v + 3)] = xv.w;
      }
      const int sh = 4 * (lane & 7);
      uint32_t m = ((mb & 1u) | ((mb >> 7) & 2u) | ((mb >> 14) & 4u) | ((mb >> 21) & 8u)) << sh;
      uint32_t g = ((gb & 1u) | ((gb >> 7) & 2u) | ((gb >> 14) & 4u) | ((gb >> 21) & 8u)) << sh;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        m |= __shfl_xor_sync(kFullWarp, m, o);
        g |= __shfl_xor_sync(kFullWarp, g, o);
      }
      if ((lane & 7) == 0 && 4 * v < T) {
        hbits[v >> 3] = m & ~g;
        cbits[v >> 3] = m & g;
        rbits[v >> 3] = g;
      }
    }
  } else {
    for (int t = tid; t < T; t += kScreenThreads) xs[r.idx(t)] = a.x[off + t];
    for (int t0 = warp * 32; t0 < T; t0 += kScreenThreads) {
      const int t = t0 + lane;
      const bool in = t < T;
      const unsigned m = __ballot_sync(kFullWarp, in && a.mask[off + t]);
      const unsigned g = __ballot_sync(kFullWarp, in && a.region[off + t]);
      if (lane == 0) {
        hbits[t0 >> 5] = m & ~g;
        cbits[t0 >> 5] = m & g;
        rbits[t0 >> 5] = g;
      }
    }
  }
  for (int i = tid; i < kBins; i += kScreenThreads) sel.bins[i] = 0;
  if (tid == 0) {
    hbits[r.nw] = cbits[r.nw] = rbits[r.nw] = 0u;
    first_s = 0.0f;
  }
  __syncthreads();
  // the words' prefix counts (an exclusive scan over nw <= 512 words) and
  // the first history value
  {
    const int c = tid < r.nw ? __popc(hbits[tid]) : 0;
    int v = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullWarp, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int i = 0; i < warp; ++i) v += wsum[i];
    if (tid < r.nw) {
      cw[tid] = v - c;
      if (tid == r.nw - 1) cw[r.nw] = v;
      if (c > 0 && v == c) first_s = xs[r.idx(32 * tid + __ffs(hbits[tid]) - 1)];
    }
  }
  __syncthreads();
  r.first = first_s;
  const int nh = cw[r.nw];
  lap(0);

  if (tid < kScreenGroup) {
    // 2a. the predictor group: S in block_scan's order
    const int p = tid;
    {
      const int beg = min(p * r.per, T), end = min(beg + r.per, T);
      double* Sc = S + size_t(p) * r.stride;
      const float* xc = xs + size_t(p) * r.stride;
      double acc = 0.0;
      uint32_t hw = hbits[beg >> 5];
      for (int s = beg; s < end; ++s) {
        if ((s & 31) == 0) hw = hbits[s >> 5];
        acc = acc + (((hw >> (s & 31)) & 1u) ? double(xc[s - beg]) : 0.0);
        Sc[s - beg] = acc;
      }
      tot[p] = acc;
      group_sync(kBarPredict, kScreenGroup);
      for (int o = 1; o < kScanChunks; o <<= 1) {
        const double u = p >= o ? tot[p - o] : 0.0;
        group_sync(kBarPredict, kScreenGroup);
        tot[p] = tot[p] + u;
        group_sync(kBarPredict, kScreenGroup);
      }
      const double pre = p > 0 ? tot[p - 1] : 0.0;
      for (int s = beg; s < end; ++s) Sc[s - beg] = pre + Sc[s - beg];
      group_sync(kBarPredict, kScreenGroup);
    }
    lap(1);

    // sigma over the history slots, in kernel B's order. kUnroll slots'
    // windowed means are computed branch-free side by side (a slot past T
    // reads slot T - 1; an empty window's 0/0 is dropped), the rare freeze
    // fills after them, then the squares are summed in turn.
    constexpr int kUnroll = 4;
    Predictor pred;
    float ss[1] = {0.0f};
    for (int t0 = p; t0 < T; t0 += kUnroll * kScanChunks) {
      float e[kUnroll];
      bool h[kUnroll], filled[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = min(t0 + u * kScanChunks, T - 1);
        const int lo = min(max(t - r.window, 0), t);
        const int chi = r.count(t), clo = r.count(lo);
        h[u] = t0 + u * kScanChunks < T && r.hist(t);
        filled[u] = chi > clo;
        const float mean = float((r.sum(t) - r.sum(lo)) / double(chi - clo));
        e[u] = xs[r.idx(t)] - mean;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (h[u] && !filled[u]) {
          const int t = t0 + u * kScanChunks;
          e[u] = xs[r.idx(t)] - pred(r, t);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (h[u]) ss[0] += e[u] * e[u];
      }
    }
    group_reduce(ss, red_f, Add<float>(), kBarPredict);
    const float sigma = nh >= 2 ? sqrtf(ss[0] / fmaxf(float(nh), 1.0f)) : CUDART_INF_F;
    lap(2);

    // the policy band and the shrunk band over the region slots
    const float thr = a.threshold[row];
    const float w_real = thr * sigma;
    const float w_shrunk = (thr - a.margin[row]) * sigma;
    const float mlb = a.min_lower_bound[row];
    int mode = a.bound_mode[row];
    mode = mode == 0 ? 3 : mode;
    int n[4] = {0, 0, 0, 0};  // count, shrunk, checked, region
    double sums[2] = {0.0, 0.0};
    float dev_max[1] = {0.0f};
    for (int t = p; t < T; t += kScanChunks) {
      if (!((rbits[t >> 5] >> (t & 31)) & 1u)) continue;
      const float pr = pred(r, t);
      const float v = xs[r.idx(t)];
      const float up = pr + w_real;
      const float lo = nan_max(pr - w_real, mlb);
      const float up_s = pr + w_shrunk;
      const float lo_s = nan_max(pr - w_shrunk, mlb);
      const bool chk = (cbits[t >> 5] >> (t & 31)) & 1u;
      n[0] += chk && (((v > up) && (mode & 1)) || ((v < lo) && (mode & 2)));
      n[1] += chk && (((v > up_s) && (mode & 1)) || ((v < lo_s) && (mode & 2)));
      n[2] += chk;
      n[3] += 1;
      sums[0] += double(up);
      sums[1] += double(lo);
      if (chk) dev_max[0] = nan_max(dev_max[0], fabsf(v - pr));
    }
    group_reduce(n, red_i, Add<int>(), kBarPredict);
    group_reduce(sums, red_d, Add<double>(), kBarPredict);
    group_reduce(dev_max, red_f, NanMax(), kBarPredict);
    lap(3);
    __syncthreads();  // the select group's median and MAD
    if (tid == 0) {
      const double n_r = double(max(n[3], 1));
      const float scale = nan_max(1.4826f * mad_s, isfinite(sigma) ? sigma : 0.0f);
      a.count[row] = n[0];
      a.shrunk_count[row] = n[1];
      a.checked[row] = n[2];
      a.n_hist[row] = nh;
      a.upper_mean[row] = float(sums[0] / n_r);
      a.lower_mean[row] = float(sums[1] / n_r);
      a.resid_z[row] = dev_max[0] / nan_max(sigma, 1e-30f);
      a.robust_z[row] = nh > 0 ? rob_s / nan_max(scale, 1e-30f) : 0.0f;
      a.sigma[row] = sigma;
      if (timed) clk[9] = clock64() - c_start;
    }
    return;
  }

  // 2b. the select group: median and MAD of the history from keys in
  // registers, thread q holding slots q + 256 i
  const int q = tid - kScreenGroup;
  uint32_t key[KPT];
  uint32_t is_hist[(KPT + 31) / 32] = {};
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int t = q + kScreenGroup * i;
    const bool h = t < T && r.hist(t);
    key[i] = t < T ? (h ? order_key(xs[r.idx(t)]) : kKeyInf) : kKeyPad;
    is_hist[i >> 5] |= uint32_t(h) << (i & 31);
  }
  const int i0 = min(max(nh > 0 ? (nh - 1) / 2 : 0, 0), T - 1);
  const int i1 = min(max(nh / 2, 0), T - 1);
  lap(4);
  int round = 0;
  uint32_t k0, k1;
  SelectClocks sc{timed, 0, 0, 0, 0};
  select_pair<KPT>(key, is_hist, nh, i0, i1, k0, k1, sel, round, sc);
  const float med = 0.5f * (key_value(k0) + key_value(k1));
  if (timed) c_mark = clock64();
  float rob[1] = {0.0f};
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int t = q + kScreenGroup * i;
    if (t < T) {
      const float d = fabsf(xs[r.idx(t)] - med);
      key[i] = ((is_hist[i >> 5] >> (i & 31)) & 1u) ? order_key(d) : kKeyInf;
      if ((r.cbits[t >> 5] >> (t & 31)) & 1u) rob[0] = nan_max(rob[0], d);
    }
  }
  lap(8);
  select_pair<KPT>(key, is_hist, nh, i0, i1, k0, k1, sel, round, sc);
  group_reduce(rob, red_f + kGroupWarps, NanMax(), kBarSelect);
  if (timed && q == 0) {
    clk[5] = sc.minmax;
    clk[6] = sc.passes;
    clk[7] = sc.pair;
  }
  if (q == 0) {
    mad_s = 0.5f * (key_value(k0) + key_value(k1));
    rob_s = rob[0];
  }
  __syncthreads();
}

}  // namespace fm

static size_t triage_smem(int T) {
  const size_t per = (T + fm::kScanChunks - 1) / fm::kScanChunks, stride = per | 1;
  const size_t nw = (T + 31) / 32;
  return fm::kScanChunks * stride * 12 + (nw + 1) * 16;
}

template <int KPT>
static int launch_screen(const fm::ScreenArgs& a, int B, cudaStream_t st) {
  const size_t smem = triage_smem(a.T);
  cudaError_t e = cudaFuncSetAttribute(fm::triage_kernel<KPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  fm::triage_kernel<KPT><<<B, fm::kScreenThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}

extern "C" int fm_triage_screen(const float* x, const uint8_t* mask, const uint8_t* region,
                                const float* threshold, const int* bound_mode,
                                const float* min_lower_bound, const float* margin, int window,
                                int B, int T, int* count, int* shrunk_count, int* checked,
                                int* n_hist, float* upper_mean, float* lower_mean, float* resid_z,
                                float* robust_z, float* sigma, long long* clocks,
                                void* stream) {
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(region) % 4 == 0;
  fm::ScreenArgs a{x, mask, region, threshold, bound_mode, min_lower_bound, margin, window, T,
                   count, shrunk_count, checked, n_hist, upper_mean, lower_mean, resid_z,
                   robust_z, sigma, clocks, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // keys a select thread holds: ceil(T / 256), rounded up to an instance
  const int kpt = (T + fm::kScreenGroup - 1) / fm::kScreenGroup;
  if (T < 1 || kpt > 64) return int(cudaErrorInvalidValue);
  if (kpt <= 8) return launch_screen<8>(a, B, st);
  if (kpt <= 16) return launch_screen<16>(a, B, st);
  if (kpt <= 32) return launch_screen<32>(a, B, st);
  return launch_screen<64>(a, B, st);
}
