// Kernel P: the fleet summary's count and top-k.
//
// Replaces the reduction of the reference's shard_map programs
// foremast_tpu/parallel/fleet.py:make_fleet_scorer (:209, body :229-245)
// and fleet_summary (:281): the count of unhealthy rows, and the k worst
// severities with their global row indices, where a healthy row's severity
// is -inf. The port runs it twice around the collectives: on each
// process's slice (a local top-k and count, rows keyed base + i by their
// global index), then, after an all_gather of the candidates, on the
// candidates keyed by their position in the gather (the caller maps a
// position back to its global index, as the reference's cand_idx[top_pos]
// does; among equal values, position order is global index order).
//
// Order: lax.top_k's. Values descend in IEEE total order (+NaN above +inf,
// -NaN below -inf, +0.0 above -0.0), equal values come lower index first.
// So a row's key is (~ordered(value) << 32) | index, ordered() the
// order-preserving unsigned of the float's bits, and the top k are the k
// smallest keys; the -inf tail carries the lowest healthy indices, as
// lax.top_k gives it across any mesh.
//
// Design: pass 1, a CTA of 256 threads per chunk of 1024 rows, builds its
// keys in shared memory, counts its unhealthy rows, sorts them (kernel A's
// bitonic sort) and keeps the first min(k, 1024); passes over the kept
// keys repeat until one chunk holds them, which one CTA sorts (only as
// many keys as there are, rounded up to a power of two) and decodes. For
// k > 512 a chunk would keep more than half of itself, so pass 1 keeps
// whole sorted chunks and one CTA sorts them all in device memory. No k
// that the reference takes (k <= B) is refused.
//
// What bounds it on an H100: at B = 100,000 and k = 8 the 500 KB of inputs
// are read once in ~0.15 us of HBM time; the time is the launches' latency
// and two chains of bitonic stages (55 over a chunk, then 55 over the 784
// kept keys), far from any bound. Chunks of 1024 rows put 98 CTAs on the
// card and cut each chain from 78 stages of 16 compares a thread (chunks
// of 4096: 0.192 ms on an H100, PERF.md) to 55 of 4.
#include "common.cuh"

namespace fm {

constexpr int kTopkThreads = 256;
constexpr int kTopkChunk = 1024;

__device__ __forceinline__ uint32_t total_order(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_total_order(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ uint64_t topk_key(float v, uint32_t index) {
  return (uint64_t(~total_order(v)) << 32) | index;
}

struct TopkIn {
  const float* values;      // pass 1: the severities
  const uint8_t* valid;     // pass 1: null, or the unhealthy flags
  long long base;           // pass 1: row r is keyed base + r
  const uint64_t* keys;     // later passes: the kept keys
  int n, keep;              // inputs; keys kept per chunk
  uint64_t* out;            // (chunks, keep)
  int* counts;              // pass 1 with valid: unhealthy rows per chunk
};

template <bool kFromValues>
__global__ void __launch_bounds__(kTopkThreads) topk_chunk_kernel(TopkIn a) {
  __shared__ uint64_t sk[kTopkChunk];
  __shared__ Scratch scr;
  const int lo = blockIdx.x * kTopkChunk;
  int cnt = 0;
  for (int i = threadIdx.x; i < kTopkChunk; i += blockDim.x) {
    const int r = lo + i;
    uint64_t key = kPadKey;
    if (r < a.n) {
      if constexpr (kFromValues) {
        const bool ok = a.valid == nullptr || a.valid[r];
        cnt += ok;
        const float v = ok ? a.values[r] : -CUDART_INF_F;
        key = topk_key(v, uint32_t(a.base + r));
      } else {
        key = a.keys[r];
      }
    }
    sk[i] = key;
  }
  if (kFromValues && a.counts != nullptr) {
    cnt = block_sum(cnt, scr);
    if (threadIdx.x == 0) a.counts[blockIdx.x] = cnt;
  }
  bitonic_sort(sk, kTopkChunk);
  for (int i = threadIdx.x; i < a.keep; i += blockDim.x)
    a.out[size_t(blockIdx.x) * a.keep + i] = sk[i];
}

// One CTA sorts n_pow2 keys in device memory, the tail [n, n_pow2) padded.
__global__ void __launch_bounds__(1024) topk_global_sort_kernel(uint64_t* keys, int n,
                                                                int n_pow2) {
  for (int i = n + threadIdx.x; i < n_pow2; i += blockDim.x) keys[i] = kPadKey;
  bitonic_sort(keys, n_pow2);
}

// One CTA: sort the n <= kTopkChunk keys first (as next_pow2(n)) unless
// they are sorted, then decode the first kk; sum the chunks' counts.
__global__ void __launch_bounds__(kTopkThreads) topk_emit_kernel(
    const uint64_t* keys, int n, int sorted, int kk, const int* counts, int n_counts,
    float* out_v, long long* out_i, long long* count) {
  __shared__ uint64_t sk[kTopkChunk];
  __shared__ Scratch scr;
  if (!sorted) {
    const int n_pow2 = next_pow2(n);
    for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) sk[i] = i < n ? keys[i] : kPadKey;
    bitonic_sort(sk, n_pow2);
  }
  const uint64_t* src = sorted ? keys : sk;
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    const uint64_t key = src[i];
    out_v[i] = from_total_order(~uint32_t(key >> 32));
    out_i[i] = (long long)(key & 0xffffffffull);
  }
  if (count != nullptr) {
    long long c = 0;
    for (int i = threadIdx.x; i < n_counts; i += blockDim.x) c += counts[i];
    c = block_sum(c, scr);
    if (threadIdx.x == 0) *count = c;
  }
}

}  // namespace fm

static int chunks_of(long long n) { return int((n + fm::kTopkChunk - 1) / fm::kTopkChunk); }

// Bytes of scratch a launch over n rows at k needs: the chunk counts and
// two buffers of kept keys (the whole sorted array for k > 512).
extern "C" long long fm_fleet_topk_scratch_bytes(long long n, long long k) {
  const long long nb = chunks_of(n);
  const long long keep = k > fm::kTopkChunk / 2 ? fm::kTopkChunk : k;
  long long cap = nb * keep;
  if (k > fm::kTopkChunk / 2) cap = fm::next_pow2(int(cap));
  return ((nb * 4 + 7) / 8) * 8 + 2 * cap * 8;
}

extern "C" int fm_fleet_topk(const float* values, const uint8_t* valid, long long base, int n,
                             int k, float* out_v, long long* out_i,
                             long long* count, unsigned char* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = chunks_of(n);
  const bool global = k > fm::kTopkChunk / 2;
  const int keep = global ? fm::kTopkChunk : (k < fm::kTopkChunk ? k : fm::kTopkChunk);
  long long cap = (long long)nb * keep;
  if (global) cap = fm::next_pow2(int(cap));
  int* counts = reinterpret_cast<int*>(scratch);
  uint64_t* buf[2] = {reinterpret_cast<uint64_t*>(scratch + ((nb * 4 + 7) / 8) * 8), nullptr};
  buf[1] = buf[0] + cap;
  const int kk = k < n ? k : n;

  fm::TopkIn a{values, valid, base, nullptr, n, keep, buf[0],
               valid != nullptr ? counts : nullptr};
  fm::topk_chunk_kernel<true><<<nb, fm::kTopkThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  int cur = nb * keep, at = 0;
  if (global) {
    fm::topk_global_sort_kernel<<<1, 1024, 0, st>>>(buf[0], cur, int(cap));
  } else {
    while (cur > fm::kTopkChunk) {
      const int nbk = chunks_of(cur);
      fm::TopkIn r{nullptr, nullptr, 0, buf[at], cur, keep, buf[at ^ 1], nullptr};
      fm::topk_chunk_kernel<false><<<nbk, fm::kTopkThreads, 0, st>>>(r);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
      cur = nbk * keep;
      at ^= 1;
    }
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  fm::topk_emit_kernel<<<1, fm::kTopkThreads, 0, st>>>(
      buf[at], cur, global ? 1 : 0, kk, counts, valid != nullptr ? nb : 0, out_v, out_i,
      valid != nullptr ? count : nullptr);
  return int(cudaGetLastError());
}
