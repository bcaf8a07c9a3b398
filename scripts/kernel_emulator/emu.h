// Host emulation of the CUDA subset the port's kernels use, for g++ (C++20):
// one OS thread per CUDA thread, the blocks of a launch one after another,
// __syncthreads as a std::barrier over the block (named barriers, bar.sync
// id, n, as one std::barrier each), warp shuffles and ballots
// through a per-warp exchange buffer and barrier, __shared__ variables as
// function statics (one block runs at a time), cp.async as a plain copy.
// It checks what a kernel computes, never how fast: see emulate.py.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <type_traits>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return {a, b}; }
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint64_t buf[32];
};
// a block's named barriers (bar.sync id, n), made at their first use
struct Named {
  std::mutex mu;
  std::unique_ptr<std::barrier<>> bar[16];
  std::atomic<int> votes{0};  // __syncthreads_and
};
struct Ctx {
  uint3 tid, bid;
  dim3 bdim, gdim;
  unsigned char* smem;
  std::barrier<>* block_bar;
  Named* named;
  Warp* warp;
  int lane;
  // a cluster's launch: this block's rank, every block's shared memory, and
  // the barrier over all the cluster's threads
  unsigned crank;
  unsigned char** cluster_smem;
  std::barrier<>* cluster_bar;
};
inline thread_local Ctx ctx;
// a thread's arrival at its cluster's barrier, until its wait
inline thread_local std::optional<std::barrier<>::arrival_token> cluster_token;

inline void bar_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(ctx.named->mu);
    if (!ctx.named->bar[id]) ctx.named->bar[id].reset(new std::barrier<>(n));
    b = ctx.named->bar[id].get();
  }
  b->arrive_and_wait();
}

template <typename T>
inline T exchange(T v, int src) {
  Warp& w = *ctx.warp;
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  w.buf[ctx.lane] = u;
  w.bar.arrive_and_wait();
  uint64_t r = w.buf[src & 31];
  w.bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}

// Every lane's N doubles, gathered over the warp.
template <int N>
inline void gather(const double* mine, double (*all)[N]) {
  Warp& w = *ctx.warp;
  for (int i = 0; i < N; ++i) {
    std::memcpy(&w.buf[ctx.lane], &mine[i], 8);
    w.bar.arrive_and_wait();
    for (int l = 0; l < 32; ++l) std::memcpy(&all[l][i], &w.buf[l], 8);
    w.bar.arrive_and_wait();
  }
}

// A warp's float64 MMA D = A B + D of shape M x 8 x 4 (M = 8 or 16), the
// fragments as common.cuh lays them out (g = lane >> 2, t = lane & 3):
// A[m][k] in lane 4 (m & 7) + k, register m >> 3; B[k][n] in lane 4 n + k;
// the lane's d[2h + i] = D[g + 8h][2t + i]. Each entry sums its 4 products
// in order.
template <int M>
inline void mma_f64(double* d, const double* a, const double* b) {
  double A[32][M / 8], B[32][1];
  gather<M / 8>(a, A);
  gather<1>(b, B);
  const int g = ctx.lane >> 2, t = ctx.lane & 3;
  for (int r = 0; r < M / 4; ++r) {
    const int m = g + 8 * (r >> 1), n = 2 * t + (r & 1);
    double s = d[r];
    for (int k = 0; k < 4; ++k) s += A[4 * (m & 7) + k][m >> 3] * B[4 * n + k][0];
    d[r] = s;
  }
}

// A launch in clusters of cl blocks: a cluster's blocks run together (one
// OS thread per CUDA thread of all of them), the clusters one after another.
template <typename K, typename... Args>
void launch_cluster(K kernel, unsigned grid, unsigned nt, size_t smem, unsigned cl,
                    Args... args) {
  for (unsigned c0 = 0; c0 < grid; c0 += cl) {
    std::vector<std::vector<unsigned char>> sm(cl, std::vector<unsigned char>(smem + 64, 0xcd));
    std::vector<unsigned char*> bases(cl);
    for (unsigned r = 0; r < cl; ++r) bases[r] = sm[r].data();
    std::barrier<> cbar(cl * nt);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<Named>> named;
    std::vector<std::unique_ptr<Warp>> warps;
    for (unsigned r = 0; r < cl; ++r) {
      bars.emplace_back(new std::barrier<>(nt));
      named.emplace_back(new Named());
      for (unsigned w = 0; w < (nt + 31) / 32; ++w) warps.emplace_back(new Warp());
    }
    std::vector<std::thread> th;
    const unsigned wpb = (nt + 31) / 32;
    for (unsigned r = 0; r < cl; ++r)
      for (unsigned t = 0; t < nt; ++t) {
        th.emplace_back([&, r, t]() {
          ctx.tid = {t, 0, 0};
          ctx.bid = {c0 + r, 0, 0};
          ctx.bdim = dim3(nt);
          ctx.gdim = dim3(grid);
          ctx.smem = bases[r];
          ctx.block_bar = bars[r].get();
          ctx.named = named[r].get();
          ctx.warp = warps[r * wpb + t / 32].get();
          ctx.lane = int(t % 32);
          ctx.crank = r;
          ctx.cluster_smem = bases.data();
          ctx.cluster_bar = &cbar;
          kernel(args...);
        });
      }
    for (auto& x : th) x.join();
  }
}

template <typename K, typename... Args>
void launch(K kernel, dim3 grid, dim3 block, size_t smem, void*, Args... args) {
  const unsigned nt = block.x;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::vector<unsigned char> sm(smem + 64, 0xcd);
    std::barrier<> bar(nt);
    Named named;
    std::vector<std::unique_ptr<Warp>> warps;
    for (unsigned w = 0; w < (nt + 31) / 32; ++w) warps.emplace_back(new Warp());
    std::vector<std::thread> th;
    for (unsigned t = 0; t < nt; ++t) {
      th.emplace_back([&, t]() {
        ctx.tid = {t, 0, 0};
        ctx.bid = {b, 0, 0};
        ctx.bdim = block;
        ctx.gdim = grid;
        ctx.smem = sm.data();
        ctx.block_bar = &bar;
        ctx.named = &named;
        ctx.warp = warps[t / 32].get();
        ctx.lane = int(t % 32);
        kernel(args...);
      });
    }
    for (auto& x : th) x.join();
  }
}
}  // namespace emu

#define threadIdx (emu::ctx.tid)
#define blockIdx (emu::ctx.bid)
#define blockDim (emu::ctx.bdim)
#define gridDim (emu::ctx.gdim)
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define CUDART_INF_F INFINITY
#define CUDART_NAN_F NAN
#define CUDART_NAN NAN

template <typename A, typename B>
inline std::common_type_t<A, B> min(A a, B b) { return a < b ? a : b; }
template <typename A, typename B>
inline std::common_type_t<A, B> max(A a, B b) { return a < b ? b : a; }

using std::isfinite;

inline void __syncthreads() { emu::ctx.block_bar->arrive_and_wait(); }
// every thread's predicate, ANDed over the block, at a barrier: the failing
// votes counted, read after one barrier, cleared after another
inline int __syncthreads_and(int pred) {
  emu::Named& n = *emu::ctx.named;
  if (!pred) n.votes.fetch_add(1);
  emu::ctx.block_bar->arrive_and_wait();
  const int all = n.votes.load() == 0;
  emu::ctx.block_bar->arrive_and_wait();
  if (emu::ctx.tid.x == 0) n.votes.store(0);
  emu::ctx.block_bar->arrive_and_wait();
  return all;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu::ctx.warp->bar.arrive_and_wait(); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) { return emu::exchange(v, src); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int m) { return emu::exchange(v, emu::ctx.lane ^ m); }
template <typename T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int src = emu::ctx.lane - d;
  T r = emu::exchange(v, src < 0 ? emu::ctx.lane : src);
  return r;
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, int d) {
  const int src = emu::ctx.lane + d;
  return emu::exchange(v, src > 31 ? emu::ctx.lane : src);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::Warp& w = *emu::ctx.warp;
  w.buf[emu::ctx.lane] = pred ? 1 : 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= unsigned(w.buf[i] & 1u) << i;
  w.bar.arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0u; }
inline unsigned __match_any_sync(unsigned, unsigned v) {
  emu::Warp& w = *emu::ctx.warp;
  w.buf[emu::ctx.lane] = v;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= unsigned(w.buf[i] == v) << i;
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r += __shfl_sync(0xffffffffu, v, i);
  return r;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  unsigned r = 0xffffffffu;
  for (int i = 0; i < 32; ++i) r = std::min(r, __shfl_sync(0xffffffffu, v, i));
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r = std::max(r, __shfl_sync(0xffffffffu, v, i));
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(int(x)); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline long long clock64() { return 1; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __float_as_int(float f) {
  int u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __int_as_float(int u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <typename T>
inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <typename T>
inline T atomicOr(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_or(v);
}
template <typename T>
inline T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
// the correctly rounded float intrinsics, as the host's IEEE arithmetic rounds
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return unsigned(((static_cast<unsigned long long>(hi) << 32) | lo) >> (sh & 31));
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > 232448 ? 2 : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;  // two SMs of two CTAs: few warps, rows grid-stride
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == 0 ? "no error" : e == 1 ? "invalid argument" : "too much shared memory";
}
