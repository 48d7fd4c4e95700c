// The threads of a warp or a block, written once for the card and the host.
//
// On the card a thread runs its own code: SMC_TEAM(N, t) runs its body once
// with t = the thread's place in its team of N threads (threadIdx.x % N: the
// lane for a warp, the thread for a block of N), Lanes<T, N> is the thread's
// own T, team_sync<N>() is __syncwarp() for a warp, __syncthreads() for a
// block and a named barrier (one of 15) for a team of whole warps within a
// block, and group_sum adds with __shfl_xor_sync. Under a host compiler
// (dsge_cpu.cpp, eigh_cpu.cpp) SMC_TEAM(N, t) loops t over the N threads,
// Lanes<T, N> holds one T per thread and team_sync does nothing: every phase
// between two syncs runs for all threads before the next one starts, which
// is what the barrier guarantees on the card. Code between two syncs reads
// only shared entries written before the first of them, and writes only
// entries that no other thread reads in that phase, so the host loop
// computes the card's bits (up to the card's fused multiply-adds).
#pragma once

#ifdef __CUDACC__
#define SMC_HD __host__ __device__
#define SMC_UNROLL _Pragma("unroll")
#define SMC_PRAGMA(x) _Pragma(#x)
#define SMC_UNROLL_BY(k) SMC_PRAGMA(unroll k)
#else
#define SMC_HD
#define SMC_UNROLL
#define SMC_UNROLL_BY(k)
#endif

namespace smc {

constexpr int kWarp = 32;

#ifdef __CUDA_ARCH__
template <class T, int N = kWarp>
struct Lanes {
  T v;
  __device__ T& operator[](int) { return v; }
};
#define SMC_TEAM(N, t)                                            \
  for (int t = (int)(threadIdx.x % (N)), t##_once = 1; t##_once; \
       t##_once = 0)
template <int N>
__device__ inline void team_sync() {
  if (N == kWarp)
    __syncwarp();
  else if (N == (int)blockDim.x)
    __syncthreads();
  else  // the N threads of this team, the block's (threadIdx.x / N)-th
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / N), "n"(N)
                 : "memory");
}
__device__ inline void smc_sync() { __syncwarp(); }
__device__ inline bool warp_any(Lanes<bool>& x) {
  return __any_sync(0xffffffffu, x[0]);
}
#else
template <class T, int N = kWarp>
struct Lanes {
  T v[N];
  T& operator[](int l) { return v[l]; }
};
#define SMC_TEAM(N, t) for (int t = 0; t < (N); ++t)
template <int N>
inline void team_sync() {}
inline void smc_sync() {}
inline bool warp_any(Lanes<bool>& x) {
  bool a = false;
  for (int l = 0; l < kWarp; ++l) a = a || x[l];
  return a;
}
#endif

// the lanes of one warp
#define SMC_LANES(l) SMC_TEAM(smc::kWarp, l)

// v <- the sum of v over the G lanes of each group (G <= 32, groups within
// a warp), by a butterfly of shuffles: every lane of a group ends with the
// same bits (each addition is of the same two values, in either order).
template <int G, int K, int N>
SMC_HD inline void group_sum(Lanes<double[K], N>& v) {
  static_assert(G <= kWarp && N % kWarp == 0, "groups lie within a warp");
#ifdef __CUDA_ARCH__
  SMC_UNROLL for (int m = 1; m < G; m <<= 1)
    SMC_UNROLL for (int k = 0; k < K; ++k)
      v[0][k] += __shfl_xor_sync(0xffffffffu, v[0][k], m);
#else
  for (int m = 1; m < G; m <<= 1) {
    static thread_local Lanes<double[K], N> o;
    o = v;
    for (int l = 0; l < N; ++l)
      for (int k = 0; k < K; ++k) v[l][k] = o[l][k] + o[l ^ m][k];
  }
#endif
}

}  // namespace smc
