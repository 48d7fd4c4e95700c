// CUDA kernel for the symmetric eigendecomposition of the mutation's
// proposal factor (body and paths in eigh_jacobi.cuh), with a plain C
// launcher bound from Python with ctypes (ops/cuda_eigh.py). One launch
// takes up to two parts of matrices of one size each (the mutation's equal
// blocks and its smaller last one): two warps per matrix up to kWarpK, a
// block of kBlockThreads per matrix past it. Tiles live in dynamic shared
// memory, whose limit smc_eigh_prepare raises once per device; past
// kSharedK A and V live in a global workspace the caller provides.
#include <cuda_runtime.h>

#include "eigh_jacobi.cuh"

namespace {

using namespace smc_jacobi;

__global__ void __launch_bounds__(kBlockThreads)
eigh_kernel(Part p0, Part p1, const double* __restrict__ a,
            double* __restrict__ lam, double* __restrict__ u,
            double* __restrict__ work) {
  extern __shared__ __align__(16) double smem[];
  long long blk = blockIdx.x;
  const bool first = blk < p0.blocks;
  const Part p = first ? p0 : p1;
  if (!first) blk -= p0.blocks;
  const int k = p.k;
  const int w = k <= kWarpK ? (int)(threadIdx.x / kSmallThreads) : 0;
  const long long b = blk * per_block(k) + w;
  if (w >= per_block(k) || b >= p.n) return;  // a whole team, or no one
  const long long kk = (long long)k * k;
  eigh_one(a + p.a0 + b * kk, lam + p.lam0 + b * k, u + p.a0 + b * kk, k,
           smem + w * (tile_bytes(k) / sizeof(double)),
           k > kSharedK ? work + p.work0 + b * (long long)av_doubles(k)
                        : nullptr);
}

}  // namespace

// Raise the kernel's dynamic shared memory limit on the current device to
// the most any launch needs. Called once per device before the first
// launch, so no launch (and no launch inside a CUDA graph capture) sets an
// attribute.
extern "C" int smc_eigh_prepare() {
  size_t most = 0;
  for (int k = 1; k <= kMaxK; ++k) {
    const size_t s = part_smem(part(k, kBlockThreads, 0, 0, 0));
    most = s > most ? s : most;
  }
  return (int)cudaFuncSetAttribute(
      eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
}

// n0 matrices of k0 x k0 then n1 of k1 x k1, packed in a -> lam, u packed
// the same way, on `stream`, with `work` holding av_doubles(k) for each
// matrix of a part with k > kSharedK (else unused, may be null); returns
// cudaGetLastError() (nonzero: the launch was refused), -1 for a k outside
// 1..kMaxK or a missing workspace. Does not synchronise.
extern "C" int smc_eigh(int k0, long long n0, int k1, long long n1,
                        const double* a, double* lam, double* u, double* work,
                        void* stream) {
  if (n0 < 0 || n1 < 0) return -1;
  if (n1 == 0) k1 = k0;
  if (k0 < 1 || k0 > kMaxK || k1 < 1 || k1 > kMaxK) return -1;
  if (((n0 > 0 && k0 > kSharedK) || (n1 > 0 && k1 > kSharedK)) &&
      work == nullptr)
    return -1;
  const Part p0 = part(k0, n0, 0, 0, 0);
  const Part p1 = part(k1, n1, n0 * k0 * k0, n0 * k0,
                       k0 > kSharedK ? n0 * (long long)av_doubles(k0) : 0);
  const long long blocks = p0.blocks + p1.blocks;
  if (blocks == 0) return 0;
  const size_t s0 = part_smem(p0), s1 = part_smem(p1);
  eigh_kernel<<<(unsigned int)blocks, kBlockThreads, s0 > s1 ? s0 : s1,
                static_cast<cudaStream_t>(stream)>>>(p0, p1, a, lam, u,
                                                     work);
  return (int)cudaGetLastError();
}
