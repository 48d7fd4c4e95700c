// CUDA kernel for the symmetric eigendecomposition of the mutation's
// proposal factor (body in eigh_jacobi.cuh), with a plain C launcher bound
// from Python with ctypes (ops/cuda_eigh.py). One block of
// smc_jacobi::kThreads threads per matrix; the round's (c, s) pairs and
// sums, and up to k = kSharedK the matrix and the rotations, live in dynamic
// shared memory (69 KiB at k = 64, whose limit smc_eigh_prepare raises once
// per device); past kSharedK the matrix and the rotations live in a global
// workspace the caller provides.
#include <cuda_runtime.h>

#include "eigh_jacobi.cuh"

namespace {

__global__ void __launch_bounds__(smc_jacobi::kThreads)
eigh_kernel(int k, const double* __restrict__ a, double* __restrict__ lam,
            double* __restrict__ u, double* __restrict__ work) {
  extern __shared__ __align__(16) double smem[];
  const long long b = blockIdx.x;
  double* av = k > smc_jacobi::kSharedK
                   ? work + b * (long long)smc_jacobi::av_doubles(k)
                   : nullptr;
  smc_jacobi::eigh_block(a + b * k * k, lam + b * k, u + b * k * k, k, smem,
                         av);
}

}  // namespace

// Raise the kernel's dynamic shared memory limit on the current device to
// the most any k needs. Called once per device before the first launch, so
// no launch (and no launch inside a CUDA graph capture) sets an attribute.
extern "C" int smc_eigh_prepare() {
  const size_t most =
      smc_jacobi::smem_bytes(smc_jacobi::kSharedK) >
              smc_jacobi::smem_bytes(smc_jacobi::kMaxK)
          ? smc_jacobi::smem_bytes(smc_jacobi::kSharedK)
          : smc_jacobi::smem_bytes(smc_jacobi::kMaxK);
  return (int)cudaFuncSetAttribute(
      eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
}

// a [batch][k][k] -> lam [batch][k], u [batch][k][k] on `stream`, with
// `work` [batch][av_doubles(k)] when k > kSharedK (else unused, may be
// null); returns cudaGetLastError() (nonzero: the launch was refused), -1
// for k outside 1..kMaxK or a missing workspace. Does not synchronise.
extern "C" int smc_eigh(int k, long long batch, const double* a, double* lam,
                        double* u, double* work, void* stream) {
  if (k < 1 || k > smc_jacobi::kMaxK) return -1;
  if (k > smc_jacobi::kSharedK && work == nullptr) return -1;
  if (batch == 0) return 0;
  eigh_kernel<<<(unsigned int)batch, smc_jacobi::kThreads,
                smc_jacobi::smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(
      k, a, lam, u, work);
  return (int)cudaGetLastError();
}
