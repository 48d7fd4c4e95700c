// The Jacobi body of eigh_jacobi.cuh compiled by a host compiler: each
// matrix's block of threads runs phase by phase (see the header), with the
// block's shared memory, and past kSharedK its workspace, in local buffers.
// Only the tests use this library: it checks the kernel's arithmetic on a
// machine without a GPU. Same C interface as eigh_kernel.cu, minus the
// workspace (allocated here) and the stream.
#include <vector>

#include "eigh_jacobi.cuh"

extern "C" int smc_eigh_cpu(int k, long long batch, const double* a,
                            double* lam, double* u) {
  if (k < 1 || k > smc_jacobi::kMaxK) return -1;
  std::vector<double> smem(smc_jacobi::smem_bytes(k) / sizeof(double) + 1);
  std::vector<double> av(k > smc_jacobi::kSharedK ? smc_jacobi::av_doubles(k)
                                                  : 0);
  for (long long b = 0; b < batch; ++b)
    smc_jacobi::eigh_block(a + b * k * k, lam + b * k, u + b * k * k, k,
                           smem.data(), av.empty() ? nullptr : av.data());
  return 0;
}
