// The Jacobi body of eigh_jacobi.cuh compiled by a host compiler: each
// matrix's team of threads (two warps up to kWarpK, a block past it) runs
// phase by phase (lanes.cuh), with the team's tile, and past kSharedK its
// workspace, in local buffers. Only the tests use this library: it checks
// the kernel's arithmetic on a machine without a GPU. Same C interface as
// eigh_kernel.cu, minus the workspace (allocated here) and the stream.
#include <vector>

#include "eigh_jacobi.cuh"

extern "C" int smc_eigh_cpu(int k0, long long n0, int k1, long long n1,
                            const double* a, double* lam, double* u) {
  using namespace smc_jacobi;
  if (n0 < 0 || n1 < 0) return -1;
  if (n1 == 0) k1 = k0;
  if (k0 < 1 || k0 > kMaxK || k1 < 1 || k1 > kMaxK) return -1;
  const int ks[2] = {k0, k1};
  const long long ns[2] = {n0, n1};
  for (int h = 0; h < 2; ++h) {
    const int k = ks[h];
    std::vector<double> tile(tile_bytes(k) / sizeof(double));
    std::vector<double> av(k > kSharedK ? av_doubles(k) : 0);
    for (long long b = 0; b < ns[h]; ++b) {
      eigh_one(a, lam, u, k, tile.data(), av.empty() ? nullptr : av.data());
      a += (long long)k * k;
      u += (long long)k * k;
      lam += k;
    }
  }
  return 0;
}
