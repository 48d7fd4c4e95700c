// CUDA kernels for the DSGE likelihood at general shapes, one block per
// particle (bodies and design in dsge_general.cuh), with plain C launchers
// bound from Python with ctypes (ops/cuda_dsge_general.py).
//
// re_general_kernel      replaces the JAX package's XLA path
//                        smc_tpu/models/dsge.py::bl_solve_linear_re
// kalman_general_kernel  replaces smc_tpu/models/dsge.py::
//                        bl_kalman_loglike_chandrasekhar (with
//                        smc_tpu/ops/linalg.py::bl_psd_fast_solve)
//
// Each kernel comes in two block sizes, kSmallTeam threads for n_state up
// to kSmallMax and kLargeTeam beyond (team_for), the Kalman kernel also in
// three widths of its innovation warp's row groups, 4, 8 or 16 lanes by
// n_obs (rows_for); the particle's tile lives in dynamic shared memory,
// whose limit smc_general_prepare raises once per device. A launcher
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (nonzero: the launch was refused), or -1 for a shape
// outside the domain or a tile past the shared memory.
#include <cuda_runtime.h>

#include "dsge_general.cuh"

namespace {

using namespace smc_general;

template <int N>
__global__ void
re_general_kernel(const double* __restrict__ A, const double* __restrict__ B,
                  const double* __restrict__ C, const double* __restrict__ D,
                  double* __restrict__ X, double* __restrict__ M,
                  unsigned char* __restrict__ ok, long long nb, int n, int k,
                  int n_iter, double tol) {
  extern __shared__ __align__(16) double smem[];
  re_block<N>(A, B, C, D, X, M, ok, nb, (long long)blockIdx.x, n, k, n_iter,
              tol, smem);
}

// The large team's: two blocks an SM (Smets-Wouters' 78 kB tile and
// sw_pi_fg's 110 kB both let two share one), so at most 128 registers a
// thread. The small team's takes no bound: with one its registers change.
template <>
__global__ void __launch_bounds__(kLargeTeam, 2)
re_general_kernel<kLargeTeam>(const double* __restrict__ A,
                              const double* __restrict__ B,
                              const double* __restrict__ C,
                              const double* __restrict__ D,
                              double* __restrict__ X, double* __restrict__ M,
                              unsigned char* __restrict__ ok, long long nb,
                              int n, int k, int n_iter, double tol) {
  extern __shared__ __align__(16) double smem[];
  re_block<kLargeTeam>(A, B, C, D, X, M, ok, nb, (long long)blockIdx.x, n, k,
                       n_iter, tol, smem);
}

// The Kalman kernel's register cap, from the threads an SM is to hold: up to
// n_obs 8, 768 (three large blocks, as many as Smets-Wouters' 62 kB tile
// lets share an SM), 80 registers a thread; beyond, the wider innovation
// rows take more: 512 (two large blocks, as many as sw_pi_fg's 100 kB tile
// lets share an SM), 128 registers. Without a cap ptxas takes more (159 at
// R = 16), and fewer blocks fit.
constexpr int kalman_threads_per_sm(int R) {
  return R <= 8 ? 3 * kLargeTeam : 2 * kLargeTeam;
}

template <int N, int R>
__global__ void __launch_bounds__(N, kalman_threads_per_sm(R) / N)
kalman_general_kernel(const double* __restrict__ T,
                      const double* __restrict__ Rm,
                      const double* __restrict__ Q,
                      const double* __restrict__ Z,
                      const double* __restrict__ d,
                      const double* __restrict__ H,
                      const double* __restrict__ data, int n_t,
                      const unsigned char* __restrict__ ok, long long nb,
                      int n, int k, int o, int lyap_iter,
                      double* __restrict__ out) {
  extern __shared__ __align__(16) double smem[];
  kalman_block<N, R>(T, Rm, Q, Z, d, H, data, n_t, ok, nb,
                     (long long)blockIdx.x, n, k, o, lyap_iter, out, smem);
}

bool in_domain(int n, int k, int o) {
  return n >= 1 && n <= kMaxState && k >= 1 && k <= kMaxShock && o >= 1 &&
         o <= kMaxObs;
}

// the Kalman instantiation that shape (n, o) takes, and its block size
using KalmanKernel = void (*)(const double*, const double*, const double*,
                              const double*, const double*, const double*,
                              const double*, int, const unsigned char*,
                              long long, int, int, int, int, double*);
struct KalmanLaunch {
  KalmanKernel kernel;
  int threads;
};
KalmanLaunch kalman_for(int n, int o) {
  const bool small = team_for(n) == kSmallTeam;
  switch (rows_for(o)) {
    case 4:
      return small ? KalmanLaunch{kalman_general_kernel<kSmallTeam, 4>,
                                  kSmallTeam}
                   : KalmanLaunch{kalman_general_kernel<kLargeTeam, 4>,
                                  kLargeTeam};
    case 8:
      return small ? KalmanLaunch{kalman_general_kernel<kSmallTeam, 8>,
                                  kSmallTeam}
                   : KalmanLaunch{kalman_general_kernel<kLargeTeam, 8>,
                                  kLargeTeam};
    default:
      return small ? KalmanLaunch{kalman_general_kernel<kSmallTeam, 16>,
                                  kSmallTeam}
                   : KalmanLaunch{kalman_general_kernel<kLargeTeam, 16>,
                                  kLargeTeam};
  }
}

}  // namespace

// Allow each kernel dynamic shared memory up to `bytes` on the current
// device. Called once per device before the first launch, so no launch
// (and none inside a CUDA graph capture) sets an attribute. Returns the
// first error.
extern "C" int smc_general_prepare(int bytes) {
  cudaError_t e = cudaSuccess, f;
#define SMC_SET(KERNEL)                                                 \
  f = cudaFuncSetAttribute(KERNEL,                                      \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, \
                           bytes);                                      \
  if (e == cudaSuccess) e = f;
  SMC_SET(re_general_kernel<kSmallTeam>)
  SMC_SET(re_general_kernel<kLargeTeam>)
  SMC_SET((kalman_general_kernel<kSmallTeam, 4>))
  SMC_SET((kalman_general_kernel<kSmallTeam, 8>))
  SMC_SET((kalman_general_kernel<kSmallTeam, 16>))
  SMC_SET((kalman_general_kernel<kLargeTeam, 4>))
  SMC_SET((kalman_general_kernel<kLargeTeam, 8>))
  SMC_SET((kalman_general_kernel<kLargeTeam, 16>))
#undef SMC_SET
  return (int)e;
}

// the tiles' bytes (-1 outside the domain)
extern "C" long long smc_general_re_smem(int n, int k) {
  return in_domain(n, k, 1) ? 8 * re_doubles(n, k) : -1;
}

extern "C" long long smc_general_kalman_smem(int n, int k, int o, int n_t) {
  return in_domain(n, k, o) && n_t >= 0 ? 8 * kalman_doubles(n, k, o) : -1;
}

// The Kalman kernel's blocks an SM of the current device at shape (n, k, o),
// for the instantiation and tile that smc_general_kalman launches (the
// occupancy calculator's answer; smc_general_prepare first), or -1 outside
// the domain or on a CUDA error.
extern "C" int smc_general_kalman_blocks_per_sm(int n, int k, int o) {
  const long long bytes = smc_general_kalman_smem(n, k, o, 0);
  if (bytes < 0 || bytes > kSmemLimit) return -1;
  const KalmanLaunch kl = kalman_for(n, o);
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kl.kernel, kl.threads, (size_t)bytes) == cudaSuccess
             ? blocks
             : -1;
}

extern "C" int smc_general_re(int n, int k, const double* A, const double* B,
                              const double* C, const double* D, double* X,
                              double* M, unsigned char* ok, long long nb,
                              int n_iter, double tol, void* stream) {
  const long long bytes = smc_general_re_smem(n, k);
  if (bytes < 0 || bytes > kSmemLimit || nb < 1 || nb > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (team_for(n) == kSmallTeam)
    re_general_kernel<kSmallTeam><<<(unsigned int)nb, kSmallTeam, bytes, s>>>(
        A, B, C, D, X, M, ok, nb, n, k, n_iter, tol);
  else
    re_general_kernel<kLargeTeam><<<(unsigned int)nb, kLargeTeam, bytes, s>>>(
        A, B, C, D, X, M, ok, nb, n, k, n_iter, tol);
  return (int)cudaGetLastError();
}

extern "C" int smc_general_kalman(int n, int k, int o, const double* T,
                                  const double* R, const double* Q,
                                  const double* Z, const double* d,
                                  const double* H, const double* data,
                                  int n_t, const unsigned char* ok,
                                  long long nb, int lyap_iter, double* out,
                                  void* stream) {
  const long long bytes = smc_general_kalman_smem(n, k, o, n_t);
  if (bytes < 0 || bytes > kSmemLimit || nb < 1 || nb > 0x7fffffffLL)
    return -1;
  const KalmanLaunch kl = kalman_for(n, o);
  const KalmanKernel kernel = kl.kernel;
  kernel<<<(unsigned int)nb, kl.threads, bytes,
           static_cast<cudaStream_t>(stream)>>>(T, R, Q, Z, d, H, data, n_t,
                                                ok, nb, n, k, o, lyap_iter,
                                                out);
  return (int)cudaGetLastError();
}
