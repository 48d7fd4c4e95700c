// CUDA kernels for the batch-last DSGE likelihood, one thread per particle,
// with plain C launchers (bound from Python with ctypes, ops/cuda_dsge.py).
//
// re_kernel      replaces smc_tpu/ops/pallas_dsge.py::_re_kernel
// kalman_kernel  replaces smc_tpu/ops/pallas_dsge.py::_kalman_kernel
//
// Each launcher launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (nonzero: the launch was refused).
// Sizes other than the instantiated (n_state, n_shock) pairs return -1.
#include <cuda_runtime.h>

#include "dsge_particle.cuh"

namespace {

constexpr int kThreads = 128;

template <int NS, int NK>
__global__ void __launch_bounds__(kThreads)
re_kernel(const double* __restrict__ A, const double* __restrict__ B,
          const double* __restrict__ C, const double* __restrict__ D,
          double* __restrict__ X, double* __restrict__ M,
          unsigned char* __restrict__ ok, long long n, int n_iter, double tol) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  smc::re_solve_particle<NS, NK>(A, B, C, D, X, M, ok, n, idx, n_iter, tol);
}

// The observations [3, n_t] are shared by every particle: staged once per
// block in shared memory. `ok` (nullable) marks particles whose RE solve
// failed; they get -inf without running the filter.
template <int NS, int NK>
__global__ void __launch_bounds__(kThreads)
kalman_kernel(const double* __restrict__ T, const double* __restrict__ R,
              const double* __restrict__ Q, const double* __restrict__ Z,
              const double* __restrict__ d, const double* __restrict__ H,
              const double* __restrict__ data, int n_t,
              const unsigned char* __restrict__ ok, long long n, int lyap_iter,
              double* __restrict__ out) {
  extern __shared__ double ys[];
  for (int i = threadIdx.x; i < smc::kNObs * n_t; i += blockDim.x) ys[i] = data[i];
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (ok != nullptr && !ok[idx]) {
    out[idx] = -(double)INFINITY;
    return;
  }
  out[idx] = smc::kalman_particle<NS, NK>(T, R, Q, Z, d, H, ys, n_t, n, idx,
                                          lyap_iter);
}

inline unsigned int n_blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int smc_re_solve(int n_s, int n_k, const double* A, const double* B,
                            const double* C, const double* D, double* X,
                            double* M, unsigned char* ok, long long n,
                            int n_iter, double tol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_s == 6 && n_k == 3)
    re_kernel<6, 3><<<n_blocks(n), kThreads, 0, s>>>(A, B, C, D, X, M, ok, n,
                                                     n_iter, tol);
  else if (n_s == 3 && n_k == 3)
    re_kernel<3, 3><<<n_blocks(n), kThreads, 0, s>>>(A, B, C, D, X, M, ok, n,
                                                     n_iter, tol);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int smc_kalman(int n_s, int n_k, const double* T, const double* R,
                          const double* Q, const double* Z, const double* d,
                          const double* H, const double* data, int n_t,
                          const unsigned char* ok, long long n, int lyap_iter,
                          double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(double) * smc::kNObs * (size_t)n_t;
  if (n_s == 6 && n_k == 3)
    kalman_kernel<6, 3><<<n_blocks(n), kThreads, smem, s>>>(
        T, R, Q, Z, d, H, data, n_t, ok, n, lyap_iter, out);
  else if (n_s == 3 && n_k == 3)
    kalman_kernel<3, 3><<<n_blocks(n), kThreads, smem, s>>>(
        T, R, Q, Z, d, H, data, n_t, ok, n, lyap_iter, out);
  else
    return -1;
  return (int)cudaGetLastError();
}
