// CUDA kernels for the batch-last DSGE likelihood, a group of lanes per
// particle (smc::kReLanes for the RE solve, smc::kKalmanLanes for the Kalman
// filter; bodies in dsge_particle.cuh), with plain C launchers (bound from
// Python with ctypes, ops/cuda_dsge.py).
//
// re_kernel      replaces smc_tpu/ops/pallas_dsge.py::_re_kernel
// kalman_kernel  replaces smc_tpu/ops/pallas_dsge.py::_kalman_kernel
//
// A block is kWarps warps; each warp takes 32 / G neighbouring particles and
// owns a slice of the block's dynamic shared memory for its groups' tiles
// (the Kalman kernel stages the observations after them, once per
// block). A warp past the last particle leaves as a whole; inside a warp
// every lane runs every exchange, padding rows and missing particles too.
//
// Each launcher launches on the given stream, does not synchronise, and
// returns cudaGetLastError() as an int (nonzero: the launch was refused).
// Sizes other than the instantiated (n_state, n_shock) pairs return -1.
#include <cuda_runtime.h>

#include "dsge_particle.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * smc::kWarp;
constexpr int RG = smc::kReLanes;
constexpr int KG = smc::kKalmanLanes;

template <int NS, int G>
long long n_warps(long long n) {
  constexpr int P = smc::Group<NS, G>::kPerWarp;
  return (n + P - 1) / P;
}

unsigned int n_blocks(long long warps) {
  return (unsigned int)((warps + kWarps - 1) / kWarps);
}

template <int NS, int NK>
__global__ void __launch_bounds__(kThreads)
re_kernel(const double* __restrict__ A, const double* __restrict__ B,
          const double* __restrict__ C, const double* __restrict__ D,
          double* __restrict__ X, double* __restrict__ M,
          unsigned char* __restrict__ ok, long long n, long long warps,
          int n_iter, double tol) {
  extern __shared__ __align__(16) double smem[];
  const int w = threadIdx.x / smc::kWarp;
  const long long warp = (long long)blockIdx.x * kWarps + w;
  if (warp >= warps) return;
  smc::re_solve_warp<NS, NK, RG>(
      A, B, C, D, X, M, ok, n, warp, n_iter, tol,
      smem + w * smc::ReTile<NS, RG>::kWarpDoubles);
}

template <int NS, int NK>
__global__ void __launch_bounds__(kThreads)
kalman_kernel(const double* __restrict__ T, const double* __restrict__ R,
              const double* __restrict__ Q, const double* __restrict__ Z,
              const double* __restrict__ d, const double* __restrict__ H,
              const double* __restrict__ data, int n_t,
              const unsigned char* __restrict__ ok, long long n,
              long long warps, int lyap_iter, double* __restrict__ out) {
  extern __shared__ __align__(16) double smem[];
  double* ys = smem + kWarps * smc::KalmanTile<NS, KG>::kWarpDoubles;
  for (int i = threadIdx.x; i < smc::kNObs * n_t; i += blockDim.x)
    ys[i] = data[i];
  __syncthreads();
  const int w = threadIdx.x / smc::kWarp;
  const long long warp = (long long)blockIdx.x * kWarps + w;
  if (warp >= warps) return;
  smc::kalman_warp<NS, NK, KG>(
      T, R, Q, Z, d, H, ys, n_t, ok, n, warp, lyap_iter, out,
      smem + w * smc::KalmanTile<NS, KG>::kWarpDoubles);
}

template <int NS, int NK>
int launch_re(const double* A, const double* B, const double* C,
              const double* D, double* X, double* M, unsigned char* ok,
              long long n, int n_iter, double tol, cudaStream_t s) {
  const long long warps = n_warps<NS, RG>(n);
  const size_t smem =
      sizeof(double) * kWarps * smc::ReTile<NS, RG>::kWarpDoubles;
  re_kernel<NS, NK><<<n_blocks(warps), kThreads, smem, s>>>(
      A, B, C, D, X, M, ok, n, warps, n_iter, tol);
  return (int)cudaGetLastError();
}

template <int NS>
size_t kalman_smem(int n_t) {
  return sizeof(double) * (smc::kNObs * (size_t)n_t +
                           kWarps * smc::KalmanTile<NS, KG>::kWarpDoubles);
}

template <int NS, int NK>
int launch_kalman(const double* T, const double* R, const double* Q,
                  const double* Z, const double* d, const double* H,
                  const double* data, int n_t, const unsigned char* ok,
                  long long n, int lyap_iter, double* out, cudaStream_t s) {
  const long long warps = n_warps<NS, KG>(n);
  const size_t smem = kalman_smem<NS>(n_t);
  kalman_kernel<NS, NK><<<n_blocks(warps), kThreads, smem, s>>>(
      T, R, Q, Z, d, H, data, n_t, ok, n, warps, lyap_iter, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define SMC_SIZES(X) X(6, 3) X(3, 3)

// Allow every kernel dynamic shared memory up to `bytes` on the current
// device (above the default 48 KB it must be allowed per kernel). Called
// once per device before the first launch, so no launch, and no launch
// inside a CUDA graph capture, sets an attribute. Returns the first error.
extern "C" int smc_dsge_prepare(int bytes) {
  cudaError_t e = cudaSuccess, f;
#define SMC_CASE(NS, NK)                                                   \
  f = cudaFuncSetAttribute(re_kernel<NS, NK>,                              \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           bytes);                                         \
  if (e == cudaSuccess) e = f;                                             \
  f = cudaFuncSetAttribute(kalman_kernel<NS, NK>,                          \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           bytes);                                         \
  if (e == cudaSuccess) e = f;
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return (int)e;
}

extern "C" int smc_re_solve(int n_s, int n_k, const double* A, const double* B,
                            const double* C, const double* D, double* X,
                            double* M, unsigned char* ok, long long n,
                            int n_iter, double tol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SMC_CASE(NS, NK)         \
  if (n_s == NS && n_k == NK) \
    return launch_re<NS, NK>(A, B, C, D, X, M, ok, n, n_iter, tol, s);
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return -1;
}

extern "C" long long smc_kalman_smem_bytes(int n_s, int n_t) {
#define SMC_CASE(NS, NK) \
  if (n_s == NS) return (long long)kalman_smem<NS>(n_t);
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return -1;
}

extern "C" int smc_kalman(int n_s, int n_k, const double* T, const double* R,
                          const double* Q, const double* Z, const double* d,
                          const double* H, const double* data, int n_t,
                          const unsigned char* ok, long long n, int lyap_iter,
                          double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SMC_CASE(NS, NK)                                                      \
  if (n_s == NS && n_k == NK)                                                 \
    return launch_kalman<NS, NK>(T, R, Q, Z, d, H, data, n_t, ok, n,          \
                                 lyap_iter, out, s);
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return -1;
}
