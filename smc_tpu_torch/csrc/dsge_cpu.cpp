// The warp bodies of dsge_particle.cuh compiled by a host compiler: a loop
// over warps, each warp's 32 lanes run phase by phase (see the header), with
// the warp's tile in a local buffer. Only the tests use this library: it
// checks the kernels' arithmetic, group layout and exchanges against the
// plain PyTorch versions on a machine without a GPU. Same C interface as
// dsge_kernels.cu, minus the stream; a call returns -2 if a body made a
// 16-byte tile load that is not 16-byte aligned (a fault on the card).
#include <math.h>

#include <vector>

#include "dsge_particle.cuh"

#define SMC_SIZES(X) X(6, 3) X(3, 3)

namespace {

template <int NS, int NK>
void re_all(const double* A, const double* B, const double* C,
            const double* D, double* X, double* M, unsigned char* ok,
            long long n, int n_iter, double tol) {
  constexpr int G = smc::kReLanes;
  constexpr int P = smc::Group<NS, G>::kPerWarp;
  std::vector<double> tile(smc::ReTile<NS, G>::kWarpDoubles);
  for (long long w = 0; w * P < n; ++w)
    smc::re_solve_warp<NS, NK, G>(A, B, C, D, X, M, ok, n, w, n_iter, tol,
                                  tile.data());
}

template <int NS, int NK>
void kalman_all(const double* T, const double* R, const double* Q,
                const double* Z, const double* d, const double* H,
                const double* data, int n_t, const unsigned char* ok,
                long long n, int lyap_iter, double* out) {
  constexpr int G = smc::kKalmanLanes;
  constexpr int P = smc::Group<NS, G>::kPerWarp;
  std::vector<double> tile(smc::KalmanTile<NS, G>::kWarpDoubles);
  for (long long w = 0; w * P < n; ++w)
    smc::kalman_warp<NS, NK, G>(T, R, Q, Z, d, H, data, n_t, ok, n, w,
                                lyap_iter, out, tile.data());
}

}  // namespace

extern "C" int smc_re_solve_cpu(int n_s, int n_k, const double* A,
                                const double* B, const double* C,
                                const double* D, double* X, double* M,
                                unsigned char* ok, long long n, int n_iter,
                                double tol) {
#define SMC_CASE(NS, NK)                                  \
  if (n_s == NS && n_k == NK) {                           \
    smc::misaligned_loads() = 0;                          \
    re_all<NS, NK>(A, B, C, D, X, M, ok, n, n_iter, tol); \
    return smc::misaligned_loads() ? -2 : 0;              \
  }
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return -1;
}

extern "C" int smc_kalman_cpu(int n_s, int n_k, const double* T,
                              const double* R, const double* Q,
                              const double* Z, const double* d,
                              const double* H, const double* data, int n_t,
                              const unsigned char* ok, long long n,
                              int lyap_iter, double* out) {
#define SMC_CASE(NS, NK)                                                   \
  if (n_s == NS && n_k == NK) {                                            \
    smc::misaligned_loads() = 0;                                           \
    kalman_all<NS, NK>(T, R, Q, Z, d, H, data, n_t, ok, n, lyap_iter, out); \
    return smc::misaligned_loads() ? -2 : 0;                               \
  }
  SMC_SIZES(SMC_CASE)
#undef SMC_CASE
  return -1;
}
