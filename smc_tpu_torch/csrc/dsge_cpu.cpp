// The per-particle bodies of dsge_particle.cuh compiled by a host compiler
// into plain loops over particles. Only the tests use this library: it checks
// the kernels' arithmetic against the plain PyTorch versions on a machine
// without a GPU. Same C interface as dsge_kernels.cu, minus the stream.
#include <math.h>

#include "dsge_particle.cuh"

extern "C" int smc_re_solve_cpu(int n_s, int n_k, const double* A,
                                const double* B, const double* C,
                                const double* D, double* X, double* M,
                                unsigned char* ok, long long n, int n_iter,
                                double tol) {
  for (long long i = 0; i < n; ++i) {
    if (n_s == 6 && n_k == 3)
      smc::re_solve_particle<6, 3>(A, B, C, D, X, M, ok, n, i, n_iter, tol);
    else if (n_s == 3 && n_k == 3)
      smc::re_solve_particle<3, 3>(A, B, C, D, X, M, ok, n, i, n_iter, tol);
    else
      return -1;
  }
  return 0;
}

extern "C" int smc_kalman_cpu(int n_s, int n_k, const double* T,
                              const double* R, const double* Q,
                              const double* Z, const double* d,
                              const double* H, const double* data, int n_t,
                              const unsigned char* ok, long long n,
                              int lyap_iter, double* out) {
  for (long long i = 0; i < n; ++i) {
    if (ok != nullptr && !ok[i]) {
      out[i] = -(double)INFINITY;
    } else if (n_s == 6 && n_k == 3) {
      out[i] = smc::kalman_particle<6, 3>(T, R, Q, Z, d, H, data, n_t, n, i,
                                          lyap_iter);
    } else if (n_s == 3 && n_k == 3) {
      out[i] = smc::kalman_particle<3, 3>(T, R, Q, Z, d, H, data, n_t, n, i,
                                          lyap_iter);
    } else {
      return -1;
    }
  }
  return 0;
}
