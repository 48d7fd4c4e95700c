// The block bodies of dsge_general.cuh compiled by a host compiler: a loop
// over particles, each particle's block of threads run phase by phase
// (lanes.cuh), with the block's tile in a local buffer. Only the tests use
// this library: it checks the kernels' arithmetic on a machine without a
// GPU. Same C interface as dsge_general_kernels.cu, minus the stream.
#include <vector>

#include "dsge_general.cuh"

namespace {

using namespace smc_general;

bool in_domain(int n, int k, int o) {
  return n >= 1 && n <= kMaxState && k >= 1 && k <= kMaxShock && o >= 1 &&
         o <= kMaxObs;
}

// warp_factor and warp_solve on each of nb systems (smc_general_psd_cpu)
template <int R>
void psd_all(int o, int m, const double* F, const double* B, double* X,
             double* logdet, long long nb) {
  std::vector<double> L(o * o);
  for (long long q = 0; q < nb; ++q) {
    const double* Fq = F + q * o * o;
    const double* Bq = B + q * o * m;
    double* Xq = X + q * o * m;
    Lanes<double[Rows<R>::kRhs], kWarp> x;
    Lanes<double, kWarp> ir, ld;
    Lanes<bool, kWarp> failed;
    warp_load<R>(x, Fq, o, 0, o, o);
    warp_factor<R>(x, Fq, o, L.data(), ir, ld, failed);
    warp_load<R>(x, Bq, m, 0, o, m);
    warp_solve<R>(L.data(), o, ir, failed, x);
    warp_store<R>(x, Xq, m, o, m);
    logdet[q] = ld[0];
  }
}

}  // namespace

// the tiles' bytes, as the card's library reports them (-1 outside the
// domain)
extern "C" long long smc_general_re_smem_cpu(int n, int k) {
  return in_domain(n, k, 1) ? 8 * re_doubles(n, k) : -1;
}

extern "C" long long smc_general_kalman_smem_cpu(int n, int k, int o,
                                                 int n_t) {
  return in_domain(n, k, o) && n_t >= 0 ? 8 * kalman_doubles(n, k, o) : -1;
}

// One Gauss-Jordan elimination of W [n][w] in place (columns n..w-1 then
// hold A^-1 B) on the block that n_state n takes, each step's pivot row in
// piv_rows [n].
extern "C" int smc_general_gj_cpu(int n, int w, double* W, int* piv_rows) {
  if (!in_domain(n, 1, 1) || w <= n || w > re_width(n, kMaxShock)) return -1;
  std::vector<double> fac(n), row(w);
  if (team_for(n) == kSmallTeam)
    gauss_jordan<kSmallTeam>(W, w, n, w, fac.data(), row.data(), piv_rows);
  else
    gauss_jordan<kLargeTeam>(W, w, n, w, fac.data(), row.data(), piv_rows);
  return 0;
}

// quot on each of n pairs: q[i] = a[i] / b[i] by the kernels' division.
extern "C" int smc_general_quot_cpu(const double* a, const double* b,
                                    double* q, long long n) {
  for (long long i = 0; i < n; ++i) q[i] = quot(a[i], b[i]);
  return 0;
}

// The innovation warp's factor and solve (warp_factor, warp_solve) of each
// of nb systems: F [nb][o][o] symmetric, B [nb][o][m], m <= o + 1 -> X
// [nb][o][m] = F^-1 B and logdet [nb] (NaN where the factorization failed).
extern "C" int smc_general_psd_cpu(int o, int m, const double* F,
                                   const double* B, double* X,
                                   double* logdet, long long nb) {
  if (o < 1 || o > kMaxObs || m < 1 || m > o + 1 || nb < 0) return -1;
  switch (rows_for(o)) {
    case 4: psd_all<4>(o, m, F, B, X, logdet, nb); break;
    case 8: psd_all<8>(o, m, F, B, X, logdet, nb); break;
    default: psd_all<16>(o, m, F, B, X, logdet, nb);
  }
  return 0;
}

extern "C" int smc_general_re_cpu(int n, int k, const double* A,
                                  const double* B, const double* C,
                                  const double* D, double* X, double* M,
                                  unsigned char* ok, long long nb, int n_iter,
                                  double tol) {
  if (!in_domain(n, k, 1) || 8 * re_doubles(n, k) > kSmemLimit || nb < 0)
    return -1;
  std::vector<double> tile(re_doubles(n, k));
  for (long long p = 0; p < nb; ++p) {
    if (team_for(n) == kSmallTeam)
      re_block<kSmallTeam>(A, B, C, D, X, M, ok, nb, p, n, k, n_iter, tol,
                           tile.data());
    else
      re_block<kLargeTeam>(A, B, C, D, X, M, ok, nb, p, n, k, n_iter, tol,
                           tile.data());
  }
  return 0;
}

extern "C" int smc_general_kalman_cpu(int n, int k, int o, const double* T,
                                      const double* R, const double* Q,
                                      const double* Z, const double* d,
                                      const double* H, const double* data,
                                      int n_t, const unsigned char* ok,
                                      long long nb, int lyap_iter,
                                      double* out) {
  if (!in_domain(n, k, o) || n_t < 0 || nb < 0 ||
      8 * kalman_doubles(n, k, o) > kSmemLimit)
    return -1;
  std::vector<double> tile(kalman_doubles(n, k, o));
  const auto block = team_for(n) == kSmallTeam
                         ? (rows_for(o) == 4   ? kalman_block<kSmallTeam, 4>
                            : rows_for(o) == 8 ? kalman_block<kSmallTeam, 8>
                                               : kalman_block<kSmallTeam, 16>)
                         : (rows_for(o) == 4   ? kalman_block<kLargeTeam, 4>
                            : rows_for(o) == 8 ? kalman_block<kLargeTeam, 8>
                                               : kalman_block<kLargeTeam, 16>);
  for (long long p = 0; p < nb; ++p)
    block(T, R, Q, Z, d, H, data, n_t, ok, nb, p, n, k, o, lyap_iter, out,
          tile.data());
  return 0;
}
