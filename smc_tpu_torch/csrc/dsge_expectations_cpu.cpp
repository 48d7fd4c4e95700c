// The block body of dsge_expectations.cuh compiled by a host compiler: a
// loop over particles, each particle's block of threads run phase by phase
// (lanes.cuh), with the block's tile in a local buffer. Only the tests use
// this library: it checks the kernel's arithmetic on a machine without a
// GPU. Same C interface as dsge_expectations.cu, minus the stream.
#include <vector>

#include "dsge_expectations.cuh"

using namespace smc_expect;

extern "C" int smc_expectation_rows_cpu(int n, int o, int n_rows,
                                        const int* spec, const double* Z,
                                        const double* X,
                                        const unsigned char* ok, double* out,
                                        long long nb) {
  Rows rows;
  if (!make_rows(n, o, n_rows, spec, &rows) || nb < 0) return -1;
  std::vector<double> tile(tile_doubles(n, n_rows));
  for (long long p = 0; p < nb; ++p)
    expectation_block<kTeam>(Z, X, ok, out, nb, p, n, o, rows, tile.data());
  return 0;
}
