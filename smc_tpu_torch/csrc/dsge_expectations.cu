// The expectation rows of a DSGE measurement on the card, one block per
// particle (body and design in dsge_expectations.cuh), with a plain C
// launcher bound from Python with ctypes
// (ops/cuda_dsge_expectations.py).
//
// expectation_rows_kernel  replaces no TPU kernel; it follows
//                          smc_tpu_torch/models/dsge.py::bl_expectation_rows
//
// The tile (X, two chain vectors and the sums, at most 41.5 kB at n_state
// 64 and 15 rows) stays under the 48 kB a block gets without raising the
// kernel's limit, so no attribute is ever set. The launcher launches on the
// given stream, does not synchronise, and returns cudaGetLastError()
// (nonzero: the launch was refused), or -1 for rows or shapes outside the
// domain.
#include <cuda_runtime.h>

#include "dsge_expectations.cuh"

namespace {

using namespace smc_expect;

static_assert(8 * tile_doubles(kMaxState, kMaxRows) <= 48 * 1024,
              "the tile fits the default shared memory of a block");

template <int N>
__global__ void __launch_bounds__(N)
expectation_rows_kernel(const double* __restrict__ Z,
                        const double* __restrict__ X,
                        const unsigned char* __restrict__ ok,
                        double* __restrict__ out, long long nb, int n, int o,
                        Rows rows) {
  extern __shared__ __align__(16) double smem[];
  expectation_block<N>(Z, X, ok, out, nb, (long long)blockIdx.x, n, o, rows,
                       smem);
}

}  // namespace

// the tile's bytes (-1 outside the domain)
extern "C" long long smc_expectation_smem(int n, int n_rows) {
  return n >= 1 && n <= kMaxState && n_rows >= 1 && n_rows <= kMaxRows
             ? 8 * tile_doubles(n, n_rows)
             : -1;
}

// Z [o][n][nb] -> out [o][n][nb]: the rows of spec [n_rows][4] = (obs,
// base, first, last) filled from X [n][n][nb] where ok [nb], every other
// entry copied.
extern "C" int smc_expectation_rows(int n, int o, int n_rows, const int* spec,
                                    const double* Z, const double* X,
                                    const unsigned char* ok, double* out,
                                    long long nb, void* stream) {
  Rows rows;
  if (!make_rows(n, o, n_rows, spec, &rows) || nb < 1 || nb > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  expectation_rows_kernel<kTeam>
      <<<(unsigned int)nb, kTeam, smc_expectation_smem(n, n_rows), s>>>(
          Z, X, ok, out, nb, n, o, rows);
  return (int)cudaGetLastError();
}
