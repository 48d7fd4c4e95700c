// The Metropolis chain of metropolis_chain.cuh compiled by a host compiler,
// one slot after another. Only the tests use this library: it checks the
// kernel's arithmetic (the Philox stream, the proposal, the uniform and the
// select) on a machine without a GPU. Same C interface as
// metropolis_kernel.cu, minus the stream, with host pointers; smc_philox_cpu
// exposes the generator alone for its known-answer vectors.
#include "metropolis_chain.cuh"

extern "C" void smc_philox_cpu(const uint32_t* ctr, const uint32_t* key,
                               uint32_t* out) {
  smc_chain::philox4x32_10(ctr, smc_chain::round_keys(key[0], key[1]), out);
}

extern "C" int smc_metropolis_cpu(const double* w, long long n,
                                  long long n_out, const long long* key,
                                  const unsigned char* flag,
                                  const long long* steps, long long* idx) {
  if (n < 1 || n >= (1LL << 31) || n_out < 0 || n_out >= (1LL << 32))
    return -1;
  const long long b = smc_chain::chain_steps(*flag, *steps);
  for (long long i = 0; i < n_out; ++i)
    idx[i] = smc_chain::chain(w, n, i, b, (uint32_t)key[0],
                              (uint32_t)key[1]);
  return 0;
}
