// CUDA kernel for the Metropolis resampler's chain (body and design in
// metropolis_chain.cuh), with a plain C launcher bound from Python with
// ctypes (ops/cuda_metropolis.py).
//
// metropolis_kernel  replaces the device while loop of
//                    smc_tpu/ops/resample.py::_metropolis_adaptive (XLA in
//                    the JAX package; not a Pallas kernel)
//
// One thread per output slot. The key, the stage's resample flag and the
// chain length B are read from device memory, so a launch captured in a
// CUDA graph serves every replay; where the flag is false a thread writes
// its start i mod n (the identity) and leaves.
#include <cuda_runtime.h>

#include "metropolis_chain.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
metropolis_kernel(const double* __restrict__ w, long long n, long long n_out,
                  const long long* __restrict__ key,
                  const unsigned char* __restrict__ flag,
                  const long long* __restrict__ steps,
                  long long* __restrict__ idx) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long b = smc_chain::chain_steps(*flag, *steps);
  idx[i] = smc_chain::chain(w, n, i, b, (uint32_t)key[0],
                            (uint32_t)key[1]);
}

}  // namespace

// n_out ancestors of the n weights w into idx, on `stream`; key holds two
// words in [0, 2^32), flag one byte, steps one int64, all on the device.
// Returns cudaGetLastError() (nonzero: the launch was refused), -1 for
// sizes outside 1 <= n < 2^31, 0 <= n_out < 2^32. Does not synchronise.
extern "C" int smc_metropolis(const double* w, long long n, long long n_out,
                              const long long* key, const unsigned char* flag,
                              const long long* steps, long long* idx,
                              void* stream) {
  if (n < 1 || n >= (1LL << 31) || n_out < 0 || n_out >= (1LL << 32))
    return -1;
  if (n_out == 0) return 0;
  const unsigned int blocks =
      (unsigned int)((n_out + kThreads - 1) / kThreads);
  metropolis_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(w, n, n_out, key,
                                                           flag, steps, idx);
  return (int)cudaGetLastError();
}
