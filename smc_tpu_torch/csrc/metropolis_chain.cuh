// The Metropolis resampler's chain for one output slot, written once for the
// card (metropolis_kernel.cu) and the host (metropolis_cpu.cpp).
//
// Counterpart of smc_tpu/ops/resample.py::_metropolis_adaptive (Murray, Lee
// and Jacob, arXiv:1202.6163), which XLA runs as a device while loop whose
// trip count B is read from the weights. Slot i starts at j = i mod n and
// takes B steps; step t proposes a uniform index `prop` in [0, n) and moves
// there when u * w[j] < w[prop] for a uniform u in [0, 1). A slot's chain
// depends on its own draws only: there is no exchange between slots.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11; the constants and round
// of Random123), keyed per stage by two 32-bit words the stage draws. Step t
// of slot i takes philox4x32_10(counter = (i, t, 0, 0), key = (k0, k1)),
// the counterpart of JAX's fold_in(key, t) (not JAX's bit stream):
//   prop = (x0 * n) >> 32   multiply-shift without rejection; the relative
//                           bias of an index is at most n / 2^32
//                           (7.6e-6 at n = 32,768);
//   u = ((x1 << 21) | (x2 >> 11)) * 2^-53, 53 bits, exact in f64.
// The accept test is one multiply and one compare (nothing to contract into
// an FMA), so the card, the host build and ops/cuda_metropolis.py's plain
// torch version give the same indices bit for bit. A NaN weight never
// compares true: a slot stays where it is.
//
// What bounds it on an H100: instruction issue. Only word 1 of the counter
// moves with t, so the parts of rounds 1-3 that the slot and the key fix
// do not depend on t, nor do the round keys (RoundKeys, worked out once a
// slot; nvcc hoists the rest out of the step loop). A step then needs 48
// instructions: 16 32x32->64 multiplies and 18 three-input XORs for its
// Philox call, 1 multiply for the proposal, 4 for the uniform, 3 for the
// gather, 2 for the accept test, 3 selects and the counter's add. They
// spread over the IMAD, ALU, f64 and conversion pipes so that none limits
// them before the 128 thread-instructions per SM per clock that the
// schedulers issue (33.4 T/s at 132 SMs and 1.98 GHz). B x n_out steps of
// that against 8 (n + n_out) bytes at 3.35 TB/s: at n = n_out = 32,768 and
// B = 100, 4.7 us of issue against 0.16 us of bytes.
// With one thread per slot the card holds only 4-8 warps per SM at the
// model sizes (16,384 and 32,768 slots), too few to hide latency by
// occupancy. The step's only serial dependency is the compare-and-select on
// (j, w_j): the proposals, uniforms and the gathers w[prop] do not depend
// on j. So a thread computes kUnroll steps' Philox blocks and issues their
// gathers (the weights, 128-256 KB, sit in L2) before it runs their short
// select chain; w_j lives in a register and changes only on accept.
#pragma once

#include <stdint.h>

#include "lanes.cuh"

namespace smc_chain {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kUnroll = 8;

// Philox4x32-10's round keys under (k0, k1): the same for every counter.
struct RoundKeys {
  uint32_t k0[10], k1[10];
};

SMC_HD inline RoundKeys round_keys(uint32_t k0, uint32_t k1) {
  RoundKeys rk;
  SMC_UNROLL
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0;
    rk.k1[r] = k1;
    k0 += kW0;
    k1 += kW1;
  }
  return rk;
}

SMC_HD inline uint32_t hi32(uint64_t x) { return (uint32_t)(x >> 32); }

// One Philox round on the counter words c under round keys (k0, k1).
SMC_HD inline void philox_round(uint32_t c[4], uint32_t k0, uint32_t k1) {
  const uint64_t p0 = (uint64_t)kM0 * c[0];
  const uint64_t p1 = (uint64_t)kM1 * c[2];
  c[0] = hi32(p1) ^ c[1] ^ k0;
  c[1] = (uint32_t)p1;
  c[2] = hi32(p0) ^ c[3] ^ k1;
  c[3] = (uint32_t)p0;
}

// Philox4x32-10 of `ctr` under the round keys rk, into out.
SMC_HD inline void philox4x32_10(const uint32_t ctr[4], const RoundKeys& rk,
                                 uint32_t out[4]) {
  uint32_t c[4] = {ctr[0], ctr[1], ctr[2], ctr[3]};
  SMC_UNROLL
  for (int r = 0; r < 10; ++r) philox_round(c, rk.k0[r], rk.k1[r]);
  SMC_UNROLL
  for (int q = 0; q < 4; ++q) out[q] = c[q];
}

// The proposal and the uniform of step t of slot i.
SMC_HD inline void step_draw(uint32_t i, uint32_t t, const RoundKeys& rk,
                             long long n, long long* prop, double* u) {
  const uint32_t ctr[4] = {i, t, 0u, 0u};
  uint32_t x[4];
  philox4x32_10(ctr, rk, x);
  *prop = (long long)(((uint64_t)x[0] * (uint64_t)n) >> 32);
  *u = (double)(((uint64_t)x[1] << 21) | (x[2] >> 11)) *
       1.1102230246251565e-16;  // 2^-53
}

// The ancestor of slot i after `steps` steps over the n weights w.
SMC_HD inline long long chain(const double* __restrict__ w, long long n,
                              long long i, long long steps, uint32_t k0,
                              uint32_t k1) {
  const RoundKeys rk = round_keys(k0, k1);
  long long j = i % n;
  double wj = w[j];
  for (long long t0 = 0; t0 < steps; t0 += kUnroll) {
    long long prop[kUnroll];
    double u[kUnroll], wp[kUnroll];
    SMC_UNROLL
    for (int q = 0; q < kUnroll; ++q) {
      prop[q] = j;
      u[q] = 1.0;
      wp[q] = 0.0;
      if (t0 + q < steps) {
        step_draw((uint32_t)i, (uint32_t)(t0 + q), rk, n, &prop[q], &u[q]);
        wp[q] = w[prop[q]];
      }
    }
    SMC_UNROLL
    for (int q = 0; q < kUnroll; ++q) {
      if (t0 + q < steps && u[q] * wj < wp[q]) {
        j = prop[q];
        wj = wp[q];
      }
    }
  }
  return j;
}

// The steps slot chains run: B where the stage resamples, else 0 (the
// identity); a negative B (none is made) counts as 0.
SMC_HD inline long long chain_steps(unsigned char flag, long long steps) {
  return flag && steps > 0 ? steps : 0;
}

}  // namespace smc_chain
