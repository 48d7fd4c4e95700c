// The expectation rows of a DSGE measurement, one block of threads per
// particle: with X the particle's solved transition, row obs of Z becomes
// the mean over h = first..last of Z[base] X^h, the expectation at t of
// observable `base` h periods ahead (the FRBNY DSGE model's expected
// policy rates, Z_r X^k, and its 10-year inflation expectation, the mean
// of Z_pi X^h over h = 1..40).
//
// Replaces no TPU kernel: the JAX package has no such rows. It stands
// between the RE solve and the Kalman filter (ops/cuda_dsge_general.py
// dsge_loglike), as a kernel of its own so that a profiler names and times
// the step inside a CUDA graph's replays, and it follows
// smc_tpu_torch/models/dsge.py::bl_expectation_rows.
//
// Each base row's chain v <- v X runs once, to the last horizon of the rows
// it feeds, and each step's v is added into those rows whose horizons hold
// it. Thread j owns column j: it forms (v X)_j from X in shared memory (the
// sum in index order), keeps its own entries of the sums, and one barrier a
// step hands v on. What bounds it: the chain's latency (at the FRBNY rows,
// 40 dependent steps of an n_state-long dot product); the work, ~2 n_state^2
// flop a step, and the bytes, X once and Z in and out, are small beside it.
// A particle whose RE solve failed keeps its rows as given.
//
// Between two barriers a thread writes only its own column's entries, so
// the host build (dsge_expectations_cpu.cpp, each thread run in turn,
// lanes.cuh) computes what the card computes, up to the card's fused
// multiply-adds.
#pragma once

#include "lanes.cuh"

namespace smc_expect {

using smc::team_sync;

constexpr int kTeam = 64;      // threads a block: one per column
constexpr int kMaxState = 64;  // n_state, at most one column a thread
constexpr int kMaxObs = 16;
constexpr int kMaxRows = kMaxObs - 1;

// The rows to fill, passed to the kernel by value (no device memory, so a
// CUDA graph captures them with the launch): entry q fills row obs[q] from
// base[q] over horizons first[q]..last[q]; bit r of `filled` is set where
// row r is filled.
struct Rows {
  int n;
  unsigned filled;
  int obs[kMaxRows], base[kMaxRows], first[kMaxRows], last[kMaxRows];
};

SMC_HD constexpr long long tile_doubles(int n, int n_rows) {
  return (long long)n * n + 2LL * n + (long long)n_rows * n;
}

// spec [n_rows][4] = (obs, base, first, last) -> rows; false where the
// rows break the rules of models/dsge.py::check_expectation_rows
inline bool make_rows(int n, int o, int n_rows, const int* spec, Rows* r) {
  if (n < 1 || n > kMaxState || o < 1 || o > kMaxObs || n_rows < 1 ||
      n_rows > kMaxRows)
    return false;
  r->n = n_rows;
  r->filled = 0u;
  for (int q = 0; q < n_rows; ++q) {
    const int* s = spec + 4 * q;
    if (s[0] < 0 || s[0] >= o || s[1] < 0 || s[1] >= o || s[2] < 1 ||
        s[3] < s[2] || (r->filled >> s[0]) & 1u)
      return false;
    r->obs[q] = s[0];
    r->base[q] = s[1];
    r->first[q] = s[2];
    r->last[q] = s[3];
    r->filled |= 1u << s[0];
  }
  for (int q = 0; q < n_rows; ++q)
    if ((r->filled >> r->base[q]) & 1u) return false;
  return true;
}

// Z [o][n] and out [o][n] of particle p, batch-last over nb particles; X
// [n][n]; tile: X, v, the next v, and the sums [n_rows][n].
template <int N>
SMC_HD void expectation_block(const double* Z, const double* X,
                              const unsigned char* ok, double* out,
                              long long nb, long long p, int n, int o,
                              const Rows& rows, double* tile) {
  const bool live = ok[p] != 0;
  double* Xs = tile;
  double* v = Xs + n * n;
  double* w = v + n;
  double* acc = w + n;
  SMC_TEAM(N, t) {
    for (int e = t; e < o * n; e += N)
      if (!live || !((rows.filled >> (e / n)) & 1u))
        out[e * nb + p] = Z[e * nb + p];
    if (live) {
      for (int e = t; e < n * n; e += N) Xs[e] = X[e * nb + p];
      if (t < n)
        for (int q = 0; q < rows.n; ++q) acc[q * n + t] = 0.0;
    }
  }
  if (!live) return;
  team_sync<N>();
  for (int q0 = 0; q0 < rows.n; ++q0) {
    const int b = rows.base[q0];
    bool seen = false;
    int h_max = 0;
    for (int q = 0; q < rows.n; ++q)
      if (rows.base[q] == b) {
        seen = seen || q < q0;
        h_max = rows.last[q] > h_max ? rows.last[q] : h_max;
      }
    if (seen) continue;  // an earlier row of this base ran the chain
    SMC_TEAM(N, t) {
      if (t < n) v[t] = Z[((long long)b * n + t) * nb + p];
    }
    team_sync<N>();
    for (int h = 1; h <= h_max; ++h) {
      SMC_TEAM(N, t) {
        if (t < n) {
          double s = 0.0;
          for (int i = 0; i < n; ++i) s += v[i] * Xs[i * n + t];
          w[t] = s;
          for (int q = q0; q < rows.n; ++q)
            if (rows.base[q] == b && rows.first[q] <= h && h <= rows.last[q])
              acc[q * n + t] += s;
        }
      }
      team_sync<N>();
      double* u = v;
      v = w;
      w = u;
    }
  }
  SMC_TEAM(N, t) {
    if (t < n)
      for (int q = 0; q < rows.n; ++q)
        out[((long long)rows.obs[q] * n + t) * nb + p] =
            acc[q * n + t] / (double)(rows.last[q] - rows.first[q] + 1);
  }
}

}  // namespace smc_expect
