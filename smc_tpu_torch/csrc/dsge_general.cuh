// The DSGE likelihood at general shapes, one block of threads per particle:
// the cyclic-reduction RE solve and the Chandrasekhar Kalman filter at any
// (n_state, n_shock, n_obs) up to the maxima the build sets, with the
// particle's matrices in the block's shared memory.
//
// re_block      replaces the JAX package's XLA path
//               smc_tpu/models/dsge.py::bl_solve_linear_re
// kalman_block  replaces smc_tpu/models/dsge.py::
//               bl_kalman_loglike_chandrasekhar with smc_tpu/ops/linalg.py::
//               bl_psd_fast_solve (the cofactor form at n_obs 3, Cholesky
//               otherwise)
//
// These are the JAX package's default likelihood ("xla"), which XLA
// compiles into a few fused device loops; the port's plain version
// (models/dsge.py bl_*) issues a dozen launches per Gauss-Jordan pivot
// step. Here a block walks the same algorithm phase by phase: the threads
// share each phase's entries (a slab of rows and columns each, fixed per
// phase), and the block's barrier separates the phases. Between two
// barriers a thread writes only entries that no other thread reads in that
// phase, so the host build (dsge_general_cpu.cpp, each thread's share run
// in turn, lanes.cuh) computes what the card computes, up to the card's
// fused multiply-adds.
//
// What bounds it: f64 arithmetic. At Smets-Wouters' shape (37, 7, 7) a
// cyclic-reduction iteration is a 37 x 111 Gauss-Jordan and four 37^3
// products (~0.65 Mflop), a Chandrasekhar step ~80 kflop; a whole particle
// ~23 Mflop (~10 in the RE solve, ~13 in the filter) against ~35 kB of
// inputs. A particle's work is a chain of small dependent phases (two
// barriers per pivot step, eight per filter step), so its latency, not the
// card's rate, sets the time: enough particles must be in flight, a few
// blocks per SM. A block is kSmallTeam threads up to n_state kSmallMax
// (more blocks per SM where the matrices are small), kLargeTeam beyond.
//
// The RE solve follows bl_solve_linear_re operation for operation:
// Gauss-Jordan with the serial pivot rule (the first maximal |entry| at or
// below the diagonal), each sum of products in index order, the residual
// test, the two 12-squaring spectral bounds and the finiteness test. It
// leaves cyclic reduction once max(|A0|, |A2|) <= 2^-27 max(|A|, |B|, |C|,
// 1), as the n_state <= 8 kernels do (the plain version runs all n_iter
// iterations; the iteration is quadratic, so they agree to rounding). The
// Kalman filter leaves the Lyapunov doubling once max|A_k| <= 1e-20, and
// the Chandrasekhar recursion once the particle is rejected (a guard has
// fired or the total is no longer finite: its result is -inf either way).
// The factor of F_{t+1} made for the M-update serves step t+1's solve.
#pragma once

#include <math.h>
#include <stddef.h>

#include "lanes.cuh"

#if !defined(SMC_GEN_MAX_STATE) || !defined(SMC_GEN_MAX_SHOCK) || \
    !defined(SMC_GEN_MAX_OBS) || !defined(SMC_SMEM_LIMIT)
#error "build with -DSMC_GEN_MAX_STATE, -DSMC_GEN_MAX_SHOCK, -DSMC_GEN_MAX_OBS, -DSMC_SMEM_LIMIT"
#endif

namespace smc_general {

using smc::kWarp;
using smc::Lanes;

constexpr int kMaxState = SMC_GEN_MAX_STATE;
constexpr int kMaxShock = SMC_GEN_MAX_SHOCK;
constexpr int kMaxObs = SMC_GEN_MAX_OBS;
// dynamic shared memory a block may use (smc_tpu_torch/_build.py SMEM_LIMIT)
constexpr long long kSmemLimit = SMC_SMEM_LIMIT;
constexpr int kSmallTeam = 64;
constexpr int kLargeTeam = 256;
constexpr int kSmallMax = 16;  // n_state served by the small team
constexpr double kExitRe = 1.0 / 134217728.0;  // 2^-27
constexpr double kExitLyap = 1e-20;
constexpr double kLog2Pi = 1.8378770664093453;

SMC_HD constexpr int team_for(int n) {
  return n <= kSmallMax ? kSmallTeam : kLargeTeam;
}
SMC_HD constexpr int red_doubles(int team) { return 4 * (team / kWarp); }

// ---------------------------------------------------------------------------
// Shared-memory tiles, in doubles (ops/cuda_dsge_general.py repeats these
// formulas to decide a shape's route before any build)
// ---------------------------------------------------------------------------

// the RE tile's Gauss-Jordan width: [A1 | A0 | A2], then [lhs | D | C]
SMC_HD constexpr int re_width(int n, int k) {
  return 3 * n > 2 * n + k ? 3 * n : 2 * n + k;
}
SMC_HD constexpr long long re_doubles(int n, int k) {
  return (long long)n * re_width(n, k) + 4LL * n * n + n + re_width(n, k) +
         red_doubles(team_for(n));
}

// The Kalman tile: persistent T, P, Z, d, s, s', v, the n_obs-square
// matrices (F, F', M, M', M W'Z', F'^-1 Z W, its product with M, the
// factor L), the innovation solve [n_obs, 1 + n_obs], the factor's
// reciprocals, 8 scalars and the reduction slots; then a region used first
// by the doubling (A_k, A_{k+1}, and a temporary that also holds Q R'),
// then by the filter (K, K', W, W', W M W'Z': n_state x n_obs each); then
// the observations [n_obs, n_t].
SMC_HD constexpr long long kalman_union(int n, int k, int o) {
  return 2LL * n * n + (n * n > k * n ? (long long)n * n : (long long)k * n) >
                 5LL * n * o
             ? 2LL * n * n +
                   (n * n > k * n ? (long long)n * n : (long long)k * n)
             : 5LL * n * o;
}
SMC_HD constexpr long long kalman_fixed(int n, int o) {
  return 2LL * n * n + (long long)o * n + o + 2 * n + o + 8LL * o * o +
         (long long)o * (o + 1) + o + 8 + red_doubles(team_for(n));
}
SMC_HD constexpr long long kalman_doubles(int n, int k, int o, int n_t) {
  return kalman_fixed(n, o) + kalman_union(n, k, o) + (long long)o * n_t;
}

static_assert(8 * re_doubles(kMaxState, kMaxShock) <= kSmemLimit,
              "the RE tile at the largest shape passes the shared memory");
static_assert(8 * kalman_doubles(kMaxState, kMaxShock, kMaxObs, 1) <=
                  kSmemLimit,
              "the Kalman tile at the largest shape passes the shared memory");

// ---------------------------------------------------------------------------
// A thread's share of a phase
// ---------------------------------------------------------------------------

// Thread t of n over a grid [rows) x [cols) (cols fast): where cols <= n,
// one column j0 and rows i0, i0 + di, ... (neighbouring threads on
// neighbouring columns); else columns t, t + n, ... of every row.
struct Slab {
  int i0, di, j0, dj;
};
SMC_HD inline Slab slab(int t, int n, int cols) {
  Slab s;
  if (cols > n) {
    s.i0 = 0;
    s.di = 1;
    s.j0 = t;
    s.dj = n;
  } else {
    const int per = n / cols;
    s.i0 = t / cols;
    s.di = per;
    s.j0 = t / cols < per ? t % cols : cols;  // cols: none
    s.dj = cols;
  }
  return s;
}
#define SMC_SLAB(sl, rows, cols, i, j)                   \
  for (int i = (sl).i0; i < (rows); i += (sl).di)        \
    for (int j = (sl).j0; j < (cols); j += (sl).dj)

// the block's barrier (the team is the block; nothing to wait for on the
// host, where each phase runs every thread before the next starts)
SMC_HD inline void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

SMC_HD inline bool finite(double x) { return x - x == 0.0; }
// |x| with NaN taken as +inf, for maxima that must see a NaN
SMC_HD inline double mag(double x) { return x != x ? INFINITY : fabs(x); }
SMC_HD inline double dmax(double a, double b) { return b > a ? b : a; }

// ---------------------------------------------------------------------------
// Reductions over the team: each thread's K values -> the team's, the same
// bits in every thread. Ends with the team's barrier.
// ---------------------------------------------------------------------------

template <int K, int N>
SMC_HD inline void warp_max(Lanes<double[K], N>& v) {
#ifdef __CUDA_ARCH__
  SMC_UNROLL for (int m = 1; m < kWarp; m <<= 1)
    SMC_UNROLL for (int c = 0; c < K; ++c) {
      const double o = __shfl_xor_sync(0xffffffffu, v[0][c], m);
      v[0][c] = dmax(v[0][c], o);
    }
#else
  for (int w = 0; w < N; w += kWarp)
    for (int c = 0; c < K; ++c) {
      double m = v[w][c];
      for (int l = 1; l < kWarp; ++l) m = dmax(m, v[w + l][c]);
      for (int l = 0; l < kWarp; ++l) v[w + l][c] = m;
    }
#endif
}

// (|x|, row) -> the warp's first maximal |x|: the largest value, of equal
// ones the smallest row, in every lane (a total order, so the butterfly
// gives every lane the same pair)
template <int N>
SMC_HD inline void warp_argmax(Lanes<double[2], N>& v) {
#ifdef __CUDA_ARCH__
  SMC_UNROLL for (int m = 1; m < kWarp; m <<= 1) {
    const double ob = __shfl_xor_sync(0xffffffffu, v[0][0], m);
    const double oi = __shfl_xor_sync(0xffffffffu, v[0][1], m);
    if (ob > v[0][0] || (ob == v[0][0] && oi < v[0][1])) {
      v[0][0] = ob;
      v[0][1] = oi;
    }
  }
#else
  for (int w = 0; w < N; w += kWarp) {
    double b = v[w][0], i = v[w][1];
    for (int l = 1; l < kWarp; ++l)
      if (v[w + l][0] > b || (v[w + l][0] == b && v[w + l][1] < i)) {
        b = v[w + l][0];
        i = v[w + l][1];
      }
    for (int l = 0; l < kWarp; ++l) {
      v[w + l][0] = b;
      v[w + l][1] = i;
    }
  }
#endif
}

// kind 0: the maximum (of values without NaN); 1: the sum, over the warp by
// a butterfly (lanes.cuh group_sum), then the warps in order
template <int K, int N>
SMC_HD inline void team_reduce(Lanes<double[K], N>& part, double* red,
                               int kind, double* out) {
  static_assert(K <= 4, "red_doubles holds 4 values a warp");
  if (kind == 0)
    warp_max<K>(part);
  else
    smc::group_sum<kWarp>(part);
  SMC_TEAM(N, t) {
    if (t % kWarp == 0)
      for (int c = 0; c < K; ++c) red[4 * (t / kWarp) + c] = part[t][c];
  }
  block_sync();
  for (int c = 0; c < K; ++c) {
    double r = red[c];
    for (int w = 1; w < N / kWarp; ++w)
      r = kind == 0 ? dmax(r, red[4 * w + c]) : r + red[4 * w + c];
    out[c] = r;
  }
  block_sync();
}

// ---------------------------------------------------------------------------
// Gauss-Jordan
// ---------------------------------------------------------------------------

// W [n][ld]: [A | B] of width w -> columns n..w-1 hold A^-1 B (the other
// columns are left partly eliminated: nothing reads them). Per pivot step
// k, two phases: every warp finds the pivot row p, the first maximal
// |W[r][k]| with r >= k (each lane the first maximum of its rows r = k +
// lane + 32 i, then warp_argmax: the serial rule exactly; a column with no
// comparable entry, all NaN, keeps p = k), moves row k to row p and row p
// to the row buffer, and forms the factors W[i][k] / pivot of the swapped
// column (fac[k] holds the pivot); then every row i != k becomes
// W[i] - fac[i] row, and row k row / pivot. Column k and the columns
// before it are never read again, so they are not written. piv_rows, where
// given (the tests' host build), receives each step's pivot row.
template <int N>
SMC_HD inline void gauss_jordan(double* W, int ld, int n, int w, double* fac,
                                double* row, int* piv_rows = nullptr) {
  for (int k = 0; k < n; ++k) {
    Lanes<double[2], N> cand;
    SMC_TEAM(N, t) {
      double big = -1.0, arg = n;
      for (int r = k + t % kWarp; r < n; r += kWarp) {
        const double x = fabs(W[r * ld + k]);
        if (x > big) {
          big = x;
          arg = r;
        }
      }
      cand[t][0] = big;
      cand[t][1] = arg;
    }
    warp_argmax(cand);
    SMC_TEAM(N, t) {
      const int p = cand[t][1] < n ? (int)cand[t][1] : k;
      const double piv = W[p * ld + k];
      if (piv_rows != nullptr && t == 0) piv_rows[k] = p;
      for (int j = k + 1 + t; j < w; j += N) {
        row[j] = W[p * ld + j];
        if (p != k) W[p * ld + j] = W[k * ld + j];
      }
      for (int i = t; i < n; i += N)
        fac[i] = i == k ? piv : (i == p ? W[k * ld + k] : W[i * ld + k]) / piv;
    }
    block_sync();
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, w - k - 1);
      const double piv = fac[k];
      SMC_SLAB(sl, n, w - k - 1, i, jj) {
        const int j = k + 1 + jj;
        if (i == k)
          W[i * ld + j] = row[j] / piv;
        else
          W[i * ld + j] -= fac[i] * row[j];
      }
    }
    block_sync();
  }
}

// ---------------------------------------------------------------------------
// The RE solve
// ---------------------------------------------------------------------------

// the global index of entry (i, j) of a batch-last [r, c, nb] matrix
SMC_HD inline long long at(int i, int j, int c, long long nb, long long p) {
  return ((long long)i * c + j) * nb + p;
}

// rho(M) <= ||M^(2^12)||_F^(1/2^12) by renormalized squaring
// (bl_spectral_radius_bound): M [n][n] in a, b another n x n buffer; both
// are overwritten.
template <int N>
SMC_HD inline double spectral_bound(double* a, double* b, int n,
                                    double* red) {
  double log_scale = 0.0;
  double out[1];
  for (int sq = 0; sq <= 12; ++sq) {
    Lanes<double[1], N> part;
    SMC_TEAM(N, t) {
      double s = 0.0;
      for (int e = t; e < n * n; e += N) s += a[e] * a[e];
      part[t][0] = s;
    }
    team_reduce<1>(part, red, 1, out);
    const double nrm = sqrt(out[0]) + 1e-300;
    if (sq == 12) return exp((log_scale + log(nrm)) / 4096.0);
    SMC_TEAM(N, t) {
      for (int e = t; e < n * n; e += N) a[e] = a[e] / nrm;
    }
    block_sync();
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      SMC_SLAB(sl, n, n, i, j) {
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += a[i * n + l] * a[l * n + j];
        b[i * n + j] = s;
      }
    }
    block_sync();
    double* c = a;
    a = b;
    b = c;
    log_scale = 2.0 * (log_scale + log(nrm));
  }
  return 0.0;  // not reached
}

// Particle p of nb: A, B, C [n, n, nb], D [n, k, nb] -> X [n, n, nb],
// M [n, k, nb], ok [nb] (X and M zero where not ok); tile: re_doubles(n, k).
template <int N>
SMC_HD void re_block(const double* A, const double* B, const double* C,
                     const double* D, double* Xo, double* Mo,
                     unsigned char* oko, long long nb, long long p, int n,
                     int k, int n_iter, double tol, double* tile) {
  const int w = re_width(n, k), nn = n * n;
  double* W = tile;  // [n][w]
  double* A0 = W + (long long)n * w;
  double* A1 = A0 + nn;
  double* A2 = A1 + nn;
  double* Ah = A2 + nn;
  double* fac = Ah + nn;
  double* row = fac + n;
  double* red = row + w;

  // W = [B | A | C]; the carry A0 = A, A1 = B, A2 = C, Ah = B
  Lanes<double[3], N> part;
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    double ma = 0.0, mb = 0.0, mc = 0.0;
    SMC_SLAB(sl, n, n, i, j) {
      const double a = A[at(i, j, n, nb, p)], b = B[at(i, j, n, nb, p)],
                   c = C[at(i, j, n, nb, p)];
      W[i * w + j] = b;
      W[i * w + n + j] = a;
      W[i * w + 2 * n + j] = c;
      A0[i * n + j] = a;
      A1[i * n + j] = b;
      A2[i * n + j] = c;
      Ah[i * n + j] = b;
      ma = dmax(ma, mag(a));
      mb = dmax(mb, mag(b));
      mc = dmax(mc, mag(c));
    }
    part[t][0] = ma;
    part[t][1] = mb;
    part[t][2] = mc;
  }
  double m3[3];
  team_reduce<3>(part, red, 0, m3);
  const double all = dmax(dmax(m3[0], m3[1]), m3[2]);
  const double exit_tol =
      dmax(all == INFINITY ? 0.0 : all, 1.0) * kExitRe;  // non-finite: 0
  const double conv_scale = dmax(m3[0], 1.0);
  double m = dmax(m3[0], m3[2]);  // max(|A0|, |A2|)

  for (int it = 0; it < n_iter && !(m <= exit_tol); ++it) {
    gauss_jordan<N>(W, w, n, 3 * n, fac, row);  // [A1 | SA0 | SA2]
    // A1 -= A0 SA2; W[:, :n] = -(A2 SA2)
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      SMC_SLAB(sl, n, n, i, j) {
        double b = 0.0, d = 0.0;
        for (int l = 0; l < n; ++l) {
          const double s2 = W[l * w + 2 * n + j];
          b += A0[i * n + l] * s2;
          d += A2[i * n + l] * s2;
        }
        A1[i * n + j] -= b;
        W[i * w + j] = -d;
      }
    }
    block_sync();
    // Ah -= A2 SA0; A1 -= A2 SA0; W[:, 2n:] = -(A0 SA0)
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      SMC_SLAB(sl, n, n, i, j) {
        double a = 0.0, c = 0.0;
        for (int l = 0; l < n; ++l) {
          const double s0 = W[l * w + n + j];
          a += A2[i * n + l] * s0;
          c += A0[i * n + l] * s0;
        }
        Ah[i * n + j] -= a;
        A1[i * n + j] -= a;
        W[i * w + 2 * n + j] = -c;
      }
    }
    block_sync();
    // the new carry, and W = [A1 | A0 | A2] for the next step
    Lanes<double[1], N> pm;
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      double mx = 0.0;
      SMC_SLAB(sl, n, n, i, j) {
        const double a0 = W[i * w + 2 * n + j], a2 = W[i * w + j];
        A0[i * n + j] = a0;
        A2[i * n + j] = a2;
        W[i * w + j] = A1[i * n + j];
        W[i * w + n + j] = a0;
        W[i * w + 2 * n + j] = a2;
        mx = dmax(mx, dmax(mag(a0), mag(a2)));
      }
      pm[t][0] = mx;
    }
    team_reduce<1>(pm, red, 0, &m);
  }

  // X = -Ah^-1 A; B and C to the carry's slots
  double* Xs = A0;
  double* Bs = A1;
  double* Cs = A2;
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    SMC_SLAB(sl, n, n, i, j) {
      W[i * w + j] = Ah[i * n + j];
      W[i * w + n + j] = A[at(i, j, n, nb, p)];
      Bs[i * n + j] = B[at(i, j, n, nb, p)];
      Cs[i * n + j] = C[at(i, j, n, nb, p)];
    }
  }
  block_sync();
  gauss_jordan<N>(W, w, n, 2 * n, fac, row);
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    SMC_SLAB(sl, n, n, i, j) Xs[i * n + j] = -W[i * w + n + j];
  }
  block_sync();
  // W = [B + C X | D | C]; XX = X X
  double* XX = Ah;
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    SMC_SLAB(sl, n, n, i, j) {
      double cx = 0.0, xx = 0.0;
      for (int l = 0; l < n; ++l) {
        cx += Cs[i * n + l] * Xs[l * n + j];
        xx += Xs[i * n + l] * Xs[l * n + j];
      }
      W[i * w + j] = Bs[i * n + j] + cx;
      W[i * w + n + k + j] = Cs[i * n + j];
      XX[i * n + j] = xx;
    }
    const Slab sd = slab(t, N, k);
    SMC_SLAB(sd, n, k, i, j) W[i * w + n + j] = D[at(i, j, k, nb, p)];
  }
  block_sync();
  // the residual (A + B X) + C (X X)
  double mr;
  {
    Lanes<double[1], N> pr;
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      double mx = 0.0;
      SMC_SLAB(sl, n, n, i, j) {
        double bx = 0.0, cxx = 0.0;
        for (int l = 0; l < n; ++l) {
          bx += Bs[i * n + l] * Xs[l * n + j];
          cxx += Cs[i * n + l] * XX[l * n + j];
        }
        mx = dmax(mx, mag((A[at(i, j, n, nb, p)] + bx) + cxx));
      }
      pr[t][0] = mx;
    }
    team_reduce<1>(pr, red, 0, &mr);
  }
  const bool converged = mr < tol * conv_scale;
  // [M | F] = -(B + C X)^-1 [D | C]
  gauss_jordan<N>(W, w, n, 2 * n + k, fac, row);
  double* Ms = Ah;  // [n][k]
  double* Fs = Bs;
  double* Xc = Cs;  // X, squared away by the spectral bound
  Lanes<double[1], N> pf;
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    double bad = 0.0;
    SMC_SLAB(sl, n, n, i, j) {
      Fs[i * n + j] = -W[i * w + n + k + j];
      Xc[i * n + j] = Xs[i * n + j];
      bad += finite(Xs[i * n + j]) ? 0.0 : 1.0;
    }
    const Slab sd = slab(t, N, k);
    SMC_SLAB(sd, n, k, i, j) {
      const double x = -W[i * w + n + j];
      Ms[i * k + j] = x;
      bad += finite(x) ? 0.0 : 1.0;
    }
    pf[t][0] = bad;
  }
  double n_bad;
  team_reduce<1>(pf, red, 0, &n_bad);
  const bool stable = spectral_bound<N>(Xc, W, n, red) < 1.0;
  const bool unique = spectral_bound<N>(Fs, W, n, red) < 1.0;
  const bool ok = converged && stable && unique && n_bad == 0.0;
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    SMC_SLAB(sl, n, n, i, j) Xo[at(i, j, n, nb, p)] = ok ? Xs[i * n + j] : 0.0;
    const Slab sd = slab(t, N, k);
    SMC_SLAB(sd, n, k, i, j) Mo[at(i, j, k, nb, p)] = ok ? Ms[i * k + j] : 0.0;
    if (t == 0) oko[p] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The innovation solves (bl_psd_fast_solve): one thread factors, one
// thread per right-hand side solves
// ---------------------------------------------------------------------------

// F [o][o] symmetric -> L [o][o] and inv [o]; meta[0] = log det F, meta[1]
// = 1 where the Cholesky factorization failed (a pivot <= 0 or NaN: the
// solves give NaN, as bl_chol_solve's do). At o = 3 the cofactors C00,
// C01, C02, C11, C12, C22 in L[0..5] and 1 / det in inv[0], log det (NaN
// for det < 0) in meta[0].
SMC_HD inline void psd_factor(const double* F, int o, double* L, double* inv,
                              double* meta) {
  if (o == 3) {
    const double a = F[0], b = F[1], c = F[2], d = F[4], e = F[5], f = F[8];
    L[0] = d * f - e * e;
    L[1] = c * e - b * f;
    L[2] = b * e - c * d;
    L[3] = a * f - c * c;
    L[4] = b * c - a * e;
    L[5] = a * d - b * b;
    const double det = a * L[0] + b * L[1] + c * L[2];
    inv[0] = 1.0 / det;
    meta[0] = log(det);
    meta[1] = 0.0;
    return;
  }
  bool failed = false;
  double logdet = 0.0;
  for (int j = 0; j < o; ++j) {
    double s = F[j * o + j];
    for (int q = 0; q < j; ++q) s = s - L[j * o + q] * L[j * o + q];
    failed = failed || !(s > 0.0);
    const double ljj = sqrt(s);
    inv[j] = 1.0 / ljj;
    logdet = logdet + log(s);
    L[j * o + j] = ljj;
    for (int i = j + 1; i < o; ++i) {
      double u = F[i * o + j];
      for (int q = 0; q < j; ++q) u = u - L[i * o + q] * L[j * o + q];
      L[i * o + j] = u * inv[j];
    }
  }
  meta[0] = failed ? NAN : logdet;
  meta[1] = failed ? 1.0 : 0.0;
}

// x = F^-1 b for one right-hand side: b[i * bs], x[i * xs], i < o
SMC_HD inline void psd_solve(const double* L, const double* inv,
                             const double* meta, int o, const double* b,
                             int bs, double* x, int xs) {
  if (o == 3) {
    const double b0 = b[0], b1 = b[bs], b2 = b[2 * bs], id = inv[0];
    x[0] = (L[0] * b0 + L[1] * b1 + L[2] * b2) * id;
    x[xs] = (L[1] * b0 + L[3] * b1 + L[4] * b2) * id;
    x[2 * xs] = (L[2] * b0 + L[4] * b1 + L[5] * b2) * id;
    return;
  }
  if (meta[1] != 0.0) {
    for (int i = 0; i < o; ++i) x[i * xs] = NAN;
    return;
  }
  for (int i = 0; i < o; ++i) {  // L y = b, y in x
    double u = b[i * bs];
    for (int q = 0; q < i; ++q) u = u - L[i * o + q] * x[q * xs];
    x[i * xs] = u * inv[i];
  }
  for (int i = o - 1; i >= 0; --i) {  // L' x = y
    double u = x[i * xs];
    for (int q = i + 1; q < o; ++q) u = u - L[q * o + i] * x[q * xs];
    x[i * xs] = u * inv[i];
  }
}

// ---------------------------------------------------------------------------
// The Kalman filter
// ---------------------------------------------------------------------------

// Particle p of nb: T [n, n, nb], R [n, k, nb], Q [k, k, nb], Z [o, n, nb],
// d [o, nb], H [o, o, nb]; ys the observations [o][n_t] in the tile's last
// o n_t doubles (the caller stages them); ok [nb] or null -> out[p], -inf
// for a rejected particle. tile: kalman_doubles(n, k, o, n_t).
template <int N>
SMC_HD void kalman_block(const double* T, const double* R, const double* Q,
                         const double* Z, const double* d, const double* H,
                         int n_t, const unsigned char* ok, long long nb,
                         long long p, int n, int k, int o, int lyap_iter,
                         double* out, double* tile) {
  if (ok != nullptr && !ok[p]) {
    SMC_TEAM(N, t) {
      if (t == 0) out[p] = -INFINITY;
    }
    return;
  }
  const int nn = n * n, oo = o * o, no = n * o;
  double* Ts = tile;
  double* Pk = Ts + nn;
  double* Zs = Pk + nn;  // [o][n]
  double* ds = Zs + no;
  double* s = ds + o;
  double* s2 = s + n;
  double* v = s2 + n;
  double* F = v + o;
  double* F2 = F + oo;
  double* M = F2 + oo;
  double* M2 = M + oo;
  double* MW = M2 + oo;  // M W'Z'
  double* G = MW + oo;   // F'^-1 Z W
  double* Rm = G + oo;   // G M
  double* L = Rm + oo;
  double* sol = L + oo;  // [o][1 + o]
  double* inv = sol + o * (o + 1);
  double* sc = inv + o;  // total, bad, tr cap, log det, fail
  double* red = sc + 8;
  double* un = red + red_doubles(N);
  const double* ys = tile + kalman_fixed(n, o) + kalman_union(n, k, o);
  // the doubling's buffers
  double* Ak = un;
  double* An = Ak + nn;
  double* tmp = An + nn;  // also Q R' [k][n]
  // the filter's, after it
  double* K = un;  // [n][o]
  double* K2 = K + no;
  double* W = K2 + no;
  double* W2 = W + no;
  double* U = W2 + no;  // W M W'Z'

  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, n);
    SMC_SLAB(sl, n, n, i, j) Ts[i * n + j] = T[at(i, j, n, nb, p)];
    const Slab sz = slab(t, N, n);
    SMC_SLAB(sz, o, n, i, j) Zs[i * n + j] = Z[at(i, j, n, nb, p)];
    for (int i = t; i < o; i += N) ds[i] = d[(long long)i * nb + p];
    // Q R'
    const Slab sq = slab(t, N, n);
    SMC_SLAB(sq, k, n, a, j) {
      double u = 0.0;
      for (int b = 0; b < k; ++b)
        u += Q[at(a, b, k, nb, p)] * R[at(j, b, k, nb, p)];
      tmp[a * n + j] = u;
    }
  }
  block_sync();
  // P = R (Q R'), A_k = T
  double m;
  {
    Lanes<double[1], N> pm;
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      double mx = 0.0;
      SMC_SLAB(sl, n, n, i, j) {
        double u = 0.0;
        for (int a = 0; a < k; ++a)
          u += R[at(i, a, k, nb, p)] * tmp[a * n + j];
        Pk[i * n + j] = u;
        Ak[i * n + j] = Ts[i * n + j];
        mx = dmax(mx, mag(Ts[i * n + j]));
      }
      pm[t][0] = mx;
    }
    team_reduce<1>(pm, red, 0, &m);
  }
  // P <- P + A_k (P A_k'), A_k <- A_k A_k
  for (int it = 0; it < lyap_iter && !(m <= kExitLyap); ++it) {
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      SMC_SLAB(sl, n, n, i, j) {
        double pa = 0.0, aa = 0.0;
        for (int l = 0; l < n; ++l) {
          pa += Pk[i * n + l] * Ak[j * n + l];
          aa += Ak[i * n + l] * Ak[l * n + j];
        }
        tmp[i * n + j] = pa;
        An[i * n + j] = aa;
      }
    }
    block_sync();
    Lanes<double[1], N> pm;
    SMC_TEAM(N, t) {
      const Slab sl = slab(t, N, n);
      double mx = 0.0;
      SMC_SLAB(sl, n, n, i, j) {
        double u = 0.0;
        for (int l = 0; l < n; ++l) u += Ak[i * n + l] * tmp[l * n + j];
        Pk[i * n + j] = Pk[i * n + j] + u;
        mx = dmax(mx, mag(An[i * n + j]));
      }
      pm[t][0] = mx;
    }
    team_reduce<1>(pm, red, 0, &m);
    double* c = Ak;
    Ak = An;
    An = c;
  }

  // P Z' into U, then F1 (before symmetrizing, in F2), K1 = T P Z', W1 = K1
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, o);
    SMC_SLAB(sl, n, o, i, a) {
      double u = 0.0;
      for (int l = 0; l < n; ++l) u += Pk[i * n + l] * Zs[a * n + l];
      U[i * o + a] = u;
    }
  }
  block_sync();
  SMC_TEAM(N, t) {
    const Slab sl = slab(t, N, o);
    SMC_SLAB(sl, n, o, i, a) {
      double u = 0.0;
      for (int l = 0; l < n; ++l) u += Ts[i * n + l] * U[l * o + a];
      K[i * o + a] = u;
      W[i * o + a] = u;
    }
    const Slab sf = slab(t, N, o);
    SMC_SLAB(sf, o, o, a, b) {
      double u = 0.0;
      for (int l = 0; l < n; ++l) u += Zs[a * n + l] * U[l * o + b];
      F2[a * o + b] = u + H[at(a, b, o, nb, p)];
    }
    for (int i = t; i < n; i += N) s[i] = 0.0;
  }
  block_sync();
  SMC_TEAM(N, t) {
    const Slab sf = slab(t, N, o);
    SMC_SLAB(sf, o, o, a, b)
        F[a * o + b] = 0.5 * (F2[a * o + b] + F2[b * o + a]);
  }
  block_sync();
  SMC_TEAM(N, t) {
    if (t == 0) {
      psd_factor(F, o, L, inv, sc + 3);
      double tr = 0.0;
      for (int a = 0; a < o; ++a) tr = tr + F[a * o + a];
      sc[0] = 0.0;                        // the total
      sc[1] = 0.0;                        // bad
      sc[2] = tr * (1.0 + 1e-6) + 1e-12;  // the trace cap
    }
  }
  block_sync();
  // M1 = sym(-F1^-1): F1^-1 into G, a column a thread
  SMC_TEAM(N, t) {
    for (int c = t; c < o; c += N) {
      for (int a = 0; a < o; ++a) Rm[a * o + c] = a == c ? 1.0 : 0.0;
      psd_solve(L, inv, sc + 3, o, Rm + c, o, G + c, o);
    }
  }
  block_sync();
  SMC_TEAM(N, t) {
    const Slab sf = slab(t, N, o);
    SMC_SLAB(sf, o, o, a, b)
        M[a * o + b] = 0.5 * (-G[a * o + b] + -G[b * o + a]);
  }
  block_sync();

  const int o1 = o + 1;
  for (int step = 0; step < n_t; ++step) {
    if (sc[1] != 0.0 || !finite(sc[0])) break;  // rejected: -inf
    // v = (y - d) - Z s; Z W into sol's columns 1..o
    SMC_TEAM(N, t) {
      for (int a = t; a < o; a += N) {
        double u = 0.0;
        for (int l = 0; l < n; ++l) u += Zs[a * n + l] * s[l];
        v[a] = (ys[a * n_t + step] - ds[a]) - u;
      }
      const Slab sf = slab(t, N, o);
      SMC_SLAB(sf, o, o, a, b) {
        double u = 0.0;
        for (int l = 0; l < n; ++l) u += Zs[a * n + l] * W[l * o + b];
        G[a * o + b] = u;  // Z W, kept for the M-update
      }
    }
    block_sync();
    // F^-1 [v | Z W], a column a thread; M W'Z'
    SMC_TEAM(N, t) {
      for (int c = t; c < o1; c += N)
        psd_solve(L, inv, sc + 3, o, c == 0 ? v : G + (c - 1), c == 0 ? 1 : o,
                  sol + c, o1);
      const Slab sf = slab(t, N, o);
      SMC_SLAB(sf, o, o, a, b) {
        double u = 0.0;
        for (int l = 0; l < o; ++l) u += M[a * o + l] * G[b * o + l];
        MW[a * o + b] = u;
      }
    }
    block_sync();
    // the step's term; s' = T s + K F^-1 v; U = W (M W'Z')
    SMC_TEAM(N, t) {
      if (t == 0) {
        double quad = 0.0;
        for (int a = 0; a < o; ++a) quad = quad + v[a] * sol[a * o1];
        sc[0] = sc[0] - 0.5 * (o * kLog2Pi + sc[3] + quad);
        if (quad < 0.0) sc[1] = 1.0;
      }
      for (int i = t; i < n; i += N) {
        double ts = 0.0, kv = 0.0;
        for (int l = 0; l < n; ++l) ts += Ts[i * n + l] * s[l];
        for (int a = 0; a < o; ++a) kv += K[i * o + a] * sol[a * o1];
        s2[i] = ts + kv;
      }
      const Slab sl = slab(t, N, o);
      SMC_SLAB(sl, n, o, i, b) {
        double u = 0.0;
        for (int a = 0; a < o; ++a) u += W[i * o + a] * MW[a * o + b];
        U[i * o + b] = u;
      }
    }
    block_sync();
    // F' = sym(F + Z U); K' = K + T U; W' = T W - K F^-1 Z W
    SMC_TEAM(N, t) {
      const Slab sf = slab(t, N, o);
      SMC_SLAB(sf, o, o, a, b) {
        double zu = 0.0, uz = 0.0;
        for (int l = 0; l < n; ++l) {
          zu += Zs[a * n + l] * U[l * o + b];
          uz += Zs[b * n + l] * U[l * o + a];
        }
        F2[a * o + b] = 0.5 * ((F[a * o + b] + zu) + (F[b * o + a] + uz));
      }
      const Slab sl = slab(t, N, o);
      SMC_SLAB(sl, n, o, i, a) {
        double tu = 0.0, tw = 0.0, kz = 0.0;
        for (int l = 0; l < n; ++l) {
          tu += Ts[i * n + l] * U[l * o + a];
          tw += Ts[i * n + l] * W[l * o + a];
        }
        for (int b = 0; b < o; ++b) kz += K[i * o + b] * sol[b * o1 + 1 + a];
        K2[i * o + a] = K[i * o + a] + tu;
        W2[i * o + a] = tw - kz;
      }
    }
    block_sync();
    // the factor of F' (this step's M-update, the next step's solve) and
    // the guards on F'
    SMC_TEAM(N, t) {
      if (t == 0) {
        psd_factor(F2, o, L, inv, sc + 3);
        double tr = 0.0;
        bool bad = false;
        for (int a = 0; a < o; ++a) {
          bad = bad || F2[a * o + a] <= 0.0;
          tr = tr + F2[a * o + a];
        }
        if (bad || tr > sc[2]) sc[1] = 1.0;
      }
    }
    block_sync();
    // F'^-1 Z W into sol's columns 1..o (F^-1 Z W is read no more)
    SMC_TEAM(N, t) {
      for (int c = t; c < o; c += N)
        psd_solve(L, inv, sc + 3, o, G + c, o, sol + 1 + c, o1);
    }
    block_sync();
    SMC_TEAM(N, t) {
      const Slab sf = slab(t, N, o);
      SMC_SLAB(sf, o, o, a, b) {
        double u = 0.0;
        for (int l = 0; l < o; ++l) u += sol[a * o1 + 1 + l] * M[l * o + b];
        Rm[a * o + b] = u;
      }
    }
    block_sync();
    // M' = sym(M - (M W'Z') (F'^-1 Z W M))
    SMC_TEAM(N, t) {
      const Slab sf = slab(t, N, o);
      SMC_SLAB(sf, o, o, a, b) {
        double ab = 0.0, ba = 0.0;
        for (int l = 0; l < o; ++l) {
          ab += MW[a * o + l] * Rm[l * o + b];
          ba += MW[b * o + l] * Rm[l * o + a];
        }
        M2[a * o + b] = 0.5 * ((M[a * o + b] - ab) + (M[b * o + a] - ba));
      }
    }
    block_sync();
    double* c;
    c = F; F = F2; F2 = c;
    c = M; M = M2; M2 = c;
    c = K; K = K2; K2 = c;
    c = W; W = W2; W2 = c;
    c = s; s = s2; s2 = c;
  }
  SMC_TEAM(N, t) {
    if (t == 0) out[p] = sc[1] == 0.0 && finite(sc[0]) ? sc[0] : -INFINITY;
  }
}

}  // namespace smc_general
