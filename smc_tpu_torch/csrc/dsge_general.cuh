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
// step. The RE solve and the Lyapunov doubling walk the algorithm phase by
// phase: the threads share each phase's entries (a slab of rows and
// columns each, fixed per phase), and the block's barrier separates the
// phases. Between two barriers a thread writes only entries that no other
// thread reads in that phase, so the host build (dsge_general_cpu.cpp, each
// thread's share run in turn, lanes.cuh) computes what the card computes,
// up to the card's fused multiply-adds.
//
// The Chandrasekhar recursion splits the block by role. Warp 0, the
// innovation warp, does the n_obs-sized algebra with its lanes holding the
// rows in registers: the Cholesky factor of F (pivot broadcast, column
// scaled, rank-1 update of the trailing block, by shuffles), the log det
// (the pivots' logs in parallel, summed by a butterfly: one log on the
// path), the solves F^-1 [v | Z W] and F'^-1 Z W (substitution, each row's
// values passed on by shuffles), the M-update and the guards. The other
// warps, the product warps, form the n_state-sized products. The two hand
// results over at named barriers where the producer arrives without
// waiting, so warp 0 solves while the product warps finish the last step's
// Z W, and the product warps form W' and s' while warp 0 factors F'. Two
// products are reassociated to take n_state out of that chain: Z U = (Z
// W)(M W'Z') and T U = (T W)(M W'Z'), T W being formed for W' anyway, so U
// = W M W'Z' itself is never formed. On the host the roles run in program
// order, warp 0's part of a step before the product warps', which meets
// every hand-off.
//
// What bounds it: latency. At Smets-Wouters' shape (37, 7, 7) a
// cyclic-reduction iteration is a 37 x 111 Gauss-Jordan and four 37^3
// products (~0.65 Mflop), a Chandrasekhar step ~40 kflop; a whole particle
// ~20 Mflop (~10 in the RE solve, ~10 in the filter, ~4 of them the
// doubling) against ~35 kB of inputs. A particle's work is a chain of small
// dependent steps (per Gauss-Jordan pivot step warp 0's pivot search,
// shuffles and divisions; per filter step, the chain through M: warp 0's
// factor, solve and M-update, the product warps' M W'Z' and Z U), so its
// latency, not the card's rate, sets the time: enough particles must be in
// flight, a few blocks per SM. A block is kSmallTeam threads up to n_state
// kSmallMax (more blocks per SM where the matrices are small), kLargeTeam
// beyond.
//
// The RE solve follows bl_solve_linear_re operation for operation:
// Gauss-Jordan with the serial pivot rule (the first maximal |entry| at or
// below the diagonal; on the large team by panels of pivot columns, warp 0
// factoring each, to the same bits), each sum of products in index order,
// the residual test, the two 12-squaring spectral bounds and the finiteness
// test. It
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
#include <string.h>

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

// The Kalman tile: persistent T, P, Z, d, v, the n_obs-square matrices (F,
// M and Z W twice each, M W'Z', the factor L, F'^-1 Z W, its product with
// M; Z U is formed in the next F's place), the innovation solve [n_obs, 1 + n_obs], 4 scalars and the
// reduction slots; then a region used first by the doubling (A_k, A_{k+1},
// and a temporary that also holds Q R'), then by the filter (K and [W | s]
// twice each, T W). The observations stay in global memory: every block
// reads the same n_obs x n_t of them, which the caches hold, and without
// them two of sw_pi_fg's tiles fit an SM.
SMC_HD constexpr long long kalman_union(int n, int k, int o) {
  return 2LL * n * n + (n * n > k * n ? (long long)n * n : (long long)k * n) >
                 5LL * n * o + 2 * n
             ? 2LL * n * n +
                   (n * n > k * n ? (long long)n * n : (long long)k * n)
             : 5LL * n * o + 2 * n;
}
SMC_HD constexpr long long kalman_fixed(int n, int o) {
  return 2LL * n * n + (long long)o * n + 2 * o + 10LL * o * o +
         (long long)o * (o + 1) + 4 + red_doubles(team_for(n));
}
SMC_HD constexpr long long kalman_doubles(int n, int k, int o) {
  return kalman_fixed(n, o) + kalman_union(n, k, o);
}

static_assert(8 * re_doubles(kMaxState, kMaxShock) <= kSmemLimit,
              "the RE tile at the largest shape passes the shared memory");
static_assert(8 * kalman_doubles(kMaxState, kMaxShock, kMaxObs) <=
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

// warp 0 alone runs the block that follows (on the host: every lane of it,
// phase by phase, as SMC_LANES does)
#ifdef __CUDA_ARCH__
#define SMC_INNOVATION_WARP if (threadIdx.x < smc::kWarp)
#else
#define SMC_INNOVATION_WARP
#endif

// the product warps (the block's warps but warp 0) alone run the block that
// follows (on the host: SMC_TEAM's threads t >= 32 of it)
#ifdef __CUDA_ARCH__
#define SMC_PRODUCT_WARPS if (threadIdx.x >= smc::kWarp)
#else
#define SMC_PRODUCT_WARPS
#endif

SMC_HD inline bool finite(double x) { return x - x == 0.0; }
// |x| with NaN taken as +inf, for maxima that must see a NaN
SMC_HD inline double mag(double x) { return x != x ? INFINITY : fabs(x); }
SMC_HD inline double dmax(double a, double b) { return b > a ? b : a; }
// The bits of a double.
SMC_HD inline unsigned long long dbits(double x) {
#ifdef __CUDA_ARCH__
  return (unsigned long long)__double_as_longlong(x);
#else
  unsigned long long b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// a / b, IEEE's quotient; a zero a over a b that is neither zero nor NaN
// by the signs alone (on the card a zero quotient takes the division's slow
// path, a branch and a call)
SMC_HD inline double quot(double a, double b) {
  if (a == 0.0 && b == b && b != 0.0)
    return signbit(a) != signbit(b) ? -0.0 : 0.0;
  return a / b;
}

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
// columns are left partly eliminated: nothing reads them). Both forms below
// follow the serial rule: per pivot step k the pivot row p is the first
// maximal |W[r][k]| with r >= k (a column with no comparable entry, all
// NaN, keeps p = k), rows k and p trade places, the factors are the swapped
// column's entries over the pivot, every row i != k becomes W[i] - fac[i]
// row, and row k row / pivot. Column k and the columns before it are never
// read again, so they are not written. piv_rows, where given (the tests'
// host build), receives each step's pivot row. fac [n] and row [w] are
// scratch.
//
// The small team, two barriers a step: every warp finds the pivot (each
// lane the first maximum of its rows r = k + lane + 32 i, then
// warp_argmax), moves row k to row p and row p to the row buffer, and forms
// the factors (fac[k] holds the pivot); then the team updates the rows.
template <int N>
SMC_HD inline void gauss_jordan_steps(double* W, int ld, int n, int w,
                                      double* fac, double* row,
                                      int* piv_rows) {
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

// The large team (n from kSmallMax + 1 to 64) takes the pivot columns in
// panels of kPanel, one block barrier a panel.
//
// Warp 0 factors a panel in registers. Lane l holds row l and row l + 32 of
// the panel's columns (its two slots); each slot's item stays in its slot
// while its label, the row it is in now, follows the serial rule's swaps. A
// step takes the pivot by the serial rule over the labels (the first
// maximal |x| at or below the diagonal, by warp reductions), trades two
// labels where the serial rule moves two rows, forms the factors and
// applies the step to the panel's later columns, the pivot's entries
// passed by shuffles. A step's divisions run as two: each lane's first
// slot's factor, then its second slot's or, in the lanes without one, the
// pivot's later entries over the pivot (a double division's slow path is a
// branch and a call, so the divisions are not left to repeat down the
// chain). It then publishes the panel: each step's factors into the
// panel's own columns, which nothing reads again (the pivot's own entry
// holds the pivot), each step's pivot row (where it stood at the panel's
// start), and where the items of the panel's rows go.
//
// The other warps then update the columns past the panel, two threads a
// column, each entry read from shared memory once and written once, each
// item written to the row the panel's swaps take it to (panel_update).
// Warp 1's first columns hold the next panel's: once they are done it
// signals warp 0, which factors the next panel while the others finish
// (look-ahead), its metadata in the other half of double buffers. Every
// entry sees the serial rule's operations in its order, so the bits are
// the small team's.
constexpr int kPanel = 4;

// v[j] <- lane src(j)'s v[j] for j >= j0 (the others unchanged)
template <int K, class Src>
SMC_HD inline void warp_bcast(Lanes<double[K], kWarp>& v, Src src, int j0) {
#ifdef __CUDA_ARCH__
  SMC_UNROLL for (int j = 0; j < K; ++j) if (j >= j0) v[0][j] =
      __shfl_sync(0xffffffffu, v[0][j], src(j));
#else
  for (int j = j0; j < K; ++j) {
    const double x = v[src(j)][j];
    for (int l = 0; l < kWarp; ++l) v[l][j] = x;
  }
#endif
}

// the warp's largest (least) value, in every lane
SMC_HD inline unsigned warp_max_u32(Lanes<unsigned, kWarp>& v) {
#ifdef __CUDA_ARCH__
  return __reduce_max_sync(0xffffffffu, v[0]);
#else
  unsigned m = v[0];
  for (int l = 1; l < kWarp; ++l) m = v[l] > m ? v[l] : m;
  return m;
#endif
}
SMC_HD inline unsigned warp_min_u32(Lanes<unsigned, kWarp>& v) {
#ifdef __CUDA_ARCH__
  return __reduce_min_sync(0xffffffffu, v[0]);
#else
  unsigned m = v[0];
  for (int l = 1; l < kWarp; ++l) m = v[l] < m ? v[l] : m;
  return m;
#endif
}

// the lanes where v holds, a bit each; the lowest lane of a non-empty mask;
// lane src's v, in every lane
SMC_HD inline unsigned warp_ballot(Lanes<bool, kWarp>& v) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(0xffffffffu, v[0]);
#else
  unsigned b = 0;
  for (int l = 0; l < kWarp; ++l) b |= v[l] ? 1u << l : 0u;
  return b;
#endif
}
SMC_HD inline int lowest_lane(unsigned mask) {
#ifdef __CUDA_ARCH__
  return __ffs(mask) - 1;
#else
  int l = 0;
  while (!(mask >> l & 1u)) ++l;
  return l;
#endif
}
SMC_HD inline unsigned warp_read_u32(Lanes<unsigned, kWarp>& v, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v[0], src);
#else
  return v[src];
#endif
}

// The panel k0..k0+bw-1 of W [n][ld] on warp 0: factored, and published
// into W's columns k0.. (the factors), piv_at[c] (step c's pivot row at the
// panel's start) and go_to[r - k0] (the row that the item in row r of the
// panel's rows goes to).
SMC_HD inline void panel_factor(double* W, int ld, int n, int k0, int bw,
                                double* piv_at, double* go_to,
                                int* piv_rows) {
  // x[l][2 c + q]: column c's entry of row l + 32 q; lab: each slot's row
  // now (n: no item)
  Lanes<double[2 * kPanel], kWarp> x;
  Lanes<int[2], kWarp> lab;
  SMC_LANES(l) {
    SMC_UNROLL for (int q = 0; q < 2; ++q) {
      const int r = l + kWarp * q;
      lab[l][q] = r < n ? r : n;
      SMC_UNROLL for (int c = 0; c < kPanel; ++c)
        x[l][2 * c + q] = r < n && c < bw ? W[r * ld + k0 + c] : 0.0;
    }
  }
  // the lanes that divide the pivot's later entries: the last kPanel, in
  // their second division where they hold no second row
  constexpr int kU = kWarp - kPanel;
  const bool u_apart = n > kWarp + kU;
  SMC_UNROLL for (int c = 0; c < kPanel; ++c) {
    if (c >= bw) break;
    const int k = k0 + c;
    // the pivot: of the rows >= k, the largest |x| (NaN never), then the
    // least row. Keys: the bits of |x| + 2^32 (0: no candidate), their
    // high word, then their low word, then the row. Where one lane holds
    // the largest high word, its row and slot are the pivot's.
    Lanes<unsigned, kWarp> hi, lo, rw, ws;
    SMC_LANES(l) {
      unsigned long long best = 0;
      int arg = n, slot = 0;
      SMC_UNROLL for (int q = 0; q < 2; ++q) {
        const int r = lab[l][q];
        const double a = fabs(x[l][2 * c + q]);
        const unsigned long long key = dbits(a) + (1ull << 32);
        if (r >= k && r < n && a == a &&
            (key > best || (key == best && r < arg))) {
          best = key;
          arg = r;
          slot = l + kWarp * q;
        }
      }
      hi[l] = (unsigned)(best >> 32);
      lo[l] = (unsigned)best;
      rw[l] = (unsigned)arg;
      ws[l] = (unsigned)(arg << 8 | slot);
    }
    const unsigned h = warp_max_u32(hi);
    Lanes<bool, kWarp> top;
    SMC_LANES(l) top[l] = hi[l] == h;
    const unsigned tops = warp_ballot(top);
    int p, s;
    if (h != 0u && (tops & (tops - 1u)) == 0u) {
      const unsigned v = warp_read_u32(ws, lowest_lane(tops));
      p = (int)(v >> 8);
      s = (int)(v & 255u);
    } else {
      SMC_LANES(l) lo[l] = top[l] ? lo[l] : 0u;
      const unsigned m = warp_max_u32(lo);
      SMC_LANES(l) rw[l] = top[l] && lo[l] == m ? rw[l] : (unsigned)n;
      const unsigned pr = warp_min_u32(rw);
      p = h != 0u && pr < (unsigned)n ? (int)pr : k;
      Lanes<unsigned, kWarp> own;
      SMC_LANES(l) {
        own[l] = lab[l][0] == p ? l + 1 : lab[l][1] == p ? l + kWarp + 1 : 0;
      }
      s = (int)warp_max_u32(own) - 1;
    }
    const int sl = s % kWarp, sq = s / kWarp;
    // the pivot's entries in columns c.. (entry c: the pivot)
    Lanes<double[kPanel], kWarp> rv;
    SMC_LANES(l) {
      SMC_UNROLL for (int j = 0; j < kPanel; ++j) rv[l][j] =
          sq ? x[l][2 * j + 1] : x[l][2 * j];
    }
    warp_bcast(rv, [=](int) { return sl; }, c);
    // the divisions: f[0], f[1] the slots' factors; u[j] the pivot's entry
    // j over the pivot
    Lanes<double[2], kWarp> f;
    Lanes<double[kPanel], kWarp> u;
    SMC_LANES(l) {
      const double piv = rv[l][c];
      if (l == 0) {
        piv_at[c] = s;
        if (piv_rows != nullptr) piv_rows[k] = p;
      }
      SMC_UNROLL for (int q = 0; q < 2; ++q) {
        const int r = lab[l][q];
        lab[l][q] = r == k ? p : r == p ? k : r;
      }
      double ru = rv[l][0];  // the pivot's entry (l - kU) % kPanel
      SMC_UNROLL for (int j = 1; j < kPanel; ++j)
        ru = (l - kU) % kPanel == j ? rv[l][j] : ru;
      f[l][0] = quot(x[l][2 * c], piv);
      const bool two = l + kWarp < n;
      const double d = quot(two ? x[l][2 * c + 1] : ru, piv);
      f[l][1] = d;
      double e = d;
      if (u_apart) e = quot(ru, piv);
      SMC_UNROLL for (int j = 0; j < kPanel; ++j) u[l][j] = e;
    }
    warp_bcast(u, [=](int j) { return kU + j; }, c + 1);
    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < 2; ++q) {
        const bool is_piv = l + kWarp * q == s;
        const double fq = is_piv ? rv[l][c] : f[l][q];
        x[l][2 * c + q] = fq;
        SMC_UNROLL for (int j = c + 1; j < kPanel; ++j) {
          const double v = x[l][2 * j + q] - fq * rv[l][j];
          x[l][2 * j + q] = is_piv ? u[l][j] : v;
        }
      }
    }
  }
  SMC_LANES(l) {
    SMC_UNROLL for (int q = 0; q < 2; ++q) {
      const int r = l + kWarp * q;
      if (r >= n) continue;
      SMC_UNROLL for (int c = 0; c < kPanel; ++c)
        if (c < bw) W[r * ld + k0 + c] = x[l][2 * c + q];
      if (r >= k0 && r < k0 + bw) go_to[r - k0] = lab[l][q];
    }
  }
}

// Warp 1 tells warp 0 that the next panel's columns are up to date: a
// named barrier of the two warps, at which warp 1 arrives without waiting.
// On the host nothing: the update runs before warp 0's next factor.
SMC_HD inline void ahead_post() {
#ifdef __CUDA_ARCH__
  if (threadIdx.x / kWarp == 1)
    asm volatile("bar.arrive 1, %0;" ::"n"(2 * kWarp) : "memory");
#endif
}
SMC_HD inline void ahead_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kWarp) : "memory");
#endif
}

// Columns j0..w-1 through the panel k0..k0+bw-1 that warp 0 published
// (factors in W's columns k0.., piv_at, go_to), by the team's threads past
// warp 0, two of them a column (its parts h = 0, 1), (N - kWarp) / 2
// columns a pass: both parts form each step's pivot row entry after the
// panel's earlier steps; after a warp barrier part 0 moves the items that
// the swaps take out of the panel's rows; after another the parts share
// the pivots' final entries (steps 2 i + h) and the other rows' steps (four
// rows at a time, in turns). With `ahead`, warp 1 signals warp 0 once it
// has done its first columns, which hold the next panel's.
template <int N>
SMC_HD inline void panel_update(double* W, int ld, int n, int w, int k0,
                                int bw, const double* piv_at,
                                const double* go_to, bool ahead) {
  constexpr int P = 2, t0 = kWarp, nt = N - kWarp;
  static_assert(kWarp / P >= kPanel, "warp 1 holds the next panel");
  const int j0 = k0 + bw;
  int src[kPanel];
  unsigned long long skip = 0;  // the pivots' rows past the panel's rows
  SMC_UNROLL for (int c = 0; c < kPanel; ++c) {
    src[c] = c < bw ? (int)piv_at[c] : 0;
    if (c < bw && src[c] >= k0 + bw) skip |= 1ull << src[c];
  }
  for (int jb = j0; jb < w; jb += nt / P) {
    Lanes<double[kPanel], N> rv;
    SMC_TEAM(N, t) {
      const int j = jb + (t - t0) / P;
      if (t >= t0 && t < t0 + nt && j < w) {
        SMC_UNROLL for (int c = 0; c < kPanel; ++c) {
          if (c >= bw) break;
          const double* F = W + src[c] * ld + k0;
          double r = W[src[c] * ld + j];
          SMC_UNROLL for (int d = 0; d < c; ++d) r -= F[d] * rv[t][d];
          rv[t][c] = r;
        }
      }
    }
    smc::team_sync<kWarp>();
    // part 0: the items that the swaps move out of the panel's rows, into
    // pivots' rows (read above)
    SMC_TEAM(N, t) {
      const int j = jb + (t - t0) / P;
      if (t >= t0 && t < t0 + nt && j < w && (t - t0) % P == 0) {
        for (int c = 0; c < bw; ++c) {
          const int to = (int)go_to[c];
          if (to < k0 + bw) continue;  // a pivot
          const double* F = W + (k0 + c) * ld + k0;
          double v = W[(k0 + c) * ld + j];
          SMC_UNROLL for (int d = 0; d < kPanel; ++d)
            if (d < bw) v -= F[d] * rv[t][d];
          W[to * ld + j] = v;
        }
      }
    }
    smc::team_sync<kWarp>();
    SMC_TEAM(N, t) {
      const int j = jb + (t - t0) / P, h = (t - t0) % P;
      if (t >= t0 && t < t0 + nt && j < w) {
        // the pivots into the panel's rows, steps P i + h in part h
        SMC_UNROLL for (int i = 0; i < (kPanel + P - 1) / P; ++i) {
          const int c = P * i + h;
          if (c >= bw) break;
          int sc = src[0];
          double rc = rv[t][0];
          SMC_UNROLL for (int e = 1; e < kPanel; ++e) {
            sc = c == e ? src[e] : sc;
            rc = c == e ? rv[t][e] : rc;
          }
          const double* F = W + sc * ld + k0;
          double v = quot(rc, F[c]);
          SMC_UNROLL for (int d = 1; d < kPanel; ++d)
            if (d < bw && d > c) v -= F[d] * rv[t][d];
          W[(k0 + c) * ld + j] = v;
        }
        // the items that stay (rows m of the others, the panel's rows left
        // out), four rows at a time, the parts in turns
        for (int m = 4 * h; m < n - bw; m += 4 * P) {
          double v[4];
          int at[4];
          bool put[4];
          SMC_UNROLL for (int e = 0; e < 4; ++e) {
            const int i = m + e < k0 ? m + e : m + e + bw;
            put[e] = m + e < n - bw && !((skip >> (i & 63)) & 1ull);
            at[e] = m + e < n - bw ? i : (m < k0 ? m : m + bw);
            v[e] = W[at[e] * ld + j];
          }
          SMC_UNROLL for (int d = 0; d < kPanel; ++d) {
            if (d < bw) {
              SMC_UNROLL for (int e = 0; e < 4; ++e)
                v[e] -= W[at[e] * ld + k0 + d] * rv[t][d];
            }
          }
          SMC_UNROLL for (int e = 0; e < 4; ++e)
            if (put[e]) W[at[e] * ld + j] = v[e];
        }
      }
    }
    smc::team_sync<kWarp>();
    if (ahead && jb == j0) ahead_post();
  }
}

template <int N>
SMC_HD inline void gauss_jordan_panels(double* W, int ld, int n, int w,
                                       double* fac, double* row,
                                       int* piv_rows) {
  // double buffers: a panel's pivot rows in fac, where its rows' items go
  // in row
  const auto width = [=](int k0) { return n - k0 < kPanel ? n - k0 : kPanel; };
  SMC_INNOVATION_WARP {
    panel_factor(W, ld, n, 0, width(0), fac, row, piv_rows);
  }
  block_sync();
  for (int k0 = 0, b = 0; k0 < n; k0 += kPanel, b = kPanel - b) {
    const int bw = width(k0), k1 = k0 + bw;
    SMC_PRODUCT_WARPS {
      panel_update<N>(W, ld, n, w, k0, bw, fac + b, row + b, k1 < n);
    }
    SMC_INNOVATION_WARP {
      if (k1 < n) {  // the next panel, while the others update the rest
        ahead_wait();
        panel_factor(W, ld, n, k1, width(k1), fac + kPanel - b,
                     row + kPanel - b, piv_rows);
      }
    }
    block_sync();
  }
}

template <int N>
SMC_HD inline void gauss_jordan(double* W, int ld, int n, int w, double* fac,
                                double* row, int* piv_rows = nullptr) {
  if constexpr (N == kLargeTeam)
    gauss_jordan_panels<N>(W, ld, n, w, fac, row, piv_rows);
  else
    gauss_jordan_steps<N>(W, ld, n, w, fac, row, piv_rows);
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
// The innovation warp: bl_psd_fast_solve on warp 0's lanes
// ---------------------------------------------------------------------------

// An n_obs-row matrix on the innovation warp's lanes, for n_obs up to R:
// the warp is G = 32 / R groups of R lanes; lane l holds row l % R, its
// register p column G p + l / R. An R x R matrix takes kSq registers a lane,
// an R x (R + 1) one kRhs. The kernel takes the least R of 4, 8, 16 that
// holds n_obs (Smets-Wouters' 7: 8, two and three registers a lane).
template <int R>
struct Rows {
  static_assert(kWarp % R == 0, "groups of R lanes");
  static constexpr int G = kWarp / R;
  static constexpr int kSq = (R + G - 1) / G;
  static constexpr int kRhs = (R + G) / G;
  SMC_HD static int row(int l) { return l % R; }
  SMC_HD static int col(int l, int p) { return G * p + l / R; }
  // the lane of row r in lane l's group, and the lane of entry (r, c)
  SMC_HD static int in_group(int l, int r) { return r + R * (l / R); }
  SMC_HD static int at(int r, int c) { return r + R * (c % G); }
};
static_assert(kMaxObs <= 16, "n_obs up to 16: R = 16 at most");
SMC_HD constexpr int rows_for(int o) { return o <= 4 ? 4 : o <= 8 ? 8 : 16; }

// register p of a lane's row, p known at run time only (selects: the row
// stays in registers)
template <int K>
SMC_HD inline double reg_at(const double (&x)[K], int p) {
  double v = x[0];
  SMC_UNROLL for (int q = 1; q < K; ++q) v = q == p ? x[q] : v;
  return v;
}

// v[k] <- the value of v[k] in lane src(l) of lane l's warp, for every lane
// l and every k
template <int K, class Src, int N>
SMC_HD inline void warp_gather(Lanes<double[K], N>& v, Src src) {
#ifdef __CUDA_ARCH__
  const int s = src((int)(threadIdx.x % kWarp));
  SMC_UNROLL for (int k = 0; k < K; ++k)
    v[0][k] = __shfl_sync(0xffffffffu, v[0][k], s);
#else
  for (int w = 0; w < N; w += kWarp)
    for (int k = 0; k < K; ++k) {
      double o[kWarp];
      for (int l = 0; l < kWarp; ++l) o[l] = v[w + l][k];
      for (int l = 0; l < kWarp; ++l) v[w + l][k] = o[src(l)];
    }
#endif
}

// the barrier of the product warps (the block's warps but warp 0): a named
// barrier, which warp 0 does not wait at
template <int N>
SMC_HD inline void product_sync() {
#ifdef __CUDA_ARCH__
  if (threadIdx.x >= kWarp)
    asm volatile("bar.sync 1, %0;" ::"n"(N - kWarp) : "memory");
#endif
}

// Hand-offs between warp 0 and the product warps within a filter step:
// named barriers over the block, at which the producer arrives without
// waiting and the consumer waits. On the host nothing: the block's code runs
// in program order, producers first.
enum Signal { kZUReady = 2, kSolReady = 3, kMReady = 4, kZWReady = 5 };
template <int N>
SMC_HD inline void signal_post(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(N) : "memory");
#endif
}
template <int N>
SMC_HD inline void signal_wait(int id) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
#endif
}

// The factor of F [o][o] (symmetric; f holds its rows on the lanes, as
// warp_load leaves them, F in shared memory) into L and each lane's ir, the
// reciprocal of its row's pivot; every lane gets log det F (NaN where the
// factorization failed: a pivot <= 0 or NaN) and the failure flag.
// Cholesky, right-looking: per column j the pivot is broadcast, the column
// scaled and the trailing block updated by a rank-1 product, so each L
// entry is formed as the serial left-looking loop forms it; the logs of the
// pivots are taken in parallel and summed by a butterfly. Selects, no
// branches: the lanes stay converged and the shuffles of a step issue
// together. At o = 3 the cofactors C00, C01, C02, C11, C12, C22 in
// L[0..5], ir = 1 / det in every lane, log det (NaN for det < 0).
template <int R>
SMC_HD inline void warp_factor(Lanes<double[Rows<R>::kRhs], kWarp>& f,
                               const double* F, int o, double* L,
                               Lanes<double, kWarp>& ir,
                               Lanes<double, kWarp>& logdet,
                               Lanes<bool, kWarp>& failed) {
  using W = Rows<R>;
  if (o == 3) {
    SMC_LANES(l) {
      const double a = F[0], b = F[1], c = F[2], d = F[4], e = F[5],
                   g = F[8];
      const double c0 = d * g - e * e, c1 = c * e - b * g,
                   c2 = b * e - c * d;
      const double det = a * c0 + b * c1 + c * c2;
      if (l == 0) {
        L[0] = c0;
        L[1] = c1;
        L[2] = c2;
        L[3] = a * g - c * c;
        L[4] = b * c - a * e;
        L[5] = a * d - b * b;
      }
      ir[l] = 1.0 / det;
      logdet[l] = log(det);
      failed[l] = false;
    }
    return;
  }
  Lanes<double, kWarp> pv;  // the lane's row's pivot
  SMC_LANES(l) {
    pv[l] = 1.0;
    failed[l] = false;
  }
  SMC_UNROLL_BY(1) for (int j = 0; j < o; ++j) {
    const int pj = j / W::G, gj = j % W::G;  // column j's register and group
    Lanes<double[1], kWarp> d, cj;  // F'[j][j]; the lane's column-j entry
    SMC_LANES(l) d[l][0] = cj[l][0] = reg_at(f[l], pj);
    warp_gather(d, [=](int) { return W::at(j, j); });
    SMC_LANES(l) {
      const double s = d[l][0], ljj = sqrt(s), inv = 1.0 / ljj;
      const int r = W::row(l);
      const bool col = (l / R == gj) & (r >= j);  // the lane holds L[r][j]
      failed[l] = failed[l] | !(s > 0.0);
      ir[l] = r == j ? inv : ir[l];
      pv[l] = r == j ? s : pv[l];
      cj[l][0] = col ? (r == j ? ljj : cj[l][0] * inv) : cj[l][0];
      SMC_UNROLL for (int q = 0; q < W::kSq; ++q)
        f[l][q] = col & (q == pj) ? cj[l][0] : f[l][q];
    }
    // the rank-1 update f[r][c] -= L[r][j] L[c][j], j < c <= r
    Lanes<double[1], kWarp> lr;
    SMC_LANES(l) lr[l][0] = cj[l][0];
    warp_gather(lr, [=](int l) { return l % R + R * gj; });
    SMC_UNROLL for (int p = 0; p < W::kSq; ++p) {
      Lanes<double[1], kWarp> lc;
      SMC_LANES(l) lc[l][0] = cj[l][0];
      warp_gather(lc, [=](int l) { return W::col(l, p) % R + R * gj; });
      SMC_LANES(l) {
        const int r = W::row(l), c = W::col(l, p);
        const double u = f[l][p] - lr[l][0] * lc[l][0];
        f[l][p] = (c > j) & (c <= r) & (r < o) ? u : f[l][p];
      }
    }
  }
  Lanes<double[1], kWarp> lg;
  SMC_LANES(l) lg[l][0] = l < R ? log(pv[l]) : 0.0;
  smc::group_sum<kWarp>(lg);
  SMC_LANES(l) {
    logdet[l] = failed[l] ? NAN : lg[l][0];
    SMC_UNROLL for (int p = 0; p < W::kSq; ++p) {
      const int r = W::row(l), c = W::col(l, p);
      if (c <= r && r < o) L[r * o + c] = f[l][p];
    }
  }
}

// x <- F^-1 x for the columns of x (o rows on the lanes), from warp_factor's
// L (in shared memory, written before the last warp sync) and ir: the
// triangular solves L y = x, L' x = y by substitution; per row i, its
// values scaled by its reciprocal pivot, passed to the other rows by
// shuffles and taken off them. Selects, no branches. Where the
// factorization failed, NaN (as bl_chol_solve). At o = 3 the cofactor form.
template <int R>
SMC_HD inline void warp_solve(const double* L, int o,
                              Lanes<double, kWarp>& ir,
                              Lanes<bool, kWarp>& failed,
                              Lanes<double[Rows<R>::kRhs], kWarp>& x) {
  using W = Rows<R>;
  constexpr int K = W::kRhs;
  if (o == 3) {
    Lanes<double[K], kWarp> b0, b1, b2;
    SMC_LANES(l) {
      SMC_UNROLL for (int p = 0; p < K; ++p) b0[l][p] = b1[l][p] = b2[l][p] =
          x[l][p];
    }
    warp_gather(b0, [=](int l) { return W::in_group(l, 0); });
    warp_gather(b1, [=](int l) { return W::in_group(l, 1); });
    warp_gather(b2, [=](int l) { return W::in_group(l, 2); });
    SMC_LANES(l) {
      const int r = W::row(l) < 3 ? W::row(l) : 0;  // row r of the cofactors
      const double c0 = L[r], c1 = L[r == 0 ? 1 : r + 2],
                   c2 = L[r == 0 ? 2 : r + 3];
      SMC_UNROLL for (int p = 0; p < K; ++p) {
        const double u = (c0 * b0[l][p] + c1 * b1[l][p] + c2 * b2[l][p]) * ir[l];
        x[l][p] = W::row(l) < 3 ? u : x[l][p];
      }
    }
    return;
  }
  SMC_UNROLL_BY(1) for (int k = 0; k < 2 * o; ++k) {  // L y = x, L' x = y
    const bool down = k < o;
    const int i = down ? k : 2 * o - 1 - k;  // the row scaled and passed on
    Lanes<double, kWarp> li;  // L[r][i] going down, L[i][r] going up
    SMC_LANES(l) {
      const int r = W::row(l) < o ? W::row(l) : 0;
      li[l] = L[down ? r * o + i : i * o + r];
      SMC_UNROLL for (int p = 0; p < K; ++p)
        x[l][p] = W::row(l) == i ? x[l][p] * ir[l] : x[l][p];
    }
    if (down ? i == o - 1 : i == 0) continue;  // no row beyond
    SMC_UNROLL for (int p = 0; p < K; ++p) {
      Lanes<double[1], kWarp> xi;
      SMC_LANES(l) xi[l][0] = x[l][p];
      warp_gather(xi, [=](int l) { return W::in_group(l, i); });
      SMC_LANES(l) {
        const int r = W::row(l);
        const bool take = down ? (r > i) & (r < o) : r < i;
        const double u = x[l][p] - li[l] * xi[l][0];
        x[l][p] = take ? u : x[l][p];
      }
    }
  }
  SMC_LANES(l) {
    SMC_UNROLL for (int p = 0; p < K; ++p) x[l][p] = failed[l] ? NAN : x[l][p];
  }
}

// x's rows from S [o][ld], its columns c0.. as x's columns 0.. (m of them;
// the rest 0); and back
template <int R>
SMC_HD inline void warp_load(Lanes<double[Rows<R>::kRhs], kWarp>& x,
                             const double* S, int ld, int c0, int o, int m) {
  SMC_LANES(l) {
    SMC_UNROLL for (int p = 0; p < Rows<R>::kRhs; ++p) {
      const int r = Rows<R>::row(l), c = Rows<R>::col(l, p);
      const bool in = (r < o) & (c < m);
      const double u = S[in ? r * ld + c0 + c : 0];
      x[l][p] = in ? u : 0.0;
    }
  }
}
template <int R>
SMC_HD inline void warp_store(Lanes<double[Rows<R>::kRhs], kWarp>& x,
                              double* S, int ld, int o, int m) {
  SMC_LANES(l) {
    SMC_UNROLL for (int p = 0; p < Rows<R>::kRhs; ++p) {
      const int r = Rows<R>::row(l), c = Rows<R>::col(l, p);
      if (r < o && c < m) S[r * ld + c] = x[l][p];
    }
  }
}

// ---------------------------------------------------------------------------
// The product warps: a thread's share of a product
// ---------------------------------------------------------------------------

// Thread u of nb over C [rows][cols] (cols <= nb), C[r][c] = the sum over l
// < len of a(r)[l] b[l * bl + c * bc], formed in index order from 0: column
// u % cols, rows u / cols + g k (g = nb / cols), two rows at a time (two
// independent sums, one chain of latency); epi(r, c, sum, x) stores, x being
// what pre(r, c) read before the sums began (a load from global memory that
// would otherwise wait in the epilogue).
template <class RowOf, class Pre, class Epi>
SMC_HD inline void product(int u, int nb, int rows, int cols, int len,
                           RowOf a, const double* b, int bl, int bc, Pre pre,
                           Epi epi) {
  const int g = nb / cols, c = u % cols;
  if (u / cols >= g) return;
  for (int r0 = u / cols; r0 < rows; r0 += 2 * g) {
    const int r1 = r0 + g < rows ? r0 + g : r0;
    const double x0 = pre(r0, c), x1 = pre(r1, c);
    const double* a0 = a(r0);
    const double* a1 = a(r1);
    double s0 = 0.0, s1 = 0.0;
    SMC_UNROLL_BY(4) for (int l = 0; l < len; ++l) {
      const double x = b[l * bl + c * bc];
      s0 += a0[l] * x;
      s1 += a1[l] * x;
    }
    epi(r0, c, s0, x0);
    if (r1 != r0) epi(r1, c, s1, x1);
  }
}
// the same with nothing read ahead: epi(r, c, sum)
template <class RowOf, class Epi>
SMC_HD inline void product(int u, int nb, int rows, int cols, int len,
                           RowOf a, const double* b, int bl, int bc,
                           Epi epi) {
  product(u, nb, rows, cols, len, a, b, bl, bc,
          [](int, int) { return 0.0; },
          [=](int r, int c, double s, double) { epi(r, c, s); });
}

// ---------------------------------------------------------------------------
// The Kalman filter
// ---------------------------------------------------------------------------

// Particle p of nb: T [n, n, nb], R [n, k, nb], Q [k, k, nb], Z [o, n, nb],
// d [o, nb], H [o, o, nb], ys the observations [o][n_t] (global memory, read
// by the product warps a step ahead); ok [nb] or null -> out[p], -inf for a
// rejected particle. tile: kalman_doubles(n, k, o).
//
// A filter step, by role (R: the rows of the innovation warp's layout, the
// least of 4, 8, 16 that holds n_obs):
//   warp 0          waits for v and Z W; solves F^-1 [v | Z W] and adds
//                   the step's term; hands over the solution;
//   product warps   wait for M; form M W'Z' and Z U = (Z W)(M W'Z'); hand
//                   over Z U;
//   warp 0          waits for Z U; forms F' = sym(F + Z U) and its guards,
//                   its factor, F'^-1 Z W and M'; hands over M' and the
//                   verdict;
//   product warps   wait for the solution; form [W' | s'] = T [W | s] - K
//                   F^-1 [Z W | -v], K' = K + (T W)(M W'Z'), and the next
//                   step's v and Z W (its observations loaded before the
//                   sums, so the load is off the hand-off); hand them over.
// F, M, K, [W | s] and Z W are kept twice: what the step reads and what it
// forms.
template <int N, int Ro>
SMC_HD void kalman_block(const double* T, const double* R, const double* Q,
                         const double* Z, const double* d, const double* H,
                         const double* ys, int n_t, const unsigned char* ok,
                         long long nb, long long p, int n, int k, int o,
                         int lyap_iter, double* out, double* tile) {
  static_assert(N > kWarp, "warp 0 and at least one product warp");
  using W = Rows<Ro>;
  if (ok != nullptr && !ok[p]) {
    SMC_TEAM(N, t) {
      if (t == 0) out[p] = -INFINITY;
    }
    return;
  }
  const int nn = n * n, oo = o * o, no = n * o, o1 = o + 1;
  double* Ts = tile;
  double* Pk = Ts + nn;
  double* Zs = Pk + nn;  // [o][n]
  double* ds = Zs + no;
  double* v = ds + o;
  // F, M and Z W twice (a step's and the next step's), in turns
  double* F = v + o;
  double* M = F + 2 * oo;
  double* MW = M + 2 * oo;  // M W'Z'
  double* ZW = MW + oo;
  double* L = ZW + 2 * oo;
  double* G = L + oo;   // F'^-1 Z W
  double* Rm = G + oo;  // G M
  double* sol = Rm + oo;  // F^-1 [v | Z W], [o][1 + o]
  // warp 0's scalars: the verdict (1: rejected), the trace cap, the factor's
  // log det, the total
  double* sc = sol + o * o1;
  enum { kFlag, kCap, kLogdet, kTotal };
  double* red = sc + 4;
  double* un = red + red_doubles(N);
  // the doubling's buffers
  double* Ak = un;
  double* An = Ak + nn;
  double* tmp = An + nn;  // also Q R' [k][n]
  // the filter's, after it
  // K [n][o] and [W | s] [n][o + 1] twice, in turns
  double* K = un;
  double* Ws = K + 2 * no;
  double* U = Ws + 2 * n * o1;  // [n][o]: P Z' before the filter, then T W

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

  // P Z' into U, then F1 before symmetrizing (in F's second place), K1 = T
  // P Z', W1 = K1,
  // s = 0
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
      Ws[i * o1 + a] = u;
    }
    const Slab sf = slab(t, N, o);
    SMC_SLAB(sf, o, o, a, b) {
      double u = 0.0;
      for (int l = 0; l < n; ++l) u += Zs[a * n + l] * U[l * o + b];
      F[oo + a * o + b] = u + H[at(a, b, o, nb, p)];
    }
    for (int i = t; i < n; i += N) Ws[i * o1 + o] = 0.0;
  }
  block_sync();

  // warp 0's state, in every lane: the lane's row's reciprocal pivot, the
  // factor's failure, the guards' verdict
  Lanes<double, kWarp> ir;
  Lanes<bool, kWarp> failed, bad;
  // F1 = sym(.), its factor and trace cap, M1 = sym(-F1^-1); v and Z W of
  // the first step
  SMC_INNOVATION_WARP {
    Lanes<double[W::kRhs], kWarp> x;
    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < W::kRhs; ++q) {
        const int r = W::row(l), c = W::col(l, q);
        const bool in = (r < o) & (c < o);
        const int rc = in ? r * o + c : 0, cr = in ? c * o + r : 0;
        x[l][q] = 0.5 * (F[oo + rc] + F[oo + cr]);
        if (in) F[rc] = x[l][q];
      }
      double tr = 0.0;
      SMC_UNROLL_BY(1) for (int a = 0; a < o; ++a) {
        const int aa = a * o + a;
        tr = tr + 0.5 * (F[oo + aa] + F[oo + aa]);  // F[a][a]
      }
      bad[l] = false;
      if (l == 0) {
        sc[kFlag] = 0.0;
        sc[kCap] = tr * (1.0 + 1e-6) + 1e-12;
        sc[kTotal] = 0.0;
      }
    }
    if (o == 3) smc::smc_sync();  // the cofactors read F
    Lanes<double, kWarp> logdet;
    warp_factor<Ro>(x, F, o, L, ir, logdet, failed);
    SMC_LANES(l) {
      if (l == 0) sc[kLogdet] = logdet[l];
    }
    smc::smc_sync();
    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < W::kRhs; ++q)
        x[l][q] = W::row(l) == W::col(l, q) ? 1.0 : 0.0;
    }
    warp_solve<Ro>(L, o, ir, failed, x);
    warp_store<Ro>(x, G, o, o, o);
    smc::smc_sync();
    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
        const int r = W::row(l), c = W::col(l, q);
        const bool in = (r < o) & (c < o);
        const int rc = in ? r * o + c : 0, cr = in ? c * o + r : 0;
        const double u = 0.5 * (-G[rc] + -G[cr]);
        if (in) M[rc] = u;
      }
    }
  }
  // [Z W | Z s] from [W | s] (product warp thread w): Z W into zw, and
  // step s's v = (y_s - d) - Z s (none at s = n_t: no data left), y_s
  // loaded before the sums
  const auto z_row = [=](int a) { return (const double*)(Zs + a * n); };
  const auto t_row = [=](int i) { return (const double*)(Ts + i * n); };
  const auto zw_v = [=](int w, const double* Wx, double* zw, int s) {
    product(w, N - kWarp, o, o1, n, z_row, Wx, o1, 1,
            [=](int a, int c) {
              return c == o && s < n_t ? ys[a * n_t + s] : 0.0;
            },
            [=](int a, int c, double u, double y) {
              if (c < o)
                zw[a * o + c] = u;
              else if (s < n_t)
                v[a] = (y - ds[a]) - u;
            });
  };
  SMC_TEAM(N, t) {
    if (t >= kWarp) zw_v(t - kWarp, Ws, ZW, 0);
  }
  block_sync();

  for (int step = 0; step < n_t; ++step) {
    const bool more = step + 1 < n_t;
    // this step's F, M, K, [W | s] and Z W, and the next step's
    const int cur = step % 2, nxt = 1 - cur;
    double* const Fc = F + cur * oo;
    double* const Fn = F + nxt * oo;
    double* const Mc = M + cur * oo;
    double* const Mn = M + nxt * oo;
    double* const Kc = K + cur * no;
    double* const Kn = K + nxt * no;
    double* const Wc = Ws + cur * n * o1;
    double* const Wn = Ws + nxt * n * o1;
    double* const zc = ZW + cur * oo;
    double* const zn = ZW + nxt * oo;
    // warp 0: F^-1 [v | Z W] and the step's term
    SMC_INNOVATION_WARP {
      if (step > 0) signal_wait<N>(kZWReady);
      Lanes<double[W::kRhs], kWarp> x;
      SMC_LANES(l) {
        SMC_UNROLL for (int q = 0; q < W::kRhs; ++q) {
          const int r = W::row(l), c = W::col(l, q);
          const bool in = (r < o) & (c <= o);
          const double u = c == 0 ? v[in ? r : 0] : zc[in ? r * o + c - 1 : 0];
          x[l][q] = in ? u : 0.0;
        }
      }
      warp_solve<Ro>(L, o, ir, failed, x);
      warp_store<Ro>(x, sol, o1, o, o1);
      smc::smc_sync();
      SMC_LANES(l) {
        double quad = 0.0;
        SMC_UNROLL_BY(1) for (int a = 0; a < o; ++a)
          quad = quad + v[a] * sol[a * o1];
        const double total =
            sc[kTotal] - 0.5 * (o * kLog2Pi + sc[kLogdet] + quad);
        bad[l] = bad[l] | (quad < 0.0);
        if (l == 0) sc[kTotal] = total;
      }
      signal_post<N>(kSolReady);
    }
    // the product warps: M W'Z', then Z U = (Z W) (M W'Z') in the next F's
    // place
    SMC_PRODUCT_WARPS {
      if (step > 0) {
        signal_wait<N>(kMReady);
        if (sc[kFlag] != 0.0) break;  // rejected: -inf
      }
      SMC_TEAM(N, t) {
        if (t >= kWarp)
          product(t - kWarp, N - kWarp, o, o, o,
                  [=](int a) { return (const double*)(Mc + a * o); }, zc, 1,
                  o, [=](int a, int b, double u) { MW[a * o + b] = u; });
      }
      product_sync<N>();
      SMC_TEAM(N, t) {
        if (t >= kWarp)
          product(t - kWarp, N - kWarp, o, o, o,
                  [=](int a) { return (const double*)(zc + a * o); }, MW, o,
                  1, [=](int a, int b, double u) { Fn[a * o + b] = u; });
      }
      signal_post<N>(kZUReady);
    }
    // warp 0: F' = sym(F + Z U) and its guards; its factor (this step's
    // M-update, the next step's solve); F'^-1 Z W; M' = sym(M - (M W'Z')
    // (F'^-1 Z W M)); the verdict
    SMC_INNOVATION_WARP {
      signal_wait<N>(kZUReady);
      Lanes<double[W::kRhs], kWarp> x;
      SMC_LANES(l) {  // Z U is in F''s place, read before F' goes there
        SMC_UNROLL for (int q = 0; q < W::kRhs; ++q) {
          const int r = W::row(l), c = W::col(l, q);
          const bool in = (r < o) & (c < o);
          const int ab = in ? r * o + c : 0, ba = in ? c * o + r : 0;
          x[l][q] = 0.5 * ((Fc[ab] + Fn[ab]) + (Fc[ba] + Fn[ba]));
        }
        double tr = 0.0;
        bool neg = false;
        SMC_UNROLL_BY(1) for (int a = 0; a < o; ++a) {
          const int aa = a * o + a;
          const double faa = 0.5 * ((Fc[aa] + Fn[aa]) + (Fc[aa] + Fn[aa]));
          neg = neg | (faa <= 0.0);
          tr = tr + faa;
        }
        bad[l] = bad[l] | neg | (tr > sc[kCap]);
      }
      smc::smc_sync();
      SMC_LANES(l) {
        SMC_UNROLL for (int q = 0; q < W::kRhs; ++q) {
          const int r = W::row(l), c = W::col(l, q);
          if ((r < o) & (c < o)) Fn[r * o + c] = x[l][q];
        }
      }
      if (o == 3) smc::smc_sync();  // the cofactors read Fn
      Lanes<double, kWarp> logdet;
      warp_factor<Ro>(x, Fn, o, L, ir, logdet, failed);
      SMC_LANES(l) {
        if (l == 0) sc[kLogdet] = logdet[l];
      }
      smc::smc_sync();
      warp_load<Ro>(x, zc, o, 0, o, o);
      warp_solve<Ro>(L, o, ir, failed, x);
      warp_store<Ro>(x, G, o, o, o);
      smc::smc_sync();
      // Rm = G M, then (M W'Z') Rm, then M' = sym(M - (M W'Z') Rm): the
      // lanes' entries in the rows' layout
      SMC_LANES(l) {
        const int r = W::row(l) < o ? W::row(l) : 0;
        double u[W::kSq];
        SMC_UNROLL for (int q = 0; q < W::kSq; ++q) u[q] = 0.0;
        SMC_UNROLL_BY(1) for (int b = 0; b < o; ++b) {
          const double g = G[r * o + b];
          SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
            const int c = W::col(l, q) < o ? W::col(l, q) : 0;
            u[q] += g * Mc[b * o + c];
          }
        }
        SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
          const int c = W::col(l, q);
          if ((W::row(l) < o) & (c < o)) Rm[r * o + c] = u[q];
        }
      }
      smc::smc_sync();
      SMC_LANES(l) {  // (M W'Z') Rm into G
        const int r = W::row(l) < o ? W::row(l) : 0;
        double u[W::kSq];
        SMC_UNROLL for (int q = 0; q < W::kSq; ++q) u[q] = 0.0;
        SMC_UNROLL_BY(1) for (int b = 0; b < o; ++b) {
          const double mw = MW[r * o + b];
          SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
            const int c = W::col(l, q) < o ? W::col(l, q) : 0;
            u[q] += mw * Rm[b * o + c];
          }
        }
        SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
          const int c = W::col(l, q);
          if ((W::row(l) < o) & (c < o)) G[r * o + c] = u[q];
        }
      }
      smc::smc_sync();
      SMC_LANES(l) {
        const int r = W::row(l) < o ? W::row(l) : 0;
        SMC_UNROLL for (int q = 0; q < W::kSq; ++q) {
          const int c = W::col(l, q) < o ? W::col(l, q) : 0;
          const int rc = r * o + c, cr = c * o + r;
          const double u = 0.5 * ((Mc[rc] - G[rc]) + (Mc[cr] - G[cr]));
          if ((W::row(l) < o) & (W::col(l, q) < o)) Mn[rc] = u;
        }
      }
      bool rejected = false;
      SMC_LANES(l) {
        rejected = bad[l] | !finite(sc[kTotal]);
        if (l == 0) sc[kFlag] = rejected ? 1.0 : 0.0;
      }
      if (more) signal_post<N>(kMReady);
      if (rejected) {  // -inf; the product warps' last hand-off is taken
        if (more) signal_wait<N>(kZWReady);
        break;
      }
    }
    // the product warps: [W' | s'] = T [W | s] - K F^-1 [Z W | -v] (T W
    // kept in U); then K' = K + T U = K + (T W) (M W'Z') and the next step's
    // v and Z W
    SMC_PRODUCT_WARPS {
      signal_wait<N>(kSolReady);
      SMC_TEAM(N, t) {
        if (t >= kWarp)
          product(t - kWarp, N - kWarp, n, o1, n, t_row, Wc, o1, 1,
                  [=](int i, int c, double u) {
                    double kz = 0.0;
                    if (c < o) {
                      for (int b = 0; b < o; ++b)
                        kz += Kc[i * o + b] * sol[b * o1 + 1 + c];
                      Wn[i * o1 + c] = u - kz;
                      U[i * o + c] = u;
                    } else {
                      for (int a = 0; a < o; ++a)
                        kz += Kc[i * o + a] * sol[a * o1];
                      Wn[i * o1 + o] = u + kz;
                    }
                  });
      }
      product_sync<N>();
      SMC_TEAM(N, t) {
        if (t >= kWarp)
          product(t - kWarp, N - kWarp, n, o, o,
                  [=](int i) { return (const double*)(U + i * o); }, MW, o, 1,
                  [=](int i, int a, double u) {
                    Kn[i * o + a] = Kc[i * o + a] + u;
                  });
      }
      if (more) {
        SMC_TEAM(N, t) {
          if (t >= kWarp) zw_v(t - kWarp, Wn, zn, step + 1);
        }
        signal_post<N>(kZWReady);
      }
    }
  }
  SMC_INNOVATION_WARP {
    SMC_LANES(l) {
      if (l == 0)
        out[p] = !bad[l] && finite(sc[kTotal]) ? sc[kTotal] : -INFINITY;
    }
  }
}

}  // namespace smc_general
