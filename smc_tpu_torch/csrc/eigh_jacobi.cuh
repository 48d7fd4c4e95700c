// Eigendecomposition of symmetric k x k f64 matrices (1 <= k <= 1024) by the
// cyclic Jacobi method, one team of threads per matrix:
//
//   k <= kWarpK   two warps per matrix, kBlockThreads / 64 matrices per
//                 block (fewer where their tiles would pass the block's
//                 shared memory), A and V in the team's tile in shared
//                 memory;
//   k <= kSharedK a block of kBlockThreads per matrix, A and V in shared
//                 memory (223 KB at k = 118);
//   beyond        a block per matrix, A and V in a global workspace of the
//                 block's own.
//
// This is not the port of a TPU kernel: the JAX package runs
// jnp.linalg.eigh through XLA. It exists because torch.linalg.eigh on a CUDA
// tensor reads its status back to the host (the call waits for the device),
// so it cannot be captured in a CUDA graph; the proposal factor of the
// mutation (ops/mutation.py) calls it once per stage for all blocks.
//
// Parallel Jacobi (Brent and Luk): the k indices, padded to an even m, are
// paired by the round-robin schedule, m - 1 rounds of P = m / 2 disjoint
// pairs per sweep. A round is two phases, each ended by the team's barrier:
//
//   rotations  thread i < P computes pair i of the round (its place in the
//              schedule, once per round), the rotation (c, s) that zeroes
//              a_pq, and the pair's own 2x2 block (a_pq becomes 0); the
//              warps past the rotations' update V with the round before's;
//   quads      A <- J'AJ in one pass. The pairs are disjoint, so the new
//              entries of rows {p_a, q_a} and columns {p_b, q_b} (a != b)
//              depend on the four old ones only: each quad of pairs is
//              read and written by one thread, in place.
//
// Only A's lower triangle is stored and updated (entry (i, j) at
// i >= j ? [i][j] : [j][i]), so A stays exactly symmetric; V is stored
// transposed, so a rotation's two columns of V are two rows of the tile. A
// thread's share of each phase is fixed once per matrix (Plan below): no
// division per entry. A sweep starts with the off-diagonal mass
// off = sum_{i != j} a_ij^2; the matrix has converged when
// off <= (kTol ||A||_F)^2, kTol at the level of the rotations' own
// rounding. The sums are per-thread partials in a fixed order, then a
// butterfly of shuffles within each warp and a fixed tree over the warps:
// every thread of the team gets the same bits, so the whole team takes the
// same branch. No atomics, and nothing a team computes depends on another
// team: a matrix's result does not depend on the batch, the block or the
// team it shares, or on thread order. A matrix with a non-finite entry
// gives NaN eigenvalues and eigenvectors.
//
// Output: eigenvalues ascending (ties in their diagonal order), the
// eigenvectors as the columns of U with the sign that makes each column's
// largest-magnitude entry (the first, in row order, of equal ones)
// positive. Only the lower triangle of the input is read, as
// torch.linalg.eigh reads it. PERF.md holds the measured times: the small
// matrices of the models are bound by the latency of a round (the
// rotation's chain of dependent f64 operations, then one pass of
// shared-memory updates), the middle path by the shared-memory traffic of
// A's quads and V per round.
//
// The same source runs on the card and on the host (lanes.cuh, eigh_cpu.cpp
// runs each team's threads phase by phase; the host's square roots and the
// card's fused multiply-adds round differently).
#pragma once

#include <math.h>
#include <stddef.h>

#include "lanes.cuh"

#ifndef SMC_SMEM_LIMIT
#error "build with -DSMC_SMEM_LIMIT (smc_tpu_torch/_build.py)"
#endif

namespace smc_jacobi {

using smc::Lanes;
using smc::kWarp;

constexpr int kWarpK = 32;           // a small team per matrix up to this k
constexpr int kSmallThreads = 64;    // that team: two warps
constexpr int kBlockThreads = 512;   // every launch's block
constexpr int kSmemLimit = SMC_SMEM_LIMIT;  // a block's (_build.py)
constexpr int kSharedK = 118;        // A and V in shared memory up to this k
constexpr int kMaxK = 1024;
constexpr int kMaxSweeps = 30;
constexpr double kTol = 1e-15;      // the rotations' own rounding
// a thread's rows of V gathered before they are written, so their loads
// overlap
constexpr int kVChunk = 4;

// row stride of A and V: 2 mod 4. The round-robin moves both indices of
// neighbouring pairs by one, so the entries of neighbouring quads lie
// ld +- 1 apart: odd, so a warp's quads fall in distinct banks (an odd ld
// put them 8 or 16 to a bank); and the rows of V that a warp's pairs
// update start 2 mod 4 doubles apart, where a multiple of 16 would put
// them all on one bank.
SMC_HD constexpr int stride(int k) { return k + ((2 - k) & 3); }
SMC_HD constexpr int pairs(int k) { return (k + 1) / 2; }
SMC_HD constexpr size_t av_doubles(int k) {
  return 2 * (size_t)k * stride(k);
}
SMC_HD constexpr int team_threads(int k) {
  return k <= kWarpK ? kSmallThreads : kBlockThreads;
}

// One team's tile: the rotations of two rounds, c and s [2][P]; A and V
// transposed, [k][stride] each (up to kSharedK); the diagonal and the
// signs [k]; one partial sum of each of three per warp; then ints: the
// rotations' pairs p | q << 16 [2][P] (q >= k: the padding index, the
// rotation is the identity) and the inverse of the sort ranks [k]. The
// table is split by field so that a warp reading neighbouring pairs reads
// neighbouring words.
// Rounded to 16 bytes.
SMC_HD constexpr size_t tile_bytes(int k) {
  return (8 * (4 * pairs(k) + (k <= kSharedK ? av_doubles(k) : 0) + 2 * k +
               3 * (team_threads(k) / kWarp)) +
          4 * (2 * pairs(k) + k) + 15) /
         16 * 16;
}

// matrices per block
SMC_HD constexpr int per_block(int k) {
  return k > kWarpK ? 1
         : kSmemLimit / tile_bytes(k) < kBlockThreads / kSmallThreads
             ? (int)(kSmemLimit / tile_bytes(k))
             : kBlockThreads / kSmallThreads;
}

static_assert(tile_bytes(kSharedK) <= kSmemLimit, "kSharedK too large");
static_assert(tile_bytes(kMaxK) <= kSmemLimit, "kMaxK too large");
static_assert(per_block(kWarpK) >= 1, "kWarpK too large");
static_assert(pairs(kMaxK) <= kBlockThreads, "a round's rotations in a pass");

struct Tile {
  double *c, *s, *a, *v, *d, *sgn, *red;
  int *pq, *inv;
};

// base: the team's tile of tile_bytes(k), 16-byte aligned; av: its
// workspace of av_doubles(k) when k > kSharedK (unused below). kShared
// (k <= kSharedK) is a template parameter so that the card's compiler
// sees A and V in shared memory, and addresses them as such, on that path.
template <bool kShared>
SMC_HD inline Tile carve(double* base, int k, double* av) {
  Tile t;
  const size_t n = (size_t)k * stride(k);
  t.c = base;
  t.s = base + 2 * pairs(k);
  double* f = base + 4 * pairs(k);
  if (kShared) {
    t.a = f;
    f += 2 * n;
  } else {
    t.a = av;
  }
  t.v = t.a + n;
  t.d = f;
  t.sgn = t.d + k;
  t.red = t.sgn + k;
  t.pq = reinterpret_cast<int*>(t.red + 3 * (team_threads(k) / kWarp));
  t.inv = t.pq + 2 * pairs(k);
  return t;
}

SMC_HD inline bool finite(double x) { return x - x == 0.0; }

// A thread's share of a grid [slow) x [fast) split over n threads: fast
// indices f0, f0 + df, ... (one, where fast <= n) and slow indices s0,
// s0 + ds, ...; f0 = fast where the thread has none. Neighbouring threads
// take neighbouring fast indices.
struct Slab {
  int f0, df, s0, ds;
};
SMC_HD inline Slab slab(int t, int n, int fast) {
  if (fast > n) return {t, n, 0, 1};
  const int per = n / fast;
  return {t / fast < per ? t % fast : fast, fast, t / fast, per};
}

// V's update runs beside the rotations, on the warps that compute none,
// where those are at least half the team (the small team's second warp, a
// block up to k = 512); else (a single warp, whose lanes would take the two
// branches one after the other, or a block with few such warps) beside the
// quads, on every thread. The first thread that updates V beside the
// rotations:
template <int N>
SMC_HD constexpr int v_beside(int k) {
  return N == kWarp ? N : (pairs(k) + kWarp - 1) / kWarp * kWarp;
}
template <int N>
SMC_HD constexpr bool v_with_rotations(int k) {
  return 2 * v_beside<N>(k) <= N;
}

// A thread's share of V's update: pairs a0, a0 + da, ... and of each the
// rows r0, r0 + dr, .... Thread t of n takes one pair and every (n / P)-th
// row where there are at least as many threads as pairs, else every n-th
// pair whole. Neighbouring threads take neighbouring rows of a pair.
struct Run {
  int a0, da, r0, dr;
};
SMC_HD inline Run run(int t, int n, int P) {
  Run r;
  const int per = n / P;
  if (per >= 1) {
    r.a0 = t / per < P ? t / per : P;
    r.da = P;
    r.r0 = t % per;
    r.dr = per;
  } else {
    r.a0 = t;
    r.da = n;
    r.r0 = 0;
    r.dr = 1;
  }
  return r;
}

// A thread's shares, fixed once per matrix: the entries (fast: column,
// slow: row), the quads of a round (fast: pair a, slow: j) and V's updates
// (beside the rotations, the threads from v_beside only). Nothing is
// divided per round.
struct Plan {
  Slab e, q;
  Run v;
};
template <int N>
SMC_HD inline Plan plan(int t, int k) {
  const int P = pairs(k);
  const int lo = v_with_rotations<N>(k) ? v_beside<N>(k) : 0;
  // (a braced return with a braced temporary in a conditional crashes
  // the device compiler's front end)
  Plan pl;
  pl.e = slab(t, N, k);
  pl.q = slab(t, N, P);
  pl.v = run(t - lo, N - lo, P);
  if (t < lo) pl.v.a0 = P;  // none
  return pl;
}

// Pair i of round r of the round-robin schedule over m (even) indices:
// (p, q) with p < q. Over rounds 0..m-2 every pair appears once.
SMC_HD inline void pair(int r, int i, int m, int* p, int* q) {
  int x = r, y = m - 1;
  if (i > 0) {  // (r + i) and (r - i) mod m - 1, for 0 <= r < m - 1 > i
    x = r + i < m - 1 ? r + i : r + i - (m - 1);
    y = r - i >= 0 ? r - i : r - i + (m - 1);
  }
  *p = x < y ? x : y;
  *q = x < y ? y : x;
}

// 1 / sqrt(x) and 1 / sqrt(x^2 + y^2). On the card from the float estimate
// refined by two Newton steps in f64 (about 1 ulp; for x in [1e-30, 1e30],
// where the float estimate is exact enough), a third of the latency of
// the f64 square root and division; the host takes the libm functions.
#ifdef __CUDA_ARCH__
__device__ inline double rsqrt_(double x) {
  double y = (double)rsqrtf((float)x);
  y = y * fma(-0.5 * x * y, y, 1.5);
  return y * fma(-0.5 * x * y, y, 1.5);
}
__device__ inline double rhypot_(double x, double y) {
  const double r2 = x * x + y * y;
  return r2 >= 1e-30 && r2 <= 1e30 ? rsqrt_(r2) : rhypot(x, y);
}
#else
inline double rsqrt_(double x) { return 1.0 / sqrt(x); }
inline double rhypot_(double x, double y) { return 1.0 / hypot(x, y); }
#endif

// Rotation zeroing a_pq of [[app, apq], [apq, aqq]]: J = [[c, s], [-s, c]]
// on (p, q), the inner one (|theta| <= pi / 4) of Golub and Van Loan's
// symmetric Schur decomposition, t = s / c = sign(tau) / (|tau| +
// sqrt(1 + tau^2)) with tau = d / h, d = aqq - app, h = 2 apq. Formed from
// the half angle: cos 2theta = |d| / r with r = hypot(d, h), c = sqrt((1 +
// cos 2theta) / 2), s = sign(d) h / (2 r c); two reciprocal square roots in
// a row, where the quotient form takes three divisions and two roots.
SMC_HD inline void rotation(double app, double aqq, double apq, double* c,
                            double* s) {
  *c = 1.0;
  *s = 0.0;
  if (apq == 0.0) return;
  const double d = aqq - app, h = 2.0 * apq;
  const double ri = rhypot_(d, h);
  const double w = 0.5 + 0.5 * (fabs(d) * ri);
  const double g = rsqrt_(w);
  *c = w * g;
  *s = (d < 0.0 ? -0.5 : 0.5) * (h * ri) * g;
}

// index of A's lower-triangle entry (i, j), either order
SMC_HD inline int lo(int i, int j, int ld) {
  return i >= j ? i * ld + j : j * ld + i;
}

// The off-diagonal mass, the total mass and (first) the non-finite entries
// of the team's matrix, summed over the team in a fixed order: 0 iterate,
// 1 converged, 2 non-finite input. Every thread returns the same.
template <int N>
SMC_HD inline int check(const Tile& tl, int k, bool first,
                        Lanes<Plan, N>& pl) {
  const int ld = stride(k);
  Lanes<double[3], N> part;
  SMC_TEAM(N, t) {
    double low = 0.0, dia = 0.0, bad = 0.0;
    const Slab& sl = pl[t].e;
    // every thread the same trip counts: the upper triangle masked, not
    // branched around
    for (int i = sl.s0; i < k; i += sl.ds)
      for (int j = sl.f0; j < k; j += sl.df) {
        const double x = j <= i ? tl.a[i * ld + j] : 0.0;
        bad += first && !finite(x) ? 1.0 : 0.0;
        dia += i == j ? x * x : 0.0;
        low += i != j ? x * x : 0.0;
      }
    part[t][0] = low;
    part[t][1] = dia;
    part[t][2] = bad;
  }
  smc::group_sum<kWarp>(part);
  double sum[3];
  if (N == kWarp) {
    for (int c = 0; c < 3; ++c) sum[c] = part[0][c];
  } else {
    constexpr int W = N / kWarp;
    SMC_TEAM(N, t) {
      if (t % kWarp == 0)
        for (int c = 0; c < 3; ++c) tl.red[3 * (t / kWarp) + c] = part[t][c];
    }
    smc::team_sync<N>();
    double w[W][3];
    for (int u = 0; u < W; ++u)
      for (int c = 0; c < 3; ++c) w[u][c] = tl.red[3 * u + c];
    for (int h = 1; h < W; h <<= 1)
      for (int u = 0; u + h < W; u += 2 * h)
        for (int c = 0; c < 3; ++c) w[u][c] += w[u + h][c];
    for (int c = 0; c < 3; ++c) sum[c] = w[0][c];
  }
  smc::team_sync<N>();
  const double off = 2.0 * sum[0];
  return sum[2] > 0.0 ? 2 : (off <= kTol * kTol * (sum[1] + off) ? 1 : 0);
}

// V <- V J with the rotations of table half h: of each of the thread's
// pairs (p, q), columns p and q of V, which V holds as its rows p and q
// (transposed), so the rows of a run sit at neighbouring addresses;
// kVChunk rows at a time.
SMC_HD inline void rotate_v(const Tile& tl, int k, int h, const Run& rv) {
  const int ld = stride(k), P = pairs(k);
  for (int a = rv.a0; a < P; a += rv.da) {
    const int pq = tl.pq[h + a];
    const int p = pq & 0xffff, q = pq >> 16;
    if (q >= k) continue;
    const double c = tl.c[h + a], s = tl.s[h + a];
    double* vp = tl.v + p * ld;
    double* vq = tl.v + q * ld;
    int row = rv.r0;
    for (; row + (kVChunk - 1) * rv.dr < k; row += kVChunk * rv.dr) {
      double x[kVChunk], y[kVChunk];
      SMC_UNROLL for (int i = 0; i < kVChunk; ++i) {
        x[i] = vp[row + i * rv.dr];
        y[i] = vq[row + i * rv.dr];
      }
      SMC_UNROLL for (int i = 0; i < kVChunk; ++i) {
        vp[row + i * rv.dr] = c * x[i] - s * y[i];
        vq[row + i * rv.dr] = s * x[i] + c * y[i];
      }
    }
    for (; row < k; row += rv.dr) {
      const double x = vp[row], y = vq[row];
      vp[row] = c * x - s * y;
      vq[row] = s * x + c * y;
    }
  }
}

// A <- J'AJ off the pairs' own blocks, with the rotations of table half h:
// the quads of pairs a and b = a + 1 + j (mod P), j < P / 2, each read and
// written by one thread; for an even P the last j meets each quad twice
// and takes it from a < P / 2 only. The thread's quads of its slab sq.
SMC_HD inline void rotate_quads(const Tile& tl, int k, int h,
                                const Slab& sq) {
  const int ld = stride(k), P = pairs(k), J = P / 2;
  for (int j = sq.f0 < P ? sq.s0 : J; j < J; j += sq.ds)
    for (int a = sq.f0; a < P; a += sq.df) {
      if (2 * (j + 1) == P && 2 * a >= P) continue;
      const int b = a + 1 + j < P ? a + 1 + j : a + 1 + j - P;
      const int pa = tl.pq[h + a] & 0xffff, qa = tl.pq[h + a] >> 16;
      const int pb = tl.pq[h + b] & 0xffff, qb = tl.pq[h + b] >> 16;
      const bool ha = qa < k, hb = qb < k;  // else q is the padding index
      const int i00 = lo(pa, pb, ld), i01 = lo(pa, qb, ld),
                i10 = lo(qa, pb, ld), i11 = lo(qa, qb, ld);
      const double x00 = tl.a[i00];
      const double x01 = hb ? tl.a[i01] : 0.0;
      const double x10 = ha ? tl.a[i10] : 0.0;
      const double x11 = ha && hb ? tl.a[i11] : 0.0;
      // columns of pair b, then rows of pair a
      const double cb = tl.c[h + b], sb = tl.s[h + b];
      const double y00 = cb * x00 - sb * x01, y01 = sb * x00 + cb * x01;
      const double y10 = cb * x10 - sb * x11, y11 = sb * x10 + cb * x11;
      const double ca = tl.c[h + a], sa = tl.s[h + a];
      tl.a[i00] = ca * y00 - sa * y10;
      if (hb) tl.a[i01] = ca * y01 - sa * y11;
      if (ha) tl.a[i10] = sa * y00 + ca * y10;
      if (ha && hb) tl.a[i11] = sa * y01 + ca * y11;
    }
}

// Round r, the team's g-th in all: its rotations (threads < P, each its
// pair's own block of A, into table half h) and V's update for the round
// before (V is read by nothing else, so it lags a round; its rotations sit
// in the other half), then A's quads; V beside the rotations or beside the
// quads as v_with_rotations says.
template <int N>
SMC_HD inline void jacobi_round(const Tile& tl, int k, int r, int g,
                                Lanes<Plan, N>& pl) {
  const int ld = stride(k);
  const int P = pairs(k);
  const int h = (g & 1) * P;
  SMC_TEAM(N, t) {
    if (t < P) {
      int p, q;
      pair(r, t, 2 * P, &p, &q);
      double c = 1.0, s = 0.0;
      if (q < k) {
        double* app = tl.a + p * ld + p;
        double* aqq = tl.a + q * ld + q;
        double* apq = tl.a + q * ld + p;
        const double x = *app, y = *apq, z = *aqq;
        rotation(x, z, y, &c, &s);
        // the two-sided product, as the quads form it: the closed form
        // a_pp - t a_pq loses the quadratic convergence on clusters of
        // equal eigenvalues (it stalls near off ~ 1e-17 ||A||^2)
        *app = c * (c * x - s * y) - s * (c * y - s * z);
        *aqq = s * (s * x + c * y) + c * (s * y + c * z);
        *apq = 0.0;
      }
      tl.c[h + t] = c;
      tl.s[h + t] = s;
      tl.pq[h + t] = p | q << 16;
    } else if (v_with_rotations<N>(k) && g > 0) {
      rotate_v(tl, k, P - h, pl[t].v);
    }
  }
  smc::team_sync<N>();
  SMC_TEAM(N, t) {
    rotate_quads(tl, k, h, pl[t].q);
    if (!v_with_rotations<N>(k) && g > 0) rotate_v(tl, k, P - h, pl[t].v);
  }
  smc::team_sync<N>();
}

// the sort key of an eigenvalue: NaN last, so the ranks stay a permutation
SMC_HD inline double key(double x) { return x != x ? INFINITY : x; }

// One matrix on a team of N threads: a_in [k][k] (lower triangle read) ->
// lam [k], u [k][k]; tile and av as carve takes them.
template <int N, bool kShared>
SMC_HD inline void eigh_team(const double* a_in, double* lam, double* u,
                             int k, double* tile, double* av) {
  const Tile tl = carve<kShared>(tile, k, av);
  const int ld = stride(k);
  Lanes<Plan, N> pl;
  SMC_TEAM(N, t) {
    pl[t] = plan<N>(t, k);
    const Slab& sl = pl[t].e;
    for (int i = sl.s0; i < k; i += sl.ds)
      for (int j = sl.f0; j < k; j += sl.df) {
        if (j <= i) tl.a[i * ld + j] = a_in[i * k + j];
        tl.v[i * ld + j] = i == j ? 1.0 : 0.0;
      }
  }
  smc::team_sync<N>();
  int state = check<N>(tl, k, true, pl);
  int g = 0;  // rounds so far
  for (int sweep = 0; sweep < kMaxSweeps && state == 0; ++sweep) {
    for (int r = 0; r < 2 * pairs(k) - 1; ++r, ++g)
      jacobi_round<N>(tl, k, r, g, pl);
    state = check<N>(tl, k, false, pl);
  }
  if (g > 0) {  // V's update for the last round
    SMC_TEAM(N, t) {
      rotate_v(tl, k, ((g - 1) & 1) * pairs(k), pl[t].v);
    }
    smc::team_sync<N>();
  }
  const bool bad = state == 2;
  SMC_TEAM(N, t) {
    for (int i = t; i < k; i += N) tl.d[i] = tl.a[i * ld + i];
  }
  smc::team_sync<N>();
  SMC_TEAM(N, t) {
    for (int i = t; i < k; i += N) {
      int rk = 0;
      const double di = key(tl.d[i]);
      for (int j = 0; j < k; ++j) {
        const double dj = key(tl.d[j]);
        rk += (dj < di) || (dj == di && j < i);
      }
      tl.inv[bad ? i : rk] = i;
      int arg = 0;
      double big = -1.0;
      for (int row = 0; row < k; ++row) {
        const double x = fabs(tl.v[i * ld + row]);
        arg = x > big ? row : arg;
        big = x > big ? x : big;
      }
      tl.sgn[i] = tl.v[i * ld + arg] < 0.0 ? -1.0 : 1.0;
    }
  }
  smc::team_sync<N>();
  SMC_TEAM(N, t) {
    for (int i = t; i < k; i += N) lam[i] = bad ? NAN : tl.d[tl.inv[i]];
    const Slab& sl = pl[t].e;
    for (int row = sl.s0; row < k; row += sl.ds)
      for (int col = sl.f0; col < k; col += sl.df) {
        const int src = tl.inv[col];
        u[row * k + col] = bad ? NAN : tl.sgn[src] * tl.v[src * ld + row];
      }
  }
}

// One matrix, on the team its k takes.
SMC_HD inline void eigh_one(const double* a_in, double* lam, double* u,
                            int k, double* tile, double* av) {
  if (k <= kWarpK)
    eigh_team<kSmallThreads, true>(a_in, lam, u, k, tile, av);
  else if (k <= kSharedK)
    eigh_team<kBlockThreads, true>(a_in, lam, u, k, tile, av);
  else
    eigh_team<kBlockThreads, false>(a_in, lam, u, k, tile, av);
}

// A launch's matrices: up to two parts of n matrices of one k each, packed
// one after another (a and u: n k^2 doubles a part, lam n k, the workspace
// n av_doubles(k) where k > kSharedK).
struct Part {
  int k;
  long long n, blocks, a0, lam0, work0;
};

SMC_HD inline Part part(int k, long long n, long long a0, long long lam0,
                        long long work0) {
  const int per = per_block(k);
  return {k, n, (n + per - 1) / per, a0, lam0, work0};
}

// dynamic shared memory of a part's blocks
SMC_HD inline size_t part_smem(const Part& p) {
  if (p.n == 0) return 0;
  const long long per = per_block(p.k);
  return (size_t)(p.n < per ? p.n : per) * tile_bytes(p.k);
}

}  // namespace smc_jacobi
