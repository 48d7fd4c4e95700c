// Eigendecomposition of one symmetric k x k f64 matrix (1 <= k <= 1024) by
// the cyclic Jacobi method, written for one thread block per matrix. The
// matrix and the accumulated rotations live in shared memory up to
// k = kSharedK, beyond it in a global workspace of the block's own; the
// rounds' rotations, sums and ranks are in shared memory at every k.
//
// This is not the port of a TPU kernel: the JAX package runs
// jnp.linalg.eigh through XLA. It exists because torch.linalg.eigh on a CUDA
// tensor reads its status back to the host (the call waits for the device),
// so it cannot be captured in a CUDA graph; the proposal factor of the
// mutation (ops/mutation.py _deg_factor) calls it once per block per stage.
//
// Parallel Jacobi (Brent and Luk): the k indices, padded to an even m, are
// paired by the round-robin schedule, m - 1 rounds of m / 2 disjoint pairs
// per sweep. A round computes every pair's rotation (c, s) from the matrix
// as it stands, applies all of them to the columns of A and V, then to the
// rows of A, and sets each rotated pair's off-diagonal entries to zero. Every
// entry is written by one thread per phase, so the result does not depend on
// the order in which threads run. A sweep starts with the off-diagonal mass
// off = sum_{i != j} a_ij^2; the matrix has converged when
// off <= (kTol ||A||_F)^2. A matrix with a non-finite entry gives NaN
// eigenvalues and eigenvectors.
//
// Output: eigenvalues ascending (ties in their diagonal order), the
// eigenvectors as the columns of U with the sign that makes each column's
// largest-magnitude entry (the first, in row order, of equal ones)
// positive. Only the lower triangle of the input is read, as
// torch.linalg.eigh reads it. PERF.md holds the measured times.
//
// The same source runs on the card and on the host. On the card
// EIGH_THREADS(t) runs its body once with t = threadIdx.x and EIGH_SYNC() is
// __syncthreads(); under a host compiler (eigh_cpu.cpp) EIGH_THREADS(t)
// loops t over the block's kThreads threads and EIGH_SYNC() does nothing. A
// phase between two syncs reads only entries written before it, or the
// entries its own thread writes, so the host loop computes the card's bits.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define EIGH_HD __host__ __device__
#else
#define EIGH_HD
#endif

#ifdef __CUDA_ARCH__
#define EIGH_THREADS(t) \
  for (int t = (int)threadIdx.x, t##_once = 1; t##_once; t##_once = 0)
#define EIGH_SYNC() __syncthreads()
#else
#define EIGH_THREADS(t) for (int t = 0; t < smc_jacobi::kThreads; ++t)
#define EIGH_SYNC()
#endif

namespace smc_jacobi {

constexpr int kSharedK = 64;  // A and V in shared memory up to this k
constexpr int kMaxK = 1024;
constexpr int kThreads = 128;
constexpr int kMaxSweeps = 30;
constexpr double kTol = 1e-17;

// row stride of A and V: odd, so a column read by a warp touches distinct
// banks
EIGH_HD inline int stride(int k) { return k | 1; }

// doubles of A and V [k][stride] together
EIGH_HD inline size_t av_doubles(int k) { return 2 * (size_t)k * stride(k); }

// Shared memory of one block: A and V when k <= kSharedK, the round's (c, s)
// pairs (m doubles), three partial sums per thread, the diagonal; then ints:
// the sort ranks and the control word.
EIGH_HD inline size_t smem_bytes(int k) {
  const size_t m = k + (k & 1);
  return sizeof(double) *
             ((k <= kSharedK ? av_doubles(k) : 0) + m + 3 * kThreads + k) +
         sizeof(int) * (k + 2);
}

struct Shared {
  double* a;
  double* v;
  double* cs;
  double* red;
  double* d;
  int* rank;
  int* ctl;  // ctl[0]: 0 iterate, 1 converged, 2 non-finite input
};

// base: the block's shared memory of smem_bytes(k); av: the block's
// workspace of av_doubles(k) for A and V when k > kSharedK (unused below)
EIGH_HD inline Shared carve(double* base, int k, double* av) {
  Shared s;
  const size_t n = (size_t)k * stride(k);
  const bool in_shared = k <= kSharedK;
  s.a = in_shared ? base : av;
  s.v = s.a + n;
  s.cs = in_shared ? base + 2 * n : base;
  s.red = s.cs + (k + (k & 1));
  s.d = s.red + 3 * kThreads;
  s.rank = reinterpret_cast<int*>(s.d + k);
  s.ctl = s.rank + k;
  return s;
}

EIGH_HD inline bool finite(double x) { return x - x == 0.0; }

// Pair i of round r of the round-robin schedule over m (even) indices:
// (p, q) with p < q. Over rounds 0..m-2 every pair appears once.
EIGH_HD inline void pair(int r, int i, int m, int* p, int* q) {
  int x, y;
  if (i == 0) {
    x = r;
    y = m - 1;
  } else {
    x = (r + i) % (m - 1);
    y = (r - i + (m - 1)) % (m - 1);
  }
  *p = x < y ? x : y;
  *q = x < y ? y : x;
}

// Rotation zeroing a_pq of [[app, apq], [apq, aqq]] (Golub and Van Loan's
// symmetric Schur decomposition): J = [[c, s], [-s, c]] on (p, q).
EIGH_HD inline void rotation(double app, double aqq, double apq, double* c,
                             double* s) {
  if (apq == 0.0) {
    *c = 1.0;
    *s = 0.0;
    return;
  }
  const double tau = (aqq - app) / (2.0 * apq);
  const double t = (tau >= 0.0 ? 1.0 : -1.0) /
                   (fabs(tau) + sqrt(1.0 + tau * tau));
  *c = 1.0 / sqrt(1.0 + t * t);
  *s = t * *c;
}

// off-diagonal mass, total mass and non-finite count of the block's matrix,
// into ctl[0]: per-thread partial sums, then thread 0 sums them in order
EIGH_HD inline void check(Shared& sh, int k, bool first) {
  const int ld = stride(k);
  EIGH_THREADS(t) {
    double off = 0.0, tot = 0.0, bad = 0.0;
    for (int e = t; e < k * k; e += kThreads) {
      const int i = e / k, j = e % k;
      const double x = sh.a[i * ld + j];
      if (first && !finite(x)) bad += 1.0;
      tot += x * x;
      if (i != j) off += x * x;
    }
    sh.red[3 * t] = off;
    sh.red[3 * t + 1] = tot;
    sh.red[3 * t + 2] = bad;
  }
  EIGH_SYNC();
  EIGH_THREADS(t) {
    if (t == 0) {
      double off = 0.0, tot = 0.0, bad = 0.0;
      for (int u = 0; u < kThreads; ++u) {
        off += sh.red[3 * u];
        tot += sh.red[3 * u + 1];
        bad += sh.red[3 * u + 2];
      }
      sh.ctl[0] = bad > 0.0 ? 2 : (off <= kTol * kTol * tot ? 1 : 0);
    }
  }
  EIGH_SYNC();
}

// One matrix: a_in [k][k] (lower triangle read) -> lam [k], u [k][k]; smem
// and av as carve takes them.
EIGH_HD inline void eigh_block(const double* a_in, double* lam, double* u,
                               int k, double* smem, double* av) {
  Shared sh = carve(smem, k, av);
  const int ld = stride(k);
  const int m = k + (k & 1);
  EIGH_THREADS(t) {
    for (int e = t; e < k * k; e += kThreads) {
      const int i = e / k, j = e % k;
      sh.a[i * ld + j] = i >= j ? a_in[i * k + j] : a_in[j * k + i];
      sh.v[i * ld + j] = i == j ? 1.0 : 0.0;
    }
  }
  EIGH_SYNC();
  check(sh, k, true);
  for (int sweep = 0; sweep < kMaxSweeps && sh.ctl[0] == 0; ++sweep) {
    for (int r = 0; r < m - 1; ++r) {
      EIGH_THREADS(t) {
        for (int i = t; i < m / 2; i += kThreads) {
          int p, q;
          pair(r, i, m, &p, &q);
          double c = 1.0, s = 0.0;
          if (q < k)
            rotation(sh.a[p * ld + p], sh.a[q * ld + q], sh.a[p * ld + q], &c,
                     &s);
          sh.cs[2 * i] = c;
          sh.cs[2 * i + 1] = s;
        }
      }
      EIGH_SYNC();
      // columns p, q of A and V
      EIGH_THREADS(t) {
        for (int e = t; e < (m / 2) * k; e += kThreads) {
          const int i = e / k, row = e % k;
          int p, q;
          pair(r, i, m, &p, &q);
          if (q >= k) continue;
          const double c = sh.cs[2 * i], s = sh.cs[2 * i + 1];
          double x = sh.a[row * ld + p], y = sh.a[row * ld + q];
          sh.a[row * ld + p] = c * x - s * y;
          sh.a[row * ld + q] = s * x + c * y;
          x = sh.v[row * ld + p];
          y = sh.v[row * ld + q];
          sh.v[row * ld + p] = c * x - s * y;
          sh.v[row * ld + q] = s * x + c * y;
        }
      }
      EIGH_SYNC();
      // rows p, q of A; the pair's off-diagonal entries become 0
      EIGH_THREADS(t) {
        for (int e = t; e < (m / 2) * k; e += kThreads) {
          const int i = e / k, col = e % k;
          int p, q;
          pair(r, i, m, &p, &q);
          if (q >= k) continue;
          const double c = sh.cs[2 * i], s = sh.cs[2 * i + 1];
          const double x = sh.a[p * ld + col], y = sh.a[q * ld + col];
          sh.a[p * ld + col] = col == q ? 0.0 : c * x - s * y;
          sh.a[q * ld + col] = col == p ? 0.0 : s * x + c * y;
        }
      }
      EIGH_SYNC();
    }
    check(sh, k, false);
  }
  const bool bad = sh.ctl[0] == 2;
  EIGH_THREADS(t) {
    for (int i = t; i < k; i += kThreads) sh.d[i] = sh.a[i * ld + i];
  }
  EIGH_SYNC();
  EIGH_THREADS(t) {
    for (int i = t; i < k; i += kThreads) {
      int rk = 0;
      for (int j = 0; j < k; ++j)
        rk += (sh.d[j] < sh.d[i]) || (sh.d[j] == sh.d[i] && j < i);
      sh.rank[i] = bad ? i : rk;
    }
  }
  EIGH_SYNC();
  EIGH_THREADS(t) {
    for (int i = t; i < k; i += kThreads) {
      const int col = sh.rank[i];
      int arg = 0;
      double big = -1.0;
      for (int row = 0; row < k; ++row) {
        const double x = fabs(sh.v[row * ld + i]);
        if (x > big) {
          big = x;
          arg = row;
        }
      }
      const double sign = sh.v[arg * ld + i] < 0.0 ? -1.0 : 1.0;
      lam[col] = bad ? NAN : sh.d[i];
      for (int row = 0; row < k; ++row)
        u[row * k + col] = bad ? NAN : sign * sh.v[row * ld + i];
    }
  }
}

}  // namespace smc_jacobi
