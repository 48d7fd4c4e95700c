// Per-particle bodies of the two DSGE likelihood kernels, in native f64.
//
//   re_solve_particle   cyclic-reduction solve of A + B X + C X^2 = 0 with the
//                       determinacy checks (the work of the TPU kernel
//                       smc_tpu/ops/pallas_dsge.py::_re_kernel);
//   kalman_particle     Lyapunov doubling + Chandrasekhar Kalman likelihood
//                       (smc_tpu/ops/pallas_dsge.py::_kalman_kernel).
//
// One call handles one particle. Matrices are read and written batch-last:
// entry (i, j) of particle `idx` of an [r, c, N] array is p[(i*c + j)*N + idx],
// so neighbouring threads touch neighbouring addresses. Sizes are template
// parameters, so every loop over a matrix unrolls and the matrices can live in
// registers (what does not fit spills to local memory).
//
// The bodies are __host__ __device__: dsge_kernels.cu wraps them in one-thread-
// per-particle CUDA kernels, and dsge_cpu.cpp compiles the very same code with
// a host compiler into a loop over particles, so the arithmetic is testable
// without a GPU. SMC_HD expands to nothing under a host compiler.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SMC_HD __host__ __device__
#define SMC_UNROLL _Pragma("unroll")
#else
#define SMC_HD
#define SMC_UNROLL
#endif

namespace smc {

constexpr double kLog2Pi = 1.8378770664093453;
constexpr int kNObs = 3;

SMC_HD inline bool is_finite(double x) { return x - x == 0.0; }
SMC_HD inline bool is_nan(double x) { return x != x; }

template <int R, int C>
SMC_HD inline void load(const double* __restrict__ p, long long n,
                        long long idx, double (&m)[R][C]) {
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j)
      m[i][j] = p[(long long)(i * C + j) * n + idx];
}

template <int R, int C>
SMC_HD inline void store(double* __restrict__ p, long long n, long long idx,
                         const double (&m)[R][C], bool keep) {
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j)
      p[(long long)(i * C + j) * n + idx] = keep ? m[i][j] : 0.0;
}

template <int R, int C>
SMC_HD inline void copy(const double (&a)[R][C], double (&out)[R][C]) {
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j) out[i][j] = a[i][j];
}

// out = a @ b
template <int R, int K, int C>
SMC_HD inline void matmul(const double (&a)[R][K], const double (&b)[K][C],
                          double (&out)[R][C]) {
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j) {
      double acc = a[i][0] * b[0][j];
      SMC_UNROLL for (int k = 1; k < K; ++k) acc += a[i][k] * b[k][j];
      out[i][j] = acc;
    }
}

// out = a @ b'
template <int R, int K, int C>
SMC_HD inline void matmul_bt(const double (&a)[R][K], const double (&b)[C][K],
                             double (&out)[R][C]) {
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j) {
      double acc = a[i][0] * b[j][0];
      SMC_UNROLL for (int k = 1; k < K; ++k) acc += a[i][k] * b[j][k];
      out[i][j] = acc;
    }
}

// a <- 0.5 (a + a')
template <int N>
SMC_HD inline void symmetrize(double (&a)[N][N]) {
  SMC_UNROLL for (int i = 0; i < N; ++i)
    SMC_UNROLL for (int j = i + 1; j < N; ++j) {
      double s = 0.5 * (a[i][j] + a[j][i]);
      a[i][j] = s;
      a[j][i] = s;
    }
}

// In-place Gauss-Jordan with partial pivoting on w = [A | B] (N x N+M):
// afterwards w[:, N:] holds A^{-1} B. The pivot is the first maximal |entry|
// at or below the diagonal (the rule of ops/linalg.py bl_gj_solve). The row
// swap is written as selects so the unrolled arrays stay in registers.
template <int N, int M>
SMC_HD inline void gj_solve(double (&w)[N][N + M]) {
  SMC_UNROLL for (int k = 0; k < N; ++k) {
    int p = k;
    double best = fabs(w[k][k]);
    SMC_UNROLL for (int i = k + 1; i < N; ++i) {
      double a = fabs(w[i][k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
    SMC_UNROLL for (int i = k + 1; i < N; ++i) {
      bool s = (i == p);
      SMC_UNROLL for (int j = k; j < N + M; ++j) {
        double rk = w[k][j], ri = w[i][j];
        w[k][j] = s ? ri : rk;
        w[i][j] = s ? rk : ri;
      }
    }
    double inv = 1.0 / w[k][k];
    SMC_UNROLL for (int j = k + 1; j < N + M; ++j) w[k][j] *= inv;
    SMC_UNROLL for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      double f = w[i][k];
      SMC_UNROLL for (int j = k + 1; j < N + M; ++j) w[i][j] -= f * w[k][j];
    }
  }
}

// rho(m) < 1 by the bound ||m^(2^12)||_F^(1/2^12) with renormalized repeated
// squaring, in f64 (models/dsge.py bl_spectral_radius_bound). Destroys m.
template <int N>
SMC_HD inline bool spectral_bound_below_one(double (&m)[N][N]) {
  double log_scale = 0.0;
  for (int it = 0; it < 12; ++it) {
    double sq = 0.0;
    SMC_UNROLL for (int i = 0; i < N; ++i)
      SMC_UNROLL for (int j = 0; j < N; ++j) sq += m[i][j] * m[i][j];
    double nrm = sqrt(sq) + 1e-300;
    SMC_UNROLL for (int i = 0; i < N; ++i)
      SMC_UNROLL for (int j = 0; j < N; ++j) m[i][j] = m[i][j] / nrm;
    double t[N][N];
    matmul(m, m, t);
    copy(t, m);
    log_scale = 2.0 * (log_scale + log(nrm));
  }
  double sq = 0.0;
  SMC_UNROLL for (int i = 0; i < N; ++i)
    SMC_UNROLL for (int j = 0; j < N; ++j) sq += m[i][j] * m[i][j];
  double total = log_scale + log(sqrt(sq) + 1e-300);
  return exp(total / 4096.0) < 1.0;
}

// Cyclic reduction for one particle. Writes X [NS,NS], M [NS,NK] (zero where
// not ok) and ok. Exits once max(|A0|,|A2|) <= 2^-27 * scale, scale =
// max(max|A|,|B|,|C|, 1) of this particle (0 if any entry is not finite):
// the iteration is quadratic, so the next update to A1/Ah would be below f64
// resolution. A NaN in A0/A2 never triggers the exit.
template <int NS, int NK>
SMC_HD void re_solve_particle(const double* __restrict__ A,
                              const double* __restrict__ B,
                              const double* __restrict__ C,
                              const double* __restrict__ D,
                              double* __restrict__ X, double* __restrict__ M,
                              unsigned char* __restrict__ ok_out, long long n,
                              long long idx, int n_iter, double tol) {
  double a0[NS][NS], a1[NS][NS], a2[NS][NS], ah[NS][NS];
  load(A, n, idx, a0);
  load(B, n, idx, a1);
  load(C, n, idx, a2);
  copy(a1, ah);

  double scale = 0.0;
  bool all_finite = true;
  SMC_UNROLL for (int i = 0; i < NS; ++i)
    SMC_UNROLL for (int j = 0; j < NS; ++j) {
      scale = fmax(scale, fmax(fabs(a0[i][j]), fmax(fabs(a1[i][j]),
                                                    fabs(a2[i][j]))));
      all_finite = all_finite && is_finite(a0[i][j]) && is_finite(a1[i][j]) &&
                   is_finite(a2[i][j]);
    }
  if (!all_finite) scale = 0.0;
  const double tol_exit = fmax(scale, 1.0) * 0x1p-27;

  for (int it = 0; it < n_iter; ++it) {
    double mx = 0.0;
    bool any_nan = false;
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        mx = fmax(mx, fmax(fabs(a0[i][j]), fabs(a2[i][j])));
        any_nan = any_nan || is_nan(a0[i][j]) || is_nan(a2[i][j]);
      }
    if (!any_nan && mx <= tol_exit) break;

    double w[NS][3 * NS];
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        w[i][j] = a1[i][j];
        w[i][NS + j] = a0[i][j];
        w[i][2 * NS + j] = a2[i][j];
      }
    gj_solve<NS, 2 * NS>(w);
    double sa0[NS][NS], sa2[NS][NS];
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        sa0[i][j] = w[i][NS + j];
        sa2[i][j] = w[i][2 * NS + j];
      }
    double a2sa0[NS][NS], t[NS][NS];
    matmul(a2, sa0, a2sa0);
    matmul(a0, sa2, t);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        ah[i][j] -= a2sa0[i][j];
        a1[i][j] = (a1[i][j] - t[i][j]) - a2sa0[i][j];
      }
    matmul(a0, sa0, t);
    copy(t, a0);
    matmul(a2, sa2, t);
    copy(t, a2);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        a0[i][j] = -a0[i][j];
        a2[i][j] = -a2[i][j];
      }
  }

  // X = -Ah^{-1} A   (a0 now holds the original A again)
  double x[NS][NS];
  {
    load(A, n, idx, a0);
    double w[NS][2 * NS];
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        w[i][j] = ah[i][j];
        w[i][NS + j] = a0[i][j];
      }
    gj_solve<NS, NS>(w);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) x[i][j] = -w[i][NS + j];
  }

  // one augmented solve (B + C X)^{-1} [D | C] gives M and the forward
  // operator Fwd = -(B + C X)^{-1} C
  load(B, n, idx, a1);
  load(C, n, idx, a2);
  double m[NS][NK], fwd[NS][NS];
  {
    double cx[NS][NS], d[NS][NK];
    matmul(a2, x, cx);
    load(D, n, idx, d);
    double w[NS][2 * NS + NK];
    SMC_UNROLL for (int i = 0; i < NS; ++i) {
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        w[i][j] = a1[i][j] + cx[i][j];
        w[i][NS + NK + j] = a2[i][j];
      }
      SMC_UNROLL for (int j = 0; j < NK; ++j) w[i][NS + j] = d[i][j];
    }
    gj_solve<NS, NS + NK>(w);
    SMC_UNROLL for (int i = 0; i < NS; ++i) {
      SMC_UNROLL for (int j = 0; j < NK; ++j) m[i][j] = -w[i][NS + j];
      SMC_UNROLL for (int j = 0; j < NS; ++j) fwd[i][j] = -w[i][NS + NK + j];
    }
  }

  // residual A + B X + C (X X) against tol * max(max|A|, 1)
  bool converged = true;
  {
    double xx[NS][NS], cxx[NS][NS], bx[NS][NS];
    matmul(x, x, xx);
    matmul(a2, xx, cxx);
    matmul(a1, x, bx);
    double max_a = 0.0;
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) max_a = fmax(max_a, fabs(a0[i][j]));
    const double thr = tol * fmax(max_a, 1.0);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        double r = (a0[i][j] + bx[i][j]) + cxx[i][j];
        converged = converged && (fabs(r) < thr);
      }
  }

  bool finite = true;
  SMC_UNROLL for (int i = 0; i < NS; ++i) {
    SMC_UNROLL for (int j = 0; j < NS; ++j) finite = finite && is_finite(x[i][j]);
    SMC_UNROLL for (int j = 0; j < NK; ++j) finite = finite && is_finite(m[i][j]);
  }
  bool ok = converged && finite;
  if (ok) {
    double xs[NS][NS];
    copy(x, xs);
    ok = spectral_bound_below_one(xs) && spectral_bound_below_one(fwd);
  }
  store(X, n, idx, x, ok);
  store(M, n, idx, m, ok);
  ok_out[idx] = ok ? 1 : 0;
}

// X B for symmetric 3x3 F by the adjugate: X = adj(F) B / det(F). Returns det.
template <int M>
SMC_HD inline double cofactor_solve3(const double (&F)[3][3],
                                     const double (&B)[3][M],
                                     double (&X)[3][M]) {
  const double a = F[0][0], b = F[0][1], c = F[0][2];
  const double d = F[1][1], e = F[1][2], f = F[2][2];
  const double c00 = d * f - e * e, c01 = c * e - b * f, c02 = b * e - c * d;
  const double c11 = a * f - c * c, c12 = b * c - a * e, c22 = a * d - b * b;
  const double det = a * c00 + b * c01 + c * c02;
  const double inv = 1.0 / det;
  SMC_UNROLL for (int j = 0; j < M; ++j) {
    const double b0 = B[0][j], b1 = B[1][j], b2 = B[2][j];
    X[0][j] = (c00 * b0 + c01 * b1 + c02 * b2) * inv;
    X[1][j] = (c01 * b0 + c11 * b1 + c12 * b2) * inv;
    X[2][j] = (c02 * b0 + c12 * b1 + c22 * b2) * inv;
  }
  return det;
}

// Chandrasekhar Kalman log-likelihood of one particle (n_obs = 3):
// T [NS,NS], R [NS,NK], Q [NK,NK], Z [3,NS], d [3], H [3,3] batch-last;
// ys [3, n_t] row-major, shared by every particle. Returns the log-likelihood
// or -inf when a guard fires: det F <= 0, v'F^-1 v < 0, diag(F) <= 0, or
// trace(F) above trace(F1)(1 + 1e-6) + 1e-12. The Lyapunov doubling exits
// once max|A_k| <= 1e-20 (a NaN never triggers the exit).
template <int NS, int NK>
SMC_HD double kalman_particle(const double* __restrict__ T,
                              const double* __restrict__ R,
                              const double* __restrict__ Q,
                              const double* __restrict__ Z,
                              const double* __restrict__ dv,
                              const double* __restrict__ H,
                              const double* ys, int n_t, long long n,
                              long long idx, int lyap_iter) {
  constexpr int NO = kNObs;
  double tm[NS][NS];
  load(T, n, idx, tm);

  // P0 = stationary covariance: P = T P T' + R Q R' by doubling
  double p[NS][NS];
  {
    double r[NS][NK], q[NK][NK], rq[NS][NK];
    load(R, n, idx, r);
    load(Q, n, idx, q);
    matmul(r, q, rq);
    matmul_bt(rq, r, p);
    double ak[NS][NS];
    copy(tm, ak);
    for (int it = 0; it < lyap_iter; ++it) {
      double mx = 0.0;
      bool any_nan = false;
      SMC_UNROLL for (int i = 0; i < NS; ++i)
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          mx = fmax(mx, fabs(ak[i][j]));
          any_nan = any_nan || is_nan(ak[i][j]);
        }
      if (!any_nan && mx <= 1e-20) break;
      double pa[NS][NS], apa[NS][NS];
      matmul_bt(p, ak, pa);
      matmul(ak, pa, apa);
      SMC_UNROLL for (int i = 0; i < NS; ++i)
        SMC_UNROLL for (int j = 0; j < NS; ++j) p[i][j] += apa[i][j];
      matmul(ak, ak, pa);
      copy(pa, ak);
    }
  }

  double z[NO][NS], d[NO];
  load(Z, n, idx, z);
  SMC_UNROLL for (int o = 0; o < NO; ++o) d[o] = dv[(long long)o * n + idx];

  double F[NO][NO], K[NS][NO], W[NS][NO], Mm[NO][NO];
  {
    double h[NO][NO], pzt[NS][NO];
    load(H, n, idx, h);
    matmul_bt(p, z, pzt);
    matmul(z, pzt, F);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) F[i][j] += h[i][j];
    symmetrize(F);
    matmul(tm, pzt, K);
    double eye[NO][NO], finv[NO][NO];
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) eye[i][j] = (i == j) ? 1.0 : 0.0;
    cofactor_solve3(F, eye, finv);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) Mm[i][j] = -finv[i][j];
    symmetrize(Mm);
    copy(K, W);
  }
  const double tr_cap = (F[0][0] + F[1][1] + F[2][2]) * (1.0 + 1e-6) + 1e-12;

  double s[NS];
  SMC_UNROLL for (int i = 0; i < NS; ++i) s[i] = 0.0;
  bool bad = false;
  double total = 0.0;
  for (int t = 0; t < n_t; ++t) {
    double zw[NO][NO];
    matmul(z, W, zw);
    double rhs[NO][1 + NO], sol[NO][1 + NO];
    SMC_UNROLL for (int o = 0; o < NO; ++o) {
      double zs = z[o][0] * s[0];
      SMC_UNROLL for (int j = 1; j < NS; ++j) zs += z[o][j] * s[j];
      rhs[o][0] = (ys[o * n_t + t] - d[o]) - zs;
      SMC_UNROLL for (int j = 0; j < NO; ++j) rhs[o][1 + j] = zw[o][j];
    }
    const double det = cofactor_solve3(F, rhs, sol);
    double quad = rhs[0][0] * sol[0][0];
    SMC_UNROLL for (int o = 1; o < NO; ++o) quad += rhs[o][0] * sol[o][0];
    total += -0.5 * (NO * kLog2Pi + log(det) + quad);

    double s_new[NS];
    SMC_UNROLL for (int i = 0; i < NS; ++i) {
      double ts = tm[i][0] * s[0];
      SMC_UNROLL for (int j = 1; j < NS; ++j) ts += tm[i][j] * s[j];
      double kf = K[i][0] * sol[0][0];
      SMC_UNROLL for (int o = 1; o < NO; ++o) kf += K[i][o] * sol[o][0];
      s_new[i] = ts + kf;
    }
    SMC_UNROLL for (int i = 0; i < NS; ++i) s[i] = s_new[i];

    double mwtzt[NO][NO], wmwtzt[NS][NO];
    matmul_bt(Mm, zw, mwtzt);                 // M W'Z'
    matmul(W, mwtzt, wmwtzt);                 // W M W'Z'
    // W <- T W - K F^{-1} Z W, with the K and W of this step
    double wn[NS][NO], tmp[NS][NO];
    matmul(tm, W, wn);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int o = 0; o < NO; ++o) {
        double kf = K[i][0] * sol[0][1 + o];
        SMC_UNROLL for (int j = 1; j < NO; ++j) kf += K[i][j] * sol[j][1 + o];
        wn[i][o] -= kf;
      }
    // K <- K + T W M W'Z' ;  F <- sym(F + Z W M W'Z')
    matmul(tm, wmwtzt, tmp);
    SMC_UNROLL for (int i = 0; i < NS; ++i)
      SMC_UNROLL for (int o = 0; o < NO; ++o) K[i][o] += tmp[i][o];
    double zwm[NO][NO];
    matmul(z, wmwtzt, zwm);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) F[i][j] += zwm[i][j];
    symmetrize(F);
    // M <- sym(M - M W'Z' F_new^{-1} Z W M)
    double fzw[NO][NO], fzwm[NO][NO], upd[NO][NO];
    cofactor_solve3(F, zw, fzw);
    matmul(fzw, Mm, fzwm);
    matmul(mwtzt, fzwm, upd);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) Mm[i][j] -= upd[i][j];
    symmetrize(Mm);
    copy(wn, W);

    bad = bad || !(det > 0.0) || quad < 0.0 || F[0][0] <= 0.0 ||
          F[1][1] <= 0.0 || F[2][2] <= 0.0 ||
          (F[0][0] + F[1][1] + F[2][2]) > tr_cap;
  }
  return bad || !is_finite(total) ? -(double)INFINITY : total;
}

}  // namespace smc
