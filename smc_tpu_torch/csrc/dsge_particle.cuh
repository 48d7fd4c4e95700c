// Bodies of the two DSGE likelihood kernels, in native f64, written for a
// group of G lanes per particle:
//
//   re_solve_warp   cyclic-reduction solve of A + B X + C X^2 = 0 with the
//                   determinacy checks (the work of the TPU kernel
//                   smc_tpu/ops/pallas_dsge.py::_re_kernel);
//   kalman_warp     Lyapunov doubling + Chandrasekhar Kalman likelihood
//                   (smc_tpu/ops/pallas_dsge.py::_kalman_kernel).
//
// One call handles one warp: 32 lanes, 32 / G particles. Lane l serves
// particle warp * (32 / G) + l / G; its place r = l % G in the group gives it
// the matrix rows i = r, r + G, r + 2G, ... below NS (rows from NS up are
// padding: they take part in every exchange and are never stored). A product
// out = a b is computed row by row: each lane its own rows of a, reading every
// row of b from the group's tile in shared memory, written by the lanes that
// own them. Cross-row decisions (pivot choice, exit tests, norms) are read
// back from the tile in row order by every lane of the group, so the whole
// group takes the same branch.
//
// Matrices are read and written batch-last: entry (i, j) of particle idx of
// an [r, c, N] array is p[(i*c + j)*N + idx]; the 32 / G particles of a warp
// are neighbours, so one load of row i fills whole 32-byte sectors.
//
// The same source runs on the card and on the host (lanes.cuh): on the card
// SMC_LANES(l) runs its body once with l = the lane, Lanes<T> is the lane's
// own T, smc_sync() is __syncwarp() and warp_any is __any_sync; under a host
// compiler (dsge_cpu.cpp) SMC_LANES(l) loops over the 32 lanes phase by
// phase. Code between two smc_sync() calls reads only tile entries written
// before the first of them, and writes only entries that no lane reads in
// that phase (or its own).
#pragma once

#include <math.h>
#include <stdint.h>

#include "lanes.cuh"

namespace smc {

constexpr double kLog2Pi = 1.8378770664093453;
constexpr int kNObs = 3;
// Lanes per particle of each kernel. The RE solve holds one matrix row per
// lane at 8 (no spills, 4 particles per warp). The Kalman filter repeats its
// 3x3 work (F, M, the innovation solves) on every lane of a group, so it
// takes the fewest lanes that still double the warps of one thread per
// particle. PERF.md holds the measurements behind both.
constexpr int kReLanes = 8;
constexpr int kKalmanLanes = 2;

SMC_HD inline bool is_finite(double x) { return x - x == 0.0; }
SMC_HD inline bool is_nan(double x) { return x != x; }

// Group geometry: G lanes per particle, RPL rows per lane, kPerWarp
// particles per warp.
template <int NS, int G>
struct Group {
  static_assert(G == 2 || G == 4 || G == 8, "G must be 2, 4 or 8");
  static_assert(NS <= 8 && NS >= 1, "NS must be 1..8");
  static constexpr int RPL = (NS + G - 1) / G;
  static constexpr int kPerWarp = kWarp / G;
  // the particle of lane l of warp `warp`
  SMC_HD static long long particle(long long warp, int l) {
    return warp * kPerWarp + l / G;
  }
  // tile of one group: mat [NS][WT], piv [WT], red [kRed][NS]. WT is even
  // and the stride is 2 mod 16 doubles, so rows are 16-byte aligned for
  // pair loads and the groups of a warp start 4 banks apart
  template <int WT, int kRed>
  static constexpr int stride() { return pad(NS * WT + WT + kRed * NS); }
  static constexpr int pad(int used) { return (used + 13) / 16 * 16 + 2; }
};

constexpr int even(int x) { return (x + 1) / 2 * 2; }

// Two neighbouring doubles of the tile (16-byte aligned) in one load. The
// card faults on a misaligned 16-byte load; the host build counts them
// instead (misaligned_loads), so the CPU tests catch a layout that would.
struct D2 {
  double x, y;
};
#ifndef __CUDA_ARCH__
inline int& misaligned_loads() {
  static thread_local int count = 0;
  return count;
}
#endif
SMC_HD inline D2 ld2(const double* p) {
#ifdef __CUDA_ARCH__
  const double2 v = *reinterpret_cast<const double2*>(p);
  return {v.x, v.y};
#else
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) ++misaligned_loads();
  return {p[0], p[1]};
#endif
}

// Rows r + G q of a batch-last [R, C, n] array into rows[q][.]; zero for
// padding rows and for particles past n.
template <int R, int C, int G, int RPL, int W>
SMC_HD inline void load_rows(const double* __restrict__ p, long long n,
                             long long idx, int r, double (&rows)[RPL][W],
                             int col0 = 0) {
  const bool valid = idx < n;
  SMC_UNROLL for (int q = 0; q < RPL; ++q) {
    const int i = r + G * q;
    SMC_UNROLL for (int j = 0; j < C; ++j)
      rows[q][col0 + j] =
          (valid && i < R) ? p[(long long)(i * C + j) * n + idx] : 0.0;
  }
}

template <int R, int C, int G, int RPL, int W>
SMC_HD inline void store_rows(double* __restrict__ p, long long n,
                              long long idx, int r,
                              const double (&rows)[RPL][W], bool keep,
                              int col0 = 0) {
  if (idx >= n) return;
  SMC_UNROLL for (int q = 0; q < RPL; ++q) {
    const int i = r + G * q;
    if (i < R)
      SMC_UNROLL for (int j = 0; j < C; ++j)
        p[(long long)(i * C + j) * n + idx] = keep ? rows[q][col0 + j] : 0.0;
  }
}

// A whole small matrix, read by every lane (for the Kalman's 3x3 and 3xNS
// inputs); zero past n.
template <int R, int C>
SMC_HD inline void load_all(const double* __restrict__ p, long long n,
                            long long idx, double (&m)[R][C]) {
  const bool valid = idx < n;
  SMC_UNROLL for (int i = 0; i < R; ++i)
    SMC_UNROLL for (int j = 0; j < C; ++j)
      m[i][j] = valid ? p[(long long)(i * C + j) * n + idx] : 0.0;
}

// out[j] = sum_k a[k] b[k][COL0 + j], k = 0..K-1 in order, with b the tile's
// mat (row stride ld, even, and rows 16-byte aligned). Where COL0 is even,
// pairs of columns are read with one 16-byte load; an odd COL0 (n_state 3)
// reads single doubles, which need only 8-byte alignment.
template <int K, int C, int COL0>
SMC_HD inline void row_times_tile(const double* a, const double* b, int ld,
                                  double* out) {
  constexpr int kPairs = (COL0 % 2 == 0) ? C / 2 : 0;
  SMC_UNROLL for (int k = 0; k < K; ++k) {
    const double* bk = b + k * ld + COL0;
    SMC_UNROLL for (int j = 0; j < 2 * kPairs; j += 2) {
      const D2 v = ld2(bk + j);
      out[j] = (k == 0) ? a[0] * v.x : out[j] + a[k] * v.x;
      out[j + 1] = (k == 0) ? a[0] * v.y : out[j + 1] + a[k] * v.y;
    }
    SMC_UNROLL for (int j = 2 * kPairs; j < C; ++j)
      out[j] = (k == 0) ? a[0] * bk[j] : out[j] + a[k] * bk[j];
  }
}

// Gauss-Jordan with partial pivoting on the group's [A | B] (NS x W), rows
// held as w[q] by their lanes, A in columns 0..NS-1. The pivot is the first
// maximal |entry| at or below the diagonal in the current row order (the rule
// of ops/linalg.py bl_gj_solve): pos[q] is the current position of row q, a
// row swap only exchanges two positions, and the pivot row is broadcast
// through the tile's piv. On return the tile's mat row k, columns NS..W-1,
// holds row k of A^{-1} B (written by the row whose final position is k), and
// the group has synced.
template <int NS, int G, int W>
SMC_HD inline void gj_solve_group(Lanes<double[Group<NS, G>::RPL][W]>& w,
                                  double* tile, int stride, int ld_mat) {
  constexpr int RPL = Group<NS, G>::RPL;
  const int o_piv = NS * ld_mat, o_red = o_piv + ld_mat;
  Lanes<int[RPL]> pos;
  SMC_LANES(l) {
    SMC_UNROLL for (int q = 0; q < RPL; ++q) pos[l][q] = l % G + G * q;
  }
  SMC_UNROLL for (int k = 0; k < NS; ++k) {
    SMC_LANES(l) {
      double* t = tile + (l / G) * stride;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = pos[l][q];
        if (i < NS && i >= k) t[o_red + i] = fabs(w[l][q][k]);
      }
    }
    smc_sync();
    SMC_LANES(l) {
      double* t = tile + (l / G) * stride;
      int p = k;
      double best = t[o_red + k];
      SMC_UNROLL for (int i = k + 1; i < NS; ++i) {
        const double a = t[o_red + i];
        if (a > best) {
          best = a;
          p = i;
        }
      }
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = pos[l][q];
        if (i == p) {
          const double inv = 1.0 / w[l][q][k];
          SMC_UNROLL for (int j = k + 1; j < W; ++j) {
            w[l][q][j] *= inv;
            t[o_piv + j] = w[l][q][j];
          }
        }
        pos[l][q] = (i == p) ? k : ((i == k) ? p : i);
      }
    }
    smc_sync();
    SMC_LANES(l) {
      const double* t = tile + (l / G) * stride;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        if (pos[l][q] != k) {
          const double f = w[l][q][k];
          SMC_UNROLL for (int j = k + 1; j < W; ++j)
            w[l][q][j] -= f * t[o_piv + j];
        }
      }
    }
  }
  SMC_LANES(l) {
    double* t = tile + (l / G) * stride;
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = pos[l][q];
      if (i < NS)
        SMC_UNROLL for (int j = NS; j < W; ++j) t[i * ld_mat + j] = w[l][q][j];
    }
  }
  smc_sync();
}

// Sum over the group's rows, in row order, of one value per row written at
// red[i]: every lane gets the same total.
template <int NS>
SMC_HD inline double sum_rows(const double* red) {
  double s = red[0];
  SMC_UNROLL for (int i = 1; i < NS; ++i) s += red[i];
  return s;
}

// rho(m) < 1 for two matrices at once, by the bound ||m^(2^12)||_F^(1/2^12)
// with renormalized repeated squaring, in f64 (models/dsge.py
// bl_spectral_radius_bound). m1, m2 are the lanes' rows and are destroyed;
// the Frobenius sums are taken row by row, then over the rows in order. The
// rows are scaled by 1/||m|| rather than divided by ||m|| (within a rounding
// of the division): entries that decay towards f64's smallest numbers would
// send every division down the card's slow division path.
// Uses mat columns 0..2NS-1 and red rows 1 and 2 of the tile.
template <int NS, int G>
SMC_HD inline void spectral_bounds_group(
    Lanes<double[Group<NS, G>::RPL][NS]>& m1,
    Lanes<double[Group<NS, G>::RPL][NS]>& m2, Lanes<bool>& below1,
    Lanes<bool>& below2, double* tile, int stride, int ld_mat) {
  constexpr int RPL = Group<NS, G>::RPL;
  const int o_red = NS * ld_mat + ld_mat;
  Lanes<double> ls1, ls2;
  SMC_LANES(l) { ls1[l] = 0.0; ls2[l] = 0.0; }
  for (int it = 0; it <= 12; ++it) {
    SMC_LANES(l) {
      double* t = tile + (l / G) * stride;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        double s1 = 0.0, s2 = 0.0;
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          s1 += m1[l][q][j] * m1[l][q][j];
          s2 += m2[l][q][j] * m2[l][q][j];
        }
        if (i < NS) {
          t[o_red + NS + i] = s1;
          t[o_red + 2 * NS + i] = s2;
        }
      }
    }
    smc_sync();
    if (it == 12) break;
    SMC_LANES(l) {
      double* t = tile + (l / G) * stride;
      const double n1 = sqrt(sum_rows<NS>(t + o_red + NS)) + 1e-300;
      const double n2 = sqrt(sum_rows<NS>(t + o_red + 2 * NS)) + 1e-300;
      ls1[l] = 2.0 * (ls1[l] + log(n1));
      ls2[l] = 2.0 * (ls2[l] + log(n2));
      const double inv1 = 1.0 / n1, inv2 = 1.0 / n2;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          m1[l][q][j] *= inv1;
          m2[l][q][j] *= inv2;
        }
        if (i < NS)
          SMC_UNROLL for (int j = 0; j < NS; ++j) {
            t[i * ld_mat + j] = m1[l][q][j];
            t[i * ld_mat + NS + j] = m2[l][q][j];
          }
      }
    }
    smc_sync();
    SMC_LANES(l) {
      const double* t = tile + (l / G) * stride;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        double r1[NS], r2[NS];
        row_times_tile<NS, NS, 0>(m1[l][q], t, ld_mat, r1);
        row_times_tile<NS, NS, NS>(m2[l][q], t, ld_mat, r2);
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          m1[l][q][j] = r1[j];
          m2[l][q][j] = r2[j];
        }
      }
    }
    smc_sync();
  }
  SMC_LANES(l) {
    const double* t = tile + (l / G) * stride;
    const double t1 = ls1[l] + log(sqrt(sum_rows<NS>(t + o_red + NS)) + 1e-300);
    const double t2 =
        ls2[l] + log(sqrt(sum_rows<NS>(t + o_red + 2 * NS)) + 1e-300);
    below1[l] = exp(t1 / 4096.0) < 1.0;
    below2[l] = exp(t2 / 4096.0) < 1.0;
  }
  smc_sync();
}

// Each row's part of the cyclic-reduction exit test, max(|A0|, |A2|) over
// the row (NaN if the row holds one), to red[i].
template <int NS, int G, int RPL>
SMC_HD inline void exit_test_rows(const double (&a0)[RPL][NS],
                                  const double (&a2)[RPL][NS], int r,
                                  double* red) {
  SMC_UNROLL for (int q = 0; q < RPL; ++q) {
    const int i = r + G * q;
    double mx = 0.0;
    bool any_nan = false;
    SMC_UNROLL for (int j = 0; j < NS; ++j) {
      mx = fmax(mx, fmax(fabs(a0[q][j]), fabs(a2[q][j])));
      any_nan = any_nan || is_nan(a0[q][j]) || is_nan(a2[q][j]);
    }
    if (i < NS) red[i] = any_nan ? NAN : mx;
  }
}

// The RE tile: mat [NS][3 NS], piv [3 NS], red [3][NS].
template <int NS, int G>
struct ReTile {
  static constexpr int kLd = even(3 * NS);
  static constexpr int kStride = Group<NS, G>::template stride<kLd, 3>();
  static constexpr int kWarpDoubles = kStride * Group<NS, G>::kPerWarp;
};

// Cyclic reduction for the 32 / G particles of warp `warp`. Writes X
// [NS,NS], M [NS,NK] (zero where not ok) and ok. A particle leaves the
// iteration once max(|A0|,|A2|) <= 2^-27 * scale, scale = max(max|A|,|B|,|C|,
// 1) of this particle (0 if any entry is not finite): the iteration is
// quadratic, so the next update to A1/Ah would be below f64 resolution. A NaN
// in A0/A2 never triggers the exit. The warp iterates while any of its
// particles has not left; a particle that has left keeps its values (its
// updates are discarded), so its result is that of its own exit.
template <int NS, int NK, int G>
SMC_HD void re_solve_warp(const double* __restrict__ A,
                          const double* __restrict__ B,
                          const double* __restrict__ C,
                          const double* __restrict__ D,
                          double* __restrict__ X, double* __restrict__ M,
                          unsigned char* __restrict__ ok_out, long long n,
                          long long warp, int n_iter, double tol,
                          double* tile) {
  using Gr = Group<NS, G>;
  constexpr int RPL = Gr::RPL;
  constexpr int LD = ReTile<NS, G>::kLd;
  constexpr int ST = ReTile<NS, G>::kStride;
  constexpr int O_RED = NS * LD + LD;

  Lanes<double[RPL][NS]> a0, a1, a2, ah;
  Lanes<bool> done;
  Lanes<double> tol_exit;
  SMC_LANES(l) {
    const long long idx = Gr::particle(warp, l);
    const int r = l % G;
    double* t = tile + (l / G) * ST;
    load_rows<NS, NS, G>(A, n, idx, r, a0[l]);
    load_rows<NS, NS, G>(B, n, idx, r, a1[l]);
    load_rows<NS, NS, G>(C, n, idx, r, a2[l]);
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = r + G * q;
      double s = 0.0;
      bool fin = true;
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        ah[l][q][j] = a1[l][q][j];
        s = fmax(s, fmax(fabs(a0[l][q][j]),
                         fmax(fabs(a1[l][q][j]), fabs(a2[l][q][j]))));
        fin = fin && is_finite(a0[l][q][j]) && is_finite(a1[l][q][j]) &&
              is_finite(a2[l][q][j]);
      }
      if (i < NS) t[O_RED + i] = fin ? s : -1.0;
    }
    exit_test_rows<NS, G>(a0[l], a2[l], l % G, t + O_RED + NS);
    done[l] = false;
  }
  smc_sync();
  SMC_LANES(l) {
    const double* t = tile + (l / G) * ST;
    double scale = 0.0;
    bool all_finite = true;
    SMC_UNROLL for (int i = 0; i < NS; ++i) {
      scale = fmax(scale, t[O_RED + i]);
      all_finite = all_finite && t[O_RED + i] >= 0.0;
    }
    if (!all_finite) scale = 0.0;
    tol_exit[l] = fmax(scale, 1.0) * 0x1p-27;
  }
  smc_sync();

  Lanes<double[RPL][3 * NS]> w;
  for (int it = 0; it < n_iter; ++it) {
    // exit test on the rows' max(|A0|, |A2|), written to red row 1 by the
    // phase that made A0 and A2
    Lanes<bool> running;
    SMC_LANES(l) {
      const double* t = tile + (l / G) * ST;
      double mx = 0.0;
      bool any_nan = false;
      SMC_UNROLL for (int i = 0; i < NS; ++i) {
        mx = fmax(mx, t[O_RED + NS + i]);
        any_nan = any_nan || is_nan(t[O_RED + NS + i]);
      }
      done[l] = done[l] || (!any_nan && mx <= tol_exit[l]);
      running[l] = !done[l];
    }
    if (!warp_any(running)) break;

    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < RPL; ++q)
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          w[l][q][j] = a1[l][q][j];
          w[l][q][NS + j] = a0[l][q][j];
          w[l][q][2 * NS + j] = a2[l][q][j];
        }
    }
    gj_solve_group<NS, G, 3 * NS>(w, tile, ST, LD);
    // mat columns NS..2NS-1 hold SA0 = A1^{-1} A0, 2NS..3NS-1 SA2
    SMC_LANES(l) {
      const double* t = tile + (l / G) * ST;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        double a2sa0[NS], a0sa2[NS], a0sa0[NS], a2sa2[NS];
        row_times_tile<NS, NS, NS>(a2[l][q], t, LD, a2sa0);
        row_times_tile<NS, NS, 2 * NS>(a0[l][q], t, LD, a0sa2);
        row_times_tile<NS, NS, NS>(a0[l][q], t, LD, a0sa0);
        row_times_tile<NS, NS, 2 * NS>(a2[l][q], t, LD, a2sa2);
        const bool keep = done[l];
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          ah[l][q][j] = keep ? ah[l][q][j] : ah[l][q][j] - a2sa0[j];
          a1[l][q][j] =
              keep ? a1[l][q][j] : (a1[l][q][j] - a0sa2[j]) - a2sa0[j];
          a0[l][q][j] = keep ? a0[l][q][j] : -a0sa0[j];
          a2[l][q][j] = keep ? a2[l][q][j] : -a2sa2[j];
        }
      }
      exit_test_rows<NS, G>(a0[l], a2[l], l % G,
                            tile + (l / G) * ST + O_RED + NS);
    }
    smc_sync();
  }

  // X = -Ah^{-1} A   (a0 holds the original A again)
  Lanes<double[RPL][NS]> x;
  {
    Lanes<double[RPL][2 * NS]> w2;
    SMC_LANES(l) {
      load_rows<NS, NS, G>(A, n, Gr::particle(warp, l), l % G, a0[l]);
      SMC_UNROLL for (int q = 0; q < RPL; ++q)
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          w2[l][q][j] = ah[l][q][j];
          w2[l][q][NS + j] = a0[l][q][j];
        }
    }
    gj_solve_group<NS, G, 2 * NS>(w2, tile, ST, LD);
    // each lane negates its own rows in place: mat columns 0..NS-1 then hold X
    SMC_LANES(l) {
      double* t = tile + (l / G) * ST;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        SMC_UNROLL for (int j = 0; j < NS; ++j)
          x[l][q][j] = (i < NS) ? -t[i * LD + NS + j] : 0.0;
        if (i < NS)
          SMC_UNROLL for (int j = 0; j < NS; ++j) t[i * LD + j] = x[l][q][j];
      }
    }
    smc_sync();
  }

  // one augmented solve (B + C X)^{-1} [D | C] gives M and the forward
  // operator Fwd = -(B + C X)^{-1} C
  Lanes<double[RPL][NS]> fwd;
  Lanes<double[RPL][NK]> m;
  {
    Lanes<double[RPL][2 * NS + NK]> w3;
    SMC_LANES(l) {
      const long long idx = Gr::particle(warp, l);
      const int r = l % G;
      const double* t = tile + (l / G) * ST;
      load_rows<NS, NS, G>(B, n, idx, r, a1[l]);
      load_rows<NS, NS, G>(C, n, idx, r, a2[l]);
      load_rows<NS, NK, G>(D, n, idx, r, w3[l], NS);
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        double cx[NS];
        row_times_tile<NS, NS, 0>(a2[l][q], t, LD, cx);
        SMC_UNROLL for (int j = 0; j < NS; ++j) {
          w3[l][q][j] = a1[l][q][j] + cx[j];
          w3[l][q][NS + NK + j] = a2[l][q][j];
        }
      }
    }
    smc_sync();
    gj_solve_group<NS, G, 2 * NS + NK>(w3, tile, ST, LD);
    SMC_LANES(l) {
      const double* t = tile + (l / G) * ST;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        SMC_UNROLL for (int j = 0; j < NK; ++j)
          m[l][q][j] = (i < NS) ? -t[i * LD + NS + j] : 0.0;
        SMC_UNROLL for (int j = 0; j < NS; ++j)
          fwd[l][q][j] = (i < NS) ? -t[i * LD + NS + NK + j] : 0.0;
      }
    }
    smc_sync();
  }

  // residual A + B X + C (X X) against tol * max(max|A|, 1); X goes to mat
  // columns 0..NS-1, then X X to columns NS..2NS-1
  Lanes<bool> ok;
  SMC_LANES(l) {
    double* t = tile + (l / G) * ST;
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = l % G + G * q;
      if (i < NS)
        SMC_UNROLL for (int j = 0; j < NS; ++j) t[i * LD + j] = x[l][q][j];
    }
  }
  smc_sync();
  Lanes<double[RPL][NS]> bx;
  SMC_LANES(l) {
    double* t = tile + (l / G) * ST;
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = l % G + G * q;
      double xx[NS];
      row_times_tile<NS, NS, 0>(x[l][q], t, LD, xx);
      row_times_tile<NS, NS, 0>(a1[l][q], t, LD, bx[l][q]);
      double mx = 0.0;
      SMC_UNROLL for (int j = 0; j < NS; ++j) mx = fmax(mx, fabs(a0[l][q][j]));
      if (i < NS) {
        SMC_UNROLL for (int j = 0; j < NS; ++j) t[i * LD + NS + j] = xx[j];
        t[O_RED + i] = mx;
      }
    }
  }
  smc_sync();
  SMC_LANES(l) {
    double* t = tile + (l / G) * ST;
    double max_a = 0.0;
    SMC_UNROLL for (int i = 0; i < NS; ++i) max_a = fmax(max_a, t[O_RED + i]);
    const double thr = tol * fmax(max_a, 1.0);
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = l % G + G * q;
      double cxx[NS];
      row_times_tile<NS, NS, NS>(a2[l][q], t, LD, cxx);
      bool good = true;
      SMC_UNROLL for (int j = 0; j < NS; ++j) {
        const double res = (a0[l][q][j] + bx[l][q][j]) + cxx[j];
        good = good && (fabs(res) < thr) && is_finite(x[l][q][j]);
      }
      SMC_UNROLL for (int j = 0; j < NK; ++j)
        good = good && is_finite(m[l][q][j]);
      if (i < NS) t[O_RED + NS + i] = good ? 1.0 : 0.0;
    }
  }
  smc_sync();
  SMC_LANES(l) {
    const double* t = tile + (l / G) * ST;
    bool good = true;
    SMC_UNROLL for (int i = 0; i < NS; ++i) good = good && t[O_RED + NS + i] > 0.5;
    ok[l] = good;
  }
  smc_sync();

  if (warp_any(ok)) {
    Lanes<double[RPL][NS]> xs;
    SMC_LANES(l) {
      SMC_UNROLL for (int q = 0; q < RPL; ++q)
        SMC_UNROLL for (int j = 0; j < NS; ++j) xs[l][q][j] = x[l][q][j];
    }
    Lanes<bool> b1, b2;
    spectral_bounds_group<NS, G>(xs, fwd, b1, b2, tile, ST, LD);
    SMC_LANES(l) { ok[l] = ok[l] && b1[l] && b2[l]; }
  }
  SMC_LANES(l) {
    const long long idx = Gr::particle(warp, l);
    const int r = l % G;
    store_rows<NS, NS, G>(X, n, idx, r, x[l], ok[l]);
    store_rows<NS, NK, G>(M, n, idx, r, m[l], ok[l]);
    if (r == 0 && idx < n) ok_out[idx] = ok[l] ? 1 : 0;
  }
}

// out[j] = sum_k a[k] b[j][k], k = 0..K-1 in order (a times the transpose
// of the tile's rows; row stride ld even, rows 16-byte aligned).
template <int K, int C>
SMC_HD inline void row_times_tile_t(const double* a, const double* b, int ld,
                                    double* out) {
  SMC_UNROLL for (int j = 0; j < C; ++j) {
    const double* bj = b + j * ld;
    double acc = 0.0;
    SMC_UNROLL for (int k = 0; k + 1 < K; k += 2) {
      const D2 v = ld2(bj + k);
      acc = (k == 0) ? a[0] * v.x : acc + a[k] * v.x;
      acc = acc + a[k + 1] * v.y;
    }
    if (K % 2) acc = (K == 1) ? a[0] * bj[0] : acc + a[K - 1] * bj[K - 1];
    out[j] = acc;
  }
}

// The adjugate of a symmetric 3x3 F (its six distinct cofactors), det(F)
// and 1 / det(F): what F^{-1} B needs, kept while F does not change.
struct Cof3 {
  double c00, c01, c02, c11, c12, c22, det, inv;
};

SMC_HD inline Cof3 cofactors3(const double (&F)[3][3]) {
  const double a = F[0][0], b = F[0][1], c = F[0][2];
  const double d = F[1][1], e = F[1][2], f = F[2][2];
  Cof3 k;
  k.c00 = d * f - e * e;
  k.c01 = c * e - b * f;
  k.c02 = b * e - c * d;
  k.c11 = a * f - c * c;
  k.c12 = b * c - a * e;
  k.c22 = a * d - b * b;
  k.det = a * k.c00 + b * k.c01 + c * k.c02;
  k.inv = 1.0 / k.det;
  return k;
}

// X = F^{-1} B = adj(F) B / det(F).
template <int M>
SMC_HD inline void cofactor_solve3(const Cof3& k, const double (&B)[3][M],
                                   double (&X)[3][M]) {
  SMC_UNROLL for (int j = 0; j < M; ++j) {
    const double b0 = B[0][j], b1 = B[1][j], b2 = B[2][j];
    X[0][j] = (k.c00 * b0 + k.c01 * b1 + k.c02 * b2) * k.inv;
    X[1][j] = (k.c01 * b0 + k.c11 * b1 + k.c12 * b2) * k.inv;
    X[2][j] = (k.c02 * b0 + k.c12 * b1 + k.c22 * b2) * k.inv;
  }
}

// a <- 0.5 (a + a')
SMC_HD inline void symmetrize3(double (&a)[3][3]) {
  SMC_UNROLL for (int i = 0; i < 3; ++i)
    SMC_UNROLL for (int j = i + 1; j < 3; ++j) {
      const double s = 0.5 * (a[i][j] + a[j][i]);
      a[i][j] = s;
      a[j][i] = s;
    }
}

// The Kalman tile: mat [NS][LD] (the doubling's A_k | P A_k', then the
// filter's W | s | W M W'Z'), red [NS].
template <int NS, int G>
struct KalmanTile {
  static constexpr int kLd = (2 * NS > 8) ? even(2 * NS) : 8;
  static constexpr int kStride = Group<NS, G>::pad(NS * kLd + NS);
  static constexpr int kWarpDoubles = kStride * Group<NS, G>::kPerWarp;
};

// Chandrasekhar Kalman log-likelihood (n_obs = 3) of the 32 / G particles of
// warp `warp`: T [NS,NS], R [NS,NK], Q [NK,NK], Z [3,NS], d [3], H [3,3]
// batch-last; ys [3, n_t] row-major, shared by every particle; ok (nullable)
// marks the particles to filter, the others get -inf. Writes the
// log-likelihood, or -inf when a guard fires: det F <= 0, v'F^-1 v < 0,
// diag(F) <= 0, or trace(F) above trace(F1)(1 + 1e-6) + 1e-12. The Lyapunov
// doubling leaves a particle once max|A_k| <= 1e-20 (a NaN never triggers
// the exit), with the warp-wide rule of re_solve_warp. Each lane keeps its
// rows of T, K, W, P and s; the 3x3 quantities (F, M, the innovation solves)
// are computed by every lane of the group from the tile.
template <int NS, int NK, int G>
SMC_HD void kalman_warp(const double* __restrict__ T,
                        const double* __restrict__ R,
                        const double* __restrict__ Q,
                        const double* __restrict__ Z,
                        const double* __restrict__ dv,
                        const double* __restrict__ H, const double* ys,
                        int n_t, const unsigned char* __restrict__ ok,
                        long long n, long long warp, int lyap_iter,
                        double* __restrict__ out, double* tile) {
  using Gr = Group<NS, G>;
  constexpr int NO = kNObs;
  constexpr int RPL = Gr::RPL;
  constexpr int LD = KalmanTile<NS, G>::kLd;
  constexpr int ST = KalmanTile<NS, G>::kStride;
  constexpr int O_RED = NS * LD;

  // particles past n or not ok run on zeros and are written as -inf
  Lanes<bool> active;
  Lanes<long long> src;
  SMC_LANES(l) {
    const long long idx = Gr::particle(warp, l);
    active[l] = idx < n && (ok == nullptr || ok[idx] != 0);
    src[l] = active[l] ? idx : n;
  }
  if (!warp_any(active)) {
    SMC_LANES(l) {
      const long long idx = Gr::particle(warp, l);
      if (l % G == 0 && idx < n) out[idx] = -(double)INFINITY;
    }
    return;
  }

  Lanes<double[RPL][NS]> tm, p;
  // P0 = stationary covariance: P = T P T' + R Q R' by doubling
  {
    Lanes<double[RPL][NK]> rr;
    SMC_LANES(l) {
      const int r = l % G;
      double* t = tile + (l / G) * ST;
      load_rows<NS, NS, G>(T, n, src[l], r, tm[l]);
      load_rows<NS, NK, G>(R, n, src[l], r, rr[l]);
      SMC_UNROLL for (int qq = 0; qq < RPL; ++qq) {
        const int i = r + G * qq;
        if (i < NS)
          SMC_UNROLL for (int j = 0; j < NK; ++j) t[i * LD + j] = rr[l][qq][j];
      }
    }
    smc_sync();
    SMC_LANES(l) {
      const double* t = tile + (l / G) * ST;
      double q[NK][NK];
      load_all<NK, NK>(Q, n, src[l], q);
      SMC_UNROLL for (int qq = 0; qq < RPL; ++qq) {
        double rq[NK];
        SMC_UNROLL for (int j = 0; j < NK; ++j) {
          double acc = rr[l][qq][0] * q[0][j];
          SMC_UNROLL for (int k = 1; k < NK; ++k) acc += rr[l][qq][k] * q[k][j];
          rq[j] = acc;
        }
        row_times_tile_t<NK, NS>(rq, t, LD, p[l][qq]);
      }
    }
    smc_sync();
  }
  {
    Lanes<double[RPL][NS]> ak;
    Lanes<bool> done;
    SMC_LANES(l) {
      done[l] = false;
      SMC_UNROLL for (int q = 0; q < RPL; ++q)
        SMC_UNROLL for (int j = 0; j < NS; ++j) ak[l][q][j] = tm[l][q][j];
    }
    for (int it = 0; it < lyap_iter; ++it) {
      // A_k to mat columns 0..NS-1, each row's max |entry| (NaN if the row
      // holds one) to red
      SMC_LANES(l) {
        double* t = tile + (l / G) * ST;
        SMC_UNROLL for (int q = 0; q < RPL; ++q) {
          const int i = l % G + G * q;
          double mx = 0.0;
          bool any_nan = false;
          SMC_UNROLL for (int j = 0; j < NS; ++j) {
            mx = fmax(mx, fabs(ak[l][q][j]));
            any_nan = any_nan || is_nan(ak[l][q][j]);
          }
          if (i < NS) {
            SMC_UNROLL for (int j = 0; j < NS; ++j) t[i * LD + j] = ak[l][q][j];
            t[O_RED + i] = any_nan ? NAN : mx;
          }
        }
      }
      smc_sync();
      Lanes<bool> running;
      SMC_LANES(l) {
        const double* t = tile + (l / G) * ST;
        double mx = 0.0;
        bool any_nan = false;
        SMC_UNROLL for (int i = 0; i < NS; ++i) {
          mx = fmax(mx, t[O_RED + i]);
          any_nan = any_nan || is_nan(t[O_RED + i]);
        }
        done[l] = done[l] || (!any_nan && mx <= 1e-20);
        running[l] = !done[l];
      }
      if (!warp_any(running)) break;
      // P A_k' to mat columns NS..2NS-1, stored after every row of the lane
      // has read A_k; A_k A_k kept in the lane
      Lanes<double[RPL][NS]> akak;
      SMC_LANES(l) {
        double* t = tile + (l / G) * ST;
        double pa[RPL][NS];
        SMC_UNROLL for (int q = 0; q < RPL; ++q) {
          row_times_tile_t<NS, NS>(p[l][q], t, LD, pa[q]);
          row_times_tile<NS, NS, 0>(ak[l][q], t, LD, akak[l][q]);
        }
        SMC_UNROLL for (int q = 0; q < RPL; ++q) {
          const int i = l % G + G * q;
          if (i < NS)
            SMC_UNROLL for (int j = 0; j < NS; ++j) t[i * LD + NS + j] = pa[q][j];
        }
      }
      smc_sync();
      // P <- P + A_k P A_k', A_k <- A_k A_k. No sync after: the next phase
      // writes only mat columns 0..NS-1 and red, which this one does not read
      SMC_LANES(l) {
        const double* t = tile + (l / G) * ST;
        const bool keep = done[l];
        SMC_UNROLL for (int q = 0; q < RPL; ++q) {
          double apa[NS];
          row_times_tile<NS, NS, NS>(ak[l][q], t, LD, apa);
          SMC_UNROLL for (int j = 0; j < NS; ++j) {
            p[l][q][j] = keep ? p[l][q][j] : p[l][q][j] + apa[j];
            ak[l][q][j] = keep ? ak[l][q][j] : akak[l][q][j];
          }
        }
      }
    }
  }

  // F1 = sym(Z P Z' + H), K1 = T P Z', M1 = sym(-F1^{-1}), W1 = K1; P Z' goes
  // to mat columns 0..2
  Lanes<double[RPL][NO]> K, W;
  Lanes<double[RPL]> s;
  Lanes<double[NO][NO]> F, Mm;
  Lanes<Cof3> cof;             // of the current F, made once per F
  Lanes<double> tr_cap, total;
  Lanes<bool> bad;
  Lanes<double[NO][NS]> z;
  Lanes<double[RPL][NO]> zc;   // the lane's columns of Z (0 for padding)
  Lanes<double[NO]> dd;
  SMC_LANES(l) {
    double* t = tile + (l / G) * ST;
    load_all<NO, NS>(Z, n, src[l], z[l]);
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = l % G + G * q;
      SMC_UNROLL for (int o = 0; o < NO; ++o)
        zc[l][q][o] = (src[l] < n && i < NS)
                          ? Z[(long long)(o * NS + i) * n + src[l]] : 0.0;
    }
    SMC_UNROLL for (int o = 0; o < NO; ++o)
      dd[l][o] = (src[l] < n) ? dv[(long long)o * n + src[l]] : 0.0;
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      const int i = l % G + G * q;
      double pzt[NO];
      SMC_UNROLL for (int o = 0; o < NO; ++o) {
        double acc = p[l][q][0] * z[l][o][0];
        SMC_UNROLL for (int j = 1; j < NS; ++j) acc += p[l][q][j] * z[l][o][j];
        pzt[o] = acc;
      }
      if (i < NS)
        SMC_UNROLL for (int o = 0; o < NO; ++o) t[i * LD + o] = pzt[o];
    }
  }
  smc_sync();
  SMC_LANES(l) {
    double* t = tile + (l / G) * ST;
    double h[NO][NO];
    load_all<NO, NO>(H, n, src[l], h);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) {
        double acc = z[l][i][0] * t[j];
        SMC_UNROLL for (int k = 1; k < NS; ++k) acc += z[l][i][k] * t[k * LD + j];
        F[l][i][j] = acc + h[i][j];
      }
    symmetrize3(F[l]);
    SMC_UNROLL for (int q = 0; q < RPL; ++q) {
      row_times_tile<NS, NO, 0>(tm[l][q], t, LD, K[l][q]);
      SMC_UNROLL for (int o = 0; o < NO; ++o) W[l][q][o] = K[l][q][o];
      s[l][q] = 0.0;
    }
    cof[l] = cofactors3(F[l]);
    double eye[NO][NO], finv[NO][NO];
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) eye[i][j] = (i == j) ? 1.0 : 0.0;
    cofactor_solve3(cof[l], eye, finv);
    SMC_UNROLL for (int i = 0; i < NO; ++i)
      SMC_UNROLL for (int j = 0; j < NO; ++j) Mm[l][i][j] = -finv[i][j];
    symmetrize3(Mm[l]);
    tr_cap[l] = (F[l][0][0] + F[l][1][1] + F[l][2][2]) * (1.0 + 1e-6) + 1e-12;
    total[l] = 0.0;
    bad[l] = false;
  }
  smc_sync();

  for (int step = 0; step < n_t; ++step) {
    // W | s to mat columns 0..3; Z [W | s] as sums over each lane's rows,
    // then over the group
    Lanes<double[NO * (NO + 1)]> zws;
    SMC_LANES(l) {
      double* t = tile + (l / G) * ST;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        if (i < NS) {
          SMC_UNROLL for (int o = 0; o < NO; ++o) t[i * LD + o] = W[l][q][o];
          t[i * LD + NO] = s[l][q];
        }
      }
      SMC_UNROLL for (int o = 0; o < NO; ++o)
        SMC_UNROLL for (int j = 0; j <= NO; ++j) {
          double acc = 0.0;
          SMC_UNROLL for (int q = 0; q < RPL; ++q) {
            const double v = (j < NO) ? W[l][q][j] : s[l][q];
            acc = (q == 0) ? zc[l][q][o] * v : acc + zc[l][q][o] * v;
          }
          zws[l][o * (NO + 1) + j] = acc;
        }
    }
    group_sum<G>(zws);
    smc_sync();
    // innovation solve with the F of this step, the likelihood term, the new
    // s and W rows; the W M W'Z' rows go to mat columns 4..6 once every row
    // of the lane has read T [W | s]
    Lanes<double[NO][NO]> zw, mwtzt;
    Lanes<double[RPL][NO]> wn;
    Lanes<double[RPL]> s_new;
    Lanes<double[NO * NO]> zwm;
    SMC_LANES(l) {
      double* t = tile + (l / G) * ST;
      double rhs[NO][1 + NO], sol[NO][1 + NO];
      SMC_UNROLL for (int o = 0; o < NO; ++o) {
        SMC_UNROLL for (int j = 0; j < NO; ++j)
          zw[l][o][j] = zws[l][o * (NO + 1) + j];
        const double zs = zws[l][o * (NO + 1) + NO];
        rhs[o][0] = (ys[o * n_t + step] - dd[l][o]) - zs;
        SMC_UNROLL for (int j = 0; j < NO; ++j) rhs[o][1 + j] = zw[l][o][j];
      }
      cofactor_solve3(cof[l], rhs, sol);
      const double det = cof[l].det;
      double quad = rhs[0][0] * sol[0][0];
      SMC_UNROLL for (int o = 1; o < NO; ++o) quad += rhs[o][0] * sol[o][0];
      total[l] += -0.5 * (NO * kLog2Pi + log(det) + quad);
      bad[l] = bad[l] || !(det > 0.0) || quad < 0.0;
      // M W'Z'
      SMC_UNROLL for (int i = 0; i < NO; ++i)
        SMC_UNROLL for (int j = 0; j < NO; ++j) {
          double acc = Mm[l][i][0] * zw[l][j][0];
          SMC_UNROLL for (int k = 1; k < NO; ++k) acc += Mm[l][i][k] * zw[l][j][k];
          mwtzt[l][i][j] = acc;
        }
      double wm[RPL][NO];
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        double tws[NO + 1];    // the row's T [W | s]
        row_times_tile<NS, NO + 1, 0>(tm[l][q], t, LD, tws);
        double kf = K[l][q][0] * sol[0][0];
        SMC_UNROLL for (int o = 1; o < NO; ++o) kf += K[l][q][o] * sol[o][0];
        s_new[l][q] = tws[NO] + kf;
        SMC_UNROLL for (int o = 0; o < NO; ++o) {
          double acc = W[l][q][0] * mwtzt[l][0][o];
          SMC_UNROLL for (int k = 1; k < NO; ++k) acc += W[l][q][k] * mwtzt[l][k][o];
          wm[q][o] = acc;
        }
        // W <- T W - K F^{-1} Z W, with the K and W of this step
        SMC_UNROLL for (int o = 0; o < NO; ++o) {
          double kfo = K[l][q][0] * sol[0][1 + o];
          SMC_UNROLL for (int j = 1; j < NO; ++j) kfo += K[l][q][j] * sol[j][1 + o];
          wn[l][q][o] = tws[o] - kfo;
        }
        SMC_UNROLL for (int a = 0; a < NO; ++a)
          SMC_UNROLL for (int b = 0; b < NO; ++b)
            zwm[l][a * NO + b] = (q == 0) ? zc[l][q][a] * wm[q][b]
                                          : zwm[l][a * NO + b] + zc[l][q][a] * wm[q][b];
      }
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        const int i = l % G + G * q;
        if (i < NS)
          SMC_UNROLL for (int o = 0; o < NO; ++o) t[i * LD + NO + 1 + o] = wm[q][o];
      }
    }
    group_sum<G>(zwm);
    smc_sync();
    // K <- K + T W M W'Z' ;  F <- sym(F + Z W M W'Z') and its cofactors ;
    // M <- sym(M - M W'Z' F_new^{-1} Z W M). No sync after: the next step's
    // first phase writes only mat columns 0..3, which this one does not read
    SMC_LANES(l) {
      const double* t = tile + (l / G) * ST;
      SMC_UNROLL for (int q = 0; q < RPL; ++q) {
        double tk[NO];
        row_times_tile<NS, NO, NO + 1>(tm[l][q], t, LD, tk);
        SMC_UNROLL for (int o = 0; o < NO; ++o) K[l][q][o] += tk[o];
        SMC_UNROLL for (int o = 0; o < NO; ++o) W[l][q][o] = wn[l][q][o];
        s[l][q] = s_new[l][q];
      }
      SMC_UNROLL for (int i = 0; i < NO; ++i)
        SMC_UNROLL for (int j = 0; j < NO; ++j) F[l][i][j] += zwm[l][i * NO + j];
      symmetrize3(F[l]);
      cof[l] = cofactors3(F[l]);
      double fzw[NO][NO], fzwm[NO][NO];
      cofactor_solve3(cof[l], zw[l], fzw);
      SMC_UNROLL for (int i = 0; i < NO; ++i)
        SMC_UNROLL for (int j = 0; j < NO; ++j) {
          double acc = fzw[i][0] * Mm[l][0][j];
          SMC_UNROLL for (int k = 1; k < NO; ++k) acc += fzw[i][k] * Mm[l][k][j];
          fzwm[i][j] = acc;
        }
      SMC_UNROLL for (int i = 0; i < NO; ++i)
        SMC_UNROLL for (int j = 0; j < NO; ++j) {
          double acc = mwtzt[l][i][0] * fzwm[0][j];
          SMC_UNROLL for (int k = 1; k < NO; ++k) acc += mwtzt[l][i][k] * fzwm[k][j];
          Mm[l][i][j] -= acc;
        }
      symmetrize3(Mm[l]);
      bad[l] = bad[l] || F[l][0][0] <= 0.0 || F[l][1][1] <= 0.0 ||
               F[l][2][2] <= 0.0 ||
               (F[l][0][0] + F[l][1][1] + F[l][2][2]) > tr_cap[l];
    }
  }
  SMC_LANES(l) {
    const long long idx = Gr::particle(warp, l);
    if (l % G == 0 && idx < n)
      out[idx] = (!active[l] || bad[l] || !is_finite(total[l]))
                     ? -(double)INFINITY
                     : total[l];
  }
}

}  // namespace smc
