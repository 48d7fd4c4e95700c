"""The work the DSGE kernels do on given inputs: flop counts per particle
and the iterations, doubling steps and filter steps each particle needs.

A frozen copy of chip_smoke.py's counts (re_flops, kalman_flops, gj_flops,
psd_solve_flops, cr_iterations, lyapunov_iterations, chandrasekhar_steps),
on the reference's plain linear algebra, so that the bound of a kernel is
the same whatever implements it. Flop counts are pairs (matrix-product
flop, other flop): products of two matrices can run on the tensor cores,
the rest (elimination, factors, matrix-vector and elementwise work) on
the FMA pipes (peaks.py).
"""

from __future__ import annotations

import torch

from perfbench.reference import _linear_re as lr


def f(prod=0, other=0):
    return (prod, other)


def add(*fs):
    return tuple(map(sum, zip(*fs))) if fs else (0, 0)


def mul(c, fl):
    return (c * fl[0], c * fl[1])


def gj_flops(n, w):
    """Gauss-Jordan on n x w: per pivot, w-1-k normalizing multiplies and
    (n-1)(w-1-k) eliminating FMAs (2 flop each); none a matrix product."""
    return f(other=sum((w - 1 - k) * (1 + 2 * (n - 1)) for k in range(n)))


def re_flops(ns, nk, cr_iters):
    """flop of one particle's RE solve that runs `cr_iters` cyclic-
    reduction iterations."""
    prod = f(prod=2 * ns ** 3)
    sq = lambda c: f(other=c * ns * ns)
    per_iter = add(gj_flops(ns, 3 * ns), mul(4, prod), sq(4))
    spectral = add(mul(12, add(prod, sq(3))), sq(2))
    tail = add(gj_flops(ns, 2 * ns), prod, sq(1),
               gj_flops(ns, 2 * ns + nk),
               mul(3, prod), sq(2),
               mul(2, spectral))
    return add(mul(cr_iters, per_iter), tail)


def psd_solve_flops(no, m):
    """flop of one PSD innovation solve with m right-hand sides: the 3x3
    cofactor form, or Cholesky and two triangular solves."""
    if no == 3:
        return 2 * 6 + 5 + 1 + m * (3 * 5 + 1)
    return 2 * no ** 3 // 3 + 2 * no * no * m


def kalman_flops(ns, nk, lyap_iters, n_t, no=3):
    """flop of one accepted particle's Chandrasekhar filter: R Q R', the
    doubling steps, the set-up of F, K, M and n_t filter steps."""
    setup = f(prod=2 * ns * nk * nk + 2 * ns * ns * nk)
    per_doubling = f(prod=3 * 2 * ns ** 3, other=ns * ns)
    first = f(prod=2 * ns * ns * no * 2 + 2 * no * no * ns,
              other=60 if no == 3 else psd_solve_flops(no, no))
    per_step = f(
        prod=(2 * no * no * ns + 2 * no ** 3 + 2 * ns * no * no
              + 2 * ns * ns * no + 2 * ns * no * no + 2 * ns * ns * no
              + 2 * no * no * ns + 2 * 2 * no ** 3),
        other=(2 * no * ns + 2 * no + psd_solve_flops(no, 1 + no) + 10
               + 2 * ns * ns + 2 * ns * no + ns + ns * no + no * no + 6
               + psd_solve_flops(no, no) + no * no + 6 + 8))
    return add(setup, mul(lyap_iters, per_doubling), first,
               mul(n_t, per_step))


def summed(counts, per):
    """sum over particles of per(count), from a tensor of counts."""
    vals, reps = torch.unique(counts, return_counts=True)
    return add(f(), *(mul(int(r), per(int(v)))
                      for v, r in zip(vals.tolist(), reps.tolist())))


def cr_iterations(A, B, C, n_iter=16):
    """Per particle, the cyclic-reduction iterations the kernels run (they
    leave once max(|A0|, |A2|) <= 2^-27 max(1, max|A|, |B|, |C|))."""
    n = A.shape[0]
    finite = lambda t: torch.isfinite(t).all(dim=0).all(dim=0)
    fin = finite(A) & finite(B) & finite(C)
    scale = torch.where(fin, torch.maximum(torch.maximum(lr.max_abs(A),
                                                         lr.max_abs(B)),
                                           lr.max_abs(C)), 0.0)
    tol_exit = scale.clamp(min=1.0) * 2.0 ** -27
    iters = torch.full((A.shape[-1],), n_iter, device=A.device)
    running = torch.ones(A.shape[-1], dtype=torch.bool, device=A.device)
    A0, A1, A2 = A, B, C
    for it in range(n_iter):
        nan = torch.isnan(A0).any(0).any(0) | torch.isnan(A2).any(0).any(0)
        stop = running & ~nan & (torch.maximum(lr.max_abs(A0),
                                               lr.max_abs(A2)) <= tol_exit)
        iters[stop] = it
        running &= ~stop
        SA = lr.gj_solve(A1, torch.cat([A0, A2], dim=1))
        SA0, SA2 = SA[:, :n], SA[:, n:]
        A2SA0 = lr.matmul(A2, SA0)
        A1 = A1 - lr.matmul(A0, SA2) - A2SA0
        A0, A2 = -lr.matmul(A0, SA0), -lr.matmul(A2, SA2)
    return iters


def lyapunov_iterations(T, n_iter=30):
    """Per particle, the doubling steps the filters run (they leave once
    max|T^(2^k)| <= 1e-20, never on a NaN)."""
    iters = torch.full((T.shape[-1],), n_iter, device=T.device)
    running = torch.ones(T.shape[-1], dtype=torch.bool, device=T.device)
    Ak = T
    for it in range(n_iter):
        nan = torch.isnan(Ak).any(0).any(0)
        stop = running & ~nan & (lr.max_abs(Ak) <= 1e-20)
        iters[stop] = it
        running &= ~stop
        Ak = lr.matmul(Ak, Ak)
    return iters


def chandrasekhar_steps(T, R, Q, Z, d, H, data):
    """Per particle, the filter steps the general Kalman kernel runs: it
    leaves after the step that rejects the particle (a guard fires or the
    total turns non-finite)."""
    n_s, n_o, nb = T.shape[0], Z.shape[0], T.shape[-1]
    RQR = lr.matmul(R, lr.matmul(Q, lr.transpose(R)))
    P0 = lr.lyapunov(T, RQR)
    F = lr.sym(lr.matmul(Z, lr.matmul(P0, lr.transpose(Z))) + H)
    K = lr.matmul(T, lr.matmul(P0, lr.transpose(Z)))
    eye = torch.eye(n_o, dtype=F.dtype, device=F.device)[:, :, None]
    M = lr.sym(-lr.psd_solve(F, eye.expand(n_o, n_o, nb))[0])
    W = K
    s = torch.zeros((n_s, nb), dtype=F.dtype, device=F.device)
    tr_cap = torch.diagonal(F).sum(-1) * (1.0 + 1e-6) + 1e-12
    bad = torch.zeros(nb, dtype=torch.bool, device=F.device)
    rejected = torch.zeros(nb, dtype=torch.bool, device=F.device)
    total = torch.zeros(nb, dtype=F.dtype, device=F.device)
    steps = torch.full((nb,), data.shape[1], device=F.device)
    for t in range(data.shape[1]):
        v = data[:, t, None] - d - lr.matvec(Z, s)
        ZW = lr.matmul(Z, W)
        sol, logdet = lr.psd_solve(F, torch.cat([v[:, None], ZW], 1))
        quad = torch.sum(v * sol[:, 0], dim=0)
        total = total - 0.5 * (n_o * lr.LOG_2PI + logdet + quad)
        s = lr.matvec(T, s) + lr.matvec(K, sol[:, 0])
        MWtZt = lr.matmul(M, lr.transpose(ZW))
        WMWtZt = lr.matmul(W, MWtZt)
        F_new = lr.sym(F + lr.matmul(Z, WMWtZt))
        K_new = K + lr.matmul(T, WMWtZt)
        W = lr.matmul(T, W) - lr.matmul(K, sol[:, 1:])
        M = lr.sym(M - lr.matmul(MWtZt, lr.matmul(
            lr.psd_solve(F_new, ZW)[0], M)))
        diag_F = torch.diagonal(F_new)
        bad = (bad | (quad < 0.0) | (diag_F <= 0.0).any(dim=1)
               | (diag_F.sum(-1) > tr_cap))
        now = bad | ~torch.isfinite(total)
        steps = torch.where(now & ~rejected, t + 1, steps)
        rejected = now
        F, K = F_new, K_new
    return steps


class Workload:
    """The counts of one batch of likelihood inputs (A, B, C, D, Q, Z, d, H
    batch-last and data [n_obs, T], float64), each worked out once on first
    use: the RE solution, the cyclic-reduction iterations of every
    particle, and the doubling and filter steps of the accepted ones."""

    def __init__(self, A, B, C, D, Q, Z, d, H, data):
        self.A, self.B, self.C, self.D = A, B, C, D
        self.Q, self.Z, self.d, self.H = Q, Z, d, H
        self.data = torch.as_tensor(data, dtype=A.dtype, device=A.device)
        self.n_s, self.n_k = A.shape[0], D.shape[1]
        self.n_o, self.n = Z.shape[0], A.shape[-1]
        self.n_t = self.data.shape[1]
        self._memo = {}

    def _get(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    @property
    def solution(self):
        """(X, M, ok) of the reference's RE solve."""
        return self._get("re", lambda: lr.solve_re(self.A, self.B, self.C,
                                                   self.D))

    @property
    def cr_iters(self):
        return self._get("cr", lambda: cr_iterations(self.A, self.B, self.C))

    def _ok(self, t):
        return t[..., self.solution[2]].contiguous()

    @property
    def lyap_iters(self):
        """Doubling steps of the accepted particles."""
        return self._get("ly", lambda: lyapunov_iterations(
            self._ok(self.solution[0])))

    @property
    def filter_steps(self):
        """Chandrasekhar steps of the accepted particles."""
        X, M, _ = self.solution
        return self._get("steps", lambda: chandrasekhar_steps(
            self._ok(X), self._ok(M), self._ok(self.Q), self._ok(self.Z),
            self._ok(self.d), self._ok(self.H), self.data))

    def re_bytes(self):
        ns, nk = self.n_s, self.n_k
        return self.n * (8 * (3 * ns * ns + ns * nk) + 8 * (ns * ns + ns * nk)
                         + 1)

    def kalman_bytes(self):
        ns, nk, no = self.n_s, self.n_k, self.n_o
        return (self.n * (8 * (ns * ns + ns * nk + nk * nk + no * ns + no
                               + no * no) + 1 + 8) + 8 * self.data.numel())
