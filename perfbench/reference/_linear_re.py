"""The plain linear-RE DSGE likelihood: a cyclic-reduction RE solve and the
Chandrasekhar Kalman filter, batch-last [r, c, N] in plain PyTorch.

A frozen copy of the algorithm of smc_tpu_torch's plain path
(models/dsge.py bl_solve_linear_re, bl_lyapunov_doubling,
bl_kalman_loglike_chandrasekhar; ops/linalg.py's Gauss-Jordan and
innovation solves), written here so that the benchmark's yardstick imports
nothing of the program. Every function computes in the dtype of its inputs:
float64 is the reference, float32 the lower-precision control.

  A x_{t-1} + B x_t + C E_t[x_{t+1}] + D eps_t = 0  ->  x_t = X x_{t-1} + M eps_t
  y_t = d + Z x_t + u_t,  eps ~ N(0, Q),  u ~ N(0, H)
"""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453


def matmul(A, B):
    """[i,j,N] @ [j,k,N] -> [i,k,N]."""
    return torch.einsum("ijn,jkn->ikn", A, B)


def transpose(A):
    return A.transpose(0, 1)


def matvec(A, x):
    """[i,j,N] @ [j,N] -> [i,N]."""
    return torch.einsum("ijn,jn->in", A, x)


def sym(A):
    return 0.5 * (A + transpose(A))


def max_abs(A):
    """max |entry| per particle of [r, c, N] -> [N] (NaN propagates)."""
    return torch.amax(A.abs(), dim=(0, 1))


def gj_solve(A, B):
    """Gauss-Jordan with partial pivoting (the first largest |entry| at or
    below the diagonal), per particle: A [n,n,N], B [n,m,N] -> X [n,m,N]."""
    n, nb = A.shape[0], A.shape[-1]
    M = torch.cat([A, B.to(A.dtype)], dim=1)
    for k in range(n):
        p = k + torch.argmax(M[k:, k, :].abs(), dim=0)
        rows = p.view(1, 1, nb).expand(1, M.shape[1], nb)
        row_p = M.gather(0, rows)
        M.scatter_(0, rows, M[k:k + 1].clone())
        M[k:k + 1] = row_p
        pivot = row_p[0, k]
        factor = M[:, k, :] / pivot
        factor[k] = 0.0
        M.addcmul_(factor[:, None, :], row_p, value=-1.0)
        M[k].div_(pivot)
    return M[:, n:, :]


def cofactor_solve3(F, B):
    """(X, log det F) for a symmetric 3x3 F [3,3,N] by the adjugate."""
    a, b, c = F[0, 0], F[0, 1], F[0, 2]
    d, e, f = F[1, 1], F[1, 2], F[2, 2]
    C00, C01, C02 = d * f - e * e, c * e - b * f, b * e - c * d
    C11, C12, C22 = a * f - c * c, b * c - a * e, a * d - b * b
    det = a * C00 + b * C01 + c * C02
    inv_det = 1.0 / det
    B0, B1, B2 = B[0], B[1], B[2]
    X = torch.stack([(C00 * B0 + C01 * B1 + C02 * B2) * inv_det,
                     (C01 * B0 + C11 * B1 + C12 * B2) * inv_det,
                     (C02 * B0 + C12 * B1 + C22 * B2) * inv_det])
    return X, torch.log(det)


def chol_solve(F, B):
    """(X, log det F) for a symmetric PD F [n,n,N] by Cholesky; a lane whose
    factor fails gets NaN (the filter's guards reject it)."""
    L, info = torch.linalg.cholesky_ex(F.permute(2, 0, 1))
    Y = torch.linalg.solve_triangular(L, B.permute(2, 0, 1), upper=False)
    X = torch.linalg.solve_triangular(L.transpose(1, 2), Y, upper=True)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(-1)
    failed = info != 0
    X = torch.where(failed[:, None, None], float("nan"), X)
    return X.permute(1, 2, 0), torch.where(failed, float("nan"), logdet)


def psd_solve(F, B):
    """The innovation solve: the cofactor form at n = 3, else Cholesky."""
    return cofactor_solve3(F, B) if F.shape[0] == 3 else chol_solve(F, B)


def spectral_radius_bound(M, n_squarings: int = 12):
    """rho(M) <= ||M^(2^k)||_F^(1/2^k), by renormalized squaring -> [N]."""
    log_scale = torch.zeros(M.shape[-1], dtype=M.dtype, device=M.device)
    for _ in range(n_squarings):
        nrm = torch.sqrt(torch.sum(M * M, dim=(0, 1))) + 1e-300
        M = matmul(M / nrm, M / nrm)
        log_scale = 2.0 * (log_scale + torch.log(nrm))
    nrm = torch.sqrt(torch.sum(M * M, dim=(0, 1))) + 1e-300
    return torch.exp((log_scale + torch.log(nrm)) / (2.0 ** n_squarings))


# the residual an accepted RE solution may leave, relative to max|A|: the
# program's 1e-8 in float64; in float32, whose rounding alone leaves some
# 1e-6, the control's scaled 1e-4, so that its draws stay finite
RESIDUAL_TOL = {torch.float64: 1e-8, torch.float32: 1e-4}


def solve_re(A, B, C, D, n_iter: int = 16):
    """Cyclic reduction (Bini and Meini) for A + B X + C X^2 = 0:
    (X [n,n,N], M [n,k,N], ok [N]). A draw is accepted where the residual
    is below RESIDUAL_TOL (relative to max|A|, at least 1), X is stable and
    -(B + C X)^-1 C has spectral radius below 1; X, M are 0 elsewhere."""
    tol = RESIDUAL_TOL[A.dtype]
    n = A.shape[0]
    A0, A1, A2, Ah = A, B, C, B
    for _ in range(n_iter):
        SA = gj_solve(A1, torch.cat([A0, A2], dim=1))
        SA0, SA2 = SA[:, :n], SA[:, n:]
        A2SA0 = matmul(A2, SA0)
        Ah = Ah - A2SA0
        A1 = A1 - matmul(A0, SA2) - A2SA0
        A0, A2 = -matmul(A0, SA0), -matmul(A2, SA2)
    X = -gj_solve(Ah, A)
    lhs = B + matmul(C, X)
    M = -gj_solve(lhs, D)
    resid = A + matmul(B, X) + matmul(C, matmul(X, X))
    converged = max_abs(resid) < tol * torch.clamp(max_abs(A), min=1.0)
    stable = spectral_radius_bound(X) < 1.0
    unique = spectral_radius_bound(-gj_solve(lhs, C)) < 1.0
    finite = (torch.isfinite(X).all(dim=0).all(dim=0)
              & torch.isfinite(M).all(dim=0).all(dim=0))
    ok = converged & stable & unique & finite
    return torch.where(ok, X, 0.0), torch.where(ok, M, 0.0), ok


def lyapunov(T, Q, n_iter: int = 30):
    """P = T P T' + Q by doubling."""
    Ak, Pk = T, Q
    for _ in range(n_iter):
        Ak, Pk = matmul(Ak, Ak), Pk + matmul(Ak, matmul(Pk, transpose(Ak)))
    return Pk


def chandrasekhar(T, R, Q, Z, d, H, data):
    """The Chandrasekhar (Morf-Sidhu-Kailath) Kalman log-likelihood from the
    stationary covariance -> [N]; quad < 0, diag(F) <= 0 or trace(F)
    growing past trace(F_1) mark the draw -inf, as does a non-finite
    total."""
    n_s, n_o, nb = T.shape[0], Z.shape[0], T.shape[-1]
    RQR = matmul(R, matmul(Q, transpose(R)))
    P0 = lyapunov(T, RQR)
    F = sym(matmul(Z, matmul(P0, transpose(Z))) + H)
    K = matmul(T, matmul(P0, transpose(Z)))
    eye = torch.eye(n_o, dtype=F.dtype, device=F.device)[:, :, None]
    M = sym(-psd_solve(F, eye.expand(n_o, n_o, nb))[0])
    W = K
    s = torch.zeros((n_s, nb), dtype=F.dtype, device=F.device)
    tr_cap = torch.diagonal(F).sum(-1) * (1.0 + 1e-6) + 1e-12
    bad = torch.zeros(nb, dtype=torch.bool, device=F.device)
    total = torch.zeros(nb, dtype=F.dtype, device=F.device)
    ys = torch.as_tensor(data, dtype=F.dtype, device=F.device)
    for t in range(ys.shape[1]):
        v = ys[:, t, None] - d - matvec(Z, s)
        ZW = matmul(Z, W)
        sol, logdet = psd_solve(F, torch.cat([v[:, None], ZW], 1))
        quad = torch.sum(v * sol[:, 0], dim=0)
        total = total - 0.5 * (n_o * LOG_2PI + logdet + quad)
        s = matvec(T, s) + matvec(K, sol[:, 0])
        MWtZt = matmul(M, transpose(ZW))
        WMWtZt = matmul(W, MWtZt)
        F_new = sym(F + matmul(Z, WMWtZt))
        K_new = K + matmul(T, WMWtZt)
        W = matmul(T, W) - matmul(K, sol[:, 1:])
        M = sym(M - matmul(MWtZt, matmul(psd_solve(F_new, ZW)[0], M)))
        diag_F = torch.diagonal(F_new)
        bad = (bad | (quad < 0.0) | (diag_F <= 0.0).any(dim=1)
               | (diag_F.sum(-1) > tr_cap))
        F, K = F_new, K_new
    return torch.where(torch.isfinite(total) & ~bad, total, float("-inf"))


def loglike(A, B, C, D, Q, Z, d, H, data):
    """The RE solve, then the filter; rejected draws -inf -> [N]."""
    X, M, ok = solve_re(A, B, C, D)
    return torch.where(ok, chandrasekhar(X, M, Q, Z, d, H, data),
                       float("-inf"))
