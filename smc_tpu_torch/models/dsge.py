"""Linear DSGE family: RE solve by cyclic reduction + Kalman likelihood
(port of smc_tpu/models/dsge.py).

The system  A x_{t-1} + B x_t + C E_t[x_{t+1}] + D eps_t = 0  is solved for
x_t = X x_{t-1} + M eps_t with X solving A + B X + C X^2 = 0 by cyclic
reduction (Bini & Meini); the draw is accepted if the residual is small and
the spectral-radius bounds of X and of -(B + C X)^{-1} C are below 1. The
likelihood is the Morf-Sidhu-Kailath Chandrasekhar recursion (or, with
use_chand_recursion=False, the Riccati filter) started from the stationary
covariance (Lyapunov doubling). Rejected draws give -inf.

The `bl_*` functions here are the plain PyTorch versions: batch-last
[r, c, N] tensors, fixed iteration counts. They are what a CPU tensor runs
and what the CUDA kernels (ops/cuda_dsge.py) are held against. The
per-particle functions (`solve_linear_re`, `lyapunov_doubling`,
`kalman_loglike`, `kalman_loglike_chandrasekhar`) are the `bl_*` ones at
N = 1.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from smc_tpu_torch.ops.linalg import (bl_matmul, bl_transpose, bl_gj_solve,
                                      bl_psd_fast_solve, bl_psd_logdet_solve)
from smc_tpu_torch.utils.misc import DeviceCopies

_LOG_2PI = 1.8378770664093453

# likelihood_backend names: the port's, and the JAX package's for the same
# two paths
BACKENDS = {"kernel": "kernel", "plain": "plain", "pallas": "kernel",
            "xla": "plain"}


def _bl_matvec(A, x):
    """[i,j,N] @ [j,N] -> [i,N]."""
    return torch.einsum("ijn,jn->in", A, x)


def _bl_sym(A):
    return 0.5 * (A + bl_transpose(A))


def _max_abs(A):
    """max |entry| per particle of [r, c, N] -> [N] (nan propagates)."""
    return torch.amax(A.abs(), dim=(0, 1))


def bl_spectral_radius_bound(M: torch.Tensor, n_squarings: int = 12):
    """rho(M) upper bound ||M^(2^k)||_F^(1/2^k) by renormalized repeated
    squaring: M [n,n,N] -> [N]."""
    log_scale = torch.zeros(M.shape[-1], dtype=M.dtype, device=M.device)
    for _ in range(n_squarings):
        nrm = torch.sqrt(torch.sum(M * M, dim=(0, 1))) + 1e-300
        M = M / nrm
        M = bl_matmul(M, M)
        log_scale = 2.0 * (log_scale + torch.log(nrm))
    nrm_last = torch.sqrt(torch.sum(M * M, dim=(0, 1))) + 1e-300
    total = log_scale + torch.log(nrm_last)
    return torch.exp(total / (2.0 ** n_squarings))


def bl_solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """Cyclic reduction: A/B/C [n,n,N], D [n,k,N] ->
    (X [n,n,N], M [n,k,N], ok bool [N]); X and M are zero where not ok."""
    n = A.shape[0]
    A0, A1, A2, Ah = A, B, C, B
    for _ in range(n_iter):
        SA = bl_gj_solve(A1, torch.cat([A0, A2], dim=1))
        SA0, SA2 = SA[:, :n], SA[:, n:]
        A2SA0 = bl_matmul(A2, SA0)
        Ah = Ah - A2SA0
        A1 = A1 - bl_matmul(A0, SA2) - A2SA0
        A0, A2 = -bl_matmul(A0, SA0), -bl_matmul(A2, SA2)
    X = -bl_gj_solve(Ah, A)
    lhs = B + bl_matmul(C, X)
    M = -bl_gj_solve(lhs, D)

    resid = A + bl_matmul(B, X) + bl_matmul(C, bl_matmul(X, X))
    scale = torch.clamp(_max_abs(A), min=1.0)
    converged = _max_abs(resid) < tol * scale
    stable = bl_spectral_radius_bound(X) < 1.0
    F = -bl_gj_solve(lhs, C)
    unique = bl_spectral_radius_bound(F) < 1.0
    finite = (torch.isfinite(X).all(dim=0).all(dim=0)
              & torch.isfinite(M).all(dim=0).all(dim=0))
    ok = converged & stable & unique & finite
    X = torch.where(ok, X, 0.0)
    M = torch.where(ok, M, 0.0)
    return X, M, ok


def bl_lyapunov_doubling(T, Q, n_iter: int = 30):
    """P = T P T' + Q by doubling, all [n,n,N]."""
    Ak, Pk = T, Q
    for _ in range(n_iter):
        Ak, Pk = (bl_matmul(Ak, Ak),
                  Pk + bl_matmul(Ak, bl_matmul(Pk, bl_transpose(Ak))))
    return Pk


def bl_kalman_loglike(T_mat, R_mat, Q, Z, d_obs, H, data, P0=None):
    """Riccati Kalman log-likelihood: system matrices [.,.,N], d_obs [n_o,N],
    data [n_o,T] shared -> loglh [N], from P0 [n_s,n_s,N] or the stationary
    covariance. The innovation solve is Gauss-Jordan (bl_psd_logdet_solve,
    log|det F|), so a step whose quad v'F^-1 v is negative marks the draw
    -inf, as does any non-finite total."""
    n_s, n_o, nb = T_mat.shape[0], Z.shape[0], T_mat.shape[-1]
    RQR = bl_matmul(R_mat, bl_matmul(Q, bl_transpose(R_mat)))
    P = bl_lyapunov_doubling(T_mat, RQR) if P0 is None else P0
    Tt, Zt = bl_transpose(T_mat), bl_transpose(Z)
    s = torch.zeros((n_s, nb), dtype=P.dtype, device=P.device)
    bad = torch.zeros(nb, dtype=torch.bool, device=P.device)
    total = torch.zeros(nb, dtype=P.dtype, device=P.device)
    ys = torch.as_tensor(data, dtype=P.dtype, device=P.device)
    for t in range(ys.shape[1]):
        s_pred = _bl_matvec(T_mat, s)
        P_pred = bl_matmul(bl_matmul(T_mat, P), Tt) + RQR
        v = ys[:, t, None] - (d_obs + _bl_matvec(Z, s_pred))
        F = _bl_sym(bl_matmul(bl_matmul(Z, P_pred), Zt) + H)
        sol, logdet = bl_psd_logdet_solve(F, torch.cat([v[:, None], Z], 1))
        quad = torch.sum(v * sol[:, 0], dim=0)
        total = total - 0.5 * (n_o * _LOG_2PI + logdet + quad)
        K = bl_matmul(P_pred, bl_transpose(sol[:, 1:]))      # [n_s, n_o]
        s = s_pred + _bl_matvec(K, v)
        P = _bl_sym(P_pred - bl_matmul(K, bl_matmul(Z, P_pred)))
        bad = bad | (quad < 0.0)
    return torch.where(torch.isfinite(total) & ~bad, total, float("-inf"))


def bl_kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data,
                                    P0=None):
    """Chandrasekhar Kalman log-likelihood: system matrices [.,.,N],
    d_obs [n_o,N], data [n_o,T] shared -> loglh [N], from P0 or the
    stationary covariance. The innovation solves are pivot-free
    (bl_psd_fast_solve: the cofactor form at n_o = 3, Cholesky otherwise).
    Divergence guards: quad < 0, diag(F) <= 0, or trace(F) growing past
    trace(F1) mark the draw -inf."""
    n_s, n_o = T_mat.shape[0], Z.shape[0]
    nb = T_mat.shape[-1]
    RQR = bl_matmul(R_mat, bl_matmul(Q, bl_transpose(R_mat)))
    if P0 is None:
        P0 = bl_lyapunov_doubling(T_mat, RQR)

    F = _bl_sym(bl_matmul(Z, bl_matmul(P0, bl_transpose(Z))) + H)
    K = bl_matmul(T_mat, bl_matmul(P0, bl_transpose(Z)))
    eye = torch.eye(n_o, dtype=F.dtype, device=F.device)[:, :, None]
    M1_neg, _ = bl_psd_fast_solve(F, eye.expand(n_o, n_o, nb))
    M = _bl_sym(-M1_neg)
    W = K
    s = torch.zeros((n_s, nb), dtype=F.dtype, device=F.device)
    tr_cap = torch.diagonal(F).sum(-1) * (1.0 + 1e-6) + 1e-12
    bad = torch.zeros(nb, dtype=torch.bool, device=F.device)
    total = torch.zeros(nb, dtype=F.dtype, device=F.device)

    ys = torch.as_tensor(data, dtype=F.dtype, device=F.device)
    for t in range(ys.shape[1]):
        v = ys[:, t, None] - d_obs - _bl_matvec(Z, s)
        ZW = bl_matmul(Z, W)
        sol, logdet = bl_psd_fast_solve(F, torch.cat([v[:, None], ZW], 1))
        Finv_v, Finv_ZW = sol[:, 0], sol[:, 1:]
        quad = torch.sum(v * Finv_v, dim=0)
        total = total - 0.5 * (n_o * _LOG_2PI + logdet + quad)
        s = _bl_matvec(T_mat, s) + _bl_matvec(K, Finv_v)

        MWtZt = bl_matmul(M, bl_transpose(ZW))
        WMWtZt = bl_matmul(W, MWtZt)
        F_new = _bl_sym(F + bl_matmul(Z, WMWtZt))
        K_new = K + bl_matmul(T_mat, WMWtZt)
        W = bl_matmul(T_mat, W) - bl_matmul(K, Finv_ZW)
        Fnew_inv_ZW, _ = bl_psd_fast_solve(F_new, ZW)
        M = _bl_sym(M - bl_matmul(MWtZt, bl_matmul(Fnew_inv_ZW, M)))
        diag_F = torch.diagonal(F_new)                       # [N, n_o]
        bad = (bad | (quad < 0.0) | (diag_F <= 0.0).any(dim=1)
               | (diag_F.sum(-1) > tr_cap))
        F, K = F_new, K_new
    return torch.where(torch.isfinite(total) & ~bad, total, float("-inf"))


def bl_dsge_loglike(A, B, C, D, Q, Z, d_obs, H, data,
                    use_chand_recursion: bool = True):
    """Plain composition: RE solve then the Chandrasekhar (or Riccati)
    filter; rejected draws -> -inf."""
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    kf = (bl_kalman_loglike_chandrasekhar if use_chand_recursion
          else bl_kalman_loglike)
    return torch.where(ok, kf(X, M, Q, Z, d_obs, H, data), float("-inf"))


# ---------------------------------------------------------------------------
# Per-particle functions: the batch-last ones at N = 1
# ---------------------------------------------------------------------------


def _n1(*xs):
    return [x[..., None] for x in xs]


def solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """A/B/C [n,n], D [n,k] -> (X [n,n], M [n,k], ok bool []); X and M are
    zero where not ok."""
    X, M, ok = bl_solve_linear_re(*_n1(A, B, C, D), n_iter=n_iter, tol=tol)
    return X[..., 0], M[..., 0], ok[0]


def lyapunov_doubling(T, Q, n_iter: int = 30):
    """P = T P T' + Q by doubling, T and Q [n,n]."""
    return bl_lyapunov_doubling(*_n1(T, Q), n_iter=n_iter)[..., 0]


def kalman_loglike(T_mat, R_mat, Q, Z, d_obs, H, data, P0=None):
    """Riccati Kalman log-likelihood of data [n_obs, T] under
    s_t = T s_{t-1} + R eta_t, eta ~ N(0, Q); y_t = d + Z s_t + u_t,
    u ~ N(0, H): a scalar, -inf for a diverging or non-finite filter."""
    P0 = None if P0 is None else P0[..., None]
    return bl_kalman_loglike(*_n1(T_mat, R_mat, Q, Z, d_obs, H), data,
                             P0=P0)[0]


def kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data,
                                 P0=None):
    """The same likelihood by the Chandrasekhar recursion (valid for a
    time-invariant system started from its stationary covariance)."""
    P0 = None if P0 is None else P0[..., None]
    return bl_kalman_loglike_chandrasekhar(*_n1(T_mat, R_mat, Q, Z, d_obs, H),
                                           data, P0=P0)[0]


class LinearDSGE:
    """A linear-RE DSGE given by batched maps from thetas [N, P]:
    system_fn -> (A, B, C, D), measurement_fn -> (d [n_o,N], Z, H),
    shock_cov_fn -> Q, every matrix batch-last [r, c, N] and contiguous.

    likelihood_backend "plain" (the default, as the JAX package's "xla" is
    its default) runs the bl_* functions above, Chandrasekhar or
    (use_chand_recursion=False) Riccati, for any shape: a model the JAX
    package's LinearDSGE takes with its defaults runs here unchanged.
    "kernel" goes through ops/cuda_dsge.py: the hand-written CUDA kernels
    for CUDA tensors, their plain versions for CPU tensors. It raises
    ValueError, on every device, outside the kernels' domain (n_obs 3,
    1 <= n_state <= 8, 1 <= n_shock <= 8, the TPU kernels' own) and for the
    Riccati filter; models in the domain pass it explicitly, as
    an_schorfheide() does. The JAX package's names are taken too: "pallas"
    is "kernel" and "xla" is "plain".

    Estimate a DSGE model with smc(model.loglike_batched, ...,
    batched=True). `loglike` evaluates one theta; it is not written for
    torch.func.vmap, which cannot trace the in-place writes of the system
    functions or bl_gj_solve's row swaps.

    `mesh` is taken as the JAX package's LinearDSGE takes it, where the
    Pallas kernels under a mesh need a shard_map. Here it changes nothing:
    under smc(..., mesh=...) each rank calls loglike_batched on its own
    particle rows, so the kernels launch per rank on the local batch, with
    no collective inside the likelihood."""

    def __init__(self, parameters: List, system_fn: Callable,
                 measurement_fn: Callable, n_shocks: int,
                 shock_cov_fn: Callable, use_chand_recursion: bool = True,
                 likelihood_backend: str = "plain", mesh=None):
        if likelihood_backend not in BACKENDS:
            raise ValueError("likelihood_backend must be one of "
                             f"{tuple(BACKENDS)}")
        likelihood_backend = BACKENDS[likelihood_backend]
        if likelihood_backend == "kernel" and not use_chand_recursion:
            raise ValueError("the kernels run the Chandrasekhar recursion; "
                             "the Riccati filter needs "
                             "likelihood_backend='plain'")
        self.parameters = parameters
        self.system_fn = system_fn
        self.measurement_fn = measurement_fn
        self.shock_cov_fn = shock_cov_fn
        self.n_shocks = n_shocks
        self.use_chand_recursion = use_chand_recursion
        self.likelihood_backend = likelihood_backend
        self.mesh = mesh
        self._data = DeviceCopies()     # the observations [n_o, T]

    def loglike_batched(self, thetas: torch.Tensor, data) -> torch.Tensor:
        """Whole-cloud likelihood thetas [N, P] -> loglh [N]."""
        thetas = thetas.to(torch.float64)
        A, B, C, D = self.system_fn(thetas)
        Q = self.shock_cov_fn(thetas)
        d_obs, Z, H = self.measurement_fn(thetas)
        y = self._data.get(data, thetas.device)
        if self.likelihood_backend == "plain":
            return bl_dsge_loglike(A, B, C, D, Q, Z, d_obs, H, y,
                                   self.use_chand_recursion)
        from smc_tpu_torch.ops.cuda_dsge import dsge_loglike
        return dsge_loglike(A, B, C, D, Q, Z, d_obs, H, y)

    def loglike(self, theta: torch.Tensor, data) -> torch.Tensor:
        """The likelihood of one theta [P] (loglike_batched at N = 1)."""
        return self.loglike_batched(theta[None], data)[0]

    def simulate(self, theta, T: int, draws, burn: int = 100) -> torch.Tensor:
        """Observables [n_obs, T] simulated at theta [P] on draws.device,
        after `burn` discarded periods. The shocks are
        draws.normal((T + burn, n_shocks)) times chol(Q)', so ReplayDraws can
        replay the JAX package's normals."""
        th = torch.as_tensor(theta, dtype=torch.float64,
                             device=draws.device)[None]
        X, M, _ = bl_solve_linear_re(*self.system_fn(th))
        X, M = X[..., 0], M[..., 0]
        chol_Q = torch.linalg.cholesky(self.shock_cov_fn(th)[..., 0])
        d_obs, Z, _ = self.measurement_fn(th)
        eps = draws.normal((T + burn, self.n_shocks)) @ chol_Q.T
        s = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        states = []
        for e in eps:
            s = X @ s + M @ e
            states.append(s)
        return d_obs[:, 0, None] + Z[..., 0] @ torch.stack(states[burn:], 1)


