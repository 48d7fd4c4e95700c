"""The plain An-Schorfheide likelihood: An and Schorfheide (2007),
"Bayesian Analysis of DSGE Models", the three-equation New Keynesian model
on output growth, inflation and the interest rate.

  IS:    y_t = E y_{t+1} + g_t - E g_{t+1} - (1/tau)(R_t - E pi_{t+1} - E z_{t+1})
  NKPC:  pi_t = beta E pi_{t+1} + kappa (y_t - g_t),  beta = 1/(1 + rA/400)
  MP:    R_t = rho_R R_{t-1} + (1 - rho_R)(psi1 pi_t + psi2 (y_t - g_t)) + eps_R
  g_t = rho_g g_{t-1} + eps_g,  z_t = rho_z z_{t-1} + eps_z
  YGR = gammaQ + 100 (y_t - y_{t-1} + z_t), INFL = piA + 400 pi_t,
  INT = piA + rA + 4 gammaQ + 400 R_t

State [y, pi, R, g, z, y_lag]; theta = (tau, kappa, psi1, psi2, rA, piA,
gammaQ, rho_R, rho_g, rho_z, sig_R, sig_g, sig_z). Every matrix is made in
the dtype of theta, batch-last [r, c, N]. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference import _linear_re

N_STATE, N_SHOCK, N_OBS = 6, 3, 3

# the priors and bounds of An and Schorfheide (2007), Table 2, as
# (name, family, p1, p2, lo, hi) of reference/prior.py
PRIORS = [
    ("tau", "gamma", 2.0, 0.5, 1e-5, 100.0),
    ("kappa", "uniform", 0.0, 1.0, 1e-8, 1.0),
    ("psi1", "gamma", 1.5, 0.25, 1e-8, 50.0),
    ("psi2", "gamma", 0.5, 0.25, 1e-8, 50.0),
    ("rA", "gamma", 0.5, 0.5, 1e-8, 50.0),
    ("piA", "gamma", 7.0, 2.0, 1e-8, 50.0),
    ("gammaQ", "normal", 0.4, 0.2, -5.0, 5.0),
    ("rho_R", "uniform", 0.0, 1.0, 1e-8, 0.99999),
    ("rho_g", "uniform", 0.0, 1.0, 1e-8, 0.99999),
    ("rho_z", "uniform", 0.0, 1.0, 1e-8, 0.99999),
    ("sig_R", "root_inv_gamma", 4.0, 0.4, 1e-8, 10.0),
    ("sig_g", "root_inv_gamma", 4.0, 1.0, 1e-8, 10.0),
    ("sig_z", "root_inv_gamma", 4.0, 0.5, 1e-8, 10.0),
]


def _zeros(r, c, th):
    return torch.zeros((r, c, th.shape[1]), dtype=th.dtype, device=th.device)


def inputs(thetas: torch.Tensor):
    """thetas [N, 13] -> (A, B, C, D, Q, Z, d, H), batch-last."""
    th = thetas.T
    tau, kappa, psi1, psi2, rA, piA, gammaQ = th[:7]
    rho_R, rho_g, rho_z = th[7], th[8], th[9]
    beta = 1.0 / (1.0 + rA / 400.0)
    A, B, C = (_zeros(N_STATE, N_STATE, th) for _ in range(3))
    D = _zeros(N_STATE, N_SHOCK, th)
    y, pi, R, g, z, ylag = range(N_STATE)
    B[0, y], B[0, g], B[0, R] = -1.0, 1.0, -1.0 / tau
    C[0, y], C[0, pi], C[0, g], C[0, z] = 1.0, 1.0 / tau, -1.0, 1.0 / tau
    B[1, pi], B[1, y], B[1, g] = -1.0, kappa, -kappa
    C[1, pi] = beta
    A[2, R], B[2, R] = rho_R, -1.0
    B[2, pi] = (1.0 - rho_R) * psi1
    B[2, y] = (1.0 - rho_R) * psi2
    B[2, g] = -(1.0 - rho_R) * psi2
    D[2, 0] = 1.0
    A[3, g], B[3, g], D[3, 1] = rho_g, -1.0, 1.0
    A[4, z], B[4, z], D[4, 2] = rho_z, -1.0, 1.0
    A[5, y], B[5, ylag] = 1.0, -1.0
    Q = _zeros(N_SHOCK, N_SHOCK, th)
    for i in range(N_SHOCK):
        Q[i, i] = th[10 + i] * th[10 + i]
    Z = _zeros(N_OBS, N_STATE, th)
    Z[0, y], Z[0, ylag], Z[0, z] = 100.0, -100.0, 100.0
    Z[1, pi] = 400.0
    Z[2, R] = 400.0
    d = torch.stack([gammaQ, piA, piA + rA + 4.0 * gammaQ])
    H = _zeros(N_OBS, N_OBS, th)
    for i in range(N_OBS):
        H[i, i] = 1e-10      # no measurement error; a jitter keeps F proper
    return A, B, C, D, Q, Z, d, H


def loglike(thetas: torch.Tensor, data) -> torch.Tensor:
    """log p(data | theta) per row of thetas [N, 13] -> [N]; -inf where the
    model has no unique stable solution or the filter diverges."""
    return _linear_re.loglike(*inputs(thetas), data)
