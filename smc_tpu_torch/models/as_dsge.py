"""An-Schorfheide 3-equation New Keynesian DSGE (port of
smc_tpu/models/as_dsge.py).

  IS:    y_t = E[y_{t+1}] + g_t - E[g_{t+1}] - (1/tau)(R_t - E[pi_{t+1}] - E[z_{t+1}])
  NKPC:  pi_t = beta E[pi_{t+1}] + kappa (y_t - g_t)
  MP:    R_t = rho_R R_{t-1} + (1 - rho_R)(psi1 pi_t + psi2 (y_t - g_t)) + eps_R
  g_t = rho_g g_{t-1} + eps_g ;  z_t = rho_z z_{t-1} + eps_z ;  beta = 1/(1 + rA/400)

Observables YGR = gammaQ + 100 (y_t - y_{t-1} + z_t), INFL = piA + 400 pi_t,
INT = piA + rA + 4 gammaQ + 400 R_t. State x = [y, pi, R, g, z, y_lag].

The system matrices are built batch-last [r, c, N] and contiguous directly
from thetas [N, P], the layout the likelihood kernels read.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from smc_tpu_torch.distributions import Gamma, Uniform, Normal, RootInverseGamma
from smc_tpu_torch.params import Parameter, parameter
from smc_tpu_torch.models.dsge import LinearDSGE

PARAM_NAMES = ["tau", "kappa", "psi1", "psi2", "rA", "piA", "gammaQ",
               "rho_R", "rho_g", "rho_z", "sig_R", "sig_g", "sig_z"]

TRUE_PARAMS = np.array([2.0, 0.33, 1.5, 0.125, 1.0, 3.2, 0.55,
                        0.75, 0.95, 0.9, 0.2, 0.6, 0.18])

_N_STATE = 6   # [y, pi, R, g, z, y_lag]
_N_SHOCK = 3   # [eps_R, eps_g, eps_z]
_N_OBS = 3

_DATA_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                          "as_T80_seed1793.npy")


def _gamma_ms(mean, std):
    """Gamma prior from (mean, std) -> Gamma(shape, scale)."""
    return Gamma((mean / std) ** 2, std * std / mean)


def an_schorfheide_parameters() -> List[Parameter]:
    return [
        parameter("tau", 2.0, (1e-5, 100.0), prior=_gamma_ms(2.0, 0.5)),
        parameter("kappa", 0.33, (1e-8, 1.0), prior=Uniform(0.0, 1.0)),
        parameter("psi1", 1.5, (1e-8, 50.0), prior=_gamma_ms(1.5, 0.25)),
        parameter("psi2", 0.125, (1e-8, 50.0), prior=_gamma_ms(0.5, 0.25)),
        parameter("rA", 1.0, (1e-8, 50.0), prior=_gamma_ms(0.5, 0.5)),
        parameter("piA", 3.2, (1e-8, 50.0), prior=_gamma_ms(7.0, 2.0)),
        parameter("gammaQ", 0.55, (-5.0, 5.0), prior=Normal(0.4, 0.2)),
        parameter("rho_R", 0.75, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("rho_g", 0.95, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("rho_z", 0.9, (1e-8, 0.99999), prior=Uniform(0.0, 1.0)),
        parameter("sig_R", 0.2, (1e-8, 10.0), prior=RootInverseGamma(4.0, 0.4)),
        parameter("sig_g", 0.6, (1e-8, 10.0), prior=RootInverseGamma(4.0, 1.0)),
        parameter("sig_z", 0.18, (1e-8, 10.0), prior=RootInverseGamma(4.0, 0.5)),
    ]


def _zeros(r, c, thetas):
    return torch.zeros((r, c, thetas.shape[0]), dtype=torch.float64,
                       device=thetas.device)


def _system(thetas: torch.Tensor):
    """thetas [N, P] -> (A, B, C, D) batch-last, with
    A x_{t-1} + B x_t + C E x_{t+1} + D eps = 0."""
    th = thetas.T                                         # [P, N]
    tau, kappa, psi1, psi2, rA = th[0], th[1], th[2], th[3], th[4]
    rho_R, rho_g, rho_z = th[7], th[8], th[9]
    beta = 1.0 / (1.0 + rA / 400.0)
    inv_tau = 1.0 / tau
    A = _zeros(_N_STATE, _N_STATE, thetas)
    B = _zeros(_N_STATE, _N_STATE, thetas)
    C = _zeros(_N_STATE, _N_STATE, thetas)
    D = _zeros(_N_STATE, _N_SHOCK, thetas)
    y, pi, R, g, z, ylag = range(_N_STATE)
    eR, eg, ez = range(_N_SHOCK)
    # IS
    B[0, y], B[0, g], B[0, R] = -1.0, 1.0, -inv_tau
    C[0, y], C[0, pi], C[0, g], C[0, z] = 1.0, inv_tau, -1.0, inv_tau
    # NKPC
    B[1, pi], B[1, y], B[1, g] = -1.0, kappa, -kappa
    C[1, pi] = beta
    # MP rule
    A[2, R] = rho_R
    B[2, R] = -1.0
    B[2, pi] = (1.0 - rho_R) * psi1
    B[2, y] = (1.0 - rho_R) * psi2
    B[2, g] = -(1.0 - rho_R) * psi2
    D[2, eR] = 1.0
    # g, z AR(1)
    A[3, g], B[3, g], D[3, eg] = rho_g, -1.0, 1.0
    A[4, z], B[4, z], D[4, ez] = rho_z, -1.0, 1.0
    # y_lag bookkeeping
    A[5, y], B[5, ylag] = 1.0, -1.0
    return A, B, C, D


def _measurement(thetas: torch.Tensor):
    """thetas [N, P] -> (d [3, N], Z [3, 6, N], H [3, 3, N])."""
    th = thetas.T
    rA, piA, gammaQ = th[4], th[5], th[6]
    y, pi, R, g, z, ylag = range(_N_STATE)
    Z = _zeros(_N_OBS, _N_STATE, thetas)
    Z[0, y], Z[0, ylag], Z[0, z] = 100.0, -100.0, 100.0
    Z[1, pi] = 400.0
    Z[2, R] = 400.0
    d = torch.stack([gammaQ, piA, piA + rA + 4.0 * gammaQ]).contiguous()
    # no measurement error in AS; a tiny jitter keeps F well-posed
    H = _zeros(_N_OBS, _N_OBS, thetas)
    for i in range(_N_OBS):
        H[i, i] = 1e-10
    return d, Z, H


def _shock_cov(thetas: torch.Tensor):
    """thetas [N, P] -> Q = diag(sig^2) [3, 3, N]."""
    sig = thetas.T[10:13]
    Q = _zeros(_N_SHOCK, _N_SHOCK, thetas)
    for i in range(_N_SHOCK):
        Q[i, i] = sig[i] * sig[i]
    return Q


def an_schorfheide(likelihood_backend: str = "kernel",
                   mesh=None) -> LinearDSGE:
    """AS with the CUDA kernels ("kernel", or the JAX package's "pallas")
    or the "plain" backend ("xla": on a card the same kernels, AS's shape
    lying in their domain, on the CPU the bl_* functions); `mesh` as
    LinearDSGE takes it
    (the kernels run per rank either way)."""
    return LinearDSGE(an_schorfheide_parameters(), _system, _measurement,
                      _N_SHOCK, _shock_cov,
                      likelihood_backend=likelihood_backend, mesh=mesh)


def _measurement_2obs(thetas: torch.Tensor):
    """Output growth and inflation only (the policy rate dropped): the
    n_obs = 2 innovation path (Cholesky; the cofactor form is 3x3 only)."""
    d, Z, H = _measurement(thetas)
    return d[:2].contiguous(), Z[:2].contiguous(), H[:2, :2].contiguous()


def an_schorfheide_2obs() -> LinearDSGE:
    """An-Schorfheide with 2 observables, on the "plain" backend (the JAX
    package's "xla"; the "kernel" backend's kernels serve n_obs = 3 only):
    on a CUDA tensor the general-shape CUDA kernels
    (ops/cuda_dsge_general.py), on a CPU tensor the plain PyTorch bl_*
    functions."""
    return LinearDSGE(an_schorfheide_parameters(), _system,
                      _measurement_2obs, _N_SHOCK, _shock_cov,
                      likelihood_backend="plain")


def generate_as_data(T: int = 80, seed: int = 1793,
                     theta: np.ndarray = TRUE_PARAMS,
                     device="cuda") -> np.ndarray:
    """Observables [3, T] simulated at `theta`, shocks from
    TorchDraws(seed, device). This is torch's stream, not the JAX
    package's: its generate_as_data(T=80, seed=1793) is `load_as_data()`."""
    from smc_tpu_torch.rng import TorchDraws
    model = an_schorfheide(likelihood_backend="plain")
    obs = model.simulate(theta, T, TorchDraws(seed, device))
    return obs.cpu().numpy()


def load_as_data() -> np.ndarray:
    """The AS observables [3, 80]: the JAX package's
    generate_as_data(T=80, seed=1793), committed as an array (its simulator
    draws from JAX's PRNG, which torch cannot reproduce)."""
    return np.load(_DATA_FILE)
