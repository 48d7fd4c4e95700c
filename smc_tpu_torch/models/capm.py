"""Single-factor CAPM (port of smc_tpu/models/capm.py; the reference's
examples/capm_model/estimate_capm.jl): R_it = alpha_i + beta_i R_Mt + eps_it,
eps ~ N(0, sigma_i^2), for 3 assets; 9 parameters (alpha_i, beta_i,
sigma_i) with the linear fixture's priors.

As in the JAX package, the likelihood is the model the reference example's
comments describe (alpha from slot 1, beta from slot 2, per-period errors),
not its code's slot quirk. The log-likelihood is a per-theta torch function
that torch.func.vmap batches, like `make_linear_loglike`; the data
generator is a numpy copy of the JAX package's, so it gives the same bits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from smc_tpu_torch.distributions import Normal, Uniform
from smc_tpu_torch.params import Parameter, parameter, Untransformed, SquareRoot
from smc_tpu_torch.models.linear import _OnDevice

_LOG_2PI = 1.8378770664093453
_N_ASSETS = 3


def capm_parameters() -> List[Parameter]:
    params: List[Parameter] = []
    for i in range(1, _N_ASSETS + 1):
        params.append(parameter(f"alpha{i}", 0.0, (-1e5, 1e5),
                                transform=Untransformed(),
                                prior=Normal(0, 1e3)))
        params.append(parameter(f"beta{i}", 0.0, (-1e5, 1e5),
                                transform=Untransformed(),
                                prior=Normal(0, 1e3)))
        params.append(parameter(f"sigma{i}", 1.0, (1e-5, 1e5),
                                transform=SquareRoot(),
                                prior=Uniform(0, 1e3)))
    return params


def generate_capm_data(T: int = 200, seed: int = 1793
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(lik_data [3, T] asset returns, market_data [T]) with alpha =
    (0.1, 0.2, 0.3), beta = (0.8, 1.0, 1.2), sigma = 0.5."""
    rng = np.random.default_rng(seed)
    market = rng.standard_normal(T) * 2.0 + 0.5
    alpha = np.array([0.1, 0.2, 0.3])[:, None]
    beta = np.array([0.8, 1.0, 1.2])[:, None]
    data = alpha + beta * market[None, :] + 0.5 * rng.standard_normal((3, T))
    return data, market


def load_reference_capm_data(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's CAPM dataset (its examples/data/capm.jld2, loaded by
    estimate_capm.jl): 3 asset return series and the market return over 36
    periods. JLD2 is HDF5 underneath. Returns (lik_data [3, T],
    market_data [T])."""
    import h5py
    with h5py.File(path, "r") as f:
        lik = f["lik_data"][()]      # stored (36, 3) -> Julia (3, 36)
        mkt = f["market_data"][()]   # stored (36, 1) -> Julia (1, 36)
    return np.ascontiguousarray(lik.T), np.ascontiguousarray(mkt.T[0])


def make_capm_loglike(market_data: np.ndarray):
    """Gaussian log-likelihood of theta [9] over data [3, T]; sigma <= 0
    gives -inf."""
    held = _OnDevice(market_data)

    def loglike(theta, data):
        d, m = held.get(data, theta.device)
        T = d.shape[1]
        alpha, beta, sigma = theta[0::3], theta[1::3], theta[2::3]
        var = sigma * sigma
        ok = torch.all(var > 0)
        var_safe = torch.where(var > 0, var, 1.0)
        errors = d - alpha[:, None] - beta[:, None] * m[None, :T]
        quad = torch.sum(errors * errors / var_safe[:, None])
        ll = (T * (-0.5 * _N_ASSETS * _LOG_2PI
                   - 0.5 * torch.sum(torch.log(var_safe))) - 0.5 * quad)
        return torch.where(ok, ll, float("-inf"))

    return loglike
