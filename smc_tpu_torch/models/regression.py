"""Two-parameter OLS regression (port of smc_tpu/models/regression.py):
y = alpha + beta x with known sigma^2, Normal(0, 10) priors. Its posterior
and evidence are closed-form, which makes it the exact oracle for whole
runs."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from smc_tpu_torch.distributions import Normal
from smc_tpu_torch.params import Parameter, parameter

_LOG_2PI = 1.8378770664093453


def regression_parameters() -> List[Parameter]:
    return [
        parameter("alpha1", 0.0, (-1e5, 1e5), prior=Normal(0, 10.0)),
        parameter("beta1", 0.0, (-1e5, 1e5), prior=Normal(0, 10.0)),
    ]


def generate_regression_data(n: int = 100, seed: int = 1793,
                             noise: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(y [1, n], x [n]) with alpha = beta = 1 (numpy, the JAX package's
    generator)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=n)
    y = 1.0 + 1.0 * x + (rng.standard_normal(n) if noise else 0.0)
    return y[None, :], x


def make_regression_loglike(x: np.ndarray, sigma2: float = 1.0):
    """loglike(theta, data) for theta [P] or a batch [N, P] (then [N])."""
    x64 = np.asarray(x, np.float64)

    def loglike(theta, data):
        y = torch.as_tensor(np.asarray(data, np.float64)[0],
                            device=theta.device)
        n = y.shape[0]
        xt = torch.as_tensor(x64[:n], device=theta.device)
        errors = y - theta[..., 0, None] - theta[..., 1, None] * xt
        return (-0.5 * n * (_LOG_2PI + math.log(sigma2))
                - 0.5 * torch.sum(errors * errors, dim=-1) / sigma2)

    return loglike
