"""Linear-regression test model (port of smc_tpu/models/linear.py): the
shared test fixture of the reference SMC package and the workload of the JAX
package's bench.py.

Three independent regressions y_i = alpha_i + beta_i x_i + eps_i,
eps ~ N(0, sigma_i^2), i = 1..3: nine parameters ordered
(alpha_1, beta_1, sigma_1, ..., alpha_3, beta_3, sigma_3) with
Normal(0, 1000) priors on alphas and betas and Uniform(0, 1000) on sigmas.
True values: alpha = beta = (1, 2, 3), sigma = 1.

The regime-switching variant gives each alpha_i and beta_i three regimes
(alpha_3 fixed in all of them; the betas get regime-specific priors) over
300 periods split into three 100-period regimes. Its likelihood uses the
"sigma" parameters as variances, as the reference fixture does.

The log-likelihoods are per-theta torch functions, total and free of Python
branches on tensor values, so `torch.func.vmap` batches them (`smc()` does
this unless batched=True). The data generators and the exact posterior are
numpy copies of the JAX package's, so they give the same bits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from smc_tpu_torch.distributions import Normal, Uniform
from smc_tpu_torch.params import Parameter, parameter, Untransformed, SquareRoot
from smc_tpu_torch.utils.misc import DeviceCopies

_LOG_2PI = 1.8378770664093453
_N_EQ = 3


def linear_parameters(regime_switching: bool = False) -> List[Parameter]:
    """The 9-parameter spec. With regime_switching=True, the 3-regime
    structure (prior scale 10 instead of 1000)."""
    prior_scale = 10.0 if regime_switching else 1000.0
    params: List[Parameter] = []
    for i in range(1, _N_EQ + 1):
        if regime_switching:
            # alpha_i: 3 regime values; alpha_3 fixed in every regime
            a_fixed = (i == 3)
            a_vals = {1: 3.0 if a_fixed else -0.1 * i,
                      2: 3.0 if a_fixed else 0.1 * i,
                      3: 3.0}
            params.append(parameter(
                f"alpha{i}", a_vals[1], (-1e5, 1e5),
                transform=Untransformed(), prior=Normal(0, prior_scale),
                fixed=a_fixed,
                regimes={"value": a_vals,
                         "fixed": {1: a_fixed, 2: a_fixed, 3: a_fixed}}))
            params.append(parameter(
                f"beta{i}", 0.2 * i, (-1e5, 1e5),
                transform=Untransformed(), prior=Normal(0, prior_scale),
                regimes={"value": {1: 0.2 * i, 2: -0.1 * i, 3: 0.1 * i},
                         "prior": {1: Normal(0, prior_scale),
                                   2: Normal(0, prior_scale * 1.2),
                                   3: Normal(0, prior_scale * 1.5)}}))
        else:
            params.append(parameter(
                f"alpha{i}", 0.0, (-1e5, 1e5), transform=Untransformed(),
                prior=Normal(0, prior_scale)))
            params.append(parameter(
                f"beta{i}", 0.0, (-1e5, 1e5), transform=Untransformed(),
                prior=Normal(0, prior_scale)))
        params.append(parameter(
            f"sigma{i}", 1.0, (1e-5, 1e5), transform=SquareRoot(),
            prior=Uniform(0, prior_scale)))
    return params


def rs_linear_parameters() -> List[Parameter]:
    return linear_parameters(regime_switching=True)


def generate_linear_data(seed: int = 1793, T: int = 100
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(data, X) [3, T]: y = beta x + alpha + eps with alpha = beta =
    (1, 2, 3), sigma = 1, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((_N_EQ, T))
    err = rng.standard_normal((_N_EQ, T))
    coef = np.arange(1, _N_EQ + 1, dtype=np.float64)[:, None]
    data = coef * X + coef + err
    return data, X


class _OnDevice:
    """A fixed array, and each data object the likelihood is called with
    (utils.misc.DeviceCopies), held on each device they are asked for."""

    def __init__(self, fixed: np.ndarray):
        self.fixed = np.asarray(fixed, np.float64)
        self._fixed = {}
        self._data = DeviceCopies()

    def get(self, data, device):
        if device not in self._fixed:
            self._fixed[device] = torch.as_tensor(self.fixed, device=device)
        return self._data.get(data, device), self._fixed[device]


def make_linear_loglike(X: np.ndarray):
    """Gaussian log-likelihood of theta [9] over data [3, T]; sigma <= 0
    gives -inf."""
    held = _OnDevice(X)

    def loglike(theta, data):
        d, Xt = held.get(data, theta.device)
        T = d.shape[1]
        alpha, beta, sigma = theta[0::3], theta[1::3], theta[2::3]
        var = sigma * sigma
        ok = torch.all(var > 0)
        var_safe = torch.where(var > 0, var, 1.0)
        errors = d - alpha[:, None] - beta[:, None] * Xt[:, :T]
        quad = torch.sum(errors * errors / var_safe[:, None])
        logdet = torch.sum(torch.log(var_safe))
        ll = T * (-0.5 * _N_EQ * _LOG_2PI - 0.5 * logdet) - 0.5 * quad
        return torch.where(ok, ll, float("-inf"))

    return loglike


def generate_rs_linear_data(seed: int = 1793, T_per_regime: int = 100
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(rsdata, Xrs) [3, 3 T_per_regime] with beta = (1, 2, 3) + r in regime
    r = 0, 1, 2 and alpha = (1, 2, 3) in all regimes."""
    rng = np.random.default_rng(seed + 1)
    T = 3 * T_per_regime
    Xrs = rng.standard_normal((_N_EQ, T))
    err = rng.standard_normal((_N_EQ, T))
    base = np.arange(1, _N_EQ + 1, dtype=np.float64)[:, None]
    data = np.empty_like(err)
    for r in range(3):
        sl = slice(r * T_per_regime, (r + 1) * T_per_regime)
        beta_r = base + r
        data[:, sl] = beta_r * Xrs[:, sl] + base + err[:, sl]
    return data, Xrs


def load_reference_data(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference package's own test data (its test/reference/
    test_data.h5). h5py reads the Julia (3, 100) matrices transposed, so
    transpose back. Returns (data [3, T], X [3, T])."""
    import h5py
    with h5py.File(path, "r") as f:
        data = f["data"][()].T
        X = f["X"][()].T
    return np.ascontiguousarray(data), np.ascontiguousarray(X)


def exact_linear_posterior(data: np.ndarray, X: np.ndarray,
                           prior_scale: float = 1000.0,
                           n_grid: int = 4000):
    """Exact posterior moments and log evidence of the linear fixture.

    The equations are independent; per equation, conditional on sigma the
    coefficient posterior is Gaussian in closed form, and the 1-D sigma
    marginal is integrated by quadrature on a log-spaced grid over
    U(0, prior_scale). Returns dict(mean [9], sd [9], log_evidence)."""
    n_eq, T = data.shape
    s0sq = prior_scale ** 2
    sig = np.exp(np.linspace(np.log(1e-3), np.log(prior_scale), n_grid))
    log_prior_sig = -np.log(prior_scale)
    means, sds, log_evs = [], [], []
    for i in range(n_eq):
        y = data[i]
        Xd = np.column_stack([np.ones(T), X[i]])
        XtX = Xd.T @ Xd
        Xty = Xd.T @ y
        yty = y @ y
        # log m(sigma) = log N(y; 0, sigma^2 I + s0^2 Xd Xd')
        lm = np.empty(n_grid)
        cond_mean = np.empty((n_grid, 2))
        cond_cov = np.empty((n_grid, 2, 2))
        for g, s in enumerate(sig):
            s2 = s * s
            prec = np.eye(2) / s0sq + XtX / s2
            cov = np.linalg.inv(prec)
            mu = cov @ (Xty / s2)
            sign, logdet_prec = np.linalg.slogdet(prec)
            lm[g] = (-0.5 * T * (np.log(2 * np.pi) + np.log(s2))
                     - 0.5 * (2 * np.log(s0sq) + logdet_prec)
                     - 0.5 * (yty / s2 - mu @ prec @ mu))
            cond_mean[g] = mu
            cond_cov[g] = cov
        lw = lm + log_prior_sig
        lw_max = lw.max()
        w = np.exp(lw - lw_max)
        Z = np.trapezoid(w, sig)
        log_ev = lw_max + np.log(Z)
        p_sig = w / Z
        mean_ab = np.trapezoid(p_sig[:, None] * cond_mean, sig, axis=0)
        mean_sig = np.trapezoid(p_sig * sig, sig)
        second_ab = np.trapezoid(
            p_sig[:, None, None]
            * (cond_cov + cond_mean[:, :, None] * cond_mean[:, None, :]),
            sig, axis=0)
        var_ab = np.diag(second_ab) - mean_ab ** 2
        var_sig = np.trapezoid(p_sig * sig * sig, sig) - mean_sig ** 2
        means.extend([mean_ab[0], mean_ab[1], mean_sig])
        sds.extend([np.sqrt(var_ab[0]), np.sqrt(var_ab[1]), np.sqrt(var_sig)])
        log_evs.append(log_ev)
    return {"mean": np.array(means), "sd": np.array(sds),
            "log_evidence": float(np.sum(log_evs))}


def make_rs_linear_loglike(Xrs: np.ndarray, space, T_per_regime: int = 100):
    """Regime-switching Gaussian log-likelihood of the flat theta, gathering
    each base parameter's regime-r value through space.regime_matrix().
    sigma (base columns 2, 5, 8) is used as the variance."""
    held = _OnDevice(Xrs)
    regmat = np.asarray(space.regime_matrix(), np.int64)  # [9, 3]
    index = {}

    def loglike(theta, data):
        d, Xt = held.get(data, theta.device)
        if theta.device not in index:
            index[theta.device] = (
                torch.as_tensor(regmat, device=theta.device),
                torch.tensor([2, 5, 8], device=theta.device))
        reg, sig_cols = index[theta.device]
        per_regime = theta[reg]                  # [9, 3] values by regime
        alpha = per_regime[0::3, :]              # [3 eq, 3 regimes]
        beta = per_regime[1::3, :]
        var = theta[sig_cols]
        ok = torch.all(var > 0)
        var_safe = torch.where(var > 0, var, 1.0)
        ll = 0.0
        for r in range(3):
            sl = slice(r * T_per_regime, (r + 1) * T_per_regime)
            errors = (d[:, sl] - alpha[:, r][:, None]
                      - beta[:, r][:, None] * Xt[:, sl])
            quad = torch.sum(errors * errors / var_safe[:, None])
            ll = ll + (T_per_regime * (-0.5 * _N_EQ * _LOG_2PI
                                       - 0.5 * torch.sum(torch.log(var_safe)))
                       - 0.5 * quad)
        return torch.where(ok, ll, float("-inf"))

    return loglike
