"""Prior distribution families (port of smc_tpu/distributions.py).

Every family is parameterized by two scalars (a, b) and has a *total* logpdf:
finite or -inf, never nan, never raising. Conventions follow Distributions.jl:

  Normal(mu, sigma)           sigma is the standard deviation
  Uniform(a, b)
  Gamma(shape, scale)
  Beta(alpha, beta)
  InverseGamma(shape, scale)  pdf ~ x^-(shape+1) exp(-scale/x)
  RootInverseGamma(nu, tau)   nu tau^2 / sigma^2 ~ chi2(nu)
  TruncatedNormal(mu, sigma)  bounds come from the parameter (params.py)

Sampling draws through the draws interface (rng.py): gamma variates from
`standard_gamma`, beta as a ratio of two gammas.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FAMILY_CODES = {
    "point": 0,
    "normal": 1,
    "uniform": 2,
    "gamma": 3,
    "beta": 4,
    "inverse_gamma": 5,
    "root_inverse_gamma": 6,
    "truncated_normal": 7,
}

_LOG_2PI = 1.8378770664093453
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class Distribution:
    """One scalar prior; `a`, `b` are the two family parameters."""

    family: str
    a: float
    b: float

    @property
    def code(self) -> int:
        return FAMILY_CODES[self.family]

    def logpdf(self, x) -> torch.Tensor:
        return logpdf_family(self.code, self.a, self.b, x)

    def sample(self, draws, shape=()) -> torch.Tensor:
        """Draws of `shape` through the draws interface, on its device."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        n = math.prod(shape)
        out = sample_family(np.array([self.code]), np.array([self.a]),
                            np.array([self.b]), draws, n, device=draws.device)
        return out.reshape(shape)

    def mean(self) -> float:
        a, b = self.a, self.b
        if self.family in ("normal", "truncated_normal"):
            return a
        if self.family == "uniform":
            return (a + b) / 2.0
        if self.family == "gamma":
            return a * b
        if self.family == "beta":
            return a / (a + b)
        if self.family == "inverse_gamma":
            return b / (a - 1.0) if a > 1 else np.nan
        if self.family == "root_inverse_gamma":
            # E[sigma] for nu tau^2 / sigma^2 ~ chi2(nu)
            nu, tau = a, b
            if nu > 1:
                return (math.sqrt(nu * tau ** 2 / 2.0)
                        * math.gamma((nu - 1) / 2.0) / math.gamma(nu / 2.0))
            return np.nan
        return np.nan


def Normal(mu: float, sigma: float) -> Distribution:
    return Distribution("normal", float(mu), float(sigma))


def Uniform(a: float, b: float) -> Distribution:
    return Distribution("uniform", float(a), float(b))


def Gamma(shape: float, scale: float) -> Distribution:
    return Distribution("gamma", float(shape), float(scale))


def Beta(alpha: float, beta: float) -> Distribution:
    return Distribution("beta", float(alpha), float(beta))


def InverseGamma(shape: float, scale: float) -> Distribution:
    return Distribution("inverse_gamma", float(shape), float(scale))


def RootInverseGamma(nu: float, tau: float) -> Distribution:
    return Distribution("root_inverse_gamma", float(nu), float(tau))


def TruncatedNormal(mu: float, sigma: float) -> Distribution:
    return Distribution("truncated_normal", float(mu), float(sigma))


def Point() -> Distribution:
    return Distribution("point", 0.0, 0.0)


def _normal_logpdf(mu, sigma, x):
    z = (x - mu) / sigma
    return -0.5 * (_LOG_2PI + z * z) - torch.log(sigma)


def _uniform_logpdf(a, b, x):
    inside = (x >= a) & (x <= b)
    return torch.where(inside, -torch.log(b - a), _NEG_INF)


def _gamma_logpdf(shape, scale, x):
    ok = x > 0
    xs = torch.where(ok, x, 1.0)
    lp = ((shape - 1.0) * torch.log(xs) - xs / scale
          - torch.lgamma(shape) - shape * torch.log(scale))
    return torch.where(ok, lp, _NEG_INF)


def _beta_logpdf(alpha, beta, x):
    ok = (x > 0) & (x < 1)
    xs = torch.where(ok, x, 0.5)
    betaln = (torch.lgamma(alpha) + torch.lgamma(beta)
              - torch.lgamma(alpha + beta))
    lp = (alpha - 1.0) * torch.log(xs) + (beta - 1.0) * torch.log1p(-xs) - betaln
    return torch.where(ok, lp, _NEG_INF)


def _inverse_gamma_logpdf(shape, scale, x):
    ok = x > 0
    xs = torch.where(ok, x, 1.0)
    lp = (shape * torch.log(scale) - torch.lgamma(shape)
          - (shape + 1.0) * torch.log(xs) - scale / xs)
    return torch.where(ok, lp, _NEG_INF)


def _root_inverse_gamma_logpdf(nu, tau, x):
    ok = x > 0
    xs = torch.where(ok, x, 1.0)
    half_nu = 0.5 * nu
    lp = (math.log(2.0) + half_nu * torch.log(half_nu * tau * tau)
          - torch.lgamma(half_nu)
          - (nu + 1.0) * torch.log(xs)
          - half_nu * tau * tau / (xs * xs))
    return torch.where(ok, lp, _NEG_INF)


class DegenerateMvNormal:
    """Multivariate normal that tolerates a rank-deficient covariance.

    logpdf uses the eigendecomposition pseudo-inverse: directions with
    (near-)zero eigenvalue contribute neither to the quadratic form nor the
    log-determinant, and the rank replaces the dimension in the
    normalization. `rand` draws in the span of the kept eigenvectors, with
    the normals taken from a draws object."""

    def __init__(self, mu, sigma, tol: float = 1e-12, device="cuda"):
        self.mu = torch.as_tensor(mu, dtype=torch.float64, device=device)
        self.sigma = torch.as_tensor(sigma, dtype=torch.float64,
                                     device=self.mu.device)
        lam, U = torch.linalg.eigh(self.sigma)
        lam_max = torch.clamp(torch.max(lam), min=0.0)
        keep = lam > tol * torch.clamp(lam_max, min=1e-300)
        safe = torch.where(keep, lam, 1.0)
        self._U = U
        self._sqrt_lam = torch.where(keep, torch.sqrt(safe), 0.0)
        self._inv_lam = torch.where(keep, 1.0 / safe, 0.0)
        self.rank = keep.sum().to(torch.float64)
        self._logdet = torch.sum(torch.where(keep, torch.log(safe), 0.0))

    def logpdf(self, x) -> torch.Tensor:
        diff = torch.as_tensor(x, dtype=torch.float64,
                               device=self.mu.device) - self.mu
        z = diff @ self._U
        quad = torch.sum(z * z * self._inv_lam, dim=-1)
        return -0.5 * (self.rank * _LOG_2PI + self._logdet + quad)

    def rand(self, draws, shape=()) -> torch.Tensor:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        eps = draws.normal(shape + tuple(self.mu.shape))
        return self.mu + (eps * self._sqrt_lam) @ self._U.T

    sample = rand

    def cov(self) -> torch.Tensor:
        return self.sigma


def get_cov(d):
    """Covariance of a DegenerateMvNormal or anything exposing .cov()/.sigma."""
    if hasattr(d, "cov"):
        c = d.cov
        return c() if callable(c) else c
    return d.sigma


_LOGPDFS = {
    FAMILY_CODES["normal"]: _normal_logpdf,
    FAMILY_CODES["uniform"]: _uniform_logpdf,
    FAMILY_CODES["gamma"]: _gamma_logpdf,
    FAMILY_CODES["beta"]: _beta_logpdf,
    FAMILY_CODES["inverse_gamma"]: _inverse_gamma_logpdf,
    FAMILY_CODES["root_inverse_gamma"]: _root_inverse_gamma_logpdf,
    FAMILY_CODES["truncated_normal"]: _normal_logpdf,
}


def logpdf_family(code, a, b, x):
    """Total logpdf dispatched on integer family `code` (tensors, broadcast
    against x [..., P]). Point masses contribute 0; an unknown code gives
    -inf. `truncated_normal` is the plain normal here: ParamSpace applies the
    truncation constant and the support mask, since it owns the bounds."""
    x = torch.as_tensor(x, dtype=torch.float64)
    code = torch.as_tensor(code, device=x.device)
    a = torch.as_tensor(a, dtype=torch.float64, device=x.device)
    b = torch.as_tensor(b, dtype=torch.float64, device=x.device)
    out = torch.full_like(x, _NEG_INF)
    out = torch.where(code == FAMILY_CODES["point"], 0.0, out)
    for c, fn in _LOGPDFS.items():
        out = torch.where(code == c, fn(a, b, x), out)
    return out


def sample_family(code, a, b, draws, n: int, device="cuda") -> torch.Tensor:
    """n draws per column from the stacked priors: `code`, `a`, `b` are host
    arrays of length P. Returns f64 [n, P]; point columns are 0.

    Only the families present are drawn, each once for all of its columns,
    in the fixed order normal, uniform, gamma, beta, inverse gamma, root
    inverse gamma, truncated normal (the order a ReplayDraws must follow)."""
    code = np.asarray(code)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = torch.zeros((n, code.shape[0]), dtype=torch.float64, device=device)

    def cols(name):
        idx = np.nonzero(code == FAMILY_CODES[name])[0]
        if idx.size == 0:
            return None
        t = lambda v: torch.as_tensor(v[idx], dtype=torch.float64,
                                      device=device)
        return torch.as_tensor(idx, device=device), t(a), t(b)

    def gamma(shape_par):  # Gamma(shape, 1), one per [n, k] entry
        alpha = torch.clamp(shape_par, min=1e-12).expand(n, -1).contiguous()
        return draws.standard_gamma(alpha)

    for name in ("normal", "uniform", "gamma", "beta", "inverse_gamma",
                 "root_inverse_gamma", "truncated_normal"):
        c = cols(name)
        if c is None:
            continue
        idx, ca, cb = c
        k = idx.numel()
        if name in ("normal", "truncated_normal"):
            val = ca + cb * draws.normal((n, k))
        elif name == "uniform":
            val = ca + (cb - ca) * draws.uniform((n, k))
        elif name == "gamma":
            val = cb * gamma(ca)
        elif name == "beta":
            ga = gamma(ca)
            gb = gamma(cb)
            val = ga / (ga + gb)
        elif name == "inverse_gamma":
            val = cb / torch.clamp(gamma(ca), min=1e-300)
        else:  # root inverse gamma: sigma = tau sqrt(nu / chi2_nu)
            chi2 = 2.0 * gamma(ca / 2.0)
            val = cb * torch.sqrt(ca / torch.clamp(chi2, min=1e-300))
        out.index_copy_(1, idx, val)
    return out
