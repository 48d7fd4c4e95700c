"""The plain prior of a configuration: each estimated parameter's family in
its published form and its bounds, as reference/<config>.py states them in
`PRIORS`, a list of (name, family, p1, p2, lo, hi):

  normal        p1 mean, p2 sd
  uniform       p1 lower, p2 upper end
  gamma         p1 mean, p2 sd
  beta          p1 mean, p2 sd
  root_inv_gamma  p1 nu, p2 tau: nu tau^2 / sigma^2 ~ chi2(nu)

The density is the families' product inside the bounds and 0 outside;
draws are the families' own (outside the bounds they get density 0 and are
drawn again). The density is computed in the dtype of theta; draws are
float64, on the device asked for, from torch's global generator, seeded by
the caller. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def _gamma_shape_scale(mean, sd):
    return (mean / sd) ** 2, sd * sd / mean


def _beta_ab(mean, sd):
    nu = mean * (1.0 - mean) / (sd * sd) - 1.0
    return mean * nu, (1.0 - mean) * nu


def _logpdf(family, p1, p2, x):
    if family == "normal":
        z = (x - p1) / p2
        return -0.5 * z * z - math.log(p2) - 0.5 * math.log(2.0 * math.pi)
    if family == "uniform":
        return torch.full_like(x, -math.log(p2 - p1))
    xs = x.clamp(min=1e-300)
    if family == "gamma":
        k, s = _gamma_shape_scale(p1, p2)
        return ((k - 1.0) * torch.log(xs) - xs / s - math.lgamma(k)
                - k * math.log(s))
    if family == "beta":
        a, b = _beta_ab(p1, p2)
        xs = x.clamp(1e-300, 1.0 - 1e-16)
        return ((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs)
                - (math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)))
    if family == "root_inv_gamma":
        h = 0.5 * p1
        return (math.log(2.0) + h * math.log(h * p2 * p2) - math.lgamma(h)
                - (p1 + 1.0) * torch.log(xs) - h * p2 * p2 / (xs * xs))
    raise ValueError(f"unknown prior family {family!r}")


def log_prior(priors, theta: torch.Tensor) -> torch.Tensor:
    """log p(theta) per row of theta [N, P] -> [N]; -inf outside the
    bounds."""
    total = torch.zeros(theta.shape[0], dtype=theta.dtype,
                        device=theta.device)
    inside = torch.ones(theta.shape[0], dtype=torch.bool, device=theta.device)
    for j, (_, family, p1, p2, lo, hi) in enumerate(priors):
        x = theta[:, j]
        inside &= (x >= lo) & (x <= hi)
        total = total + _logpdf(family, p1, p2, x)
    return torch.where(inside & torch.isfinite(total), total, -math.inf)


def _sample(family, p1, p2, n, device):
    dtype = torch.float64

    def gamma(shape):
        k = torch.full((n,), float(shape), dtype=dtype, device=device)
        return torch._standard_gamma(k)

    if family == "normal":
        return p1 + p2 * torch.randn(n, dtype=dtype, device=device)
    if family == "uniform":
        return p1 + (p2 - p1) * torch.rand(n, dtype=dtype, device=device)
    if family == "gamma":
        k, s = _gamma_shape_scale(p1, p2)
        return s * gamma(k)
    if family == "beta":
        a, b = _beta_ab(p1, p2)
        ga, gb = gamma(a), gamma(b)
        return ga / (ga + gb)
    if family == "root_inv_gamma":
        chi2 = 2.0 * gamma(0.5 * p1)
        return p2 * torch.sqrt(p1 / chi2.clamp(min=1e-300))
    raise ValueError(f"unknown prior family {family!r}")


def sample(priors, n: int, device="cpu") -> torch.Tensor:
    """n float64 draws [n, P] of the families (bounds not applied)."""
    return torch.stack([_sample(f, p1, p2, n, device)
                        for _, f, p1, p2, _, _ in priors], dim=1)
