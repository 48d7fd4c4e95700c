"""A plain tempered SMC estimation (Herbst and Schorfheide 2014), the
yardstick of the posterior and the log marginal data density that the
program's estimations return. It imports nothing of the program: the prior
is reference/prior.py's, the likelihood reference/<config>.py's, the
algorithm written out here from the paper.

  * N draws from the prior, those outside the bounds or with a likelihood
    that is not finite drawn again;
  * the fixed schedule phi_n = ((n - 1)/(n_phi - 1))^lambda;
  * at each stage the correction W_n ~ W_{n-1} exp((phi_n - phi_{n-1}) l),
    the log-MDD's term log(sum W_{n-1} w_n / N), resampling (multinomial
    or systematic) where the ESS falls below threshold_ratio N, and
    n_mh_steps sweeps of random-walk Metropolis-Hastings over n_blocks
    random blocks, each proposal from the mixture
      alpha N(theta_b, c^2 S_b) + (1-alpha)/2 N(theta_b, c^2 diag S_b)
        + (1-alpha)/2 N(mean_b, c^2 S_b)
    (S the weighted covariance of the cloud), with c adapted to a 25%
    acceptance: c <- c (0.95 + 0.10 sigmoid(16 (acceptance - 0.25))).

`estimate` returns the posterior mean and sd of the final weighted cloud
and the log-MDD. perfbench/posterior.py runs it on a card to write
posteriors/<config>.json.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import prior

TARGET, C0 = 0.25, 0.5
BLOCK, MAX_ROUNDS = 4096, 1000     # likelihood rows a call; redraw rounds
F64 = torch.float64


def _loglike(reference, theta, y):
    return torch.cat([reference.loglike(theta[i:i + BLOCK], y)
                      for i in range(0, theta.shape[0], BLOCK)])


def _evaluate(reference, theta, y):
    lp = prior.log_prior(reference.PRIORS, theta)
    ll = torch.full_like(lp, -math.inf)
    ok = torch.isfinite(lp)
    if ok.any():
        ll[ok] = _loglike(reference, theta[ok], y)
    ll = torch.where(torch.isfinite(ll), ll, -math.inf)
    return ll, lp


def _resample(weights, method):
    n = weights.shape[0]
    p = weights / weights.sum()
    if method == "multinomial":
        return torch.multinomial(p, n, replacement=True)
    cdf = torch.cumsum(p, 0)
    u = (torch.rand((), dtype=p.dtype, device=p.device)
         + torch.arange(n, dtype=p.dtype, device=p.device)) / n
    return torch.searchsorted(cdf, u).clamp(max=n - 1)


def _mvn_logpdf(x, mean, chol):
    """log N(x; mean, L L') per row, L lower triangular."""
    z = torch.linalg.solve_triangular(chol, (x - mean).T, upper=False)
    k = x.shape[1]
    return (-0.5 * (z * z).sum(0) - torch.log(torch.diagonal(chol)).sum()
            - 0.5 * k * math.log(2.0 * math.pi))


def _block_chol(cov):
    k = cov.shape[0]
    jitter = 1e-12 * float(torch.diagonal(cov).mean()) + 1e-300
    eye = torch.eye(k, dtype=cov.dtype, device=cov.device)
    for _ in range(20):
        L, info = torch.linalg.cholesky_ex(cov + jitter * eye)
        if int(info) == 0:
            return L
        jitter *= 10.0
    raise RuntimeError("the cloud's covariance is not positive definite")


def _mixture_logq(x, y, mean, L, Ld, alpha):
    """log q(x | y): the proposal mixture's density at x from y."""
    terms = [math.log(alpha) + _mvn_logpdf(x, y, L)]
    if alpha < 1.0:
        rest = math.log(0.5 * (1.0 - alpha))
        terms += [rest + _mvn_logpdf(x, y, Ld),
                  rest + _mvn_logpdf(x, mean[None], L)]
    return torch.logsumexp(torch.stack(terms), 0)


def _mutate(reference, y, theta, ll, lp, weights, phi, c, smc):
    n, p = theta.shape
    alpha = float(smc["alpha"])
    wn = weights / weights.sum()
    mean = wn @ theta
    dev = theta - mean
    cov = (dev * wn[:, None]).T @ dev
    cov = 0.5 * (cov + cov.T)
    moved = torch.zeros(n, dtype=theta.dtype, device=theta.device)
    n_blocks = int(smc["n_blocks"])
    for _ in range(int(smc["n_mh_steps"])):
        perm = torch.randperm(p, device=theta.device)
        size = -(-p // n_blocks)
        for b in range(n_blocks):
            idx = perm[b * size:(b + 1) * size]
            k = idx.numel()
            cov_b = cov[idx][:, idx]
            L = c * _block_chol(cov_b)
            Ld = c * torch.diag(torch.sqrt(torch.diagonal(cov_b)))
            old = theta[:, idx]
            eps = torch.randn((n, k), dtype=theta.dtype, device=theta.device)
            comp = torch.multinomial(
                torch.tensor([alpha, 0.5 * (1 - alpha), 0.5 * (1 - alpha)],
                             dtype=theta.dtype, device=theta.device),
                n, replacement=True)
            prop = torch.where(
                (comp == 0)[:, None], old + eps @ L.T,
                torch.where((comp == 1)[:, None], old + eps @ Ld.T,
                            mean[idx][None] + eps @ L.T))
            new = theta.clone()
            new[:, idx] = prop
            ll_new, lp_new = _evaluate(reference, new, y)
            log_r = (phi * (ll_new - ll) + (lp_new - lp)
                     + _mixture_logq(old, prop, mean[idx], L, Ld, alpha)
                     - _mixture_logq(prop, old, mean[idx], L, Ld, alpha))
            u = torch.rand(n, dtype=theta.dtype, device=theta.device)
            take = torch.isfinite(ll_new) & (torch.log(u) < log_r)
            theta = torch.where(take[:, None], new, theta)
            ll = torch.where(take, ll_new, ll)
            lp = torch.where(take, lp_new, lp)
            moved += take.to(theta.dtype) * k
    return theta, ll, lp, float(moved.mean()) / (p * int(smc["n_mh_steps"]))


def estimate(reference, data, smc: dict, seed: int, device="cpu"):
    """One float64 estimation of `smc`'s settings (the keys of a mix's
    "smc") on `device`: {"mean": [P], "sd": [P], "log_mdd": float,
    "redraw_rounds": int}."""
    torch.manual_seed(seed)
    y = torch.as_tensor(data, dtype=F64, device=device)
    n = int(smc["n_parts"])
    priors = reference.PRIORS
    theta = prior.sample(priors, n, device)
    ll, lp = _evaluate(reference, theta, y)
    rounds = 0
    while True:
        bad = torch.nonzero(~(torch.isfinite(ll) & torch.isfinite(lp)))
        bad = bad.flatten()
        if bad.numel() == 0:
            break
        rounds += 1
        if rounds > MAX_ROUNDS:
            raise RuntimeError("the prior puts almost no mass where the "
                               "likelihood is finite")
        fresh = prior.sample(priors, bad.numel(), device)
        ll[bad], lp[bad] = _evaluate(reference, fresh, y)
        theta[bad] = fresh
    n_phi = int(smc["n_phi"])
    phis = (torch.arange(n_phi, dtype=F64) / (n_phi - 1)) ** float(smc["lam"])
    weights = torch.ones(n, dtype=F64, device=device)
    log_mdd, c, accept = 0.0, C0, TARGET
    for s in range(1, n_phi):
        phi, phi_prev = float(phis[s]), float(phis[s - 1])
        c = c * (0.95 + 0.10 / (1.0 + math.exp(-16.0 * (accept - TARGET))))
        lw = (phi - phi_prev) * ll
        m = lw.max()
        u = weights * torch.exp(lw - m)
        log_mdd += float(m + torch.log(u.sum() / n))
        weights = n * u / u.sum()
        ess = float(n * n / (weights * weights).sum())
        if ess < float(smc.get("threshold_ratio", 0.5)) * n:
            idx = _resample(weights, smc["resampling_method"])
            theta, ll, lp = theta[idx], ll[idx], lp[idx]
            weights = torch.ones_like(weights)
        theta, ll, lp, accept = _mutate(reference, y, theta, ll, lp, weights,
                                        phi, c, smc)
    wn = weights / weights.sum()
    mean = wn @ theta
    sd = torch.sqrt(wn @ (theta - mean) ** 2)
    return {"mean": mean.cpu().tolist(), "sd": sd.cpu().tolist(),
            "log_mdd": log_mdd, "redraw_rounds": rounds}
