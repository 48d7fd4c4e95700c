"""Blocked random-walk Metropolis-Hastings mutation (port of
smc_tpu/ops/mutation.py).

Per particle, for each of n_mh_steps x n_blocks, the block's free parameters
get a proposal from the 3-component mixture built from the cloud's weighted
mean and covariance,

    alpha     * N(theta_old_b, c^2 Sigma_b)
  + (1-a)/2   * N(theta_old_b, c^2 diag(Sigma_b))
  + (1-a)/2   * N(theta_bar_b, c^2 Sigma_b),

and is accepted with probability
  exp[phi_n (l_new - l) + (1-phi_n)(l_old_new - l_old) + (p_new - p) + q_rev - q_fwd].
`accept` counts the fraction of parameters moved.

The whole cloud mutates at once: the block's covariance factor (an eigh
pseudo-inverse that tolerates rank deficiency) is computed once per block,
everything else is batched over [N, ...]. Block columns are read and written
with index_select/index_copy. Draws per block, in order: normal eps [N, k],
the mixture component (categorical, when alpha < 1), the uniform [N].
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from smc_tpu_torch.utils.misc import scrub_loglh

_LOG_2PI = 1.8378770664093453


def block_sizes(n_free: int, n_blocks: int) -> List[int]:
    """Equal-split block sizes by ceiling division; the last block absorbs
    the remainder."""
    if n_blocks < 1 or n_blocks > n_free:
        raise ValueError(f"n_blocks={n_blocks} must be in [1, n_free={n_free}]")
    subset = -(-n_free // n_blocks)
    last = n_free - subset * (n_blocks - 1)
    if last <= 0:
        raise ValueError(
            f"n_blocks={n_blocks} leaves an empty last block for "
            f"n_free={n_free}; use fewer blocks")
    return [subset] * (n_blocks - 1) + [last]


def _deg_factor(cov: torch.Tensor, tol: float = 1e-12):
    """Eigen factor of a PSD, possibly rank-deficient matrix:
    (U, sqrt_lam, inv_lam, rank, logdet_plus)."""
    lam, U = torch.linalg.eigh(cov)
    lam_max = torch.clamp(torch.max(lam), min=0.0)
    keep = lam > tol * torch.clamp(lam_max, min=1e-300)
    safe = torch.where(keep, lam, 1.0)
    sqrt_lam = torch.where(keep, torch.sqrt(safe), 0.0)
    inv_lam = torch.where(keep, 1.0 / safe, 0.0)
    rank = keep.sum().to(cov.dtype)
    logdet = torch.sum(torch.where(keep, torch.log(safe), 0.0))
    return U, sqrt_lam, inv_lam, rank, logdet


def _deg_logpdf(diff, U, inv_lam, rank, logdet, c):
    """log N(x; mu, c^2 Sigma) through the pseudo-inverse factor,
    diff = x - mu [..., k]."""
    z = diff @ U
    quad = torch.sum(z * z * inv_lam, dim=-1) / (c * c)
    return -0.5 * (rank * (_LOG_2PI + 2.0 * torch.log(c)) + logdet + quad)


def _diag_logpdf(diff, diag_sd, c):
    """Sum of 1-D normal logpdfs with per-coordinate sd c*sqrt(Sigma_ii)."""
    sd = c * torch.clamp(diag_sd, min=1e-150)
    z = diff / sd
    return torch.sum(-0.5 * (_LOG_2PI + z * z) - torch.log(sd), dim=-1)


def make_mutation_step(space, loglike_batched: Callable, n_blocks: int,
                       n_mh_steps: int, alpha: float):
    """Returns mutation_step(draws, params, loglh, logprior, old_loglh,
    mean_free, cov_free, perm, c, phi_n, phi_n1)
    -> (params, loglh, logprior, old_loglh, accept_frac). Without bridging
    (not ported yet) the old-data likelihood of a proposal is 0."""
    n_free = space.n_free
    sizes = block_sizes(n_free, n_blocks)
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    log_alpha = math.log(alpha) if alpha > 0 else -math.inf
    log_half_rest = math.log((1.0 - alpha) / 2.0) if alpha < 1 else -math.inf
    mix_probs = [alpha, (1 - alpha) / 2, (1 - alpha) / 2]

    def mutation_step(draws, params, loglh, logprior, old_loglh,
                      mean_free, cov_free, perm, c, phi_n, phi_n1):
        n = params.shape[0]
        dev = params.device
        c = torch.as_tensor(c, dtype=torch.float64, device=dev)
        free_inds = space.tensors(dev)["free_inds"]
        accept_count = torch.zeros(n, dtype=torch.float64, device=dev)
        for _ in range(n_mh_steps):
            for off, k in zip(offsets, sizes):
                idx_f = perm[int(off):int(off) + k]
                idx_full = free_inds[idx_f]
                mu_b = mean_free[idx_f]
                cov_b = cov_free[idx_f][:, idx_f]
                U, sqrt_lam, inv_lam, rank, logdet = _deg_factor(cov_b)
                diag_sd = torch.sqrt(torch.clamp(torch.diagonal(cov_b), min=0.0))
                theta_b = params.index_select(1, idx_full)

                # mixture proposal draw
                eps = draws.normal((n, k))
                full_step = c * ((eps * sqrt_lam) @ U.T)
                if alpha >= 1.0:
                    prop = theta_b + full_step
                    log_q_diff = torch.zeros(n, dtype=torch.float64, device=dev)
                else:
                    comp = draws.categorical(mix_probs, n)
                    center = torch.where((comp == 2)[:, None], mu_b, theta_b)
                    stepv = torch.where((comp == 1)[:, None],
                                        c * eps * diag_sd, full_step)
                    prop = center + stepv
                    # q_rev - q_fwd: only the theta_bar component is
                    # asymmetric; both mixtures share their first two terms,
                    # so one common max serves both log-sum-exps
                    diff = prop - theta_b
                    a_sym = log_alpha + _deg_logpdf(diff, U, inv_lam, rank,
                                                    logdet, c)
                    a_diag = log_half_rest + _diag_logpdf(diff, diag_sd, c)
                    a_cur = log_half_rest + _deg_logpdf(
                        theta_b - mu_b, U, inv_lam, rank, logdet, c)
                    a_prop = log_half_rest + _deg_logpdf(
                        prop - mu_b, U, inv_lam, rank, logdet, c)
                    m = torch.maximum(torch.maximum(a_sym, a_diag),
                                      torch.maximum(a_cur, a_prop))
                    ms = torch.where(torch.isfinite(m), m, 0.0)
                    e_sym = torch.exp(a_sym - ms)
                    e_diag = torch.exp(a_diag - ms)
                    q0 = ms + torch.log(e_sym + e_diag + torch.exp(a_cur - ms))
                    q1 = ms + torch.log(e_sym + e_diag + torch.exp(a_prop - ms))
                    both_inf = torch.isposinf(q0) & torch.isposinf(q1)
                    log_q_diff = torch.where(both_inf, 0.0, q0) - q1

                # prior and likelihood of the proposals
                params_new = params.index_copy(1, idx_full, prop)
                prior_new = space.log_prior(params_new)
                like_new = scrub_loglh(loglike_batched(params_new))
                prior_new = torch.where(torch.isneginf(like_new),
                                        float("-inf"), prior_new)
                like_old_new = torch.zeros_like(like_new)

                log_eta = (phi_n * (like_new - loglh)
                           + (1.0 - phi_n) * (like_old_new - old_loglh)
                           + (prior_new - logprior) + log_q_diff)
                log_u = torch.log(draws.uniform((n,)))
                acc = log_u < log_eta    # nan log_eta rejects

                params = torch.where(acc[:, None], params_new, params)
                loglh = torch.where(acc, like_new, loglh)
                logprior = torch.where(acc, prior_new, logprior)
                old_loglh = torch.where(acc, like_old_new, old_loglh)
                accept_count = accept_count + acc * float(k)
        # divided by n_free only, not by n_mh_steps (reference semantics)
        return params, loglh, logprior, old_loglh, accept_count / float(n_free)

    return mutation_step
