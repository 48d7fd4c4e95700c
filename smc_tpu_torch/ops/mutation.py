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

The whole cloud mutates at once: the blocks' covariance factors (an eigh
pseudo-inverse that tolerates rank deficiency) come from one eigh call per
mutation step, before the MH loop (cov_free and perm do not change within
it), everything else is batched over [N, ...]. The eigh is
ops/cuda_eigh.py's: the Jacobi kernel on a card, one launch for every
block, torch.linalg.eigh on the CPU, so nothing in a mutation copies from
the host or reads back to it and a stage can be captured in a CUDA graph.
Block columns are read and written with index_select/index_copy. Draws per
block, in order: normal eps [N, k], the mixture component (categorical,
when alpha < 1), the uniform [N].

In a tempered update (bridging) the proposals' likelihood on the old data
comes from `old_loglike_batched`; without it, it is 0.

The single-particle API helpers at the end (`mutation`,
`mvnormal_mixture_draw`, `compute_proposal_densities`, the block
generators) follow the JAX package's. `compute_proposal_densities` takes
each mixture's log-sum-exp over its own three terms (torch.logsumexp), as
the JAX helper does; the batched step shares one max between the two
mixtures. The two forms agree while the mixture terms lie within ~745 nats
of each other and may differ beyond, where exp underflows.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from smc_tpu_torch.ops.cuda_eigh import eigh, eigh_batched
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
    lam, U = eigh(cov)
    return _factor(lam, U, cov.dtype, tol)


def _factor(lam, U, dtype, tol: float = 1e-12):
    """_deg_factor from the eigendecomposition (lam, U)."""
    lam_max = torch.clamp(torch.max(lam), min=0.0)
    keep = lam > tol * torch.clamp(lam_max, min=1e-300)
    safe = torch.where(keep, lam, 1.0)
    sqrt_lam = torch.where(keep, torch.sqrt(safe), 0.0)
    inv_lam = torch.where(keep, 1.0 / safe, 0.0)
    rank = keep.sum().to(dtype)
    logdet = torch.sum(torch.where(keep, torch.log(safe), 0.0))
    return U, sqrt_lam, inv_lam, rank, logdet


def block_factors(cov_free: torch.Tensor, perm: torch.Tensor,
                  sizes: List[int]):
    """Each block's proposal factor (U, sqrt_lam, inv_lam, rank, logdet,
    diag_sd), the block being perm's next sizes[i] free ordinals, from one
    eigh_batched call: the equal blocks as one stack, a smaller last block
    as a second."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    covs = [cov_free[idx][:, idx] for idx in
            (perm[int(o):int(o) + k] for o, k in zip(offsets, sizes))]
    n_eq = sizes.count(sizes[0])
    stacks = [torch.stack(covs[:n_eq])] + [c[None] for c in covs[n_eq:]]
    eig = [(lam, U) for lams, Us in eigh_batched(stacks)
           for lam, U in zip(lams.unbind(), Us.unbind())]
    return [_factor(lam, U, cov.dtype)
            + (torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)),)
            for (lam, U), cov in zip(eig, covs)]


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
                       n_mh_steps: int, alpha: float,
                       old_loglike_batched: Optional[Callable] = None):
    """Returns mutation_step(draws, params, loglh, logprior, old_loglh,
    mean_free, cov_free, perm, c, phi_n, phi_n1)
    -> (params, loglh, logprior, old_loglh, accept_frac).
    `old_loglike_batched` gives the proposals' likelihood on the old data
    in a tempered update; without it that likelihood is 0."""
    n_free = space.n_free
    sizes = block_sizes(n_free, n_blocks)
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    log_alpha = math.log(alpha) if alpha > 0 else -math.inf
    log_half_rest = math.log((1.0 - alpha) / 2.0) if alpha < 1 else -math.inf
    mix_probs = (alpha, (1 - alpha) / 2, (1 - alpha) / 2)

    def mutation_step(draws, params, loglh, logprior, old_loglh,
                      mean_free, cov_free, perm, c, phi_n, phi_n1):
        n = params.shape[0]
        dev = params.device
        c = torch.as_tensor(c, dtype=torch.float64, device=dev)
        free_inds = space.tensors(dev)["free_inds"]
        factors = block_factors(cov_free, perm, sizes)
        accept_count = torch.zeros(n, dtype=torch.float64, device=dev)
        for _ in range(n_mh_steps):
            for off, k, factor in zip(offsets, sizes, factors):
                U, sqrt_lam, inv_lam, rank, logdet, diag_sd = factor
                idx_f = perm[int(off):int(off) + k]
                idx_full = free_inds[idx_f]
                mu_b = mean_free[idx_f]
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
                if old_loglike_batched is not None:
                    like_old_new = scrub_loglh(old_loglike_batched(params_new))
                else:
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


# --- single-particle API helpers --------------------------------------------


def generate_free_blocks(draws, n_free_para: int, n_blocks: int):
    """A random partition of the free-parameter ordinals into ~equal blocks
    (a permutation cut at block_sizes): a list of int64 tensors."""
    perm = draws.permutation(n_free_para)
    sizes = block_sizes(n_free_para, n_blocks)
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    return [perm[int(o):int(o) + k] for o, k in zip(offsets, sizes)]


def generate_all_blocks(blocks_free, free_para_inds):
    """Free-ordinal blocks mapped to full-parameter indices."""
    free_para_inds = torch.as_tensor(np.asarray(free_para_inds),
                                     device=blocks_free[0].device)
    return [free_para_inds[b] for b in blocks_free]


def generate_param_blocks(draws, n_params: int, n_blocks: int):
    """A random ~equal partition of 0..n_params-1, each block sorted."""
    if n_blocks == 1:
        return [torch.arange(n_params, device=draws.device)]
    return [torch.sort(b).values
            for b in generate_free_blocks(draws, n_params, n_blocks)]


def mvnormal_mixture_draw(draws, theta_old, mean, cov, c: float = 1.0,
                          alpha: float = 1.0):
    """One draw from the 3-component mixture proposal around theta_old [k].
    Draws, in order: normal eps [k], the component (categorical, 1)."""
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64,
                                    device=draws.device)
    theta_old, mean, cov = f64(theta_old), f64(mean), f64(cov)
    k = theta_old.shape[0]
    U, sqrt_lam, _, _, _ = _deg_factor(cov)
    diag_sd = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    eps = draws.normal((k,))
    comp = draws.categorical([alpha, (1 - alpha) / 2, (1 - alpha) / 2], 1)[0]
    full_step = c * ((eps * sqrt_lam) @ U.T)
    center = torch.where(comp == 2, mean, theta_old)
    stepv = torch.where(comp == 1, c * eps * diag_sd, full_step)
    return center + stepv


def compute_proposal_densities(para_draw, para_subset, mean, cov,
                               alpha: float = 1.0, c: float = 1.0,
                               catch_near_zeros: bool = False,
                               tol: float = 1e-6):
    """(q0, q1): log densities of the mixture at the current point given the
    proposal and at the proposal given the current point. With
    catch_near_zeros, covariance diagonal entries in (-tol, 0) become 0."""
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)
    para_draw, para_subset = f64(para_draw), f64(para_subset)
    mean, cov = f64(mean), f64(cov)
    if catch_near_zeros:
        diag = torch.diagonal(cov)
        fixed = torch.where((diag < 0) & (diag > -tol), 0.0, diag)
        cov = cov - torch.diag(diag) + torch.diag(fixed)
    U, _, inv_lam, rank, logdet = _deg_factor(cov)
    diag_sd = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    c = torch.as_tensor(c, dtype=torch.float64, device=cov.device)
    log_alpha = math.log(alpha) if alpha > 0 else -math.inf
    log_rest = math.log((1 - alpha) / 2) if alpha < 1 else -math.inf
    lp_sym = _deg_logpdf(para_draw - para_subset, U, inv_lam, rank, logdet, c)
    lp_diag = _diag_logpdf(para_draw - para_subset, diag_sd, c)
    lp_bar_cur = _deg_logpdf(para_subset - mean, U, inv_lam, rank, logdet, c)
    lp_bar_prop = _deg_logpdf(para_draw - mean, U, inv_lam, rank, logdet, c)
    q0 = torch.logsumexp(torch.stack([log_alpha + lp_sym, log_rest + lp_diag,
                                      log_rest + lp_bar_cur]), dim=0)
    q1 = torch.logsumexp(torch.stack([log_alpha + lp_sym, log_rest + lp_diag,
                                      log_rest + lp_bar_prop]), dim=0)
    q0 = torch.where(torch.isposinf(q0) & torch.isposinf(q1), 0.0, q0)
    return q0, q1


def mutation(draws, space, loglike, data, particle_params, particle_loglh,
             particle_logprior, particle_old_loglh, mean_free, cov_free,
             perm, c, alpha, n_mh_steps, n_blocks, phi_n, phi_n1,
             old_loglike=None, old_data=None):
    """Mutate one particle: the batched step at N = 1, with the per-theta
    `loglike(theta, data)` vmapped. Returns (params, loglh, logprior,
    old_loglh, accept_frac) of the particle."""
    dev = draws.device
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    ll = torch.func.vmap(lambda t: loglike(t, data))
    oll = None
    if old_loglike is not None and old_data is not None:
        oll = torch.func.vmap(lambda t: old_loglike(t, old_data))
    step = make_mutation_step(space, ll, n_blocks, n_mh_steps, alpha, oll)
    p, l, lp, ol, af = step(
        draws, f64(particle_params)[None, :], f64(particle_loglh).reshape(1),
        f64(particle_logprior).reshape(1), f64(particle_old_loglh).reshape(1),
        f64(mean_free), f64(cov_free),
        perm.to(dev) if torch.is_tensor(perm) else
        torch.as_tensor(np.array(perm, np.int64), device=dev), c, phi_n,
        phi_n1)
    return p[0], l[0], lp[0], ol[0], af[0]
