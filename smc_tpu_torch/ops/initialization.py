"""Initialization (port of smc_tpu/ops/initialization.py): prior draws with
redraw-until-valid, and the likelihood re-evaluation of a tempered update.

`initial_draw` runs masked redraw rounds on the host: draw all N, evaluate
them in one batched likelihood call, then redraw and evaluate only the
invalid rows, until every particle has a finite likelihood and prior. Each
round is one likelihood call and one host read of the invalid count, in a
span `smc.init.round` (tracing.py).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from smc_tpu_torch.cloud import Cloud
from smc_tpu_torch.tracing import span
from smc_tpu_torch.utils.misc import scrub_loglh


def _eval_batch(space, loglike_batched, draws):
    """(loglh, logprior); any non-finite value forces both to -inf."""
    logprior = space.log_prior(draws)
    loglh = loglike_batched(draws)
    bad = ~torch.isfinite(loglh) | ~torch.isfinite(logprior)
    return (torch.where(bad, float("-inf"), loglh),
            torch.where(bad, float("-inf"), logprior))


def initial_draw(draws, space, loglike_batched: Callable, n_parts: int,
                 device="cuda", max_rounds: int = 1000,
                 sharding=None) -> Tuple[Cloud, int]:
    """n_parts valid prior draws. Returns (cloud, redraw rounds taken);
    raises after max_rounds rounds.

    Under a particle mesh (`sharding`, a parallel.mesh.ParticleSharding)
    every rank draws all n_parts from its (shared) draws, evaluates its own
    rows and gathers the likelihoods, so every rank sees the same invalid
    rows; each redraw round then draws and evaluates the fresh rows on
    every rank, as the one-device run does, and the rank returns its rows
    of the cloud after the same number of rounds."""
    with span("smc.init.round"):
        params = space.sample_prior(draws, n_parts, device=device)
        if sharding is None:
            loglh, logprior = _eval_batch(space, loglike_batched, params)
        else:
            loglh, logprior = sharding.gather(*_eval_batch(
                space, loglike_batched, params[sharding.rows(n_parts)]))
        invalid = torch.nonzero(~torch.isfinite(loglh)).flatten()
    rounds = 0
    while invalid.numel() > 0:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                f"initial_draw: {invalid.numel()}/{n_parts} particles still "
                f"invalid after {max_rounds} redraw rounds: the prior puts "
                "almost no mass where the likelihood is finite")
        with span("smc.init.round"):
            fresh = space.sample_prior(draws, invalid.numel(), device=device)
            l_new, lp_new = _eval_batch(space, loglike_batched, fresh)
            params[invalid] = fresh
            loglh[invalid] = l_new
            logprior[invalid] = lp_new
            invalid = invalid[~torch.isfinite(l_new)]
    cloud = Cloud.create(space.n_para, n_parts, device=device)
    cloud.params, cloud.loglh, cloud.logprior = params, loglh, logprior
    return (cloud if sharding is None else sharding.shard(cloud)), rounds


def one_draw(draws, space, loglike_batched: Callable, max_rounds: int = 10000,
             device="cuda"):
    """One valid prior draw: (draw [P], loglh, logprior), an N=1
    initial_draw."""
    cloud, _ = initial_draw(draws, space, loglike_batched, 1, device=device,
                            max_rounds=max_rounds)
    return cloud.params[0], cloud.loglh[0], cloud.logprior[0]


def initialize_likelihoods(cloud: Cloud, space,
                           loglike_batched: Callable) -> Cloud:
    """Tempered-update set-up: loglh moves to old_loglh, then loglh and
    logprior are evaluated for every particle on the new data (a non-finite
    loglh becomes -inf). Updates and returns `cloud`."""
    cloud.old_loglh = cloud.loglh
    cloud.logprior = space.log_prior(cloud.params)
    cloud.loglh = scrub_loglh(loglike_batched(cloud.params))
    return cloud


def draw_likelihood(space, loglike_batched: Callable, draws, device="cuda"):
    """(loglh, logprior) at the given parameter draws [N, P], moved to
    `device`; a non-finite loglh becomes -inf."""
    draws = torch.as_tensor(draws, dtype=torch.float64, device=device)
    logprior = space.log_prior(draws)
    loglh = scrub_loglh(loglike_batched(draws))
    return loglh, logprior
