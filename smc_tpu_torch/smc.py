"""The SMC recursion: correction -> selection -> mutation over a tempering
schedule (port of smc_tpu/smc.py: the stage body and the host-loop
recursion with the fixed schedule).

The stage loop runs on the host. Each stage makes one explicit host read:
the ESS and the log-MDD increment, fetched together right after the
correction, which the host `if` on ESS < threshold needs. Everything else
stays on the device: the step size c is updated there from the previous
stage's mean acceptance, and the last acceptance mean and the w/W weight
columns are fetched once, at the end (with verbose="low", each stage also
reads what its line prints). On a GPU, `torch.linalg.eigh` in the mutation
also waits for the device, to check its status.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from smc_tpu_torch.cloud import (Cloud, weighted_mean, weighted_cov,
                                 weighted_std)
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.ops.correction import correct
from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.ops.resample import resample as resample_indices, VALID_METHODS
from smc_tpu_torch.ops.mutation import make_mutation_step
from smc_tpu_torch.ops.initialization import initial_draw


@dataclasses.dataclass
class SMCResult:
    """Estimation output: the final cloud, the incremental (w) and
    normalized (W) weight matrices [N, n_stages+1] as numpy, the log marginal
    data density, and the number of redraw rounds the initialization took."""

    cloud: Cloud
    w: Optional[np.ndarray]
    W: Optional[np.ndarray]
    log_mdd: float
    para_names: List[str]
    space: ParamSpace
    init_rounds: int = 0

    def posterior_mean(self) -> np.ndarray:
        return weighted_mean(self.cloud).cpu().numpy()

    def posterior_std(self) -> np.ndarray:
        return weighted_std(self.cloud).cpu().numpy()


def _logistic_c_update(c, accept: torch.Tensor, target: float):
    """Adaptive step size c <- c (0.95 + 0.10 sigmoid(16 (accept - target))),
    on the device: `accept` is the previous stage's mean acceptance."""
    return c * (0.95 + 0.10 * torch.sigmoid(16.0 * (accept - target)))


def make_stage_core(space, loglike_batched, n_blocks, n_mh_steps, alpha,
                    resampling_method, threshold):
    """The stage body:
      stage(draws, params, loglh, logprior, old_loglh, weights,
            phi_n, phi_n1, c)
        -> (params, loglh, logprior, old_loglh, weights, accept,
            inc_w, W_col, ess, did_resample, accept_mean, mdd_inc)
    ess and mdd_inc are host floats (the stage's one host read) and
    did_resample a bool; everything else stays on the device. Draws, in
    order: the resampling uniform(s) only when the stage resamples, the
    block permutation, then the mutation's draws."""
    mutation_step = make_mutation_step(space, loglike_batched, n_blocks,
                                       n_mh_steps, alpha)

    def stage(draws, params, loglh, logprior, old_loglh, weights,
              phi_n, phi_n1, c):
        inc_w, norm_w, ess, mdd_inc = correct(loglh, old_loglh, weights,
                                              phi_n, phi_n1)
        ess, mdd_inc = torch.stack([ess, mdd_inc]).tolist()
        did_resample = ess < threshold
        if did_resample:
            idx = resample_indices(draws, norm_w, method=resampling_method)
            params, loglh = params[idx], loglh[idx]
            logprior, old_loglh = logprior[idx], old_loglh[idx]
            weights = torch.ones_like(norm_w)
        else:
            weights = norm_w
        vals = params.index_select(1, space.tensors(params.device)["free_inds"])
        mu = weighted_mean(vals, weights)
        cov = weighted_cov(vals, weights)
        cov = 0.5 * (cov + cov.T)
        perm = draws.permutation(space.n_free)
        params, loglh, logprior, old_loglh, accept = mutation_step(
            draws, params, loglh, logprior, old_loglh, mu, cov, perm, c,
            phi_n, phi_n1)
        return (params, loglh, logprior, old_loglh, weights, accept, inc_w,
                weights, ess, did_resample, torch.mean(accept), mdd_inc)

    return stage


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to smc_tpu_torch yet (ROADMAP.md, {item})")


def smc(loglikelihood: Callable,
        parameters,
        data=None,
        *,
        verbose: str = "low",
        n_parts: int = 5_000,
        n_blocks: int = 1,
        n_mh_steps: int = 1,
        lam: float = 2.1,
        n_phi: int = 300,
        resampling_method: str = "systematic",
        threshold_ratio: float = 0.5,
        c: float = 0.5,
        alpha: float = 1.0,
        target: float = 0.25,
        use_fixed_schedule: bool = True,
        old_data=None,
        regime_switching: bool = False,
        savepath: Optional[str] = None,
        save_intermediate: bool = False,
        continue_intermediate: bool = False,
        store_weight_matrices: bool = True,
        batched: bool = False,
        seed: int = 0,
        mesh=None,
        device="cuda") -> SMCResult:
    """Estimate p(theta | data) by tempered SMC on `device`.

    `device` defaults to "cuda": the run is on the card unless the caller
    passes device="cpu". Without a card the first tensor it creates raises;
    nothing falls back to the CPU.

    `loglikelihood(theta, data)` maps a tensor f64[P] to a scalar; pass
    `batched=True` if it maps f64[N, P] to f64[N] (a DSGE model's
    `loglike_batched`). It must be total: -inf or nan on failure, never an
    exception. `parameters` is a list of Parameter or a ParamSpace. Draws come
    from one torch.Generator seeded with `seed` on `device`, so two runs with
    the same seed on the same device are identical.

    Kwargs of the JAX package whose paths are not ported raise
    NotImplementedError naming their ROADMAP item."""
    if not use_fixed_schedule:
        _not_ported("the adaptive schedule (use_fixed_schedule=False)",
                    "Queue A item 1")
    if old_data is not None:
        _not_ported("tempered updates (old_data)", "Queue A item 4")
    if continue_intermediate:
        _not_ported("continue_intermediate", "Queue A item 3")
    if save_intermediate or savepath is not None:
        _not_ported("saving (savepath/save_intermediate)", "Queue A item 3")
    if mesh is not None:
        _not_ported("multi-device runs (mesh)", "Queue A item 7")
    if resampling_method == "metropolis":
        _not_ported("Metropolis resampling", "Queue A item 2")
    if verbose == "high":
        _not_ported("verbose='high'", "Queue A item 5")
    if resampling_method not in VALID_METHODS:
        raise ValueError(f"resampling_method must be one of {VALID_METHODS}")
    if verbose not in ("none", "low"):
        raise ValueError("verbose must be 'none' or 'low'")

    device = torch.device(device)
    space = (parameters if isinstance(parameters, ParamSpace)
             else ParamSpace(parameters, regime_switching=regime_switching))
    if space.n_free == 0:
        raise ValueError("All model parameters are fixed!")
    if batched:
        loglike_batched = lambda th: loglikelihood(th, data)
    else:
        loglike_batched = torch.func.vmap(lambda th: loglikelihood(th, data))

    draws = TorchDraws(seed, device)
    sched = fixed_schedule(n_phi, lam)
    threshold = threshold_ratio * n_parts

    t_start = time.perf_counter()
    cloud, init_rounds = initial_draw(draws, space, loglike_batched, n_parts,
                                      device=device)
    cloud.n_phi = n_phi
    cloud.ESS = [float(n_parts)]
    cloud.c = c
    cloud.accept_rate = target
    cloud.tempering_schedule = [float(sched[0])]

    stage = make_stage_core(space, loglike_batched, n_blocks, n_mh_steps,
                            alpha, resampling_method, threshold)
    ones = torch.ones(n_parts, dtype=torch.float64, device=device)
    w_cols = [torch.zeros_like(ones)]
    W_cols = [ones]
    c_dev = torch.tensor(c, dtype=torch.float64, device=device)
    accept_rate = torch.tensor(target, dtype=torch.float64, device=device)
    log_mdd = 0.0
    if verbose == "low":
        print(f"SMC recursion starts: {n_parts} particles, {n_phi - 1} "
              f"stages on {device}")

    for i in range(2, n_phi + 1):
        t0 = time.perf_counter()
        phi_n1, phi_n = float(sched[i - 2]), float(sched[i - 1])
        c_dev = _logistic_c_update(c_dev, accept_rate, target)
        (cloud.params, cloud.loglh, cloud.logprior, cloud.old_loglh,
         cloud.weights, cloud.accept, inc_w, W_col, ess, did_resample,
         accept_rate, mdd_inc) = stage(
            draws, cloud.params, cloud.loglh, cloud.logprior,
            cloud.old_loglh, cloud.weights, phi_n, phi_n1, c_dev)
        cloud.stage_index = i
        cloud.tempering_schedule.append(phi_n)
        cloud.ESS.append(ess)
        cloud.resamples += int(did_resample)
        log_mdd += mdd_inc
        if store_weight_matrices:
            w_cols.append(inc_w)
            W_cols.append(W_col)
        if np.isnan(ess):
            raise RuntimeError(f"ESS is NaN at stage {i}: every particle has "
                               "zero weight or a -inf likelihood")
        if verbose == "low":
            print(f"stage {i - 1}/{n_phi - 1}  phi={phi_n:.6f}  "
                  f"c={float(c_dev):.4f}  accept={float(accept_rate):.4f}  "
                  f"ESS={ess:.1f}  resampled={did_resample}  "
                  f"t={time.perf_counter() - t0:.3f}s")

    cloud.c = float(c_dev)
    cloud.accept_rate = float(accept_rate)
    cloud.total_sampling_time = time.perf_counter() - t_start
    w_matrix = W_matrix = None
    if store_weight_matrices:
        w_matrix = torch.stack(w_cols, dim=1).cpu().numpy()
        W_matrix = torch.stack(W_cols, dim=1).cpu().numpy()
    return SMCResult(cloud=cloud, w=w_matrix, W=W_matrix, log_mdd=log_mdd,
                     para_names=list(space.names), space=space,
                     init_rounds=init_rounds)
