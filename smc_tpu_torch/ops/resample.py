"""Resampling (port of smc_tpu/ops/resample.py).

Index i is the first j with cumweights[j] > threshold (searchsorted,
right=True), clamped to N-1 because the cumulative sum can end just below 1:
  systematic   one shared uniform, thresholds (i + u) / n;
  stratified   one uniform per stratum, thresholds (i + u_i) / n;
  multinomial  n iid uniforms ("polyalgo" is an alias);
  metropolis   a Metropolis chain over ancestor indices per output slot
               (Murray, Lee & Jacob, arXiv:1202.6163): uniform index
               proposals accepted with w_prop / w_current, no cumulative sum.

The Metropolis chain length is fixed when `n_iter` is given (the JAX
package's `_metropolis`: the proposals and uniforms come from `draws`),
else the Doeblin length B = ceil(kappa ln(1/eps)), kappa = max(w) / mean(w),
capped at n_iter_max (its `_metropolis_adaptive`): B is computed on the
device and the chain is ops/cuda_metropolis.py's, one kernel launch on a
card, keyed by one [2] draw of `integers`, so nothing is read to the host.
A non-finite kappa (NaN weights) gives B = 0 steps, the identity.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from smc_tpu_torch.ops.cuda_metropolis import metropolis_chain

VALID_METHODS = ("systematic", "multinomial", "polyalgo", "stratified",
                 "metropolis")
# the adaptive chain's cap (the JAX package's n_iter_max)
N_ITER_MAX = 10_000

# chain steps drawn per draws call: bounds the [steps, n] proposal and
# uniform blocks of a long chain
_CHAIN_BLOCK = 128


def metropolis_n_iter(weights, eps: float = 0.01) -> int:
    """Chain length with total-variation bias <= eps from the Doeblin bound:
    every transition satisfies P(i -> j) >= w_j / (n w_max), a minorization
    of mass 1/kappa with kappa = w_max / w_bar, so after B steps
    TV <= exp(-B / kappa) and B = ceil(kappa ln(1/eps)) suffices."""
    w = np.asarray(torch.as_tensor(weights).cpu(), dtype=np.float64)
    kappa = float(w.max() / w.mean())
    return max(1, int(np.ceil(kappa * np.log(1.0 / eps))))


def resample(draws, weights: torch.Tensor, method: str = "systematic",
             n_parts: int | None = None, n_iter: int | None = None,
             eps: float = 0.01, n_iter_max: int = N_ITER_MAX) -> torch.Tensor:
    """Ancestor indices (int64 [n_parts]) for `weights` (need not be
    normalized); every random number comes from `draws`. `n_iter`, `eps`
    and `n_iter_max` apply to method="metropolis" only: a fixed chain
    length, or the bias bound and cap of the adaptive length (when the cap
    binds, the bias bound degrades to exp(-n_iter_max / kappa) and a
    warning says so)."""
    if method not in VALID_METHODS:
        raise ValueError(f"Invalid resampler {method!r}; options are "
                         f"{VALID_METHODS}")
    n_out = int(n_parts) if n_parts is not None else weights.shape[0]
    if method == "metropolis":
        if n_iter is not None:
            return _metropolis(draws, weights, n_out, int(n_iter))
        idx, doeblin = metropolis_adaptive(draws, weights, n_out, eps,
                                           n_iter_max)
        warn_if_capped(float(doeblin), n_iter_max)
        return idx
    cw = torch.cumsum(weights / torch.sum(weights), 0)
    steps = torch.arange(n_out, dtype=torch.float64, device=weights.device)
    if method == "systematic":
        u = draws.uniform(())
        thresholds = (steps + u) / n_out
    elif method == "stratified":
        thresholds = (steps + draws.uniform((n_out,))) / n_out
    else:
        thresholds = draws.uniform((n_out,))
    idx = torch.searchsorted(cw, thresholds, right=True)
    return idx.clamp_(0, weights.shape[0] - 1)


def chain_steps(weights: torch.Tensor, eps: float = 0.01,
                n_iter_max: int = N_ITER_MAX):
    """(steps, doeblin) as device scalars, in two reductions: the Doeblin
    length max(ceil(kappa ln(1/eps)), 1), kappa = max(w) / mean(w) (f64; 0
    where kappa is not finite), and the steps the chain runs,
    min(doeblin, n_iter_max) (int64)."""
    kappa = torch.max(weights) / torch.mean(weights)
    doeblin = torch.clamp(torch.ceil(kappa * math.log(1.0 / eps)), min=1.0)
    doeblin = torch.where(torch.isfinite(doeblin), doeblin, 0.0)
    steps = torch.clamp(doeblin, max=float(n_iter_max)).to(torch.int64)
    return steps, doeblin


def metropolis_adaptive(draws, weights: torch.Tensor,
                        n_out: Optional[int] = None, eps: float = 0.01,
                        n_iter_max: int = N_ITER_MAX,
                        flag: Optional[torch.Tensor] = None):
    """(idx, doeblin): the adaptive Metropolis resample of `weights` into
    n_out slots and its Doeblin length (a device scalar, before the cap),
    where the device flag `flag` holds; elsewhere the identity and a length
    of 0. Draws the chain's key, integers [2] in [0, 2^32), whatever the
    flag: a stage's draws do not depend on its data. Reads nothing to the
    host on a card."""
    key = draws.integers(0, 2 ** 32, (2,))
    steps, doeblin = chain_steps(weights, eps, n_iter_max)
    if flag is not None:
        doeblin = torch.where(flag, doeblin, 0.0)
    return metropolis_chain(weights, key, steps, flag, n_out), doeblin


def warn_if_capped(doeblin: float, n_iter_max: int = N_ITER_MAX) -> None:
    """The warning of a chain whose Doeblin length passed the cap."""
    if doeblin > n_iter_max:
        warnings.warn(
            f"metropolis resampler chain length capped at {n_iter_max} "
            f"(Doeblin bound {doeblin:.0f}); TV bias bound degrades to "
            "exp(-cap/kappa)")


def metropolis_chain_length(weights, eps: float = 0.01,
                            n_iter_max: int = N_ITER_MAX):
    """(steps, doeblin) of `chain_steps`, read to the host, for callers
    that want the numbers; warns when the cap binds."""
    steps_t, doeblin_t = chain_steps(weights, eps, n_iter_max)
    steps, doeblin = torch.stack([steps_t.to(torch.float64),
                                  doeblin_t]).tolist()
    warn_if_capped(doeblin, n_iter_max)
    return int(steps), int(doeblin)


def _metropolis(draws, weights, n_out: int, n_iter: int) -> torch.Tensor:
    """n_iter Metropolis steps from the start j_i = i mod n. Draws, per block
    of up to _CHAIN_BLOCK steps: the index proposals (integers [k, n_out]),
    then the uniforms ([k, n_out])."""
    n = weights.shape[0]
    j = torch.arange(n_out, device=weights.device) % n
    for start in range(0, n_iter, _CHAIN_BLOCK):
        k = min(_CHAIN_BLOCK, n_iter - start)
        props = draws.integers(0, n, (k, n_out))
        us = draws.uniform((k, n_out))
        for t in range(k):
            prop = props[t]
            accept = us[t] * weights[j] < weights[prop]
            j = torch.where(accept, prop, j)
    return j
