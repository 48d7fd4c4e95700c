"""Resampling (port of smc_tpu/ops/resample.py).

Index i is the first j with cumweights[j] > threshold (searchsorted,
right=True), clamped to N-1 because the cumulative sum can end just below 1:
  systematic   one shared uniform, thresholds (i + u) / n;
  stratified   one uniform per stratum, thresholds (i + u_i) / n;
  multinomial  n iid uniforms ("polyalgo" is an alias);
  metropolis   a Metropolis chain over ancestor indices per output slot
               (Murray, Lee & Jacob, arXiv:1202.6163): uniform index
               proposals accepted with w_prop / w_current, no cumulative sum.

The Metropolis chain length is fixed when `n_iter` is given, else the
Doeblin length B = ceil(kappa ln(1/eps)), kappa = max(w) / mean(w), capped
at n_iter_max; B is the one host read a Metropolis resample makes.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

VALID_METHODS = ("systematic", "multinomial", "polyalgo", "stratified",
                 "metropolis")

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
             eps: float = 0.01, n_iter_max: int = 10_000) -> torch.Tensor:
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
        if n_iter is None:
            n_iter, _ = metropolis_chain_length(weights, eps, n_iter_max)
        return _metropolis(draws, weights, n_out, int(n_iter))
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


def metropolis_chain_length(weights, eps: float = 0.01,
                            n_iter_max: int = 10_000):
    """(steps, doeblin): the Doeblin length max(ceil(kappa ln(1/eps)), 1),
    kappa = max(w) / mean(w) computed on the device and read once, and the
    steps the chain runs, min(doeblin, n_iter_max). Warns when the cap
    binds."""
    kappa_t = torch.max(weights) / torch.mean(weights)
    doeblin_t = torch.clamp(torch.ceil(kappa_t * math.log(1.0 / eps)),
                            min=1.0)
    kappa, doeblin = torch.stack([kappa_t, doeblin_t]).tolist()
    if doeblin > n_iter_max:
        warnings.warn(
            f"metropolis resampler chain length capped at {n_iter_max} "
            f"(Doeblin bound {doeblin:.0f} at kappa={kappa:.1f}); TV bias "
            "bound degrades to exp(-cap/kappa)")
    return int(min(doeblin, float(n_iter_max))), int(doeblin)


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
