"""Resampling (port of smc_tpu/ops/resample.py, without the Metropolis
resampler).

Index i is the first j with cumweights[j] > threshold (searchsorted,
right=True), clamped to N-1 because the cumulative sum can end just below 1:
  systematic   one shared uniform, thresholds (i + u) / n;
  stratified   one uniform per stratum, thresholds (i + u_i) / n;
  multinomial  n iid uniforms ("polyalgo" is an alias).
"""

from __future__ import annotations

import torch

VALID_METHODS = ("systematic", "multinomial", "polyalgo", "stratified")


def resample(draws, weights: torch.Tensor, method: str = "systematic",
             n_parts: int | None = None) -> torch.Tensor:
    """Ancestor indices (int64 [n_parts]) for `weights` (need not be
    normalized); uniforms come from `draws`."""
    if method not in VALID_METHODS:
        raise ValueError(f"Invalid resampler {method!r}; options are "
                         f"{VALID_METHODS}")
    n_out = int(n_parts) if n_parts is not None else weights.shape[0]
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
