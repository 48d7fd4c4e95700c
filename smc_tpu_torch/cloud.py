"""Particle cloud (port of smc_tpu/cloud.py): f64 tensors for the particle
arrays plus host-side scalar state, and the weighted cloud statistics."""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

import numpy as np
import torch

# the array fields, in the order and under the names the JAX package saves
ARRAY_FIELDS = ("params", "loglh", "logprior", "old_loglh", "accept",
                "weights")


@dataclasses.dataclass
class Cloud:
    """params [N, P], loglh, logprior, old_loglh, accept, weights [N] (f64,
    one device; weights normalized to sum to N), and the scalar state of the
    recursion."""

    params: torch.Tensor
    loglh: torch.Tensor
    logprior: torch.Tensor
    old_loglh: torch.Tensor
    accept: torch.Tensor
    weights: torch.Tensor

    tempering_schedule: List[float] = dataclasses.field(
        default_factory=lambda: [0.0])
    ESS: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    stage_index: int = 1
    n_phi: int = 1
    resamples: int = 0
    c: float = 0.5
    accept_rate: float = 0.25
    total_sampling_time: float = 0.0

    @classmethod
    def create(cls, n_para: int, n_parts: int, device="cuda") -> "Cloud":
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
        return cls(params=z(n_parts, n_para), loglh=z(n_parts),
                   logprior=z(n_parts), old_loglh=z(n_parts),
                   accept=z(n_parts),
                   weights=torch.ones(n_parts, dtype=torch.float64,
                                      device=device))

    @classmethod
    def from_numpy(cls, fields: Mapping, device="cuda") -> "Cloud":
        """A cloud from the saved particle arrays (the ARRAY_FIELDS of e.g.
        np.load of a cloud written by smc_tpu.io.save_cloud); the scalar
        state starts fresh."""
        return cls(**{k: torch.as_tensor(np.array(fields[k], np.float64),
                                         device=device)
                      for k in ARRAY_FIELDS})

    @property
    def n_parts(self) -> int:
        return int(self.params.shape[0])

    @property
    def n_para(self) -> int:
        return int(self.params.shape[1])


def _vals_weights(cloud_or_vals, weights):
    if isinstance(cloud_or_vals, Cloud):
        return cloud_or_vals.params, cloud_or_vals.weights
    return cloud_or_vals, weights


def weighted_mean(cloud_or_vals, weights=None) -> torch.Tensor:
    """vals' W / sum(W) -> [P]."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    return (w @ vals) / torch.sum(w)


def weighted_cov(cloud_or_vals, weights=None) -> torch.Tensor:
    """Weighted, uncorrected covariance [P, P]."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    wsum = torch.sum(w)
    dev = vals - (w @ vals) / wsum
    return (dev.T * w) @ dev / wsum


def weighted_std(cloud_or_vals, weights=None) -> torch.Tensor:
    return torch.sqrt(torch.diagonal(weighted_cov(cloud_or_vals, weights)))
