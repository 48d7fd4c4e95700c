"""Misc helpers (port of smc_tpu/utils/misc.py)."""

from __future__ import annotations

import torch


def scrub_loglh(loglh: torch.Tensor) -> torch.Tensor:
    """Map ANY non-finite log-likelihood (nan, +inf; -inf stays) to -inf.

    A likelihood that returned +inf would otherwise be accepted with
    probability 1 in the mutation and turn the next correction's weights
    into inf/inf = nan."""
    return torch.where(torch.isfinite(loglh), loglh, float("-inf"))
