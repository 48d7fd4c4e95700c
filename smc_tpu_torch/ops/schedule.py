"""Tempering schedule (port of smc_tpu/ops/schedule.py): the fixed
lambda-schedule. The adaptive schedule is not ported yet."""

from __future__ import annotations

import numpy as np


def fixed_schedule(n_phi: int, lam: float) -> np.ndarray:
    """phi_n = ((n-1)/(n_phi-1))^lambda, n = 1..n_phi."""
    return (np.arange(n_phi, dtype=np.float64) / (n_phi - 1)) ** lam
