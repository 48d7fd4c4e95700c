"""Misc helpers (port of smc_tpu/utils/misc.py)."""

from __future__ import annotations

import torch


def scrub_loglh(loglh: torch.Tensor) -> torch.Tensor:
    """Map ANY non-finite log-likelihood (nan, +inf; -inf stays) to -inf.

    A likelihood that returned +inf would otherwise be accepted with
    probability 1 in the mutation and turn the next correction's weights
    into inf/inf = nan."""
    return torch.where(torch.isfinite(loglh), loglh, float("-inf"))


class DeviceCopies:
    """Each data object a likelihood is called with, held as a contiguous
    f64 tensor on each device it is asked for, so a run copies each of its
    arrays to the device once rather than at every likelihood call (a
    tempered update alternates between the new and the old data), and a
    likelihood call inside a CUDA graph capture copies nothing."""

    def __init__(self):
        # id(data) -> (data, {device: tensor}); holding `data` keeps its id
        # from being reused by another object
        self._held = {}

    def get(self, data, device) -> torch.Tensor:
        _, copies = self._held.setdefault(id(data), (data, {}))
        if device not in copies:
            copies[device] = torch.as_tensor(data, dtype=torch.float64,
                                             device=device).contiguous()
        return copies[device]
