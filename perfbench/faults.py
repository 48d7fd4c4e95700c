"""Faults planted in the program's timed path underneath a run: each a
context manager that patches the stage body of smc_tpu_torch's driver
(module smc_tpu_torch.smc) and undoes it on exit. control.py --fault reads
a cell's numbers under one, on a card at the cell's size; the tests see
`correct` come out false under each.

  frozen_mutation  the mutation rejects every proposal: the particles stay
                   where the initial draw and the resampling put them
  wrong_phi        the correction weights by exp(phi_n l) in place of
                   exp((phi_n - phi_{n-1}) l)
"""

from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def _patched(name, make):
    import smc_tpu_torch  # noqa: F401  (loads smc_tpu_torch.smc)
    mod = sys.modules["smc_tpu_torch.smc"]
    real = getattr(mod, name)
    setattr(mod, name, make(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def frozen_mutation():
    def make(real):
        def make_mutation_step(*args, **kwargs):
            def step(draws, params, loglh, logprior, old_loglh, *rest):
                import torch
                return (params, loglh, logprior, old_loglh,
                        torch.zeros_like(loglh))
            return step
        return make_mutation_step
    return _patched("make_mutation_step", make)


def wrong_phi():
    def make(real):
        def correct(loglh, old_loglh, weights, phi_n, phi_n1, *rest):
            return real(loglh, old_loglh, weights, phi_n, 0.0 * phi_n1,
                        *rest)
        return correct
    return _patched("correct", make)


FAULTS = {"frozen_mutation": frozen_mutation, "wrong_phi": wrong_phi}
