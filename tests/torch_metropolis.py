"""Shared inputs for the tests of the Metropolis chain
(csrc/metropolis_chain.cuh through its host build, ops/cuda_metropolis.py's
plain version and, on a card, its kernel). Not a test module itself, and it
imports no jax."""

import numpy as np
import torch

# Random123's known-answer vectors of Philox4x32-10: counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]

# the chain's cases: sizes, n_out != n (the bridge), degenerate weights, a
# capped chain and a stage that does not resample
CHAIN_CASES = ("n1", "n7", "n4096", "n_out_less", "n_out_more", "zero",
               "nan", "nan_inside", "spike", "capped", "no_resample")


def chain_case(name: str, seed: int = 0):
    """(weights f64 [n], n_out, steps, cap, flag, key int64 [2]) of one
    case, made with numpy: `steps` is an int, or None for chain_steps'
    Doeblin length under the cap `cap`."""
    rng = np.random.default_rng([CHAIN_CASES.index(name), seed])
    key = rng.integers(0, 2 ** 32, 2)
    lognormal = lambda n: np.exp(1.5 * rng.standard_normal(n))
    n, n_out, steps, cap, flag = 64, None, None, 10_000, True
    if name == "n1":
        w, steps = lognormal(1), 5
    elif name == "n7":
        w, steps = lognormal(7), 33
    elif name == "n4096":
        w = lognormal(4096)
    elif name == "n_out_less":
        w, n_out = lognormal(300), 120
    elif name == "n_out_more":
        w, n_out = lognormal(100), 250
    elif name == "zero":
        w, steps = np.zeros(n), 20
    elif name == "nan":
        w = np.full(n, np.nan)
    elif name == "nan_inside":
        w, steps = lognormal(n), 30
        w[rng.choice(n, 5, replace=False)] = np.nan
    elif name == "spike":
        w = np.zeros(n)
        w[17] = 1.0
    elif name == "capped":
        w, cap = np.ones(n), 40
        w[5] = 1e3
    elif name == "no_resample":
        w, flag = lognormal(n), False
    else:
        raise ValueError(name)
    return (w, w.shape[0] if n_out is None else n_out, steps, cap, flag,
            torch.as_tensor(key, dtype=torch.int64))
