"""smc_tpu_torch's Metropolis resampler: the fixed-length chain against the
JAX package's `_metropolis` with its draws replayed (indices equal), the
adaptive Doeblin length and its cap, a chi-square check of ancestor
counts against the weights, and the adaptive chain's Philox stream
(ops/cuda_metropolis.py's plain version) against its known answers."""

import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from scipy import stats

from smc_tpu.ops import resample as jr

from smc_tpu_torch.ops import cuda_metropolis
from smc_tpu_torch.ops.resample import (resample, metropolis_n_iter,
                                        metropolis_chain_length, _CHAIN_BLOCK,
                                        VALID_METHODS, chain_steps,
                                        metropolis_adaptive)
from smc_tpu_torch.rng import ReplayDraws, TorchDraws


def _weights(n, seed, skew=1.5):
    w = np.exp(skew * np.random.default_rng(seed).standard_normal(n))
    return n * w / w.sum()


def _jax_chain_draws(key, n, n_out, n_iter):
    """The proposals and uniforms JAX's `_metropolis` draws from `key`, as
    the port asks for them: per block of up to _CHAIN_BLOCK steps, the
    integers, then the uniforms."""
    kp, ku = jax.random.split(key)
    props = np.asarray(jax.random.randint(kp, (n_iter, n_out), 0, n))
    us = np.asarray(jax.random.uniform(ku, (n_iter, n_out),
                                       dtype=jnp.float64))
    entries = []
    for s in range(0, n_iter, _CHAIN_BLOCK):
        entries += [("integers", props[s:s + _CHAIN_BLOCK]),
                    ("uniform", us[s:s + _CHAIN_BLOCK])]
    return entries


@pytest.mark.parametrize("n,n_out,n_iter", [(300, 300, 50), (300, 120, 40),
                                            (200, 200, 300)])
def test_fixed_chain_matches_jax_under_replay(n, n_out, n_iter):
    """Equal indices; (200, 200, 300) crosses the port's 128-step draw
    blocks, (300, 120, 40) draws fewer indices than weights (the bridge)."""
    w = _weights(n, seed=n_iter)
    key = jax.random.PRNGKey(n_iter)
    want = np.asarray(jr._metropolis(key, jnp.asarray(w), n_out, n_iter))
    draws = ReplayDraws(_jax_chain_draws(key, n, n_out, n_iter))
    got = resample(draws, torch.tensor(w), method="metropolis",
                   n_parts=n_out, n_iter=n_iter)
    assert draws.remaining() == 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_doeblin_length():
    """B = ceil(kappa ln(1/eps)), kappa = max(w) / mean(w), in all three
    forms (the JAX helper, the port's host helper and its device one)."""
    for seed, eps in ((1, 0.01), (2, 0.01), (3, 1e-4)):
        w = _weights(1000, seed)
        want = math.ceil(w.max() / w.mean() * math.log(1.0 / eps))
        assert metropolis_n_iter(w, eps) == want == jr.metropolis_n_iter(
            w, eps)
        assert metropolis_chain_length(torch.tensor(w), eps) == (want, want)
    assert metropolis_chain_length(torch.ones(50)) == (5, 5)


def test_chain_length_cap_warns():
    """One weight holding most of the mass: kappa ~ N, the Doeblin length
    passes the 10,000 cap, the chain runs 10,000 steps and a warning says
    so; below the cap nothing warns."""
    w = torch.ones(5000, dtype=torch.float64)
    w[17] = 1e6
    with pytest.warns(UserWarning, match="capped at 10000"):
        steps, doeblin = metropolis_chain_length(w)
    assert steps == 10_000 and doeblin > 10_000
    assert doeblin == math.ceil(float(w.max() / w.mean()) * math.log(100.0))
    with pytest.warns(UserWarning, match="capped at 30"):
        idx = resample(TorchDraws(0, device="cpu"), w, method="metropolis",
                       n_iter_max=30)
    assert idx.shape == (5000,)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        metropolis_chain_length(torch.tensor(_weights(5000, 4)))


def test_metropolis_ancestor_counts_follow_the_weights():
    """20,000 ancestors from 40 weights, chain length for a 1e-6 bias bound:
    the counts pass a chi-square test against N w / sum(w) at 0.1%."""
    w = _weights(40, seed=6, skew=1.0)
    n_out = 20_000
    idx = resample(TorchDraws(11, device="cpu"), torch.tensor(w),
                   method="metropolis", n_parts=n_out, eps=1e-6)
    counts = np.bincount(idx.numpy(), minlength=40)
    expected = n_out * w / w.sum()
    assert stats.chisquare(counts, expected).pvalue > 1e-3


def test_metropolis_is_a_valid_method():
    assert "metropolis" in VALID_METHODS
    assert VALID_METHODS == jr.VALID_METHODS
    with pytest.raises(ValueError, match="Invalid resampler"):
        resample(TorchDraws(0, device="cpu"), torch.ones(4), method="alias")


@pytest.mark.parametrize("vector", range(3))
def test_philox_plain_known_answers(vector):
    """The plain version's Philox4x32-10 (int64 words, products split in
    16-bit halves) gives Random123's known-answer outputs, all-ones words
    included (where an unsplit product would pass 2^63)."""
    from torch_metropolis import PHILOX_KAT
    ctr, key, want = PHILOX_KAT[vector]
    out = cuda_metropolis.philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(x) for x in out) == want


def test_chain_steps_match_jax_and_define_the_edges():
    """The device Doeblin length equals the JAX package's metropolis_n_iter;
    the steps are capped; a non-finite kappa (NaN or zero weights) gives
    0 steps and a Doeblin length of 0, and the chain is then the
    identity."""
    for seed, eps in ((1, 0.01), (2, 1e-3)):
        w = _weights(3000, seed)
        steps, doeblin = chain_steps(torch.tensor(w), eps, 50)
        assert float(doeblin) == jr.metropolis_n_iter(w, eps)
        assert int(steps) == min(50, jr.metropolis_n_iter(w, eps))
    for bad in (torch.full((9,), math.nan, dtype=torch.float64),
                torch.zeros(9, dtype=torch.float64)):
        steps, doeblin = chain_steps(bad)
        assert (int(steps), float(doeblin)) == (0, 0.0)
        idx, doeblin = metropolis_adaptive(TorchDraws(0, "cpu"), bad)
        assert torch.equal(idx, torch.arange(9)) and float(doeblin) == 0.0


def test_adaptive_chain_draws_one_key_whatever_the_flag():
    """A stage's draws do not depend on its data: one [2] key is drawn
    where the flag is false too, and the chain is then the identity with a
    Doeblin length of 0."""
    w = torch.tensor(_weights(100, 3))
    for flag in (True, False):
        draws = ReplayDraws([("integers", np.array([7, 11]))])
        idx, doeblin = metropolis_adaptive(draws, w, flag=torch.tensor(flag))
        assert draws.remaining() == 0
        assert (float(doeblin) > 0) == flag
        assert torch.equal(idx, torch.arange(100)) != flag
