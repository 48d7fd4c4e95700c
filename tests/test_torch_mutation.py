"""smc_tpu_torch make_mutation_step against the JAX package's, with the JAX
draws replayed through ReplayDraws.

The eigenvector signs of torch.linalg.eigh and jnp.linalg.eigh may differ;
torch_replay.replay_mutation undoes that. The covariances here have
well-separated eigenvalues, so each eigenvector is unique up to sign."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.ops.mutation import make_mutation_step as j_make_mutation_step
from smc_tpu.models import as_dsge as jas
from smc_tpu.models.regression import (regression_parameters as j_reg_params,
                                       make_regression_loglike as j_reg_ll,
                                       generate_regression_data)

from smc_tpu_torch.params import ParamSpace, ARRAY_FIELDS
from smc_tpu_torch.ops.mutation import make_mutation_step, block_sizes
from smc_tpu_torch.rng import ReplayDraws
from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models.regression import make_regression_loglike

from torch_parity import as_posterior_draws
from torch_replay import replay_mutation


def _cloud_moments(th, w):
    mu = w @ th / w.sum()
    dev = th - mu
    cov = (dev.T * w) @ dev / w.sum()
    return mu, 0.5 * (cov + cov.T)


def _run_both(jspace, tspace, jll, tll, th, n_blocks, alpha, perm, phi,
              seed, c=0.45):
    n = th.shape[0]
    ll = np.asarray(jll(jnp.asarray(th)))
    lp = np.asarray(jspace.log_prior(jnp.asarray(th)))
    assert np.isfinite(ll).all() and np.isfinite(lp).all()
    old = np.zeros(n)
    w = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    mu, cov = _cloud_moments(th, w)
    key = jax.random.PRNGKey(seed)
    jstep = j_make_mutation_step(jspace, jll, n_blocks, 1, alpha)
    want = jstep(key, jnp.asarray(th), jnp.asarray(ll), jnp.asarray(lp),
                 jnp.asarray(old), jnp.asarray(mu), jnp.asarray(cov),
                 jnp.asarray(perm), c, phi, phi - 0.05)
    draws = ReplayDraws(replay_mutation(
        key, n, cov, perm, block_sizes(jspace.n_free, n_blocks), alpha))
    tstep = make_mutation_step(tspace, tll, n_blocks, 1, alpha)
    T = lambda a: torch.tensor(np.asarray(a))
    got = tstep(draws, T(th), T(ll), T(lp), T(old), T(mu), T(cov),
                T(perm), c, phi, phi - 0.05)
    assert draws.remaining() == 0
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    # acceptance identical, then the states
    np.testing.assert_array_equal(got[4], want[4])
    assert 0.05 < got[4].mean() < 0.95
    for g, j_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, j_, rtol=1e-10, atol=1e-12)


def test_mutation_regression_two_blocks_matches_jax():
    y, x = generate_regression_data(n=100, seed=1793)
    jspace = JParamSpace(j_reg_params())
    tspace = ParamSpace.from_numpy({k: getattr(jspace, k)
                                    for k in ARRAY_FIELDS})
    jll1 = j_reg_ll(x)
    jll = jax.jit(jax.vmap(lambda t: jll1(t, y)))
    tll1 = make_regression_loglike(x)
    tll = lambda t: tll1(t, y)
    rng = np.random.default_rng(4)
    th = np.column_stack([1.0 + 0.3 * rng.standard_normal(512),
                          1.0 + 0.5 * rng.standard_normal(512)])
    _run_both(jspace, tspace, jll, tll, th, n_blocks=2, alpha=0.9,
              perm=np.array([1, 0]), phi=0.4, seed=5)


def test_mutation_as_one_block_matches_jax():
    data = tas.load_as_data()
    jspace = JParamSpace(jas.an_schorfheide_parameters())
    tspace = ParamSpace.from_numpy({k: getattr(jspace, k)
                                    for k in ARRAY_FIELDS})
    jmodel = jas.an_schorfheide()
    jll = jax.jit(lambda t: jmodel.loglike_batched(t, data))
    tmodel = tas.an_schorfheide()
    tll = lambda t: tmodel.loglike_batched(t, data)
    th = as_posterior_draws(256, seed=6, scale=0.01)
    perm = np.random.default_rng(7).permutation(13)
    _run_both(jspace, tspace, jll, tll, th, n_blocks=1, alpha=0.9,
              perm=perm, phi=0.3, seed=8, c=0.3)
