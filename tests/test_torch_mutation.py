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


@pytest.mark.parametrize("n_blocks,n_mh_steps", [(3, 2), (2, 1), (1, 3)])
def test_one_eigh_call_per_mutation_step(monkeypatch, n_blocks, n_mh_steps):
    """Every block's factor comes from one eigh_batched call per mutation
    step (AS's 13 parameters in blocks of 5, 5, 3; 7, 6; 13), whatever
    n_mh_steps: the equal blocks as one stack, a smaller last one as a
    second. The step's results are bit for bit those of a factor per block
    from its own eigh call."""
    from smc_tpu_torch.ops import mutation
    from smc_tpu_torch.rng import TorchDraws
    space = ParamSpace(tas.an_schorfheide_parameters())
    model, data = tas.an_schorfheide(), tas.load_as_data()
    ll = lambda t: model.loglike_batched(t, data)
    th = as_posterior_draws(128, seed=6, scale=0.01)
    w = np.random.default_rng(5).uniform(0.5, 1.5, th.shape[0])
    mu, cov = _cloud_moments(th, w)
    th = torch.tensor(th)
    args = (th, ll(th), space.log_prior(th), torch.zeros(th.shape[0]),
            torch.tensor(mu), torch.tensor(cov),
            torch.tensor(np.random.default_rng(7).permutation(13)), 0.3,
            0.4, 0.35)
    step = mutation.make_mutation_step(space, ll, n_blocks, n_mh_steps, 0.9)
    calls, batched = [], mutation.eigh_batched
    monkeypatch.setattr(mutation, "eigh_batched", lambda stacks: (
        calls.append([tuple(s.shape) for s in stacks]), batched(stacks))[1])
    got = step(TorchDraws(3, "cpu"), *args)
    sizes = block_sizes(13, n_blocks)
    n_eq = sizes.count(sizes[0])
    assert calls == [[(n_eq, sizes[0], sizes[0])]
                     + [(1, k, k) for k in sizes[n_eq:]]]

    def per_block(cov_free, perm, sizes):
        out, o = [], 0
        for k in sizes:
            idx = perm[o:o + k]
            cov_b = cov_free[idx][:, idx]
            out.append(mutation._deg_factor(cov_b) + (torch.sqrt(
                torch.clamp(torch.diagonal(cov_b), min=0.0)),))
            o += k
        return out

    monkeypatch.setattr(mutation, "block_factors", per_block)
    want = step(TorchDraws(3, "cpu"), *args)
    assert len(calls) == 1
    # accept_frac counts every MH step's moves over n_free
    assert 0.05 < float(got[4].mean()) / n_mh_steps < 0.95
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
