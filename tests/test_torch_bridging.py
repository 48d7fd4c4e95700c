"""smc_tpu_torch's tempered updates and bridge distributions: the likelihood
re-evaluation and two bridging stages against the JAX package (the stages
with the JAX draws replayed, to 1e-12), and the three runs of
tests/test_bridging.py at 1,000 particles with its gates.

The runs use the reference's default n_phi = 300 where test_bridging.py uses
100: at 100 stages the half-data estimate misses the exact posterior means
by tens to hundreds in the JAX package too (seeds 42-47, all six), and the
update then recovers or not depending on the stream; at 300 stages the
updates met the gates at every seed tried (42-47)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.cloud import Cloud as JCloud
from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.smc import make_stage_core as j_make_stage_core
from smc_tpu.ops.initialization import (initialize_likelihoods as
                                        j_initialize_likelihoods)
from smc_tpu.models import linear as jl

import smc_tpu_torch
from smc_tpu_torch.cloud import Cloud, weighted_cov
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.smc import make_stage_core
from smc_tpu_torch.ops.correction import correct
from smc_tpu_torch.ops.resample import resample
from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.ops.initialization import initialize_likelihoods
from smc_tpu_torch.rng import ReplayDraws
from smc_tpu_torch.models.linear import (linear_parameters,
                                         make_linear_loglike,
                                         generate_linear_data)

from torch_replay import replay_mutation

TRUE = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])
RTOL = 1e-12
OMEGA = 0.5
LOG_PROB_OLD = -80.0
N_PHI = 300


@pytest.fixture(scope="module")
def fixture():
    data, X = generate_linear_data(seed=1793)
    return data[:, :50], data, X


def _particles(n, seed):
    rng = np.random.default_rng(seed)
    th = TRUE + 0.05 * rng.standard_normal((n, 9))
    w = np.exp(2.0 * rng.standard_normal(n))
    return th, n * w / w.sum()


def test_initialize_likelihoods_matches_jax(fixture):
    half, full, X = fixture
    th, w = _particles(200, seed=1)
    jspace, tspace = JParamSpace(jl.linear_parameters()), ParamSpace(
        linear_parameters())
    jll = jax.vmap(lambda t: jl.make_linear_loglike(X)(t, half))
    tll = torch.func.vmap(lambda t: make_linear_loglike(X)(t, half))
    old = np.asarray(jll(jnp.asarray(th)))
    fields = dict(params=th, loglh=old, logprior=np.zeros(200),
                  old_loglh=np.zeros(200), accept=np.zeros(200), weights=w)
    jc = JCloud(**{k: jnp.asarray(v) for k, v in fields.items()})
    tc = Cloud.from_numpy(fields, device="cpu")
    jc = j_initialize_likelihoods(
        jc, jspace, jax.vmap(lambda t: jl.make_linear_loglike(X)(t, full)))
    tc = initialize_likelihoods(
        tc, tspace, torch.func.vmap(lambda t: make_linear_loglike(X)(t, full)))
    np.testing.assert_array_equal(tc.old_loglh.numpy(), old)
    for k in ("loglh", "logprior"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), rtol=RTOL)


def _stage_replay(skey, tspace, state, phi_n, phi_n1, threshold, resampled,
                  sizes):
    """The draws of one bridging stage, from the JAX stage key, in the
    port's order (see tests/test_torch_smc.py)."""
    kr, kp, km = jax.random.split(skey, 3)
    params, loglh, logprior, old, weights = state
    _, norm_w, ess, _ = correct(loglh, old, weights, phi_n, phi_n1, OMEGA,
                                LOG_PROB_OLD)
    assert bool(ess < threshold) == resampled
    u = np.asarray(jax.random.uniform(kr, (), dtype=jnp.float64))
    entries, w = [("uniform", u)], norm_w
    if resampled:
        params = params[resample(ReplayDraws([("uniform", u)]), norm_w)]
        w = torch.ones_like(norm_w)
    perm = np.asarray(jax.random.permutation(kp, tspace.n_free))
    entries.append(("permutation", perm))
    cov = weighted_cov(params, w)
    cov = (0.5 * (cov + cov.T)).numpy()
    return entries + replay_mutation(km, params.shape[0], cov, perm, sizes,
                                     0.9)


def test_bridging_stages_match_jax_stage_core(fixture):
    """Two stages (the first resamples) with omega = 0.5, the old data's
    likelihood in every proposal, 3 blocks, at N = 256."""
    half, full, X = fixture
    n = 256
    jspace = JParamSpace(jl.linear_parameters())
    tspace = ParamSpace(linear_parameters())
    j_new = jax.jit(jax.vmap(lambda t: jl.make_linear_loglike(X)(t, full)))
    j_old = jax.jit(jax.vmap(lambda t: jl.make_linear_loglike(X)(t, half)))
    t_new = torch.func.vmap(lambda t: make_linear_loglike(X)(t, full))
    t_old = torch.func.vmap(lambda t: make_linear_loglike(X)(t, half))
    threshold = 0.5 * n
    args = (3, 1, 0.9, "systematic", threshold, OMEGA, LOG_PROB_OLD)
    jstage = j_make_stage_core(jspace, j_new, *args, j_old)
    tstage = make_stage_core(tspace, t_new, *args, t_old)

    th, w = _particles(n, seed=2)
    jth = jnp.asarray(th)
    state = (th, np.asarray(j_new(jth)), np.asarray(jspace.log_prior(jth)),
             np.asarray(j_old(jth)), w)
    jstate = tuple(jnp.asarray(a) for a in state)
    tstate = tuple(torch.tensor(a) for a in state)
    sched = fixed_schedule(100, 2.1)
    key = jax.random.PRNGKey(5)
    did_all = []
    for s in (40, 41):
        phi_n1, phi_n = float(sched[s - 1]), float(sched[s])
        key, skey = jax.random.split(key)
        jout = jstage(skey, *jstate, phi_n, phi_n1, 0.4)
        did = bool(jout[9])
        did_all.append(did)
        draws = ReplayDraws(_stage_replay(skey, tspace, tstate, phi_n, phi_n1,
                                          threshold, did, [3, 3, 3]))
        tout = tstage(draws, *tstate, phi_n, phi_n1, 0.4)
        assert draws.remaining() == 0
        assert tout[9] == did
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
        for i in (0, 1, 2, 3, 4, 6):  # params .. weights, inc_w
            np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                       rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(tout[8], float(jout[8]), rtol=RTOL)
        np.testing.assert_allclose(tout[11], float(jout[11]), rtol=RTOL)
        jstate, tstate = tuple(jout[:5]), tuple(tout[:5])
    assert did_all == [True, False]
    assert np.any(tstate[3].numpy() != state[3])   # old_loglh moved


@pytest.fixture(scope="module")
def old_result(fixture):
    half, _, X = fixture
    return smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(),
                             half, n_parts=1000, n_phi=N_PHI, lam=2.1,
                             alpha=0.9, resampling_method="polyalgo",
                             verbose="none", seed=42, device="cpu")


# (n_parts, prior weight, seed, gate): the three runs of test_bridging.py
RUNS = {"prior_weight_zero": (1000, 0.0, 43, 0.5),
        "bridge_distribution": (1000, 0.5, 44, 0.5),
        "bridge_with_different_n_parts": (500, 0.0, 45, 0.6)}


@pytest.mark.parametrize("run", list(RUNS))
def test_tempered_update_runs(fixture, old_result, run):
    half, full, X = fixture
    n_parts, omega, seed, gate = RUNS[run]
    before = old_result.cloud.params.clone()
    res = smc_tpu_torch.smc(
        make_linear_loglike(X), linear_parameters(), full, n_parts=n_parts,
        n_phi=N_PHI, lam=2.1, alpha=0.9, resampling_method="polyalgo",
        verbose="none", seed=seed, old_data=half, old_cloud=old_result.cloud,
        tempered_update_prior_weight=omega,
        log_prob_old_data=old_result.log_mdd, device="cpu")
    assert res.cloud.n_parts == n_parts
    assert np.max(np.abs(res.posterior_mean() - TRUE)) < gate
    assert np.any(res.cloud.old_loglh.numpy() != 0.0)
    assert torch.equal(old_result.cloud.params, before)   # not modified
    assert np.isfinite(res.log_mdd)


def test_invalid_prior_weight_raises(fixture, old_result):
    half, full, X = fixture
    with pytest.raises(ValueError, match="tempered_update_prior_weight"):
        smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(), full,
                          old_data=half, old_cloud=old_result.cloud,
                          tempered_update_prior_weight=1.5, device="cpu")
