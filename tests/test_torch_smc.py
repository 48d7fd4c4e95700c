"""smc_tpu_torch's SMC recursion: three stages replayed against the JAX stage
body, whole runs against the regression model's exact posterior and the AS
accuracy gate, and seed determinism."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.smc import make_stage_core as j_make_stage_core
from smc_tpu.models import as_dsge as jas

import smc_tpu_torch
from smc_tpu_torch.params import ParamSpace, ARRAY_FIELDS
from smc_tpu_torch.cloud import weighted_cov
from smc_tpu_torch.smc import make_stage_core
from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.rng import ReplayDraws
from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)

from torch_parity import StubMesh, as_posterior_draws
from torch_replay import stage_replay


def test_three_stages_match_jax_stage_core():
    """Stages 40-42 of the AS schedule at N=256 from a skewed cloud near the
    posterior (the first stage resamples, the others do not)."""
    n = 256
    data = tas.load_as_data()
    jspace = JParamSpace(jas.an_schorfheide_parameters())
    tspace = ParamSpace.from_numpy({k: getattr(jspace, k)
                                    for k in ARRAY_FIELDS})
    jmodel = jas.an_schorfheide()
    jll = jax.jit(lambda t: jmodel.loglike_batched(t, data))
    tmodel = tas.an_schorfheide()
    threshold = 0.5 * n
    jstage = j_make_stage_core(jspace, jll, 1, 1, 0.9, "systematic",
                               threshold)
    tstage = make_stage_core(tspace, lambda t: tmodel.loglike_batched(t, data),
                             1, 1, 0.9, "systematic", threshold)

    th = as_posterior_draws(n, seed=9, scale=0.01)
    ll = np.asarray(jll(jnp.asarray(th)))
    lp = np.asarray(jspace.log_prior(jnp.asarray(th)))
    w = np.exp(2.5 * np.random.default_rng(10).standard_normal(n))
    w = n * w / w.sum()
    jstate = tuple(jnp.asarray(a) for a in (th, ll, lp, np.zeros(n), w))
    tstate = tuple(torch.tensor(a) for a in (th, ll, lp, np.zeros(n), w))
    sched = fixed_schedule(100, 2.0)
    key = jax.random.PRNGKey(11)
    resampled_any = []
    for s in (40, 41, 42):
        phi_n1, phi_n = float(sched[s - 1]), float(sched[s])
        key, skey = jax.random.split(key)
        jout = jstage(skey, *jstate, phi_n, phi_n1, 0.3)
        did = bool(jout[9])
        resampled_any.append(did)
        draws = ReplayDraws(stage_replay(skey, tspace, tstate, phi_n, phi_n1,
                                          threshold, did))
        tout = tstage(draws, *tstate, phi_n, phi_n1, 0.3)
        assert draws.remaining() == 0
        assert tout[9] == did
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
        for i in (0, 1, 4):          # params, loglh, weights
            np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                       rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tout[8], float(jout[8]), rtol=1e-9)
        np.testing.assert_allclose(tout[11], float(jout[11]), rtol=1e-9)
        jstate = tuple(jout[:5])
        tstate = tuple(tout[:5])
    assert resampled_any == [True, False, False]


# --- whole runs on the regression model: exact oracle -----------------------

SIGMA2 = 1.0
PRIOR_SD = 10.0


@pytest.fixture(scope="module")
def oracle():
    """Closed-form posterior N(mu_n, Sigma_n) and log evidence."""
    y, x = generate_regression_data(n=100, seed=1793)
    yv = y[0]
    X = np.column_stack([np.ones_like(x), x])
    prec_n = np.eye(2) / PRIOR_SD ** 2 + X.T @ X / SIGMA2
    Sigma_n = np.linalg.inv(prec_n)
    mu_n = Sigma_n @ (X.T @ yv / SIGMA2)
    S_marg = SIGMA2 * np.eye(len(yv)) + PRIOR_SD ** 2 * X @ X.T
    _, logdet = np.linalg.slogdet(S_marg)
    quad = yv @ np.linalg.solve(S_marg, yv)
    log_z = -0.5 * (len(yv) * np.log(2 * np.pi) + logdet + quad)
    return (y, x), mu_n, Sigma_n, float(log_z)


@pytest.fixture(scope="module")
def runs(oracle):
    (y, x), _, _, _ = oracle
    ll = make_regression_loglike(x, sigma2=SIGMA2)
    return [smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=4000,
                              n_phi=100, lam=2.0, alpha=0.9, verbose="none",
                              seed=7000 + r, device="cpu")
            for r in range(4)]


def test_regression_posterior_mean_matches_analytic(oracle, runs):
    _, mu_n, Sigma_n, _ = oracle
    sd_n = np.sqrt(np.diag(Sigma_n))
    for res in runs:
        mu = res.posterior_mean()
        assert np.all(np.abs(mu - mu_n) < 0.35 * sd_n), (mu, mu_n, sd_n)


def test_regression_posterior_cov_matches_analytic(oracle, runs):
    _, _, Sigma_n, _ = oracle
    for res in runs:
        cov = weighted_cov(res.cloud).numpy()
        assert (np.abs(cov - Sigma_n) / np.abs(Sigma_n).max()).max() < 0.25


def test_regression_log_mdd_matches_analytic(oracle, runs):
    _, _, _, log_z = oracle
    mdds = np.array([res.log_mdd for res in runs])
    assert np.all(np.abs(mdds - log_z) < 0.2), (mdds, log_z)
    for res in runs:   # the w/W bookkeeping: 99 stages + the initial column
        assert res.w.shape == res.W.shape == (4000, 100)
        assert res.cloud.tempering_schedule[-1] == 1.0


# --- whole run on AS: the 4-sd gate of tests/test_as_estimation.py ---------

def test_as_estimation_posterior_within_4_std():
    model = tas.an_schorfheide()
    res = smc_tpu_torch.smc(
        model.loglike_batched, tas.an_schorfheide_parameters(),
        tas.load_as_data(), batched=True, n_parts=400, n_phi=100, lam=2.0,
        resampling_method="systematic", verbose="none", seed=42,
        device="cpu")
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - tas.TRUE_PARAMS) / np.maximum(sd, 1e-9)
    assert np.all(z < 4.0), dict(zip(res.para_names, z))
    assert np.isfinite(res.log_mdd)
    assert np.isfinite(res.cloud.loglh.numpy()).all()
    assert 0.0 < res.cloud.accept_rate < 1.0


def test_same_seed_runs_are_bitwise_equal():
    y, x = generate_regression_data(n=100, seed=1793)
    ll = make_regression_loglike(x)
    a, b = (smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=1000,
                              n_phi=30, lam=2.0, alpha=0.9, verbose="none",
                              seed=3, device="cpu") for _ in range(2))
    assert a.log_mdd == b.log_mdd
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert torch.equal(a.cloud.weights, b.cloud.weights)
    np.testing.assert_array_equal(a.W, b.W)
    c = smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=1000,
                          n_phi=30, lam=2.0, alpha=0.9, verbose="none",
                          seed=4, device="cpu")
    assert not torch.equal(a.cloud.params, c.cloud.params)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(mesh=StubMesh(2), n_parts=401), ValueError, "divisible")])
def test_unported_paths_raise(kwargs, error, match):
    """A mesh whose size does not divide n_parts is refused before anything
    runs."""
    y, x = generate_regression_data(n=10, seed=1)
    kwargs = dict(dict(n_parts=10), **kwargs)
    with pytest.raises(error, match=match):
        smc_tpu_torch.smc(make_regression_loglike(x), regression_parameters(),
                          y, n_phi=3, device="cpu", **kwargs)


def test_fused_runs_and_equals_the_host_loop():
    """fused=True, refused by earlier slices, runs the recursion on device
    buffers and gives the host loop's bits."""
    y, x = generate_regression_data(n=10, seed=1)
    run = lambda fused: smc_tpu_torch.smc(
        make_regression_loglike(x), regression_parameters(), y, n_parts=64,
        n_phi=12, verbose="none", device="cpu", seed=5, fused=fused)
    a, b = run(True), run(False)
    assert (a.fused, b.fused) == (True, False)
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert a.log_mdd == b.log_mdd
    np.testing.assert_array_equal(a.W, b.W)
    assert a.cloud.tempering_schedule == b.cloud.tempering_schedule


@pytest.mark.parametrize("kwargs", [
    dict(use_fixed_schedule=False), dict(save_intermediate=True),
    dict(resampling_method="metropolis"), dict(verbose="high"),
    dict(run_test=True), dict(store_weight_matrices=False)])
def test_formerly_refused_paths_run(kwargs, tmp_path):
    """The paths that earlier slices refused now run; a checkpointing run
    leaves a checkpoint per `intermediate_stage_increment` stages."""
    y, x = generate_regression_data(n=10, seed=1)
    res = smc_tpu_torch.smc(make_regression_loglike(x),
                            regression_parameters(), y, n_parts=50, n_phi=7,
                            device="cpu", savepath=str(tmp_path / "c.npz"),
                            intermediate_stage_increment=3, **kwargs)
    assert res.cloud.tempering_schedule[-1] == 1.0 or kwargs.get("run_test")
    assert np.isfinite(res.log_mdd)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == (["c.npz", "c_stage=3.npz", "c_stage=6.npz"]
                     if kwargs.get("save_intermediate") else ["c.npz"])


def test_verbose_low_prints_each_stage(capsys):
    y, x = generate_regression_data(n=50, seed=2)
    smc_tpu_torch.smc(make_regression_loglike(x), regression_parameters(), y,
                      n_parts=200, n_phi=6, verbose="low", seed=1,
                      device="cpu")
    out = capsys.readouterr().out
    assert out.count("stage ") == 5 and "ESS=" in out


def test_default_device_is_the_card():
    """smc() without `device` runs on the card; without one it raises
    instead of falling back to the CPU."""
    y, x = generate_regression_data(n=20, seed=5)
    call = lambda: smc_tpu_torch.smc(make_regression_loglike(x),
                                     regression_parameters(), y, n_parts=64,
                                     n_phi=3, verbose="none", seed=1)
    if torch.cuda.is_available():
        assert call().cloud.params.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            call()
