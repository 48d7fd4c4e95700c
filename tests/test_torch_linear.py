"""smc_tpu_torch's linear fixture, parameter transforms and distributions
against the JAX package: the data generators bit for bit, the parameter
spaces' arrays, the log-likelihoods to rtol 1e-12 (-inf where sigma <= 0),
the exact posterior, the transforms and the distribution helpers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.models import linear as jl
from smc_tpu import distributions as jd

from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.models import linear as tl
from smc_tpu_torch import distributions as td
from smc_tpu_torch.rng import TorchDraws


def test_data_generators_are_bitwise_equal():
    for seed in (1793, 7):
        for t_fn, j_fn in ((tl.generate_linear_data, jl.generate_linear_data),
                           (tl.generate_rs_linear_data,
                            jl.generate_rs_linear_data)):
            for a, b in zip(t_fn(seed), j_fn(seed)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rs", [False, True])
def test_param_space_arrays_match_jax(rs):
    t = ParamSpace(tl.linear_parameters(rs), regime_switching=rs)
    j = JParamSpace(jl.linear_parameters(rs), regime_switching=rs)
    assert t.names == j.names
    for k in ("values", "lo", "hi", "fixed", "prior_family", "prior_a",
              "prior_b", "_tn_logz", "free_inds"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    np.testing.assert_array_equal(t.regime_matrix(), j.regime_matrix())
    assert len(t) == len(j)
    assert ([type(s[0]).__name__ for s in t._column_specs()]
            == [type(s[0]).__name__ for s in j._column_specs()])
    assert ([s[1:] for s in t._column_specs()]
            == [s[1:] for s in j._column_specs()])


def _thetas(n_para, seed, n=64):
    """Seeded thetas around the truth, with sigma <= 0 in some rows."""
    rng = np.random.default_rng(seed)
    th = 1.0 + rng.standard_normal((n, n_para))
    th[::5, 2] = -np.abs(th[::5, 2])
    th[3, 5] = 0.0
    th[7, 8] = -1e-3
    return th


@pytest.mark.parametrize("variant", ["linear", "rs"])
def test_loglike_matches_jax(variant):
    """Per theta and vmapped, rtol 1e-12; -inf at the same thetas."""
    if variant == "linear":
        data, X = tl.generate_linear_data(seed=1793)
        tll = tl.make_linear_loglike(X)
        jll = jl.make_linear_loglike(X)
        n_para = 9
    else:
        data, X = tl.generate_rs_linear_data(seed=1793)
        tsp = ParamSpace(tl.rs_linear_parameters(), regime_switching=True)
        jsp = JParamSpace(jl.rs_linear_parameters(), regime_switching=True)
        tll = tl.make_rs_linear_loglike(X, tsp)
        jll = jl.make_rs_linear_loglike(X, jsp)
        n_para = tsp.n_para
    th = _thetas(n_para, seed=11)
    want = np.asarray(jax.vmap(lambda t: jll(t, data))(jnp.asarray(th)))
    got = torch.func.vmap(lambda t: tll(t, data))(torch.tensor(th)).numpy()
    one = np.array([float(tll(torch.tensor(t), data)) for t in th])
    fin = np.isfinite(want)
    assert 0 < (~fin).sum() < len(th)
    assert np.all(np.isneginf(want[~fin]))
    for g in (got, one):
        np.testing.assert_array_equal(np.isneginf(g), ~fin)
        np.testing.assert_allclose(g[fin], want[fin], rtol=1e-12)


def test_exact_posterior_matches_jax():
    data, X = tl.generate_linear_data(seed=1793)
    t = tl.exact_linear_posterior(data, X, n_grid=800)
    j = jl.exact_linear_posterior(data, X, n_grid=800)
    for k in ("mean", "sd"):
        np.testing.assert_array_equal(t[k], j[k])
    assert t["log_evidence"] == j["log_evidence"]


def test_transforms_match_jax():
    t = ParamSpace(tl.linear_parameters())
    j = JParamSpace(jl.linear_parameters())
    rng = np.random.default_rng(3)
    th = rng.uniform(0.5, 3.0, (20, 9))
    real = t.to_real(torch.tensor(th)).numpy()
    np.testing.assert_allclose(real, np.asarray(j.to_real(jnp.asarray(th))),
                               rtol=1e-13)
    # from_real adds (hi - lo) / 2 z to (lo + hi) / 2 at bounds (1e-5, 1e5):
    # one rounding of z in either package moves the result by 5e4 ulp(z),
    # so the two agree to a few 1e5 eps absolute
    np.testing.assert_allclose(t.from_real(torch.tensor(real)).numpy(),
                               np.asarray(j.from_real(jnp.asarray(real))),
                               rtol=1e-13, atol=4e5 * np.finfo(float).eps)
    # the round trip through SquareRoot on (1e-5, 1e5) loses ~1e5 eps
    np.testing.assert_allclose(t.from_real(torch.tensor(real)).numpy(), th,
                               rtol=1e-10)
    from smc_tpu.params import Exponential as JExp
    from smc_tpu_torch.params import Exponential
    x = np.array([0.3, 2.0, 9.0])
    np.testing.assert_allclose(
        Exponential().to_real(torch.tensor(x), 0.1, np.inf).numpy(),
        np.asarray(JExp().to_real(jnp.asarray(x), 0.1, np.inf)), rtol=1e-14)


DISTS = [("Normal", (0.3, 1.7)), ("Uniform", (-1.0, 2.0)),
         ("Gamma", (2.5, 0.4)), ("Beta", (2.0, 3.0)),
         ("InverseGamma", (3.0, 2.0)), ("RootInverseGamma", (4.0, 0.4)),
         ("TruncatedNormal", (0.0, 1.0))]


@pytest.mark.parametrize("name,ab", DISTS)
def test_distribution_methods_match_jax(name, ab):
    t, j = getattr(td, name)(*ab), getattr(jd, name)(*ab)
    x = np.linspace(-0.5, 3.0, 15)
    np.testing.assert_allclose(t.logpdf(torch.tensor(x)).numpy(),
                               np.asarray(j.logpdf(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(t.mean(), j.mean(), rtol=1e-14)
    s = t.sample(TorchDraws(5, device="cpu"), (4000,))
    assert s.shape == (4000,) and s.dtype == torch.float64
    if name != "TruncatedNormal":      # bounds belong to the parameter
        assert abs(s.mean().item() - t.mean()) < 0.1 * (1 + abs(t.mean()))


def test_degenerate_mvnormal_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((4, 2))
    cov = A @ A.T                       # rank 2
    mu = rng.standard_normal(4)
    x = mu + rng.standard_normal((10, 2)) @ A.T
    t = td.DegenerateMvNormal(mu, cov, device="cpu")
    j = jd.DegenerateMvNormal(mu, cov)
    np.testing.assert_allclose(t.logpdf(torch.tensor(x)).numpy(),
                               np.asarray(j.logpdf(jnp.asarray(x))),
                               rtol=1e-10)
    assert float(t.rank) == 2.0
    np.testing.assert_array_equal(td.get_cov(t).numpy(), cov)
    draws = t.rand(TorchDraws(1, device="cpu"), (3,))
    assert draws.shape == (3, 4)
    # the draws lie in the span of the covariance
    resid = (draws - torch.tensor(mu)).numpy()
    proj = A @ np.linalg.lstsq(A, resid.T, rcond=None)[0]
    np.testing.assert_allclose(proj.T, resid, atol=1e-10)
