"""smc_tpu_torch's Smets-Wouters model (models/sw_dsge.py) against the JAX
package on the CPU: the system matrices, the solve at the mode, passive
policy, the likelihood at 21 draws and the prior (test_torch_sw_data.py
holds the data, the loader and a smoke run)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.models import sw_dsge as jsw
from smc_tpu.params import ParamSpace as JParamSpace

from smc_tpu_torch.models import sw_dsge as tsw
from smc_tpu_torch.models.dsge import solve_linear_re
from smc_tpu_torch.params import ParamSpace

from test_torch_cuda import assert_sw_loglh_close


@pytest.fixture(scope="module")
def sw_case():
    """TRUE_PARAMS, 16 prior draws (the JAX package's sampler) and 4 draws
    within 1e-4 (relative) of TRUE_PARAMS through the JAX package: system
    matrices, measurement, shock covariance, the batched likelihood on the
    committed data, and the log prior."""
    draws = np.asarray(JParamSpace(jsw.sw_parameters()).sample_prior(
        jax.random.PRNGKey(0), 16))
    near = jsw.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                              .standard_normal((4, 36)))
    th = np.vstack([jsw.TRUE_PARAMS[None], draws, near])
    tj = jnp.asarray(th)
    bl = lambda x: np.asarray(jnp.moveaxis(x, 0, -1))
    sys_j = [bl(m) for m in jax.vmap(jsw._system)(tj)]
    d, Z, H = jax.vmap(jsw._measurement)(tj)
    Q = jax.vmap(jsw._shock_cov)(tj)
    data = tsw.load_sw_data()
    model = jsw.smets_wouters()
    ll = jax.jit(lambda t: model.loglike_batched(t, data))(tj)
    lp = JParamSpace(jsw.sw_parameters()).log_prior(tj)
    return dict(th=th, sys=sys_j, d=bl(d), Z=bl(Z), H=bl(H), Q=bl(Q),
                data=data, ll=np.asarray(ll), lp=np.asarray(lp))


def test_dimensions():
    assert len(tsw.PARAM_NAMES) == len(tsw.sw_parameters()) == 36
    assert tsw.N_STATE == len(tsw.STATE_NAMES) == 37
    assert tsw.STATE_NAMES == jsw.STATE_NAMES
    assert tsw.SHOCK_NAMES == jsw.SHOCK_NAMES and tsw.N_OBS == jsw.N_OBS
    assert (tsw.CTOU, tsw.CLANDAW, tsw.CG, tsw.CURVP, tsw.CURVW) == \
        (jsw.CTOU, jsw.CLANDAW, jsw.CG, jsw.CURVP, jsw.CURVW)


def test_system_matrices_match_jax(sw_case):
    th = torch.as_tensor(sw_case["th"])
    for got, want in zip(tsw._system(th), sw_case["sys"]):
        assert got.is_contiguous() and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    d, Z, H = tsw._measurement(th)
    for got, key in ((d, "d"), (Z, "Z"), (H, "H")):
        np.testing.assert_allclose(got.numpy(), sw_case[key], rtol=1e-14,
                                   atol=1e-14)
    np.testing.assert_allclose(tsw._shock_cov(th).numpy(), sw_case["Q"],
                               rtol=1e-14, atol=1e-14)


def test_solution_at_mode_matches_jax():
    A, B, C, D = (m[..., 0] for m in tsw._system(
        torch.as_tensor(tsw.TRUE_PARAMS)[None]))
    X, M, ok = solve_linear_re(A, B, C, D)
    assert bool(ok)
    assert (A + B @ X + C @ (X @ X)).abs().max().item() < 1e-8
    Xj, Mj, okj = jax.jit(jsw_solve)(jnp.asarray(jsw.TRUE_PARAMS))
    assert bool(okj)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=1e-10,
                               atol=1e-10)
    idx = {n: i for i, n in enumerate(tsw.STATE_NAMES)}
    assert abs(X[idx["a"], idx["a"]].item() - 0.95) < 1e-8
    assert abs(X[idx["ylag"], idx["y"]].item() - 1.0) < 1e-8


def jsw_solve(theta):
    from smc_tpu.models.dsge import solve_linear_re as j_solve
    return j_solve(*jsw._system(theta))


def test_passive_policy_rejected():
    theta = tsw.TRUE_PARAMS.copy()
    theta[10], theta[12], theta[13] = 0.5, 0.001, 0.001
    A, B, C, D = (m[..., 0] for m in tsw._system(
        torch.as_tensor(theta)[None]))
    assert not bool(solve_linear_re(A, B, C, D)[2])


def test_likelihood_matches_jax(sw_case):
    """The 21 draws' likelihoods in SW's bands; the draws near the mode
    are in the posterior band, and a perturbed mode fits worse."""
    model = tsw.smets_wouters()
    ll = model.loglike_batched(torch.as_tensor(sw_case["th"]),
                               sw_case["data"]).numpy()
    assert np.isfinite(ll).all()
    assert_sw_loglh_close(ll, sw_case["ll"])
    np.testing.assert_allclose(
        model.loglike(torch.as_tensor(tsw.TRUE_PARAMS), sw_case["data"])
        .item(), ll[0], rtol=1e-13)
    th2 = tsw.TRUE_PARAMS.copy()
    th2[0], th2[20] = 8.0, 0.5
    assert model.loglike(torch.as_tensor(th2), sw_case["data"]).item() < ll[0]


def test_log_prior_matches_jax(sw_case):
    """Equal to the JAX package's log prior once its Beta normalizers are
    taken from scipy: jax.scipy.special.betaln is off by up to 2.9e-7 at
    SW's asymmetric Beta priors (e.g. Beta(14, 6)), where the port's
    lgamma form agrees with scipy to 4e-15."""
    from scipy import special
    from jax.scipy import special as jspecial
    lp = ParamSpace(tsw.sw_parameters()).log_prior(
        torch.as_tensor(sw_case["th"]))
    shift = sum(float(jspecial.betaln(p.prior.a, p.prior.b))
                - special.betaln(p.prior.a, p.prior.b)
                for p in jsw.sw_parameters() if p.prior.family == "beta")
    assert 1e-7 < abs(shift) < 1e-5
    np.testing.assert_allclose(lp.numpy(), sw_case["lp"] + shift, rtol=1e-13)
