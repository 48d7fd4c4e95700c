"""smc_tpu_torch's small-matrix linear algebra (ops/linalg.py), the
per-particle DSGE functions and LinearDSGE's API (models/dsge.py) and the
model library's exports, against the JAX package on the CPU."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
from scipy import linalg as sla

import smc_tpu.models as jmodels
from smc_tpu.models import dsge as jdsge
from smc_tpu.models import as_dsge as jas
from smc_tpu.ops import linalg as jlin

import smc_tpu_torch.models as tmodels
from smc_tpu_torch.models import dsge as tdsge
from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models import sw_dsge as tsw
from smc_tpu_torch.ops import linalg as tlin
from smc_tpu_torch.rng import ReplayDraws

from torch_parity import as_prior_draws, assert_loglh_close


def _spd(n, N, seed):
    """N symmetric PD [n, n] matrices, batch-last."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, n, n))
    F = G @ np.swapaxes(G, 1, 2) + 0.5 * np.eye(n)
    return np.ascontiguousarray(np.moveaxis(F, 0, -1))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# ops/linalg.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["bl_chol_solve", "bl_psd_fast_solve"])
@pytest.mark.parametrize("n", [2, 3, 7])
def test_psd_solves_match_jax(fn, n):
    F = _spd(n, 64, seed=n)
    B = np.random.default_rng(10 + n).standard_normal((n, 4, 64))
    X, logdet = getattr(tlin, fn)(_t(F), _t(B))
    Xj, logdet_j = getattr(jlin, fn)(_j(F), _j(B))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(logdet_j),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 7])
def test_chol_solve_non_pd_lanes_match_jax(n):
    """Lanes with a negative eigenvalue get NaN in X and logdet in both
    packages, and the PD lanes are untouched (the likelihood tests hold the
    resulting -inf pattern against the JAX package's)."""
    F = _spd(n, 64, seed=20 + n)
    bad = np.arange(64) % 5 == 0
    F[n - 1, n - 1, bad] = -3.0 - F[n - 1, n - 1, bad]
    B = np.ones((n, 2, 64))
    X, logdet = tlin.bl_chol_solve(_t(F), _t(B))
    Xj, logdet_j = jlin.bl_chol_solve(_j(F), _j(B))
    np.testing.assert_array_equal(np.isnan(logdet.numpy()),
                                  np.isnan(np.asarray(logdet_j)))
    np.testing.assert_array_equal(np.isnan(logdet.numpy()), bad)
    np.testing.assert_array_equal(np.isnan(X.numpy()).any(axis=(0, 1)), bad)
    np.testing.assert_allclose(X.numpy()[..., ~bad], np.asarray(Xj)[..., ~bad],
                               rtol=1e-12, atol=1e-12)


def test_chol_solve_nan_lane_isolated():
    F = _spd(7, 64, seed=3)
    B = np.random.default_rng(4).standard_normal((7, 3, 64))
    X, logdet = tlin.bl_chol_solve(_t(F), _t(B))
    F_nan = F.copy()
    F_nan[2, 5, 17] = F_nan[5, 2, 17] = np.nan
    X2, logdet2 = tlin.bl_chol_solve(_t(F_nan), _t(B))
    keep = np.arange(64) != 17
    assert torch.equal(X2[..., keep], X[..., keep])
    assert torch.equal(logdet2[keep], logdet[keep])
    assert torch.isnan(logdet2[17]) and torch.isnan(X2[..., 17]).all()


def test_gauss_jordan_family_matches_jax():
    """gj_solve (leading batch dims, with and without log|det|), gj_inv,
    small_psd_logdet_solve (with jitter), bl_gj_solve and
    bl_psd_logdet_solve, against the JAX functions."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((2, 5, 7, 7))
    B = rng.standard_normal((2, 5, 7, 3))
    X, lad = tlin.gj_solve(_t(A), _t(B), return_logabsdet=True)
    Xj, lad_j = jlin.gj_solve(_j(A), _j(B), return_logabsdet=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lad.numpy(), np.asarray(lad_j), rtol=1e-12)
    assert torch.equal(tlin.gj_solve(_t(A), _t(B)), X)
    np.testing.assert_allclose(tlin.gj_inv(_t(A[0])).numpy(),
                               np.asarray(jlin.gj_inv(_j(A[0]))), rtol=1e-12,
                               atol=1e-12)
    F = np.moveaxis(_spd(6, 1, seed=9), -1, 0)[0]
    b = rng.standard_normal((6, 2))
    for jitter in (0.0, 1e-3):
        got = tlin.small_psd_logdet_solve(_t(F), _t(b), jitter=jitter)
        want = jlin.small_psd_logdet_solve(_j(F), _j(b), jitter=jitter)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    Abl, Bbl = np.moveaxis(A[0], 0, -1), np.moveaxis(B[0], 0, -1)
    for fn in ("bl_gj_solve", "bl_psd_logdet_solve"):
        kw = {"return_logabsdet": True} if fn == "bl_gj_solve" else {}
        got = getattr(tlin, fn)(_t(Abl), _t(Bbl), **kw)
        want = getattr(jlin, fn)(_j(Abl), _j(Bbl), **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-12)


def test_gj_solve_pivots_and_singular():
    X = tlin.gj_solve(_t([[0.0, 1.0], [1.0, 0.0]]), _t([[2.0], [3.0]]))
    np.testing.assert_allclose(X.numpy(), [[3.0], [2.0]], rtol=1e-12)
    assert not torch.isfinite(tlin.gj_solve(torch.zeros(2, 2),
                                            torch.ones(2, 1))).all()


def test_products_and_cofactor_match_jax():
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((4, 5, 16)), rng.standard_normal((5, 3, 16))
    np.testing.assert_allclose(tlin.bl_matmul(_t(A), _t(B)).numpy(),
                               np.asarray(jlin.bl_matmul(_j(A), _j(B))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(tlin.bl_transpose(_t(A)).numpy(),
                                  np.asarray(jlin.bl_transpose(_j(A))))
    F, Bc = _spd(3, 16, seed=2), rng.standard_normal((3, 2, 16))
    for g, w in zip(tlin.bl_psd_cofactor_solve3(_t(F), _t(Bc)),
                    jlin.bl_psd_cofactor_solve3(_j(F), _j(Bc))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)


@pytest.mark.parametrize("pair", [(jlin, tlin), (jdsge, tdsge)])
def test_every_public_function_has_a_counterpart(pair):
    jmod, tmod = pair
    names = [n for n, v in vars(jmod).items()
             if not n.startswith("_") and (inspect.isfunction(v)
                                           or inspect.isclass(v))
             and v.__module__ == jmod.__name__]
    assert names
    assert [n for n in names if not hasattr(tmod, n)] == []


def test_models_export_every_name():
    names = [n for n in dir(jmodels) if not n.startswith("_")
             and not inspect.ismodule(getattr(jmodels, n))]
    assert [n for n in names if not hasattr(tmodels, n)] == []
    assert callable(tmodels.load_sw_data)
    np.testing.assert_array_equal(tmodels.SW_TRUE_PARAMS,
                                  jmodels.SW_TRUE_PARAMS)
    np.testing.assert_array_equal(tmodels.AS_TRUE_PARAMS,
                                  jmodels.AS_TRUE_PARAMS)


# ---------------------------------------------------------------------------
# models/dsge.py: the per-particle functions on tests/test_dsge.py's systems
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # backward AR(1), purely forward, explosive (tests/test_dsge.py)
    ([[0.9]], [[-1.0]], [[0.0]], [[1.0]]),
    ([[0.0]], [[-1.0]], [[0.5]], [[1.0]]),
    ([[1.5]], [[-1.0]], [[0.0]], [[1.0]]),
])
def test_solve_linear_re_matches_jax(case):
    got = tdsge.solve_linear_re(*(_t(np.array(m, float)) for m in case))
    want = jdsge.solve_linear_re(*(_j(np.array(m, float)) for m in case))
    assert bool(got[2]) == bool(want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_as_solve_and_passive_policy_match_jax():
    th = jas.TRUE_PARAMS.copy()
    for psi1 in (1.5, 0.5):
        th[2] = psi1
        sys_t = [m[..., 0] for m in tas._system(_t(th)[None])]
        X, M, ok = tdsge.solve_linear_re(*sys_t)
        Xj, Mj, okj = jdsge.solve_linear_re(*jas._system(_j(th)))
        assert bool(ok) == bool(okj) == (psi1 > 1.0)
        np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=1e-10,
                                   atol=1e-12)


def test_lyapunov_doubling_matches_jax_and_scipy():
    rng = np.random.default_rng(1)
    T = 0.9 * sla.orth(rng.normal(size=(4, 4)))
    Q0 = rng.normal(size=(4, 4))
    Q = Q0 @ Q0.T
    P = tdsge.lyapunov_doubling(_t(T), _t(Q)).numpy()
    np.testing.assert_allclose(
        P, np.asarray(jdsge.lyapunov_doubling(_j(T), _j(Q))), rtol=1e-12)
    np.testing.assert_allclose(P, sla.solve_discrete_lyapunov(T, Q),
                               rtol=1e-8)


def test_spectral_radius_bound_matches_jax():
    M = np.random.default_rng(0).normal(size=(6, 6, 8))
    np.testing.assert_allclose(
        tdsge.bl_spectral_radius_bound(_t(M)).numpy(),
        np.asarray(jdsge.bl_spectral_radius_bound(_j(M))), rtol=1e-12)


def test_kalman_ar1_matches_exact_gaussian():
    """The 1-state AR(1) of tests/test_dsge.py, both filters, against the
    exact multivariate normal likelihood and JAX's filters."""
    from scipy.stats import multivariate_normal
    rho, q, h, T_len = 0.8, 0.5, 0.1, 50
    data = np.random.default_rng(2).normal(size=(1, T_len))
    args = ([[rho]], [[1.0]], [[q]], [[1.0]], [0.0], [[h]])
    idx = np.arange(T_len)
    Sigma = (q * rho ** np.abs(idx[:, None] - idx[None, :]) / (1 - rho ** 2)
             + h * np.eye(T_len))
    exact = multivariate_normal.logpdf(data[0], mean=np.zeros(T_len),
                                       cov=Sigma)
    for name in ("kalman_loglike", "kalman_loglike_chandrasekhar"):
        got = float(getattr(tdsge, name)(*(_t(np.array(a, float))
                                            for a in args), data))
        want = float(getattr(jdsge, name)(*(_j(np.array(a, float))
                                             for a in args), _j(data)))
        np.testing.assert_allclose(got, exact, rtol=1e-8)
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.fixture(scope="module")
def as_solved():
    """64 AS prior draws solved by the port, and the JAX package's vmapped
    per-particle Riccati filter on them (T = 40)."""
    th = as_prior_draws(64, seed=7)
    tht = _t(th)
    X, M, ok = tdsge.bl_solve_linear_re(*tas._system(tht))
    d, Z, H = tas._measurement(tht)
    Q = tas._shock_cov(tht)
    data = tas.load_as_data()[:, :40]
    per = lambda x: jnp.moveaxis(jnp.asarray(x.numpy()), -1, 0)
    want = jax.jit(jax.vmap(jdsge.kalman_loglike,
                            in_axes=(0, 0, 0, 0, 0, 0, None)))(
        per(X), per(M), per(Q), per(Z), per(d), per(H), jnp.asarray(data))
    want = np.where(ok.numpy(), np.asarray(want), -np.inf)
    return dict(args=(X, M, Q, Z, d, H), ok=ok, data=data, want=want)


def test_riccati_filter_matches_jax_vmapped(as_solved):
    c = as_solved
    ll = torch.where(c["ok"], tdsge.bl_kalman_loglike(*c["args"], c["data"]),
                     float("-inf"))
    assert np.isfinite(c["want"]).sum() > 20
    assert_loglh_close(ll.numpy(), c["want"])
    for j in np.flatnonzero(c["ok"].numpy())[:4]:
        one = tdsge.kalman_loglike(*(a[..., j] for a in c["args"]),
                                   c["data"])
        np.testing.assert_allclose(one.item(), ll[j].item(), rtol=1e-13)


def test_plain_filters_agree_and_as_2obs_takes_riccati(as_solved):
    """Chandrasekhar against Riccati in the posterior band (the JAX
    package's test_chandrasekhar_matches_standard_kalman contract), and a
    Riccati LinearDSGE against the JAX model's loglike."""
    c = as_solved
    ch = torch.where(c["ok"], tdsge.bl_kalman_loglike_chandrasekhar(
        *c["args"], c["data"]), float("-inf")).numpy()
    ric = c["want"]
    fin = np.isfinite(ric)
    near = fin & (ric > ric[fin].max() - 1e4)
    np.testing.assert_allclose(ch[near], ric[near], rtol=1e-8, atol=1e-4)
    model = tdsge.LinearDSGE(tas.an_schorfheide_parameters(), tas._system,
                             tas._measurement_2obs, 3, tas._shock_cov,
                             use_chand_recursion=False,
                             likelihood_backend="plain")
    jmodel = jdsge.LinearDSGE(jas.an_schorfheide_parameters(), jas._system,
                              jas._measurement_2obs, 3, jas._shock_cov,
                              use_chand_recursion=False)
    data2 = c["data"][:2]
    th = as_prior_draws(8, seed=1)
    got = model.loglike_batched(_t(th), data2).numpy()
    want = np.asarray(jmodel.loglike_batched(_j(th), data2))
    assert_loglh_close(got, want)
    np.testing.assert_allclose(model.loglike(_t(th[0]), data2).item(),
                               got[0], rtol=1e-13)


# ---------------------------------------------------------------------------
# LinearDSGE: simulate, and the kernel backend's domain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["as", "sw"])
def test_simulate_replays_jax_draws(name):
    """The JAX package's generators simulate from jax.random.normal(
    PRNGKey(1793), (T + 100, n_shocks)); replaying those normals gives its
    committed arrays (tests/test_torch_dsge.py and test_torch_sw_data.py
    check that they are the generators' outputs)."""
    mod, T, n_k = (tas, 80, 3) if name == "as" else (tsw, 156, 7)
    model = (tas.an_schorfheide(likelihood_backend="plain") if name == "as"
             else tsw.smets_wouters())
    load = tas.load_as_data if name == "as" else tsw.load_sw_data
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(1793),
                                       (T + 100, n_k), dtype=jnp.float64))
    draws = ReplayDraws([("normal", eps)])
    got = model.simulate(mod.TRUE_PARAMS, T, draws)
    assert draws.remaining() == 0
    np.testing.assert_allclose(got.numpy(), load(), rtol=1e-10, atol=1e-10)


def test_generate_as_data_is_torchs_stream():
    a = tas.generate_as_data(T=40, seed=5, device="cpu")
    assert a.shape == (3, 40) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, tas.generate_as_data(T=40, seed=5,
                                                          device="cpu"))
    assert not np.array_equal(a, tas.generate_as_data(T=40, seed=6,
                                                      device="cpu"))


def test_kernel_backend_raises_for_shapes_without_a_kernel():
    """No fallback from "kernel" to "plain": n_obs = 2 (AS-2obs) and
    n_state = 37 (SW) raise ValueError on the CPU as on the card."""
    th2 = _t(as_prior_draws(4, seed=2))
    as2 = tdsge.LinearDSGE(tas.an_schorfheide_parameters(), tas._system,
                           tas._measurement_2obs, 3, tas._shock_cov,
                           likelihood_backend="kernel")
    with pytest.raises(ValueError, match="n_obs"):
        as2.loglike_batched(th2, tas.load_as_data()[:2])
    sw = tdsge.LinearDSGE(tsw.sw_parameters(), tsw._system, tsw._measurement,
                          7, tsw._shock_cov, likelihood_backend="kernel")
    with pytest.raises(ValueError, match="no kernel"):
        sw.loglike_batched(_t(tsw.TRUE_PARAMS)[None], tsw.load_sw_data())
    with pytest.raises(ValueError, match="Riccati"):
        tdsge.LinearDSGE(tas.an_schorfheide_parameters(), tas._system,
                         tas._measurement, 3, tas._shock_cov,
                         use_chand_recursion=False)
