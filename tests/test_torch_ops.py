"""smc_tpu_torch correction, resampling and schedule against the JAX
package (resampling with the JAX uniforms replayed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.ops import correction as jc
from smc_tpu.ops.resample import resample as j_resample
from smc_tpu.ops.schedule import fixed_schedule as j_fixed_schedule

from smc_tpu_torch.ops import correction as tc
from smc_tpu_torch.ops.resample import resample
from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.rng import ReplayDraws


def _cloud(n=512, seed=0):
    rng = np.random.default_rng(seed)
    loglh = -1400.0 + 30.0 * rng.standard_normal(n)
    old = -800.0 + 20.0 * rng.standard_normal(n)
    w = rng.gamma(2.0, 1.0, n)
    return loglh, old, n * w / w.sum()


@pytest.mark.parametrize("omega", [0.0, 1.0, 0.3])
def test_correct_and_incremental_weights_match_jax(omega):
    loglh, old, w = _cloud()
    args = (0.31, 0.27, omega, -812.5)
    got = tc.correct(torch.as_tensor(loglh), torch.as_tensor(old),
                     torch.as_tensor(w), *args)
    want = jc.correct(jnp.asarray(loglh), jnp.asarray(old), jnp.asarray(w),
                      *args)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-12)
    got = tc.log_incremental_weights(torch.as_tensor(loglh),
                                     torch.as_tensor(old), *args)
    want = jc.log_incremental_weights(jnp.asarray(loglh), jnp.asarray(old),
                                      *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_compute_ess_matches_jax():
    loglh, old, w = _cloud(seed=1)
    for old_arg in (None, old):
        got = tc.compute_ess(torch.as_tensor(loglh), torch.as_tensor(w),
                             0.05, 0.04,
                             None if old_arg is None else torch.as_tensor(old))
        want = jc.compute_ess(jnp.asarray(loglh), jnp.asarray(w), 0.05, 0.04,
                              None if old_arg is None else jnp.asarray(old))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("method", ["systematic", "multinomial", "polyalgo",
                                    "stratified"])
def test_resample_replayed_uniforms_identical(method):
    rng = np.random.default_rng(2)
    n = 1000
    w = rng.gamma(0.5, 1.0, n)
    w[rng.uniform(size=n) < 0.3] = 0.0
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_resample(key, jnp.asarray(w), method=method))
    shape = () if method == "systematic" else (n,)
    u = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float64))
    got = resample(ReplayDraws([("uniform", u)]), torch.as_tensor(w),
                   method=method).numpy()
    np.testing.assert_array_equal(got, want)


def test_resample_clamp_edge():
    """The cumulative weights of ten 0.1s end at 1 - 2^-53; a uniform at
    that value lands past the end and is clamped to the last index, as in
    the JAX package."""
    w = np.full(10, 0.1)
    u = np.array([0.0, 0.05, np.nextafter(1.0, 0.0)])
    got = resample(ReplayDraws([("uniform", u)]), torch.as_tensor(w),
                   method="multinomial", n_parts=3).numpy()
    cw = jnp.cumsum(jnp.asarray(w) / jnp.sum(jnp.asarray(w)))
    want = np.asarray(jnp.clip(jnp.searchsorted(cw, jnp.asarray(u),
                                                side="right"), 0, 9))
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 9
    got = resample(ReplayDraws([("uniform", np.nextafter(1.0, 0.0))]),
                   torch.as_tensor(w), method="systematic").numpy()
    assert got.max() == 9


def test_replay_draws_refuses_mismatch():
    d = ReplayDraws([("uniform", np.zeros(3))])
    with pytest.raises(RuntimeError, match="mismatch"):
        d.normal((3,))
    d = ReplayDraws([("uniform", np.zeros(3))])
    with pytest.raises(RuntimeError, match="mismatch"):
        d.uniform((4,))


@pytest.mark.parametrize("n_phi,lam", [(100, 2.0), (300, 2.1), (2, 1.0)])
def test_fixed_schedule_matches_jax(n_phi, lam):
    np.testing.assert_array_equal(fixed_schedule(n_phi, lam),
                                  j_fixed_schedule(n_phi, lam))


def test_cloud_from_saved_jax_cloud_and_weighted_stats(tmp_path):
    """A cloud saved by the JAX package loads into the port, and the
    weighted statistics agree."""
    from smc_tpu.cloud import (Cloud as JCloud, weighted_mean as j_mean,
                               weighted_cov as j_cov, weighted_std as j_std)
    from smc_tpu.io import save_cloud
    from smc_tpu_torch.cloud import (Cloud, weighted_mean, weighted_cov,
                                     weighted_std)
    rng = np.random.default_rng(3)
    n, p = 300, 4
    jc = JCloud.create(p, n)
    jc.params = jnp.asarray(rng.standard_normal((n, p)) @ rng.uniform(
        0.5, 1.5, (p, p)))
    jc.loglh = jnp.asarray(rng.standard_normal(n))
    jc.weights = jnp.asarray(rng.gamma(2.0, 1.0, n))
    path = str(tmp_path / "cloud.npz")
    save_cloud(path, jc)
    with np.load(path) as z:
        cloud = Cloud.from_numpy(z, device="cpu")
    for k in ("params", "loglh", "logprior", "old_loglh", "accept",
              "weights"):
        np.testing.assert_array_equal(getattr(cloud, k).numpy(),
                                      np.asarray(getattr(jc, k)))
        assert getattr(cloud, k).dtype == torch.float64
    for t_fn, j_fn in ((weighted_mean, j_mean), (weighted_cov, j_cov),
                       (weighted_std, j_std)):
        np.testing.assert_allclose(t_fn(cloud).numpy(), np.asarray(j_fn(jc)),
                                   rtol=1e-12)
