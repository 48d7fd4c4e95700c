"""smc_tpu_torch's CAPM model (models/capm.py) against the JAX package on
the CPU: the data generator bit for bit, the likelihood at 64 draws, the
reference-data loader, and one estimation at tests/test_capm.py's
configuration."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.models import capm as jcapm

import smc_tpu_torch
from smc_tpu_torch.models import capm as tcapm

TRUE = np.array([0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5])


def test_data_bitwise_equal():
    for T, seed in ((200, 1793), (36, 7)):
        for got, want in zip(tcapm.generate_capm_data(T=T, seed=seed),
                             jcapm.generate_capm_data(T=T, seed=seed)):
            np.testing.assert_array_equal(got, want)


def test_loglike_matches_jax():
    """64 draws around the truth, some with sigma <= 0 (-inf in both), the
    per-theta likelihood vmapped in both packages."""
    lik, market = jcapm.generate_capm_data(T=200, seed=1793)
    rng = np.random.default_rng(0)
    th = TRUE + 0.3 * rng.standard_normal((64, 9))
    th[::9, 2] = -np.abs(th[::9, 2]) * 0.0
    got = torch.func.vmap(lambda t: tcapm.make_capm_loglike(market)(t, lik))(
        torch.as_tensor(th)).numpy()
    want = np.asarray(jax.vmap(lambda t: jcapm.make_capm_loglike(market)(
        t, lik))(jnp.asarray(th)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert (~np.isfinite(got)).sum() == 8
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


def test_parameters_match_jax():
    for p, q in zip(tcapm.capm_parameters(), jcapm.capm_parameters()):
        assert (p.name, p.value, p.valuebounds) == (q.name, q.value,
                                                    q.valuebounds)
        assert (p.prior.family, p.prior.a, p.prior.b) == \
            (q.prior.family, q.prior.a, q.prior.b)
        assert type(p.transform).__name__ == type(q.transform).__name__


def test_load_reference_capm_data_matches_jax(tmp_path):
    """Both loaders on a file laid out as the reference's capm.jld2 (HDF5:
    lik_data stored (36, 3), market_data (36, 1)), written here."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    path = tmp_path / "capm.jld2"
    with h5py.File(path, "w") as f:
        f["lik_data"] = rng.standard_normal((36, 3))
        f["market_data"] = rng.standard_normal((36, 1))
    for got, want in zip(tcapm.load_reference_capm_data(str(path)),
                         jcapm.load_reference_capm_data(str(path))):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_capm_estimation():
    """tests/test_capm.py's configuration at seeds 42 and 0-3, gated as
    ROADMAP caveat 4 asks: the median over the seeds of each parameter's
    |z| against the data-generating values below 5, and a finite log-MDD
    for each seed. A seed can collapse (one parameter far off) in either
    package; which seeds do moves with the random stream and the CPU's
    thread count, and in each package about a quarter to a third of seeds
    42 and 0-39 did (tests/torch_capm_seeds.py, with and without --jax;
    PERF.md), so three seeds were too few for a median."""
    lik, market = tcapm.generate_capm_data(T=200, seed=1793)
    zs = []
    for seed in (42, 0, 1, 2, 3):
        res = smc_tpu_torch.smc(tcapm.make_capm_loglike(market),
                                tcapm.capm_parameters(), lik, n_parts=5000,
                                n_phi=100, lam=2.1, alpha=0.9,
                                resampling_method="systematic",
                                verbose="none", seed=seed, device="cpu")
        mu, sd = res.posterior_mean(), res.posterior_std()
        zs.append(np.abs(mu - TRUE) / np.maximum(sd, 1e-9))
        assert np.isfinite(res.log_mdd)
    med = np.median(zs, axis=0)
    assert np.all(med < 5.0), f"median z={med}, per seed {zs}"
