"""An-Schorfheide with two observables (output growth and inflation): the
port's Cholesky innovation path against the JAX package.

Run as a script, it prints the JAX package's log-MDD of AS-2obs at the
configuration of chip_smoke.py's phase (g) (16,384 particles, n_phi=100,
lam=2, 1 block, alpha=0.9, systematic resampling, `load_as_data()[:2]`),
seeds 0-2 on the CPU; phase (g) gates the port's log-MDD on the seed-0
value:

    JAX_PLATFORMS=cpu python tests/test_torch_as2obs.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from smc_tpu.models import as_dsge as jas  # noqa: E402
from smc_tpu.params import ParamSpace as JParamSpace  # noqa: E402

from smc_tpu_torch.models import as_dsge as tas  # noqa: E402
from smc_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402

from torch_parity import assert_loglh_close, launches_since  # noqa: E402


@pytest.fixture(scope="module")
def as2_case():
    """The 128 prior draws and T = 24 data of the JAX package's
    test_as_2obs_batched_matches_vmapped, and its batched likelihood."""
    data = jas.generate_as_data(T=24, seed=5)[:2]
    th = JParamSpace(jas.an_schorfheide_parameters()).sample_prior(
        jax.random.PRNGKey(2), 128)
    ll = jax.jit(lambda t: jas.an_schorfheide_2obs().loglike_batched(
        t, data))(th)
    return dict(th=np.array(th), data=data, ll=np.asarray(ll))


def test_as_2obs_loglike_matches_jax(as2_case):
    model = tas.an_schorfheide_2obs()
    assert model.likelihood_backend == "plain"
    ll = model.loglike_batched(torch.as_tensor(as2_case["th"]),
                               as2_case["data"]).numpy()
    assert np.isfinite(ll).sum() > 60
    assert_loglh_close(ll, as2_case["ll"])
    for j in np.flatnonzero(np.isfinite(ll))[:3]:
        one = model.loglike(torch.as_tensor(as2_case["th"][j]),
                            as2_case["data"])
        np.testing.assert_allclose(one.item(), ll[j], rtol=1e-13)


def test_as_2obs_measurement_is_the_first_two_rows():
    th = torch.as_tensor(jas.TRUE_PARAMS)[None].repeat(4, 1)
    d, Z, H = tas._measurement(th)
    d2, Z2, H2 = tas._measurement_2obs(th)
    assert all(t.is_contiguous() for t in (d2, Z2, H2))
    assert torch.equal(d2, d[:2]) and torch.equal(Z2, Z[:2])
    assert torch.equal(H2, H[:2, :2])


def test_as_2obs_launches_no_kernel(as2_case):
    before = dict(LAUNCHES)
    tas.an_schorfheide_2obs().loglike_batched(
        torch.as_tensor(as2_case["th"][:8]), as2_case["data"])
    assert launches_since(before) == {}


def _jax_reference():
    from smc_tpu import smc
    model = jas.an_schorfheide_2obs()
    data = jas.generate_as_data(T=80, seed=1793)[:2]
    for seed in range(3):
        t0 = time.perf_counter()
        res = smc(model.loglike_batched, jas.an_schorfheide_parameters(),
                  data, batched=True, n_parts=16_384, n_phi=100, lam=2.0,
                  n_blocks=1, alpha=0.9, resampling_method="systematic",
                  verbose="none", seed=seed)
        mu, sd = res.posterior_mean(), res.posterior_std()
        z = np.abs(mu - jas.TRUE_PARAMS) / np.maximum(sd, 1e-9)
        print(json.dumps(dict(seed=seed, log_mdd=res.log_mdd,
                              max_z=float(z.max()),
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    _jax_reference()
