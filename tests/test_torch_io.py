"""smc_tpu_torch's persistence: one npz format for both packages (a cloud
saved by either loads in the other with every array bitwise equal), resume
from a checkpoint bit for bit in the fixed and the adaptive mode, file
split/join, the particle store, `testing=True`, and the refusal to resume
from a checkpoint that holds only a JAX PRNG key."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu import io as jio
from smc_tpu.cloud import Cloud as JCloud

import smc_tpu_torch
from smc_tpu_torch import io as tio
from smc_tpu_torch.cloud import Cloud, ARRAY_FIELDS
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)

SCALARS = ("tempering_schedule", "ESS", "stage_index", "n_phi", "resamples",
           "c", "accept_rate", "total_sampling_time")


def _fields(n=64, p=5, seed=0):
    rng = np.random.default_rng(seed)
    return dict(params=rng.standard_normal((n, p)),
                loglh=rng.standard_normal(n) - 100.0,
                logprior=rng.standard_normal(n),
                old_loglh=rng.standard_normal(n),
                accept=rng.uniform(size=n),
                weights=rng.uniform(0.5, 1.5, n))


SCALAR_STATE = dict(tempering_schedule=[0.0, 0.1 / 3, 1.0],
                    ESS=[64.0, 31.123456789012345, 60.5], stage_index=3,
                    n_phi=3, resamples=1, c=0.4567891234567891,
                    accept_rate=0.2789, total_sampling_time=1.25)


def _assert_same_cloud(a_arrays, a_scalars, b_arrays, b_scalars):
    for k in ARRAY_FIELDS:
        x, y = np.asarray(a_arrays[k]), np.asarray(b_arrays[k])
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)
    for k in SCALARS:
        assert a_scalars[k] == b_scalars[k], k


def test_jax_saved_cloud_loads_here(tmp_path):
    f = _fields()
    jc = JCloud(**{k: jnp.asarray(v) for k, v in f.items()}, **SCALAR_STATE)
    path = str(tmp_path / "jax.npz")
    extra = {"w": np.arange(6.0).reshape(3, 2), "log_mdd": np.asarray(-3.5)}
    jio.save_cloud(path, jc, extra=extra)
    tc, textra = tio.load_cloud(path, device="cpu")
    _assert_same_cloud(f, SCALAR_STATE,
                       {k: getattr(tc, k).numpy() for k in ARRAY_FIELDS},
                       {k: getattr(tc, k) for k in SCALARS})
    assert set(textra) == set(extra)
    for k in extra:
        np.testing.assert_array_equal(textra[k], extra[k])
    assert torch.equal(tio.get_cloud(path, device="cpu").params, tc.params)


def test_cloud_saved_here_loads_in_jax(tmp_path):
    f = _fields(seed=1)
    tc = Cloud.from_numpy(f, device="cpu")
    for k, v in SCALAR_STATE.items():
        setattr(tc, k, v)
    path = str(tmp_path / "torch.npz")
    tio.save_cloud(path, tc, extra={"W": torch.ones(4, 2)})
    jc, jextra = jio.load_cloud(path)
    _assert_same_cloud(f, SCALAR_STATE,
                       {k: np.asarray(getattr(jc, k)) for k in ARRAY_FIELDS},
                       {k: getattr(jc, k) for k in SCALARS})
    np.testing.assert_array_equal(jextra["W"], np.ones((4, 2)))
    with np.load(path) as z:        # the same array names in the file
        assert set(z.files) == set(ARRAY_FIELDS) | {"_meta", "extra_W"}


@pytest.fixture(scope="module")
def regression():
    y, x = generate_regression_data(n=60, seed=1793)
    return make_regression_loglike(x), y


def _run(regression, **kw):
    ll, y = regression
    return smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=600,
                             n_phi=40, lam=2.0, alpha=0.9, n_blocks=2,
                             verbose="none", seed=5, device="cpu", **kw)


def _assert_bitwise(a, b):
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert torch.equal(a.cloud.loglh, b.cloud.loglh)
    assert torch.equal(a.cloud.weights, b.cloud.weights)
    assert a.log_mdd == b.log_mdd
    np.testing.assert_array_equal(a.w, b.w)
    np.testing.assert_array_equal(a.W, b.W)
    assert a.cloud.tempering_schedule == b.cloud.tempering_schedule
    assert a.cloud.ESS == b.cloud.ESS
    assert (a.cloud.c, a.cloud.accept_rate) == (b.cloud.c, b.cloud.accept_rate)
    assert a.cloud.resamples == b.cloud.resamples


@pytest.mark.parametrize("mode", [
    dict(), dict(use_fixed_schedule=False, tempering_target=0.9),
    dict(resampling_method="metropolis")])
def test_resume_is_bit_identical(tmp_path, regression, mode):
    """Checkpoints every 5 stages; resuming from stage 10 ends where the
    uninterrupted run ends, bit for bit."""
    savepath = str(tmp_path / "run.npz")
    plain = _run(regression, **mode)
    full = _run(regression, savepath=savepath, save_intermediate=True,
                intermediate_stage_increment=5, **mode)
    _assert_bitwise(full, plain)
    assert len(plain.cloud.tempering_schedule) > 12
    assert os.path.exists(tio.intermediate_path(savepath, 10))
    resumed = _run(regression, continue_intermediate=True,
                   loadpath=tio.intermediate_path(savepath, 10), **mode)
    _assert_bitwise(resumed, plain)


def test_resume_from_a_jax_checkpoint_raises(tmp_path, regression):
    f = _fields(n=600, p=2, seed=2)
    jc = JCloud(**{k: jnp.asarray(v) for k, v in f.items()}, **SCALAR_STATE)
    savepath = str(tmp_path / "jax_run.npz")
    jio.save_checkpoint(savepath, 3, jc, np.ones((600, 3)), np.ones((600, 3)),
                        4, 0.5, -10.0, jax.random.PRNGKey(0))
    path = jio.intermediate_path(savepath, 3)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        _run(regression, continue_intermediate=True, loadpath=path)
    cloud, extra = tio.load_cloud(path, device="cpu")    # the cloud still loads
    np.testing.assert_array_equal(cloud.params.numpy(), f["params"])
    assert "rng_key" in extra


def test_split_and_join_cloud_files(tmp_path):
    f = _fields(n=60, seed=3)
    tc = Cloud.from_numpy(f, device="cpu")
    path = str(tmp_path / "big.npz")
    tio.save_cloud(path, tc, extra={"log_mdd": np.asarray(-1.5)})
    pieces = tio.split_cloud_file(path, 4)
    assert [os.path.basename(p) for p in pieces] == [
        f"big_part{i}.npz" for i in range(1, 5)]
    assert tio.load_cloud(pieces[1], device="cpu")[0].n_parts == 15
    os.remove(path)
    tio.join_cloud_file(path, 4)
    joined, extra = tio.load_cloud(path, device="cpu")
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(joined, k).numpy(), f[k])
    assert float(extra["log_mdd"]) == -1.5
    # the JAX package joins the pieces written here to the same cloud
    os.remove(path)
    jio.join_cloud_file(path, 4)
    jjoined = jio.load_cloud(path)[0]
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jjoined, k)), f[k])


def test_particle_store_and_testing_flag(tmp_path, regression):
    tc = Cloud.from_numpy(_fields(n=10, seed=4), device="cpu")
    tio.save_particle_store(str(tmp_path / "store.npy"), tc)
    np.testing.assert_array_equal(np.load(tmp_path / "store.npy"),
                                  tc.params.numpy())
    tio.save_particle_store(str(tmp_path / "store.h5"), tc)
    try:
        import h5py
        with h5py.File(tmp_path / "store.h5", "r") as h:
            np.testing.assert_array_equal(h["smcparams"][()],
                                          tc.params.numpy())
    except ImportError:
        np.testing.assert_array_equal(np.load(tmp_path / "store.h5.npy"),
                                      tc.params.numpy())

    out = tmp_path / "quiet"
    out.mkdir()
    res = _run(regression, savepath=str(out / "c.npz"),
               particle_store_path=str(out / "p.npy"), testing=True)
    assert list(out.iterdir()) == []
    _run(regression, savepath=str(out / "c.npz"),
         particle_store_path=str(out / "p.npy"))
    assert sorted(p.name for p in out.iterdir()) == ["c.npz", "p.npy"]
    saved, extra = tio.load_cloud(str(out / "c.npz"), device="cpu")
    assert torch.equal(saved.params, res.cloud.params)
    np.testing.assert_array_equal(extra["W"], res.W)
    assert float(extra["log_mdd"]) == res.log_mdd
