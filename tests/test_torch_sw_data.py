"""smc_tpu_torch's Smets-Wouters data (the committed array against the JAX
package's generator, the reference-data loader against the JAX package's)
and a 3-stage estimation smoke run, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from smc_tpu.models import sw_dsge as jsw

import smc_tpu_torch
from smc_tpu_torch.models import sw_dsge as tsw


def test_committed_sw_data_is_the_generator_output():
    np.testing.assert_array_equal(tsw.load_sw_data(),
                                  jsw.generate_sw_data(T=156, seed=1793))
    assert tsw.load_sw_data().dtype == np.float64


def _write_sw_file(path, order):
    import h5py
    rng = np.random.default_rng(0)
    T = 197
    cols = [0.4 + 0.5 * rng.standard_normal(T) for _ in range(4)]
    cols += [-46.0 + rng.standard_normal(T),            # log hours level
             0.8 + 0.2 * rng.standard_normal(T),        # inflation
             1.2 + 0.3 * np.abs(rng.standard_normal(T))]  # policy rate
    with h5py.File(path, "w") as f:
        f["data"] = np.stack([cols[i] for i in order], axis=1)


def test_load_reference_sw_data_matches_jax(tmp_path):
    """The loader on a file laid out as the reference's (h5py, written
    here), and a misordered file raising in both packages."""
    pytest.importorskip("h5py")
    good, bad = tmp_path / "sw.h5", tmp_path / "sw_bad.h5"
    _write_sw_file(good, range(7))
    _write_sw_file(bad, [4, 1, 2, 3, 0, 5, 6])
    for demean in (True, False):
        np.testing.assert_array_equal(
            tsw.load_reference_sw_data(str(good), demean_hours=demean),
            jsw.load_reference_sw_data(str(good), demean_hours=demean))
    for load in (tsw.load_reference_sw_data, jsw.load_reference_sw_data):
        with pytest.raises(ValueError):
            load(str(bad))


def test_smc_smoke():
    """Three stages of an estimation at the reference dsge_model.jl shape
    (3 blocks, alpha 0.9), the likelihood batched."""
    model = tsw.smets_wouters()
    res = smc_tpu_torch.smc(model.loglike_batched, tsw.sw_parameters(),
                            tsw.load_sw_data(), batched=True, n_parts=128,
                            n_phi=60, lam=2.1, alpha=0.9, n_blocks=3,
                            resampling_method="systematic", verbose="none",
                            seed=42, run_test=True, device="cpu")
    assert res.cloud.stage_index == 3
    assert torch.isfinite(res.cloud.loglh).all()
