"""smc_tpu_torch's Smets-Wouters model with the FRBNY DSGE model's inflation
target and forward guidance (models/sw_pi_fg.py) and the expectation rows
of LinearDSGE (models/dsge.py, ops/cuda_dsge_expectations.py), against the
plain reference tests/reference_sw_pi_fg.py, which shares no code with the
port. No JAX: the JAX package has no such model. The card test (marker
`cuda`) runs with
    python -m pytest --noconftest tests/test_torch_sw_pi_fg.py -m cuda -q
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import smc_tpu_torch
from smc_tpu_torch import _build
from smc_tpu_torch.models import sw_dsge, sw_pi_fg as fg
from smc_tpu_torch.models.dsge import (LinearDSGE, bl_expectation_rows,
                                       bl_solve_linear_re,
                                       check_expectation_rows,
                                       likelihood_route)
from smc_tpu_torch.ops import cuda_dsge_expectations as ce
from smc_tpu_torch.ops import kernels
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.rng import TorchDraws

import reference_sw_pi_fg as ref
from test_torch_cuda import assert_sw_loglh_close
from torch_parity import launches_since

# The bands (test_torch_cuda.assert_sw_loglh_close): within 50 nats of the
# best draw two f64 implementations of the likelihood agree to rounding,
# 1e-10 relative (measured here: 9e-13); deeper, within 1e6 nats, the
# Chandrasekhar recursion amplifies rounding on draws far from the data, as
# in SW (SW_TAIL_RTOL 1e-3; measured for this model over 3 x 96 prior
# draws, the port against the reference on the CPU: up to 2.1e-5, and the
# -inf pattern equal). The reference in float32 misses the first band by
# 2.4e-4 at the mode, and the likelihood without its expectation rows by
# orders of magnitude.


def _draws(n_prior, seed, n_near=4, scale=1e-3):
    """The mode, n_prior prior draws and n_near draws within `scale`
    (relative) of the mode [1 + n_prior + n_near, 43]."""
    th = ParamSpace(fg.sw_pi_fg_parameters()).sample_prior(
        TorchDraws(seed, "cpu"), n_prior, device="cpu")
    g = torch.Generator().manual_seed(seed)
    mode = torch.as_tensor(fg.TRUE_PARAMS)[None]
    near = mode * (1 + scale * torch.randn((n_near, 43), generator=g,
                                           dtype=torch.float64))
    return torch.cat([mode, th, near])


def test_dimensions():
    assert len(fg.PARAM_NAMES) == len(fg.sw_pi_fg_parameters()) == 43
    assert [p.name for p in fg.sw_pi_fg_parameters()] == fg.PARAM_NAMES
    assert [p[0] for p in ref.PRIORS] == fg.PARAM_NAMES
    assert (fg.N_STATE, fg.N_SHOCK, fg.N_OBS) == (44, 14, 14)
    assert fg.STATE_NAMES == ref.STATES and fg.SHOCK_NAMES == ref.SHOCKS
    assert fg.EXPECTATION_ROWS == ref.EXPECTATION_ROWS
    assert fg.TRUE_PARAMS.shape == (43,)


def test_system_and_measurement_match_the_reference():
    th = _draws(12, 3)
    for got, want in zip(fg._system(th), ref.system(th)):
        assert got.is_contiguous() and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    for got, want in zip(fg._measurement(th), ref.measurement(th)):
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(fg._shock_cov(th), ref.shock_cov(th),
                               rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("n_t", [20, 156])
def test_likelihood_matches_the_reference(n_t):
    """The plain route (what a CPU tensor runs) on the mode, seeded prior
    draws and near-mode draws, at T 20 and the full T."""
    th = _draws(10, 5)
    data = fg.load_sw_pi_fg_data()[:, :n_t]
    got = fg.sw_pi_fg().loglike_batched(th, data)
    want = ref.loglike(th, torch.as_tensor(data))
    assert bool(torch.isfinite(want[-4:]).all())
    assert_sw_loglh_close(got.numpy(), want.numpy())


def test_the_band_fails_float32_and_missing_rows():
    """The bands are tight enough: the reference in float32, or the
    likelihood with the expectation rows left at zero, falls outside."""
    th = _draws(0, 7)
    data = fg.load_sw_pi_fg_data()
    want = ref.loglike(th, torch.as_tensor(data)).numpy()
    f32 = ref.loglike(th.float(), torch.as_tensor(data).float())
    with pytest.raises(AssertionError):
        assert_sw_loglh_close(f32.double().numpy(), want)
    rowless = LinearDSGE(fg.sw_pi_fg_parameters(), fg._system,
                         fg._measurement, fg.N_SHOCK, fg._shock_cov)
    with pytest.raises(AssertionError):
        assert_sw_loglh_close(rowless.loglike_batched(th, data).numpy(), want)


def _stable(n, nb, seed, radius=0.97):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((nb, n, n), generator=g, dtype=torch.float64)
    rho = torch.linalg.eigvals(X).abs().amax(-1)
    return (X * (radius / rho)[:, None, None]).permute(1, 2, 0).contiguous()


ROWS = ((3, 0, 2, 5), (4, 0, 1, 1), (5, 1, 1, 40), (6, 2, 7, 7))


def test_bl_expectation_rows_match_matrix_powers():
    n, nb = 9, 6
    X = _stable(n, nb, 1)
    Z = torch.randn((7, n, nb), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    ok = torch.tensor([True, True, False, True, True, True])
    got = bl_expectation_rows(Z, X, ROWS, ok)
    want = ref.expectation_rows(Z, X, ROWS)
    torch.testing.assert_close(got[..., ok], want[..., ok], rtol=1e-12,
                               atol=1e-13)
    assert torch.equal(got[..., 2], Z[..., 2])       # rejected: as given
    assert torch.equal(got[:3], Z[:3])               # the other rows


def test_host_build_of_the_kernel_matches_the_plain_version():
    """csrc/dsge_expectations.cuh's block body (g++, each thread in turn)
    against bl_expectation_rows, at the model's rows and the test rows."""
    lib = kernels.typed(_build.build_cpu_library("dsge_expectations"),
                        "dsge_expectations", host=True)
    for n, n_o, rows, seed in ((44, 14, fg.EXPECTATION_ROWS, 3),
                               (9, 7, ROWS, 4), (64, 16, ((15, 0, 1, 3),), 5)):
        nb = 5
        X = _stable(n, nb, seed)
        Z = torch.randn((n_o, n, nb), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(seed))
        ok = torch.tensor([True, False, True, True, True])
        out = torch.full_like(Z, float("nan"))
        spec = (ctypes.c_int * (4 * len(rows)))(*[x for r in rows for x in r])
        rc = lib.smc_expectation_rows_cpu(
            n, n_o, len(rows), spec, Z.data_ptr(), X.data_ptr(),
            ok.data_ptr(), out.data_ptr(), nb)
        assert rc == 0
        want = bl_expectation_rows(Z, X, rows, ok)
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-13)
        assert torch.equal(out[..., 1], Z[..., 1])
    bad = (ctypes.c_int * 4)(1, 0, 3, 2)          # first > last
    assert lib.smc_expectation_rows_cpu(9, 7, 1, bad, Z.data_ptr(),
                                        X.data_ptr(), ok.data_ptr(),
                                        out.data_ptr(), nb) == -1


def test_without_the_blocks_it_is_smets_wouters():
    """The model's system with the target, the nu states and their shocks
    cut away, and its measurement without the expectation rows, are
    SW2007's, and give smets_wouters()' likelihood to rounding."""
    th = _draws(6, 11)
    sw = sw_dsge.N_STATE, sw_dsge.N_SHOCK, sw_dsge.N_OBS

    def cut_system(t):
        A, B, C, D = fg._system(torch.cat(
            [t, th[:t.shape[0], 36:]], dim=1))
        return tuple(m[:sw[0], :sw[1] if i == 3 else sw[0]].contiguous()
                     for i, m in enumerate((A, B, C, D)))

    def cut_measurement(t):
        d, Z, H = fg._measurement(torch.cat([t, th[:t.shape[0], 36:]], 1))
        return (d[:sw[2]].contiguous(), Z[:sw[2], :sw[0]].contiguous(),
                H[:sw[2], :sw[2]].contiguous())

    cut = LinearDSGE(sw_dsge.sw_parameters(), cut_system, cut_measurement,
                     sw[1], lambda t: sw_dsge._shock_cov(t))
    for got, want in zip(cut_system(th[:, :36]), sw_dsge._system(th[:, :36])):
        assert torch.equal(got, want)
    data = sw_dsge.load_sw_data()
    got = cut.loglike_batched(th[:, :36], data)
    want = sw_dsge.smets_wouters().loglike_batched(th[:, :36], data)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14)


def test_simulate_reproduces_the_committed_data():
    """generate_sw_pi_fg_data() remakes the committed array (to 1e-12: a
    BLAS build may sum a product in another order)."""
    data = fg.load_sw_pi_fg_data()
    assert data.shape == (14, 156) and data.dtype == np.float64
    np.testing.assert_allclose(fg.generate_sw_pi_fg_data(), data,
                               rtol=1e-12, atol=1e-12)


def test_expectation_rows_are_refused_where_they_cannot_run():
    with pytest.raises(ValueError):
        LinearDSGE(fg.sw_pi_fg_parameters(), fg._system, fg._measurement,
                   fg.N_SHOCK, fg._shock_cov, likelihood_backend="kernel",
                   expectation_rows=fg.EXPECTATION_ROWS)
    for rows in (((3, 0, 2, 1),), ((3, 0, 0, 1),), ((3, 0, 1, 2),
                                                    (3, 1, 1, 1)),
                 ((3, 0, 1, 1), (4, 3, 1, 1)), ((3, 0, 1),)):
        with pytest.raises(ValueError):
            check_expectation_rows(rows)
    with pytest.raises(ValueError):
        check_expectation_rows(((7, 0, 1, 1),), n_obs=7)
    Z, X = torch.zeros((7, 4, 2), dtype=torch.float64), _stable(4, 2, 1)
    with pytest.raises(ValueError):
        ce.expectation_rows(Z, X, torch.ones(2, dtype=torch.bool),
                            ((7, 0, 1, 1),))
    # the n_obs-3 kernels' shapes go to the general kernels with rows
    assert likelihood_route("plain", True, "cuda", 6, 3, 3, 80) == "kernel"
    assert likelihood_route("plain", True, "cuda", 6, 3, 3, 80,
                            expectations=True) == "general"
    assert likelihood_route("plain", True, "cuda", 44, 14, 14, 156,
                            expectations=True) == "general"
    assert likelihood_route("plain", True, "cpu", 44, 14, 14, 156,
                            expectations=True) == "plain"


def test_smc_smoke():
    """Three stages of an estimation through smc() (the reference
    dsge_model.jl's 3 blocks, alpha 0.9), the likelihood batched."""
    res = smc_tpu_torch.smc(fg.sw_pi_fg().loglike_batched,
                            fg.sw_pi_fg_parameters(),
                            fg.load_sw_pi_fg_data(), batched=True,
                            n_parts=64, n_phi=60, lam=2.1, alpha=0.9,
                            n_blocks=3, resampling_method="multinomial",
                            verbose="none", seed=42, run_test=True,
                            device="cpu")
    assert res.cloud.stage_index == 3
    assert torch.isfinite(res.cloud.loglh).all()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_route_matches_the_reference(dev):
    """The card's route at 512 draws (prior and near-mode): the general RE
    kernel, the expectation-rows kernel and the general Kalman kernel, one
    launch each, against the float64 reference on the card; and the
    expectation-rows kernel alone against the plain version."""
    from smc_tpu_torch.ops import cuda_dsge_general as g
    th = _draws(500, 13, n_near=11).to(dev)
    data = torch.as_tensor(fg.load_sw_pi_fg_data(), device=dev)
    before = dict(kernels.LAUNCHES)
    got = fg.sw_pi_fg().loglike_batched(th, data)
    torch.cuda.synchronize()
    assert launches_since(before) == {
        "re_general": 1, "kalman_general": 1, "expectation_rows": 1}
    want = ref.loglike(th, data)
    assert bool(torch.isfinite(want[-11:]).all())
    assert_sw_loglh_close(got.cpu().numpy(), want.cpu().numpy())

    A, B, C, D = fg._system(th)
    _, Z, _ = fg._measurement(th)
    X, _, ok = g.solve_linear_re(A, B, C, D)
    out = ce.expectation_rows(Z, X, ok, fg.EXPECTATION_ROWS)
    plain = bl_expectation_rows(Z, X, fg.EXPECTATION_ROWS, ok)
    torch.testing.assert_close(out, plain, rtol=1e-12, atol=1e-13)
    assert not bool(ok.all())                     # a rejected draw's rows
    assert torch.equal(out[..., ~ok], Z[..., ~ok])
