"""smc_tpu_torch DSGE likelihood (models/dsge.py + ops/cuda_dsge.py) against
the JAX package. On the CPU the kernel wrappers run their plain versions;
the kernels themselves are checked by test_torch_kernel_body_cpu.py (their
bodies, compiled for the host) and on the card by chip_smoke.py."""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.models import as_dsge as jas
from smc_tpu.models.dsge import (bl_solve_linear_re as j_re,
                                 bl_kalman_loglike_chandrasekhar as j_kalman)
from smc_tpu.ops.pallas_dsge import (pallas_solve_linear_re,
                                     pallas_kalman_chandrasekhar)

from smc_tpu_torch import _build
from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar)
from smc_tpu_torch.ops import cuda_dsge

from torch_parity import (as_prior_draws, assert_loglh_close, synthetic_model,
                          synthetic_system, tiny_system)


def _bl(x):
    return jnp.moveaxis(x, 0, -1)


@pytest.fixture(scope="module")
def as_case():
    """256 AS prior draws through both packages' system-matrix functions and the JAX
    plain (batch-last XLA) path."""
    th = as_prior_draws(256, seed=3)
    A, B, C, D = jax.vmap(jas._system)(jnp.asarray(th))
    jsys = tuple(_bl(x) for x in (A, B, C, D))
    X, M, ok = jax.jit(j_re)(*jsys)
    Q = _bl(jax.vmap(jas._shock_cov)(jnp.asarray(th)))
    d, Z, H = jax.vmap(jas._measurement)(jnp.asarray(th))
    data = tas.load_as_data()
    ll = jax.jit(j_kalman)(X, M, Q, _bl(Z), _bl(d), _bl(H), data)
    jmodel = jas.an_schorfheide()
    ll_full = jax.jit(lambda t: jmodel.loglike_batched(t, data))(
        jnp.asarray(th))
    return dict(th=th, jsys=[np.asarray(x) for x in jsys],
                X=np.asarray(X), M=np.asarray(M), ok=np.asarray(ok),
                Q=np.asarray(Q), Z=np.asarray(_bl(Z)), d=np.asarray(_bl(d)),
                H=np.asarray(_bl(H)), data=data, ll=np.asarray(ll),
                ll_full=np.asarray(ll_full))


def test_system_matrices_match_jax(as_case):
    th = torch.as_tensor(as_case["th"])
    for got, want in zip(tas._system(th), as_case["jsys"]):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    d, Z, H = tas._measurement(th)
    np.testing.assert_array_equal(d.numpy(), as_case["d"])
    np.testing.assert_array_equal(Z.numpy(), as_case["Z"])
    np.testing.assert_array_equal(H.numpy(), as_case["H"])
    np.testing.assert_array_equal(tas._shock_cov(th).numpy(), as_case["Q"])


def test_solve_linear_re_plain_matches_jax(as_case):
    A, B, C, D = (torch.tensor(x) for x in as_case["jsys"])
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    np.testing.assert_array_equal(ok.numpy(), as_case["ok"])
    assert 0 < ok.sum() < 256
    o = as_case["ok"]
    np.testing.assert_allclose(X.numpy()[..., o], as_case["X"][..., o],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.numpy()[..., o], as_case["M"][..., o],
                               rtol=1e-10, atol=1e-12)
    assert not X.numpy()[..., ~o].any() and not M.numpy()[..., ~o].any()


def test_kalman_plain_matches_jax(as_case):
    c = as_case
    ll = bl_kalman_loglike_chandrasekhar(
        *(torch.tensor(c[k]) for k in ("X", "M", "Q", "Z", "d", "H")),
        torch.tensor(c["data"]))
    assert_loglh_close(ll.numpy(), c["ll"])


def test_dsge_loglike_matches_jax(as_case):
    """The model's likelihood (kernel backend: on a CPU tensor, the plain
    path) against the JAX model's, draws [N, P] in."""
    model = tas.an_schorfheide()
    ll = model.loglike_batched(torch.as_tensor(as_case["th"]),
                               as_case["data"])
    assert_loglh_close(ll.numpy(), as_case["ll_full"])
    plain = tas.an_schorfheide(likelihood_backend="plain")
    ll_p = plain.loglike_batched(torch.as_tensor(as_case["th"]),
                                 as_case["data"])
    assert torch.equal(ll, ll_p)


def test_tiny_system_matches_pallas_interpret():
    """dsge_loglike against the JAX package's Pallas kernels (composed as
    pallas_dsge_loglike composes them) in interpret mode, at the rtol 2e-7 test_pallas_dsge.py states for interpret mode
    (its df64 arithmetic can lose an f32-sized lo word under XLA fusion)."""
    args = tiny_system()
    A, B, C, D, Q, Z, d, H, data = (jnp.asarray(a) for a in args)
    # the iteration caps of test_pallas_dsge.py keep interpret mode cheap;
    # this system converges well inside them
    X, M, ok = pallas_solve_linear_re(A, B, C, D, n_iter=4, interpret=True)
    want = jnp.where(ok, pallas_kalman_chandrasekhar(
        X, M, Q, Z, d, H, data, lyap_iter=12, interpret=True), -jnp.inf)
    got = cuda_dsge.dsge_loglike(*(torch.as_tensor(a) for a in args))
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7)


# shapes across the kernels' domain (n_obs 3, 1 <= n_state, n_shock <= 8):
# the edges, n_shock above n_state, the Kalman filter's 4-lane groups
DOMAIN_SHAPES = [(1, 1), (2, 1), (4, 2), (5, 5), (7, 3), (8, 8)]


@pytest.mark.parametrize("shape", DOMAIN_SHAPES)
def test_kernel_backend_across_the_domain_matches_jax(shape):
    """A LinearDSGE on "pallas" (the port's "kernel") at a shape of the
    domain, on synthetic systems: its wrappers' X, M and ok, and the model's
    likelihood, against the JAX package's bl_* path, to the AS tests'
    tolerances."""
    sys_np, data = synthetic_system(*shape, 48, n_t=12)
    A, B, C, D, Q, Z, d, H = (jnp.asarray(x) for x in sys_np)
    Xj, Mj, okj = jax.jit(j_re)(A, B, C, D)
    want = np.where(okj, jax.jit(j_kalman)(Xj, Mj, Q, Z, d, H,
                                           jnp.asarray(data)), -np.inf)
    X, M, ok = cuda_dsge.solve_linear_re(
        *(torch.as_tensor(x) for x in sys_np[:4]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert bool(ok.all())
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=1e-10,
                               atol=1e-12)
    th = torch.arange(48, dtype=torch.float64)[:, None]
    for backend in ("pallas", "kernel"):
        model = synthetic_model(sys_np, "cpu", likelihood_backend=backend)
        assert model.likelihood_backend == "kernel"
        assert_loglh_close(model.loglike_batched(th, data).numpy(), want)


@pytest.mark.parametrize("shape, n_obs, match", [
    ((9, 3), 3, "no kernel"), ((3, 9), 3, "no kernel"), ((4, 2), 2, "n_obs")])
def test_shapes_outside_the_domain_raise(shape, n_obs, match):
    """n_state or n_shock above 8, or n_obs != 3, under "kernel": ValueError
    on the CPU as on the card, no fallback to the plain path."""
    sys_np, data = synthetic_system(*shape, 4, n_t=6)
    if n_obs != 3:
        sys_np = (*sys_np[:5], sys_np[5][:n_obs].copy(),
                  sys_np[6][:n_obs].copy(), sys_np[7][:n_obs, :n_obs].copy())
        data = data[:n_obs]
    model = synthetic_model(sys_np, "cpu")
    with pytest.raises(ValueError, match=match):
        model.loglike_batched(torch.arange(4, dtype=torch.float64)[:, None],
                              data)
    with pytest.raises(ValueError, match=match):
        cuda_dsge.dsge_loglike(*(torch.as_tensor(x) for x in sys_np),
                               torch.as_tensor(data))


def test_nan_particle_leaves_others_unchanged(as_case):
    sys_t = [torch.tensor(x) for x in as_case["jsys"]]
    rest = [torch.tensor(as_case[k]) for k in ("Q", "Z", "d", "H")]
    data = torch.as_tensor(as_case["data"])
    Q, Z, d, H = rest
    ll = cuda_dsge.dsge_loglike(*sys_t, Q, Z, d, H, data)
    A_nan = sys_t[0].clone()
    j = 17
    A_nan[:, :, j] = float("nan")
    ll_nan = cuda_dsge.dsge_loglike(A_nan, *sys_t[1:], Q, Z, d, H, data)
    keep = np.arange(256) != j
    assert torch.equal(ll_nan[keep], ll[keep])
    assert ll_nan[j].item() == float("-inf")


def test_cpu_tensors_do_not_launch(as_case):
    for k in cuda_dsge.LAUNCHES:
        cuda_dsge.LAUNCHES[k] = 0
    model = tas.an_schorfheide()
    model.loglike_batched(torch.as_tensor(as_case["th"][:8]),
                          as_case["data"])
    assert cuda_dsge.LAUNCHES == {"re": 0, "kalman": 0}


def test_wrappers_refuse_other_devices():
    A = torch.zeros((6, 6, 4), device="meta", dtype=torch.float64)
    D = torch.zeros((6, 3, 4), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_dsge.solve_linear_re(A, A, A, D)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_cuda_library()


def test_build_raises_on_compiler_error(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no such toolchain' >&2\nexit 3\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such toolchain"):
        _build.build_cuda_library()
    assert not any((tmp_path / "build").glob("*.so"))


def test_committed_as_data_is_the_generator_output():
    np.testing.assert_array_equal(tas.load_as_data(),
                                  jas.generate_as_data(T=80, seed=1793))
    assert tas.load_as_data().dtype == np.float64
