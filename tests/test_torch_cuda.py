"""smc_tpu_torch's CUDA kernels on the card, against their plain versions.
These need a CUDA card and nvcc and skip without them; on a GPU machine run
    python -m pytest tests/test_torch_cuda.py -m cuda
(chip_smoke.py runs the same checks at the full 16,384-particle size)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models.dsge import bl_dsge_loglike, bl_solve_linear_re
from smc_tpu_torch.ops import cuda_dsge, kernels
from smc_tpu_torch.ops.kernels import LAUNCHES

from torch_parity import (BAND_NATS, BAND_RTOL, TAIL_NATS, as_prior_draws,
                          assert_loglh_close, launches_since, tiny_system)

pytestmark = pytest.mark.cuda

# SW's Chandrasekhar tail drifts further than AS's (n_state 37, n_obs 7,
# H = 1e-10; ROADMAP Queue C item 5). Measured over prior draws, lanes
# within 1e6 nats of the best: torch against JAX on the CPU (256 draws) to
# 8.0e-7, the card against the CPU (1,024 draws, chip_smoke.py) to 4.2e-5;
# the -inf pattern was equal in both. The posterior band keeps
# tests/torch_parity.py's 1e-10.
SW_TAIL_RTOL = 1e-3


def assert_sw_loglh_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    best = want[fin].max()
    band = fin & (want > best - BAND_NATS)
    tail = fin & (want > best - TAIL_NATS)
    assert band.sum() >= 2
    np.testing.assert_allclose(got[band], want[band], rtol=BAND_RTOL, atol=0)
    np.testing.assert_allclose(got[tail], want[tail], rtol=SW_TAIL_RTOL,
                               atol=0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _as_inputs(dev, n=2048, seed=3):
    th = torch.as_tensor(as_prior_draws(n, seed=seed), device=dev)
    d, Z, H = tas._measurement(th)
    data = torch.as_tensor(tas.load_as_data(), device=dev).contiguous()
    return tas._system(th), (tas._shock_cov(th), Z, d, H, data)


def test_re_kernel_matches_plain(dev):
    sys_t, _ = _as_inputs(dev)
    before = dict(LAUNCHES)
    X, M, ok = cuda_dsge.solve_linear_re(*sys_t)
    assert launches_since(before) == {"re": 1}
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    assert (ok == okp).double().mean().item() >= 0.9999
    both = (ok & okp).cpu()
    for a, b in ((X, Xp), (M, Mp)):
        np.testing.assert_allclose(a.cpu()[..., both], b.cpu()[..., both],
                                   rtol=1e-10, atol=1e-12)


def test_loglike_kernels_match_plain(dev):
    sys_t, rest = _as_inputs(dev)
    ll = cuda_dsge.dsge_loglike(*sys_t, *rest)
    want = bl_dsge_loglike(*sys_t, *rest)
    fin = torch.isfinite(ll) & torch.isfinite(want)
    assert int((torch.isfinite(ll) != torch.isfinite(want)).sum()) <= 2
    assert_loglh_close(ll[fin].cpu().numpy(), want[fin].cpu().numpy())


def test_tiny_system_kernels_match_plain(dev):
    args = [torch.as_tensor(a, device=dev).contiguous() for a in tiny_system()]
    got = cuda_dsge.dsge_loglike(*args)
    want = bl_dsge_loglike(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("part", ["re", "kalman"])
@pytest.mark.parametrize("n", [1, 3, 5, 257])
def test_ragged_n_kernels_match_plain(dev, n, part):
    sys_t, rest = _as_inputs(dev, n, seed=10 + n)
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    if part == "re":
        X, M, ok = cuda_dsge.solve_linear_re(*sys_t)
        assert torch.equal(ok, okp)
        for a, b in ((X, Xp), (M, Mp)):
            np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-10,
                                       atol=1e-12)
    else:
        ll = cuda_dsge.kalman_chandrasekhar(Xp, Mp, *rest, ok=okp)
        want = bl_dsge_loglike(*sys_t, *rest)
        assert_loglh_close(ll.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("shape", [(1, 1), (4, 2), (7, 3), (8, 8)])
def test_kernels_across_the_domain_match_plain(dev, shape):
    """Both kernels at shapes of their domain on 257 synthetic systems
    (ragged warps) against their plain versions, and a NaN particle that
    leaves its neighbours bitwise alone."""
    from torch_parity import synthetic_system
    sys_np, data = synthetic_system(*shape, 257, n_t=40)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x, device=dev)
                              for x in sys_np)
    data = torch.as_tensor(data, device=dev)
    X, M, ok = cuda_dsge.solve_linear_re(A, B, C, D)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert torch.equal(ok, okp)
    for a, b in ((X, Xp), (M, Mp)):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-10, atol=1e-12)
    ll = cuda_dsge.dsge_loglike(A, B, C, D, Q, Z, d, H, data)
    assert_loglh_close(ll.cpu().numpy(),
                       bl_dsge_loglike(A, B, C, D, Q, Z, d, H,
                                       data).cpu().numpy())
    A_nan = A.clone()
    A_nan[:, :, 100] = float("nan")
    ll2 = cuda_dsge.dsge_loglike(A_nan, B, C, D, Q, Z, d, H, data)
    keep = torch.arange(257, device=dev) != 100
    assert ll2[100].item() == float("-inf")
    assert torch.equal(ll2[keep], ll[keep])


def _schedule_cloud(n, scale, seed):
    rng = np.random.default_rng(seed)
    w = np.exp(0.3 * rng.standard_normal(n))
    return (-50.0 + scale * rng.standard_normal(n), n * w / w.sum(),
            -40.0 + scale * rng.standard_normal(n))


@pytest.mark.parametrize("scale", [1000.0, 10.0, 0.05])
def test_solve_adaptive_phi_on_card_matches_cpu(dev, scale):
    """An interior target, an advance over several entries, saturation at
    1: j and phi_prop equal, phi_n within 1e-12."""
    from smc_tpu_torch.ops.schedule import fixed_schedule, solve_adaptive_phi
    loglh, w, old = _schedule_cloud(16_384, scale, seed=3)
    sched = fixed_schedule(100, 2.0)
    ess_bar = 0.97 * len(w) ** 2 / np.sum(w * w)
    out = []
    for d in ("cpu", dev):
        phi, j, prop = solve_adaptive_phi(
            *(torch.as_tensor(a, device=d) for a in (loglh, w, old)),
            float(sched[10]), sched, 11, float(sched[11]), ess_bar)
        out.append((phi.item(), int(j), prop.item()))
    (phi_c, j_c, prop_c), (phi_g, j_g, prop_g) = out
    assert (j_g, prop_g) == (j_c, prop_c)
    assert abs(phi_g - phi_c) <= 1e-12


def test_metropolis_fixed_chain_on_card_matches_cpu(dev):
    """The same numpy draws replayed on both devices give the same
    ancestors, across the chain's 128-step draw blocks."""
    from smc_tpu_torch.ops.resample import resample
    from smc_tpu_torch.rng import ReplayDraws
    n, n_iter = 4096, 300
    rng = np.random.default_rng(9)
    w = np.exp(1.5 * rng.standard_normal(n))
    props = rng.integers(0, n, (n_iter, n))
    us = rng.uniform(size=(n_iter, n))
    entries = []
    for s in range(0, n_iter, 128):
        entries += [("integers", props[s:s + 128]),
                    ("uniform", us[s:s + 128])]
    got = [resample(ReplayDraws(entries, device=d),
                    torch.as_tensor(w, device=d), method="metropolis",
                    n_iter=n_iter).cpu() for d in ("cpu", dev)]
    assert torch.equal(got[0], got[1])


def _card_and_cpu(dev, model, params, data, n, seed):
    """n prior draws (made on the CPU) through the model on both devices."""
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    th = ParamSpace(params).sample_prior(TorchDraws(seed, "cpu"), n,
                                         device="cpu")
    return (model.loglike_batched(th.to(dev), data).cpu().numpy(),
            model.loglike_batched(th, data).numpy())


def test_as_2obs_likelihood_on_card_matches_cpu(dev):
    """The Cholesky innovation path on the card: the general-shape kernels,
    one launch each, none of the n_obs 3 kernels."""
    before = dict(LAUNCHES)
    got, want = _card_and_cpu(dev, tas.an_schorfheide_2obs(),
                              tas.an_schorfheide_parameters(),
                              tas.load_as_data()[:2], 2048, seed=4)
    assert launches_since(before) == {"re_general": 1, "kalman_general": 1}
    assert_loglh_close(got, want)


def test_as_plain_backend_on_card_runs_the_n_obs3_kernels(dev):
    """AS on the "plain" backend on the card: its shape lies in the n_obs 3
    kernels' domain, so it runs them (one launch each, none of the general
    kernels) and gives the "kernel" backend's bits."""
    th = torch.as_tensor(as_prior_draws(1024, seed=5), device=dev)
    data = tas.load_as_data()
    before = dict(LAUNCHES)
    got = tas.an_schorfheide("plain").loglike_batched(th, data)
    assert launches_since(before) == {"re": 1, "kalman": 1}
    assert torch.equal(got, tas.an_schorfheide().loglike_batched(th, data))


def test_kalman_smem_bytes_are_the_kernels(dev):
    """The route decides the n_obs 3 kernels' domain from its own copy of
    the Kalman kernel's shared memory: equal to the library's."""
    for n_s in cuda_dsge._build.DSGE_STATES:
        lib = kernels.load(f"dsge_ns{n_s}", dev)
        for n_t in (0, 1, 80, 197, 7936, 9301):
            assert lib.smc_kalman_smem_bytes(n_s, n_t) == \
                cuda_dsge.kalman_smem_bytes(n_s, n_t)


def test_sw_likelihood_on_card_matches_cpu(dev):
    """SW on the card against the CPU in SW's bands (tests/test_torch_sw.py:
    the Chandrasekhar tail of n_state 37, n_obs 7 drifts further)."""
    from smc_tpu_torch.models import sw_dsge
    got, want = _card_and_cpu(dev, sw_dsge.smets_wouters(),
                              sw_dsge.sw_parameters(), sw_dsge.load_sw_data(),
                              256, seed=4)
    near = sw_dsge.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                                  .standard_normal((4, 36)))
    th = torch.as_tensor(near)
    model = sw_dsge.smets_wouters()
    got_near = model.loglike_batched(th.to(dev), sw_dsge.load_sw_data())
    want_near = model.loglike_batched(th, sw_dsge.load_sw_data())
    assert_sw_loglh_close(np.concatenate([got, got_near.cpu().numpy()]),
                          np.concatenate([want, want_near.numpy()]))


def _sw_inputs(dev, n=256, seed=4):
    """n SW prior draws (made on the CPU) and the 4 near-mode draws of
    test_sw_likelihood_on_card_matches_cpu: the system on the card."""
    from smc_tpu_torch.models import sw_dsge
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    th = ParamSpace(sw_dsge.sw_parameters()).sample_prior(
        TorchDraws(seed, "cpu"), n, device="cpu")
    near = sw_dsge.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                                  .standard_normal((4, 36)))
    th = torch.cat([th, torch.as_tensor(near)]).to(dev)
    d, Z, H = sw_dsge._measurement(th)
    data = torch.as_tensor(sw_dsge.load_sw_data(), device=dev).contiguous()
    return sw_dsge._system(th), (sw_dsge._shock_cov(th), Z, d, H, data)


def test_general_kernels_match_plain_at_sw_shape(dev):
    """The general-shape kernels against their plain versions on the card
    at SW's shape (37, 7, 7): RE ok flags, X and M normwise within 1e-10,
    the likelihood in SW's bands; one launch each."""
    from torch_parity import normwise_rel
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sys_t, rest = _sw_inputs(dev)
    before = dict(LAUNCHES)
    X, M, ok = g.solve_linear_re(*sys_t)
    ll = g.kalman_chandrasekhar(X, M, *rest, ok=ok)
    assert launches_since(before) == {"re_general": 1, "kalman_general": 1}
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    assert torch.equal(ok, okp)
    assert normwise_rel(X[..., ok], Xp[..., ok]).max().item() <= 1e-10
    assert normwise_rel(M[..., ok], Mp[..., ok]).max().item() <= 1e-10
    want = bl_dsge_loglike(*sys_t, *rest)
    assert_sw_loglh_close(ll.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("shape", [(1, 1, 1), (9, 3, 2), (17, 4, 7),
                                   (37, 7, 3), (64, 3, 7)])
def test_general_kernels_across_shapes_match_plain(dev, shape):
    """Both block sizes and both innovation solves on 257 synthetic
    systems, and a NaN particle that leaves its neighbours bitwise alone."""
    from torch_parity import normwise_rel, synthetic_system
    from smc_tpu_torch.ops import cuda_dsge_general as g
    n_s, n_k, n_o = shape
    sys_np, data = synthetic_system(n_s, n_k, 257, n_t=40, n_o=n_o)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x, device=dev)
                              for x in sys_np)
    data = torch.as_tensor(data, device=dev)
    X, M, ok = g.solve_linear_re(A, B, C, D)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert torch.equal(ok, okp) and bool(ok.all())
    assert normwise_rel(X, Xp).max().item() <= 1e-10
    assert normwise_rel(M, Mp).max().item() <= 1e-10
    ll = g.dsge_loglike(A, B, C, D, Q, Z, d, H, data)
    assert_loglh_close(ll.cpu().numpy(),
                       bl_dsge_loglike(A, B, C, D, Q, Z, d, H,
                                       data).cpu().numpy())
    A_nan = A.clone()
    A_nan[:, :, 100] = float("nan")
    ll2 = g.dsge_loglike(A_nan, B, C, D, Q, Z, d, H, data)
    keep = torch.arange(257, device=dev) != 100
    assert ll2[100].item() == float("-inf")
    assert torch.equal(ll2[keep], ll[keep])


def _host_build():
    import shutil
    from torch_parity import GeneralHostBuild
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the block bodies")
    return GeneralHostBuild()


def test_general_kalman_at_sw_shape_matches_host_build(dev):
    """The Kalman kernel at SW's shape (37, 7, 7) against its host build
    (the same block body through g++, on the CPU) and the plain version,
    on the card's RE solutions, in SW's bands."""
    from smc_tpu_torch.models.dsge import bl_kalman_loglike_chandrasekhar
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sys_t, rest = _sw_inputs(dev)
    X, M, ok = g.solve_linear_re(*sys_t)
    got = g.kalman_chandrasekhar(X, M, *rest, ok=ok).cpu().numpy()
    cpu = [x.cpu() for x in (X, M, *rest)]
    host = _host_build().kalman(*cpu, ok.cpu()).numpy()
    want = torch.where(ok.cpu(), bl_kalman_loglike_chandrasekhar(*cpu),
                       float("-inf")).numpy()
    assert_sw_loglh_close(got, host)
    assert_sw_loglh_close(got, want)


def _sw_pi_fg_draws(dev, n=256, seed=4):
    """n prior draws of models/sw_pi_fg.py (made on the CPU) and 4 within
    1e-4 of its TRUE_PARAMS, on the card."""
    from smc_tpu_torch.models import sw_pi_fg
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    th = ParamSpace(sw_pi_fg.sw_pi_fg_parameters()).sample_prior(
        TorchDraws(seed, "cpu"), n, device="cpu")
    near = sw_pi_fg.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                                   .standard_normal((4, th.shape[1])))
    return torch.cat([th, torch.as_tensor(near)]).to(dev)


def _sw_pi_fg_system(dev, n=256, seed=4):
    """_sw_pi_fg_draws' system (44 states, 14 shocks) on the card."""
    from smc_tpu_torch.models import sw_pi_fg
    return sw_pi_fg._system(_sw_pi_fg_draws(dev, n, seed))


@pytest.mark.parametrize("model", ["sw", "sw_pi_fg"])
def test_general_re_matches_host_build(dev, model):
    """The RE kernel at SW's (37, 7) and sw_pi_fg's (44, 14), the large
    team's panel Gauss-Jordan, against its host build (the same block body
    through g++, on the CPU): the same ok flags, X and M within 1e-12
    normwise (the card's fused multiply-adds leave one of SW's 248 ok draws
    1.2e-13 from the host build, the serial Gauss-Jordan's kernel as
    well)."""
    from torch_parity import normwise_rel
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sys_t = _sw_inputs(dev)[0] if model == "sw" else _sw_pi_fg_system(dev)
    X, M, ok = g.solve_linear_re(*sys_t)
    hX, hM, hok = _host_build().re(
        *(x.cpu().contiguous() for x in sys_t))
    assert torch.equal(ok.cpu(), hok)
    assert int(hok.sum()) > 100
    for got, want in ((X, hX), (M, hM)):
        assert normwise_rel(got.cpu()[..., hok], want[..., hok]).max() \
            <= 1e-12


@pytest.mark.parametrize("n_o", [2, 3, 5, 7, 16])
@pytest.mark.parametrize("n_s", [12, 37])
def test_general_kalman_across_n_obs_matches_host_build(dev, n_s, n_o):
    """The Kalman kernel on 257 synthetic systems at each n_obs (the
    cofactor form at 3, the innovation warp's Cholesky otherwise), both
    block sizes (one product warp at n_state 12, seven at 37), against its
    host build and the plain version."""
    from torch_parity import synthetic_system
    from smc_tpu_torch.models.dsge import bl_kalman_loglike_chandrasekhar
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sys_np, data = synthetic_system(n_s, 4, 257, n_t=40, n_o=n_o)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x) for x in sys_np)
    data = torch.as_tensor(data)
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    assert bool(ok.all())
    cpu = (X, M, Q, Z, d, H, data)
    before = dict(LAUNCHES)
    got = g.kalman_chandrasekhar(*(x.to(dev) for x in cpu), ok=ok.to(dev))
    assert launches_since(before) == {"kalman_general": 1}
    host = _host_build().kalman(*cpu, ok)
    want = bl_kalman_loglike_chandrasekhar(*cpu)
    assert_loglh_close(got.cpu().numpy(), host.numpy())
    assert_loglh_close(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("shape,blocks", [((44, 14, 14), 2), ((37, 7, 7), 3)])
def test_kalman_blocks_per_sm(dev, shape, blocks):
    """The Kalman kernel's residency, which sets its rate (each particle a
    chain of dependent steps): two of sw_pi_fg's blocks an SM on rows of 16
    (its 100 kB tile without the observations, 128 registers), three of
    SW's on rows of 8."""
    from smc_tpu_torch.ops import cuda_dsge_general as g
    assert g.kalman_blocks_per_sm(*shape, device=dev) == blocks


def _kalman_rows16_inputs(shape):
    """CPU inputs (X, M, Q, Z, d, H, data, ok) of the Kalman filter on rows
    of 16: sw_pi_fg's (44, 14, 14), its expectation rows filled, over its
    committed 156 quarters on 64 prior and 4 near-mode draws, or over n_t
    quarters simulated at the mode on 33 draws within 1% of the mode (deep
    in the prior's tail two exact float64 filters drift apart past SW's
    1e-3 band, the more the longer the recursion: one of 33 prior draws
    over 400 quarters, at -7.1e5 nats, read 3.0e-3 between the card and the
    host build); else 33 synthetic systems at (n_s, n_k, n_o) over n_t
    standard normal observations."""
    from torch_parity import synthetic_system
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.models.dsge import bl_expectation_rows
    n_s, n_k, n_o, n_t = shape
    if (n_s, n_k, n_o) == (44, 14, 14):
        th = (_sw_pi_fg_draws("cpu", n=64) if n_t == 156 else
              torch.as_tensor(fg.TRUE_PARAMS * (1.0 + 1e-2 * np.random
                                                .default_rng(5)
                                                .standard_normal((33, 43)))))
        X, M, ok = bl_solve_linear_re(*fg._system(th))
        d, Z, H = fg._measurement(th)
        Z = bl_expectation_rows(Z, X, fg.EXPECTATION_ROWS, ok)
        data = (fg.load_sw_pi_fg_data() if n_t == 156
                else fg.generate_sw_pi_fg_data(T=n_t))
        return X, M, fg._shock_cov(th), Z, d, H, torch.as_tensor(data), ok
    sys_np, _ = synthetic_system(n_s, n_k, 33, n_t=1, n_o=n_o)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x) for x in sys_np)
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    data = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (n_o, n_t)))
    return X, M, Q, Z, d, H, data, ok


@pytest.mark.parametrize("shape", [(44, 14, 14, 156), (44, 14, 14, 400),
                                   (64, 64, 16, 400)])
def test_general_kalman_on_rows_of_16_matches_host_build(dev, shape):
    """kalman_general_kernel<256, 16>, the observations read from global
    memory a step ahead, over data of any length: at sw_pi_fg's shape over
    its 156 quarters and 400, and at (64, 64, 16) over 400, whose tile
    with the observations would not fit a block's shared memory; against
    its host build and the plain version (SW's bands at sw_pi_fg's
    shape)."""
    from smc_tpu_torch.models.dsge import bl_kalman_loglike_chandrasekhar
    from smc_tpu_torch.ops import cuda_dsge_general as g
    *cpu, ok = _kalman_rows16_inputs(shape)
    assert g.in_domain(*shape)
    before = dict(LAUNCHES)
    got = g.kalman_chandrasekhar(*(x.to(dev) for x in cpu),
                                 ok=ok.to(dev)).cpu().numpy()
    assert launches_since(before) == {"kalman_general": 1}
    host = _host_build().kalman(*cpu, ok).numpy()
    want = torch.where(ok, bl_kalman_loglike_chandrasekhar(*cpu),
                       float("-inf")).numpy()
    close = assert_sw_loglh_close if shape[0] == 44 else assert_loglh_close
    close(got, host)
    close(got, want)


@pytest.mark.parametrize("n_s,n_o", [(5, 2), (5, 3), (20, 7), (20, 16)])
def test_general_kalman_without_observations(dev, n_s, n_o):
    """n_t = 0: the kernel reads no observation and returns 0 for every
    particle, as its host build and the plain version do, and the card's
    context stays sound for the next launch."""
    from torch_parity import synthetic_system
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sys_np, data = synthetic_system(n_s, 2, 33, n_t=1, n_o=n_o)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x) for x in sys_np)
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    assert bool(ok.all())
    cpu = (X, M, Q, Z, d, H, torch.zeros((n_o, 0), dtype=torch.float64))
    got = g.kalman_chandrasekhar(*(x.to(dev) for x in cpu), ok=ok.to(dev))
    torch.cuda.synchronize(dev)
    zero = torch.zeros(33, dtype=torch.float64)
    assert torch.equal(got.cpu(), zero)
    assert torch.equal(_host_build().kalman(*cpu, ok), zero)
    one = g.kalman_chandrasekhar(*(x.to(dev) for x in cpu[:-1]),
                                 torch.as_tensor(data).to(dev), ok=ok.to(dev))
    torch.cuda.synchronize(dev)
    assert bool(torch.isfinite(one).all())


def test_general_kernels_in_a_cuda_graph(dev):
    """SW's and AS-2obs's likelihood captured in one CUDA graph (no host
    read, no attribute set, no allocation from the host inside the calls):
    a replay gives the eager call's bits."""
    from smc_tpu_torch.models import sw_dsge
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sw, as2 = sw_dsge.smets_wouters(), tas.an_schorfheide_2obs()
    th_sw = torch.as_tensor(np.stack([sw_dsge.TRUE_PARAMS] * 3)
                            * np.array([[1.0], [1.001], [0.999]]),
                            device=dev)
    th_as = torch.as_tensor(as_prior_draws(512, seed=8), device=dev)
    data_sw, data_as = sw_dsge.load_sw_data(), tas.load_as_data()[:2]
    call = lambda: (sw.loglike_batched(th_sw, data_sw),
                    as2.loglike_batched(th_as, data_as))
    eager = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    with torch.cuda.graph(graph):
        out = call()
    assert launches_since(before) == {"re_general": 2, "kalman_general": 2}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
    assert bool(torch.isfinite(eager[0]).all())


def test_one_rank_nccl_mesh_matches_unsharded(dev, tmp_path):
    """AS on the kernels under a one-rank NCCL particle mesh: the same
    kernel launches and the same run as without the mesh, bit for bit,
    the fused recursion capturing the mesh's collectives in its graph
    (counted once per replay)."""
    import torch.distributed as dist
    import smc_tpu_torch
    from smc_tpu_torch.parallel import initialize_multihost, particle_mesh
    model = tas.an_schorfheide()
    run = lambda mesh: smc_tpu_torch.smc(
        model.loglike_batched, tas.an_schorfheide_parameters(),
        tas.load_as_data(), batched=True, n_parts=1024, n_phi=6, lam=2.0,
        verbose="none", seed=2, device=dev, mesh=mesh)
    before = dict(LAUNCHES)
    want = run(None)
    plain = launches_since(before)
    initialize_multihost(num_processes=1, process_id=0, backend="nccl",
                         device=dev,
                         store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        before = dict(LAUNCHES)
        got = run(particle_mesh())
        meshed = launches_since(before)
    finally:
        dist.destroy_process_group()
    n_calls = 1 + want.init_rounds + 5
    assert meshed == plain == {"re": n_calls, "kalman": n_calls, "eigh": 5}
    np.testing.assert_allclose(got.log_mdd, want.log_mdd, rtol=1e-12)
    np.testing.assert_allclose(got.cloud.loglh.cpu().numpy(),
                               want.cloud.loglh.cpu().numpy(), rtol=1e-12)
    assert got.collectives == 2 * 5 + 2
    assert got.fused and got.host_reads == 2
    assert torch.equal(got.cloud.params, want.cloud.params)
    assert got.log_mdd == want.log_mdd


def _spd(k, batch, seed, dev):
    x = np.random.default_rng(seed).standard_normal((batch, k, k + 2))
    return torch.as_tensor(x @ x.transpose(0, 2, 1), device=dev)


def _assert_eigh_close(a, lam, u):
    """The tests of the CPU body's tolerances, against torch.linalg.eigh."""
    from smc_tpu_torch.ops import cuda_eigh
    k = a.shape[-1]
    lam_p, _ = cuda_eigh.eigh_plain(a)
    scale = lam_p.abs().amax(dim=-1, keepdim=True)
    assert bool((lam - lam_p).abs().le(1e-12 * scale).all())
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    rec = u @ torch.diag_embed(lam) @ u.transpose(-1, -2)
    nrm = torch.linalg.matrix_norm(a)
    assert bool((torch.linalg.matrix_norm(rec - a) <= 1e-12 * nrm).all())
    assert bool(((u.transpose(-1, -2) @ u - eye).abs() <= 1e-12).all())


@pytest.mark.parametrize("k,batch", [(3, 3), (12, 3), (13, 1), (31, 2),
                                     (32, 20), (33, 2), (36, 2), (64, 1),
                                     (100, 2), (118, 1), (119, 1), (128, 2)])
def test_eigh_kernel_matches_plain(dev, k, batch):
    """The Jacobi kernel against torch.linalg.eigh on the card, one launch
    per call, NaN isolated, at each path's edges: two warps per matrix up
    to k = 32 (20 matrices: several blocks of teams), a block with the
    matrix in shared memory up to 118, past it the global workspace."""
    from smc_tpu_torch.ops import cuda_eigh
    a = _spd(k, batch, k, dev)
    before = dict(LAUNCHES)
    lam, u = cuda_eigh.eigh(a)
    assert launches_since(before) == {"eigh": 1}
    _assert_eigh_close(a, lam, u)
    a_nan = a.clone()
    a_nan[0, k - 1, 0] = float("nan")
    lam2, u2 = cuda_eigh.eigh(a_nan)
    assert bool(torch.isnan(lam2[0]).all() and torch.isnan(u2[0]).all())
    assert torch.equal(lam2[1:], lam[1:]) and torch.equal(u2[1:], u[1:])


@pytest.mark.parametrize("sizes", [(12, 12, 11), (33, 32), (128, 118)])
def test_eigh_kernel_two_sizes_in_one_launch(dev, sizes):
    """The mutation's block split (equal blocks, a smaller last one) in one
    launch: each matrix's bits equal a call on it alone, and the gates of
    test_eigh_kernel_matches_plain hold."""
    from smc_tpu_torch.ops import cuda_eigh
    first = _spd(sizes[0], len(sizes) - 1, sum(sizes), dev)
    last = _spd(sizes[-1], 1, sizes[-1], dev)
    before = dict(LAUNCHES)
    (lam0, u0), (lam1, u1) = cuda_eigh.eigh_batched([first, last])
    assert launches_since(before) == {"eigh": 1}
    for a, lam, u in ((first, lam0, u0), (last, lam1, u1)):
        _assert_eigh_close(a, lam, u)
        for i in range(a.shape[0]):
            lam_i, u_i = cuda_eigh.eigh(a[i])
            assert torch.equal(lam[i], lam_i) and torch.equal(u[i], u_i)


def _as_fused_recursion(dev, n=1024, seed=4):
    """A fused recursion of AS on the kernels from a prior cloud."""
    from smc_tpu_torch.ops.initialization import initial_draw
    from smc_tpu_torch.ops.schedule import fixed_schedule
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    from smc_tpu_torch.smc import (make_stage_core, make_recursion_step,
                                   FusedRecursion, _initial_state)
    model, data = tas.an_schorfheide(), tas.load_as_data()
    space = ParamSpace(tas.an_schorfheide_parameters())
    ll = lambda th: model.loglike_batched(th, data)
    draws = TorchDraws(seed, dev)
    cloud, _ = initial_draw(draws, space, ll, n, device=dev)
    cloud.ESS, cloud.accept_rate = [float(n)], 0.25
    stage = make_stage_core(space, ll, 1, 1, 0.9, "systematic", 0.5 * n)
    sched = torch.as_tensor(fixed_schedule(100, 2.0), device=dev)
    step = make_recursion_step(stage, sched, n, True, 0.97, 0.25)
    state = _initial_state(cloud, dev, 0.5, 0.0, 1, 0.0, False, 1)
    return FusedRecursion(step, draws, state, 4, n, True)


def test_captured_as_stage_replays_the_eager_stage(dev):
    """Stage 1 eager, stage 2 captured and replayed, against two eager
    stages from the same cloud and generator: every buffer and trace bit
    for bit, and each kernel counted once per replay."""
    graphed, eager = _as_fused_recursion(dev), _as_fused_recursion(dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graphed.run_stage()
        before = dict(LAUNCHES)
        graphed.run_stage()
        counted = launches_since(before)
        eager.body()
        eager.body()
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)
    assert graphed.graph is not None
    assert counted == {"re": 1, "kalman": 1, "eigh": 1}
    for k, v in graphed.buffers.items():
        assert torch.equal(v, eager.buffers[k]), k
    for a, b in ((graphed.scalars, eager.scalars), (graphed.w, eager.w),
                 (graphed.W, eager.W)):
        assert torch.equal(a, b)
    assert int(graphed.buffers["k"]) == 2


def test_fused_as_run_equals_host_loop_on_card(dev):
    """AS at 1,024 particles, 9 stages: fused (a graph replay per stage)
    and the host loop give the same bits and the same kernel launches."""
    import smc_tpu_torch
    model = tas.an_schorfheide()
    out = {}
    for fused in (True, False):
        before = dict(LAUNCHES)
        res = smc_tpu_torch.smc(
            model.loglike_batched, tas.an_schorfheide_parameters(),
            tas.load_as_data(), batched=True, n_parts=1024, n_phi=10,
            lam=2.0, verbose="none", seed=2, device=dev, fused=fused)
        out[fused] = res, launches_since(before)
    (a, la), (b, lb) = out[True], out[False]
    assert a.fused and not b.fused
    assert la == lb
    n_calls = 1 + a.init_rounds + 9
    assert la == {"re": n_calls, "kalman": n_calls, "eigh": 9}
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert a.log_mdd == b.log_mdd
    np.testing.assert_array_equal(a.W, b.W)
    assert a.host_reads == 2 and b.host_reads == 9


@pytest.mark.parametrize("fused", [True, False])
def test_eigh_one_launch_per_stage_with_blocks(dev, fused):
    """The linear fixture in 3 blocks of 3 at 2 MH steps per stage, fused
    (graph replays) and on the host loop: one eigh launch per stage."""
    import smc_tpu_torch
    from smc_tpu_torch.models.linear import (linear_parameters,
                                             make_linear_loglike,
                                             generate_linear_data)
    data, X = generate_linear_data(seed=1793)
    before = LAUNCHES["eigh"]
    res = smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(), data,
                            n_parts=1024, n_phi=8, lam=2.1, n_blocks=3,
                            n_mh_steps=2, verbose="none", seed=2, device=dev,
                            fused=fused)
    assert res.fused == fused
    assert LAUNCHES["eigh"] - before == 7


@pytest.mark.parametrize("case", ["n1", "n7", "n4096", "n_out_less",
                                  "n_out_more", "zero", "nan", "nan_inside",
                                  "spike", "capped", "no_resample"])
def test_metropolis_chain_kernel_matches_plain(dev, case):
    """The chain kernel against its plain version on the card, bit for bit,
    in tests/torch_metropolis.py's cases (sizes, n_out != n, zero and NaN
    weights, a single non-zero weight, a capped chain, no resample): one
    launch each."""
    from smc_tpu_torch.ops import cuda_metropolis
    from smc_tpu_torch.ops.resample import chain_steps
    from torch_metropolis import chain_case
    w, n_out, steps, cap, flag, key = chain_case(case)
    wt, key = torch.as_tensor(w, device=dev), key.to(dev)
    steps_t = (chain_steps(wt, 0.01, cap)[0] if steps is None
               else torch.tensor(steps, device=dev))
    flag_t = torch.tensor(flag, device=dev)
    before = dict(LAUNCHES)
    got = cuda_metropolis.metropolis_chain(wt, key, steps_t, flag_t, n_out)
    torch.cuda.synchronize(dev)
    assert launches_since(before) == {"metropolis": 1}
    want = cuda_metropolis.metropolis_chain_plain(wt, key, steps_t, flag_t,
                                                  n_out)
    assert torch.equal(got, want)


def test_fused_metropolis_run_equals_host_loop_on_card(dev):
    """The linear fixture with Metropolis resampling at 2,048 particles:
    fused (a graph replay per stage, the chain kernel inside it) and the
    host loop give the same bits and Doeblin lengths, one chain launch per
    stage each."""
    import smc_tpu_torch
    from smc_tpu_torch.models.linear import (linear_parameters,
                                             make_linear_loglike,
                                             generate_linear_data)
    data, X = generate_linear_data(seed=1793)
    out = {}
    for fused in (True, False):
        before = LAUNCHES["metropolis"]
        res = smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(),
                                data, n_parts=2048, n_phi=20, lam=2.1,
                                resampling_method="metropolis",
                                verbose="none", seed=2, device=dev,
                                fused=fused)
        out[fused] = res, LAUNCHES["metropolis"] - before
    (a, la), (b, lb) = out[True], out[False]
    assert a.fused and not b.fused
    assert la == lb == 19
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert a.log_mdd == b.log_mdd
    np.testing.assert_array_equal(a.W, b.W)
    assert a.chain_lengths == b.chain_lengths and a.chain_lengths
    assert a.host_reads == 2 and b.host_reads == 19
