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
from smc_tpu_torch.ops import cuda_dsge

from torch_parity import as_prior_draws, assert_loglh_close, tiny_system

pytestmark = pytest.mark.cuda


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
    before = cuda_dsge.LAUNCHES["re"]
    X, M, ok = cuda_dsge.solve_linear_re(*sys_t)
    assert cuda_dsge.LAUNCHES["re"] == before + 1
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
