"""The plain SW and AS likelihoods of perfbench/reference/ against the
port's plain path (models/dsge.py bl_dsge_loglike, what a CPU tensor runs)
on seeded draws at small N. The test imports the port; the reference does
not."""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from perfbench.reference import an_schorfheide, smets_wouters  # noqa: E402

# within 50 nats of the best draw the two agree to rounding; further out
# two correct f64 Chandrasekhar recursions drift apart (the port's SW tail
# band, chip_smoke.SW_TAIL_RTOL)
BAND_NATS, BAND_RTOL, TAIL_RTOL = 50.0, 1e-10, 1e-3


def _case(name, n, seed):
    from smc_tpu_torch.models import as_dsge, sw_dsge
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    mod, params, ref, data = {
        "as": (as_dsge, as_dsge.an_schorfheide_parameters(),
               an_schorfheide, as_dsge.load_as_data()),
        "sw": (sw_dsge, sw_dsge.sw_parameters(), smets_wouters,
               sw_dsge.load_sw_data()),
    }[name]
    th = ParamSpace(params).sample_prior(TorchDraws(seed, "cpu"), n,
                                         device="cpu")
    g = torch.Generator().manual_seed(seed)
    near = torch.as_tensor(mod.TRUE_PARAMS)[None] * (
        1 + 1e-2 * torch.randn((8, th.shape[1]), generator=g,
                               dtype=torch.float64))
    return mod, ref, torch.cat([th, near]), data


@pytest.mark.parametrize("name,n,seed", [("as", 256, 3), ("as", 128, 11),
                                         ("sw", 40, 5)])
def test_reference_matches_the_ports_plain_path(name, n, seed):
    from smc_tpu_torch.models.dsge import bl_dsge_loglike
    mod, ref, th, data = _case(name, n, seed)
    A, B, C, D = mod._system(th)
    d, Z, H = mod._measurement(th)
    want = bl_dsge_loglike(A, B, C, D, mod._shock_cov(th), Z, d, H,
                           torch.as_tensor(data))
    got = ref.loglike(th, data)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert fin[-8:].all()
    rel = (got - want).abs() / want.abs()
    band = fin & (want > want[fin].max() - BAND_NATS)
    assert rel[band].max() <= BAND_RTOL
    assert rel[fin].max() <= TAIL_RTOL


@pytest.mark.parametrize("name", ["as", "sw"])
def test_reference_system_matches_the_ports(name):
    mod, ref, th, _ = _case(name, 16, 7)
    A, B, C, D = mod._system(th)
    d, Z, H = mod._measurement(th)
    got = ref.inputs(th)
    want = (A, B, C, D, mod._shock_cov(th), Z, d, H)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.allclose(g, w, rtol=1e-14, atol=1e-14)


def test_reference_computes_in_the_dtype_it_is_given():
    _, ref, th, data = _case("as", 8, 1)
    assert ref.loglike(th.float(), data).dtype == torch.float32


@pytest.mark.parametrize("name,seed", [("as", 13), ("sw", 17)])
def test_reference_prior_matches_the_ports(name, seed):
    from smc_tpu_torch.params import ParamSpace
    from perfbench.reference import prior
    mod, ref, th, _ = _case(name, 512, seed)
    space = ParamSpace(mod.an_schorfheide_parameters() if name == "as"
                       else mod.sw_parameters())
    assert [p[0] for p in ref.PRIORS] == space.names
    assert [(p[4], p[5]) for p in ref.PRIORS] == list(zip(space.lo,
                                                          space.hi))
    # the port's draws, and the same draws pushed past the bounds
    wide = torch.cat([th, th * 1.5])
    got, want = prior.log_prior(ref.PRIORS, wide), space.log_prior(wide)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert fin.sum() > 100
    assert torch.allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)
    torch.manual_seed(seed)
    draws = prior.sample(ref.PRIORS, 20000)
    ours = space.sample_prior(__import__("smc_tpu_torch.rng", fromlist=[
        "TorchDraws"]).TorchDraws(seed, "cpu"), 20000, device="cpu")
    # the same families: the means of 20,000 draws agree within 5 se
    se = ours.std(0) / 20000 ** 0.5
    assert ((draws.mean(0) - ours.mean(0)).abs() <= 5 * 2 ** 0.5 * se).all()
