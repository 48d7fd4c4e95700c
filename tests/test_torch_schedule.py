"""smc_tpu_torch's adaptive schedule: `solve_adaptive_phi` against the jitted
JAX function (j and phi_prop equal, phi_n within 1e-12), its [K, N] advance
against the loop form on ties, and a whole adaptive run on the linear fixture
against the exact posterior means (within 0.5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp

from smc_tpu.ops.schedule import solve_adaptive_phi as j_solve

import smc_tpu_torch
from smc_tpu_torch.ops.schedule import fixed_schedule, solve_adaptive_phi, _ess
from smc_tpu_torch.models.linear import (linear_parameters,
                                         make_linear_loglike,
                                         generate_linear_data,
                                         exact_linear_posterior)

PHI_ATOL = 1e-12


def _cloud(n, scale, seed, old=False):
    """loglh with sd `scale`, skewed weights summing to n, and (with `old`)
    a nonzero old_loglh, from numpy."""
    rng = np.random.default_rng(seed)
    loglh = -50.0 + scale * rng.standard_normal(n)
    w = np.exp(0.3 * rng.standard_normal(n))
    w = n * w / w.sum()
    old_ll = (-40.0 + scale * rng.standard_normal(n)) if old else np.zeros(n)
    return loglh, w, old_ll


def _target(w, ratio=0.97):
    """ratio x the ESS of the current weights, as smc() sets it."""
    return ratio * len(w) ** 2 / np.sum(w * w)


def _both(loglh, w, old_ll, phi_n1, sched, j, phi_prop, ess_bar):
    t = solve_adaptive_phi(torch.tensor(loglh), torch.tensor(w),
                           torch.tensor(old_ll), phi_n1, sched, j, phi_prop,
                           ess_bar)
    jx = j_solve(jnp.asarray(loglh), jnp.asarray(w), jnp.asarray(old_ll),
                 jnp.float64(phi_n1), jnp.asarray(sched), jnp.int64(j),
                 jnp.float64(phi_prop), jnp.float64(ess_bar))
    return ((t[0].item(), int(t[1]), t[2].item()),
            (float(jx[0]), int(jx[1]), float(jx[2])))


def _assert_same(got, want):
    assert got[1] == want[1]                      # j
    assert got[2] == want[2]                      # phi_prop
    assert abs(got[0] - want[0]) <= PHI_ATOL, (got, want)


# (loglh sd, old_loglh nonzero, start entry j): an interior target at the
# current proposal, an advance over several entries, saturation at phi = 1
CASES = {"interior": (1000.0, False, 11), "advance": (10.0, True, 11),
         "saturation": (0.05, False, 11)}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_adaptive_phi_matches_jax(case):
    scale, old, j0 = CASES[case]
    n = 2000
    loglh, w, old_ll = _cloud(n, scale, seed=3, old=old)
    sched = fixed_schedule(100, 2.0)
    phi_n1, phi_prop = float(sched[j0 - 1]), float(sched[j0])
    got, want = _both(loglh, w, old_ll, phi_n1, sched, j0, phi_prop,
                      _target(w))
    _assert_same(got, want)
    if case == "interior":
        assert got[1] == j0 and phi_n1 < got[0] < phi_prop
    elif case == "advance":
        assert got[1] - j0 >= 3 and got[0] < 1.0
    else:
        assert got[1] == 100 and got[2] == 1.0 and got[0] == 1.0


@pytest.mark.parametrize("case", list(CASES) + ["exhausted"])
def test_device_j_matches_jax(case):
    """The scalars as the recursion passes them (j an int64 tensor, phi_n1,
    phi_prop and ess_bar f64 tensors, the schedule a tensor): the JAX
    function's (phi_n, j, phi_prop), with j returned as an int64 scalar.
    "exhausted" starts past the last entry (j = n_phi, phi_prop = 1)."""
    scale, old, j0 = CASES.get(case, (1000.0, False, 100))
    n = 2000
    loglh, w, old_ll = _cloud(n, scale, seed=5, old=old)
    sched = fixed_schedule(100, 2.0)
    phi_n1, phi_prop = float(sched[j0 - 2]), float(sched[j0 - 1])
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    phi, j, prop = solve_adaptive_phi(
        torch.tensor(loglh), torch.tensor(w), torch.tensor(old_ll),
        f64(phi_n1), torch.as_tensor(sched),
        torch.tensor(j0, dtype=torch.int64), f64(phi_prop), f64(_target(w)))
    assert j.dtype == torch.int64 and j.dim() == 0
    got = (phi.item(), int(j), prop.item())
    _, want = _both(loglh, w, old_ll, phi_n1, sched, j0, phi_prop,
                    _target(w))
    _assert_same(got, want)
    if case == "exhausted":
        assert got[1] == 100 and got[2] == 1.0 and phi_n1 < got[0] < 1.0


def _loop_form(loglh, w, old_ll, phi_n1, sched, j, phi_prop, ess_bar):
    """The JAX package's while loop, one scalar ESS per candidate."""
    lw, ll, ol = (torch.log(torch.tensor(w)), torch.tensor(loglh),
                  torch.tensor(old_ll))
    f = lambda phi: (_ess(lw, ll, ol, torch.tensor(phi, dtype=torch.float64),
                          torch.tensor(phi_n1, dtype=torch.float64)).item()
                     - ess_bar)
    while f(phi_prop) >= 0 and j < len(sched):
        j += 1
        phi_prop = float(sched[j - 1])
    return j, phi_prop


def test_advance_ties_match_loop_form():
    """Exact ties, where the two forms must make the same choice: constant
    likelihoods with uniform weights make ESS = N exactly, so f = 0 at
    every candidate and the advance runs to the end (phi = 1); repeated
    schedule entries make equal rows of the grid, and the advance stops at
    the first of them that fails."""
    n = 1000
    sched = fixed_schedule(50, 2.0)
    flat = (np.full(n, -7.25), np.ones(n), np.zeros(n))
    got, want = _both(*flat, float(sched[4]), sched, 5, float(sched[5]),
                      float(n))
    _assert_same(got, want)
    assert got == (1.0, 50, 1.0)
    assert _loop_form(*flat, float(sched[4]), sched, 5, float(sched[5]),
                      float(n)) == (50, 1.0)

    rep = np.concatenate([sched[:10], np.repeat(sched[10:14], 3), sched[14:]])
    loglh, w, old_ll = _cloud(n, 5.0, seed=8)
    args = (loglh, w, old_ll, float(rep[4]), rep, 5, float(rep[5]),
            _target(w))
    got, want = _both(*args)
    _assert_same(got, want)
    assert (got[1], got[2]) == _loop_form(*args)
    k = got[1] - 1                 # the entry it stopped at: first of three
    assert rep[k] == rep[k + 1] == rep[k + 2] != rep[k - 1]


def test_nan_likelihood_stops_the_advance():
    """A NaN ESS fails the loop's test at once, and the JAX package then
    returns phi = 1 (its `f < 0` is false); the port does the same."""
    n = 500
    loglh, w, old_ll = _cloud(n, 1.0, seed=4)
    loglh[7] = np.nan
    sched = fixed_schedule(30, 2.0)
    got, want = _both(loglh, w, old_ll, float(sched[2]), sched, 3,
                      float(sched[3]), _target(w))
    _assert_same(got, want)
    assert got == (1.0, 3, float(sched[3]))


def test_adaptive_run_on_linear_fixture_matches_exact_means():
    """5,000 particles, n_phi = 300: the configuration at which the JAX
    package passed the 0.5 gate on 10 of 10 seeds. The schedule rises
    strictly to 1, and each stage of the host loop makes one host read."""
    data, X = generate_linear_data(seed=1793)
    exact = exact_linear_posterior(data, X)
    res = smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(), data,
                            n_parts=5000, n_phi=300, lam=2.1, alpha=0.9,
                            use_fixed_schedule=False, tempering_target=0.97,
                            verbose="none", seed=21, device="cpu",
                            fused=False)
    sched = np.asarray(res.cloud.tempering_schedule)
    n_stages = len(sched) - 1
    assert np.all(np.diff(sched) > 0) and sched[-1] == 1.0
    assert res.host_reads == n_stages
    assert res.w.shape == (5000, n_stages + 1)
    err = np.max(np.abs(res.posterior_mean() - exact["mean"]))
    assert err < 0.5, (err, res.posterior_mean(), exact["mean"])
    assert np.isfinite(res.log_mdd)
