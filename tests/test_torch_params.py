"""smc_tpu_torch priors and parameter space against the JAX package."""

import math
import subprocess
import sys
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp
from scipy import stats

from smc_tpu import distributions as jd
from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.models.as_dsge import an_schorfheide_parameters as j_as_params
from smc_tpu.models.regression import regression_parameters as j_reg_params

from smc_tpu_torch import distributions as td
from smc_tpu_torch.params import ParamSpace, ARRAY_FIELDS, parameter
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.models.as_dsge import an_schorfheide_parameters
from smc_tpu_torch.models.regression import regression_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, a, b) for every code
FAMILIES = [("point", 0.0, 0.0), ("normal", 0.4, 0.2), ("uniform", -1.0, 2.0),
            ("gamma", 16.0, 0.125), ("beta", 2.0, 5.0),
            ("inverse_gamma", 6.0, 2.0), ("root_inverse_gamma", 8.0, 0.5),
            ("truncated_normal", 0.5, 1.5)]


@pytest.mark.parametrize("family,a,b", FAMILIES)
def test_logpdf_family_matches_jax(family, a, b):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-3, 3, 200), rng.uniform(0, 1, 50),
                        [0.0, 1.0, -1.0, 2.0, 1e-300, -1e-300]])
    code = td.FAMILY_CODES[family]
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    got = td.logpdf_family(torch.tensor(code), f64(a), f64(b),
                           torch.as_tensor(x)).numpy()
    want = np.asarray(jd.logpdf_family(code, jnp.float64(a), jnp.float64(b),
                                       jnp.asarray(x)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-300)
    assert np.all(got[~fin] == -np.inf)


def _all_families_jax():
    from smc_tpu.params import parameter as jparam
    out = []
    for i, (fam, a, b) in enumerate(FAMILIES[1:]):
        bounds = (-0.5, 3.0) if fam == "truncated_normal" else (-50.0, 50.0)
        out.append(jparam(f"p{i}", 0.5, bounds,
                          prior=jd.Distribution(fam, a, b)))
    out.append(jparam("fixed", 0.7, (0.0, 1.0), prior=jd.Normal(0, 1),
                      fixed=True))
    return out


def _all_families_torch():
    out = []
    for i, (fam, a, b) in enumerate(FAMILIES[1:]):
        bounds = (-0.5, 3.0) if fam == "truncated_normal" else (-50.0, 50.0)
        out.append(parameter(f"p{i}", 0.5, bounds,
                             prior=td.Distribution(fam, a, b)))
    out.append(parameter("fixed", 0.7, (0.0, 1.0), prior=td.Normal(0, 1),
                         fixed=True))
    return out


SPACES = {
    "as": (j_as_params, an_schorfheide_parameters),
    "regression": (j_reg_params, regression_parameters),
    "all_families": (_all_families_jax, _all_families_torch),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_param_space_arrays_and_from_numpy(name):
    jfn, tfn = SPACES[name]
    js = JParamSpace(jfn())
    fields = {k: getattr(js, k) for k in ARRAY_FIELDS}
    for ts in (ParamSpace(tfn()), ParamSpace.from_numpy(fields)):
        assert ts.names == list(js.names)
        for k in ARRAY_FIELDS[1:]:
            np.testing.assert_array_equal(getattr(ts, k), getattr(js, k),
                                          err_msg=k)
        np.testing.assert_array_equal(ts.free_inds, js.free_inds)


@pytest.mark.parametrize("name", sorted(SPACES))
def test_log_prior_matches_jax(name):
    jfn, _ = SPACES[name]
    js = JParamSpace(jfn())
    ts = ParamSpace.from_numpy({k: getattr(js, k) for k in ARRAY_FIELDS})
    rng = np.random.default_rng(1)
    lo = np.where(np.isfinite(js.lo), js.lo, -10.0)
    hi = np.where(np.isfinite(js.hi), js.hi, 10.0)
    span = hi - lo
    # mostly inside the bounds, some rows with a coordinate outside
    th = lo + span * rng.uniform(0.0, 1.0, (400, js.n_para)) * 0.5
    out = rng.uniform(size=400) < 0.2
    th[out, rng.integers(0, js.n_para, out.sum())] = hi.max() + 1.0
    th[:, js.fixed] = js.values[js.fixed]
    got = ts.log_prior(torch.as_tensor(th)).numpy()
    want = np.asarray(js.log_prior(jnp.asarray(th)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isneginf(got[~np.isfinite(want)]).all()
    assert (~np.isfinite(want)).sum() >= out.sum() * 0.9
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


def _analytic_moments(fam, a, b, lo, hi):
    if fam in ("normal",):
        return a, b
    if fam == "uniform":
        return (a + b) / 2, (b - a) / math.sqrt(12)
    if fam == "gamma":
        return a * b, math.sqrt(a) * b
    if fam == "beta":
        return a / (a + b), math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))
    if fam == "inverse_gamma":
        return b / (a - 1), b / ((a - 1) * math.sqrt(a - 2))
    if fam == "root_inverse_gamma":
        m = (math.sqrt(a * b * b / 2) * math.gamma((a - 1) / 2)
             / math.gamma(a / 2))
        return m, math.sqrt(a * b * b / (a - 2) - m * m)
    if fam == "truncated_normal":
        d = stats.truncnorm((lo - a) / b, (hi - a) / b, loc=a, scale=b)
        return d.mean(), d.std()
    raise ValueError(fam)


def test_sample_prior_moments():
    """Means within 5 Monte-Carlo standard errors of the analytic mean, and
    sds within 3% of the analytic sd (n = 200,000: the sd's own MC error is
    below 1% for these families)."""
    n = 200_000
    ts = ParamSpace(_all_families_torch())
    draws = ts.sample_prior(TorchDraws(11, "cpu"), n, device="cpu").numpy()
    assert draws.shape == (n, ts.n_para)
    for j, (fam, a, b) in enumerate(FAMILIES[1:]):
        m, s = _analytic_moments(fam, a, b, ts.lo[j], ts.hi[j])
        col = draws[:, j]
        assert abs(col.mean() - m) < 5 * col.std() / math.sqrt(n), fam
        assert abs(col.std() - s) < 0.03 * s, fam
        if fam == "truncated_normal":
            assert col.min() >= ts.lo[j] and col.max() <= ts.hi[j]
    np.testing.assert_array_equal(draws[:, -1], 0.7)


def test_package_imports_without_jax():
    """smc_tpu_torch and every submodule import with jax unavailable, and
    importing sets no global default dtype."""
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
import torch
import smc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(smc_tpu_torch.__path__,
                                              "smc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "smc_tpu_torch.ops.cuda_eigh" in names
assert "smc_tpu" not in sys.modules
assert torch.get_default_dtype() == torch.float32
print(len(names))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip()) >= 15
