"""smc_tpu_torch's public surface against the JAX package: the exported
names and smc()'s kwargs, run_test, seed reproducibility, the verbose="high"
stage print, NaN-ESS forensics, settings, the log-MDD formula, the cloud
helpers, and the single-particle mutation helpers under replayed draws
(within 1e-12). The package boundary (no jax) is held by
tests/test_torch_params.py."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import smc_tpu
from smc_tpu import diagnostics as jdiag
from smc_tpu import settings as jset
from smc_tpu import cloud as jcloud
from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.ops import mutation as jmut
from smc_tpu.models import linear as jl

import smc_tpu_torch
from smc_tpu_torch import diagnostics as tdiag
from smc_tpu_torch import settings as tset
from smc_tpu_torch import cloud as tcloud
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.ops import mutation as tmut
from smc_tpu_torch.rng import ReplayDraws, TorchDraws
from smc_tpu_torch.models.linear import (linear_parameters,
                                         make_linear_loglike,
                                         generate_linear_data)
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)

from torch_parity import StubMesh
from torch_replay import _eigh_signs, replay_mutation

TOL = 1e-12


def test_every_jax_export_is_here():
    assert set(smc_tpu.__all__) <= set(smc_tpu_torch.__all__)
    for name in smc_tpu_torch.__all__:
        assert getattr(smc_tpu_torch, name) is not None, name
    from smc_tpu import parallel as jparallel
    from smc_tpu_torch.parallel import mesh as tmesh
    assert jparallel.__all__ == smc_tpu_torch.parallel.__all__
    for name in smc_tpu_torch.parallel.__all__:
        assert callable(getattr(smc_tpu_torch.parallel, name)), name
    assert tmesh.PARTICLE_AXIS == jparallel.mesh.PARTICLE_AXIS


def test_smc_accepts_every_jax_kwarg():
    want = set(inspect.signature(smc_tpu.smc).parameters)
    got = set(inspect.signature(smc_tpu_torch.smc).parameters)
    assert want <= got, want - got
    assert inspect.signature(smc_tpu_torch.smc).parameters[
        "device"].default == "cuda"


@pytest.fixture(scope="module")
def regression():
    y, x = generate_regression_data(n=60, seed=17)
    return make_regression_loglike(x), y


def _run(regression, **kw):
    ll, y = regression
    kw = dict(dict(n_parts=400, n_phi=25, lam=2.0, alpha=0.9, verbose="none",
                   seed=3, device="cpu"), **kw)
    return smc_tpu_torch.smc(ll, regression_parameters(), y, **kw)


def test_run_test_stops_after_stage_3(regression):
    res = _run(regression, run_test=True)
    assert res.cloud.stage_index == 3
    assert len(res.cloud.tempering_schedule) == 3
    assert res.w.shape == (400, 3)


def test_same_seed_same_run(regression):
    """Adaptive schedule, Metropolis resampling and 2 blocks: the same seed
    (or the same seed through `key`) gives the same run bit for bit, another
    seed another run."""
    kw = dict(use_fixed_schedule=False, resampling_method="metropolis",
              n_blocks=2)
    a, b = _run(regression, **kw), _run(regression, **kw)
    k = _run(regression, key=TorchDraws(3, device="cpu"), **kw)
    for other in (b, k):
        assert torch.equal(a.cloud.params, other.cloud.params)
        assert a.log_mdd == other.log_mdd
        np.testing.assert_array_equal(a.W, other.W)
        assert a.cloud.tempering_schedule == other.cloud.tempering_schedule
    assert a.chain_lengths and a.chain_lengths == b.chain_lengths
    c = _run(regression, seed=4, **kw)
    assert not torch.equal(a.cloud.params, c.cloud.params)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(mesh=StubMesh(3)), ValueError, "divisible by the mesh size 3")])
def test_refused_kwargs_raise(regression, kwargs, error, match):
    with pytest.raises(error, match=match):
        _run(regression, **kwargs)


def test_fused_true_equals_fused_false(regression):
    """The surface's fused=True runs, and its result is the host loop's
    bit for bit."""
    a, b = _run(regression, fused=True), _run(regression, fused=False)
    assert a.fused and not b.fused
    assert torch.equal(a.cloud.params, b.cloud.params)
    assert a.log_mdd == b.log_mdd
    assert a.cloud.ESS == b.cloud.ESS


def test_accepted_kwargs_change_nothing(regression, tmp_path):
    """fused=False, aot_cache_dir and the parity-only kwargs are accepted
    and leave the run as it is; run_csminwel warns; profile_dir writes a
    trace."""
    base = _run(regression)
    with pytest.warns(UserWarning, match="run_csminwel"):
        res = _run(regression, fused=False, fused_chunk_stages=5,
                   aot_cache_dir=str(tmp_path / "aot"), parallel=True,
                   data_vintage="200101", old_vintage="191231",
                   smc_iteration=2, filestring_addl=["x=1"],
                   intermediate_stage_start=4, run_csminwel=True,
                   profile_dir=str(tmp_path / "prof"))
    assert torch.equal(base.cloud.params, res.cloud.params)
    assert base.log_mdd == res.log_mdd
    assert not (tmp_path / "aot").exists()
    assert (tmp_path / "prof" / "smc_trace.json").stat().st_size > 0


def _clouds(n=40, p=3, seed=0, **scalars):
    rng = np.random.default_rng(seed)
    f = dict(params=rng.standard_normal((n, p)) * np.resize([1.0, 10.0, 0.1],
                                                            p),
             loglh=rng.standard_normal(n), logprior=rng.standard_normal(n),
             old_loglh=np.zeros(n), accept=rng.uniform(size=n),
             weights=rng.uniform(0.2, 2.0, n))
    jc = jcloud.Cloud(**{k: jnp.asarray(v) for k, v in f.items()}, **scalars)
    tc = tcloud.Cloud.from_numpy(f, device="cpu")
    for k, v in scalars.items():
        setattr(tc, k, v)
    return jc, tc


def test_verbose_high_prints_what_jax_prints(capsys):
    state = dict(tempering_schedule=[0.0, 0.01, 0.0421], ESS=[40.0, 33.3,
                 21.7], stage_index=3, n_phi=50, resamples=2, c=0.3141,
                 accept_rate=0.2718, total_sampling_time=0.9)
    jc, tc = _clouds(**state)
    names = ["alpha", "beta", "sigma"]
    for fixed in (True, False):
        jdiag.end_stage_print(jc, names, verbose="high",
                              use_fixed_schedule=fixed, stage_time=0.4321)
        want = capsys.readouterr().out
        tdiag.end_stage_print(tc, names, verbose="high",
                              use_fixed_schedule=fixed, stage_time=0.4321)
        assert capsys.readouterr().out == want
        assert len(want.splitlines()) == 4


def test_verbose_levels_of_a_run(regression, capsys):
    _run(regression, n_phi=6, verbose="high")
    high = capsys.readouterr().out
    assert high.count("stage ") == 5 and high.count("mean = ") == 2 * 6
    _run(regression, n_phi=6, verbose="low")
    low = capsys.readouterr().out
    assert low.count("stage ") == 5 and "mean = " not in low
    _run(regression, n_phi=6, verbose="none")
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="verbose"):
        _run(regression, verbose="loud")


def test_check_nan_ess_writes_its_forensics(tmp_path):
    state = dict(ESS=[40.0, float("nan")], stage_index=2)
    jc, tc = _clouds(**state)
    inc = np.full(40, np.nan)
    inc[3] = np.inf
    norm = np.full(40, np.nan)
    msgs = []
    for mod, cloud, name in ((jdiag, jc, "jax.npz"), (tdiag, tc, "t.npz")):
        with pytest.raises(AssertionError) as err:
            mod.check_nan_ess(cloud, 2, inc, norm, str(tmp_path / name),
                              debug_assertion=True)
        msgs.append(str(err.value).replace(str(tmp_path / name[:-4]), "X"))
    assert msgs[0] == msgs[1]
    assert "infinite" in msgs[1] and "NaN" in msgs[1]
    with np.load(tmp_path / "t_debug_assertion.npz") as z, \
            np.load(tmp_path / "jax_debug_assertion.npz") as zj:
        assert set(z.files) == set(zj.files)
        for k in z.files:
            np.testing.assert_array_equal(z[k], zj[k])
    with pytest.raises(AssertionError):     # without the dump
        tdiag.check_nan_ess(tc, 2, inc, norm, str(tmp_path / "u.npz"))
    assert not (tmp_path / "u_debug_assertion.npz").exists()
    tc.ESS = [40.0, 12.0]
    tdiag.check_nan_ess(tc, 2, inc, norm)        # a finite ESS passes


def test_settings_match_jax():
    jm, tm = jset.GenericModel(), tset.GenericModel()
    assert tset.smc_settings_kwargs(tm) == jset.smc_settings_kwargs(jm) == {}
    for m, mod in ((jm, jset), (tm, tset)):
        m <= mod.Setting("n_particles", 1234)
        m <= mod.Setting("lambda", 2.5, True, "λ", "schedule exponent")
        m.set("use_fixed_schedule", False)
        m.set("not_an_smc_setting", 1)
    assert tset.smc_settings_kwargs(tm) == jset.smc_settings_kwargs(jm) == {
        "n_parts": 1234, "lam": 2.5, "use_fixed_schedule": False}
    assert (tset.rawpath(tm, "estimate", "smc_cloud.npz", ["x=1"])
            == jset.rawpath(jm, "estimate", "smc_cloud.npz", ["x=1"]))
    assert tset.dataroot(tm) == jset.dataroot(jm)
    assert tset.DATE_FORMAT == jset.DATE_FORMAT
    assert tm["lambda"] == 2.5 and tm.get("absent", 7) == 7
    tm <= linear_parameters()[0]
    assert isinstance(tm.param_space(), ParamSpace)


def test_marginal_data_density_matches_jax():
    rng = np.random.default_rng(5)
    w = np.exp(rng.standard_normal((300, 12)))
    W = rng.uniform(0.1, 2.0, (300, 12))
    assert smc_tpu_torch.marginal_data_density(w, W) == \
        smc_tpu.marginal_data_density(w, W)


def test_cloud_helpers_match_jax():
    jc, tc = _clouds(n=60, seed=2)
    np.testing.assert_array_equal(
        tcloud.weighted_quantile(tc, qs=(0.05, 0.5, 0.95)).numpy(),
        np.asarray(jcloud.weighted_quantile(jc, qs=(0.05, 0.5, 0.95))))
    np.testing.assert_array_equal(tc.likeliest_particle_value().numpy(),
                                  np.asarray(jc.likeliest_particle_value()))
    np.testing.assert_array_equal(
        tc.highest_posterior_particle_value().numpy(),
        np.asarray(jc.highest_posterior_particle_value()))
    for c in (jc, tc):
        c.zero_bad_loglh_weights()
        c.normalize_weights()
        c.update_acceptance_rate()
    np.testing.assert_allclose(tc.weights.numpy(), np.asarray(jc.weights),
                               rtol=TOL)
    assert abs(tc.accept_rate - jc.accept_rate) <= TOL
    pieces = tcloud.split_cloud(tc, 3)
    assert [p.n_parts for p in pieces] == [20, 20, 20]
    joined = tcloud.join_cloud(pieces)
    for k in tcloud.ARRAY_FIELDS:
        assert torch.equal(getattr(joined, k), getattr(tc, k))
    tc.update_draws(tc.params.T.numpy())         # (P, N) orientation
    np.testing.assert_array_equal(tc.get_vals().numpy(),
                                  np.asarray(jc.get_vals()))
    tc.update_mutation(4, [1.0, 2.0, 3.0], -1.0, -2.0, -3.0, 0.5)
    assert tc.params[4].tolist() == [1.0, 2.0, 3.0] and tc.loglh[4] == -1.0


def test_add_parameters_to_cloud():
    """Old draws kept in their columns, new columns from the prior, the
    logprior recomputed under the extended prior, the loop state reset."""
    old_space = ParamSpace(linear_parameters()[:6])
    new_space = ParamSpace(linear_parameters())
    _, tc = _clouds(n=50, p=6, seed=3)
    tc.params = old_space.sample_prior(TorchDraws(1, device="cpu"), 50,
                                       device="cpu")
    mask = np.array([True] * 6 + [False] * 3)
    out = smc_tpu_torch.add_parameters_to_cloud(
        tc, new_space, mask, TorchDraws(2, device="cpu"), device="cpu")
    assert torch.equal(out.params[:, :6], tc.params)
    assert torch.isfinite(out.logprior).all()
    torch.testing.assert_close(out.logprior, new_space.log_prior(out.params))
    assert torch.equal(out.loglh, tc.loglh)
    assert (out.stage_index, out.c, out.accept_rate) == (1, 0.0, 0.25)
    assert torch.equal(out.old_loglh, torch.zeros(50, dtype=torch.float64))
    with pytest.raises(ValueError, match="regime_switching"):
        smc_tpu_torch.add_parameters_to_cloud(
            tc, new_space, mask, TorchDraws(2, device="cpu"),
            regime_switching=True, device="cpu")


# --- the single-particle mutation helpers under replayed JAX draws --------

def _spd(k, seed):
    a = np.random.default_rng(seed).standard_normal((k, k))
    return 0.05 * (a @ a.T / k + np.eye(k))


def test_block_generators_match_jax():
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, 9))
    jb = jmut.generate_free_blocks(key, 9, 3)
    tb = tmut.generate_free_blocks(ReplayDraws([("permutation", perm)]), 9, 3)
    assert [b.tolist() for b in tb] == [np.asarray(b).tolist() for b in jb]
    free = np.array([0, 2, 3, 5, 6, 7, 8, 10, 11])
    assert ([b.tolist() for b in tmut.generate_all_blocks(tb, free)]
            == [np.asarray(b).tolist()
                for b in jmut.generate_all_blocks(jb, free)])
    jp = jmut.generate_param_blocks(key, 9, 3)
    tp = tmut.generate_param_blocks(ReplayDraws([("permutation", perm)]), 9,
                                    3)
    assert [b.tolist() for b in tp] == [np.asarray(b).tolist() for b in jp]
    assert tmut.generate_param_blocks(ReplayDraws([]), 4, 1)[0].tolist() == \
        [0, 1, 2, 3]


def test_mvnormal_mixture_draw_matches_jax():
    k, alpha, c = 4, 0.4, 0.7
    cov = _spd(k, 1)
    theta = np.array([0.5, -1.0, 2.0, 0.1])
    mean = np.array([0.4, -0.8, 1.9, 0.0])
    s = _eigh_signs(cov)
    comps = set()
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        kcomp, keps = jax.random.split(key)
        eps = np.asarray(jax.random.normal(keps, (k,), dtype=jnp.float64))
        comp = int(jax.random.choice(
            kcomp, 3, (), p=jnp.array([alpha, (1 - alpha) / 2,
                                       (1 - alpha) / 2])))
        comps.add(comp)
        draws = ReplayDraws([("normal", eps if comp == 1 else eps * s),
                             ("categorical", np.array([comp]))])
        got = tmut.mvnormal_mixture_draw(draws, theta, mean, cov, c, alpha)
        want = np.asarray(jmut.mvnormal_mixture_draw(key, theta, mean, cov, c,
                                                     alpha))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert comps == {0, 1, 2}


@pytest.mark.parametrize("near_zeros", [False, True])
def test_compute_proposal_densities_match_jax(near_zeros):
    cov = _spd(3, 2)
    if near_zeros:
        cov[1, 1] = -1e-9
    draw, cur = np.array([0.3, 0.2, -0.1]), np.array([0.25, 0.1, 0.0])
    mean = np.array([0.2, 0.15, -0.05])
    got = tmut.compute_proposal_densities(draw, cur, mean, cov, 0.9, 0.5,
                                          catch_near_zeros=near_zeros)
    want = jmut.compute_proposal_densities(draw, cur, mean, cov, 0.9, 0.5,
                                           catch_near_zeros=near_zeros)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=TOL)


def test_single_particle_mutation_matches_jax():
    """One particle of the linear fixture, 3 blocks, alpha = 0.9, with the
    old data's likelihood (bridging), over several keys."""
    data, X = generate_linear_data(seed=1793)
    half = data[:, :50]
    jspace = JParamSpace(jl.linear_parameters())
    tspace = ParamSpace(linear_parameters())
    jll, tll = jl.make_linear_loglike(X), make_linear_loglike(X)
    theta = np.array([1.0, 1.1, 0.9, 2.0, 2.1, 1.0, 3.0, 2.9, 1.1])
    cov = _spd(9, 3) * 0.1
    mean = theta + 0.01
    ll = float(jll(jnp.asarray(theta), data))
    lp = float(jspace.log_prior(jnp.asarray(theta)[None])[0])
    old = float(jll(jnp.asarray(theta), half))
    accepted = 0
    for i in range(6):
        key = jax.random.PRNGKey(40 + i)
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(i), 9))
        want = jmut.mutation(key, jspace, jll, data, jnp.asarray(theta), ll,
                             lp, old, jnp.asarray(mean), jnp.asarray(cov),
                             jnp.asarray(perm), 0.5, 0.9, 1, 3, 0.6, 0.5,
                             old_loglike=jll, old_data=half)
        draws = ReplayDraws(replay_mutation(key, 1, cov, perm, [3, 3, 3],
                                            0.9))
        got = tmut.mutation(draws, tspace, tll, data, theta, ll, lp, old,
                            mean, cov, perm, 0.5, 0.9, 1, 3, 0.6, 0.5,
                            old_loglike=tll, old_data=half)
        assert draws.remaining() == 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
        accepted += float(got[4]) > 0
    assert 0 < accepted


@pytest.mark.parametrize("name,means", [("xla", "plain"),
                                        ("pallas", "kernel"),
                                        ("plain", "plain"),
                                        ("kernel", "kernel")])
def test_an_schorfheide_takes_the_jax_backend_names(name, means):
    """The JAX package's likelihood_backend names are taken: "xla" is the
    plain path, "pallas" the kernels; both give the same likelihood on the
    CPU (where the kernels' plain versions run)."""
    from smc_tpu_torch.models import as_dsge as tas
    from torch_parity import as_prior_draws
    model = tas.an_schorfheide(likelihood_backend=name)
    assert model.likelihood_backend == means
    th = torch.as_tensor(as_prior_draws(8, seed=1))
    want = tas.an_schorfheide(likelihood_backend="plain").loglike_batched(
        th, tas.load_as_data())
    got = model.loglike_batched(th, tas.load_as_data())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="likelihood_backend"):
        tas.an_schorfheide(likelihood_backend="cuda")


def test_tempered_update_copies_each_data_array_once(monkeypatch):
    """A tempered update of a DSGE model alternates its likelihood between
    the new and the old data: each array is copied to the device once, not
    once per likelihood call."""
    from smc_tpu_torch.models import as_dsge as tas
    from smc_tpu_torch.models import dsge as tdsge
    data = tas.load_as_data()
    old_data = np.ascontiguousarray(data[:, :40])
    model = tas.an_schorfheide()
    copies = []
    as_tensor = torch.as_tensor

    def counting(x, *args, **kwargs):
        if x is data or x is old_data:
            copies.append(x is data)
        return as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(tdsge.torch, "as_tensor", counting)
    calls = []
    ll = lambda th, d: calls.append(d is data) or model.loglike_batched(th, d)
    kw = dict(batched=True, n_parts=64, n_phi=4, lam=2.0, alpha=0.9,
              verbose="none", device="cpu")
    old = smc_tpu_torch.smc(ll, tas.an_schorfheide_parameters(), old_data,
                            seed=1, **kw)
    smc_tpu_torch.smc(ll, tas.an_schorfheide_parameters(), data, seed=2,
                      old_data=old_data, old_cloud=old.cloud,
                      log_prob_old_data=old.log_mdd, **kw)
    assert sorted(copies) == [False, True]
    assert calls.count(True) >= 4 and calls.count(False) >= 4
