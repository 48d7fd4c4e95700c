"""smc_tpu_torch's fused recursion on the CPU: `fused=True` (the recursion on
device buffers, read once per chunk; a CUDA graph replay per stage on a
card) against the host loop `fused=False`, bit for bit, in the seven cases
of tests/test_fused.py and under Metropolis resampling; the read count,
masked stages, a NaN ESS, the refusals, the Doeblin lengths against the
JAX package's, the chunk's stage lines against the JAX package's, and
device-select stages against the JAX stage body with its draws
replayed."""

import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu import diagnostics as jdiag
from smc_tpu.ops import resample as jr
from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.smc import make_stage_core as j_make_stage_core
from smc_tpu.models import linear as jlin

import smc_tpu_torch
from smc_tpu_torch import diagnostics as tdiag
from smc_tpu_torch.smc import (make_stage_core, make_recursion_step,
                               FusedRecursion, _initial_state,
                               _fuse_limit)
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.rng import ReplayDraws, TorchDraws
from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)
from smc_tpu_torch.models.linear import (linear_parameters,
                                         make_linear_loglike,
                                         generate_linear_data)

from torch_parity import StubMesh
from torch_replay import stage_replay

REPLAY_TOL = 1e-12


@pytest.fixture(scope="module")
def reg():
    y, x = generate_regression_data(n=100, seed=1793)
    return y, make_regression_loglike(x)


def _both(ll, params, data, **kw):
    kw = dict(device="cpu", **kw)
    host = smc_tpu_torch.smc(ll, params(), data, fused=False, **kw)
    fused = smc_tpu_torch.smc(ll, params(), data, fused=True, **kw)
    assert (host.fused, fused.fused) == (False, True)
    return host, fused


def _assert_runs_equal(a, b):
    """Bit for bit: the cloud, the schedule, the ESS, w and W, the
    resamples, the stage index, log-MDD and c."""
    for f in ("params", "loglh", "logprior", "weights", "accept"):
        assert torch.equal(getattr(a.cloud, f), getattr(b.cloud, f)), f
    assert a.cloud.tempering_schedule == b.cloud.tempering_schedule
    assert a.cloud.ESS == b.cloud.ESS
    if a.w is None:
        assert b.w is None and a.W is None and b.W is None
    else:
        np.testing.assert_array_equal(a.w, b.w)
        np.testing.assert_array_equal(a.W, b.W)
    assert a.cloud.resamples == b.cloud.resamples
    assert a.cloud.stage_index == b.cloud.stage_index
    assert a.log_mdd == b.log_mdd
    assert a.cloud.c == b.cloud.c
    assert a.cloud.accept_rate == b.cloud.accept_rate


def test_fused_matches_host_fixed_schedule(reg):
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=512, n_phi=50,
                        lam=2.0, alpha=0.9, seed=3, verbose="none")
    _assert_runs_equal(host, fused)
    assert fused.masked_stages == 0


def test_fused_matches_host_adaptive_schedule(reg):
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=512, n_phi=100,
                        lam=2.0, alpha=0.9, seed=4, verbose="none",
                        use_fixed_schedule=False, tempering_target=0.95)
    assert 2 < len(fused.cloud.tempering_schedule) < 100
    _assert_runs_equal(host, fused)


def test_fused_matches_host_blocked_multistep():
    data, X = generate_linear_data(seed=1793)
    host, fused = _both(make_linear_loglike(X), linear_parameters, data,
                        n_parts=512, n_phi=40, lam=2.0, alpha=0.9, n_blocks=3,
                        n_mh_steps=2, seed=5, verbose="none")
    _assert_runs_equal(host, fused)


def test_fused_chunk_stages_matches_host(reg):
    """Seven stages per chunk: 49 stages in 7 chunks, one read each and
    one at the end."""
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=512, n_phi=50,
                        lam=2.0, alpha=0.9, seed=3, verbose="none",
                        fused_chunk_stages=7)
    _assert_runs_equal(host, fused)
    assert fused.host_reads == 7 + 1
    assert host.host_reads == 49


def test_fused_matches_host_across_chunk_boundaries(reg):
    """An adaptive run longer than two 16-stage chunks."""
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=512, n_phi=16,
                        lam=2.0, alpha=0.9, seed=6, verbose="none",
                        use_fixed_schedule=False, tempering_target=0.97)
    n_stages = len(fused.cloud.tempering_schedule) - 1
    assert n_stages > 2 * 16
    _assert_runs_equal(host, fused)
    assert fused.host_reads == -(-n_stages // 16) + 1


@pytest.mark.parametrize("kwargs", [
    dict(), dict(use_fixed_schedule=False, tempering_target=0.95),
    dict(fused_chunk_stages=7)], ids=["fixed", "adaptive", "chunks"])
def test_fused_matches_host_under_metropolis(reg, kwargs):
    """Metropolis resampling, fixed and adaptive schedules and across
    chunks of 7: bit for bit, the same Doeblin lengths (one per resample
    stage), one read per stage in the host loop, one per chunk and one at
    the end fused."""
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=256, n_phi=30,
                        lam=2.0, alpha=0.9, seed=3, verbose="none",
                        resampling_method="metropolis", **kwargs)
    _assert_runs_equal(host, fused)
    n_stages = len(host.cloud.tempering_schedule) - 1
    assert fused.chain_lengths == host.chain_lengths
    assert len(host.chain_lengths) == host.cloud.resamples > 1
    assert host.host_reads == n_stages
    chunk = kwargs.get("fused_chunk_stages", 30)
    assert fused.host_reads == -(-n_stages // chunk) + 1


def test_chain_lengths_are_jax_doeblin_lengths(reg, monkeypatch):
    """SMCResult.chain_lengths holds, for each stage that resampled, JAX's
    metropolis_n_iter of the weights the stage's chain ran on, in both
    drivers."""
    smc_mod = sys.modules["smc_tpu_torch.smc"]
    real, seen = smc_mod.metropolis_adaptive, []

    def record(draws, weights, **kw):
        seen.append((weights.clone(), bool(kw["flag"])))
        return real(draws, weights, **kw)

    monkeypatch.setattr(smc_mod, "metropolis_adaptive", record)
    y, ll = reg
    for fused in (True, False):
        seen.clear()
        res = smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=256,
                                n_phi=30, lam=2.0, seed=8, verbose="none",
                                resampling_method="metropolis", fused=fused,
                                device="cpu")
        want = [jr.metropolis_n_iter(w.numpy()) for w, did in seen if did]
        assert res.chain_lengths == want
        assert len(want) == res.cloud.resamples > 1


@pytest.fixture(scope="module")
def gloo_group(tmp_path_factory):
    """A one-rank gloo process group of this process."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kwargs,match", [
    (dict(run_test=True, verbose="low"), "run_test"),
    (dict(verbose="high"), "verbose"),
    (dict(resampling_method="metropolis"), None),
    (dict(mesh="gloo"), None)])
def test_fused_auto_selection_and_validation(reg, gloo_group, kwargs, match):
    """fused=True where smc() cannot fuse raises ValueError; fused=None
    picks the host loop there. Under Metropolis resampling and on a CPU
    gloo mesh (a one-rank mesh over this process's gloo group) fused=None
    picks the fused driver, as the JAX package does, and fused=True
    raises nothing."""
    y, ll = reg
    if "mesh" in kwargs:
        kwargs = dict(mesh=StubMesh(1, gloo_group))
        assert _fuse_limit(kwargs["mesh"], TorchDraws(0, "cpu"),
                           torch.device("cpu")) is None
    run = lambda **kw: smc_tpu_torch.smc(
        ll, regression_parameters(), y, n_parts=64, n_phi=5, device="cpu",
        **kwargs, **kw)
    if match is None:
        assert run().fused and run(fused=True).fused
        return
    with pytest.raises(ValueError, match=match):
        run(fused=True)
    assert not run().fused


def test_fuse_limits(gloo_group):
    """Replayed draws can be fused on the CPU, not on a card; a gloo mesh
    on the CPU, not on a card; the automatic choice fuses a plain run."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _fuse_limit(None, ReplayDraws([]), cpu) is None
    assert "ReplayDraws" in _fuse_limit(None, ReplayDraws([]), cuda)
    assert _fuse_limit(None, TorchDraws(0, cpu), cuda) is None
    mesh = StubMesh(1, gloo_group)
    assert _fuse_limit(mesh, TorchDraws(0, cpu), cpu) is None
    assert "gloo particle mesh on a CUDA device" in _fuse_limit(
        mesh, TorchDraws(0, cpu), cuda)


def test_fused_no_weight_matrices(reg):
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=512, n_phi=50,
                        lam=2.0, seed=3, verbose="none",
                        store_weight_matrices=False)
    assert fused.w is None and fused.W is None
    assert np.isfinite(fused.log_mdd)
    _assert_runs_equal(host, fused)


def test_verbose_low_chunks_and_reads(reg, capsys):
    """At verbose "low" the first chunk is 3 stages and the others 25: 49
    stages make 3 chunk reads and the final read; a line per stage."""
    y, ll = reg
    host, fused = _both(ll, regression_parameters, y, n_parts=256, n_phi=50,
                        lam=2.0, seed=2, verbose="low")
    _assert_runs_equal(host, fused)
    assert fused.host_reads == 3 + 1
    out = capsys.readouterr().out
    assert sum(line.startswith("stage 50/50:") for line in out.splitlines()) \
        == 2


def _fused_on(state_overrides, n=32):
    """A fused recursion of the regression model on a prior cloud, its
    state changed by `state_overrides`."""
    y, x = generate_regression_data(n=20, seed=2)
    ll = make_regression_loglike(x)
    space = ParamSpace(regression_parameters())
    draws = TorchDraws(1, "cpu")
    params = space.sample_prior(draws, n, device="cpu")
    cloud = smc_tpu_torch.Cloud.create(space.n_para, n, device="cpu")
    cloud.params = params
    cloud.loglh = torch.func.vmap(lambda t: ll(t, y))(params)
    cloud.logprior = space.log_prior(params)
    cloud.ESS = [float(n)]
    cloud.accept_rate = 0.25
    stage = make_stage_core(space, torch.func.vmap(lambda t: ll(t, y)), 1, 1,
                            0.9, "systematic", 0.5 * n)
    sched = torch.as_tensor(fixed_schedule(10, 2.0))
    step = make_recursion_step(stage, sched, n, True, 0.97, 0.25)
    state = _initial_state(cloud, torch.device("cpu"), 0.5, 0.0, 1, 0.0,
                           False, 1)
    state.update(state_overrides)
    return FusedRecursion(step, draws, state, 4, n, True)


@pytest.mark.parametrize("overrides", [
    dict(phi=torch.tensor(1.0, dtype=torch.float64)),
    dict(nan_ess=torch.tensor(True))], ids=["phi_at_1", "nan_ess"])
def test_masked_stages_leave_every_buffer_as_it_was(overrides):
    rec = _fused_on(overrides)
    before = {k: v.clone() for k, v in rec.buffers.items()}
    traces = [t.clone() for t in (rec.scalars, rec.w, rec.W)]
    for _ in range(3):
        rec.run_stage()
    for k, v in rec.buffers.items():
        assert torch.equal(v, before[k]), k
    for t, t0 in zip((rec.scalars, rec.w, rec.W), traces):
        assert torch.equal(t, t0)


def test_nan_ess_sets_the_flag_and_masks_what_follows():
    """A cloud with a +inf log-likelihood makes the stage's ESS NaN: that
    stage writes its slot and sets nan_ess, and the stages after it leave
    every buffer as it was."""
    rec = _fused_on({})
    rec.buffers["loglh"][3] = float("inf")
    rec.run_stage()
    first = {k: v.clone() for k, v in rec.buffers.items()}
    rec.run_stage()
    rec.run_stage()
    n_in, traces, nan_ess, done = rec.read_chunk()
    assert (n_in, nan_ess, done) == (1, True, True)
    assert np.isnan(traces["ess"][0])
    for k, v in rec.buffers.items():
        torch.testing.assert_close(v, first[k], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("fused", [True, False])
def test_nan_ess_raises_at_the_next_read(reg, monkeypatch, fused):
    """An ESS that turns NaN at stage 6 (the correction patched on the
    device) raises check_nan_ess's AssertionError in both loops: the host
    loop at that stage's read, the fused recursion at its chunk's read."""
    smc_mod = sys.modules["smc_tpu_torch.smc"]
    correct = smc_mod.correct
    thr = float(fixed_schedule(20, 2.0)[5])

    def nan_from_stage_6(loglh, old, weights, phi_n, phi_n1, *args):
        inc_w, norm_w, ess, mdd_inc = correct(loglh, old, weights, phi_n,
                                              phi_n1, *args)
        return inc_w, norm_w, torch.where(phi_n >= thr, math.nan, ess), \
            mdd_inc

    monkeypatch.setattr(smc_mod, "correct", nan_from_stage_6)
    y, ll = reg
    with pytest.raises(AssertionError, match="No particles have non-zero"):
        smc_tpu_torch.smc(ll, regression_parameters(), y, n_parts=64,
                          n_phi=20, lam=2.0, seed=1, verbose="none",
                          device="cpu", fused=fused)


def test_an_active_stage_writes_its_slot():
    rec = _fused_on({})
    rec.run_stage()
    n_in, traces, nan_ess, done = rec.read_chunk()
    assert (n_in, nan_ess, done) == (1, False, False)
    assert traces["phi"][0] == fixed_schedule(10, 2.0)[1]
    assert int(rec.buffers["s"]) == 2
    assert rec.buffers["log_mdd"].item() == traces["mdd_inc"][0]


def test_chunk_stage_prints_match_jax(capsys):
    rng = np.random.default_rng(3)
    traces = {"phi": np.sort(rng.uniform(size=6)), "ess": rng.uniform(
        10, 500, 6), "c": rng.uniform(0.2, 0.6, 6), "accept": rng.uniform(
        size=6), "mdd_inc": rng.standard_normal(6),
        "resampled": np.array([0, 1, 0, 0, 1, 0], float)}
    for total in (40, None):
        kw = dict(n_in_chunk=5, first_stage=7, total_stages=total,
                  chunk_time=1.37, resamples_before=2, verbose="low")
        jdiag.chunk_stage_prints(traces, **kw)
        want = capsys.readouterr().out
        tdiag.chunk_stage_prints(traces, **kw)
        assert capsys.readouterr().out == want
        assert want.count("\n") == 5
    tdiag.chunk_stage_prints(traces, 5, 7, 40, 1.0, 0, verbose="none")
    assert capsys.readouterr().out == ""


def _jax_stage_and_port_stage(skew, resampled, method):
    """One stage of the linear fixture at N = 64 near its posterior through
    the JAX stage body and the port's with the JAX stage key's draws
    replayed: (JAX outputs, port outputs, replay draws)."""
    n = 64
    data, X = jlin.generate_linear_data(seed=1793)
    jspace = JParamSpace(jlin.linear_parameters())
    tspace = ParamSpace(linear_parameters())
    jll = jax.vmap(lambda t: jlin.make_linear_loglike(X)(t, data))
    tll = torch.func.vmap(lambda t: make_linear_loglike(X)(t, data))
    threshold = 0.5 * n
    jstage = j_make_stage_core(jspace, jll, 1, 1, 0.9, method, threshold)
    tstage = make_stage_core(tspace, tll, 1, 1, 0.9, method, threshold)
    rng = np.random.default_rng(4)
    true = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])
    th = true * (1.0 + 0.02 * rng.standard_normal((n, 9)))
    ll = np.asarray(jll(jnp.asarray(th)))
    lp = np.asarray(jspace.log_prior(jnp.asarray(th)))
    w = np.exp(skew * rng.standard_normal(n))
    state = (th, ll, lp, np.zeros(n), n * w / w.sum())
    sched = fixed_schedule(25, 2.0)
    phi_n1, phi_n = float(sched[11]), float(sched[12])
    skey = jax.random.PRNGKey(11)
    jout = jstage(skey, *(jnp.asarray(a) for a in state), phi_n, phi_n1, 0.3)
    assert bool(jout[9]) == resampled
    tstate = [torch.tensor(a) for a in state]
    draws = ReplayDraws(stage_replay(skey, tspace, tstate, phi_n, phi_n1,
                                     threshold, resampled, method=method))
    tout = tstage(draws, *tstate, phi_n, phi_n1, 0.3)
    return jout, tout, draws


def _assert_stage_matches_jax(jout, tout, draws, resampled):
    assert draws.remaining() == 0
    assert bool(tout[9]) == resampled and tout[9].dim() == 0
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    for i in (0, 1, 2, 4, 6, 7):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]),
                                   rtol=REPLAY_TOL, atol=REPLAY_TOL)
    for i in (8, 10, 11):
        np.testing.assert_allclose(tout[i].item(), float(jout[i]),
                                   rtol=REPLAY_TOL)
    assert float(tout[12]) == 0.0
    if not resampled:
        np.testing.assert_array_equal(tout[4].numpy(), tout[7].numpy())


@pytest.mark.parametrize("skew,resampled", [(2.5, True), (0.05, False)],
                         ids=["resampling", "not_resampling"])
def test_device_select_stage_matches_jax_stage_core(skew, resampled):
    """One stage of the linear fixture at N = 64 near its posterior, the
    JAX stage key's draws replayed (the resampling uniform recorded on
    both stages): the device select takes the resampled or the identity
    rows as the JAX lax.cond does."""
    _assert_stage_matches_jax(*_jax_stage_and_port_stage(
        skew, resampled, "systematic"), resampled)


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
def test_device_select_stage_matches_jax_for_each_resampler(method):
    """The same resampling stage under the other non-Metropolis resamplers
    (one uniform per particle, drawn on every stage): JAX's stage to
    1e-12."""
    _assert_stage_matches_jax(*_jax_stage_and_port_stage(2.5, True, method),
                              True)
