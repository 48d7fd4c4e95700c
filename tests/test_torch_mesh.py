"""smc_tpu_torch's particle mesh on the CPU: smc(..., mesh=particle_mesh())
on 2 and 4 gloo ranks (worker processes running tests/torch_mesh_worker.py
over a FileStore) against the one-process run, every rank bitwise equal to
the others, the fused recursion (smc()'s choice on CPU ranks) against the
host loop bit for bit, one stage with the JAX package's draws replayed
through the sharded draws on 2 ranks against the JAX stage, and the fused
recursion's stop rule under a mesh."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.params import ParamSpace as JParamSpace
from smc_tpu.smc import make_stage_core as j_make_stage_core
from smc_tpu.models import linear as jlin

from smc_tpu_torch.ops.schedule import fixed_schedule
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.models.linear import linear_parameters

import torch_mesh_worker as worker
from torch_replay import stage_replay

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-9           # the mesh against one process
REPLAY_TOL = 1e-12    # a replayed stage against the JAX package's
WORKER_TIMEOUT = 240  # seconds; each rank's process group times out at 120
CASES = {2: ["linear", "as_plain", "adaptive", "metropolis", "resume",
             "tempered0", "tempered05", "indivisible", "verbose_high",
             "replay", "linear_host", "adaptive_host", "metropolis_host"],
         4: ["linear", "as_plain"]}
CLOUD_FIELDS = ("params", "loglh", "weights", "accept", "mean", "w", "W",
                "schedule", "ESS")


def _replay_inputs(out):
    """One stage of the linear fixture near its posterior (a skewed cloud,
    so the stage resamples): the JAX stage's output, and the draws it made
    in the port's order, written to OUT/replay_in.npz for the workers."""
    n = 64
    data, X = jlin.generate_linear_data(seed=1793)
    jspace = JParamSpace(jlin.linear_parameters())
    tspace = ParamSpace(linear_parameters())
    jll = jax.vmap(lambda t: jlin.make_linear_loglike(X)(t, data))
    threshold = 0.5 * n
    jstage = j_make_stage_core(jspace, jll, 1, 1, 0.9, "systematic",
                               threshold)
    rng = np.random.default_rng(4)
    true = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 3.0, 3.0, 1.0])
    th = true * (1.0 + 0.02 * rng.standard_normal((n, 9)))
    ll = np.asarray(jll(jnp.asarray(th)))
    lp = np.asarray(jspace.log_prior(jnp.asarray(th)))
    w = np.exp(2.5 * rng.standard_normal(n))
    state = dict(params=th, loglh=ll, logprior=lp, old_loglh=np.zeros(n),
                 weights=n * w / w.sum())
    sched = fixed_schedule(25, 2.0)
    phi_n1, phi_n = float(sched[11]), float(sched[12])
    skey = jax.random.PRNGKey(11)
    jout = jstage(skey, *(jnp.asarray(state[k]) for k in
                          ("params", "loglh", "logprior", "old_loglh",
                           "weights")), phi_n, phi_n1, 0.3)
    tstate = [torch.tensor(state[k]) for k in ("params", "loglh", "logprior",
                                               "old_loglh", "weights")]
    entries = stage_replay(skey, tspace, tstate, phi_n, phi_n1, threshold,
                           bool(jout[9]))
    np.savez(os.path.join(out, "replay_in.npz"), threshold=threshold,
             phi_n=phi_n, phi_n1=phi_n1, c=0.3, **state,
             **{f"e{i:03d}_{k}": v for i, (k, v) in enumerate(entries)})
    return {k: np.asarray(jout[i]) for i, k in
            ((0, "params"), (1, "loglh"), (2, "logprior"), (4, "weights"),
             (5, "accept"), (8, "ess"), (9, "did_resample"),
             (11, "mdd_inc"))}


def _launch(world, cases, out):
    """Start the `world` ranks of one mesh as worker processes."""
    store = os.path.join(out, "store")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
         str(r), str(world), store, out, *cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _wait(procs):
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(logs):
        assert rc == 0, f"rank {rank} failed:\n{err[-4000:]}"
        assert f"rank {rank}: jax imported: False" in out, out
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh(es), and each case's one-process run."""
    root = tmp_path_factory.mktemp("mesh")
    for world in CASES:
        os.makedirs(root / f"r{world}")
    procs = [_launch(4, CASES[4], str(root / "r4"))]
    try:
        jax_stage = _replay_inputs(str(root / "r2"))
        procs.append(_launch(2, CASES[2], str(root / "r2")))
        ref_dir = root / "one"
        os.makedirs(ref_dir)
        ref = {name: worker.run_case(name, None, str(ref_dir))
               for name in CASES[2] if name not in ("indivisible", "replay")
               and not name.endswith("_host")}
    finally:
        for p in procs:
            _wait(p)
    ranks = {(world, name): [dict(np.load(root / f"r{world}" /
                                          f"{name}_r{r}.npz"))
                             for r in range(world)]
             for world, cases in CASES.items() for name in cases}
    return ref, ranks, jax_stage


def _ranks_equal(per_rank):
    for other in per_rank[1:]:
        assert per_rank[0].keys() == other.keys()
        for k in per_rank[0]:
            np.testing.assert_array_equal(per_rank[0][k], other[k], err_msg=k)


def _matches(ref, got, prefix=""):
    for k in CLOUD_FIELDS:
        np.testing.assert_allclose(got[prefix + k], ref[k], rtol=RTOL,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(got[prefix + "log_mdd"], ref["log_mdd"],
                               rtol=RTOL)
    assert int(got[prefix + "init_rounds"]) == ref["init_rounds"]
    np.testing.assert_array_equal(got[prefix + "chain_lengths"],
                                  ref["chain_lengths"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["linear", "as_plain"])
def test_mesh_matches_one_process(runs, name, world):
    """The linear fixture and AS (plain likelihood, T=12) on 2 and 4 ranks:
    the one-process run's cloud, weights, schedule and log-MDD at rtol
    1e-9; the ranks bitwise equal; each stage two collectives."""
    ref, ranks, _ = runs
    per_rank = ranks[(world, name)]
    _ranks_equal(per_rank)
    _matches(ref[name], per_rank[0])
    n_stages = len(ref[name]["schedule"]) - 1
    # the initial draw's gather, two per stage, the result's gather
    assert int(per_rank[0]["collectives"]) == 2 * n_stages + 2
    assert int(per_rank[0]["bytes"]) > 0


@pytest.mark.parametrize("name", ["adaptive", "metropolis", "tempered0",
                                  "tempered05"])
def test_paths_on_two_ranks(runs, name):
    """The adaptive schedule, Metropolis resampling (3 blocks) and the
    tempered update with prior weight 0 and 0.5 on 2 ranks against one
    process."""
    ref, ranks, _ = runs
    per_rank = ranks[(2, name)]
    _ranks_equal(per_rank)
    _matches(ref[name], per_rank[0])
    if name == "metropolis":
        assert len(ref[name]["chain_lengths"]) > 0


@pytest.mark.parametrize("name", ["linear", "adaptive", "metropolis"])
def test_fused_mesh_equals_host_loop_mesh(runs, name):
    """On 2 CPU ranks smc() picks the fused recursion; it equals the
    host-loop mesh (fused=False) bit for bit, each rank every other, and
    both the one-process run at rtol 1e-9. The fused ranks read once per
    chunk and once at the end, the host loop once per stage."""
    ref, ranks, _ = runs
    fused, host = ranks[(2, name)], ranks[(2, name + "_host")]
    _ranks_equal(fused)
    _ranks_equal(host)
    assert all(bool(r["fused"]) for r in fused)
    assert not any(bool(r["fused"]) for r in host)
    for k in CLOUD_FIELDS + ("log_mdd", "chain_lengths", "collectives",
                             "bytes", "init_rounds"):
        np.testing.assert_array_equal(fused[0][k], host[0][k], err_msg=k)
    _matches(ref[name], fused[0])
    _matches(ref[name], host[0])
    n_stages = len(ref[name]["schedule"]) - 1
    assert int(host[0]["host_reads"]) == n_stages
    chunk = worker.LINEAR["n_phi"]
    assert int(fused[0]["host_reads"]) == -(-n_stages // chunk) + 1


def test_resume_on_two_ranks_is_bitwise(runs):
    """A 2-rank run checkpointed by rank 0 and resumed from stage 10 on
    both ranks equals the uninterrupted 2-rank run bit for bit, and the
    one-process run at rtol 1e-9."""
    ref, ranks, _ = runs
    per_rank = ranks[(2, "resume")]
    _ranks_equal(per_rank)
    for k in CLOUD_FIELDS + ("log_mdd",):
        np.testing.assert_array_equal(per_rank[0]["resumed_" + k],
                                      per_rank[0][k], err_msg=k)
    _matches(ref["resume"], per_rank[0])


def test_only_rank_0_prints(runs):
    """verbose="high" on 2 ranks: rank 0 prints the one-process run's stage
    lines and the whole cloud's moments, rank 1 prints nothing."""
    ref, ranks, _ = runs
    r0, r1 = ranks[(2, "verbose_high")]
    assert str(r1["printed"]) == ""
    want, got = str(ref["verbose_high"]["printed"]), str(r0["printed"])
    strip = lambda s: [ln.split(" t=")[0] for ln in s.splitlines()]
    assert strip(got) == strip(want)
    assert got.count("stage ") == 3 and got.count("mean = ") == 9 * 4


def test_indivisible_n_parts_raises(runs):
    _, ranks, _ = runs
    for r in ranks[(2, "indivisible")]:
        assert "divisible" in str(r["error"])


def test_replayed_stage_matches_jax(runs):
    """One stage with the JAX package's draws replayed through each rank's
    share of the sharded draws: the ranks' rows together are the JAX
    stage's output to 1e-12."""
    _, ranks, want = runs
    per_rank = ranks[(2, "replay")]
    assert all(int(r["remaining"]) == 0 for r in per_rank)
    assert bool(want["did_resample"])
    for k in ("params", "loglh", "logprior", "weights", "accept"):
        got = np.concatenate([r[k] for r in per_rank])
        np.testing.assert_allclose(got, want[k], rtol=REPLAY_TOL,
                                   atol=REPLAY_TOL, err_msg=k)
    for r in per_rank:
        assert bool(r["did_resample"])
        np.testing.assert_allclose(r["ess"], want["ess"], rtol=REPLAY_TOL)
        np.testing.assert_allclose(r["mdd_inc"], want["mdd_inc"],
                                   rtol=REPLAY_TOL)
    np.testing.assert_array_equal(per_rank[0]["W_col"], per_rank[1]["W_col"])


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_initialize_multihost_defaults_to_the_card(monkeypatch, backend):
    """With no `device`, a rank's device is cuda:LOCAL_RANK (the rank where
    LOCAL_RANK is unset) under either backend; the CPU only when asked.
    The process group and the card are stood in for, so nothing is
    joined."""
    from smc_tpu_torch.parallel import mesh
    joined, current = [], []
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda **kw: joined.append(kw))
    monkeypatch.setattr(mesh.torch.cuda, "set_device", current.append)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    dev = mesh.initialize_multihost(num_processes=4, process_id=3,
                                    backend=backend, store=object())
    assert dev == torch.device("cuda", 3) and current == [dev]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.rank_device(3) == torch.device("cuda", 1)
    dev = mesh.initialize_multihost(num_processes=4, process_id=3,
                                    backend=backend, device="cpu",
                                    store=object())
    assert dev == torch.device("cpu") and len(current) == 1
    assert [kw["backend"] for kw in joined] == [backend, backend]


class _RandomEvent:
    """A stand-in for torch.cuda.Event whose query() answers at random."""

    def __init__(self, rng):
        self.rng = rng

    def record(self):
        pass

    def synchronize(self):
        pass

    def query(self):
        return bool(self.rng.integers(2))


def _replays(done_at, size, rng):
    """The stages a fused chunk issues when stage `done_at` (0-based) is the
    first whose done flag is set, under _DoneWatch's rule."""
    from smc_tpu_torch.smc import _DoneWatch
    watch = _DoneWatch(torch.device("cpu"), size,
                       event=lambda: _RandomEvent(rng))
    issued = 0
    while issued < size:
        issued += 1
        if watch.after_stage(torch.tensor(issued - 1 >= done_at)):
            break
    return issued


@pytest.mark.parametrize("done_at", [0, 3, 17, 30])
def test_mesh_stop_rule_ignores_event_timing(done_at):
    """The fused recursion's stop rule never polls: whatever its events
    answer, a chunk issues the same number of replays (so under a mesh
    every rank joins every collective), LOOKAHEAD past the first done
    stage or up to the chunk's end."""
    from smc_tpu_torch.smc import LOOKAHEAD
    size = 25
    counts = {_replays(done_at, size, np.random.default_rng(s))
              for s in range(40)}
    assert counts == {min(size, done_at + 1 + LOOKAHEAD)}
