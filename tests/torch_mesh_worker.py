"""One rank of a particle mesh on the CPU (gloo over a FileStore), for
tests/test_torch_mesh.py. Not a test module itself, and it imports no jax:

    python tests/torch_mesh_worker.py RANK WORLD STORE OUT CASE [CASE ...]

Each CASE runs smc_tpu_torch under `particle_mesh()` and writes this rank's
result to OUT/<case>_r<RANK>.npz. `run_case(name, None, out)` runs the same
case without a mesh in one process: the tests' reference. smc() picks the
fused recursion on these CPU ranks (eagerly, as on one CPU); a case named
<case>_host runs <case> with fused=False.
"""

import contextlib
import datetime
import io
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import smc_tpu_torch  # noqa: E402
from smc_tpu_torch import io as smc_io  # noqa: E402
from smc_tpu_torch.models import as_dsge  # noqa: E402
from smc_tpu_torch.models.linear import (linear_parameters,  # noqa: E402
                                         make_linear_loglike,
                                         generate_linear_data)

# the linear fixture at tests/test_sharding.py's configuration
LINEAR = dict(n_parts=64, n_phi=25, lam=2.0, verbose="none", seed=5,
              device="cpu")
# AS on the plain likelihood, tests/test_sharding.py's configuration (T=12)
AS_PLAIN = dict(n_parts=64, n_phi=8, lam=2.0, verbose="none", seed=3,
                batched=True, device="cpu")
PG_TIMEOUT = datetime.timedelta(seconds=120)


def _result(res) -> dict:
    c = res.cloud
    return dict(log_mdd=res.log_mdd, params=c.params.numpy(),
                loglh=c.loglh.numpy(), weights=c.weights.numpy(),
                accept=c.accept.numpy(), w=res.w, W=res.W,
                schedule=np.asarray(c.tempering_schedule),
                ESS=np.asarray(c.ESS), mean=res.posterior_mean(),
                init_rounds=res.init_rounds, chain_lengths=np.asarray(
                    res.chain_lengths, np.int64),
                collectives=res.collectives, bytes=res.collective_bytes,
                fused=res.fused)


def _linear(mesh, **kw):
    data, X = generate_linear_data(seed=1793)
    return smc_tpu_torch.smc(make_linear_loglike(X), linear_parameters(),
                             data, **dict(LINEAR, **kw), mesh=mesh)


def _as_plain(mesh):
    model = as_dsge.an_schorfheide("plain", mesh=mesh)
    return smc_tpu_torch.smc(model.loglike_batched,
                             as_dsge.an_schorfheide_parameters(),
                             as_dsge.load_as_data()[:, :12], **AS_PLAIN,
                             mesh=mesh)


def _resume(mesh, out):
    savepath = os.path.join(
        out, f"resume_{'one' if mesh is None else 'mesh'}.npz")
    full = _linear(mesh, savepath=savepath, save_intermediate=True,
                   intermediate_stage_increment=10)
    resumed = _linear(mesh, continue_intermediate=True,
                      loadpath=smc_io.intermediate_path(savepath, 10))
    return dict(_result(full), **{"resumed_" + k: v for k, v in
                                  _result(resumed).items()})


def _tempered(mesh, omega):
    data, X = generate_linear_data(seed=1793)
    ll, half = make_linear_loglike(X), data[:, :50]
    old = smc_tpu_torch.smc(ll, linear_parameters(), half, **LINEAR,
                            mesh=mesh)
    return _result(smc_tpu_torch.smc(
        ll, linear_parameters(), data, **dict(LINEAR, seed=1),
        old_data=half, old_cloud=old.cloud,
        tempered_update_prior_weight=omega, log_prob_old_data=old.log_mdd,
        mesh=mesh))


def _indivisible(mesh):
    try:
        _linear(mesh, n_parts=401, n_phi=10)
    except ValueError as e:
        return dict(error=str(e))
    return dict(error="")


def _verbose_high(mesh):
    """A short run at verbose="high": what this rank printed."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = _linear(mesh, n_phi=4, verbose="high")
    return dict(_result(res), printed=text.getvalue())


def _replay_stage(mesh, out):
    """One stage of make_stage_core on the cloud and the recorded JAX draws
    of OUT/replay_in.npz; this rank's rows of the result."""
    from smc_tpu_torch.parallel.mesh import particle_sharding
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import ReplayDraws
    from smc_tpu_torch.smc import make_stage_core
    z = dict(np.load(os.path.join(out, "replay_in.npz")))
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    sharding = particle_sharding(mesh)
    stage = make_stage_core(ParamSpace(linear_parameters()),
                            torch.func.vmap(lambda th: ll(th, data)), 1, 1,
                            0.9, "systematic", float(z["threshold"]),
                            sharding=sharding)
    state = [torch.as_tensor(z[k]) for k in ("params", "loglh", "logprior",
                                             "old_loglh", "weights")]
    rows = sharding.rows(state[0].shape[0])
    state = sharding.gather(*(x[rows] for x in state))
    entries = sorted(k for k in z if k.startswith("e"))
    draws = ReplayDraws([(k.split("_", 1)[1], z[k]) for k in entries])
    outs = stage(draws, *state, float(z["phi_n"]), float(z["phi_n1"]),
                 float(z["c"]))
    return dict(params=outs[0].numpy(), loglh=outs[1].numpy(),
                logprior=outs[2].numpy(), weights=outs[4].numpy(),
                accept=outs[5].numpy(), W_col=outs[7].numpy(), ess=outs[8],
                did_resample=outs[9], mdd_inc=outs[11],
                remaining=draws.remaining())


# the linear fixture's cases, and their smc() kwargs
LINEAR_CASES = {"linear": {}, "adaptive": dict(use_fixed_schedule=False),
                "metropolis": dict(resampling_method="metropolis",
                                   n_blocks=3)}


def run_case(name: str, mesh, out: str) -> dict:
    base, host = name.removesuffix("_host"), name.endswith("_host")
    if base in LINEAR_CASES:
        res = _linear(mesh, **LINEAR_CASES[base],
                      **(dict(fused=False) if host else {}))
        return dict(_result(res), host_reads=res.host_reads)
    if name == "as_plain":
        return _result(_as_plain(mesh))
    if name == "resume":
        return _resume(mesh, out)
    if name in ("tempered0", "tempered05"):
        return _tempered(mesh, 0.0 if name == "tempered0" else 0.5)
    if name == "indivisible":
        return _indivisible(mesh)
    if name == "verbose_high":
        return _verbose_high(mesh)
    if name == "replay":
        return _replay_stage(mesh, out)
    raise ValueError(f"unknown case {name!r}")


def main(argv) -> int:
    rank, world, store, out, *cases = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from smc_tpu_torch.parallel import initialize_multihost, particle_mesh
    initialize_multihost(num_processes=world, process_id=rank,
                         backend="gloo", device="cpu",
                         store=dist.FileStore(store, world),
                         timeout=PG_TIMEOUT)
    mesh = particle_mesh()
    for name in cases:
        np.savez(os.path.join(out, f"{name}_r{rank}.npz"),
                 **run_case(name, mesh, out))
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: jax imported: {'jax' in sys.modules}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
