"""The SMC recursion: correction -> selection -> mutation over a tempering
schedule (port of smc_tpu/smc.py: the stage body and the host stage loop,
with the fixed or the adaptive schedule, tempered updates and bridge
distributions, checkpoints and resume).

The stage loop runs on the host. Each stage makes one explicit host read:
the ESS and the log-MDD increment, fetched together right after the
correction, which the host `if` on ESS < threshold needs. In adaptive mode
the stage's phi_n, j and phi_prop come from `solve_adaptive_phi` as device
scalars and are fetched in that same read. Everything else stays on the
device: the step size c is updated there from the previous stage's mean
acceptance, and the weight columns are fetched once, at the end. Reads that
are made only on some stages: a Metropolis resample reads its chain length;
verbose "low"/"high" read c and the acceptance for the stage line ("high"
also the parameter table); a checkpoint reads c, the acceptance and the w/W
columns. On a GPU, `torch.linalg.eigh` in the mutation also waits for the
device, to check its status.

Under a particle mesh (`mesh=`, parallel/mesh.py) each stage adds two
collectives: the all-gather of the cloud's rows before the correction and
the all-gather of the acceptance after the mutation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from smc_tpu_torch import diagnostics as diag
from smc_tpu_torch import io as smc_io
from smc_tpu_torch.cloud import (Cloud, ARRAY_FIELDS, weighted_mean,
                                 weighted_cov, weighted_std)
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.rng import TorchDraws, ParticleDraws
from smc_tpu_torch.ops.correction import correct
from smc_tpu_torch.ops.schedule import fixed_schedule, solve_adaptive_phi
from smc_tpu_torch.ops.resample import (resample as resample_indices,
                                        metropolis_chain_length,
                                        VALID_METHODS)
from smc_tpu_torch.ops.mutation import make_mutation_step
from smc_tpu_torch.ops.initialization import (initial_draw,
                                              initialize_likelihoods)


@dataclasses.dataclass
class SMCResult:
    """Estimation output: the final cloud, the incremental (w) and
    normalized (W) weight matrices [N, n_stages+1] as numpy, the log marginal
    data density, the redraw rounds of the initialization, the explicit
    host reads the stage loop made, the Doeblin length (before the cap) of
    each Metropolis resample, and under a particle mesh the collectives the
    run made and the bytes they brought this rank from the others."""

    cloud: Cloud
    w: Optional[np.ndarray]
    W: Optional[np.ndarray]
    log_mdd: float
    para_names: List[str]
    space: ParamSpace
    init_rounds: int = 0
    host_reads: int = 0
    chain_lengths: List[int] = dataclasses.field(default_factory=list)
    collectives: int = 0
    collective_bytes: int = 0

    def posterior_mean(self) -> np.ndarray:
        return weighted_mean(self.cloud).cpu().numpy()

    def posterior_std(self) -> np.ndarray:
        return weighted_std(self.cloud).cpu().numpy()


def marginal_data_density(w: np.ndarray, W: np.ndarray) -> float:
    """log-MDD from the saved weight matrices: sum_n log((1/N) sum_i
    W_{i,n-1} w~_{i,n}). `w` holds the raw incremental weights, which can
    underflow in extreme configurations; SMCResult.log_mdd is accumulated
    from the shift-invariant per-stage increments instead."""
    n = w.shape[0]
    out = 0.0
    for s in range(1, w.shape[1]):
        out += np.log(np.sum(W[:, s - 1] * w[:, s]) / n)
    return float(out)


def _logistic_c_update(c, accept: torch.Tensor, target: float):
    """Adaptive step size c <- c (0.95 + 0.10 sigmoid(16 (accept - target))),
    on the device: `accept` is the previous stage's mean acceptance."""
    return c * (0.95 + 0.10 * torch.sigmoid(16.0 * (accept - target)))


def make_stage_core(space, loglike_batched, n_blocks, n_mh_steps, alpha,
                    resampling_method, threshold,
                    tempered_update_prior_weight=0.0, log_prob_old_data=0.0,
                    old_loglike_batched=None, sharding=None):
    """The stage body:
      stage(draws, params, loglh, logprior, old_loglh, weights,
            phi_n, phi_n1, c, read_along=())
        -> (params, loglh, logprior, old_loglh, weights, accept,
            inc_w, W_col, ess, did_resample, accept_mean, mdd_inc, info)
    ess and mdd_inc are host floats (the stage's one host read) and
    did_resample a bool; `read_along` are f64 device scalars fetched in the
    same read, returned as the host list info["read"]. A Metropolis
    resample puts its Doeblin chain length (before the cap) in
    info["chain_length"]. Everything else stays on the device. A stage
    whose ESS is NaN returns after the correction (smc() raises).
    Draws, in order: the resampling draws only when the stage resamples,
    the block permutation, then the mutation's draws.

    Under a particle mesh (`sharding`) the stage takes the whole cloud (the
    rows every rank gathered) and returns this rank's rows of the particle
    arrays after mutating only those; inc_w, W_col and accept_mean stay
    global."""
    mutation_step = make_mutation_step(space, loglike_batched, n_blocks,
                                       n_mh_steps, alpha, old_loglike_batched)
    omega = tempered_update_prior_weight

    def stage(draws, params, loglh, logprior, old_loglh, weights,
              phi_n, phi_n1, c, read_along=()):
        inc_w, norm_w, ess, mdd_inc = correct(loglh, old_loglh, weights,
                                              phi_n, phi_n1, omega,
                                              log_prob_old_data)
        ess, mdd_inc, *read = torch.stack([ess, mdd_inc,
                                           *read_along]).tolist()
        info = {"read": read}
        n = loglh.shape[0]
        rows = slice(None) if sharding is None else sharding.rows(n)
        if math.isnan(ess):
            nan = torch.full((), float("nan"), dtype=torch.float64,
                             device=params.device)
            return (params[rows], loglh[rows], logprior[rows],
                    old_loglh[rows], norm_w[rows],
                    torch.zeros_like(loglh[rows]), inc_w, norm_w, ess, False,
                    nan, mdd_inc, info)
        did_resample = ess < threshold
        if did_resample:
            n_iter = None
            if resampling_method == "metropolis":
                n_iter, info["chain_length"] = metropolis_chain_length(norm_w)
            idx = resample_indices(draws, norm_w, method=resampling_method,
                                   n_iter=n_iter)
            params, loglh = params[idx], loglh[idx]
            logprior, old_loglh = logprior[idx], old_loglh[idx]
            weights = torch.ones_like(norm_w)
        else:
            weights = norm_w
        vals = params.index_select(1, space.tensors(params.device)["free_inds"])
        mu = weighted_mean(vals, weights)
        cov = weighted_cov(vals, weights)
        cov = 0.5 * (cov + cov.T)
        perm = draws.permutation(space.n_free)
        mdraws = draws if sharding is None else ParticleDraws(draws, rows, n)
        params, loglh, logprior, old_loglh, accept = mutation_step(
            mdraws, params[rows], loglh[rows], logprior[rows],
            old_loglh[rows], mu, cov, perm, c, phi_n, phi_n1)
        accept_all = accept if sharding is None else sharding.gather(accept)
        return (params, loglh, logprior, old_loglh, weights[rows], accept,
                inc_w, weights, ess, did_resample, torch.mean(accept_all),
                mdd_inc, info)

    return stage


def _on_device(cloud: Cloud, device) -> Cloud:
    """A copy of `cloud` with its arrays on `device` (the caller's cloud is
    left as it was)."""
    return dataclasses.replace(
        cloud, tempering_schedule=list(cloud.tempering_schedule),
        ESS=list(cloud.ESS),
        **{f: getattr(cloud, f).to(device) for f in ARRAY_FIELDS})


def smc(loglikelihood: Callable,
        parameters,
        data=None,
        *,
        verbose: str = "low",
        n_parts: int = 5_000,
        n_blocks: int = 1,
        n_mh_steps: int = 1,
        lam: float = 2.1,
        n_phi: int = 300,
        resampling_method: str = "systematic",
        threshold_ratio: float = 0.5,
        c: float = 0.5,
        alpha: float = 1.0,
        target: float = 0.25,
        use_fixed_schedule: bool = True,
        tempering_target: float = 0.97,
        old_data=None,
        old_cloud: Optional[Cloud] = None,
        old_loglikelihood: Optional[Callable] = None,
        tempered_update_prior_weight: float = 0.0,
        log_prob_old_data: float = 0.0,
        regime_switching: bool = False,
        run_test: bool = False,
        loadpath: str = "",
        savepath: Optional[str] = None,
        particle_store_path: Optional[str] = None,
        save_intermediate: bool = False,
        intermediate_stage_increment: int = 10,
        continue_intermediate: bool = False,
        store_weight_matrices: bool = True,
        batched: bool = False,
        fused: Optional[bool] = None,
        fused_chunk_stages: Optional[int] = None,
        seed: int = 0,
        key=None,
        mesh=None,
        run_csminwel: bool = False,
        debug_assertion: bool = False,
        profile_dir: Optional[str] = None,
        aot_cache_dir: Optional[str] = None,
        parallel: Optional[bool] = None,
        testing: bool = False,
        data_vintage: Optional[str] = None,
        old_vintage: str = "",
        smc_iteration: int = 1,
        filestring_addl=(),
        intermediate_stage_start: int = 0,
        device="cuda") -> SMCResult:
    """Estimate p(theta | data) by tempered SMC on `device`.

    The kwargs are the JAX package's `smc()`'s, with these differences:
      * `device` defaults to "cuda": the run is on the card unless the
        caller passes device="cpu". Without a card the first tensor it
        creates raises; nothing falls back to the CPU.
      * `loglikelihood(theta, data)` maps a tensor f64[P] to a scalar and
        is vmapped with torch.func.vmap; pass `batched=True` if it maps
        f64[N, P] to f64[N] (a DSGE model's `loglike_batched`). It must be
        total: -inf or nan on failure, never an exception, and free of
        Python branches on tensor values.
      * Draws come from one torch.Generator seeded with `seed` on `device`,
        or from `key`, a draws object (TorchDraws) on `device`. Two runs
        with the same seed on the same device are identical, and a resume
        from a checkpoint continues the generator bit for bit.
      * `continue_intermediate` resumes with the checkpoint's own phi_prop
        and infers whether the checkpoint's stage resampled from its ESS,
        so an adaptive-schedule resume is bit-identical too.
      * `old_cloud` is not modified; a tempered update works on a copy.
      * `profile_dir` writes a torch.profiler trace of the recursion
        (`smc_trace.json`).
      * `aot_cache_dir` has no effect: eager PyTorch has no compiled
        program to cache (the CUDA kernels' build is cached by _build).
      * `fused=True` (the whole recursion as one device program) raises
        NotImplementedError; `fused_chunk_stages` is accepted and unused.
      * `mesh` is a particle mesh (parallel.particle_mesh()) over the
        ranks of a torch.distributed process group, one process per rank,
        each running this call with the same arguments and seed on its own
        `device`. n_parts must be divisible by the number of ranks. Each
        rank holds and mutates N/R particle rows, so its likelihood calls
        (the kernels, on a card) see only those; every stage gathers the
        rows once, and every rank computes the stage's decisions from the
        same data with the one-device code. The result is the one-device
        run's up to what the likelihood's and the proposal's batch size
        changes in rounding, and the same on every rank: `cloud` and the
        w/W matrices are the whole cloud's, and `old_cloud` must be one
        too. Only rank 0 prints and writes files (checkpoints, `savepath`,
        `particle_store_path`, the profile); a resume loads the checkpoint
        on every rank. The collectives are
        counted in `SMCResult.collectives` and `collective_bytes`, apart
        from `host_reads`.
    Accepted for parity and unused: `parallel`, `data_vintage`,
    `old_vintage`, `smc_iteration`, `filestring_addl`,
    `intermediate_stage_start`. `testing=True` suppresses the final writes;
    `run_csminwel` warns that no mode polish runs."""
    del parallel, data_vintage, old_vintage, smc_iteration, filestring_addl
    del intermediate_stage_start, aot_cache_dir, fused_chunk_stages
    if fused:
        raise NotImplementedError(
            "fused=True (the whole recursion as one device program; its "
            "counterpart is a CUDA graph per stage) is not ported to "
            "smc_tpu_torch yet (ROADMAP.md, Queue A item 10)")
    if resampling_method not in VALID_METHODS:
        raise ValueError(f"resampling_method must be one of {VALID_METHODS}")
    if verbose not in diag.VERBOSITY:
        raise ValueError(f"verbose must be one of {tuple(diag.VERBOSITY)}")
    if not (0.0 <= tempered_update_prior_weight <= 1.0):
        raise ValueError(
            "The keyword tempered_update_prior_weight must be within [0, 1] "
            f"but is currently set to {tempered_update_prior_weight}")
    if run_csminwel:
        warnings.warn("run_csminwel is accepted for API parity but mode "
                      "polish is not implemented (matching the reference)")

    device = torch.device(device)
    sharding = None
    if mesh is not None:
        from smc_tpu_torch.parallel.mesh import particle_sharding
        sharding = particle_sharding(mesh)
        sharding.rows(n_parts)          # raises unless R divides n_parts
    root = sharding is None or sharding.rank == 0
    shown_verbose = verbose if root else "none"
    space = (parameters if isinstance(parameters, ParamSpace)
             else ParamSpace(parameters, regime_switching=regime_switching))
    if space.n_free == 0:
        raise ValueError("All model parameters are fixed!")

    def batch(fn, d):
        return (lambda th: fn(th, d)) if batched else \
            torch.func.vmap(lambda th: fn(th, d))

    loglike_batched = batch(loglikelihood, data)
    tempered_update = old_data is not None
    old_loglike_batched = None
    if tempered_update:
        old_loglike_batched = batch(old_loglikelihood or loglikelihood,
                                    old_data)

    draws = key if key is not None else TorchDraws(seed, device)
    threshold = threshold_ratio * n_parts
    sched = fixed_schedule(n_phi, lam)
    omega = tempered_update_prior_weight

    # ---- initialization: fresh, tempered update / bridge, or resume --------
    i = 1
    j = 1          # 0-based index of the next untried schedule entry
    phi_prop = 0.0
    log_mdd = 0.0
    resampled_last = False
    init_rounds = 0
    w_cols: List[torch.Tensor] = []
    W_cols: List[torch.Tensor] = []

    def shard(cloud):
        return cloud if sharding is None else sharding.shard(cloud)

    def whole(cloud):
        return cloud if sharding is None else sharding.gather_cloud(cloud)

    def reinit_scalars(cloud, tempered):
        cloud.ESS = [cloud.ESS[-1]] if tempered else [float(n_parts)]
        cloud.stage_index = 1
        cloud.n_phi = n_phi
        cloud.resamples = 0
        cloud.c = c
        cloud.accept_rate = target
        cloud.total_sampling_time = 0.0
        cloud.tempering_schedule = [0.0]
        return cloud

    if tempered_update:
        if old_cloud is None or old_cloud.is_empty():
            if not loadpath:
                raise ValueError("tempered update requires old_cloud or "
                                 "loadpath")
            old_cloud = smc_io.get_cloud(loadpath, device=device)
        cloud = _on_device(old_cloud, device)
        if omega == 0.0 and cloud.n_parts == n_parts:
            cloud = reinit_scalars(cloud, tempered=True)
            weights0 = cloud.weights
            cloud = initialize_likelihoods(shard(cloud), space,
                                           loglike_batched)
        else:
            # bridge: (1-omega) N resampled old-posterior draws and omega N
            # prior draws whose loglh is evaluated on the old data, then all
            # evaluated on the new data and resampled (one-time work, done
            # whole on every rank of a mesh)
            n_to_resample = int(round((1.0 - omega) * n_parts))
            n_from_prior = n_parts - n_to_resample
            parts = []
            if n_to_resample > 0:
                idx = resample_indices(draws, cloud.weights,
                                       method=resampling_method,
                                       n_parts=n_to_resample)
                parts.append(cloud.reindexed(idx))
            if n_from_prior > 0:
                prior_cloud, init_rounds = initial_draw(
                    draws, space, old_loglike_batched, n_from_prior,
                    device=device)
                parts.append(prior_cloud)
            cloud = Cloud.create(space.n_para, n_parts, device=device)
            for f in ("params", "loglh", "logprior", "old_loglh"):
                setattr(cloud, f, torch.cat([getattr(p, f) for p in parts]))
            cloud = initialize_likelihoods(cloud, space, loglike_batched)
            cloud.zero_bad_loglh_weights()
            norm_w = cloud.normalize_weights()
            cloud = cloud.reindexed(resample_indices(
                draws, norm_w, method=resampling_method))
            cloud.reset_weights()
            cloud.ESS.append(float(n_parts))
            cloud = reinit_scalars(cloud, tempered=True)
            weights0 = cloud.weights
            cloud = shard(cloud)
    elif continue_intermediate:
        if not loadpath:
            raise ValueError("continue_intermediate requires loadpath")
        (cloud, w_saved, W_saved, j, phi_prop, log_mdd,
         rng_state) = smc_io.load_checkpoint(loadpath, device=device)
        cloud = shard(cloud)
        draws.set_state(rng_state)
        as_cols = lambda m: [torch.as_tensor(m[:, k], device=device)
                             for k in range(m.shape[1])]
        w_cols, W_cols = as_cols(w_saved), as_cols(W_saved)
        i = cloud.stage_index
        c = cloud.c
        if use_fixed_schedule:
            cloud.tempering_schedule = list(sched[:i])
        resampled_last = cloud.ESS[-1] < threshold
    else:
        cloud, init_rounds = initial_draw(draws, space, loglike_batched,
                                          n_parts, device=device,
                                          sharding=sharding)
        cloud = reinit_scalars(cloud, tempered=False)

    cloud.n_phi = n_phi
    if use_fixed_schedule and not continue_intermediate:
        cloud.tempering_schedule = [float(sched[0])]
    if store_weight_matrices and not continue_intermediate:
        w_cols = [torch.zeros(n_parts, dtype=torch.float64, device=device)]
        W_cols = [weights0 if tempered_update else
                  torch.ones(n_parts, dtype=torch.float64, device=device)]

    stage = make_stage_core(space, loglike_batched, n_blocks, n_mh_steps,
                            alpha, resampling_method, threshold, omega,
                            log_prob_old_data, old_loglike_batched, sharding)
    para_names = list(space.names)

    def shown(cloud):
        """The cloud a stage print shows: the whole one (verbose="high"
        prints its moments; every rank gathers, rank 0 prints)."""
        return whole(cloud) if verbose == "high" else cloud

    diag.init_stage_print(shown(cloud), para_names, verbose=shown_verbose,
                          use_fixed_schedule=use_fixed_schedule)
    diag.vprint(shown_verbose, "low", "SMC recursion starts...")

    c_dev = torch.tensor(c, dtype=torch.float64, device=device)
    accept_rate = torch.tensor(cloud.accept_rate, dtype=torch.float64,
                               device=device)
    host_reads = 0
    chain_lengths: List[int] = []
    with contextlib.ExitStack() as profiling:
        if profile_dir:
            from torch.profiler import profile, ProfilerActivity
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profiling.enter_context(profile(activities=acts))
        phi_n = float(cloud.tempering_schedule[-1]) if continue_intermediate \
            else 0.0
        timer = diag.StageTimer()
        while phi_n < 1.0:
            i += 1
            cloud.stage_index = i
            phi_n1 = float(cloud.tempering_schedule[-1])
            state = (cloud.params, cloud.loglh, cloud.logprior,
                     cloud.old_loglh, cloud.weights)
            if sharding is not None:
                state = sharding.gather(*state)
            if use_fixed_schedule:
                phi_arg, read_along = float(sched[i - 1]), ()
            else:
                ess_bar = tempering_target * (
                    float(n_parts) if resampled_last else cloud.ESS[-1])
                phi_arg, j_dev, prop_dev = solve_adaptive_phi(
                    state[1], state[4], state[3], phi_n1, sched, j, phi_prop,
                    ess_bar)
                read_along = (phi_arg, j_dev.to(torch.float64), prop_dev)
            resampled_last = False
            c_dev = _logistic_c_update(c_dev, accept_rate, target)
            (cloud.params, cloud.loglh, cloud.logprior, cloud.old_loglh,
             cloud.weights, cloud.accept, inc_w, W_col, ess, did_resample,
             accept_rate, mdd_inc, info) = stage(
                draws, *state, phi_arg, phi_n1, c_dev, read_along)
            host_reads += 1
            if use_fixed_schedule:
                phi_n = phi_arg
            else:
                phi_n, j, phi_prop = info["read"]
                j = int(j)
            cloud.tempering_schedule.append(phi_n)
            cloud.ESS.append(ess)
            if math.isnan(ess):
                diag.check_nan_ess(whole(cloud), i, inc_w, W_col,
                                   savepath or "smc_cloud.npz",
                                   debug_assertion and root)
            if did_resample:
                cloud.resamples += 1
                resampled_last = True
                if "chain_length" in info:
                    chain_lengths.append(info["chain_length"])
                    host_reads += 1
            log_mdd += mdd_inc
            if store_weight_matrices:
                w_cols.append(inc_w)
                W_cols.append(W_col)
            dt = timer.lap()
            cloud.total_sampling_time += dt
            checkpoint = (save_intermediate and savepath
                          and i % intermediate_stage_increment == 0)
            if verbose != "none" or checkpoint:
                cloud.c, cloud.accept_rate = torch.stack(
                    [c_dev, accept_rate]).tolist()
                host_reads += 1
            diag.end_stage_print(shown(cloud), para_names,
                                 verbose=shown_verbose,
                                 use_fixed_schedule=use_fixed_schedule,
                                 stage_time=dt)
            if run_test and i == 3:
                break
            if checkpoint:
                saved = whole(cloud)
                if root:
                    smc_io.save_checkpoint(
                        savepath, i, saved, _stack(w_cols, n_parts),
                        _stack(W_cols, n_parts), j, phi_prop, log_mdd,
                        draws.get_state())
                    host_reads += 1
                if sharding is not None:
                    sharding.barrier()
        if profile_dir:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiling.close()
            if root:
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      "smc_trace.json"))

    cloud.c, cloud.accept_rate = torch.stack([c_dev, accept_rate]).tolist()
    cloud = whole(cloud)
    w_matrix = W_matrix = None
    if store_weight_matrices:
        w_matrix, W_matrix = _stack(w_cols, n_parts), _stack(W_cols, n_parts)
    writes = not testing and (savepath or particle_store_path)
    if writes and root:
        if savepath:
            extra = ({"w": w_matrix, "W": W_matrix} if store_weight_matrices
                     else {})
            extra["log_mdd"] = np.asarray(log_mdd)
            smc_io.save_cloud(savepath, cloud, extra=extra)
        if particle_store_path:
            smc_io.save_particle_store(particle_store_path, cloud)
    if writes and sharding is not None:
        sharding.barrier()
    return SMCResult(cloud=cloud, w=w_matrix, W=W_matrix, log_mdd=log_mdd,
                     para_names=para_names, space=space,
                     init_rounds=init_rounds, host_reads=host_reads,
                     chain_lengths=chain_lengths,
                     collectives=0 if sharding is None else
                     sharding.collectives,
                     collective_bytes=0 if sharding is None else
                     sharding.bytes)


def _stack(cols: List[torch.Tensor], n_parts: int) -> np.ndarray:
    """Weight columns as one host matrix [N, len(cols)]."""
    if not cols:
        return np.zeros((n_parts, 0))
    return torch.stack(cols, dim=1).cpu().numpy()
