"""The SMC recursion: correction -> selection -> mutation over a tempering
schedule (port of smc_tpu/smc.py: the stage body, the fused recursion and
the host stage loop, with the fixed or the adaptive schedule, tempered
updates and bridge distributions, checkpoints and resume).

One stage function serves both loops (`make_recursion_step`): it maps the
carried state, a dict of device tensors, to the next one. The resample
decision is a device select (the JAX package's `lax.cond`), the adaptive
schedule's solver runs on the device, the step size c is updated there, and
the proposal's eigendecomposition is ops/cuda_eigh.py's and a Metropolis
resample's chain is ops/cuda_metropolis.py's (its length computed on the
device), so a stage makes no host read and copies nothing from the host.

* The fused recursion (`FusedRecursion`, `fused=True`, the default where
  it applies) keeps the state in static device buffers and the per-stage
  traces in [chunk] buffers. On a card the first stage runs eagerly (the
  warm-up before a capture), the next is captured as one CUDA graph and each
  further stage is a replay; on the CPU the same body is called eagerly.
  The host reads once per chunk of stages and once at the end.
* The host loop (`fused=False`) calls the same stage function and reads its
  scalars once per stage (phi, ESS, the log-MDD increment, the resample
  flag, c, the acceptance, j, phi_prop and the Doeblin length, in one
  read), as the JAX package's host loop does.

Under a particle mesh (`mesh=`, parallel/mesh.py) each stage adds two
collectives: the all-gather of the cloud's rows before the correction and
the all-gather of the acceptance after the mutation. The fused recursion
captures them with the stage (NCCL); every rank issues the same number of
stages, because its stop rule waits on the done flag of a fixed stage and
never polls.

While a torch profiler records, the call opens the spans of tracing.py at
its layer boundaries (`smc.estimation`, `smc.init`, `smc.chunk`, ...); no
span opens around a graph replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from smc_tpu_torch import diagnostics as diag
from smc_tpu_torch import io as smc_io
from smc_tpu_torch.cloud import (Cloud, ARRAY_FIELDS, weighted_mean,
                                 weighted_cov, weighted_std)
from smc_tpu_torch.params import ParamSpace
from smc_tpu_torch.rng import TorchDraws, ParticleDraws, ReplayDraws
from smc_tpu_torch.tracing import span
from smc_tpu_torch.ops import cuda_eigh, kernels
from smc_tpu_torch.ops.correction import correct
from smc_tpu_torch.ops.schedule import fixed_schedule, solve_adaptive_phi
from smc_tpu_torch.ops.resample import (resample as resample_indices,
                                        metropolis_adaptive, warn_if_capped,
                                        N_ITER_MAX, VALID_METHODS)
from smc_tpu_torch.ops.mutation import block_sizes, make_mutation_step
from smc_tpu_torch.ops.initialization import (initial_draw,
                                              initialize_likelihoods)

_F64 = torch.float64

# replays a fused adaptive run keeps in flight past the last stage the host
# has seen unfinished: at most this many masked stages run per run
LOOKAHEAD = 4

# the carried state of the recursion (make_recursion_step), and the
# per-stage scalars a fused chunk traces, in the order of its [chunk, 7]
# trace buffer
STATE_KEYS = ("params", "loglh", "logprior", "old_loglh", "weights", "accept",
              "c", "accept_rate", "phi", "ess_prev", "j", "phi_prop",
              "resampled_last", "s", "log_mdd", "resamples", "nan_ess")
TRACE_KEYS = ("phi", "ess", "c", "accept", "mdd_inc", "resampled",
              "doeblin")


@dataclasses.dataclass
class SMCResult:
    """Estimation output: the final cloud, the incremental (w) and
    normalized (W) weight matrices [N, n_stages+1] as numpy, the log marginal
    data density, the redraw rounds of the initialization, which stage loop
    ran (`fused`), the blocking reads of stage scalars the stage loop made (one
    per stage in the host loop, whatever the resampler; one per chunk and
    one at the end when fused), the masked stages a fused adaptive run
    replayed past its end, the seconds a fused run spent capturing its
    CUDA graph, the Doeblin length (before the cap) of each Metropolis
    resample, and under a particle mesh the collectives the run made and
    the bytes they brought this rank from the others."""

    cloud: Cloud
    w: Optional[np.ndarray]
    W: Optional[np.ndarray]
    log_mdd: float
    para_names: List[str]
    space: ParamSpace
    init_rounds: int = 0
    fused: bool = False
    host_reads: int = 0
    masked_stages: int = 0
    capture_seconds: float = 0.0
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
            phi_n, phi_n1, c)
        -> (params, loglh, logprior, old_loglh, weights, accept,
            inc_w, W_col, ess, did_resample, accept_mean, mdd_inc, doeblin)
    ess, did_resample, accept_mean, mdd_inc and doeblin are device scalars.
    The resample decision ESS < threshold is a device select, as the JAX
    package's `lax.cond`: the resampling indices are computed on every
    stage and the gather takes them where the stage resamples, the identity
    elsewhere; a Metropolis chain reads the decision on the device and runs
    no step where it is false. doeblin is a Metropolis resample's Doeblin
    length (before the cap; 0 on a stage that does not resample, and for
    the other resamplers). A stage whose ESS is NaN runs through on NaN
    weights (the caller raises at its next read).
    Draws, in order: the resampling draws (on every stage: for Metropolis
    the chain's key), the block permutation, then the mutation's draws.

    Under a particle mesh (`sharding`) the stage takes the whole cloud (the
    rows every rank gathered) and returns this rank's rows of the particle
    arrays after mutating only those; inc_w, W_col and accept_mean stay
    global."""
    mutation_step = make_mutation_step(space, loglike_batched, n_blocks,
                                       n_mh_steps, alpha, old_loglike_batched)
    omega = tempered_update_prior_weight

    def stage(draws, params, loglh, logprior, old_loglh, weights,
              phi_n, phi_n1, c):
        with span("smc.correction"):
            inc_w, norm_w, ess, mdd_inc = correct(loglh, old_loglh, weights,
                                                  phi_n, phi_n1, omega,
                                                  log_prob_old_data)
        n = loglh.shape[0]
        dev = params.device
        rows = slice(None) if sharding is None else sharding.rows(n)
        with span("smc.selection"):
            do_resample = ess < threshold
            if resampling_method == "metropolis":
                idx, doeblin = metropolis_adaptive(draws, norm_w,
                                                   flag=do_resample)
            else:
                idx = torch.where(do_resample,
                                  resample_indices(draws, norm_w,
                                                   method=resampling_method),
                                  torch.arange(n, device=dev))
                doeblin = torch.zeros_like(ess)
            params = params.index_select(0, idx)
            loglh = loglh.index_select(0, idx)
            logprior = logprior.index_select(0, idx)
            old_loglh = old_loglh.index_select(0, idx)
            weights = torch.where(do_resample, 1.0, norm_w)
        with span("smc.mutation"):
            vals = params.index_select(1, space.tensors(dev)["free_inds"])
            mu = weighted_mean(vals, weights)
            cov = weighted_cov(vals, weights)
            cov = 0.5 * (cov + cov.T)
            perm = draws.permutation(space.n_free)
            mdraws = (draws if sharding is None
                      else ParticleDraws(draws, rows, n))
            params, loglh, logprior, old_loglh, accept = mutation_step(
                mdraws, params[rows], loglh[rows], logprior[rows],
                old_loglh[rows], mu, cov, perm, c, phi_n, phi_n1)
            accept_all = (accept if sharding is None
                          else sharding.gather(accept))
        return (params, loglh, logprior, old_loglh, weights[rows], accept,
                inc_w, weights, ess, do_resample, torch.mean(accept_all),
                mdd_inc, doeblin)

    return stage


def make_recursion_step(stage, sched_dev, n_parts, use_fixed_schedule,
                        tempering_target, target, sharding=None):
    """One stage of the recursion on the carried state:
      step(draws, st) -> (st', extras)
    st holds STATE_KEYS as device tensors (the particle arrays are this
    rank's rows under a mesh); extras holds the stage's inc_w, W_col,
    mdd_inc and doeblin. phi_n is the fixed schedule's entry s or
    the adaptive solver's root, c is updated from the last acceptance, and
    the stage body runs; everything stays on the device."""
    n_phi = sched_dev.shape[0]
    last = torch.tensor(n_phi - 1, device=sched_dev.device)

    def step(draws, st):
        arrays = (st["params"], st["loglh"], st["logprior"], st["old_loglh"],
                  st["weights"])
        if sharding is not None:
            arrays = sharding.gather(*arrays)
        phi_n1 = st["phi"]
        if use_fixed_schedule:
            entry = torch.minimum(st["s"], last).reshape(1)
            phi_n = sched_dev.index_select(0, entry)[0]
            j, phi_prop = st["j"], st["phi_prop"]
        else:
            ess_bar = tempering_target * torch.where(
                st["resampled_last"], float(n_parts), st["ess_prev"])
            phi_n, j, phi_prop = solve_adaptive_phi(
                arrays[1], arrays[4], arrays[3], phi_n1, sched_dev, st["j"],
                st["phi_prop"], ess_bar)
        c = _logistic_c_update(st["c"], st["accept_rate"], target)
        (params, loglh, logprior, old_loglh, weights, accept, inc_w, W_col,
         ess, did, accept_mean, mdd_inc, doeblin) = stage(
            draws, *arrays, phi_n, phi_n1, c)
        new = dict(params=params, loglh=loglh, logprior=logprior,
                   old_loglh=old_loglh, weights=weights, accept=accept, c=c,
                   accept_rate=accept_mean, phi=phi_n, ess_prev=ess, j=j,
                   phi_prop=phi_prop, resampled_last=did, s=st["s"] + 1,
                   log_mdd=st["log_mdd"] + mdd_inc,
                   resamples=st["resamples"] + did.to(torch.int64),
                   nan_ess=torch.isnan(ess))
        return new, dict(inc_w=inc_w, W_col=W_col, mdd_inc=mdd_inc,
                         doeblin=doeblin)

    return step


def _initial_state(cloud, device, c, phi, j, phi_prop, resampled_last,
                   stage, log_mdd=0.0):
    """The carried state at the start of the recursion, on `device`."""
    f64 = lambda x: torch.tensor(float(x), dtype=_F64, device=device)
    i64 = lambda x: torch.tensor(int(x), dtype=torch.int64, device=device)
    b = lambda x: torch.tensor(bool(x), device=device)
    return dict(params=cloud.params, loglh=cloud.loglh,
                logprior=cloud.logprior, old_loglh=cloud.old_loglh,
                weights=cloud.weights, accept=cloud.accept, c=f64(c),
                accept_rate=f64(cloud.accept_rate), phi=f64(phi),
                ess_prev=f64(cloud.ESS[-1]), j=i64(j), phi_prop=f64(phi_prop),
                resampled_last=b(resampled_last), s=i64(stage),
                log_mdd=f64(log_mdd), resamples=i64(0), nan_ess=b(False))


def _add_counts(counters, counts, times=1):
    """Add `times` x counts to counters (dicts, entry by entry)."""
    for d, c in zip(counters, counts):
        for k, v in c.items():
            d[k] += times * v


class FusedRecursion:
    """The recursion on static device buffers, the counterpart of the JAX
    package's `make_fused_recursion` (its `lax.while_loop` over stages).

    `buffers` hold STATE_KEYS plus the chunk's slot index `k` and the
    `done` flag (phi has reached 1 or an ESS was NaN); `scalars` [chunk, 7]
    and, with `store_weight_matrices`, `w` and `W` [chunk, N] hold the
    traces. `run_stage()` runs one stage: the body masks it, so a stage
    after `done` leaves every buffer bit for bit as it was, and a stage
    writes its traces at slot k and advances k. On a card the first call
    runs the body eagerly, the second captures it as a CUDA graph (the
    run's generator registered with it, so each replay advances the
    generator as an eager stage does) and then replays it; every later call
    replays. The kernels' launch registry (ops/kernels.py LAUNCHES), and
    `counters` (a mesh's collective counts), count what the graph issues
    once per replay and nothing for the capture. The capture is in
    "thread_local" mode: under a mesh the NCCL process group's watchdog
    thread may query the events of earlier collectives while the capture
    runs, and "global" mode would hold such a call, from any thread,
    against the capture. On the CPU every call runs the body eagerly."""

    def __init__(self, step, draws, state, chunk: int, n_parts: int,
                 store_weight_matrices: bool, counters=()):
        dev = state["params"].device
        self.counters = [kernels.LAUNCHES, *counters]
        self.step, self.draws, self.device = step, draws, dev
        self.buffers = {k: v.clone() for k, v in state.items()}
        self.buffers["k"] = torch.zeros((), dtype=torch.int64, device=dev)
        self.buffers["done"] = ~((state["phi"] < 1.0) & ~state["nan_ess"])
        self.scalars = torch.zeros((chunk, len(TRACE_KEYS)), dtype=_F64,
                                   device=dev)
        self.w = self.W = None
        if store_weight_matrices:
            self.w = torch.zeros((chunk, n_parts), dtype=_F64, device=dev)
            self.W = torch.zeros((chunk, n_parts), dtype=_F64, device=dev)
        self.graph = None
        self.calls = 0
        self.capture_seconds = 0.0
        self._per_replay = []

    def body(self):
        b = self.buffers
        st = {k: b[k] for k in STATE_KEYS}
        active = (st["phi"] < 1.0) & ~st["nan_ess"]
        new, ex = self.step(self.draws, st)
        for key in STATE_KEYS:
            b[key].copy_(torch.where(active, new[key], b[key]))
        slot = b["k"].reshape(1)
        row = torch.stack([new["phi"], new["ess_prev"], new["c"],
                           new["accept_rate"], ex["mdd_inc"],
                           new["resampled_last"].to(_F64), ex["doeblin"]])
        self._write(self.scalars, slot, row, active)
        if self.w is not None:
            self._write(self.w, slot, ex["inc_w"], active)
            self._write(self.W, slot, ex["W_col"], active)
        b["k"].add_(active.to(torch.int64))
        b["done"].copy_(~((b["phi"] < 1.0) & ~b["nan_ess"]))

    @staticmethod
    def _write(trace, slot, row, active):
        old = trace.index_select(0, slot)[0]
        trace.index_copy_(0, slot, torch.where(active, row, old)[None])

    def run_stage(self):
        self.calls += 1
        if self.device.type != "cuda" or self.calls == 1:
            with span("smc.stage"):
                self.body()
            return
        if self.graph is None:
            with span("smc.capture"):
                self._capture()
        self.graph.replay()
        _add_counts(self.counters, self._per_replay)

    def _capture(self):
        """Capture the body on the current stream (a capture that fails
        raises; nothing reruns the stage eagerly)."""
        t0 = time.perf_counter()
        before = [dict(d) for d in self.counters]
        graph = torch.cuda.CUDAGraph()
        gen = getattr(self.draws, "generator", None)
        if gen is not None:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph,
                              stream=torch.cuda.current_stream(self.device),
                              capture_error_mode="thread_local"):
            self.body()
        self._per_replay = [{k: v - b[k] for k, v in d.items()}
                            for d, b in zip(self.counters, before)]
        _add_counts(self.counters, self._per_replay, times=-1)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def read_chunk(self):
        """The chunk's traces and the state's flags in one blocking read:
        (n_in_chunk, traces {TRACE_KEYS: list}, nan_ess, done)."""
        b = self.buffers
        with span("smc.read"):
            flat = torch.cat([self.scalars.flatten(),
                              torch.stack([b["k"].to(_F64),
                                           b["nan_ess"].to(_F64),
                                           b["done"].to(_F64)])]).tolist()
        n_in, nan_ess, done = flat[-3:]
        rows = np.asarray(flat[:-3]).reshape(self.scalars.shape)[:int(n_in)]
        traces = {k: rows[:, i] for i, k in enumerate(TRACE_KEYS)}
        return int(n_in), traces, bool(nan_ess), bool(done)


class _DoneWatch:
    """Which replays of an adaptive fused chunk the host has seen end
    unfinished. After each stage a non-blocking copy of the `done` flag
    goes to pinned host memory and an event is recorded; once `lookahead`
    stages are in flight the host waits on the event of stage
    issued - lookahead and reads its flag, and reads no other, so the card
    always has work queued and exactly `lookahead` stages run past the end
    (fewer where the chunk ends first). When the host learns that the run
    is done depends on the flags alone, never on the events' timing; under
    a mesh the flags are the same on every rank, so every rank issues the
    same number of replays (one more on a rank would wait in a collective
    the others never join). On the CPU the flag is known at once. `event`
    makes the events (torch.cuda.Event; tests pass a stand-in)."""

    def __init__(self, device, size: int, lookahead: int = LOOKAHEAD,
                 event=None):
        self.sync = device.type == "cuda" or event is not None
        self.lookahead = lookahead
        self.event = event or torch.cuda.Event
        self.flags = torch.zeros(size, dtype=torch.bool)
        if device.type == "cuda":
            self.flags = self.flags.pin_memory()
        self.events = []
        self.seen = 0            # stages known to have ended unfinished
        self.done = False

    def after_stage(self, done_dev: torch.Tensor) -> bool:
        """Record stage len(events); True once the host knows the run is
        done (then issue no further stage)."""
        if not self.sync:
            self.done = bool(done_dev)
            return self.done
        r = len(self.events)
        self.flags[r].copy_(done_dev, non_blocking=True)
        ev = self.event()
        ev.record()
        self.events.append(ev)
        if len(self.events) - self.seen > self.lookahead:
            self.events[self.seen].synchronize()
            self.done = bool(self.flags[self.seen])
            self.seen += 1
        return self.done


def _on_device(cloud: Cloud, device) -> Cloud:
    """A copy of `cloud` with its arrays on `device` (the caller's cloud is
    left as it was)."""
    return dataclasses.replace(
        cloud, tempering_schedule=list(cloud.tempering_schedule),
        ESS=list(cloud.ESS),
        **{f: getattr(cloud, f).to(device) for f in ARRAY_FIELDS})


def _fuse_limit(mesh, draws, device) -> Optional[str]:
    """Why the port cannot fuse this run, or None: what a CUDA graph cannot
    capture."""
    if isinstance(draws, ReplayDraws) and device.type == "cuda":
        return ("ReplayDraws on a CUDA device (recorded host arrays cannot "
                "be captured in a CUDA graph)")
    if mesh is not None and device.type == "cuda":
        from smc_tpu_torch.parallel.mesh import mesh_backend
        if mesh_backend(mesh) == "gloo":
            return ("a gloo particle mesh on a CUDA device (gloo carries "
                    "CUDA tensors through host memory, which a CUDA graph "
                    "cannot capture; use NCCL, one card per rank)")
    return None


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device, root: bool):
    """With `profile_dir`, a torch.profiler trace of the block (CPU
    activity, and CUDA activity on a card), written by rank 0 to
    profile_dir/smc_trace.json once the block has ended and the card has
    finished its work; nothing without it."""
    if not profile_dir:
        yield
        return
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if root:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "smc_trace.json"))


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
        creates raises; nothing falls back to the CPU. On a card a
        mutation block holds at most cuda_eigh.MAX_K (1,024) free
        parameters, the eigh kernel's limit; a larger one raises
        ValueError before anything is drawn.
      * `loglikelihood(theta, data)` maps a tensor f64[P] to a scalar and
        is vmapped with torch.func.vmap; pass `batched=True` if it maps
        f64[N, P] to f64[N] (a DSGE model's `loglike_batched`). It must be
        total: -inf or nan on failure, never an exception, and free of
        Python branches on tensor values and of host reads (a fused run
        captures it in a CUDA graph).
      * Draws come from one torch.Generator seeded with `seed` on `device`,
        or from `key`, a draws object (TorchDraws) on `device`. Two runs
        with the same seed on the same device are identical, whichever
        loop runs them, and a resume from a checkpoint continues the
        generator bit for bit.
      * `fused` picks the stage loop as the JAX package does: fused (the
        recursion on device buffers, each stage a replay of one captured
        CUDA graph on a card, one host read per chunk of stages) unless
        run_test, save_intermediate or continue_intermediate is set or
        verbose is "high"; fused=None chooses by that rule, fused=False
        takes the host loop. The port also runs the host loop, and
        fused=True raises ValueError, where a CUDA graph cannot capture the
        stage: a ReplayDraws `key` on a CUDA device, and a gloo `mesh` on
        a CUDA device. A chunk is n_phi stages,
        `fused_chunk_stages` when given, 25 at verbose "low" (the first 3).
        Both loops give the same bits. `SMCResult.fused` says which ran.
      * `continue_intermediate` resumes with the checkpoint's own phi_prop
        and infers whether the checkpoint's stage resampled from its ESS,
        so an adaptive-schedule resume is bit-identical too.
      * `old_cloud` is not modified; a tempered update works on a copy.
      * `profile_dir` writes a torch.profiler trace of the whole call,
        initialization and final reads included (`smc_trace.json`), with
        the spans of tracing.py (`smc.estimation`, `smc.init`, ...). The
        spans are recorded exactly while a torch profiler records, this
        one or the caller's.
      * `aot_cache_dir` has no effect: eager PyTorch has no compiled
        program to cache (the CUDA kernels' build is cached by _build).
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
        from `host_reads`. An NCCL mesh runs the fused recursion with its
        collectives in the graph (every rank issues the same stages); a
        gloo mesh runs it eagerly on CPU ranks and takes the host loop on
        cards.
    Accepted for parity and unused: `parallel`, `data_vintage`,
    `old_vintage`, `smc_iteration`, `filestring_addl`,
    `intermediate_stage_start`. `testing=True` suppresses the final writes;
    `run_csminwel` warns that no mode polish runs."""
    del parallel, data_vintage, old_vintage, smc_iteration, filestring_addl
    del intermediate_stage_start, aot_cache_dir
    if resampling_method not in VALID_METHODS:
        raise ValueError(f"resampling_method must be one of {VALID_METHODS}")
    if verbose not in diag.VERBOSITY:
        raise ValueError(f"verbose must be one of {tuple(diag.VERBOSITY)}")
    if not (0.0 <= tempered_update_prior_weight <= 1.0):
        raise ValueError(
            "The keyword tempered_update_prior_weight must be within [0, 1] "
            f"but is currently set to {tempered_update_prior_weight}")
    device = torch.device(device)
    draws = key if key is not None else TorchDraws(seed, device)
    can_fuse = (not run_test and not save_intermediate
                and not continue_intermediate and verbose in ("none", "low"))
    limit = _fuse_limit(mesh, draws, device)
    use_fused = (can_fuse and limit is None) if fused is None else bool(fused)
    if use_fused and not can_fuse:
        raise ValueError(
            "fused=True is incompatible with run_test/save_intermediate/"
            "continue_intermediate and requires verbose='none' or 'low'")
    if use_fused and limit is not None:
        raise ValueError(f"fused=True is not available with {limit}")
    if run_csminwel:
        warnings.warn("run_csminwel is accepted for API parity but mode "
                      "polish is not implemented (matching the reference)")

    sharding = None
    if mesh is not None:
        from smc_tpu_torch.parallel.mesh import particle_sharding
        sharding = particle_sharding(mesh)
        sharding.rows(n_parts)          # raises unless R divides n_parts
    root = sharding is None or sharding.rank == 0
    with _profiled(profile_dir, device, root), span("smc.estimation"):
        shown_verbose = verbose if root else "none"
        space = (parameters if isinstance(parameters, ParamSpace)
                 else ParamSpace(parameters,
                                 regime_switching=regime_switching))
        if space.n_free == 0:
            raise ValueError("All model parameters are fixed!")
        if device.type == "cuda":   # the eigh kernel's limit, before any draw
            cuda_eigh.check_block(max(block_sizes(space.n_free, n_blocks)))

        def batch(fn, d):
            call = (lambda th: fn(th, d)) if batched else \
                torch.func.vmap(lambda th: fn(th, d))

            def likelihood(th):
                with span("smc.likelihood"):
                    return call(th)
            return likelihood

        loglike_batched = batch(loglikelihood, data)
        tempered_update = old_data is not None
        old_loglike_batched = None
        if tempered_update:
            old_loglike_batched = batch(old_loglikelihood or loglikelihood,
                                        old_data)

        threshold = threshold_ratio * n_parts
        sched = fixed_schedule(n_phi, lam)
        omega = tempered_update_prior_weight

        # ---- initialization: fresh, tempered update / bridge, or resume ----
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

        with span("smc.init"):
            if tempered_update:
                if old_cloud is None or old_cloud.is_empty():
                    if not loadpath:
                        raise ValueError("tempered update requires old_cloud "
                                         "or loadpath")
                    old_cloud = smc_io.get_cloud(loadpath, device=device)
                cloud = _on_device(old_cloud, device)
                if omega == 0.0 and cloud.n_parts == n_parts:
                    cloud = reinit_scalars(cloud, tempered=True)
                    weights0 = cloud.weights
                    cloud = initialize_likelihoods(shard(cloud), space,
                                                   loglike_batched)
                else:
                    # bridge: (1-omega) N resampled old-posterior draws and
                    # omega N prior draws whose loglh is evaluated on the old
                    # data, then all evaluated on the new data and resampled
                    # (one-time work, done whole on every rank of a mesh)
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
                        setattr(cloud, f,
                                torch.cat([getattr(p, f) for p in parts]))
                    cloud = initialize_likelihoods(cloud, space,
                                                   loglike_batched)
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
                cloud, init_rounds = initial_draw(draws, space,
                                                  loglike_batched, n_parts,
                                                  device=device,
                                                  sharding=sharding)
                cloud = reinit_scalars(cloud, tempered=False)

            cloud.n_phi = n_phi
            if use_fixed_schedule and not continue_intermediate:
                cloud.tempering_schedule = [float(sched[0])]
            if store_weight_matrices and not continue_intermediate:
                w_cols = [torch.zeros(n_parts, dtype=_F64, device=device)]
                W_cols = [weights0 if tempered_update else
                          torch.ones(n_parts, dtype=_F64, device=device)]

            stage = make_stage_core(space, loglike_batched, n_blocks,
                                    n_mh_steps, alpha, resampling_method,
                                    threshold, omega, log_prob_old_data,
                                    old_loglike_batched, sharding)
            sched_dev = torch.as_tensor(sched, device=device)
            step = make_recursion_step(stage, sched_dev, n_parts,
                                       use_fixed_schedule, tempering_target,
                                       target, sharding)
            state = _initial_state(cloud, device, c,
                                   cloud.tempering_schedule[-1], j, phi_prop,
                                   resampled_last, i, log_mdd)
        para_names = list(space.names)

        def shown(cloud):
            """The cloud a stage print shows: the whole one (verbose="high"
            prints its moments; every rank gathers, rank 0 prints)."""
            return whole(cloud) if verbose == "high" else cloud

        diag.init_stage_print(shown(cloud), para_names, verbose=shown_verbose,
                              use_fixed_schedule=use_fixed_schedule)
        diag.vprint(shown_verbose, "low", "SMC recursion starts...")

        host_reads = 0
        masked = 0
        capture_seconds = 0.0
        chain_lengths: List[int] = []
        if use_fused:
            full = int(fused_chunk_stages or (min(25, n_phi)
                                              if verbose == "low" else n_phi))
            first = min(3, full) if verbose == "low" else full
            fused_rec = FusedRecursion(
                step, draws, state, full, n_parts, store_weight_matrices,
                counters=() if sharding is None else [sharding.counts])
            stream = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
            with contextlib.ExitStack() as on_stream:
                if stream is not None:
                    stream.wait_stream(torch.cuda.current_stream(device))
                    on_stream.enter_context(torch.cuda.stream(stream))
                remaining = n_phi - 1 if use_fixed_schedule else None
                size = first
                timer = diag.StageTimer()
                while True:
                    if remaining is not None:
                        size = min(size, remaining)
                    with span("smc.chunk"):
                        fused_rec.buffers["k"].zero_()
                        watch = (None if use_fixed_schedule else
                                 _DoneWatch(device, size))
                        issued = 0
                        while issued < size:
                            fused_rec.run_stage()
                            issued += 1
                            if watch is not None and watch.after_stage(
                                    fused_rec.buffers["done"]):
                                break
                        n_in, traces, nan_ess, done = fused_rec.read_chunk()
                    host_reads += 1
                    masked += issued - n_in
                    if remaining is not None:
                        remaining -= issued
                    dt = timer.lap()
                    cloud.total_sampling_time += dt
                    resamples_before = cloud.resamples
                    cloud.tempering_schedule += traces["phi"].tolist()
                    cloud.ESS += traces["ess"].tolist()
                    cloud.resamples += int(traces["resampled"].sum())
                    if resampling_method == "metropolis":
                        _chain_lengths(chain_lengths, traces["doeblin"],
                                       traces["resampled"])
                    if store_weight_matrices:
                        w_cols.append(fused_rec.w[:n_in].clone())
                        W_cols.append(fused_rec.W[:n_in].clone())
                    diag.chunk_stage_prints(
                        traces, n_in, first_stage=i + 1,
                        total_stages=n_phi if use_fixed_schedule else None,
                        chunk_time=dt, resamples_before=resamples_before,
                        verbose=shown_verbose)
                    i += n_in
                    cloud.stage_index = i
                    if nan_ess:
                        nan = torch.full((n_parts,), math.nan)
                        inc_last, W_last = (
                            (fused_rec.w[n_in - 1], fused_rec.W[n_in - 1])
                            if store_weight_matrices else (nan, nan))
                        for f in ("params", "loglh", "weights"):
                            setattr(cloud, f, fused_rec.buffers[f])
                        diag.check_nan_ess(whole(cloud), i, inc_last, W_last,
                                           savepath or "smc_cloud.npz",
                                           debug_assertion and root)
                    if done or remaining == 0:
                        break
                    size = full
            if stream is not None:
                torch.cuda.current_stream(device).wait_stream(stream)
        else:
            timer = diag.StageTimer()
            phi_n = float(cloud.tempering_schedule[-1])
            while phi_n < 1.0:
                i += 1
                cloud.stage_index = i
                with span("smc.stage"):
                    state, ex = step(draws, state)
                    with span("smc.read"):
                        (phi_n, ess, mdd_inc, did, cloud.c, cloud.accept_rate,
                         j, phi_prop, doeblin) = torch.stack([
                             state["phi"], state["ess_prev"], ex["mdd_inc"],
                             state["resampled_last"].to(_F64), state["c"],
                             state["accept_rate"], state["j"].to(_F64),
                             state["phi_prop"], ex["doeblin"]]).tolist()
                j = int(j)
                host_reads += 1
                for f in ("params", "loglh", "logprior", "old_loglh",
                          "weights", "accept"):
                    setattr(cloud, f, state[f])
                cloud.tempering_schedule.append(phi_n)
                cloud.ESS.append(ess)
                if math.isnan(ess):
                    diag.check_nan_ess(whole(cloud), i, ex["inc_w"],
                                       ex["W_col"],
                                       savepath or "smc_cloud.npz",
                                       debug_assertion and root)
                if did:
                    cloud.resamples += 1
                if resampling_method == "metropolis":
                    _chain_lengths(chain_lengths, [doeblin], [did])
                log_mdd += mdd_inc
                if store_weight_matrices:
                    w_cols.append(ex["inc_w"])
                    W_cols.append(ex["W_col"])
                dt = timer.lap()
                cloud.total_sampling_time += dt
                diag.end_stage_print(shown(cloud), para_names,
                                     verbose=shown_verbose,
                                     use_fixed_schedule=use_fixed_schedule,
                                     stage_time=dt)
                if run_test and i == 3:
                    break
                if (save_intermediate and savepath
                        and i % intermediate_stage_increment == 0):
                    saved = whole(cloud)
                    if root:
                        smc_io.save_checkpoint(
                            savepath, i, saved, _stack(w_cols, n_parts),
                            _stack(W_cols, n_parts), j, phi_prop, log_mdd,
                            draws.get_state())
                        host_reads += 1
                    if sharding is not None:
                        sharding.barrier()

        with span("smc.finish"):
            if use_fused:
                b = fused_rec.buffers
                with span("smc.read"):
                    (cloud.c, cloud.accept_rate, log_mdd, j,
                     phi_prop) = torch.stack([
                         b["c"], b["accept_rate"], b["log_mdd"],
                         b["j"].to(_F64), b["phi_prop"]]).tolist()
                host_reads += 1
                for f in ("params", "loglh", "logprior", "old_loglh",
                          "weights", "accept"):
                    setattr(cloud, f, b[f])
                capture_seconds = fused_rec.capture_seconds
            cloud = whole(cloud)
            w_matrix = W_matrix = None
            if store_weight_matrices:
                w_matrix = _stack(w_cols, n_parts)
                W_matrix = _stack(W_cols, n_parts)
            writes = not testing and (savepath or particle_store_path)
            if writes and root:
                if savepath:
                    extra = ({"w": w_matrix, "W": W_matrix}
                             if store_weight_matrices else {})
                    extra["log_mdd"] = np.asarray(log_mdd)
                    smc_io.save_cloud(savepath, cloud, extra=extra)
                if particle_store_path:
                    smc_io.save_particle_store(particle_store_path, cloud)
            if writes and sharding is not None:
                sharding.barrier()
        return SMCResult(cloud=cloud, w=w_matrix, W=W_matrix, log_mdd=log_mdd,
                         para_names=para_names, space=space,
                         init_rounds=init_rounds, fused=use_fused,
                         host_reads=host_reads, masked_stages=masked,
                         capture_seconds=capture_seconds,
                         chain_lengths=chain_lengths,
                         collectives=0 if sharding is None else
                         sharding.collectives,
                         collective_bytes=0 if sharding is None else
                         sharding.bytes)


def _chain_lengths(out: List[int], doeblin, resampled) -> None:
    """Append the Doeblin lengths of the stages that resampled to `out`,
    warning for each that passed the chain's cap (at the read that brings
    them, in either driver)."""
    for b, r in zip(doeblin, resampled):
        if r:
            warn_if_capped(float(b), N_ITER_MAX)
            out.append(int(b))


def _stack(cols: List[torch.Tensor], n_parts: int) -> np.ndarray:
    """Weight columns as one host matrix [N, n_stages + 1]: each entry of
    `cols` is one column [N] or a fused chunk's rows [n, N]."""
    if not cols:
        return np.zeros((n_parts, 0))
    rows = [c.reshape(-1, n_parts) for c in cols]
    return torch.cat(rows).T.contiguous().cpu().numpy()
