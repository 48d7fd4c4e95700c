"""Observability (port of smc_tpu/diagnostics.py): verbosity-gated stage
printing (per stage, or per fused chunk from its traces), the per-stage
parameter table of verbose="high", degenerate-weight forensics and the
stage timer. The lines are the JAX package's, character
for character."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

VERBOSITY = {"none": 0, "low": 1, "high": 2}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def vprint(verbose: str, level: str, msg: str) -> None:
    if VERBOSITY.get(verbose, 1) >= VERBOSITY[level]:
        print(msg, flush=True)


def init_stage_print(cloud, para_names, verbose="low",
                     use_fixed_schedule=True) -> None:
    """The report before the first stage."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    total = "--------------------------"
    print(total)
    print(f"SMC (torch) stage: {cloud.stage_index} of "
          f"{'' if use_fixed_schedule else '?'}{cloud.n_phi if use_fixed_schedule else ''}")
    print(f"  phi_n = {cloud.tempering_schedule[-1]:.6f}")
    print(f"  c = {cloud.c:.4f}, accept = {cloud.accept_rate:.4f}, "
          f"ESS = {cloud.ESS[-1]:.1f} ({cloud.resamples} total resamples)")
    if VERBOSITY.get(verbose, 1) >= 2:
        _param_table(cloud, para_names)
    print(total, flush=True)


def end_stage_print(cloud, para_names, verbose="low", use_fixed_schedule=True,
                    stage_time: Optional[float] = None) -> None:
    """The line after each stage, with the stage time and an ETA; at
    verbose="high" also the weighted mean and sd of each parameter."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    i = cloud.stage_index
    total_stages = cloud.n_phi if use_fixed_schedule else None
    avg = cloud.total_sampling_time / max(i - 1, 1)
    line = (f"stage {i}" + (f"/{total_stages}" if total_stages else "")
            + f": phi={cloud.tempering_schedule[-1]:.6f}"
            + f" c={cloud.c:.4f} accept={cloud.accept_rate:.3f}"
            + f" ESS={cloud.ESS[-1]:.1f} resamples={cloud.resamples}")
    if stage_time is not None:
        line += f" t={stage_time:.2f}s"
    if total_stages:
        eta = avg * max(total_stages - i, 0)
        line += f" ETA={eta:.0f}s"
    print(line, flush=True)
    if VERBOSITY.get(verbose, 1) >= 2:
        _param_table(cloud, para_names)


def chunk_stage_prints(traces, n_in_chunk: int, first_stage: int,
                       total_stages: Optional[int], chunk_time: float,
                       resamples_before: int, verbose: str = "low") -> None:
    """The lines of end_stage_print for a fused chunk's stages, from its
    traces (phi, c, accept, ESS, resampled: sequences of at least
    n_in_chunk). The stage time is the chunk's average: the stages of a
    chunk are not timed one by one."""
    if VERBOSITY.get(verbose, 1) < 1:
        return
    per = chunk_time / max(n_in_chunk, 1)
    res_count = resamples_before
    for k in range(n_in_chunk):
        stage = first_stage + k
        res_count += int(traces["resampled"][k])
        line = (f"stage {stage}"
                + (f"/{total_stages}" if total_stages else "")
                + f": phi={float(traces['phi'][k]):.6f}"
                + f" c={float(traces['c'][k]):.4f}"
                + f" accept={float(traces['accept'][k]):.3f}"
                + f" ESS={float(traces['ess'][k]):.1f}"
                + f" resamples={res_count}"
                + f" t~{per:.2f}s")
        if total_stages:
            eta = per * max(total_stages - stage, 0)
            line += f" ETA={eta:.0f}s"
        print(line, flush=True)


def _param_table(cloud, para_names) -> None:
    from smc_tpu_torch.cloud import weighted_mean, weighted_std
    mu = _host(weighted_mean(cloud))
    sd = _host(weighted_std(cloud))
    for name, m, s in zip(para_names, mu, sd):
        print(f"    {name:>16s}: mean = {m: .6f}  std = {s: .6f}")


def check_nan_ess(cloud, stage: int, incremental_weights, normalized_weights,
                  savepath: str = "", debug_assertion: bool = False) -> None:
    """If the stage's ESS is NaN, compose the cause, with debug_assertion
    and a savepath dump the weights and particles to
    `<savepath>_debug_assertion.npz`, then raise AssertionError."""
    if not np.isnan(cloud.ESS[stage - 1] if stage - 1 < len(cloud.ESS)
                    else cloud.ESS[-1]):
        return
    inc = _host(incremental_weights)
    norm = _host(normalized_weights)
    msg = "No particles have non-zero weight."
    if np.isinf(inc).any():
        msg += " Some particles have approximately infinite log-likelihoods."
    if np.isnan(inc).any():
        msg += " Some particles have approximately NaN log-likelihoods."
    ssq = np.sum(norm ** 2)
    if ssq <= np.finfo(np.float64).eps:
        msg += " The squared sum of the normalized weights is at machine-error."
    if np.isnan(ssq):
        msg += " The squared sum of the normalized weights is returning a NaN."
        if np.isnan(norm).any():
            msg += " Part of the reason is that one of the normalized weights is a NaN."
    if debug_assertion and savepath:
        debug_path = savepath.replace(".npz", "") + "_debug_assertion.npz"
        np.savez(debug_path, incremental_weights=inc, normalized_weights=norm,
                 params=_host(cloud.params), loglh=_host(cloud.loglh),
                 weights=_host(cloud.weights))
        msg += f" Debug state dumped to {debug_path}."
    raise AssertionError(msg)


class StageTimer:
    """Wall-clock time per stage, accumulated into
    cloud.total_sampling_time by smc()."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
