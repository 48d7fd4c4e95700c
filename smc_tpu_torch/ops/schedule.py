"""Tempering schedule (port of smc_tpu/ops/schedule.py): the fixed
lambda-schedule and the adaptive-phi solver.

`solve_adaptive_phi` runs on the device alone: it makes no host read and
copies nothing from the host, so it can be captured in a CUDA graph. The
schedule advance evaluates the ESS at every candidate (the current
proposal, then the whole schedule, the entries before j masked) as one
fixed-shape [n_phi + 1, N] reduction and takes the first candidate where
the ESS is not above target, which is where the JAX package's `while_loop`
stops. The 64-step bisection then runs as `torch.where` updates of lo/hi,
and the choice between its root and phi = 1 is a select.
"""

from __future__ import annotations

import numpy as np
import torch

_BISECT_ITERS = 64  # 2^-64 < eps(f64): bisection to machine precision


def fixed_schedule(n_phi: int, lam: float) -> np.ndarray:
    """phi_n = ((n-1)/(n_phi-1))^lambda, n = 1..n_phi."""
    return (np.arange(n_phi, dtype=np.float64) / (n_phi - 1)) ** lam


def _ess(log_w, loglh, old_loglh, phi, phi_n1):
    """ESS after tempering phi_n1 -> phi, for phi of shape [K, 1] (rows of
    a [K, N] grid, returns [K]) or a scalar (returns a scalar); the form of
    correction.compute_ess, max-shifted in log space."""
    n = loglh.shape[-1]
    lw = log_w + ((phi_n1 - phi) * old_loglh + (phi - phi_n1) * loglh)
    shifted = torch.exp(lw - torch.amax(lw, dim=-1, keepdim=True))
    norm_w = n * shifted / torch.sum(shifted, dim=-1, keepdim=True)
    return n * n / torch.sum(norm_w * norm_w, dim=-1)


_SCHEDULES = {}


def _schedule_on(schedule, device) -> torch.Tensor:
    """The schedule as an f64 tensor on `device`: a tensor as it is, host
    values copied once per distinct schedule and device."""
    if torch.is_tensor(schedule):
        return schedule.to(device=device, dtype=torch.float64)
    arr = np.ascontiguousarray(schedule, np.float64)
    key = (arr.tobytes(), str(device))
    if key not in _SCHEDULES:
        _SCHEDULES[key] = torch.as_tensor(arr, device=device)
    return _SCHEDULES[key]


def solve_adaptive_phi(loglh, weights, old_loglh, phi_n1, schedule, j,
                       phi_prop, ess_bar):
    """One adaptive-schedule step.

    loglh, weights, old_loglh: cloud tensors [N] (weights sum to N).
    phi_n1: previous tempering parameter. schedule: the proposed fixed
    schedule (numpy or tensor, last entry 1.0). j: 0-based index of the
    next untried schedule entry (1 at the start), an int or an int64
    device scalar. phi_prop: current proposal upper bound. ess_bar: target
    ESS. Scalars given as tensors stay on the device; host numbers are
    copied to it.

    The proposal advances through the schedule while the ESS at it stays
    at or above ess_bar (and entries remain); if the ESS at the final
    proposal is below ess_bar, phi_n is the bisection root of
    ESS(phi) = ess_bar on [phi_n1, phi_prop], else phi_n = 1.
    Returns (phi_n, j, phi_prop) as device scalars (f64, int64, f64)."""
    dev, f64 = loglh.device, torch.float64
    sched = _schedule_on(schedule, dev)
    n_phi = sched.shape[0]
    if old_loglh is None:
        old_loglh = torch.zeros_like(loglh)
    log_w = torch.log(weights)
    scalar = lambda x, dt=f64: torch.as_tensor(x, dtype=dt, device=dev)
    phi_n1, ess_bar, phi_prop = scalar(phi_n1), scalar(ess_bar), \
        scalar(phi_prop)
    j = scalar(j, torch.int64)

    # -- advance: the first candidate where ESS >= ess_bar fails ------------
    # candidate 0 is the proposal, candidate p >= 1 the schedule entry p - 1,
    # untried (so a candidate) from p = j + 1 on
    cands = torch.cat([phi_prop.reshape(1), sched])
    pos = torch.arange(n_phi + 1, device=dev)
    valid = (pos == 0) | (pos > j)
    f = _ess(log_w, loglh, old_loglh, cands[:, None], phi_n1) - ess_bar
    stop = valid & ~(f >= 0)   # f < 0, or nan: where the loop's test fails
    last = torch.where(j < n_phi, n_phi, 0)
    m = torch.where(stop.any(), torch.argmax(stop.to(torch.int32)),
                    last).reshape(1)
    # index_select, not cands[m]: a 0-d index tensor would be read to host
    phi_prop, f_m = cands.index_select(0, m)[0], f.index_select(0, m)[0]
    j = torch.where(m[0] > 0, m[0], j)

    # -- bisect on [phi_n1, phi_prop] -----------------------------------------
    lo, hi = phi_n1, phi_prop
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        go_right = _ess(log_w, loglh, old_loglh, mid, phi_n1) - ess_bar >= 0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    phi_n = torch.where(f_m < 0, 0.5 * (lo + hi), 1.0)
    return phi_n, j, phi_prop
